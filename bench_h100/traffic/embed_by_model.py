"""Closed-loop map building (``embed_closed_loop``) for every configuration
the benchmark holds a reference for, at any number of points.

- ``params["num_points"]``, where given, sets the submaps' points and the
  model's ``num_points``, from which the per-layer readers take N;
- the weights and the reference follow ``model["name"]`` (``REFERENCES``):
  EPC-Net and EPC-Net-L take ``weights.py`` and ``reference/model.py``'s
  forward (``reference/model_any_n.py``, whose kNN fits the card at any
  N), DGCNN-VLAD ``weights_dgcnn_vlad.py`` and ``reference/dgcnn_vlad.py``;
- the control: that reference at ``CONTROL`` precision in the program's
  place, behind the same ``PlaceIndex``.

End to end, correctness and the other parameters are
``embed_closed_loop``'s: ``embed_submaps_per_s`` over the window, and
``desc_gap``, the largest L2 distance between a descriptor of the window
and the reference's of its submap.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100 import data, program, weights, weights_dgcnn_vlad
from bench_h100.reference import dgcnn_vlad as ref_dgcnn_vlad
from bench_h100.reference import model_any_n as ref_epcnet
from bench_h100.reference.precision import CONTROL
from bench_h100.traffic.embed_closed_loop import Kind as ClosedLoop

# model name -> (the weights' maker, the reference module)
REFERENCES = {"epcnet": (weights.make_weights, ref_epcnet),
              "epcnet_l": (weights.make_weights, ref_epcnet),
              "dgcnn_vlad": (weights_dgcnn_vlad.make_weights, ref_dgcnn_vlad)}


class Kind(ClosedLoop):
    def __init__(self, model: dict, train: dict, params: dict, device, seed: int,
                 control: bool = False):
        if "num_points" in params:
            model = {**model, "num_points": int(params["num_points"])}
        if model["name"] not in REFERENCES:
            raise KeyError(f"no reference for model {model['name']!r}")
        super().__init__(model, train, params, device, seed, control)
        self.make_weights, self.reference = REFERENCES[model["name"]]

    def _index(self):
        """The program's ``PlaceIndex``, or the control's: the reference at
        the control's precision in the program's place."""
        p, m = self.params, self.model
        if not self.control:
            return program.place_index(m, self.weights, self.device, p["batch"], max_k=1)

        def embed(points: torch.Tensor) -> torch.Tensor:
            return self.reference.embed(self.weights, m, points, self.device, p=CONTROL)

        return program.PlaceIndex(embed, m["output_dim"], embed_batch=p["batch"], max_k=1,
                                  num_points=m["num_points"], device=self.device)

    def setup(self) -> None:
        p, lap = self.params, data.Laps()
        self.weights = self.make_weights(self.model, data.torch_seed(self.seed, "weights"),
                                         self.device)
        self.pool = data.blob_submaps(data.rng(self.seed, "pool"), p["pool"],
                                      self.model["num_points"])
        lap("inputs")
        self.index = self._index()
        lap("build")
        self.order = self._batches()
        for _ in range(2):  # the only shape the window uses
            self.index.embed(self.pool[next(self.order)])
        lap("warm")
        self.info = {"setup_laps_s": lap.laps}

    def check(self) -> dict:
        ref = self.reference.embed(self.weights, self.model, self.pool, self.device)
        rows = torch.as_tensor(np.concatenate([r for r, _ in self.outs]), device=self.device)
        got = torch.as_tensor(np.concatenate([o for _, o in self.outs]), device=self.device)
        gap = torch.linalg.vector_norm(got - ref[rows], dim=1)
        return {"desc_gap": float(gap.max())}
