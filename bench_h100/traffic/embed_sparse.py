"""Closed-loop map building (``embed_by_model``) for the sparse voxel models:
MinkLoc3Dv2, its weights ``weights_minkloc3dv2.py`` and its reference
``reference/minkloc3dv2.py``; the control is that reference at ``CONTROL``
precision in the program's place, behind the same ``PlaceIndex``.

End to end, the traffic and the other parameters are ``embed_closed_loop``'s:
``embed_submaps_per_s`` over the window. Correctness: ``desc_rel_gap``, the
largest ``||got - ref|| / ||ref||`` over the descriptors of the window
(relative: MinkLoc3Dv2's descriptors are not unit-norm).

``counters``: the program's voxels at each stride and pairs of each kernel
map over the window (its model's ``counters()``, read before and after),
and, after a traced window, ``work``: a batch's work counted from the pool
by the benchmark's own maps (``counts_sparse.batch_work``), which the
per-layer readers take, and ``span_ms``: the device time a batch of each of
the model's spans (``minkloc/...``). All go to ``info``.

The traced stretch is the window's own path: the embed layer replays the
model's eval forward as a CUDA graph, whose kernels the profiler records
(the idle share, K11's records) but with none of the model's spans around
them. ``span_ms`` is therefore read after the window from ``SPAN_BATCHES``
further batches of the pool through the model called eagerly (the same
kernels, launched one by one inside their spans), profiled on their own.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100 import counts_sparse, weights_minkloc3dv2
from bench_h100.reference import minkloc3dv2 as ref_minkloc3dv2
from bench_h100.traffic.embed_by_model import Kind as ByModel
from bench_h100.traffic.embed_closed_loop import Kind as ClosedLoop
from bench_h100.trace import Stretch

SPAN_BATCHES = 10
SPAN_PREFIX = "minkloc/"

# model name -> (the weights' maker, the reference module)
REFERENCES = {"minkloc3dv2": (weights_minkloc3dv2.make_weights, ref_minkloc3dv2)}


def _difference(after: dict, before: dict) -> dict:
    return {k: _difference(v, before[k]) if isinstance(v, dict) else v - before[k]
            for k, v in after.items()}


class Kind(ByModel):
    def __init__(self, model: dict, train: dict, params: dict, device, seed: int,
                 control: bool = False):
        if "num_points" in params:
            model = {**model, "num_points": int(params["num_points"])}
        if model["name"] not in REFERENCES:
            raise KeyError(f"no reference for model {model['name']!r}")
        ClosedLoop.__init__(self, model, train, params, device, seed, control)
        self.make_weights, self.reference = REFERENCES[model["name"]]

    def _program_counters(self) -> dict | None:
        """The program's model's counters, where it keeps them (not the
        control's reference)."""
        model = getattr(getattr(self.index, "_embed", None), "model", None)
        read = getattr(model, "counters", None)
        return read() if callable(read) else None

    def window(self, seconds: float, trace: bool) -> dict:
        before = self._program_counters()
        out = super().window(seconds, trace)
        after = self._program_counters()
        self.counters = {}
        if before is not None and after is not None:
            self.counters = {k: v for k, v in _difference(after, before).items()
                             if k in ("forwards", "voxels", "pairs")}
        if trace:
            self.counters["work"] = counts_sparse.batch_work(
                self.model, self.pool, self.params["batch"], self.device)
            spans = self._span_ms()
            if spans is not None:
                self.counters["span_ms"] = spans
        self.info = {**self.info, "counters": self.counters}
        return out

    def _span_ms(self) -> dict | None:
        """{span: device ms a batch} over ``SPAN_BATCHES`` eager forwards of
        the program's model (not the control's reference), profiled."""
        model = getattr(getattr(self.index, "_embed", None), "model", None)
        if model is None:
            return None
        dev = next(model.parameters()).device
        stretch = Stretch(self.device, 0, SPAN_BATCHES)
        for i in range(SPAN_BATCHES):
            x = torch.as_tensor(self.pool[next(self.order)], dtype=torch.float32, device=dev)
            stretch.before(i)
            with torch.inference_mode():
                model(x)
            stretch.after(i)
        t = stretch.trace
        names = sorted({name for _, _, name in t.spans if name.startswith(SPAN_PREFIX)})
        return {name: t.span_device_us([name]) / 1e3 / t.units for name in names}

    def check(self) -> dict:
        ref = self.reference.embed(self.weights, self.model, self.pool, self.device)
        rows = torch.as_tensor(np.concatenate([r for r, _ in self.outs]), device=self.device)
        got = torch.as_tensor(np.concatenate([o for _, o in self.outs]), device=self.device)
        want = ref[rows]
        gap = torch.linalg.vector_norm(got - want, dim=1) / torch.linalg.vector_norm(want, dim=1)
        return {"desc_rel_gap": float(gap.max())}
