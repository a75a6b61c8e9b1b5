"""Closed-loop map building: ``PlaceIndex.embed`` on host batches of
``batch`` submaps drawn from a seeded pool of blob submaps, one batch after
the other (the next starts when the descriptors of the last are back on
the host), for the whole window.

End to end: ``embed_submaps_per_s``, the submaps embedded and copied back
over the window's time. Correctness: every descriptor the window gave
against the reference's of its submap (``desc_gap``: the largest L2
distance, both unit-norm); the reference embeds the pool once.

Parameters: ``batch``, ``pool`` (submaps), ``trace_skip`` and
``trace_units`` (the traced batches).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import data, program
from bench_h100.reference import model as ref_model
from bench_h100.trace import Stretch
from bench_h100.weights import make_weights


class Kind:
    def __init__(self, model: dict, train: dict, params: dict, device, seed: int,
                 control: bool = False):
        self.model, self.params, self.device, self.seed = model, params, device, seed
        self.control = control
        self.counters: dict = {}

    def _batches(self):
        """Pool rows of each batch: the pool in a seeded order, again and
        again, ``batch`` rows at a time."""
        r, b, pool = data.rng(self.seed, "batches"), self.params["batch"], self.params["pool"]
        buf = np.empty(0, np.int64)
        while True:
            while len(buf) < b:
                buf = np.concatenate([buf, r.permutation(pool)])
            yield buf[:b]
            buf = buf[b:]

    def setup(self) -> None:
        p, lap = self.params, data.Laps()
        self.weights = make_weights(self.model, data.torch_seed(self.seed, "weights"),
                                    self.device)
        self.pool = data.blob_submaps(data.rng(self.seed, "pool"), p["pool"],
                                      self.model["num_points"])
        lap("inputs")
        self.index = program.place_index(self.model, self.weights, self.device, p["batch"],
                                         max_k=1, control=self.control)
        lap("build")
        self.order = self._batches()
        for _ in range(2):  # the only shape the window uses
            self.index.embed(self.pool[next(self.order)])
        lap("warm")
        self.info = {"setup_laps_s": lap.laps}

    def window(self, seconds: float, trace: bool) -> dict:
        p = self.params
        stretch = Stretch(self.device, p["trace_skip"], p["trace_units"]) if trace else None
        self.outs, self.attempted, self.failed, i = [], 0, 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            rows = next(self.order)
            if stretch:
                stretch.before(i)
            self.attempted += len(rows)
            self.outs.append((rows, self.index.embed(self.pool[rows])))
            if stretch:
                stretch.after(i)
            i += 1
        t1 = time.perf_counter()
        if stretch:
            stretch.finish(i, t0, t1)
        self.trace = stretch.trace if stretch else None
        return {"embed_submaps_per_s": self.attempted / (t1 - t0)}

    def free(self) -> None:
        self.index = None

    def check(self) -> dict:
        ref = ref_model.embed(self.weights, self.model, self.pool, self.device)
        rows = torch.as_tensor(np.concatenate([r for r, _ in self.outs]), device=self.device)
        got = torch.as_tensor(np.concatenate([o for _, o in self.outs]), device=self.device)
        gap = torch.linalg.vector_norm(got - ref[rows], dim=1)
        return {"desc_gap": float(gap.max())}
