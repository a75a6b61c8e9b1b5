"""Open-loop fleet serving: single-submap place queries sent to a
``QueryScheduler`` over a ``PlaceIndex`` at a fixed rate of Poisson
arrivals, whatever the system's state (``data.open_loop_schedule``).

Set-up builds the map as a deployment does: the pool's submaps go through
``PlaceIndex.embed`` and their descriptors are planted at seeded rows
among seeded unit descriptors, ``rows`` in all, which ``add_descriptors``
and ``warmup`` make resident on the card. Each query is one pool submap.

End to end: ``query_p50_ms`` and ``query_p95_ms``, submit to answer timed
from each request's due time, over every request due in the window (those
still queued at its close are waited for, up to ``drain_s``). A request
that fails or never comes counts in ``failed``.

Correctness, on every answer, once the window has closed and the
program's state is freed:

- ``wrong_answers``: answers that are not the exact top-k of the queried
  submap's descriptor (as map building gave it) over the rows: the fp64
  distance of each returned row must equal the fp64 top-k's at its rank,
  and each returned distance the fp64 distance of its row, within the fp32
  rounding of a distance of unit 256-D rows (``TOL``); ids must be
  distinct. A served embed that differs from map building's puts another
  row, or another distance, first;
- ``desc_gap``: the map-building descriptors of the pool against the
  reference's (largest L2 distance).

Retrieval is so judged from the program's own descriptors; the embed
itself is judged against the reference by ``desc_gap``.

Parameters: ``rows``, ``pool``, ``rate_per_s``, ``embed_batch``,
``max_wait_ms``, ``k``, ``drain_s``, ``trace_s`` (the traced stretch: the
last seconds of the window).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from bench_h100 import data, program
from bench_h100.reference import model as ref_model
from bench_h100.reference import retrieval as ref_retrieval
from bench_h100.trace import Stretch
from bench_h100.weights import make_weights

# fp32 rounding of a squared distance of unit-norm 256-D rows, with room:
# the dot product's worst-case error is 256 x 2^-24 x sum|q_i x_i| <= 1.6e-5,
# doubled in the distance
TOL = 1e-4


class _WorkerStretch:
    """Profiles the dispatches the scheduler's worker thread starts from
    ``t_start`` on, up to the first that ends at or after ``t_stop``: the
    profiler records the host's ops of the thread that starts it, so it is
    started and stopped around the index's query, in that thread."""

    def __init__(self, device, query, t_start: float, t_stop: float, on_start):
        self.stretch = Stretch(device, 0, 0)
        self.query, self.t_start, self.t_stop = query, t_start, t_stop
        self.on_start = on_start
        self.units, self.done = 0, False

    def __call__(self, points, k=25):
        if not self.done and self.stretch.prof is None and time.perf_counter() >= self.t_start:
            self.on_start()
            self.stretch.start()
        out = self.query(points, k)
        if self.stretch.prof is not None:
            self.units += 1
            if time.perf_counter() >= self.t_stop:
                self.stretch.stop(self.units)
                self.done = True
        return out


class _Outcomes:
    """What each request came to, recorded by its future's callback (in the
    scheduler's worker), so that no future outlives its answer: when it
    was answered, whether it failed, and the answer."""

    def __init__(self, m: int, k: int):
        self.done = np.full(m, np.nan)
        self.failed = np.zeros(m, bool)
        self.ids = np.full((m, k), -1, np.int64)
        self.dists = np.full((m, k), np.nan)

    def __call__(self, i: int, fut) -> None:
        t = time.perf_counter()
        if fut.exception() is not None:
            self.failed[i] = True
        else:
            ids, dists = fut.result()
            self.ids[i, :len(ids)], self.dists[i, :len(dists)] = ids, dists
        self.done[i] = t  # last: all_done() then sees the answer too

    def all_done(self) -> bool:
        return bool(np.isfinite(self.done).all())


class Kind:
    def __init__(self, model: dict, train: dict, params: dict, device, seed: int,
                 control: bool = False):
        self.model, self.params, self.device, self.seed = model, params, device, seed
        self.control = control
        self.counters: dict = {}

    def setup(self) -> None:
        p, dim = self.params, self.model["output_dim"]
        lap = data.Laps()
        self.weights = make_weights(self.model, data.torch_seed(self.seed, "weights"),
                                    self.device)
        self.pool = data.blob_submaps(data.rng(self.seed, "pool"), p["pool"],
                                      self.model["num_points"])
        lap("inputs")
        self.index = program.place_index(self.model, self.weights, self.device,
                                         p["embed_batch"], p["k"], control=self.control)
        self.pool_desc = self.index.embed(self.pool)
        lap("build_and_map")
        gen = torch.Generator(device=self.device).manual_seed(data.torch_seed(self.seed, "db"))
        self.db = data.unit_rows(gen, p["rows"], dim).cpu().numpy()
        self.plant = data.rng(self.seed, "plant").choice(p["rows"], p["pool"], replace=False)
        self.db[self.plant] = self.pool_desc
        lap("rows")
        self.index.add_descriptors(self.db)
        self.index.warmup()
        lap("add_and_sync")
        self.sched = program.QueryScheduler(self.index, k=p["k"],
                                            max_wait_ms=p["max_wait_ms"])
        for n in (p["embed_batch"], 1):
            for f in [self.sched.submit(self.pool[i]) for i in range(n)]:
                f.result()
        lap("scheduler")
        self.setup_laps = lap.laps

    def window(self, seconds: float, trace: bool) -> dict:
        p = self.params
        due, self.which = data.open_loop_schedule(self.seed, p["rate_per_s"], seconds,
                                                  p["pool"])
        m = len(due)
        out = self.outcomes = _Outcomes(m, p["k"])
        late = np.empty(m)
        counts = [self.sched.metrics()]
        gc_pauses = data.GcPauses()
        t0 = time.perf_counter() + 0.005
        tracer = None
        if trace:
            span = min(p["trace_s"], seconds / 2)
            tracer = _WorkerStretch(self.device, self.index.query, t0 + seconds - span,
                                    t0 + seconds,
                                    on_start=lambda: counts.append(self.sched.metrics()))
            self.index.query = tracer  # an instance attribute: the scheduler calls it
        try:
            for i in range(m):
                at = t0 + due[i]
                now = time.perf_counter()
                if at > now:
                    time.sleep(at - now)
                fut = self.sched.submit(self.pool[self.which[i]])
                late[i] = time.perf_counter() - at
                fut.add_done_callback(functools.partial(out, i))
            deadline = t0 + seconds + p["drain_s"]
            while not out.all_done() and time.perf_counter() < deadline:
                time.sleep(0.01)
        finally:
            gc_pauses.close()
            if tracer is not None:
                del self.index.query
        counts.append(self.sched.metrics())
        self.trace = tracer.stretch.trace if tracer else None
        ok = np.isfinite(out.done) & ~out.failed
        self.attempted, self.failed = m, int(m - ok.sum())
        lat = (out.done - (t0 + due))[ok] * 1e3
        # the micro-batches' fill up to the traced stretch (the profiler's
        # stop holds the worker), else over the window
        c0, c1 = counts[0], counts[1]
        self.counters = {"requests": c1["requests"] - c0["requests"],
                         "dispatches": c1["dispatches"] - c0["dispatches"],
                         "max_batch": self.sched.max_batch}
        if self.trace is not None and self.counters["dispatches"]:
            # a dispatch's time before the stretch: the window's start to
            # the stretch's over the dispatches in between
            self.trace.unit_s = (tracer.stretch.began - t0) / self.counters["dispatches"]
        self.info = {"setup_laps_s": self.setup_laps, "gc": gc_pauses.summary(),
                     "generator_late_ms_p50": float(np.percentile(late, 50) * 1e3),
                     "generator_late_ms_p99": float(np.percentile(late, 99) * 1e3),
                     "generator_late_ms_max": float(late.max() * 1e3),
                     "requests": m, "offered_per_s": m / seconds,
                     "answered_per_s": float(ok.sum()) / max(
                         float(np.nanmax(out.done)) - t0, seconds) if ok.any() else 0.0}
        if not len(lat):
            return {}
        return {"query_p50_ms": float(np.percentile(lat, 50)),
                "query_p95_ms": float(np.percentile(lat, 95))}

    def free(self) -> None:
        self.sched.stop()
        self.sched = self.index = None

    def check(self) -> dict:
        out = self.outcomes
        ok = np.nonzero(np.isfinite(out.done) & ~out.failed)[0]
        wrong = len(out.done) - len(ok)
        # the exact top-k of each pool submap's descriptor, then every
        # answer against its submap's
        _, d64 = ref_retrieval.topk(self.pool_desc, self.db, self.params["k"], self.device)
        db = torch.as_tensor(self.db, device=self.device)
        desc = torch.as_tensor(self.pool_desc, device=self.device, dtype=torch.float64)
        for s in range(0, len(ok), 4096):
            i = ok[s:s + 4096]
            ids, j = out.ids[i], self.which[i]
            rows = db[torch.as_tensor(np.maximum(ids, 0), device=self.device)].double()
            true = ((rows - desc[torch.as_tensor(j, device=self.device)][:, None]) ** 2).sum(-1)
            true = true.cpu().numpy()
            srt = np.sort(ids, 1)
            bad = ((ids < 0).any(1) | (srt[:, 1:] == srt[:, :-1]).any(1)
                   | (np.abs(true - d64[j]) > TOL).any(1)
                   | ~(np.abs(out.dists[i] - true) <= TOL).all(1))
            wrong += int(bad.sum())
        ref = ref_model.embed(self.weights, self.model, self.pool, self.device)
        gap = torch.linalg.vector_norm(
            torch.as_tensor(self.pool_desc, device=self.device) - ref, dim=1)
        return {"wrong_answers": float(wrong), "desc_gap": float(gap.max())}
