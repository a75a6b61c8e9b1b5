"""Serving at database scale on the card (counterpart of
``scripts/hw_serve_scale.py`` and of ``scripts/hw_serve_load.py``'s protocol).

  python -m epcnet_torch.scripts.serve_scale [--rungs 10000,100000,1000000] \\
      [--quantize none,int8] [--load] [--ingest] [--ingest_rows 1000000] \\
      [--ingest_repeats 1] [--device cuda] [--out build/serve_scale.json]

The full-width EPC-Net (``ModelConfig()``, seeded weights
``init_flat_variables(cfg, 0)``) serves 32 seeded blob submaps (N=4096)
planted as rows 0-31 of a database of random unit-norm descriptors (the
embed and the distance products do not depend on the rows' values).

- Ladder (per ``--quantize``): the DB grows through the normal
  ``PlaceIndex`` append path in irregular chunks that cross capacity
  doublings, each followed by a query that syncs it. At each rung: the
  planted submaps retrieve themselves at rank 0; the fused query of a full
  ``embed_batch=32`` batch (embed + exact top-k 25 against the whole DB),
  host clock around ``PlaceIndex.query`` (which ends in a copy to the host),
  p50/p99 over ``iters`` calls and qps = 32 / mean; ``device_bytes``; and
  the transient device memory of one query, ``max_memory_allocated`` after
  ``reset_peak_memory_stats`` minus what was allocated before it, for the
  retrieval alone (``query_descriptors`` of the 32 descriptors) and for the
  fused query (whose embed dominates). At the ``plain_at`` rungs (10^5 and
  10^6) the full-sort plain version (``ops/retrieval.py``'s ``*_plain``)
  runs on the same snapshot and descriptors: its ids must equal the blocked
  path's, and both are timed by CUDA events.
- Load (``--load``): 8 threads each submit 12 single-submap queries through
  ``QueryScheduler`` (k=5); p50/p99, qps and the average micro-batch.
- Ingest (``--ingest``): ``sync_mode="background"``, fp32, two windows.
  8 client threads (each its own planted submap, k=5) query in rounds: a
  barrier starts each round, and a ``QueryScheduler`` whose micro-batch is
  the 8 clients serves the round as one dispatch, so that no request
  queues behind another round's dispatch. Over a base of random rows,
  ``ingest_rows`` rows are added in 10 host chunks, then ``flush()``.
  In ``ingest`` the base keeps the capacity fixed (2^21 for 10^6 added
  rows): every device-sync chunk is written in place. In
  ``ingest_growth`` the capacity doubles halfway through (2^20 -> 2^21):
  that chunk copies the whole synced prefix into a new buffer on the side
  stream (``growth_chunk_ms``). Every chunk also holds two rows near each
  thread's descriptor, nearer chunk by chunk, so the top-5 changes as the
  prefix grows. Query latency with no sync in flight (idle: finished
  before the first add; after: sent after ``flush()``), during the ingest
  (sent between the first add and the end of ``flush()``), each
  dispatch's time in the same windows, and the wall time of each sync
  chunk. Every answer is checked to be the exact top-5 (float64 oracle) of
  a prefix at least as long as the one visible when it was sent, and every
  row is visible after ``flush()``. ``within_bound``: the longest query
  during the ingest took at most the longest query with no sync in flight
  plus the longest chunk (``margin_ms`` is what was left). With
  ``--ingest_repeats N`` both windows run N times and ``ingest_repeats``
  lists each one's margin (``--rungs "" --quantize ""`` skips the ladder).

``run(...)`` returns the results as a dict (``chip_smoke.py`` calls it);
``main`` prints one JSON line and writes ``--out``. With ``--device cpu``
it runs a tiny model at small sizes on host clocks (no number of it is a
device time, and memory is not measured); without a card the default
device raises.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import threading
import time

import numpy as np
import torch

from epcnet_torch.configs import ModelConfig
from epcnet_torch.device import resolve_device
from epcnet_torch.ops.retrieval import topk_neighbors_plain, topk_neighbors_quantized_plain
from epcnet_torch.scripts.train_bench import SMALL, blob_submaps
from epcnet_torch.serve import PlaceIndex, QueryScheduler, _capacity
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.utils.timing import cuda_ms
from epcnet_torch.weights import init_flat_variables

K = 25


def unit_rows(gen: torch.Generator, n: int, dim: int) -> np.ndarray:
    """n random unit-norm fp32 rows, drawn on the generator's device."""
    d = torch.randn((n, dim), generator=gen, device=gen.device)
    return (d / torch.linalg.vector_norm(d, dim=1, keepdim=True)).cpu().numpy()


def _pcts(lat_s: list) -> dict:
    a = np.sort(np.asarray(lat_s)) * 1e3
    if not len(a):
        return {"n": 0}
    return {"n": int(len(a)), "p50_ms": float(a[len(a) // 2]),
            "p99_ms": float(a[min(len(a) - 1, int(len(a) * 0.99))]), "max_ms": float(a[-1])}


def _transient(dev: torch.device, fn) -> int | None:
    """Peak device bytes ``fn`` allocated beyond what was allocated before."""
    if dev.type != "cuda":
        fn()
        return None
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev) - base)


def _plain_vs_blocked(index: PlaceIndex, desc: np.ndarray, dev: torch.device) -> dict:
    """The full-sort plain version over the whole device buffer (the serving
    path before blocked retrieval) against the serving path on the index's
    snapshot and the same descriptors; on the card both are timed by CUDA
    events."""
    dbj, scj, _, rows = index._snapshot_db(len(desc), K)  # one shard a list
    q = torch.from_numpy(desc).to(dev)
    if index.quantize == "int8":
        def plain():
            return topk_neighbors_quantized_plain(q, dbj[0], scj[0], K)
    else:
        def plain():
            return topk_neighbors_plain(q, dbj[0], K)

    def blocked():
        return index._retrieve(q, dbj, scj, K, rows)

    with torch.inference_mode():
        ids_p, d_p = plain()
        ids_b, d_b = blocked()
        out = {"capacity": _capacity(dbj),
               "ids_equal": bool(torch.equal(ids_p, ids_b)),
               "max_abs_dist_diff": float((d_p - d_b).abs().max()),
               "plain_transient_bytes": _transient(dev, plain),
               "blocked_transient_bytes": _transient(dev, blocked)}
        if dev.type == "cuda":
            out["plain_ms"] = cuda_ms(plain, 5)
            out["blocked_ms"] = cuda_ms(blocked, 5)
    return out


def ladder(embed, dim: int, query_pts: np.ndarray, rungs, quantize: str, dev: torch.device,
           iters: int = 30, plain_at=()) -> list[dict]:
    """The DB-size ladder of one ``quantize`` mode (module docstring)."""
    b = len(query_pts)
    index = PlaceIndex(embed, dim, embed_batch=b, quantize=quantize, max_k=K,
                       num_points=query_pts.shape[1], device=dev)
    index.warmup()
    index.add(query_pts, metadata=[f"planted_{i}" for i in range(b)])
    planted_desc = index._db[:b].copy()
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    rows = []
    for target in rungs:
        grew, syncs = 0, []
        while len(index) < target:
            need = target - len(index)
            n = int(min(need, max(1, target // 8) * (0.5 + rng.random())))
            index.add_descriptors(unit_rows(gen, n, dim))
            cap0 = index.metrics()["device_rows_capacity"]
            t0 = time.perf_counter()
            index.query(query_pts[:1], k=1)  # syncs the chunk
            syncs.append(time.perf_counter() - t0)
            grew += index.metrics()["device_rows_capacity"] != cap0
        ids, _ = index.query(query_pts, k=1)
        planted_ok = int((ids[:, 0] == np.arange(b)).sum())
        index.query(query_pts, k=K)  # warm at this capacity
        lat = []
        for _ in range(iters):
            t0 = time.perf_counter()
            index.query(query_pts, k=K)
            lat.append(time.perf_counter() - t0)
        m = index.metrics()
        with torch.inference_mode():
            row = {
                "rows": len(index), "quantize": quantize,
                "capacity": m["device_rows_capacity"], "device_bytes": m["device_bytes"],
                "batch": b, "iters": iters, **_pcts(lat),
                "qps": b / float(np.mean(lat)),
                "planted_rank0": f"{planted_ok}/{b}",
                "retrieval_transient_bytes": _transient(
                    dev, lambda: index.query_descriptors(planted_desc, k=K)),
                "fused_query_transient_bytes": _transient(
                    dev, lambda: index.query(query_pts, k=K)),
                "append_chunks": len(syncs), "capacity_doublings": int(grew),
                "sync_query_ms_max": max(syncs) * 1e3 if syncs else None,
            }
        if target in plain_at:
            row["plain_vs_blocked"] = _plain_vs_blocked(index, planted_desc, dev)
        rows.append(row)
    return rows


def load(embed, dim: int, query_pts: np.ndarray, dev: torch.device) -> dict:
    """Concurrent single-submap queries through the QueryScheduler: 8
    threads of 12 each."""
    threads, per = 8, 12
    index = PlaceIndex(embed, dim, embed_batch=len(query_pts), num_points=query_pts.shape[1],
                       device=dev)
    index.warmup()
    index.add(query_pts)
    sched = QueryScheduler(index, k=5, max_wait_ms=5.0)
    lat, fails = [], []
    try:
        sched.submit(query_pts[0]).result(timeout=600)  # warm
        m0 = sched.metrics()

        def caller(tid):
            r = np.random.default_rng(tid)
            for _ in range(per):
                j = int(r.integers(len(query_pts)))
                t0 = time.perf_counter()
                ids, _ = sched.submit(query_pts[j]).result(timeout=600)
                lat.append(time.perf_counter() - t0)
                if ids[0] != j:
                    fails.append((tid, j, int(ids[0])))

        pool = [threading.Thread(target=caller, args=(t,)) for t in range(threads)]
        t0 = time.perf_counter()
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        m = sched.metrics()
    finally:
        sched.stop()
    dispatches = m["dispatches"] - m0["dispatches"]
    return {"threads": threads, "queries": len(lat), "self_retrieval_fails": fails,
            **_pcts(lat), "qps": len(lat) / wall, "dispatches": dispatches,
            "avg_batch": (m["requests"] - m0["requests"]) / max(dispatches, 1)}


def _oracle_tops(d: np.ndarray, k: int) -> list[tuple[int, tuple]]:
    """[(L, ids)]: the exact top-k (ascending distance, then row) of the
    prefix of length L, listed at each L where it changes."""
    first = min(k, len(d))
    cut = np.sort(d[:first])[-1]  # a later row must beat this to enter
    cand = np.concatenate([np.arange(first), first + np.nonzero(d[first:] < cut)[0]])
    top: list = []
    out = []
    for j in cand:
        top = sorted(top + [(float(d[j]), int(j))])[:k]
        if int(j) in [i for _, i in top]:
            out.append((int(j) + 1, tuple(i for _, i in top)))
    return out


def _answer_ok(ids: np.ndarray, lo: int, hi: int, tops, d: np.ndarray) -> bool:
    """``ids`` is the top-k of some prefix L in [lo, hi] (ties within 1e-5
    in distance allowed)."""
    i = max(0, int(np.searchsorted([L for L, _ in tops], lo, side="right")) - 1)
    for _, want in [tops[i]] + [t for t in tops[i + 1:] if t[0] <= hi]:
        want = np.asarray(want)
        if len(want) == len(ids) and ((want == ids) | (np.abs(d[want] - d[ids]) <= 1e-5)).all():
            return True
    return False


def _sqdist64(q: np.ndarray, db: np.ndarray, chunk: int = 100_000) -> np.ndarray:
    """[Q, N] float64 squared distances, a chunk of rows at a time."""
    q = q.astype(np.float64)
    qq = (q * q).sum(1)[:, None]
    out = np.empty((len(q), len(db)))
    for s in range(0, len(db), chunk):
        b = db[s:s + chunk].astype(np.float64)
        out[:, s:s + chunk] = qq + (b * b).sum(1)[None] - 2.0 * (q @ b.T)
    return out


def ingest(embed, dim: int, query_pts: np.ndarray, dev: torch.device, rows: int,
           cross_growth: bool = False) -> dict:
    """The background ingest (module docstring); one thread a planted submap.

    A base of random rows is synced first. By default it fills the device
    DB past half the capacity the ingest ends in, so that no capacity
    doubling falls inside the ingest and every chunk is written in place.
    With ``cross_growth`` the base ends half the ingest short of half that
    capacity, so the capacity doubles halfway through. A query's retrieval
    scans the synced rows (``n_valid``), not the capacity: it slows as the
    prefix grows, which the after window, over every row, shows."""
    k, threads, chunks, idle_s, after_s = 5, min(8, len(query_pts)), 10, 2.0, 1.0
    index = PlaceIndex(embed, dim, embed_batch=len(query_pts), num_points=query_pts.shape[1],
                       sync_mode="background", device=dev)
    index.warmup()
    index.add(query_pts)
    # each thread's descriptor as its query computes it: submap t alone in
    # a padded batch
    qdesc = np.concatenate([index.embed(query_pts[t:t + 1]) for t in range(threads)])
    gen = torch.Generator(device=dev).manual_seed(7)
    rng = np.random.default_rng(7)
    planted = len(query_pts)
    cap = index.block_rows
    while cap < 2 * (rows + planted):
        cap *= 2
    if cross_growth:
        base = cap // 2 - planted - rows // 2
    else:
        base = cap // 2 - planted + (cap // 2 - rows) // 2 + 1
    index.add_descriptors(unit_rows(gen, base, dim))
    index.flush()
    capacity_before = index.metrics()["device_rows_capacity"]
    data = unit_rows(gen, rows, dim)
    per = rows // chunks
    for c in range(chunks):  # two rows near each query descriptor, nearer each chunk
        eps = 0.3 * 0.7 ** c
        at = c * per + rng.choice(per, 2 * threads, replace=False)
        near = np.repeat(qdesc, 2, axis=0) + eps * rng.standard_normal((2 * threads, dim))
        data[at] = near / np.linalg.norm(near, axis=1, keepdims=True)

    chunk_s, chunk_at, grew, dispatch, adds = [], [], [], [], []
    sync_chunk, query = index._sync_chunk, index.query  # bound methods

    def timed_chunk():  # runs under the sync lock: _dev_db changes only here
        cap0 = 0 if index._dev_db is None else _capacity(index._dev_db)
        t0 = time.perf_counter()
        try:
            return sync_chunk()
        finally:
            chunk_s.append(time.perf_counter() - t0)
            chunk_at.append(t0)
            grew.append(index._dev_db is not None and _capacity(index._dev_db) != cap0)

    def timed_query(pts, kq):  # the scheduler's dispatch
        t0 = time.perf_counter()
        try:
            return query(pts, kq)
        finally:
            dispatch.append((t0, time.perf_counter() - t0))

    gc_at, gc_s = [], []
    gc_objects = len(gc.get_objects())  # what a full collection walks

    def timed_gc(phase, info):  # the collector's pauses (all threads wait)
        if phase == "start":
            gc_at.append(time.perf_counter())
        else:
            gc_s.append((info["generation"], time.perf_counter() - gc_at[-1]))

    index._sync_chunk, index.query = timed_chunk, timed_query
    # what earlier windows and phases left is freed now, not inside the
    # windows below (freeing a 10^6-row index's buffers takes ~200 ms)
    gc.collect()
    gc.callbacks.append(timed_gc)
    log, errors = [], []
    stop = threading.Event()
    go = [True]  # read by every client after the barrier that set it
    rounds = threading.Barrier(threads, action=lambda: go.__setitem__(0, not stop.is_set()))
    # one dispatch a round: it fires when the round's last request arrives
    # (the wait only caps a straggler); the clients read the synced rows
    # directly (an int), so that the harness adds little to a request
    sched = QueryScheduler(index, k=k, max_batch=threads, max_wait_ms=50.0)

    def worker(t):
        while True:
            try:
                rounds.wait(timeout=600)
            except threading.BrokenBarrierError:
                return
            if not go[0]:
                return
            lo = index._dev_rows
            t0 = time.perf_counter()
            try:
                ids, _ = sched.submit(query_pts[t]).result(timeout=600)
            except Exception as e:  # reported and failed on below
                errors.append(repr(e))
                rounds.abort()
                return
            t1 = time.perf_counter()
            log.append((t, t0, t1 - t0, lo, index._dev_rows, ids))

    pool = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(threads)]
    for t in pool:
        t.start()
    time.sleep(idle_s)
    t_start = time.perf_counter()
    for c in range(chunks):
        t0 = time.perf_counter()
        index.add_descriptors(data[c * per:(c + 1) * per if c < chunks - 1 else rows])
        adds.append((t0, time.perf_counter() - t0))
    t_added = time.perf_counter()
    index.flush()
    t_flushed = time.perf_counter()
    capacity = index.metrics()["device_rows_capacity"]
    time.sleep(after_s)
    stop.set()
    for t in pool:
        t.join(timeout=120)
    alive = sum(t.is_alive() for t in pool)
    avg_batch = sched.metrics()["avg_batch"]
    sched.stop()
    gc.callbacks.remove(timed_gc)
    del index._sync_chunk, index.query  # the class's methods again (no cycle)

    # every answer: the exact top-k of a prefix in [visible when sent, visible after]
    d_all = _sqdist64(qdesc, index._db)  # [threads, rows]
    tops = [_oracle_tops(d_all[t], k) for t in range(threads)]
    bad = [(t, lo, hi, ids.tolist()) for t, _, _, lo, hi, ids in log
           if not _answer_ok(ids, lo, hi, tops[t], d_all[t])]
    final_ids, _ = index.query_descriptors(qdesc, k=k)
    final_ok = all(tuple(final_ids[t]) == tops[t][-1][1] for t in range(threads))
    m = index.metrics()

    def windows(spans):  # [(sent, seconds)] -> idle / during / after
        return {"idle": _pcts([dt for t0, dt in spans if t0 + dt < t_start]),
                "during": _pcts([dt for t0, dt in spans if t_start <= t0 <= t_flushed]),
                "after_flush": _pcts([dt for t0, dt in spans if t0 > t_flushed])}

    lat = windows([(t0, dt) for _, t0, dt, *_ in log])
    chunk_ms = np.asarray(chunk_s) * 1e3
    out = {
        "rows_added": rows, "base_rows": base + planted, "capacity_before": capacity_before,
        "capacity": capacity, "capacity_fixed": capacity == capacity_before == cap,
        "capacity_doubled": 2 * capacity_before == capacity == cap,
        "threads": threads, "k": k, "quantize": index.quantize,
        "sync_chunk_rows": index.sync_chunk_rows, "add_s": t_added - t_start,
        "ingest_to_flushed_s": t_flushed - t_start, **lat,
        "dispatch": windows(dispatch), "chunks_synced": len(chunk_s),
        "chunk_ms_median": float(np.median(chunk_ms)), "chunk_ms_max": float(chunk_ms.max()),
        "growth_chunk_ms": [float(c) for c, g in zip(chunk_ms, grew) if g],
        # when (ms after the first add) and how long: the adds, the chunks,
        # the collector's pauses (with their generation) and the 5 longest
        # queries sent during the ingest
        "timeline_ms": {
            "adds": [((t0 - t_start) * 1e3, dt * 1e3) for t0, dt in adds],
            "chunks": [((t0 - t_start) * 1e3, dt * 1e3) for t0, dt in zip(chunk_at, chunk_s)
                       if t0 >= t_start],
            "gc_over_1ms": [((t0 - t_start) * 1e3, g, dt * 1e3)
                            for t0, (g, dt) in zip(gc_at, gc_s) if dt > 1e-3],
            "longest_during": sorted([((t0 - t_start) * 1e3, dt * 1e3) for _, t0, dt, *_ in log
                                      if t_start <= t0 <= t_flushed], key=lambda x: -x[1])[:5]},
        "answers_checked": len(log), "answers_not_a_prefix_top_k": bad[:5],
        "n_bad_answers": len(bad), "errors": errors[:3], "threads_alive": alive,
        "all_visible_after_flush": bool(m["device_synced_rows"] == m["size"] == rows + base
                                        + planted and final_ok),
        "avg_batch": avg_batch, "gc_objects": gc_objects,
    }
    if all(lat[w]["n"] for w in lat):
        # the same statistic on both sides: the longest query
        out["no_sync_max_ms"] = max(lat["idle"]["max_ms"], lat["after_flush"]["max_ms"])
        out["bound_ms"] = out["no_sync_max_ms"] + out["chunk_ms_max"]
        out["margin_ms"] = out["bound_ms"] - lat["during"]["max_ms"]
        out["within_bound"] = bool(out["margin_ms"] >= 0)
    return out


def run(dev: torch.device, rungs=(10_000, 100_000, 1_000_000), quantize=("none", "int8"),
        do_load: bool = False, do_ingest: bool = False, ingest_rows: int = 1_000_000,
        iters: int = 30, plain_at=(100_000, 1_000_000), cfg: ModelConfig | None = None,
        embed=None, batch: int = 32, ingest_repeats: int = 1) -> dict:
    cfg = cfg or ModelConfig()
    embed = embed or build_embed_fn(cfg, dev, variables=init_flat_variables(cfg, 0))
    query_pts = blob_submaps(np.random.default_rng(3), batch, cfg.num_points)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "timer": "host", "num_points": cfg.num_points, "embed_batch": batch, "k": K,
           "ladder": {}}
    for qmode in quantize:
        out["ladder"][qmode] = ladder(embed, cfg.output_dim, query_pts, rungs, qmode, dev,
                                      iters, plain_at)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if do_load:
        out["load"] = load(embed, cfg.output_dim, query_pts, dev)
    repeats = []
    for rep in range(ingest_repeats if do_ingest else 0):
        for name, growth in (("ingest", False), ("ingest_growth", True)):
            r = ingest(embed, cfg.output_dim, query_pts, dev, ingest_rows, growth)
            out.setdefault(name, r)  # the first repetition in full
            repeats.append({"window": name, "during_max_ms": r["during"].get("max_ms"),
                            **{key: r.get(key) for key in (
                                "no_sync_max_ms", "chunk_ms_max", "growth_chunk_ms",
                                "bound_ms", "margin_ms", "within_bound", "n_bad_answers",
                                "all_visible_after_flush")},
                            # where a window missed its bound, what happened when
                            **({} if r.get("within_bound", True) else {
                                w: r[w] for w in ("idle", "during", "after_flush",
                                                  "dispatch", "timeline_ms")})})
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    if ingest_repeats > 1 and repeats:
        out["ingest_repeats"] = repeats  # the check's spread, every window
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rungs", default=None, help="comma-separated DB sizes")
    ap.add_argument("--quantize", default="none,int8")
    ap.add_argument("--load", action="store_true")
    ap.add_argument("--ingest", action="store_true")
    ap.add_argument("--ingest_rows", type=int, default=None)
    ap.add_argument("--ingest_repeats", type=int, default=1,
                    help="run both ingest windows this many times (margins of each)")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join("build", "serve_scale.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    rungs = [int(r) for r in args.rungs.split(",") if r] if args.rungs is not None else (
        [10_000, 100_000, 1_000_000] if cuda else [2_000, 10_000])
    kw = {} if cuda else {"cfg": SMALL, "batch": 4, "plain_at": tuple(rungs[-1:])}
    res = run(dev, rungs, tuple(q for q in args.quantize.split(",") if q), args.load,
              args.ingest, args.ingest_rows or (1_000_000 if cuda else 20_000), args.iters,
              ingest_repeats=args.ingest_repeats, **kw)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({"serve_scale": res}))
    return res


if __name__ == "__main__":
    main()
