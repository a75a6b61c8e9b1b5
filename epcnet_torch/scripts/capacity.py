"""Capacity on the card: the largest training batch and the largest submap
(counterpart of ``scripts/hw_train_capacity.py`` and
``scripts/hw_capacity_gather.py``).

  python -m epcnet_torch.scripts.capacity [--train] [--giant] [--embed] \\
      [--ladder 2,4,6,8,12,16,24,32,48,64] [--giant_ns 32768,65536,131072] \\
      [--embed_past 262144,524288] [--device cuda] [--out build/capacity.json]

With none of ``--train``, ``--giant`` and ``--embed`` all three parts run.
The model is the full-width EPC-Net (``ModelConfig()``: k=20, bf16
backbone, fp32 VLAD) from seeded weights (``init_flat_variables(cfg, 0)``);
the clouds are seeded blob submaps (``train_bench.blob_submaps``).

- ``train_ladder``: the largest ``batch_num_queries`` that trains at
  N=4096 under four memory configurations (``CONFIGS``: baseline,
  ``remat``, ``remat`` with ``grad_accum_steps`` 2 and 4), smallest B first
  over ``LADDER`` (JAX's 2..32, extended to 64 for the card's 80 GB); a B
  the accumulation count does not divide is skipped, as in JAX. A tuple is
  22 clouds: 1 query, 2 positives, 18 negatives and the other negative.
  Rung B takes the first B tuples of one seeded set
  (``train_bench.tuple_batch(SEED, ...)``). ``saved_for_backward`` adds,
  at the baseline's first rung, the bytes the forward saves for backward
  by the module that saved them.
- ``train_giant``: JAX's ``EPCNET_CAP_N`` runs: B=1, full tuples, at
  N in ``GIANT_NS``, baseline and ``remat``, on the route ``auto`` takes in
  training (gather from N=32768).
- ``embed_ladder``: ``hw_capacity_gather.py``'s rungs (``EMBED_RUNGS``:
  dense, packed and gather at (16384, B=4) and (32768, B=2); gather at
  65536 and 131072, B=1), then gather at B=1 past JAX (``EMBED_PAST``)
  until the first rung that runs out of memory. Each rung: ms a batch by
  CUDA events (the median of 5 calls after a warm-up), submaps a second,
  peak memory, and the route ``auto`` takes at that N. Where two or more
  routes ran at one N, their descriptors must agree within ``ROUTE_TOL``.

A training rung runs one warm-up step from the seeded weights (its loss is
the rung's ``loss``), then ``steps`` steps under CUDA events (ms a step,
submaps a second); its peak is ``torch.cuda.max_memory_allocated`` over all
of them after ``reset_peak_memory_stats``. Only
``torch.cuda.OutOfMemoryError`` ends a ladder: the rung becomes ``{"oom":
true, "message": <its first 200 characters>}``; any other exception
propagates. After every rung, fitting or not, its state, step and batch
are dropped, ``gc.collect()`` and ``torch.cuda.empty_cache()`` run, and
the memory allocated must be back within ``MEM_SLACK`` of what it was
before the rung, so that a leaked buffer cannot move the next rung's wall.
Every rung prints one JSON line.

``main`` prints one JSON line and writes ``--out``; it exits non-zero after
writing where a cross-route check failed. With ``--device cpu`` it runs a
tiny model at tiny sizes on host clocks (``"timer": "host"``; no number of
it is a device time, and memory is not measured); without a card the
default device raises.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import numpy as np
import torch

from epcnet_torch.configs import ModelConfig, TrainConfig
from epcnet_torch.device import resolve_device
from epcnet_torch.models.epcnet import adjacency_route
from epcnet_torch.scripts.train_bench import SMALL, blob_submaps, mean_ms, tuple_batch
from epcnet_torch.train.state import create_train_state
from epcnet_torch.train.step import build_embed_fn, build_train_step, to_device
from epcnet_torch.weights import init_flat_variables

POS, NEG = 2, 18  # a tuple: 1 query, 2 positives, 18 negatives, the other negative
TUPLE_CLOUDS = POS + NEG + 2
# (name, remat, grad_accum_steps), in JAX's order
CONFIGS = (("baseline", False, 1), ("remat", True, 1), ("remat+accum2", True, 2),
           ("remat+accum4", True, 4))
LADDER = (2, 4, 6, 8, 12, 16, 24, 32, 48, 64)
GIANT_NS = (32768, 65536, 131072)
EMBED_RUNGS = tuple((n, b, fmt) for n, b in ((16384, 4), (32768, 2))
                    for fmt in ("dense", "packed", "gather")) + (
    (65536, 1, "gather"), (131072, 1, "gather"))
EMBED_PAST = (262144, 524288)
SEED = 1
# what a rung may leave allocated once it is dropped
MEM_SLACK = 64 << 20
# chip_smoke.py::ROUTE_TOL: a 1-ulp bf16 difference in a neighbour mean
# moves a descriptor entry by ~1e-4
ROUTE_TOL = 1e-3


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev: torch.device) -> int | None:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def run_rung(fn, dev: torch.device, label: str) -> dict:
    """``fn()``'s row, or ``{"oom": true, "message": ...}`` where the card ran
    out of memory (no other exception is caught). Then the rung's memory is
    freed and must be back within ``MEM_SLACK`` of what was allocated before
    it (``memory_left``: the bytes still allocated above that). Prints the
    row as one JSON line under ``label``."""
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    try:
        row = fn()
    except torch.cuda.OutOfMemoryError as e:
        row = {"oom": True, "message": str(e)[:200]}
    # the exception and fn's frames are gone here; their tensors with them
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        # cuBLAS keeps a workspace a handle and stream in the allocator from
        # its first call on; freed here, so the first rung leaves none either
        torch._C._cuda_clearCublasWorkspaces()
        left = torch.cuda.memory_allocated(dev) - before
        if left > MEM_SLACK:
            raise RuntimeError(f"{label}: {left} bytes still allocated after the rung "
                               f"(limit {MEM_SLACK})")
        row["memory_left"] = left
    print(json.dumps({label: row}), flush=True)
    return row


def _train_rung(cfg: ModelConfig, train_cfg: TrainConfig, batch_np: dict, steps: int,
                dev: torch.device) -> dict:
    state = create_train_state(cfg, train_cfg, dev, variables=init_flat_variables(cfg, 0))
    step = build_train_step(cfg, train_cfg)
    batch = to_device(batch_np, dev)
    clouds = sum(int(np.prod(v.shape[:-2])) for v in batch.values())
    losses = []

    def one():
        nonlocal state
        state, m = step(state, batch)
        losses.append(m["loss"])

    _reset_peak(dev)
    ms = mean_ms(one, steps, dev)  # the warm-up step, then `steps` under the clock
    return {"clouds": clouds, "ms_per_step": ms, "submaps_per_s": clouds / ms * 1e3,
            "max_memory_allocated": _peak(dev), "loss": float(losses[0]),
            "loss_last": float(losses[-1])}


def train_ladder(cfg: ModelConfig, n: int = 4096, ladder=LADDER, configs=CONFIGS,
                 steps: int = 3, dev=None) -> dict:
    """The training ladder at N=``n`` (see the module docstring): per
    configuration its rows (``b``, then the rung's fields or ``oom``) and
    ``max_b``, the largest B that fit (0: none)."""
    dev = resolve_device(dev)
    cfg = cfg.variant(num_points=n)
    tuples = tuple_batch(SEED, max(ladder), POS, NEG, n)
    out = {}
    for name, remat, accum in configs:
        rows = []
        for b in ladder:
            if b % accum:
                continue
            tc = TrainConfig(batch_num_queries=b, remat=remat, grad_accum_steps=accum)
            batch = {k: v[:b] for k, v in tuples.items()}
            row = run_rung(lambda: _train_rung(cfg, tc, batch, steps, dev), dev,
                           f"train {name} n={n} b={b}")
            rows.append({"b": b, **row})
            if row.get("oom"):
                break
        fits = [r for r in rows if not r.get("oom")]
        out[name] = {"remat": remat, "grad_accum_steps": accum, "route":
                     adjacency_route(cfg, n, train=True), "rows": rows,
                     "max_b": fits[-1]["b"] if fits else 0,
                     "ms_per_step_at_max_b": fits[-1]["ms_per_step"] if fits else None}
    return out


def train_giant(cfg: ModelConfig, ns=GIANT_NS, configs=CONFIGS[:2], steps: int = 3,
                dev=None) -> dict:
    """B=1 with full tuples at each N of ``ns`` on ``auto``'s training
    route; an out-of-memory rung ends that configuration's N ladder. Per
    configuration its rows (``n``, ``route``, then the rung's fields or
    ``oom``) and ``max_n``."""
    dev = resolve_device(dev)
    out = {}
    for name, remat, accum in configs:
        rows = []
        for n in ns:
            gcfg = cfg.variant(num_points=n)
            tc = TrainConfig(batch_num_queries=1, remat=remat, grad_accum_steps=accum)
            row = run_rung(lambda: _train_rung(gcfg, tc, tuple_batch(SEED + n, 1, POS, NEG, n),
                                               steps, dev), dev, f"giant {name} n={n}")
            rows.append({"n": n, "route": adjacency_route(gcfg, n, train=True), **row})
            if row.get("oom"):
                break
        fits = [r["n"] for r in rows if not r.get("oom")]
        out[name] = {"remat": remat, "grad_accum_steps": accum, "rows": rows,
                     "max_n": max(fits, default=0)}
    return out


def median_ms(fn, reps: int, dev: torch.device) -> float:
    """Median ms of ``reps`` calls of ``fn``: CUDA events around each call on
    the card, the host clock on the CPU. The caller warms up."""
    ts = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def embed_clouds(n: int, b: int) -> np.ndarray:
    """The embed ladder's clouds at N=``n``: the first ``b`` of one seeded
    set, the same for every route and batch."""
    return blob_submaps(np.random.default_rng(n), b, n)


def embed_rung(cfg: ModelConfig, flat: dict, n: int, b: int, fmt: str, reps: int,
               dev: torch.device) -> tuple[dict, np.ndarray]:
    """One embed rung on route ``fmt``: its row and the descriptors [b, D]."""
    embed = build_embed_fn(cfg.variant(num_points=n, adjacency_format=fmt), dev, flat)
    x = torch.tensor(embed_clouds(n, b), device=dev)
    _reset_peak(dev)
    desc = embed(x).float().cpu().numpy()  # the warm-up call
    ms = median_ms(lambda: embed(x), reps, dev)
    return {"ms_per_batch": ms, "submaps_per_s": b / ms * 1e3,
            "max_memory_allocated": _peak(dev), "finite": bool(np.isfinite(desc).all())}, desc


def embed_ladder(cfg: ModelConfig, rungs=EMBED_RUNGS, past=EMBED_PAST, reps: int = 5,
                 dev=None) -> tuple[dict, dict]:
    """The embed ladder (see the module docstring). Returns (result, the
    descriptors by ``(n, route)``); ``result["route_gap"][str(n)]`` is the
    largest gap of any route's descriptors from the first route's at that N
    (over the clouds both embedded)."""
    dev = resolve_device(dev)
    flat = init_flat_variables(cfg, 0)
    rows, descs = [], {}

    def rung(n, b, fmt):
        def fn():
            row, descs[(n, fmt)] = embed_rung(cfg, flat, n, b, fmt, reps, dev)
            return row
        row = run_rung(fn, dev, f"embed {fmt} n={n} b={b}")
        rows.append({"n": n, "b": b, "route": fmt, "auto_route": adjacency_route(cfg, n),
                     **row})
        return row

    for n, b, fmt in rungs:
        rung(n, b, fmt)
    for n in past:
        if rung(n, 1, "gather").get("oom"):
            break
    gaps = {}
    for n in sorted({n for n, _ in descs}):
        got = [d for (m, _), d in descs.items() if m == n]
        if len(got) > 1:
            gaps[str(n)] = max(float(np.abs(d[:len(got[0])] - got[0][:len(d)]).max())
                               for d in got[1:])
    return {"rows": rows, "route_gap": gaps, "tolerance": ROUTE_TOL}, descs


def saved_for_backward(cfg: ModelConfig, b: int = 2, n: int = 4096, top: int = 5,
                       dev=None) -> dict:
    """The bytes one training step's forward (baseline, the ladder's first B)
    saves for backward, by the module that saved them: a
    ``saved_tensors_hooks`` pack hook sees each saved tensor, and forward
    hooks on every module name the innermost one running. A storage saved
    by several ops (the bf16 indicator every layer's A @ F keeps) counts
    once, for the first module that saved it; the parameters count under
    ``(parameters)`` and what the loss saves outside the model under
    ``(loss)``. Each module's row names its largest storage (bytes, and the
    shape and dtype of the tensor first saved from it). Nothing on the
    step's path changes: the hook returns each tensor as it is."""
    dev = resolve_device(dev)
    cfg = cfg.variant(num_points=n)
    tc = TrainConfig(batch_num_queries=b)
    state = create_train_state(cfg, tc, dev, variables=init_flat_variables(cfg, 0))
    params = {p.untyped_storage().data_ptr() for p in state.model.parameters()}
    stack, seen = [], {}

    def pack(t):
        s = t.untyped_storage()
        key = s.data_ptr()
        if key not in seen:
            owner = "(parameters)" if key in params else (stack[-1] if stack else "(loss)")
            seen[key] = (owner, s.nbytes(), list(t.shape), str(t.dtype).replace("torch.", ""))
        return t

    def enter(name):
        def hook(_mod, _args):
            stack.append(name or "(model)")
        return hook

    def leave(_mod, _args, _out):
        stack.pop()

    handles = []
    for name, mod in state.model.named_modules():
        handles += [mod.register_forward_pre_hook(enter(name)),
                    mod.register_forward_hook(leave)]
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            build_train_step(cfg, tc)(state, tuple_batch(SEED, b, POS, NEG, n))
    finally:
        for h in handles:
            h.remove()
    by = {}
    for owner, nbytes, shape, dtype in seen.values():
        row = by.setdefault(owner, {"module": owner, "bytes": 0, "storages": 0,
                                    "largest": {"bytes": 0}})
        row["bytes"] += nbytes
        row["storages"] += 1
        if nbytes > row["largest"]["bytes"]:
            row["largest"] = {"bytes": nbytes, "shape": shape, "dtype": dtype}
    ranked = sorted(by.values(), key=lambda r: -r["bytes"])
    total = sum(r["bytes"] for r in ranked)
    return {"b": b, "n": n, "clouds": b * TUPLE_CLOUDS, "saved_bytes": total,
            "saved_bytes_outside_parameters": total - by.get("(parameters)", {}).get("bytes", 0),
            "top": ranked[:top], "modules": len(ranked)}


def _ints(text: str) -> tuple[int, ...]:
    return tuple(int(v) for v in text.split(",") if v)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true", help="the N=4096 training ladder")
    ap.add_argument("--giant", action="store_true", help="B=1 training at giant N")
    ap.add_argument("--embed", action="store_true", help="the embed ladder")
    ap.add_argument("--ladder", type=_ints, default=None, help="the training ladder's B")
    ap.add_argument("--giant_ns", type=_ints, default=None)
    ap.add_argument("--embed_past", type=_ints, default=None,
                    help="gather rungs past JAX's at B=1")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join("build", "capacity.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    parts = [p for p in ("train", "giant", "embed") if getattr(args, p)] or [
        "train", "giant", "embed"]
    if cuda:
        cfg, n, ladder = ModelConfig(), 4096, LADDER
        giant_ns, rungs, past = GIANT_NS, EMBED_RUNGS, EMBED_PAST
    else:  # the tiny model at tiny sizes
        cfg, n, ladder, giant_ns, past = SMALL, 256, (2, 4), (512,), (1024,)
        rungs = tuple((256, 2, f) for f in ("dense", "packed", "gather")) + ((512, 1, "gather"),)
    res = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "timer": "cuda_events" if cuda else "host", "k": cfg.knn_k,
           "compute_dtype": cfg.compute_dtype, "tuple_clouds": TUPLE_CLOUDS}
    if "train" in parts:
        ladder = args.ladder or ladder
        res["train"] = {"n": n, "ladder": list(ladder),
                        "saved_for_backward": run_rung(
                            lambda: saved_for_backward(cfg, ladder[0], n, dev=dev), dev,
                            "saved_for_backward"),
                        "configs": train_ladder(cfg, n, ladder, CONFIGS, dev=dev)}
    if "giant" in parts:
        res["giant"] = train_giant(cfg, args.giant_ns or giant_ns, dev=dev)
    if "embed" in parts:
        res["embed"], _ = embed_ladder(cfg, rungs, args.embed_past or past, dev=dev)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({"capacity": res}))
    bad = {n_: g for n_, g in res.get("embed", {}).get("route_gap", {}).items() if g > ROUTE_TOL}
    if bad:
        raise RuntimeError(f"routes disagree beyond {ROUTE_TOL}: {bad}")
    return res


if __name__ == "__main__":
    main()
