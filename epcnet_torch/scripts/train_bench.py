"""Where a training step's time goes on the card.

  python -m epcnet_torch.scripts.train_bench [--steps 10] [--device cuda] \\
      [--out build/train_bench.json]

The full-width EPC-Net (``ModelConfig()``: 2,742,144 parameters, k=20, bf16
backbone, fp32 VLAD) from seeded weights (``init_flat_variables(cfg, 0)``),
trained on one fixed batch of seeded blob submaps:

- ``dense``: the default tuple batch, 2 tuples of 1 query, 2 positives, 18
  negatives and the other negative (44 clouds) at N=4096: the dense route,
  K1 once a step;
- ``dense_remat`` and ``dense_accum2``: the same with ``remat=True`` and
  with ``grad_accum_steps=2``;
- ``gather``: N=32768, the gather route (K2; where ``auto`` takes it in
  training), on 1 tuple of 1 query, 1 positive, 2 negatives and the other negative (5
  clouds: the batch is cut, not the width).

For each: ms a step by CUDA events (the mean of ``--steps`` steps after 2
warm-up steps), submaps a second, the peak of ``torch.cuda.
max_memory_allocated`` over the timed steps, and a ``torch.profiler`` trace
of 3 more steps read by span (``utils/profiling.py::region_ms``, the device
time launched inside each): ``train/forward`` (which holds
``epcnet/knn_graph``, the kNN kernel), ``train/backward``,
``train/bn_update`` and ``train/optimizer``; ``knn_share`` is the kNN span's
device time over the step's; ``ops_ms_per_step`` is the device time of all
the step's kernels (so 1 - it / ``ms_per_step`` is the share the card
idles) and ``top_ops`` the 8 costliest (``top_device_ops``). ``mining_refresh`` (``mining_refresh_ms``)
times ``MiningCache.refresh`` over a dataset, when ``mining_root`` is given
(``bench_mining``).

The result is one JSON line, also written to ``--out``. With ``--device
cpu`` it runs at a tiny size on host clocks (``"timer": "host"``; no number
of it is a device time); without a card the default device raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity

from epcnet_torch.configs import DataConfig, ModelConfig, TrainConfig
from epcnet_torch.data.tuples import TrainingTuples
from epcnet_torch.device import resolve_device
from epcnet_torch.models.epcnet import adjacency_route
from epcnet_torch.train.mining import MiningCache
from epcnet_torch.train.state import create_train_state
from epcnet_torch.train.step import build_train_step, to_device
from epcnet_torch.utils.profiling import region_ms, top_device_ops
from epcnet_torch.utils.timing import cuda_ms
from epcnet_torch.weights import init_flat_variables

SPANS = ("train/forward", "train/backward", "train/bn_update", "train/optimizer",
         "epcnet/knn_graph")
# the tiny model the scripts run on the CPU
SMALL = ModelConfig(num_points=256, knn_k=8, proxyconv_channels=(16, 16),
                    lift_channels=(32, 64), feature_dim=64, vlad_clusters=8, vlad_groups=4,
                    vlad_group_dim=16)


def blob_submaps(rng: np.random.Generator, count: int, n: int) -> np.ndarray:
    """Seeded place-like submaps: each a few gaussian blobs, 3-12 of them
    with random sizes and shares, clipped to [-1, 1] (the geometry of the
    synthetic dataset)."""
    out = np.empty((count, n, 3), np.float32)
    for i in range(count):
        nb = int(rng.integers(3, 13))
        centers = rng.uniform(-0.8, 0.8, (nb, 3))
        scales = rng.uniform(0.02, 0.2, (nb, 1))
        pick = rng.choice(nb, n, p=rng.dirichlet(np.ones(nb)))
        out[i] = np.clip(centers[pick] + scales[pick] * rng.standard_normal((n, 3)), -1, 1)
    return out


def tuple_batch(seed: int, b: int, p: int, ng: int, n: int) -> dict:
    """B tuples of 1 query, P positives, Ng negatives and the other
    negative, as the loader emits them (numpy)."""
    clouds = blob_submaps(np.random.default_rng(seed), b * (p + ng + 2), n)
    clouds = clouds.reshape(b, p + ng + 2, n, 3)
    return {"query": clouds[:, 0], "positives": clouds[:, 1:1 + p],
            "negatives": clouds[:, 1 + p:1 + p + ng], "other_neg": clouds[:, -1]}


def mean_ms(fn, reps: int, dev: torch.device) -> float:
    """Mean ms of ``reps`` calls of ``fn`` after a warm-up call: CUDA events
    on the card (``cuda_ms``), the host clock on the CPU."""
    if dev.type == "cuda":
        return cuda_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def bench_step(cfg: ModelConfig, train_cfg: TrainConfig, batch: dict, steps: int,
               dev: torch.device) -> dict:
    """One training configuration: see the module docstring."""
    state = create_train_state(cfg, train_cfg, dev, variables=init_flat_variables(cfg, 0))
    step = build_train_step(cfg, train_cfg)
    batch = to_device(batch, dev)
    clouds = sum(int(np.prod(v.shape[:-2])) for v in batch.values())

    def one():
        nonlocal state
        state, m = step(state, batch)
        return m

    one()  # the kernels' builds and cuBLAS's choices outside the clock
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    ms = mean_ms(one, steps, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(3):
            m = one()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    ops = top_device_ops(prof, top=8)
    found = {**region_ms(prof, "train/"), **region_ms(prof, "epcnet/knn_graph")}
    spans = {k: {"count": v["count"], "ms_per_step": v["total_ms"] / 3}
             for k, v in found.items() if k in SPANS}
    parts = sum(spans.get(k, {"ms_per_step": 0.0})["ms_per_step"] for k in SPANS[:4])
    knn = spans.get("epcnet/knn_graph", {"ms_per_step": 0.0})["ms_per_step"]
    return {"n": cfg.num_points, "route": adjacency_route(cfg, cfg.num_points, train=True),
            "clouds": clouds, "remat": train_cfg.remat,
            "grad_accum_steps": train_cfg.grad_accum_steps, "ms_per_step": ms,
            "submaps_per_s": clouds / ms * 1e3, "max_memory_allocated": peak,
            "spans": spans, "span_sum_ms": parts,
            "knn_share": knn / ms if ms else None, "loss": float(m["loss"]),
            "ops_ranked_by": ops["ranked_by"], "ops_ms_per_step": ops["total_ms"] / 3,
            "top_ops": [dict(r, ms_per_step=r.pop("total_ms") / 3) for r in ops["top"]]}


def bench_mining(cfg: ModelConfig, root: str, tuples: dict, dev: torch.device) -> dict:
    """One ``MiningCache.refresh`` over ``tuples`` (warm: a first refresh
    runs outside the clock), host clock with a final synchronise."""
    state = create_train_state(cfg, TrainConfig(), dev, variables=init_flat_variables(cfg, 0))
    cache = MiningCache(TrainingTuples(tuples), DataConfig(dataset_root=root,
                                                            num_points=cfg.num_points),
                        TrainConfig())
    cache.refresh(state.model)
    t0 = time.perf_counter()
    cache.refresh(state.model)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"submaps": len(tuples), "batch_size": cache.batch_size, "mining_refresh_ms": ms,
            "submaps_per_s": len(tuples) / ms * 1e3}


def run(dev: torch.device, steps: int, n: int = 4096, n_gather: int = 32768,
        cfg: ModelConfig | None = None) -> dict:
    cfg = cfg or ModelConfig(num_points=n)
    base = TrainConfig()
    dense = tuple_batch(1, base.batch_num_queries, 2, 18, n)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "timer": "cuda_events" if dev.type == "cuda" else "host", "k": cfg.knn_k,
           "compute_dtype": cfg.compute_dtype}
    out["dense"] = bench_step(cfg, base, dense, steps, dev)
    out["dense_remat"] = bench_step(cfg, dataclasses.replace(base, remat=True), dense, steps, dev)
    out["dense_accum2"] = bench_step(cfg, dataclasses.replace(base, grad_accum_steps=2), dense,
                                     steps, dev)
    gcfg = cfg.variant(num_points=n_gather, adjacency_format="gather")
    out["gather"] = bench_step(gcfg, dataclasses.replace(base, batch_num_queries=1),
                               tuple_batch(2, 1, 1, 2, n_gather), steps, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join("build", "train_bench.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        res = run(dev, args.steps)
    else:  # a tiny size: the plain versions on host clocks
        res = run(dev, args.steps, n=256, n_gather=512, cfg=SMALL)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({"train_bench": res}))
    return res


if __name__ == "__main__":
    main()
