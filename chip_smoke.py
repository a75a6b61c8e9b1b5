#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``epcnet_torch``) on one card.

  python3 chip_smoke.py

Builds every CUDA kernel of the serving path from ``epcnet_torch/csrc`` with
nvcc, holds each against its plain PyTorch version on the card, builds the
full-width EPC-Net (the default ModelConfig: 2,742,144 parameters, N=4096,
k=20, bf16) from seeded random weights, and serves it: a PlaceIndex (fp32,
then int8) takes 64 seeded submaps and answers requests through
``PlaceIndex.query`` and ``QueryScheduler``; every submap must retrieve
itself at rank 0. Kernel launch counts are zeroed just before that serving
run and read just after it.

Output: progress lines, then a ``{"kernels": [...]}`` line, timing lines,
the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a card it exits 2 and prints no result. Needs no network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from epcnet_torch.configs import ModelConfig
from epcnet_torch.models import param_count
from epcnet_torch.ops import _build, knn
from epcnet_torch.serve import PlaceIndex, QueryScheduler
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.weights import init_flat_variables

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_ULP = 2.0 ** -7


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def submaps(rng, count: int, n: int):
    """Seeded place-like submaps: each a few gaussian blobs ("buildings"),
    3-12 of them with random sizes and shares, clipped to [-1, 1] — the
    geometry of epcnet_tpu's synthetic dataset, kept here so the script
    needs nothing of that package."""
    out = np.empty((count, n, 3), np.float32)
    for i in range(count):
        nb = int(rng.integers(3, 13))
        centers = rng.uniform(-0.8, 0.8, (nb, 3))
        scales = rng.uniform(0.02, 0.2, (nb, 1))
        pick = rng.choice(nb, n, p=rng.dirichlet(np.ones(nb)))
        out[i] = np.clip(centers[pick] + scales[pick] * rng.standard_normal((n, 3)), -1, 1)
    return out


def check_k1(x, k, dtype, with_proxy=True) -> float:
    """K1 against its plain version on the same card tensors: the indicator
    exactly equal, the proxy within 1 bf16 ulp (bf16) or 1e-6 relative
    (fp32). Returns the proxy's max abs difference."""
    adj, proxy = knn.knn_adjacency_cuda(x, k, dtype, with_proxy)
    adj_p, proxy_p = knn.knn_adjacency_plain(x, k, dtype, with_proxy)
    torch.cuda.synchronize()
    bad = int((adj != adj_p).sum())
    assert bad == 0, f"K1 indicator differs in {bad} entries (B,N,k={tuple(x.shape[:2])},{k})"
    assert bool((adj.sum(-1, dtype=torch.int32) == k).all()), "rows without k ones"
    if not with_proxy:
        assert proxy is None
        return 0.0
    got, want = proxy.float(), proxy_p.float()
    err = (got - want).abs()
    if dtype == torch.bfloat16:
        spacing = BF16_ULP * torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(2.0 ** -126))))
        assert bool((err <= spacing).all()), f"K1 proxy off by more than 1 bf16 ulp: {err.max()}"
    else:
        assert bool((err <= 1e-6 * want.abs() + 1e-7).all()), f"K1 proxy fp32 error {err.max()}"
    return float(err.max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no card, no result",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build(["knn_adj"])
    log(f"phase build: {time.perf_counter() - t0:.3f} s")
    for src, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {src}: {line.strip()}")

    # -- 2. K1 against its plain version -----------------------------------
    cfg = ModelConfig()  # N=4096, k=20, bf16
    n, k, bf16 = cfg.num_points, cfg.knn_k, torch.bfloat16
    rng = np.random.default_rng(0)

    def cloud(b, npts):
        return torch.tensor(rng.uniform(-1, 1, (b, npts, 3)).astype(np.float32), device=dev)

    x8 = cloud(8, n)
    x32 = cloud(32, n)
    err = check_k1(x8, k, bf16)
    err = max(err, check_k1(x32, k, bf16))  # the serving batch
    grid = torch.round(cloud(2, n) * 6) / 6  # coarse grid: ties everywhere
    grid[0, 40:61] = grid[0, 5]
    check_k1(grid, k, bf16)
    check_k1(grid, k, torch.float32)
    check_k1(torch.ones(1, 1000, 3, device=dev), k, bf16)  # all identical
    check_k1(cloud(3, 1000), k, bf16)  # odd N
    check_k1(cloud(2, 1001), 7, torch.float32)
    check_k1(cloud(2, 33), 33, bf16)  # k = N
    check_k1(cloud(1, 1), 1, bf16)
    check_k1(cloud(2, 517), 20, bf16, with_proxy=False)
    check_k1(cloud(1, 20000), k, bf16)  # xyz read from global memory
    log(f"phase K1 check: ok (indicator exact on 11 cases; proxy max abs err {err})")

    # -- 3. the full-width model from seeded weights -----------------------
    flat = init_flat_variables(cfg, seed=0)
    embed = build_embed_fn(cfg, variables=flat)
    model = embed.model
    assert param_count(model) == 2_742_144, param_count(model)
    log(f"phase model: epcnet, {param_count(model)} params, N={n}, k={k}, {cfg.compute_dtype}")

    # -- 4. descriptors: kernel path against the plain-twin path -----------
    with torch.inference_mode():
        d_kernel = embed(x8)
        d_plain = model.forward_graph(x8, *knn.knn_adjacency_plain(x8, k, bf16))
    torch.cuda.synchronize()
    assert d_kernel.shape == (8, 256) and bool(torch.isfinite(d_kernel).all())
    norms = torch.linalg.vector_norm(d_kernel, dim=-1)
    assert bool(((norms - 1).abs() < 1e-5).all()), norms
    desc_err = float((d_kernel - d_plain).abs().max())
    # a 1-ulp bf16 proxy difference moves a descriptor entry by ~1e-4
    assert desc_err <= 1e-3, desc_err
    log(f"phase descriptors: kernel vs plain-twin path max abs err {desc_err}")

    # -- 5. serving: the main path, with launch counts zeroed --------------
    sub = submaps(np.random.default_rng(1), 64, n)
    knn.knn_adjacency_cuda.launches = 0
    requests = 0
    for quant in ("none", "int8"):
        ix = PlaceIndex(embed, cfg.output_dim, embed_batch=32, quantize=quant,
                        num_points=n)
        ix.warmup()
        ix.add(sub, metadata=[f"submap_{i}" for i in range(len(sub))])
        for s in (0, 32):  # every added submap retrieves itself at rank 0
            ids, _ = ix.query(sub[s:s + 32], k=5)
            np.testing.assert_array_equal(ids[:, 0], np.arange(s, s + 32))
        for i in range(8):  # single-submap requests
            ids, _ = ix.query(sub[7 * i:7 * i + 1], k=5)
            assert ids[0, 0] == 7 * i, (quant, i, ids)
        requests += 8
        sched = QueryScheduler(ix, k=5, max_wait_ms=5.0)
        try:
            futs = [sched.submit(sub[i]) for i in range(3, 64, 4)]
            for j, fut in enumerate(futs):
                ids, dists = fut.result(timeout=300)
                assert ids[0] == 3 + 4 * j and np.isfinite(dists).all(), (quant, j, ids)
            requests += len(futs)
            m = sched.metrics()
            assert m["errors"] == 0 and m["requests"] == len(futs)
        finally:
            sched.stop()
        assert ix.metadata([5]) == ["submap_5"]
        log(f"phase serve {quant}: 64 submaps self-retrieved at rank 0; "
            f"{ix.metrics()['queries']} queries, scheduler avg batch {m['avg_batch']:.2f}")
    launches = knn.knn_adjacency_cuda.launches
    assert launches >= 1, "the serving path never launched K1"
    log(f"phase serve: {requests} requests answered; K1 launches {launches}")

    # -- 6. timings --------------------------------------------------------
    def k1_numbers(x):
        b = x.shape[0]
        ms = cuda_ms(lambda: knn.knn_adjacency_cuda(x, k, bf16), 20)
        plain = cuda_ms(lambda: knn.knn_adjacency_plain(x, k, bf16), 3)
        nbytes = b * n * 3 * 4 + b * n * n + b * n * 3 * 2
        ops = 8 * b * n * n  # 3 sub, 3 mul, 2 add per pair
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return ms, plain, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    ms32, plain32, bound32, by32 = k1_numbers(x32)
    ms8, plain8, bound8, by8 = k1_numbers(x8)
    with torch.inference_mode():
        pts32 = torch.tensor(sub[:32], device=dev)
        embed_ms = cuda_ms(lambda: embed(pts32), 5)
    ix = PlaceIndex(embed, cfg.output_dim, embed_batch=32, num_points=n)
    ix.add(sub)
    ix.query(sub[:1], k=5)
    q_ms = []
    for i in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ix.query(sub[i:i + 1], k=5)  # returns host arrays: includes the sync
        q_ms.append((time.perf_counter() - t) * 1e3)

    log(json.dumps({"kernels": [{
        "name": "knn_adj", "route": "cuda", "source": "epcnet_torch/csrc/knn_adj.cu",
        "replaces": "epcnet_tpu/ops/knn.py:68", "launches": launches,
        "max_abs_err": err, "ms": ms32, "plain_ms": plain32,
        "bound_ms": bound32, "bound_by": by32, "library_ms": None,
        "shape": [32, n, 3], "k": k,
    }]}))
    log(json.dumps({"k1_b8": {"ms": ms8, "plain_ms": plain8, "bound_ms": bound8,
                              "bound_by": by8, "shape": [8, n, 3], "k": k}}))
    log(json.dumps({"serve": {"embed_batch32_ms": embed_ms,
                              "query1_ms_median": sorted(q_ms)[len(q_ms) // 2],
                              "query1_ms_min": min(q_ms), "query1_ms": q_ms,
                              "db_rows": len(ix)}}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
