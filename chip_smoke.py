#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``epcnet_torch``) on one card.

  python3 chip_smoke.py

Builds every CUDA kernel of the port from ``epcnet_torch/csrc`` with nvcc
(K1/K3 ``knn_adj.cu``, K2 ``knn_ids.cu``, K4 ``packed_mean.cu``, K5
``knn_phase.cu``, K6 ``knn_pipelined.cu``; K1-K3, K5 and K6 on the tiled
core ``knn_tile.cuh`` for k (K5: rounds) <= 32; the ptxas report of every
tiled kernel and of K4 must show no spill), holds each against its plain
PyTorch version on the card, builds the full-width EPC-Net
(the default ModelConfig: 2,742,144 parameters, k=20, bf16) from seeded
random weights, and serves it on each adjacency route:

- dense (N=4096): a PlaceIndex (fp32, then int8) takes 64 seeded submaps and
  answers requests through ``PlaceIndex.query`` and ``QueryScheduler``;
- the capacity routes: at N=32768 ``auto`` takes the packed route (K3 + K4)
  and at N=65536 the gather route (K2); an index takes 16 and 8 submaps.

Every submap must retrieve itself at rank 0. Kernel launch counts are zeroed
just before each serving run and read just after it. At N=32768 the three
routes also run side by side on the same clouds and weights, and their
descriptors must agree.

Then the rest of serving, counts zeroed before each phase: "serve http"
runs the serve CLI's ``make_server`` over a ``--log_dir`` that
``cli/convert.py`` wrote from the seeded weights (``--name_map self``):
``/healthz``, ``/add`` of the 64 submaps with metadata, 64 ``/query`` from 8
threads (each at rank 0 with its metadata), ``/query_batch``, ``/metrics``
(average micro-batch above 1), a 400 and a 404; "serve drain" runs the CLI
in a subprocess, which warms up before it binds and on SIGTERM drains and
saves (``--save_on_exit``): the saved DB equals its ``/embed`` descriptors
and reloads. "convert" renames the weights to the tf1_epcnet layout (the
importer's NAME_MAPS inverted) and to an unlabelled torch dict (``auto``),
converts and serves each: descriptors bit-equal to the bridge's. "serve
scale" runs ``scripts/serve_scale.run``: the fp32 and int8 ladders at 10^4,
10^5 and 10^6 rows (planted submaps at rank 0, fused-query p50/p99 and qps,
``device_bytes``, one query's transient memory, which at 2^20 int8 must stay
below the 268 MB resident DB and within 10% of the 10^5 rung's; the full
sort beside the blocked path at 10^5 and 10^6, ids equal) and the 8-thread load
test; "serve ingest" adds 10^6 rows in the background while 8 threads
query in rounds, once at a fixed capacity and once across a capacity
doubling: every answer the exact top-5 of a prefix at least as long as the
one visible when it was sent, every row visible after ``flush()``, and no
query during the ingest longer than the longest query with no sync in
flight plus the longest chunk. "sampling"
holds each sampling op on the card to the CPU at B=2, N=4096, npoint=1024.

Then recall@N evaluation ("evaluate"): ``cli/generate_tuples.py`` writes a
synthetic dataset of 5 runs x 80 submaps x 4096 points at difficulty 0.5
and its test pickles into a temporary directory; the full-width EPC-Net's
seeded weights go to an export pair (``weights.save_export``), and
``cli/evaluate.py`` evaluates it on the card with the latency probe, counts
zeroed before it (K1 must launch, its value rounds never), in the scan and
the pickle form, each equal to ``evaluate_dataset`` in process. Every
database submap's descriptor from ``embed_entries`` (through K1) is held
against the plain-twin path in the CLI's batches of 64 (K1 itself held
against its plain version on run 0's two batches), every submap retrieves itself (fp32 and
int8), and the full-width PointNetVLAD is evaluated on the same data. The
bf16 GEMM check holds the card's full-width descriptors against JAX's
(``tests/torch_bf16_fullwidth.npz``) with cuBLAS's reduced-precision bf16
reduction allowed and not.

Then the kNN trace path (``epcnet_torch.scripts.knn_trace``), counts zeroed
before it: a profiler trace of B=8 forwards at N=4096, the phase ablation
(K5 after 1 and k distinct values and the threshold count, then K1; all on
the tiled core at k=20, which the counts and ``phase_cores`` must show) and
K6 against K1; then the ablation at B=32, N=4096 (the serving batch) and
B=2, N=32768 (the packed route's), and at k=33, where K5's value rounds
still run, at B=2 either side of their shared-memory cutoff (N=16384 and
N=20480).

Then training, counts zeroed before each phase: "train check" takes one
step of the full-width model (Adam) on the default tuple batch, 44 blob
submaps at N=4096 (K1 launched once), and the same step from the same
weights on the plain twins' graph: the indicators equal, the loss, every
gradient and the BN statistics within ``TRAIN_TOL``, and
``matmul_f32acc``'s backward within 1 bf16 ulp of fp32 ``torch.matmul``
at the A @ F shape; "train parity" holds the card's fp32 step at a small
width (N=128, k=8) to JAX's in ``tests/torch_train_step.npz`` within
``PARITY_TOL``; "train gather" takes one step at N=32768 (5 clouds: the
batch cut, not the width) on the gather route through K2 against its
plain twin (ids equal, loss within ``TRAIN_TOL``); "train loop" runs
``cli/train.py`` on 2 runs x 20 synthetic submaps for 2 epochs (a mining
refresh in the second), restores to a third (the log shows the restored
step and only epoch 2), exports and evaluates, and reports the loss by
epoch and K1's launches by steps, mining and evaluation; "pointnetvlad
train" (3 steps at lr 5e-5) and "distill" (10 steps, EPC-Net teacher,
EPC-Net-L student; the mimic loss must fall). "train timings" runs
``scripts/train_bench.run``: ms a step, peak memory and the step's spans
for the dense step, with remat, with accumulation over 2, and at N=32768.

Then the multi-device phase (``scripts/multidevice.py``), at full width:
(a) one process over ``make_mesh(devices=[cuda:0, cuda:0])``: sharded and
ring top-k at 10^6 rows (fp32 and int8) return the unsharded blocked ids
exactly, the 64 serving submaps planted at rank 0, and a sharded
``PlaceIndex`` answers them through ``QueryScheduler`` from 8 threads, p50
and p99 beside the unsharded index's (counts zeroed: K1 embeds the
requests); (b) a world of two ranks sharing the card over gloo (spawn, a
FileStore): the data-parallel step of the 44-cloud batch in bf16 and fp32,
the ring kNN and the points-sharded embed at N=131072 (bf16; fp32 at
65536) and the points-sharded tuple step at N=32768, each held against
the single-device path (``multidevice.TOL``), each rank's K1 and K2
launches counted; (c) a world of one over NCCL through
``maybe_initialize_distributed``: the data-parallel step timed against the
plain one, and ``cli/train.py --mesh`` for two steps; and which raw
collectives gloo runs on CUDA tensors (each must include
``collectives.GLOO_CUDA_OPS``).

Then, counts zeroed before each phase: "benchmark cli" runs
``cli/benchmark.py --json`` at B=32, N=4096 (K2 and K1 must launch; K2's
ids equal ``knn_plain``'s on the CLI's clouds); "train quality" runs (a)
the CI-scale quality band (``scripts/multiseed.ci_run``: 3 runs x 40
submaps x 256 points, difficulty 0.5, the tiny model, 6 epochs) on the
card, seed 1234 before and after training and the seeds 1234, 7 and 2024,
held to ``multiseed.CI_BAND`` (seed 1234's two loss curves compared and
reported), and (b) seed 1234's full-width teacher of the difficulty-0.5
protocol through the CLIs (``multiseed.run``: 5 x 80 x 4096, 15 epochs,
lr 2e-4, mining from epoch 5), recall@1 held to ``multiseed.BAND``'s
teacher floor (JAX's 92.48% less 5 points), K1 counted by train steps,
mining and evaluation; "compile cache" runs ``cli/benchmark.py`` in a
process with ``--compilation_cache_dir`` a fresh directory (K1's and K2's
libraries built there) and again in a process with no nvcc to find, which
loads them from there.

Output: progress lines with each phase's seconds, then a ``{"kernels":
[...]}`` line, timing lines, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a card it exits 2 and prints no result. Needs no network.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from epcnet_torch.cli import benchmark, convert, evaluate, export, generate_tuples, train
from epcnet_torch.cli import serve as serve_cli
from epcnet_torch.configs import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
    epcnet_l_config,
    pointnetvlad_config,
)
from epcnet_torch.data import load_pc_files_native, load_pickle, native_available
from epcnet_torch.evals import embed_entries, evaluate_dataset, get_recall
from epcnet_torch.models import get_model, param_count
from epcnet_torch.models.epcnet import adjacency_route
from epcnet_torch.models.vlad_head import compute_dtype
from epcnet_torch.ops import _build, adjacency, knn, knn_phases, sampling
from epcnet_torch.ops.matmul import matmul_f32acc
from epcnet_torch.parallel.collectives import GLOO_CUDA_OPS
from epcnet_torch.scripts import knn_trace, multidevice, multiseed, serve_scale, train_bench
from epcnet_torch.serve import PlaceIndex, QueryScheduler
from epcnet_torch.train.mining import MiningCache
from epcnet_torch.train.state import create_train_state
from epcnet_torch.train.step import build_distill_step, build_embed_fn, build_train_step, to_device
from epcnet_torch.utils import compile_cache, importer
from epcnet_torch.utils.timing import cuda_ms
from epcnet_torch.weights import (
    flat_grads,
    flat_variables,
    init_flat_variables,
    load_flat_variables,
    save_export,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# fp32 instructions a second outside the tensor cores: 132 SMs x 128 lanes x
# 1.98 GHz. The data sheet's 67 TFLOP/s counts an FMA as two operations, but
# the kernels are built with -fmad=false and spell out __fmul_rn/__fadd_rn,
# so that distances stay bit-equal to the plain version: each of a pair's 8
# operations is an instruction of its own.
FP32_OPS_PER_S = 132 * 128 * 1.98e9
BF16_ULP = 2.0 ** -7
# a 1-ulp bf16 difference in a neighbour mean moves a descriptor entry by
# ~1e-4 (K1 against its plain twin at N=4096); the routes are held to 1e-3
ROUTE_TOL = 1e-3
# the port against JAX in bf16 (tests/test_torch_models.py)
BF16_TOL = 2e-4
# PointNetVLAD at the published widths, from jax.eval_shape of the JAX model
# (tests/test_torch_models.py::test_pointnetvlad_full_width_params)
PNV_PARAMS = 19_786_505
# JAX's full-width bf16 descriptors for the bf16 GEMM check
BF16_FULLWIDTH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                              "torch_bf16_fullwidth.npz")
# every launch counter of the port: (wrapper, attribute)
COUNTERS = {
    "K1": (knn.knn_adjacency_cuda, "launches"),
    "K1'": (knn.knn_adjacency_cuda, "launches_no_proxy"),
    "K1 k>32": (knn.knn_adjacency_cuda, "launches_rounds"),
    "K2": (knn.knn_cuda, "launches"),
    "K2 k>32": (knn.knn_cuda, "launches_rounds"),
    "K3": (knn.knn_packed_cuda, "launches"),
    "K3 k>32": (knn.knn_packed_cuda, "launches_rounds"),
    "K4": (adjacency.packed_neighbor_mean_cuda, "launches"),
    "K5": (knn_phases.knn_phase_cuda, "launches"),
    "K5 r>32": (knn_phases.knn_phase_cuda, "launches_rounds"),
    "K6": (knn_phases.knn_adjacency_pipelined_cuda, "launches"),
    "K6 k>32": (knn_phases.knn_adjacency_pipelined_cuda, "launches_rounds"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def zero_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


@contextlib.contextmanager
def k1_inside(owner, attr: str, tally: list):
    """While the block runs, ``owner.attr`` adds the K1 launches made inside
    each of its calls to ``tally[0]``."""
    real = getattr(owner, attr)

    def counted(*args, **kwargs):
        before = read_counts()["K1"]
        try:
            return real(*args, **kwargs)
        finally:
            tally[0] += read_counts()["K1"] - before

    setattr(owner, attr, counted)
    try:
        yield
    finally:
        setattr(owner, attr, real)


class Phase:
    """Times a phase on the host clock and prints its seconds."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            torch.cuda.synchronize()
            log(f"phase {self.name}: {time.perf_counter() - self.t0:.2f} s")


def bf16_spacing(want: torch.Tensor) -> torch.Tensor:
    return BF16_ULP * torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))))


def bound(nbytes: float, ops: float):
    """The least time for the work, in ms, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def check_k1(x, k, dtype, with_proxy=True, splits=()) -> float:
    """K1 against its plain version on the same card tensors: the indicator
    exactly equal, the proxy within 1 bf16 ulp (bf16) or 1e-6 relative
    (fp32); the value rounds run only for k > 32; then with each of
    ``splits`` threads a row forced on the tiled core, the indicator and the
    proxy equal the wrapper's. Returns the proxy's max abs difference."""
    rounds = knn.knn_adjacency_cuda.launches_rounds
    adj, proxy = knn.knn_adjacency_cuda(x, k, dtype, with_proxy)
    assert knn.knn_adjacency_cuda.launches_rounds - rounds == (k > 32), (k, "core")
    adj_p, proxy_p = knn.knn_adjacency_plain(x, k, dtype, with_proxy)
    torch.cuda.synchronize()
    shape = tuple(x.shape[:2])
    bad = int((adj != adj_p).sum())
    assert bad == 0, f"K1 indicator differs in {bad} entries (B,N,k={shape},{k})"
    assert bool((adj.sum(-1, dtype=torch.int32) == k).all()), "rows without k ones"
    for split in splits:
        adj_s, proxy_s, ran_rounds = knn._launch_adj(x, k, dtype, with_proxy, False, "K1", split)
        assert not ran_rounds, f"a forced S ran the value rounds (k={k})"
        torch.cuda.synchronize()
        assert torch.equal(adj_s, adj_p), f"K1 differs at S={split} (B,N,k={shape},{k})"
        assert not with_proxy or torch.equal(proxy_s, proxy), f"K1 proxy differs at S={split}"
        del adj_s
    del adj, adj_p
    if not with_proxy:
        assert proxy is None
        return 0.0
    got, want = proxy.float(), proxy_p.float()
    err = (got - want).abs()
    if dtype == torch.bfloat16:
        assert bool((err <= bf16_spacing(want)).all()), \
            f"K1 proxy off by more than 1 bf16 ulp: {err.max()}"
    else:
        assert bool((err <= 1e-6 * want.abs() + 1e-7).all()), f"K1 proxy fp32 error {err.max()}"
    return float(err.max())


def check_k2(x, k, with_adjacency=False, splits=()) -> float:
    """K2 against its plain version: ids and distances exactly equal (and
    the optional indicator equal to K1's plain version), through the
    wrapper and then with each of ``splits`` threads a row forced on the
    tiled core. Returns the distances' max abs difference."""
    out = knn.knn_cuda(x, k, return_dists=True, with_adjacency=with_adjacency)
    ids_p, dists_p = knn.knn_plain(x, k, return_dists=True)
    torch.cuda.synchronize()
    shape = tuple(x.shape[:2])
    assert torch.equal(out[0], ids_p), f"K2 ids differ (B,N,k={shape},{k})"
    assert torch.equal(out[1], dists_p), f"K2 distances differ (B,N,k={shape},{k})"
    for split in splits:
        ids, dists = torch.empty_like(ids_p), torch.empty_like(dists_p)
        assert not knn._launch_ids(x, k, ids, dists, None, split), \
            f"a forced S ran the value rounds (k={k})"
        torch.cuda.synchronize()
        assert torch.equal(ids, ids_p) and torch.equal(dists, dists_p), \
            f"K2 differs at S={split} (B,N,k={shape},{k})"
    if with_adjacency:
        adj_p, _ = knn.knn_adjacency_plain(x, k, with_proxy=False)
        assert torch.equal(out[2], adj_p), f"K2 indicator differs (B,N,k={shape},{k})"
    return float((out[1] - dists_p).abs().max())


def check_k3(x, k, dtype, splits=(), sign_bit=True) -> float:
    """K3 against its plain version: the planes exactly equal, the proxy
    within 1 bf16 ulp (bf16) or 1e-6 relative (fp32), and equal to K1's bit
    for bit (the one cross-check between the tiled core and K1's); then
    with each of ``splits`` threads a row forced on the tiled core. Returns
    the proxy's max abs difference."""
    planes, proxy = knn.knn_packed_cuda(x, k, dtype)
    planes_p, proxy_p = knn.knn_adjacency_plain(x, k, dtype, fmt="packed")
    torch.cuda.synchronize()
    bad = int((planes != planes_p).sum())
    assert bad == 0, f"K3 planes differ in {bad} words (B,N,k={tuple(x.shape[:2])},{k})"
    assert bool((planes < 0).any()) or not sign_bit, "plane 31 (the sign bit) never set"
    for split in splits:
        planes_s, proxy_s, rounds = knn._launch_adj(x, k, dtype, True, True, "K3", split)
        assert not rounds, f"a forced S ran the value rounds (k={k})"
        torch.cuda.synchronize()
        assert torch.equal(planes_s, planes_p) and torch.equal(proxy_s, proxy), \
            f"K3 differs at S={split} (B,N,k={tuple(x.shape[:2])},{k})"
        del planes_s
    del planes_p
    got, want = proxy.float(), proxy_p.float()
    err = (got - want).abs()
    if dtype == torch.bfloat16:
        assert bool((err <= bf16_spacing(want)).all()), f"K3 proxy error {err.max()}"
    else:
        assert bool((err <= 1e-6 * want.abs() + 1e-7).all()), f"K3 proxy error {err.max()}"
    proxy_k1 = knn.knn_adjacency_cuda(x, k, dtype)[1]
    assert torch.equal(proxy, proxy_k1), "K3's proxy differs from K1's"
    return float(err.max())


def x_sorted(x):
    """The cloud stored in ascending x: a scanner's order, the worst case for
    the tiled core's insertions."""
    order = torch.sort(x[..., 0], dim=-1, stable=True).indices
    return torch.gather(x, 1, order[..., None].expand(-1, -1, 3)).contiguous()


def check_k4(f, planes, k, dtype) -> float:
    """K4 against its plain version (unpack, then cuBLAS with an fp32 sum):
    the two sum in another order, so they differ by fp32 rounding of the
    sum, at most ~1e-6 of the mean of |F| over the set bits; bf16 results
    are held to 1 bf16 ulp plus that, fp32 results to that. Returns the max
    abs difference."""
    got = adjacency.packed_neighbor_mean_cuda(f, planes, k, dtype).float()
    want = adjacency.packed_neighbor_mean_plain(f, planes, k, dtype).float()
    scale = adjacency.packed_neighbor_mean_plain(f.abs(), planes, k, dtype).float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1.01e-6 * scale + (bf16_spacing(want) if f.dtype == torch.bfloat16 else 0)
    assert bool((err <= tol).all()), f"K4 error {float(err.max())} above tolerance"
    return float(err.max())


def check_k5(x, rounds, thresh, splits=()):
    """K5 against its plain version: exactly equal (the same fp32 arithmetic
    on the card; +inf where the row has fewer than ``rounds`` distinct
    values); the value rounds run only for rounds > 32; then with each of
    ``splits`` threads a row forced on the tiled core, exactly equal too.
    Returns K5's output and the max abs difference (0 where both are +inf)."""
    before = knn_phases.knn_phase_cuda.launches_rounds
    got = knn_phases.knn_phase_cuda(x, rounds, thresh)
    assert knn_phases.knn_phase_cuda.launches_rounds - before == (rounds > 32), (rounds, "core")
    want = knn_phases.knn_phase_plain(x, rounds, thresh)
    torch.cuda.synchronize()
    case = f"B,N={tuple(x.shape[:2])}, rounds={rounds}, thresh={thresh}"
    err = float(torch.where(got == want, 0.0, (got - want).abs()).max())
    bad = int((got != want).sum())
    assert bad == 0, f"K5 differs in {bad} rows ({case}; max abs err {err})"
    for split in splits if rounds <= 32 else ():
        got_s, ran_rounds = knn_phases._launch_phase(x, rounds, thresh, split)
        assert not ran_rounds, f"a forced S ran the value rounds ({case})"
        torch.cuda.synchronize()
        assert torch.equal(got_s, want), f"K5 differs at S={split} ({case})"
    return got, err


def check_k6(x, k, splits=()) -> float:
    """K6 against its plain version: the indicator exactly equal, and equal
    to K1's; the fp32 proxy within 1e-6 relative (an fp32 sum of bf16 values
    in another order than cuBLAS's); the warp pairs run only for k > 32;
    then with each of ``splits`` threads a row forced on the tiled core, the
    indicator and the proxy equal the wrapper's. Returns the proxy's max abs
    difference."""
    before = knn_phases.knn_adjacency_pipelined_cuda.launches_rounds
    adj, proxy = knn_phases.knn_adjacency_pipelined_cuda(x, k)
    assert knn_phases.knn_adjacency_pipelined_cuda.launches_rounds - before == (k > 32), \
        (k, "design")
    adj_p, proxy_p = knn_phases.knn_adjacency_pipelined_plain(x, k)
    torch.cuda.synchronize()
    shape = tuple(x.shape[:2])
    assert torch.equal(adj, adj_p), f"K6 indicator differs (B,N,k={shape},{k})"
    del adj_p
    assert torch.equal(adj, knn.knn_adjacency_cuda(x, k, with_proxy=False)[0]), \
        f"K6 indicator differs from K1's (B,N,k={shape},{k})"
    assert proxy.dtype == torch.float32
    err = (proxy - proxy_p).abs()
    assert bool((err <= 1e-6 * proxy_p.abs() + 1e-7).all()), f"K6 proxy error {err.max()}"
    for split in splits if k <= 32 else ():
        adj_s, proxy_s, ran_pairs = knn_phases._launch_pipelined(x, k, split)
        assert not ran_pairs, f"a forced S ran the warp pairs (k={k})"
        torch.cuda.synchronize()
        assert torch.equal(adj_s, adj) and torch.equal(proxy_s, proxy), \
            f"K6 differs at S={split} (B,N,k={shape},{k})"
        del adj_s
    return float(err.max())


def misaligned(x):
    """x stored 4 bytes past a 16-byte boundary: K6's bulk copies then take
    a head and a tail of plain loads in every tile."""
    buf = torch.empty(x.numel() + 1, dtype=torch.float32, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 4
    return out


def evaluate_phase(embed, cfg: ModelConfig, flat: dict, tmp: str) -> dict:
    """Recall@N evaluation of the full-width EPC-Net (``embed``, weights
    ``flat``) and PointNetVLAD on BASELINE's protocol, generated under
    ``tmp``; see the module docstring. Returns what the timing lines
    print, with the launch counts of the CLI's run under ``"counts"``."""
    dev, n, k = torch.device("cuda"), cfg.num_points, cfg.knn_k
    root, log_dir = os.path.join(tmp, "data"), os.path.join(tmp, "log")
    with Phase("dataset"):
        generate_tuples.main(["--dataset_root", root, "--synthetic", "--synthetic_runs", "5",
                              "--synthetic_submaps", "80", "--synthetic_difficulty", "0.5",
                              "--num_points", str(n)])
        generate_tuples.main(["--dataset_root", root, "--mode", "test"])
        exp = ExperimentConfig(model=cfg, data=DataConfig(dataset_root=root, num_points=n))
        save_export(os.path.join(log_dir, "export"), exp, flat)
        native = native_available()  # builds the loader, outside the evaluation's time
    pickles = [os.path.join(root, f"oxford_evaluation_{part}.pickle")
               for part in ("database", "query")]
    regions = {"oxford": tuple(load_pickle(p) for p in pickles)}
    db_sets = regions["oxford"][0]
    assert [len(s) for s in db_sets] == [80] * 5, [len(s) for s in db_sets]

    with Phase("evaluate"):
        zero_counts()
        t0 = time.perf_counter()
        scan = evaluate.main(["--dataset_root", root, "--log_dir", log_dir, "--latency_probe"])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        counts = read_counts()
        assert counts["K1"] >= 1, "the evaluation never launched K1"
        assert counts["K1 k>32"] == 0, counts  # k=20: every K1 ran tiled
        pickled = evaluate.main(["--log_dir", log_dir, "--database_pickle", pickles[0],
                                 "--query_pickle", pickles[1],
                                 "--output", os.path.join(log_dir, "results_pickled.txt")])
        for name in ("results.txt", "results.json", "results_pickled.txt"):
            assert os.path.isfile(os.path.join(log_dir, name)), name
        with open(os.path.join(log_dir, "results.json")) as f:
            saved = json.load(f)
        for name, m in saved.items():
            r = np.array(m["recall_at"])
            assert r.shape == (25,) and ((r >= 0) & (r <= 1)).all(), (name, r)
            assert (np.diff(r) >= 0).all() and 0 <= m["recall_at_1pct"] <= 1, (name, m)
        direct = evaluate_dataset(embed, regions, exp.data, exp.eval)
        for form, out in (("scan", scan), ("pickle", pickled)):
            got = out["results"]["average"]
            assert np.array_equal(got["recall_at"], direct["average"]["recall_at"]), form
            assert got["recall_at_1pct"] == direct["average"]["recall_at_1pct"], form
        assert saved["average"]["recall_at"] == [float(x) for x in direct["average"]["recall_at"]]
        lat = scan["latency"]
        assert all(np.isfinite(v) and v > 0 for v in lat.values()), lat
    avg = direct["average"]
    log(f"phase evaluate: 5 x 80 submaps, {eval_s:.2f} s; untrained recall@1 "
        f"{avg['recall_at'][0]}, @1% {avg['recall_at_1pct']}; the CLI (scan and pickle "
        f"forms) equals evaluate_dataset; launches {counts}")

    with Phase("evaluate descriptors"):
        # every database submap: embed_entries (K1) against the plain-twin
        # path, in the CLI's batches (the last one 16 clouds + 48 zero ones)
        model, err, descs, bs = embed.model, 0.0, [], exp.eval.batch_size
        for r, s in enumerate(db_sets):
            d_k = embed_entries(embed, s, exp.data, bs)
            pts = load_pc_files_native([s[i]["query"] for i in range(len(s))], root, n)
            pts = np.concatenate([pts, np.zeros((-len(pts) % bs, n, 3), np.float32)])
            for b in range(0, len(s), bs):
                xb = torch.tensor(pts[b:b + bs], device=dev)
                if r == 0:  # K1 at the path's shapes, the padded batch's ties included
                    check_k1(xb, k, torch.bfloat16, splits=(1, 2, 4, 8))
                with torch.inference_mode():
                    d_p = model.forward_graph(xb, *knn.knn_adjacency_plain(xb, k, torch.bfloat16))
                cnt = min(bs, len(s) - b)
                err = max(err, float(np.abs(d_k[b:b + cnt] - d_p[:cnt].cpu().numpy()).max()))
                del xb, d_p
            descs.append(d_k)
        assert err <= ROUTE_TOL, err
        torch.cuda.empty_cache()
        # every submap retrieves itself, fp32 and int8, in its run and in all 400
        for d in descs + [np.concatenate(descs)]:
            for quant in ("none", "int8"):
                r, _, cnt = get_recall(d, d, [[i] for i in range(len(d))], quantize=quant)
                assert r[0] == 1.0 and cnt == len(d), (quant, r[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # what the CLI runs: the eval batch, file reads included
        for s in db_sets:
            embed_entries(embed, s, exp.data, exp.eval.batch_size)
        submaps_per_s = 400 / (time.perf_counter() - t0)
    log(f"phase evaluate descriptors: 400 submaps in batches of {bs}, kernel vs plain-twin "
        f"path max abs err {err} (tolerance {ROUTE_TOL}); K1 exact on run 0's batches "
        f"[{bs}, {n}, 3]; all self-retrieved at rank 0 (fp32, int8)")

    with Phase("pointnetvlad"):
        pnv_s = {}  # host seconds by step
        t0 = time.perf_counter()
        pcfg = pointnetvlad_config()
        flat_p = init_flat_variables(pcfg, seed=0)
        pnv_s["init_weights"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        embed_p = build_embed_fn(pcfg, variables=flat_p)
        torch.cuda.synchronize()
        pnv_s["build"] = time.perf_counter() - t0
        assert param_count(embed_p.model) == PNV_PARAMS, param_count(embed_p.model)
        x32 = torch.tensor(load_pc_files_native([db_sets[0][i]["query"] for i in range(32)],
                                                root, n), device=dev)
        zero_counts()
        t0 = time.perf_counter()
        d = embed_p(x32)
        assert d.shape == (32, 256) and bool(torch.isfinite(d).all())
        assert bool(((torch.linalg.vector_norm(d, dim=-1) - 1).abs() < 1e-5).all())
        pnv_s["first_embed_b32"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_p = evaluate_dataset(embed_p, regions, exp.data, exp.eval)["average"]
        torch.cuda.synchronize()
        pnv_s["evaluate_dataset"] = time.perf_counter() - t0
        assert not any(read_counts().values()), read_counts()  # no kernel of the port's
        pnv_ms = cuda_ms(lambda: embed_p(x32), 5)
        epc_ms = cuda_ms(lambda: embed(x32), 5)
    log(f"phase pointnetvlad: {PNV_PARAMS} params; untrained recall@1 {res_p['recall_at'][0]}, "
        f"@1% {res_p['recall_at_1pct']}; host seconds {pnv_s}")
    return {"counts": counts, "eval_s": eval_s, "embed_entries_submaps_per_s": submaps_per_s,
            "embed_b32_ms": {"epcnet": epc_ms, "pointnetvlad": pnv_ms},
            "latency_probe_run0": lat, "native_loader": native,
            "recall": {"epcnet": {"at_1": avg["recall_at"][0],
                                  "at_1pct": avg["recall_at_1pct"]},
                       "pointnetvlad": {"at_1": res_p["recall_at"][0],
                                        "at_1pct": res_p["recall_at_1pct"]}},
            "desc_max_abs_err": err, "batch": exp.eval.batch_size, "pointnetvlad_s": pnv_s}


def bf16_gaps(embed) -> dict:
    """The full-width bf16 descriptors on the card against JAX's on the CPU
    (the same seeded weights and clouds), max abs, with cuBLAS's
    reduced-precision bf16 reduction allowed and not; the port's setting is
    restored."""
    data = np.load(BF16_FULLWIDTH)
    x = np.random.default_rng(int(data["seed"])).uniform(-1, 1, (2, 4096, 3))
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    gaps = {}
    try:
        for allowed in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allowed
            got = embed(x.astype(np.float32)).cpu().numpy()
            gaps[f"reduced_precision_{str(allowed).lower()}"] = float(
                np.abs(got - data["descriptors"]).max())
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    gaps["port_setting"] = f"reduced_precision_{str(flag).lower()}"
    return gaps


# -- training on the card -----------------------------------------------------
# the golden small EPC-Net of the CPU tests (tests/test_torch_models.py
# GOLDEN_KW), in fp32, the width of tests/torch_train_step.npz
GOLDEN_FP32 = dict(num_points=128, knn_k=8, proxyconv_channels=(16, 16), lift_channels=(32, 64),
                   feature_dim=64, vlad_clusters=8, vlad_groups=4, vlad_group_dim=16,
                   compute_dtype="float32")
TRAIN_STEP_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                               "torch_train_step.npz")
# the card's fp32 step against JAX's (tests/test_torch_train_step.py TOL["fp32"],
# set from 8 seeds on the CPU): loss, gradient (of max(the tensor's largest,
# a tenth of the model's largest)), BN statistics
PARITY_TOL = dict(loss=5e-6, grad=2e-4, stats=5e-6)
# the kernel path against the plain-twin path, both bf16 on the card: a 1-ulp
# bf16 difference in K1's proxy moves a descriptor by ~1e-4 (ROUTE_TOL's
# note), so the loss is held to ROUTE_TOL relative; gradients (same scale
# as PARITY_TOL's) and BN statistics (O(1) values, a bf16 ulp is 4e-3) to
# 5e-2 and 1e-2
TRAIN_TOL = dict(loss=ROUTE_TOL, grad=5e-2, stats=1e-2)
# the gather phase's points: the first N where training takes the gather route
TRAIN_GATHER_N = 32768


def grad_gap(got: dict, want: dict) -> float:
    """The worst gradient gap, each tensor's over max(its largest entry, a
    tenth of the largest of all): the CPU tests' measure."""
    gmax = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), 0.1 * gmax)
               for k, w in want.items())


def stats_gap(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - w).max()) for k, w in want.items()
               if k.startswith("batch_stats/"))


def plain_graph(model, k):
    """Make ``model`` (an EPCNet) build its kNN graph with the plain twins
    (K1's and K2's plain versions on the card), so that the same step can be
    held against the kernel path."""
    def build_graph(x, route):
        if route == "gather":
            return knn.knn_plain(x, k), None
        return knn.knn_adjacency_plain(x, k, compute_dtype(model.cfg), with_proxy=True, fmt=route)
    model.build_graph = build_graph


def flat_clouds(batch: dict) -> torch.Tensor:
    parts = [batch["query"][:, None], batch["positives"], batch["negatives"],
             batch["other_neg"][:, None]]
    clouds = torch.cat(parts, dim=1)
    return clouds.reshape(-1, *clouds.shape[2:])


def check_matmul_backward(adj: torch.Tensor, dev) -> dict:
    """``matmul_f32acc``'s backward on the card against fp32 ``torch.matmul``
    gradients rounded once to the operand's dtype: the dense route's A @ F
    at the training shape (the indicator takes no gradient), and a product
    whose both operands take one. Within 1 bf16 ulp of the reference."""
    g = torch.Generator(device=dev).manual_seed(7)
    a = adj.to(torch.bfloat16)
    out = {}
    cases = {"a_at_f": (a, torch.randn(a.shape[0], a.shape[-1], 64, device=dev, generator=g)),
             "both": (torch.randn(8, 64, 4096, device=dev, generator=g),
                      torch.randn(8, 4096, 1024, device=dev, generator=g))}
    for name, (x, y) in cases.items():
        need_x = name == "both"
        xb = x.to(torch.bfloat16).requires_grad_(need_x)
        yb = y.to(torch.bfloat16).requires_grad_(True)
        prod = matmul_f32acc(xb, yb)
        assert prod.dtype == torch.float32
        cot = torch.randn(prod.shape, device=dev, generator=g)
        prod.backward(cot)
        xf = xb.detach().float().requires_grad_(need_x)
        yf = yb.detach().float().requires_grad_(True)
        torch.matmul(xf, yf).backward(cot)
        pairs = [(yb.grad, yf.grad)] + ([(xb.grad, xf.grad)] if need_x else [])
        err = 0.0
        for got, want in pairs:
            assert got.dtype == torch.bfloat16
            want_b = want.to(torch.bfloat16).float()
            e = (got.float() - want_b).abs()
            assert bool((e <= bf16_spacing(want_b)).all()), (name, float(e.max()))
            err = max(err, float(e.max()))
        out[name] = err
        del xb, yb, xf, yf, prod, cot
    torch.cuda.empty_cache()
    return out


def train_phases(dev, cfg: ModelConfig, flat: dict, tmp: str) -> dict:
    """The training phases (see the module docstring) at ``cfg``'s width;
    returns what the timing lines print, with each phase's launch counts
    under ``"counts"``."""
    ncap = TRAIN_GATHER_N
    n, k, bf16 = cfg.num_points, cfg.knn_k, torch.bfloat16
    res, counts = {}, {}
    tc = TrainConfig()

    # -- the full-width dense step through K1, against the plain-twin step --
    with Phase("train check"):
        batch = to_device(train_bench.tuple_batch(3, 2, 2, 18, n), dev)
        kst = create_train_state(cfg, tc, dev, variables=flat)
        pst = create_train_state(cfg, tc, dev, variables=flat)
        plain_graph(pst.model, k)
        step = build_train_step(cfg, tc)
        zero_counts()
        kst, km = step(kst, batch)
        torch.cuda.synchronize()
        counts["train check"] = read_counts()
        assert counts["train check"]["K1"] == 1, counts["train check"]
        assert sum(counts["train check"].values()) == 1, counts["train check"]
        pst, pm = step(pst, batch)
        assert read_counts()["K1"] == 1, "the plain-twin step launched K1"
        clouds = flat_clouds(batch)
        adj_k = knn.knn_adjacency_cuda(clouds, k, bf16)[0]
        adj_p = knn.knn_adjacency_plain(clouds, k, bf16)[0]
        assert torch.equal(adj_k, adj_p), "K1's training indicator differs from the plain one"
        del adj_p
        loss_k, loss_p = float(km["loss"]), float(pm["loss"])
        assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= TRAIN_TOL["loss"] * abs(loss_p), \
            (loss_k, loss_p)
        g_gap = grad_gap(flat_grads(kst.model), flat_grads(pst.model))
        s_gap = stats_gap(flat_variables(kst.model), flat_variables(pst.model))
        assert g_gap <= TRAIN_TOL["grad"] and s_gap <= TRAIN_TOL["stats"], (g_gap, s_gap)
        mm = check_matmul_backward(adj_k, dev)
        del adj_k, kst, pst, batch
        torch.cuda.empty_cache()
    res["train_check"] = {"clouds": int(clouds.shape[0]), "n": n, "loss": loss_k,
                          "loss_plain": loss_p, "grad_gap": g_gap, "stats_gap": s_gap,
                          "matmul_backward_max_abs": mm, "tolerance": TRAIN_TOL}
    log(f"phase train check: 44 clouds at N={n}, K1 launched once, indicator equal to the "
        f"plain one; loss {loss_k} (plain {loss_p}), gradient gap {g_gap}, BN gap {s_gap}; "
        f"matmul_f32acc backward within 1 bf16 ulp of fp32 ({mm})")

    # -- the fp32 step at the golden width against JAX's (the committed file) --
    with Phase("train parity"):
        data = dict(np.load(TRAIN_STEP_FILE))
        gcfg = ModelConfig(**GOLDEN_FP32)
        gtc = TrainConfig(learning_rate=1e-3, optimizer="momentum")
        st = create_train_state(gcfg, gtc, dev,
                                variables=init_flat_variables(gcfg, int(data["seed"])))
        gbatch = {key[6:]: v for key, v in data.items() if key.startswith("batch/")}
        zero_counts()
        st, m = build_train_step(gcfg, gtc)(st, gbatch)
        torch.cuda.synchronize()
        counts["train parity"] = read_counts()
        assert counts["train parity"]["K1"] == 1, counts["train parity"]
        want_g = {key[5:]: v for key, v in data.items() if key.startswith("grad/")}
        want_s = {key[6:]: v for key, v in data.items() if key.startswith("stats/")}
        p_loss = abs(float(m["loss"]) - float(data["loss"]))
        p_grad = grad_gap(flat_grads(st.model), want_g)
        p_stats = stats_gap(flat_variables(st.model), want_s)
        assert p_loss <= PARITY_TOL["loss"], p_loss
        assert p_grad <= PARITY_TOL["grad"] and p_stats <= PARITY_TOL["stats"], (p_grad, p_stats)
    res["train_parity"] = {"loss_gap": p_loss, "grad_gap": p_grad, "stats_gap": p_stats,
                           "tolerance": PARITY_TOL}
    log(f"phase train parity: the card's fp32 step against JAX's: loss {p_loss}, gradient "
        f"{p_grad}, BN {p_stats} (tolerances {PARITY_TOL})")

    # -- the gather route: N=32768 in training, through K2 ---------------------
    with Phase("train gather"):
        capcfg = cfg.variant(num_points=ncap)
        assert adjacency_route(capcfg, ncap, train=True) == "gather"
        gtc1 = dataclasses.replace(tc, batch_num_queries=1)
        batch = to_device(train_bench.tuple_batch(4, 1, 1, 2, ncap), dev)
        kst = create_train_state(capcfg, gtc1, dev, variables=flat)
        pst = create_train_state(capcfg, gtc1, dev, variables=flat)
        plain_graph(pst.model, k)
        step = build_train_step(capcfg, gtc1)
        zero_counts()
        kst, km = step(kst, batch)
        torch.cuda.synchronize()
        counts["train gather"] = read_counts()
        assert counts["train gather"]["K2"] == 1, counts["train gather"]
        assert sum(counts["train gather"].values()) == 1, counts["train gather"]
        pst, pm = step(pst, batch)
        assert read_counts()["K2"] == 1, "the plain-twin step launched K2"
        clouds = flat_clouds(batch)
        assert torch.equal(knn.knn_cuda(clouds, k), knn.knn_plain(clouds, k)), \
            "K2's training ids differ from the plain ones"
        lg_k, lg_p = float(km["loss"]), float(pm["loss"])
        assert np.isfinite(lg_k) and abs(lg_k - lg_p) <= TRAIN_TOL["loss"] * abs(lg_p), (lg_k, lg_p)
        del kst, pst, batch, clouds
        torch.cuda.empty_cache()
    res["train_gather"] = {"clouds": 5, "n": ncap, "loss": lg_k, "loss_plain": lg_p}
    log(f"phase train gather: 5 clouds at N={ncap} on the gather route, K2 launched once, ids "
        f"equal to the plain ones; loss {lg_k} (plain {lg_p})")

    # -- the training loop through the CLIs --------------------------------
    root, log_dir = os.path.join(tmp, "train_data"), os.path.join(tmp, "train_log")
    with Phase("train loop"):
        generate_tuples.main(["--dataset_root", root, "--synthetic", "--synthetic_runs", "2",
                              "--synthetic_submaps", "20", "--num_points", str(n)])
        cfg_path = os.path.join(tmp, "train_config.json")
        with open(cfg_path, "w") as f:  # the model of the other phases
            f.write(ExperimentConfig(model=cfg, data=DataConfig(num_points=n)).to_json())
        sets = ["data.num_positives=1", "train.max_epoch=2", "train.mining_start_epoch=1",
                "train.log_every_steps=1", "train.checkpoint_every_steps=1000000"]
        args = ["--config", cfg_path, "--dataset_root", root, "--log_dir", log_dir,
                "--tuples_pickle", os.path.join(root, "training_queries_baseline.pickle"),
                "--device", dev.type]
        args += [a for kv in sets for a in ("--set", kv)]
        mining_k1 = [0]
        with k1_inside(MiningCache, "refresh", mining_k1):
            zero_counts()
            tr = train.main(args)
            first = read_counts()
            steps = tr.state.step
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                tr2 = train.main(args + ["--restore", "--set", "train.max_epoch=3"])
            resumed = read_counts()
        text = buf.getvalue()
        print(text, end="")
        assert f"restored at step {steps}" in text, text
        assert "epoch 2:" in text and "epoch 0:" not in text and "epoch 1:" not in text, text
        assert tr2.state.step == steps * 3 // 2, (steps, tr2.state.step)
        recs = [json.loads(line) for line in open(os.path.join(log_dir, "train.jsonl"))]
        loss_by_epoch = {e: float(np.mean([r["loss"] for r in recs if r["epoch"] == e]))
                         for e in sorted({r["epoch"] for r in recs})}
        assert all(np.isfinite(v) for v in loss_by_epoch.values()), loss_by_epoch
        assert sorted(loss_by_epoch) == [0, 1, 2], loss_by_epoch
        export.main(["--log_dir", log_dir])
        zero_counts()
        ev = evaluate.main(["--dataset_root", root, "--log_dir", log_dir, "--device", dev.type])
        eval_counts = read_counts()
        r1 = float(ev["results"]["average"]["recall_at"][0])
        assert np.isfinite(r1) and eval_counts["K1"] >= 1, (r1, eval_counts)
        train_k1 = resumed["K1"] - mining_k1[0]
        assert train_k1 == tr2.state.step, (train_k1, tr2.state.step, mining_k1)
        mining = train_bench.bench_mining(cfg, root, tr.tuples.queries, dev)
    counts["train loop"] = resumed
    res["train_loop"] = {"submaps": len(tr.tuples.queries), "steps": tr2.state.step,
                         "loss_by_epoch": loss_by_epoch, "recall_at_1": r1,
                         "k1_launches": {"train_steps": train_k1, "mining": mining_k1[0],
                                         "eval": eval_counts["K1"]},
                         "mining": mining}
    log(f"phase train loop: {steps} steps in 2 epochs, restored at step {steps}, epoch 2 only "
        f"({tr2.state.step} steps in all), export + evaluate recall@1 {r1}; loss by epoch "
        f"{loss_by_epoch}; K1 launches {res['train_loop']['k1_launches']}")

    # -- PointNetVLAD and distillation steps ---------------------------------
    with Phase("pointnetvlad train"):
        pcfg = pointnetvlad_config()
        ptc = TrainConfig(learning_rate=5e-5)
        st = create_train_state(pcfg, ptc, dev, variables=init_flat_variables(pcfg, 0))
        batch = to_device(train_bench.tuple_batch(5, 2, 2, 18, n), dev)
        step = build_train_step(pcfg, ptc)
        zero_counts()
        pnv_loss = []
        for _ in range(3):
            st, m = step(st, batch)
            pnv_loss.append(float(m["loss"]))
        assert all(np.isfinite(pnv_loss)) and sum(read_counts().values()) == 0, pnv_loss
        del st
        torch.cuda.empty_cache()
    res["pointnetvlad_train"] = {"loss": pnv_loss}
    log(f"phase pointnetvlad train: 3 steps at lr 5e-5, 44 clouds, losses {pnv_loss} "
        "(library ops only)")
    with Phase("distill"):
        scfg = epcnet_l_config()
        teacher = get_model(cfg, dev)
        load_flat_variables(teacher, flat)
        dtc = TrainConfig(learning_rate=1e-3)
        st = create_train_state(scfg, dtc, dev, variables=init_flat_variables(scfg, 1))
        batch = to_device(train_bench.tuple_batch(3, 2, 2, 18, n), dev)
        step = build_distill_step(scfg, cfg, dtc, alpha=5.0)
        zero_counts()
        mimic, dloss = [], []
        for _ in range(10):
            st, m = step(st, teacher, batch)
            mimic.append(float(m["mimic_loss"]))
            dloss.append(float(m["loss"]))
        counts["distill"] = read_counts()
        assert all(np.isfinite(dloss)) and mimic[-1] < mimic[0], (dloss, mimic)
        assert counts["distill"]["K1"] == 20, counts["distill"]  # student + teacher a step
        del st, teacher
        torch.cuda.empty_cache()
    res["distill"] = {"mimic_loss": mimic, "loss": dloss}
    log(f"phase distill: 10 steps, EPC-Net teacher, EPC-Net-L student; mimic loss "
        f"{mimic[0]} -> {mimic[-1]}")
    res["counts"] = counts
    return res


def http_call(base: str, path: str, payload=None, timeout: float = 300):
    """(status, JSON body) of one request to the serve CLI's server."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def tf1_epcnet_source(flat: dict) -> dict:
    """``flat`` renamed to the tf1_epcnet layout by inverting the importer's
    own NAME_MAPS (each regex's first alternative; TF conv kernels [1, 1,
    in, out], TF centroids [1, D, K])."""
    out = {}
    for pattern, target in importer.NAME_MAPS["tf1_epcnet"].items():
        src = re.sub(r"\(\?:([^|()]*)(?:\|[^()]*)?\)\??", r"\1", pattern).replace("g?", "")
        assert re.fullmatch(pattern, src), (pattern, src)
        name = ("batch_stats/" if target.rsplit("/", 1)[-1] in ("mean", "var")
                else "params/") + target
        v, leaf = flat[name], target.rsplit("/", 1)[-1]
        out[src] = v[None, None] if leaf == "kernel" else v.T[None] if leaf == "centroids" else v
    assert len(out) == len(flat), (len(out), len(flat))
    return out


def serve_http_phase(flat: dict, sub: np.ndarray, tmp: str) -> dict:
    """The serve CLI on the card over a ``--log_dir`` that ``cli/convert``
    wrote from ``flat`` (``--name_map self``): ``make_server`` in process,
    then the CLI in a subprocess drained by SIGTERM. Returns what the
    timing lines print, with the launch counts under ``"counts"``."""
    log_dir, src = os.path.join(tmp, "converted"), os.path.join(tmp, "seeded.npz")
    np.savez(src, **flat)
    convert.main(["--source", src, "--log_dir", log_dir, "--name_map", "self"])
    res = {}
    with Phase("serve http"):
        zero_counts()
        index = PlaceIndex.from_checkpoint(log_dir)
        index.warmup()
        srv, sched = serve_cli.make_server(index, port=0, k=5, max_wait_ms=5.0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            assert http_call(base, "/healthz") == (200, {"ok": True, "size": 0, "dim": 256})
            meta = [f"submap_{i}" for i in range(len(sub))]
            t0 = time.perf_counter()
            assert http_call(base, "/add", {"points": sub.tolist(), "metadata": meta}) == \
                (200, {"size": len(sub)})
            res["add_64_s"] = time.perf_counter() - t0

            def query(i):
                t = time.perf_counter()
                code, r = http_call(base, "/query", {"points": sub[i].tolist(), "k": 5})
                return i, code, r, time.perf_counter() - t

            with ThreadPoolExecutor(8) as ex:
                answers = list(ex.map(query, range(len(sub))))
            for i, code, r, _ in answers:
                assert code == 200 and r["ids"][0] == i and r["metadata"][0] == meta[i], (i, r)
            lat = sorted(a[3] for a in answers)
            code, rb = http_call(base, "/query_batch", {"points": sub[:8].tolist(), "k": 3})
            assert code == 200 and [row[0] for row in rb["ids"]] == list(range(8)), rb
            code, m = http_call(base, "/metrics")
            assert code == 200 and m["scheduler"]["avg_batch"] > 1, m["scheduler"]
            assert m["scheduler"]["errors"] == 0 and m["index"]["size"] == len(sub)
            bad = http_call(base, "/query", {"points": sub[0].tolist(), "k": 6})
            assert bad[0] == 400 and "error" in bad[1], bad
            assert http_call(base, "/metricz")[0] == 404
        finally:
            srv.shutdown()
            srv.server_close()
            sched.stop()
        counts = read_counts()
        assert counts["K1"] >= 1 and counts["K1 k>32"] == 0, counts
        res.update(queries=len(answers), query_p50_ms=lat[len(lat) // 2] * 1e3,
                   query_max_ms=lat[-1] * 1e3, avg_batch=m["scheduler"]["avg_batch"],
                   dispatches=m["scheduler"]["dispatches"])
        del index
        torch.cuda.empty_cache()
    log(f"phase serve http: 64 submaps added over HTTP, 64 /query from 8 threads at rank 0 "
        f"with metadata, avg micro-batch {res['avg_batch']:.2f}; launches {counts}")

    with Phase("serve drain"):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        saved, out_log = os.path.join(tmp, "saved.npz"), os.path.join(tmp, "serve.log")
        with open(out_log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-u", "-m", "epcnet_torch.cli.serve", "--log_dir", log_dir,
                 "--port", str(port), "--k", "5", "--save_on_exit", saved],
                stdout=out, stderr=subprocess.STDOUT, cwd=os.path.dirname(os.path.abspath(
                    __file__)))
        base = f"http://127.0.0.1:{port}"
        try:
            deadline, up = time.time() + 300, None
            while up is None and time.time() < deadline:
                assert proc.poll() is None, open(out_log).read()[-3000:]
                try:
                    up = http_call(base, "/healthz", timeout=10)
                except OSError:
                    time.sleep(0.5)
            assert up == (200, {"ok": True, "size": 0, "dim": 256}), open(out_log).read()
            code, d = http_call(base, "/embed", {"points": sub[:8].tolist()})
            assert code == 200
            assert http_call(base, "/add", {"points": sub[:8].tolist(),
                                            "metadata": list(range(8))}) == (200, {"size": 8})
            code, q = http_call(base, "/query", {"points": sub[3].tolist(), "k": 1})
            assert code == 200 and q["ids"] == [3] and q["metadata"] == [3], q
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
                raise
        text = open(out_log).read()
        assert rc == 0 and "server stopped" in text, text[-3000:]
        assert text.index("warmup: embed+query ran") < text.index("serving on"), text
        with np.load(saved, allow_pickle=True) as z:
            db, smeta = z["db"], list(z["meta"])
        assert np.array_equal(db, np.asarray(d["descriptors"], np.float32)), "saved DB"
        assert smeta == list(range(8))
        ix = PlaceIndex.from_checkpoint(log_dir)
        ix.load_db(saved)
        assert np.array_equal(ix._db, db) and ix.metadata([5]) == [5]
        ids, _ = ix.query(sub[:8], k=1)
        np.testing.assert_array_equal(ids[:, 0], np.arange(8))
        res["drain"] = {"rc": rc, "saved_rows": int(len(db))}
        del ix
        torch.cuda.empty_cache()
    log("phase serve drain: the CLI in a subprocess warmed up before it bound, took 8 "
        "submaps, drained on SIGTERM; the saved DB equals its /embed descriptors and "
        "reloads to rank-0 self-retrieval")
    res["counts"] = counts
    return res


def convert_phase(cfg: ModelConfig, flat: dict, sub: np.ndarray, tmp: str) -> dict:
    """``flat`` renamed to the tf1_epcnet layout and as an unlabelled torch
    dict, each converted (``cli/convert``) and served from its run
    directory: descriptors bit-equal to the bridge's (``load_flat_variables``
    through ``build_embed_fn``)."""
    with Phase("convert"):
        zero_counts()
        tf_src = os.path.join(tmp, "tf1_epcnet.npz")
        np.savez(tf_src, **tf1_epcnet_source(flat))
        model = load_flat_variables(get_model(cfg, "cpu"), flat)
        pt_src = os.path.join(tmp, "unlabelled.pt")
        torch.save({f"v{i}": t for i, t in enumerate(model.state_dict().values())}, pt_src)
        want = build_embed_fn(cfg, variables=flat)(torch.tensor(sub[:8], device="cuda"))
        got = {}
        for name, src, extra in (("tf1_epcnet", tf_src, ["--name_map", "tf1_epcnet"]),
                                 ("auto", pt_src, ["--name_map", "auto"])):
            log_dir = convert.main(["--source", src, "--log_dir", os.path.join(tmp, name)]
                                   + extra)
            ix = PlaceIndex.from_checkpoint(log_dir, embed_batch=8)
            ix.add(sub[:8])
            ids, _ = ix.query(sub[:8], k=1)
            np.testing.assert_array_equal(ids[:, 0], np.arange(8))
            d = torch.from_numpy(ix.embed(sub[:8]))
            got[name] = float((d - want.cpu()).abs().max())
            assert torch.equal(d, want.cpu()), (name, got[name])
            del ix
        counts = read_counts()
        assert counts["K1"] >= 1, counts
        torch.cuda.empty_cache()
    log(f"phase convert: tf1_epcnet names and an unlabelled torch dict converted and served; "
        f"descriptors bit-equal to the bridge's (max abs diff {got}); launches {counts}")
    return {"max_abs_diff": got, "counts": counts}


def sampling_phase(dev) -> dict:
    """Each sampling op on the card against the same op on the CPU at B=2,
    N=4096, npoint=1024: ids exactly, values within 1e-6."""
    with Phase("sampling"):
        x = submaps(np.random.default_rng(1024), 2, 4096)
        rng = np.random.default_rng(5)
        feats = rng.standard_normal((2, 1024, 16)).astype(np.float32)
        probs = rng.random((2, 4096)).astype(np.float32)
        probs /= probs.sum(-1, keepdims=True)
        draws = rng.random((2, 1024)).astype(np.float32)

        def ops(d):
            xs = torch.tensor(x, device=d)
            fps = sampling.farthest_point_sample(xs, 1024)
            new = sampling.gather_point(xs, fps)
            bq = sampling.ball_query(0.1, 32, xs, new)
            dist, idx = sampling.three_nn(xs, new)
            return {"fps": fps, "gather_point": new, "ball_query": bq,
                    "group_point": sampling.group_point(xs, bq),
                    "prob_sample": sampling.prob_sample(torch.tensor(probs, device=d),
                                                        torch.tensor(draws, device=d)),
                    "three_nn_idx": idx, "three_nn_dist": dist,
                    "three_interpolate": sampling.three_interpolate(
                        torch.tensor(feats, device=d), idx, dist)}

        t0 = time.perf_counter()
        card = ops(dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        host = ops("cpu")
        err = {}
        for name, want in host.items():
            got = card[name].cpu()
            if want.is_floating_point():
                err[name] = float((got - want).abs().max())
                assert err[name] <= 1e-6, (name, err[name])
            else:
                assert torch.equal(got, want), name
        assert len(set(card["fps"][0].tolist())) == 1024
    log(f"phase sampling: B=2, N=4096, npoint=1024 on the card equal to the CPU (ids exact; "
        f"values max abs {err}); the card's pass {card_s:.2f} s with FPS's 1023 steps")
    return {"max_abs_err": err, "card_s": card_s}


def serving_phases(dev, cfg: ModelConfig, flat: dict, embed, sub: np.ndarray) -> dict:
    """The serving slice's phases at full width (see the module docstring):
    "serve http" and "serve drain", "convert", "serve scale", "serve
    ingest" and "sampling". Returns their results, with each phase's launch
    counts under ``"counts"``."""
    with tempfile.TemporaryDirectory(prefix="epcnet_serve_") as tmp:
        http = serve_http_phase(flat, sub, tmp)
        conv = convert_phase(cfg, flat, sub, tmp)
    http_counts, convert_counts = http.pop("counts"), conv.pop("counts")
    with Phase("serve scale"):
        zero_counts()
        scale = serve_scale.run(dev, embed=embed, do_load=True)
        scale_counts = read_counts()
        assert scale_counts["K1"] >= 1 and scale_counts["K1 k>32"] == 0, scale_counts
        resident = (1 << 20) * 256  # a 2^20-row int8 DB
        for qmode, rows in scale["ladder"].items():
            for r in rows:
                log(f"  serve scale {qmode}: rows {r['rows']}, capacity {r['capacity']}, "
                    f"device_bytes {r['device_bytes']}, query transient "
                    f"{r['retrieval_transient_bytes']} B (fused {r['fused_query_transient_bytes']}"
                    f" B), p50 {r['p50_ms']:.2f} / p99 {r['p99_ms']:.2f} ms, qps "
                    f"{r['qps']:.1f}, planted rank 0 {r['planted_rank0']}")
                assert r["planted_rank0"] == "32/32", r
            for r in rows[1:]:  # 10^5 and 10^6 rows
                pvb = r["plain_vs_blocked"]
                assert pvb["ids_equal"] and pvb["max_abs_dist_diff"] == 0.0, pvb
                log(f"  serve scale {qmode} at {r['rows']} rows: full sort "
                    f"{pvb['plain_ms']:.3f} ms, {pvb['plain_transient_bytes']} B; blocked "
                    f"{pvb['blocked_ms']:.3f} ms, {pvb['blocked_transient_bytes']} B")
        i8 = {r["rows"]: r for r in scale["ladder"]["int8"]}
        t5, t6 = (i8[n]["retrieval_transient_bytes"] for n in (100_000, 1_000_000))
        assert i8[1_000_000]["capacity"] == 1 << 20 and t6 < resident, (t6, resident)
        assert abs(t6 - t5) < 0.1 * t5, (t5, t6)
        assert not scale["load"]["self_retrieval_fails"], scale["load"]
        torch.cuda.empty_cache()
    log(f"phase serve scale: 10^4-10^6 rows fp32 and int8, every planted submap at rank 0; "
        f"int8 query transient {t5} B at 10^5 rows, {t6} B at 10^6 (resident 2^20 rows: "
        f"{resident} B); load p50 {scale['load']['p50_ms']:.2f} / p99 "
        f"{scale['load']['p99_ms']:.2f} ms, avg batch {scale['load']['avg_batch']:.2f}; "
        f"launches {scale_counts}")
    with Phase("serve ingest"):
        zero_counts()
        ingest = serve_scale.run(dev, rungs=(), quantize=(), do_ingest=True, embed=embed)
        ingest = {w: ingest[w] for w in ("ingest", "ingest_growth")}
        ingest_counts = read_counts()
        assert ingest_counts["K1"] >= 1, ingest_counts
        for w, ing in ingest.items():
            assert not ing["errors"] and ing["threads_alive"] == 0, (w, ing)
            assert ing["n_bad_answers"] == 0, (w, ing["answers_not_a_prefix_top_k"])
            assert ing["all_visible_after_flush"], (w, ing)
            assert ing["capacity_fixed" if w == "ingest" else "capacity_doubled"], (w, ing)
            assert ing["during"]["n"] > 0 and ing["within_bound"], (w, ing)
        assert len(ingest["ingest_growth"]["growth_chunk_ms"]) == 1, ingest["ingest_growth"]
        torch.cuda.empty_cache()
    for w, ing in ingest.items():
        growth = (f", the growth chunk {ing['growth_chunk_ms'][0]:.2f} ms "
                  f"({ing['capacity_before']} -> {ing['capacity']} rows)"
                  if ing["growth_chunk_ms"] else f" (capacity {ing['capacity']} rows)")
        log(f"phase serve {w.replace('_', ' ')}: 10^6 rows in the background over "
            f"{ing['base_rows']}, 8 threads in rounds (avg batch {ing['avg_batch']:.2f}); "
            f"p50/p99/max idle {ing['idle']['p50_ms']:.2f}/{ing['idle']['p99_ms']:.2f}/"
            f"{ing['idle']['max_ms']:.2f}, during {ing['during']['p50_ms']:.2f}/"
            f"{ing['during']['p99_ms']:.2f}/{ing['during']['max_ms']:.2f}, after flush "
            f"{ing['after_flush']['p50_ms']:.2f}/{ing['after_flush']['p99_ms']:.2f}/"
            f"{ing['after_flush']['max_ms']:.2f} ms; chunk {ing['chunk_ms_median']:.2f} ms "
            f"(max {ing['chunk_ms_max']:.2f}){growth}; longest during "
            f"{ing['during']['max_ms']:.2f} ms against the bound {ing['bound_ms']:.2f} "
            f"(margin {ing['margin_ms']:.2f}); {ing['answers_checked']} answers each the "
            f"exact top-5 of a prefix")
    log(f"phase serve ingest: launches {ingest_counts}")
    samp = sampling_phase(dev)
    return {"http": http, "convert": conv, "scale": scale, "ingest": ingest,
            "sampling": samp, "counts": {"serve http": http_counts, "convert": convert_counts,
                                         "serve scale": scale_counts,
                                         "serve ingest": ingest_counts}}


def multi_device_phases(dev, cfg: ModelConfig, flat: dict, embed, sub: np.ndarray):
    """(a)-(c) of the module docstring; returns the results line and each
    path's launch counts (a rank's K1 and K2 in the gloo world)."""
    counts = {}
    with Phase("multi-device retrieval"):
        zero_counts()
        ret = multidevice.retrieval(dev, embed, sub, 10**6)
        counts["multi-device retrieval"] = read_counts()
        assert counts["multi-device retrieval"]["K1"] >= 1, counts["multi-device retrieval"]
        torch.cuda.empty_cache()
    lat = ret["scheduler_8_threads"]
    log(f"phase multi-device retrieval: 10^6 rows over [cuda:0, cuda:0], sharded and ring ids "
        f"equal to the unsharded (fp32, int8), {ret['queries']} submaps at rank 0 through "
        f"QueryScheduler: p50/p99 {lat['sharded']['p50_ms']:.2f}/{lat['sharded']['p99_ms']:.2f} "
        f"ms sharded, {lat['unsharded']['p50_ms']:.2f}/{lat['unsharded']['p99_ms']:.2f} "
        f"unsharded; launches {counts['multi-device retrieval']}")
    with Phase("multi-device gloo"):
        gl = multidevice.gloo_world(dev, cfg, flat)
        torch.cuda.empty_cache()
    for r, c in gl["counts"].items():
        for path, kc in c.items():
            counts[f"gloo rank {r} {path}"] = {**{name: 0 for name in COUNTERS}, **kc}
    log(f"phase multi-device gloo: 2 ranks on one card; DP step bf16 {gl['dp_step_bf16']}, "
        f"fp32 {gl['dp_step_fp32']}; ring kNN ids equal to K2's at N=131072; embed "
        f"{gl['embed']}; tuple step bf16 {gl['tuple_step_bf16']}, fp32 {gl['tuple_step_fp32']}; "
        f"K1 / K2 launches a rank {gl['counts']}")
    with Phase("multi-device nccl"):
        nc = multidevice.nccl_world(dev, cfg, flat)
    log(f"phase multi-device nccl: world of one, step {nc['step_ms']} ms (collectives "
        f"{nc['collective_ms']:.3f} ms; K1 {nc['step_counts']['K1']} a step); cli/train "
        f"--mesh {nc['cli_train']['steps']} steps, K1 {nc['cli_train']['counts']['K1']}")
    with Phase("gloo cuda probe"):
        ops = multidevice.gloo_cuda_ops()
    assert all(ops[op] == "accepted" for op in GLOO_CUDA_OPS), ops
    log(f"phase gloo cuda probe: {ops}")
    return {"retrieval": ret, "gloo": gl, "nccl": nc, "gloo_cuda_ops": ops}, counts


def benchmark_cli_phase(dev, n: int) -> tuple[dict, dict]:
    """``cli/benchmark.py --json`` at its defaults (B=32, N=4096), counts
    zeroed: K2 (its kNN) and K1 (its embed) must launch, and K2's ids equal
    the plain version's on the CLI's clouds. Returns (its line, counts)."""
    with Phase("benchmark cli"):
        zero_counts()
        line = benchmark.main(["--json"])  # prints its line
        counts = read_counts()
        assert counts["K2"] >= 1 and counts["K1"] >= 1, counts
        assert line["num_points"] == n and line["batch"] == 32, line
        assert all(np.isfinite(v) and v > 0 for k, v in line.items() if k.endswith("_ms")), line
        xb = benchmark.clouds(np.random.default_rng(0), 32, n, dev)  # the CLI's clouds
        ids, d = knn.knn_cuda(xb, benchmark.KNN_K, return_dists=True)
        ids_p, d_p = knn.knn_plain(xb, benchmark.KNN_K, return_dists=True)
        assert torch.equal(ids, ids_p) and torch.equal(d, d_p)
        del xb, ids, d, ids_p, d_p
        torch.cuda.empty_cache()
    log(f"phase benchmark cli: K2 ids equal to knn_plain's at B=32, N={n}; embed "
        f"{line['embed_device_ms']:.3f} ms device, {line['submaps_per_sec_device']:.1f} "
        f"submaps/s; launches {counts}")
    return line, counts


def train_quality_phase(dev, tmp: str) -> tuple[dict, dict]:
    """(a) the CI-scale band (``multiseed.ci_run``) on the card: seed 1234
    before and after training, then the seeds (1234, 7, 2024), held to
    ``multiseed.CI_BAND``, seed 1234's two loss curves compared; (b) seed
    1234's full-width teacher (``multiseed.run``, the protocol's 15 epochs)
    through the CLIs, recall@1 held to ``multiseed.BAND``, K1 counted by train
    steps, mining and evaluation. Returns (its line, counts)."""
    res, counts = {}, {}
    with Phase("train quality ci"):
        root = multiseed.ci_dataset(os.path.join(tmp, "ci_data"))
        zero_counts()
        first = multiseed.ci_run(root, 1234, os.path.join(tmp, "ci_first"), dev.type,
                                 untrained=True)
        runs = {s: multiseed.ci_run(root, s, os.path.join(tmp, f"ci_{s}"), dev.type)
                for s in multiseed.CI_SEEDS}
        counts["train quality ci"] = read_counts()
        recalls = {s: r["trained"] for s, r in runs.items()}
        bad = multiseed.ci_band_failures(first["untrained"], first["trained"], recalls)
        assert not bad, bad
        assert counts["train quality ci"]["K1"] >= 1, counts
        a, b = np.array(first["loss"]), np.array(runs[1234]["loss"])
        res["ci"] = {"untrained": first["untrained"], "trained_first": first["trained"],
                     "recall_by_seed": recalls,
                     "loss_by_epoch": {s: [float(np.mean(r["loss"][i:j])) for i, j in
                                           zip([0] + r["epoch_ends"][:-1], r["epoch_ends"])]
                                       for s, r in runs.items()},
                     "seed1234_rerun_loss_equal": bool(np.array_equal(a, b)),
                     "seed1234_rerun_loss_max_gap": float(np.abs(a - b).max()),
                     "seed1234_rerun_first_unequal_step": (
                         int(np.argmax(a != b)) if not np.array_equal(a, b) else None),
                     "seed1234_rerun_recall": [first["trained"], runs[1234]["trained"]]}
    log(f"phase train quality ci: untrained {first['untrained']:.4f}, trained "
        f"{first['trained']:.4f}; by seed {recalls} (band {multiseed.CI_BAND}); seed 1234 "
        f"twice: losses equal {res['ci']['seed1234_rerun_loss_equal']}")

    with Phase("train quality teacher"):
        mining_k1, eval_k1 = [0], [0]
        with k1_inside(MiningCache, "refresh", mining_k1), \
                k1_inside(evaluate, "main", eval_k1):
            zero_counts()
            out = multiseed.run(os.path.join(tmp, "teacher"), seeds=(1234,),
                                device=dev.type, teacher_only=True,
                                pointnetvlad=False)
            counts["train quality teacher"] = read_counts()
        with open(os.path.join(tmp, "teacher", "s1234", "log", "export.json")) as f:
            steps = json.load(f)["step"]
        k1 = counts["train quality teacher"]["K1"]
        train_k1 = k1 - mining_k1[0] - eval_k1[0]
        assert train_k1 == steps, (train_k1, steps, mining_k1, eval_k1)
        assert mining_k1[0] >= 1 and eval_k1[0] >= 1, (mining_k1, eval_k1)
        r1 = out["seeds"][0]["teacher_recall1"]
        assert r1 >= multiseed.BAND["teacher_floor"], (r1, multiseed.BAND)
        res["teacher"] = {"epochs": out["epochs"], "recall_at_1": r1, "steps": steps,
                          "untrained_recall_at_1": out["untrained"]["recall1"],
                          "seconds": out["seeds"][0]["seconds"],
                          "k1_launches": {"train_steps": train_k1, "mining": mining_k1[0],
                                          "eval": eval_k1[0]},
                          "peak_memory_bytes": out["peak_memory_bytes"],
                          "tensorboard_mirrors": out["tensorboard_mirrors"]}
        torch.cuda.empty_cache()
    log(f"phase train quality teacher: seed 1234, {out['epochs']} epochs, {steps} steps, "
        f"recall@1 {r1:.4f} (floor {multiseed.BAND['teacher_floor']:.4f}); K1 launches "
        f"{res['teacher']['k1_launches']}")
    return res, counts


def compile_cache_phase(tmp: str) -> dict:
    """``cli/benchmark.py`` (K1 and K2) in a process of its own with
    ``--compilation_cache_dir`` a fresh directory: the two libraries are
    built there, by their content-addressed names; a second process with no
    nvcc to find (``CUDA_HOME`` empty, ``PATH`` without it) loads them
    from there and builds nothing."""
    cache = os.path.join(tmp, "kernel_cache")
    argv = [sys.executable, "-m", "epcnet_torch.cli.benchmark", "--json", "--batch", "2",
            "--iters", "2", "--db_size", "64", "--compilation_cache_dir", cache]
    root = os.path.dirname(os.path.abspath(__file__))
    with Phase("compile cache"):
        t0 = time.perf_counter()
        first = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=600)
        build_s = time.perf_counter() - t0
        assert first.returncode == 0, first.stderr[-3000:]
        real_dir = _build.BUILD_DIR
        try:
            compile_cache.enable_compilation_cache(cache)
            want = sorted(_build._target(name)[1].name for name in ("knn_adj", "knn_ids"))
        finally:
            _build.BUILD_DIR = real_dir
        built = {f: os.stat(os.path.join(cache, f)).st_mtime_ns for f in os.listdir(cache)}
        assert sorted(built) == want, (sorted(built), want)
        env = {**os.environ, "CUDA_HOME": os.path.join(tmp, "no_cuda"),
               "PATH": os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                                       if not os.path.isfile(os.path.join(p, "nvcc")))}
        t0 = time.perf_counter()
        second = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=600,
                                env=env)
        load_s = time.perf_counter() - t0
        assert second.returncode == 0, second.stderr[-3000:]
        after = {f: os.stat(os.path.join(cache, f)).st_mtime_ns for f in os.listdir(cache)}
        assert after == built, (after, built)
        line = json.loads(second.stdout.strip().splitlines()[-1])
        assert line["knn_cuda_ms"] > 0 and line["embed_device_ms"] > 0, line
    res = {"built": want, "first_process_s": build_s, "second_process_s": load_s}
    log(f"phase compile cache: {want} built in {cache} ({build_s:.1f} s process), loaded by "
        f"a process with no nvcc ({load_s:.1f} s)")
    return res


def spill_bytes(report: str) -> dict:
    """{kernel: spill store + load bytes} from a ptxas -v report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = int(m.group(1)) + int(m.group(2))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no card, no result",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1. build: one nvcc per source, all started together ---------------
    with Phase("build"):
        reports = _build.build(_build.SOURCES)
    for src, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {src}: {line.strip()}")
    # the kernels whose ptxas report must show no spill, by source: the
    # tiled core's at S = 1, 2, 4, 8 and its two list sizes (K2; K1 and K3),
    # and K4 for 2 x 2 dtypes and 4 channel widths
    watched = {"knn_ids": ("tiled_kernel", 8), "knn_adj": ("tiled_kernel", 16),
               "packed_mean": ("packed_mean_kernel", 16),
               # K5: S x 2 list sizes x with and without the count; K6: S x 2 lists
               "knn_phase": ("phase_tiled_kernel", 16),
               "knn_pipelined": ("pipelined_tiled_kernel", 8)}
    spills = {}
    for src, (part, count) in watched.items():
        if src in reports:
            got = {name: b for name, b in spill_bytes(reports[src]).items() if part in name}
            assert len(got) == count, f"ptxas reported {sorted(got)} for {src}"
            spills.update(got)
    assert all(b == 0 for b in spills.values()), f"spills: {spills}"
    dense = sum("dense_tiled" in name for name in spills)
    assert dense in (0, 8), f"{dense} dense tiled kernels in the ptxas report"
    log(f"phase build: {len(spills)} kernels spill 0 bytes (the tiled core's, {dense} of "
        "them K1's, K5's and K6's on it, and K4's)" if spills else
        "phase build: kernels were built before; no ptxas report")

    # -- 2. K1 against its plain version -----------------------------------
    cfg = ModelConfig()  # N=4096, k=20, bf16
    n, k, bf16 = cfg.num_points, cfg.knn_k, torch.bfloat16
    rng = np.random.default_rng(0)

    def cloud(b, npts):
        return torch.tensor(rng.uniform(-1, 1, (b, npts, 3)).astype(np.float32), device=dev)

    splits = (1, 2, 4, 8)
    with Phase("K1 check"):
        x8 = cloud(8, n)
        x32 = cloud(32, n)
        err = check_k1(x8, k, bf16, splits=splits)  # the trace's batch
        err = max(err, check_k1(x32, k, bf16, splits=splits))  # the serving batch
        err = max(err, check_k1(cloud(64, n), k, bf16, splits=splits))  # the evaluation's
        grid = torch.round(cloud(2, n) * 6) / 6  # coarse grid: ties everywhere, across tiles
        grid[0, 40:61] = grid[0, 5]
        check_k1(grid, k, bf16, splits=splits)
        check_k1(grid, k, torch.float32)
        check_k1(x_sorted(cloud(32, n)), k, bf16, splits=splits)  # scan order
        check_k1(torch.full((2, n, 3), 0.25, device=dev), k, bf16, splits=splits)  # identical
        check_k1(torch.ones(1, 1000, 3, device=dev), k, bf16)  # all identical, one tile
        check_k1(cloud(2, 1025), k, bf16, splits=splits)  # one point past a tile
        check_k1(cloud(2, 4097), k, bf16, splits=splits)  # one past the serving N
        check_k1(cloud(3, 1000), k, bf16)  # odd N
        check_k1(cloud(2, 1001), 7, torch.float32)
        check_k1(cloud(2, 33), 33, bf16)  # k = N
        check_k1(cloud(1, 1), 1, bf16)
        check_k1(cloud(2, 517), 20, bf16, with_proxy=False)
        check_k1(x_sorted(cloud(2, n)), k, bf16, with_proxy=False, splits=splits)
        check_k1(cloud(1, 20000), k, bf16)  # 20 tiles, the last one partial
        check_k1(cloud(2, n), 32, bf16, splits=splits)  # the register limit
        x33 = cloud(2, n)  # k one above the register list: the value rounds
        err_k1_r = check_k1(x33, 33, bf16)
    log(f"phase K1 check: ok (indicator exact on 19 cases, 10 of them also at S = 1, 2, 4 "
        f"and 8; the value rounds at k=33 alone; proxy max abs err {err}, {err_k1_r} at "
        "k=33)")

    # -- 3. K2 against its plain version -----------------------------------
    # the capacity routes' clouds: 16 submaps at N=32768, 8 at N=65536
    sub32k = submaps(np.random.default_rng(32768), 16, 32768)
    sub64k = submaps(np.random.default_rng(65536), 8, 65536)
    with Phase("K2 check"):
        check_k2(cloud(2, n), k)
        check_k2(grid, k)  # ties
        check_k2(torch.round(cloud(2, 1001) * 4) / 4, 7)  # odd N, ties
        check_k2(cloud(1, 33), 33)  # k = N
        check_k2(cloud(1, 1), 1)
        err_k2 = check_k2(torch.tensor(sub64k[:1], device=dev), k)  # the gather route's cloud
        check_k2(cloud(1, 131072), k)  # the largest rung the JAX package ran
        check_k2(grid, k, with_adjacency=True)
        check_k2(cloud(2, n), k, with_adjacency=True)
        # the tiled core, also at every split S of a row's columns
        check_k2(cloud(1, 1024), k, splits=splits)  # one tile exactly
        check_k2(cloud(1, 1025), k, splits=splits)  # one point past it
        check_k2(torch.round(cloud(1, 65536) * 6) / 6, k, splits=splits)  # ties across tiles
        check_k2(torch.full((1, 40000, 3), 0.25, device=dev), k, splits=splits)  # identical
        check_k2(x_sorted(cloud(1, 65536)), k, splits=splits)  # scan order: insertions
        check_k2(cloud(2, n), 32, with_adjacency=True, splits=splits)  # the register limit
        err_k2_r = check_k2(x33, 33, with_adjacency=True)
    log("phase K2 check: ok (ids and distances exact on 16 cases up to N=131072, the "
        "tiled core's 7 new ones at S = 1, 2, 4 and 8 too; indicator exact at N=4096, "
        f"k=20, 32, 33; distances max abs err {err_k2} at N=65536, {err_k2_r} at k=33)")

    # -- 4. K3 against its plain version -----------------------------------
    with Phase("K3 check"):
        x_pack = torch.tensor(sub32k[:2], device=dev)  # the packed route's batch
        err_k3 = check_k3(x_pack, k, bf16, splits=splits)
        err_k3 = max(err_k3, check_k3(torch.round(cloud(2, 32768) * 8) / 8, k, bf16,
                                      splits=splits))
        check_k3(torch.round(cloud(2, 1024) * 4) / 4, 7, torch.float32, splits=splits)
        check_k3(cloud(1, 32), 32, bf16)  # k = N, one word a row
        check_k3(cloud(1, 1056), k, bf16, splits=splits)  # one word column past a tile
        check_k3(torch.full((1, 40000, 3), 0.25, device=dev), k, bf16, sign_bit=False)
        check_k3(x_sorted(cloud(1, 32768)), k, torch.float32, splits=splits)
        check_k3(cloud(2, n), 32, bf16, splits=splits)  # the register limit
        err_k3_r = check_k3(x33, 33, bf16)  # one above: the value rounds
        torch.cuda.empty_cache()
    log(f"phase K3 check: ok (planes exact on 9 cases, at S = 1, 2, 4 and 8 too; proxy "
        f"max abs err {err_k3}, {err_k3_r} at k=33, equal to K1's)")

    # -- 5. K4 against its plain version -----------------------------------
    with Phase("K4 check"):
        planes, _ = knn.knn_packed_cuda(x_pack, k, bf16)
        gen = torch.Generator(device=dev).manual_seed(4)
        f64 = torch.randn(2, 32768, 64, device=dev, generator=gen).to(bf16)
        err_k4 = check_k4(f64, planes, k, bf16)  # the path's planes, k bits a row

        def words(shape):
            return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                                 device=dev, generator=gen)

        sparse = words(planes.shape) & words(planes.shape) & words(planes.shape) \
            & words(planes.shape)  # 1/16 dense: popcount ~2048 a row, not k
        sparse |= torch.iinfo(torch.int32).min  # plane 31 set in every word
        err_rand = check_k4(f64, sparse, k, bf16)
        check_k4(f64.float(), sparse, k, torch.float32)
        del sparse
        # K3's planes edited: rows with no set bit, a word with all 32 planes
        # set, and rows with more than 32 non-zero words (a warp's ballot)
        edited = planes.clone()
        edited[:, :100] = 0
        edited[:, 100:200, 5] = -1
        edited[:, 200:300, :40] |= 1 << 30
        err_edit = check_k4(f64, edited, k, bf16)
        check_k4(f64.float(), edited, k, torch.float32)
        del edited
        full = torch.full((2, 1024, 32), -1, dtype=torch.int32, device=dev)  # every bit set
        check_k4(f64[:, :1024], full, k, bf16)
        check_k4(f64[:, :1024].float(), full, k, torch.float32)
        torch.cuda.empty_cache()
    log(f"phase K4 check: ok (max abs err {err_k4} on K3's planes, {err_rand} on a "
        f"1/16-dense mask, {err_edit} on K3's planes with empty rows, full words and rows "
        "of 40 non-zero words, and a fully dense mask at N=1024; fp32 within 1e-6 of mean "
        "|F|)")

    # -- 5b. K5 and K6 against their plain versions ------------------------
    with Phase("K5/K6 check"):
        # x8 is the trace's batch (knn_trace.clouds(8, n), seed 0)
        assert torch.equal(x8.cpu(), torch.from_numpy(knn_trace.clouds(8, n)))
        dyadic = torch.round(cloud(2, n) * 8) / 8  # exact distances, ties across tiles
        few = torch.round(cloud(1, 1000))  # coordinates in {-1, 0, 1}: 10 distinct values
        same = torch.full((1, 3000, 3), 0.25, device=dev)  # identical points
        xs4k = x_sorted(cloud(2, n))  # scan order
        # rounds around both list sizes (24, 32) and one past: the value rounds
        k5_rounds = (1, k, 24, 25, 32, 33)
        k5_cases = [x8, cloud(2, 1024), cloud(2, 1025), cloud(1, 4097), dyadic, few, same,
                    xs4k, x_pack]  # x_pack: the packed route's B=2, N=32768
        err_k5 = 0.0
        for x in k5_cases:
            for rounds in k5_rounds:
                for thresh in (False, True):
                    err_k5 = max(err_k5, check_k5(x, rounds, thresh, splits)[1])
        for rounds in (1, k):  # x32: the serving batch, whose ablation line is timed
            for thresh in (False, True):
                err_k5 = max(err_k5, check_k5(x32, rounds, thresh, splits)[1])
        got, _ = check_k5(few, k, True)
        assert bool(torch.isinf(got).all()), "fewer than 20 distinct values: +inf"
        got, _ = check_k5(cloud(2, 40), 41, True)  # more rounds than points
        assert bool(torch.isinf(got).all())
        # the k=33 ablation's batches, either side of the value rounds'
        # shared-memory cutoff (N ~18,700)
        x16k, x20k = cloud(2, 16384), cloud(2, 20480)
        smem = {npts: knn_phases.xyz_in_shared_memory(npts) for npts in (16384, 20480, 32768)}
        assert smem == {16384: True, 20480: False, 32768: False}, smem
        for x in (x16k, x20k):
            for rounds in (1, 33):
                for thresh in (False, True):
                    err_k5 = max(err_k5, check_k5(x, rounds, thresh)[1])
        torch.cuda.empty_cache()
        # K6: the tiled pipeline at every S for k <= 32, the warp pairs at k = 33
        k6_cases = [x8, dyadic, cloud(2, 1001), cloud(2, 1025), cloud(2, 4097), same, xs4k,
                    misaligned(cloud(2, 1001)), misaligned(x8)]
        err_k6 = 0.0
        for x in k6_cases:
            for kk in (k, 32, 33):
                err_k6 = max(err_k6, check_k6(x, kk, splits))
        err_k6 = max(err_k6, check_k6(cloud(1, 33), 33))  # k = N
        # the warp pairs with xyz read from global memory (past N ~11,200,
        # where it no longer fits beside one pair's rows)
        err_k6 = max(err_k6, check_k6(cloud(1, 20000), 33))
        err_k6 = max(err_k6, check_k6(x32, k))  # the serving batch, timed below
        x1_32k = cloud(1, 32768)  # past the warp pairs' N limit (~27,700)
        for kk in (k, 32):
            err_k6 = max(err_k6, check_k6(x1_32k, kk, splits))
        try:
            knn_phases.knn_adjacency_pipelined_cuda(x1_32k, 33)
            raise AssertionError("K6 took k=33 past the warp pairs' shared memory")
        except ValueError:
            pass
        del x1_32k
        torch.cuda.empty_cache()
    log(f"phase K5/K6 check: ok (K5 exact on {len(k5_cases)} clouds up to B=2, N=32768 at "
        f"rounds {k5_rounds}, with and without the count, on the tiled core at S = 1, 2, "
        f"4 and 8 too, the value rounds at 33, at B=32 (rounds 1 and {k}, every S), and at "
        f"N=16384 and 20480; max abs err {err_k5}; value rounds' xyz in shared memory "
        f"{smem}; K6 indicator exact and equal to K1's on {len(k6_cases) + 4} clouds up to "
        f"N=32768 at k = 20, 32 (at every S) and 33 (up to N=20000), and at B=32, proxy max "
        f"abs err {err_k6})")

    # -- 6. the full-width model from seeded weights -----------------------
    with Phase("model"):
        flat = init_flat_variables(cfg, seed=0)
        embed = build_embed_fn(cfg, variables=flat)
        model = embed.model
        assert param_count(model) == 2_742_144, param_count(model)
    log(f"phase model: epcnet, {param_count(model)} params, N={n}, k={k}, {cfg.compute_dtype}")

    # -- 7. descriptors: kernel path against the plain-twin path -----------
    with Phase("descriptors"), torch.inference_mode():
        d_kernel = embed(x8)
        d_plain = model.forward_graph(x8, *knn.knn_adjacency_plain(x8, k, bf16))
    assert d_kernel.shape == (8, 256) and bool(torch.isfinite(d_kernel).all())
    norms = torch.linalg.vector_norm(d_kernel, dim=-1)
    assert bool(((norms - 1).abs() < 1e-5).all()), norms
    desc_err = float((d_kernel - d_plain).abs().max())
    assert desc_err <= ROUTE_TOL, desc_err
    log(f"phase descriptors: kernel vs plain-twin path max abs err {desc_err}")

    # -- 8. the three routes side by side at N=32768, B=2 ------------------
    routes = {fmt: build_embed_fn(cfg.variant(adjacency_format=fmt), variables=flat)
              for fmt in ("dense", "packed", "gather")}
    with Phase("routes"):
        assert adjacency_route(cfg, 32768) == "packed"
        zero_counts()
        d_auto = embed(x_pack)
        assert read_counts()["K3"] == 1 and read_counts()["K4"] == 3, read_counts()
        d_route = {fmt: e(x_pack) for fmt, e in routes.items()}
        assert torch.equal(d_auto, d_route["packed"])
        route_err = {}
        for fmt in ("packed", "gather"):
            d = d_route[fmt]
            assert d.shape == (2, 256) and bool(torch.isfinite(d).all()), fmt
            route_err[fmt] = float((d - d_route["dense"]).abs().max())
            assert route_err[fmt] <= ROUTE_TOL, (fmt, route_err)
        torch.cuda.empty_cache()
    log(f"phase routes: auto took packed at N=32768; descriptors against the dense "
        f"route, max abs err {route_err} (tolerance {ROUTE_TOL})")

    # -- 9. serving at N=4096, the dense route, launch counts zeroed -------
    sub = submaps(np.random.default_rng(1), 64, n)
    with Phase("serve"):
        zero_counts()
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
        dense_counts = read_counts()
    assert dense_counts["K1"] >= 1, "the serving path never launched K1"
    assert dense_counts["K1 k>32"] == 0, dense_counts  # k=20: every K1 ran tiled
    log(f"phase serve: {requests} requests answered; launches {dense_counts}")

    # -- 10. serving on the capacity routes, launch counts zeroed ----------
    with Phase("serve capacity"):
        zero_counts()
        for npts, sub_c, batch, route in ((32768, sub32k, 2, "packed"),
                                          (65536, sub64k, 1, "gather")):
            assert adjacency_route(cfg, npts) == route
            ix = PlaceIndex(embed, cfg.output_dim, embed_batch=batch, num_points=npts)
            ix.warmup()
            ix.add(sub_c, metadata=[f"submap_{i}" for i in range(len(sub_c))])
            for s in range(0, len(sub_c), batch):  # every submap at rank 0
                ids, dists = ix.query(sub_c[s:s + batch], k=5)
                np.testing.assert_array_equal(ids[:, 0], np.arange(s, s + batch))
                assert np.isfinite(dists).all()
            log(f"  N={npts} ({route}): {len(sub_c)} submaps self-retrieved at rank 0, "
                f"embed_batch {batch}")
            del ix
        cap_counts = read_counts()
        assert cap_counts["K3"] >= 1 and cap_counts["K2"] >= 1, cap_counts
        assert cap_counts["K4"] == 3 * cap_counts["K3"], cap_counts
        # k=20: every K2 and K3 launch of the path ran on the tiled core
        assert cap_counts["K2 k>32"] == 0 and cap_counts["K3 k>32"] == 0, cap_counts
        torch.cuda.empty_cache()
    log(f"phase serve capacity: launches {cap_counts}")

    # -- 10'. the serving slice: HTTP, scale, background ingest, convert ----
    served = serving_phases(dev, cfg, flat, embed, sub)
    http, conv, scale, ingest, samp = (served[p] for p in ("http", "convert", "scale",
                                                            "ingest", "sampling"))

    # -- 10a. recall@N evaluation through the CLIs, launch counts zeroed ---
    with tempfile.TemporaryDirectory(prefix="epcnet_eval_") as tmp:
        ev = evaluate_phase(embed, cfg, flat, tmp)
    eval_counts = ev.pop("counts")
    with Phase("bf16 check"):
        gaps = bf16_gaps(embed)
    log(f"phase bf16 check: full-width bf16 descriptors against JAX's, max abs {gaps} "
        f"(tolerance {BF16_TOL})")
    torch.cuda.empty_cache()

    # -- 10b. the kNN trace path, launch counts zeroed ---------------------
    with Phase("knn trace"):
        zero_counts()
        trace = knn_trace.main([])  # B=8, N=4096, k=20: prints its JSON line
        trace_counts = read_counts()
        assert trace["pipelined"]["adj_exact"], trace["pipelined"]
        assert trace["pipelined"]["proxy_within_1e-6_rel"], trace["pipelined"]
        assert trace["trace"]["ranked_by"] == "device", trace["trace"]["ranked_by"]
        assert trace["phase_cores"] == {"A-C (K5)": "tiled", "D (K1)": "tiled"}, \
            trace["phase_cores"]
        assert all(trace_counts[name] >= 1 for name in ("K1", "K5", "K6")), trace_counts
        # k=20: every K5 and K6 launch of the path ran on the tiled core
        assert trace_counts["K5 r>32"] == 0 and trace_counts["K6 k>32"] == 0, trace_counts
        # the model's kNN span holds K1 alone: its device time a forward is
        # phase D's, which the span attribution (region_ms) must reproduce
        span = trace["trace"]["regions_ms"]["epcnet/knn_graph"]
        span_ms = span["total_ms"] / trace["trace"]["forwards"]
        d_ms = trace["phase_ms_per_batch"]["D_full_shipped"]
        assert span["count"] == trace["trace"]["forwards"], span
        assert abs(span_ms / d_ms - 1) <= 0.2, (span_ms, d_ms)
        # the tiled core's phases at the serving batch and at the packed
        # route's batch, the batches K5 was held against its plain version on
        abl32 = knn_trace.phase_ablation(x32, k)
        log(json.dumps({"knn_ablation_b32_n4096": abl32}))
        abl_pack = knn_trace.phase_ablation(x_pack, k)
        log(json.dumps({"knn_ablation_b2_n32768": abl_pack}))
        for abl in (abl32, abl_pack):
            assert abl["phase_cores"] == {"A-C (K5)": "tiled", "D (K1)": "tiled"}, abl
        # k=33: the value rounds (B-D; A's one value is on the tiled core)
        # either side of their shared-memory cutoff: what reading xyz from
        # global memory costs each phase
        regimes = [dict(knn_trace.phase_ablation(x, 33), k5_xyz_in_shared_memory=smem[npts])
                   for npts, x in ((16384, x16k), (20480, x20k))]
        for abl in regimes:
            assert abl["phase_cores"] == {"A-C (K5)": "A tiled, B-C value rounds",
                                          "D (K1)": "value rounds"}, abl
        log(json.dumps({"knn_ablation_regimes_k33": regimes}))
        torch.cuda.empty_cache()
    log(f"phase knn trace: K6 verdict {trace['pipelined']['verdict']}; kNN span "
        f"{span_ms} ms a forward against phase D {d_ms} ms; launches {trace_counts}")

    # -- 10c. training, launch counts zeroed before each phase --------------
    with tempfile.TemporaryDirectory(prefix="epcnet_train_") as tmp:
        trained = train_phases(dev, cfg, flat, tmp)
    train_counts = trained.pop("counts")
    with Phase("train timings"):
        bench = train_bench.run(dev, 10)
    log(f"phase train timings: dense {bench['dense']['ms_per_step']:.2f} ms a step, gather "
        f"{bench['gather']['ms_per_step']:.2f} ms")

    # -- 10d. the multi-device paths, launch counts zeroed before each ------
    md, md_counts = multi_device_phases(dev, cfg, flat, embed, sub)

    # -- 10e. the benchmark CLI, training quality, the compile cache -------
    bench_cli, bench_cli_counts = benchmark_cli_phase(dev, n)
    with tempfile.TemporaryDirectory(prefix="epcnet_quality_") as tmp:
        quality, quality_counts = train_quality_phase(dev, tmp)
        cache = compile_cache_phase(tmp)

    # -- 11. timings, at the shapes the serving paths give each kernel -----
    with Phase("timings"):
        kernels = []

        path_counts = {"serve": dense_counts, "serve capacity": cap_counts,
                       **served["counts"], "evaluate": eval_counts, "knn trace": trace_counts,
                       **train_counts, **md_counts, "benchmark cli": bench_cli_counts,
                       **quality_counts}

        def entry(name, source, replaces, launches, err_, ms, plain, nbytes, ops,
                  shape, counter, **extra):
            b_ms, by = bound(nbytes, ops)
            kernels.append({
                "name": name, "route": "cuda", "source": f"epcnet_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err_,
                "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
                "library_ms": None, "shape": shape, "k": k,
                "launches_by_path": {p: c[counter] for p, c in path_counts.items()},
                **extra})

        def xyz_bytes(x):
            return x.numel() * 4

        # K1 / K1': the dense route at the serving batch, B=32, N=4096
        ms32 = cuda_ms(lambda: knn.knn_adjacency_cuda(x32, k, bf16), 20)
        plain32 = cuda_ms(lambda: knn.knn_adjacency_plain(x32, k, bf16), 3)
        entry("knn_adj", "knn_adj.cu", "epcnet_tpu/ops/knn.py:68", dense_counts["K1"],
              err, ms32, plain32, xyz_bytes(x32) + 32 * n * n + 32 * n * 3 * 2,
              8 * 32 * n * n, [32, n, 3], "K1")
        ms_np = cuda_ms(lambda: knn.knn_adjacency_cuda(x32, k, bf16, with_proxy=False), 20)
        plain_np = cuda_ms(lambda: knn.knn_adjacency_plain(x32, k, bf16, with_proxy=False), 3)
        entry("knn_adj (no proxy)", "knn_adj.cu", "epcnet_tpu/ops/knn.py:247",
              dense_counts["K1'"] + cap_counts["K1'"], 0.0, ms_np, plain_np,
              xyz_bytes(x32) + 32 * n * n, 8 * 32 * n * n, [32, n, 3], "K1'")
        ms8 = cuda_ms(lambda: knn.knn_adjacency_cuda(x8, k, bf16), 20)
        plain8 = cuda_ms(lambda: knn.knn_adjacency_plain(x8, k, bf16), 3)
        b8 = bound(xyz_bytes(x8) + 8 * n * n + 8 * n * 3 * 2, 8 * 8 * n * n)
        # the tiled core under K1 at each split S (0: the kernel's choice)
        k1_splits = {f"k1_b{xx.shape[0]}_n4096": {
            s_: cuda_ms(lambda: knn._launch_adj(xx, k, bf16, True, False, "K1", s_), 20)
            for s_ in (0, 1, 2, 4, 8)} for xx in (x32, x8)}
        # k above the register list: the value rounds, on the checked x33
        entry("knn_adj (k > 32)", "knn_adj.cu", "epcnet_tpu/ops/knn.py:68",
              dense_counts["K1 k>32"], err_k1_r, cuda_ms(lambda: knn.knn_adjacency_cuda(
                  x33, 33, bf16), 5), cuda_ms(lambda: knn.knn_adjacency_plain(x33, 33, bf16), 3),
              xyz_bytes(x33) + 2 * n * n + 2 * n * 3 * 2, 8 * 2 * n * n, [2, n, 3], "K1 k>32",
              k=33)

        # K2: the gather route's shape, B=1, N=65536, ids alone
        x64 = torch.tensor(sub64k[:1], device=dev)
        n64 = 65536
        ms_k2 = cuda_ms(lambda: knn.knn_cuda(x64, k), 10)
        x64s = x_sorted(x64)  # the same cloud in scan order: what insertions cost
        ms_k2_sorted = cuda_ms(lambda: knn.knn_cuda(x64s, k), 10)
        plain_k2 = cuda_ms(lambda: knn.knn_plain(x64, k), 1)
        two_k2 = cuda_ms(lambda: torch.topk(torch.cdist(x64, x64), k, largest=False), 3)
        entry("knn_ids", "knn_ids.cu", "epcnet_tpu/ops/knn.py:151", cap_counts["K2"], err_k2,
              ms_k2, plain_k2, xyz_bytes(x64) + n64 * k * 4, 8 * n64 * n64, [1, n64, 3], "K2",
              ms_x_sorted=ms_k2_sorted, two_call_ms=two_k2,
              two_call="torch.cdist + torch.topk(largest=False); "
              "sqrt distances, ties in no promised order")
        # the tiled core at each split S (threads a row; 0: the kernel's choice)
        ids64 = torch.empty((1, n64, k), dtype=torch.int32, device=dev)
        k2_splits = {s_: cuda_ms(lambda: knn._launch_ids(x64, k, ids64, None, None, s_), 5)
                     for s_ in (0, 1, 2, 4, 8)}
        # and on one small cloud, where S = 1 leaves SMs idle (16 blocks at N=4096)
        x4k, ids4k = cloud(1, n), torch.empty((1, n, k), dtype=torch.int32, device=dev)
        k2_splits_n4096 = {s_: cuda_ms(lambda: knn._launch_ids(x4k, k, ids4k, None, None, s_),
                                       20) for s_ in (0, 1, 2, 4, 8)}
        # k above the register list: the value rounds, on the checked x33
        ms_r = cuda_ms(lambda: knn.knn_cuda(x33, 33), 5)
        entry("knn_ids (k > 32)", "knn_ids.cu", "epcnet_tpu/ops/knn.py:151",
              cap_counts["K2 k>32"], err_k2_r, ms_r, cuda_ms(lambda: knn.knn_plain(x33, 33), 3),
              xyz_bytes(x33) + 2 * n * 33 * 4, 8 * 2 * n * n, [2, n, 3], "K2 k>32", k=33)
        x131 = cloud(1, 131072)
        ms_k2_131 = cuda_ms(lambda: knn.knn_cuda(x131, k), 3)
        b131 = bound(xyz_bytes(x131) + 131072 * k * 4, 8 * 131072 ** 2)
        del x131
        torch.cuda.empty_cache()

        # K3: the packed route's shape, B=2, N=32768
        n32 = 32768
        ms_k3 = cuda_ms(lambda: knn.knn_packed_cuda(x_pack, k, bf16), 10)
        plain_k3 = cuda_ms(lambda: knn.knn_adjacency_plain(x_pack, k, bf16, fmt="packed"), 1)
        torch.cuda.empty_cache()
        entry("knn_adj (packed)", "knn_adj.cu", "epcnet_tpu/ops/knn.py:119",
              cap_counts["K3"], err_k3, ms_k3, plain_k3,
              xyz_bytes(x_pack) + 2 * n32 * n32 // 8 + 2 * n32 * 3 * 2,
              8 * 2 * n32 * n32, [2, n32, 3], "K3")
        k3_splits = {s_: cuda_ms(lambda: knn._launch_adj(x_pack, k, bf16, True, True, "K3", s_),
                                 5) for s_ in (0, 1, 2, 4, 8)}
        ms_r3 = cuda_ms(lambda: knn.knn_packed_cuda(x33, 33, bf16), 5)
        entry("knn_adj (packed, k > 32)", "knn_adj.cu", "epcnet_tpu/ops/knn.py:119",
              cap_counts["K3 k>32"], err_k3_r, ms_r3,
              cuda_ms(lambda: knn.knn_adjacency_plain(x33, 33, bf16, fmt="packed"), 3),
              xyz_bytes(x33) + 2 * n * n // 8 + 2 * n * 3 * 2, 8 * 2 * n * n, [2, n, 3], "K3 k>32",
              k=33)
        # the tiled core at K1's shape, B=32, N=4096: a reading for K1's future
        tiled_b32 = {"k1_ms": ms32, "k2_ids_ms": cuda_ms(lambda: knn.knn_cuda(x32, k), 20),
                     "k3_ms": cuda_ms(lambda: knn.knn_packed_cuda(x32, k, bf16), 20),
                     "k6_ms": cuda_ms(lambda: knn_phases.knn_adjacency_pipelined_cuda(x32, k),
                                      20),
                     "shape": [32, n, 3], "k": k}

        # K4: layers 1-3 of the packed route, B=2, N=32768, C=64, bf16
        f_relu = torch.relu(f64)  # a layer's input is a ReLU output
        ms_k4 = cuda_ms(lambda: adjacency.packed_neighbor_mean_cuda(f_relu, planes, k), 20)
        plain_k4 = cuda_ms(lambda: adjacency.packed_neighbor_mean_plain(f_relu, planes, k), 3)
        set_bits = sum(int(((planes >> j) & 1).sum()) for j in range(32))
        mask = adjacency.unpack_indicator(planes, bf16)
        dense_k4 = cuda_ms(lambda: torch.bmm(mask, f_relu, out_dtype=torch.float32), 10)
        del mask
        torch.cuda.empty_cache()
        entry("packed_mean", "packed_mean.cu", "epcnet_tpu/ops/adjacency.py:129",
              cap_counts["K4"], err_k4, ms_k4, plain_k4,
              planes.numel() * 4 + 2 * f_relu.numel() * 2, set_bits * 64, [2, n32, 64], "K4",
              dense_product_ms=dense_k4, dense_product="torch.bmm of the unpacked bf16 "
              "mask with F, fp32 sum (the dense route's layer product; unpack not timed)")

        # K5 and K6: the trace path's shape, B=8, N=4096; their times are the
        # trace phase's (K5: phase C, k distinct values and the count)
        plain_k5 = cuda_ms(lambda: knn_phases.knn_phase_plain(x8, k, True), 3)
        entry("knn_phase", "knn_phase.cu", "scripts/hw_knn_trace.py:83", trace_counts["K5"],
              err_k5, trace["phase_ms_per_batch"]["C_plus_threshold"], plain_k5,
              xyz_bytes(x8) + 8 * n * 4, 8 * 8 * n * n, [8, n, 3], "K5", rounds=k, thresh=True)
        plain_k6 = cuda_ms(lambda: knn_phases.knn_adjacency_pipelined_plain(x8, k), 3)
        entry("knn_pipelined", "knn_pipelined.cu", "scripts/hw_knn_trace.py:162",
              trace_counts["K6"], err_k6, trace["pipelined"]["pipelined_ms_per_batch"],
              plain_k6, xyz_bytes(x8) + 8 * n * n + 8 * n * 3 * 4, 8 * 8 * n * n, [8, n, 3], "K6",
              k1_same_process_ms=trace["pipelined"]["shipped_ms_per_batch_same_process"])
        # more than 32 rounds / neighbours: the first designs, on the checked x33
        entry("knn_phase (rounds > 32)", "knn_phase.cu", "scripts/hw_knn_trace.py:83",
              trace_counts["K5 r>32"], check_k5(x33, 33, True)[1],
              cuda_ms(lambda: knn_phases.knn_phase_cuda(x33, 33, True), 5),
              cuda_ms(lambda: knn_phases.knn_phase_plain(x33, 33, True), 3),
              xyz_bytes(x33) + 2 * n * 4, 8 * 2 * n * n, [2, n, 3], "K5 r>32", rounds=33,
              thresh=True)
        entry("knn_pipelined (k > 32)", "knn_pipelined.cu", "scripts/hw_knn_trace.py:162",
              trace_counts["K6 k>32"], check_k6(x33, 33),
              cuda_ms(lambda: knn_phases.knn_adjacency_pipelined_cuda(x33, 33), 5),
              cuda_ms(lambda: knn_phases.knn_adjacency_pipelined_plain(x33, 33), 3),
              xyz_bytes(x33) + 2 * n * n + 2 * n * 3 * 4, 8 * 2 * n * n, [2, n, 3], "K6 k>32",
              k=33)
        # K5 (phase C) and K6 at each split S at the trace's batch (0: the rule's)
        k5_splits = {s_: cuda_ms(lambda: knn_phases._launch_phase(x8, k, True, s_), 20)
                     for s_ in (0, 1, 2, 4, 8)}
        k6_splits = {s_: cuda_ms(lambda: knn_phases._launch_pipelined(x8, k, s_), 20)
                     for s_ in (0, 1, 2, 4, 8)}

        # the routes: one embed batch each, by CUDA events (mean of 3)
        route_ms = []
        for npts, b, fmts in ((16384, 2, ("dense", "packed", "gather")),
                              (32768, 2, ("dense", "packed", "gather")),
                              (65536, 1, ("gather",)), (131072, 1, ("gather",))):
            xr = torch.tensor(submaps(np.random.default_rng(npts + 1), b, npts), device=dev)
            for fmt in fmts:
                route_ms.append({"n": npts, "b": b, "route": fmt,
                                 "auto": adjacency_route(cfg, npts) == fmt,
                                 "embed_ms": cuda_ms(lambda: routes[fmt](xr), 3)})
            del xr
            torch.cuda.empty_cache()

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

    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"k1_b8": {"ms": ms8, "plain_ms": plain8, "bound_ms": b8[0],
                              "bound_by": b8[1], "shape": [8, n, 3], "k": k}}))
    log(json.dumps({"k2_n131072": {"ms": ms_k2_131, "bound_ms": b131[0],
                                   "bound_by": b131[1], "shape": [1, 131072, 3], "k": k}}))
    log(json.dumps({"tiled_splits": {"k2_b1_n65536": k2_splits, "k3_b2_n32768": k3_splits,
                                     "k2_b1_n4096": k2_splits_n4096, **k1_splits,
                                     "k5_c_b8_n4096": k5_splits, "k6_b8_n4096": k6_splits,
                                     "k": k}}))
    log(json.dumps({"tiled_b32_n4096": tiled_b32}))
    log(json.dumps({"routes": route_ms}))
    log(json.dumps({"serve": {"embed_batch32_ms": embed_ms,
                              "query1_ms_median": sorted(q_ms)[len(q_ms) // 2],
                              "query1_ms_min": min(q_ms), "query1_ms": q_ms,
                              "db_rows": len(ix)}}))
    log(json.dumps({"serve_http": http}))
    log(json.dumps({"serve_scale": scale}))
    log(json.dumps({"serve_ingest": ingest}))
    log(json.dumps({"convert": conv, "sampling": samp}))
    log(json.dumps({"evaluate": ev}))
    log(json.dumps({"bf16_gemm_check": {**gaps, "tolerance": BF16_TOL}}))
    log(json.dumps({"train": trained}))
    log(json.dumps({"train_bench": bench}))
    log(json.dumps({"multi_device": md}, default=str))
    log(json.dumps({"benchmark_cli": bench_cli}))
    log(json.dumps({"train_quality": quality}))
    log(json.dumps({"compile_cache": cache}))
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
