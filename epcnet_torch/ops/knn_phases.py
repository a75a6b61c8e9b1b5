"""The kNN trace's kernels (twins of the two Pallas kernels of
``scripts/hw_knn_trace.py``), measurement variants of K1.

- ``knn_phase`` (K5, ``csrc/knn_phase.cu``; TPU ``_kern_phase``): per row,
  the r-th smallest distinct fp32 distance, plus ``1e-20 * count(d <= it)``
  with ``thresh``. K1's selection stopped after its scan and r distinct
  values (and the count): the phase ablation of
  ``epcnet_torch/scripts/knn_trace.py`` times it.
- ``knn_adjacency_pipelined`` (K6, ``csrc/knn_pipelined.cu``; TPU
  ``_kern_pipelined``): K1's indicator, with the selection's input produced
  ahead of the selection that consumes it, and the fp32 proxy of bf16
  operands that the TPU variant emits.

Each kernel's C entry picks its core, as K1's does: for rounds / k up to 32
the tiled core of K1-K3 (``csrc/knn_tile.cuh``), above it the warp-per-row
designs of the first port, counted in ``launches_rounds``. A CPU tensor takes the
plain version beside each kernel, a CUDA tensor the kernel; there is no
fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from epcnet_torch.ops import _build
from epcnet_torch.ops.adjacency import count_adjacency
from epcnet_torch.ops.knn import _cloud_batch, knn_plain
from epcnet_torch.ops.matmul import matmul_f32acc
from epcnet_torch.ops.pairwise import pairwise_sqdist

PLAIN_BLOCK_ROWS = 1024  # query rows a step of knn_phase_plain, as knn_plain


def xyz_in_shared_memory(n: int) -> bool:
    """Whether K5's value rounds (rounds > 32) keep a cloud of N points in
    shared memory (up to N of about 18,700) or read xyz from global memory,
    as their launch plans it (``knn_phase_xyz_in_smem``; builds
    ``csrc/knn_phase.cu`` on first use). The tiled core, which runs rounds
    up to 32, streams the cloud in tiles at every N."""
    where = _build.call("knn_phase", "knn_phase_xyz_in_smem", "i", n)
    if where < 0:
        raise ValueError(f"K5 takes no cloud of N={n} points")
    return bool(where)


def knn_phase_plain(x: torch.Tensor, rounds: int, thresh: bool = False) -> torch.Tensor:
    """K5's plain version. For each block of ``PLAIN_BLOCK_ROWS`` query
    rows: the distances (``pairwise_sqdist``), a sort, the distinct rank of
    each sorted value, the first value of rank ``rounds`` (+inf if the row
    has fewer distinct values), and with ``thresh`` that value plus
    ``float32(1e-20) * count(d <= value)`` in fp32.

    Args:
      x: [..., N, D] coordinates. rounds: >= 1.

    Returns:
      [..., N] fp32.
    """
    if rounds < 1:
        raise ValueError(f"rounds={rounds} must be >= 1")
    n = x.shape[-2]
    out = []
    for r0 in range(0, n, PLAIN_BLOCK_ROWS):
        d = pairwise_sqdist(x[..., r0:r0 + PLAIN_BLOCK_ROWS, :], x)
        s = torch.sort(d, dim=-1).values
        new = torch.ones_like(s, dtype=torch.bool)
        new[..., 1:] = s[..., 1:] != s[..., :-1]
        below = torch.cumsum(new, dim=-1) < rounds  # True, then False along the row
        first = below.sum(-1, keepdim=True)  # where the distinct rank reaches `rounds`
        m = torch.gather(s, -1, first.clamp_max(n - 1))
        m = torch.where(first < n, m, torch.inf)
        if thresh:
            cnt = (d <= m).sum(-1, keepdim=True, dtype=torch.int32).float()
            # float32(1e-20), as the TPU kernel's weakly typed 1e-20 * cnt
            m = m + torch.tensor(1e-20, dtype=torch.float32, device=m.device) * cnt
        out.append(m[..., 0])
        del d, s, new, below
    return torch.cat(out, dim=-1)


def _launch_phase(x: torch.Tensor, rounds: int, thresh: bool = False, split: int = 0):
    """One launch of ``csrc/knn_phase.cu``; the kernel picks its core by
    rounds (``split``: the tiled core's threads a row, 0 for the kernel's
    own choice). Returns (out [B, N] fp32, whether the value rounds ran)."""
    x = _cloud_batch(x, 1, "K5")
    if rounds < 1:
        raise ValueError(f"rounds={rounds} must be >= 1")
    b, n, _ = x.shape
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    tiled = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        _build.launch("knn_phase", "knn_phase_launch", "piiiipipp", x.data_ptr(), b, n,
                      min(rounds, 2 ** 31 - 1), int(thresh), out.data_ptr(), split,
                      ctypes.addressof(tiled), torch.cuda.current_stream().cuda_stream)
    return out, not tiled.value


def knn_phase_cuda(x: torch.Tensor, rounds: int, thresh: bool = False) -> torch.Tensor:
    """Launch K5 on ``torch.cuda.current_stream()``. x: [B, N, 3] on the
    card; returns [B, N] fp32. rounds <= 32 runs the tiled core, more rounds
    the value rounds (the kernel's rule); both are checked on the card at
    rounds = 32 and 33. Each launch adds one to ``knn_phase_cuda.launches``,
    and one the kernel reports as the value rounds also to
    ``knn_phase_cuda.launches_rounds``."""
    out, ran_rounds = _launch_phase(x, rounds, thresh)
    knn_phase_cuda.launches_rounds += ran_rounds
    knn_phase_cuda.launches += 1
    return out


knn_phase_cuda.launches = 0
knn_phase_cuda.launches_rounds = 0


def knn_phase(x: torch.Tensor, rounds: int, thresh: bool = False) -> torch.Tensor:
    """The r-th smallest distinct fp32 distance of each row (r = ``rounds``;
    +inf if the row has fewer distinct values), plus ``1e-20 * count(d <=
    it)`` with ``thresh``. x: [..., N, 3]; returns [..., N] fp32. A CUDA
    tensor goes through K5, a CPU tensor through ``knn_phase_plain``."""
    if x.device.type == "cpu":
        return knn_phase_plain(x, rounds, thresh)
    *lead, n, d = x.shape
    return knn_phase_cuda(x.reshape(-1, n, d), rounds, thresh).reshape(*lead, n)


def knn_adjacency_pipelined_plain(x: torch.Tensor, k: int):
    """K6's plain version: the indicator as ``count_adjacency(knn_plain(x,
    k))`` (int8, K1's), and the proxy as the product of the bf16 indicator
    and bf16 coordinates summed in fp32, times float32(1/k), kept in fp32.
    Returns (indicator [..., N, N] int8, proxy [..., N, 3] fp32)."""
    ind = count_adjacency(knn_plain(x, k), x.shape[-2], torch.int8)
    inv_k = torch.tensor(1.0 / k, dtype=torch.float32, device=x.device)
    proxy = matmul_f32acc(ind.to(torch.bfloat16), x.to(torch.bfloat16)) * inv_k
    return ind, proxy


def _launch_pipelined(x: torch.Tensor, k: int, split: int = 0):
    """One launch of ``csrc/knn_pipelined.cu``; the kernel picks its design
    by k (``split``: the tiled core's threads a row, 0 for the kernel's own
    choice). Returns (adj, proxy, whether the warp pairs ran)."""
    x = _cloud_batch(x, k, "K6")
    b, n, _ = x.shape
    adj = torch.empty((b, n, n), dtype=torch.int8, device=x.device)
    proxy = torch.empty((b, n, 3), dtype=torch.float32, device=x.device)
    tiled = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        _build.launch("knn_pipelined", "knn_pipelined_launch", "piiippfipp", x.data_ptr(), b,
                      n, k, adj.data_ptr(), proxy.data_ptr(), 1.0 / k, split,
                      ctypes.addressof(tiled), torch.cuda.current_stream().cuda_stream)
    return adj, proxy, not tiled.value


def knn_adjacency_pipelined_cuda(x: torch.Tensor, k: int):
    """Launch K6 on ``torch.cuda.current_stream()``: the int8 indicator
    [B, N, N] (K1's) and the fp32 proxy [B, N, 3]. x: [B, N, 3] on the card.
    k <= 32 runs the tiled core fed by a producer warp, at any N; a larger k
    the first design's warp pairs (the kernel's rule), which hold two distance rows in
    shared memory: there it raises ``ValueError`` when they do not fit (N
    above about 27,700; the kernel's own plan, ``knn_pipelined_fits``). Each
    launch adds one to ``knn_adjacency_pipelined_cuda.launches``, and one
    the kernel reports as the warp pairs also to
    ``knn_adjacency_pipelined_cuda.launches_rounds``."""
    x = _cloud_batch(x, k, "K6")
    n = x.shape[1]
    if not _build.call("knn_pipelined", "knn_pipelined_fits", "ii", n, k):
        raise ValueError(f"K6: at N={n} and k={k} one warp pair's two distance rows and "
                         "bitmask do not fit in a block's shared memory (227 KB)")
    adj, proxy, pairs = _launch_pipelined(x, k)
    knn_adjacency_pipelined_cuda.launches_rounds += pairs
    knn_adjacency_pipelined_cuda.launches += 1
    return adj, proxy


knn_adjacency_pipelined_cuda.launches = 0
knn_adjacency_pipelined_cuda.launches_rounds = 0


def knn_adjacency_pipelined(x: torch.Tensor, k: int):
    """K1's indicator and the fp32 proxy of bf16 operands, through K6 on a
    CUDA tensor or ``knn_adjacency_pipelined_plain`` on a CPU tensor. x:
    [..., N, 3]; returns (int8 [..., N, N], fp32 [..., N, 3])."""
    if x.device.type == "cpu":
        return knn_adjacency_pipelined_plain(x, k)
    *lead, n, d = x.shape
    adj, proxy = knn_adjacency_pipelined_cuda(x.reshape(-1, n, d), k)
    return adj.reshape(*lead, n, n), proxy.reshape(*lead, n, d)
