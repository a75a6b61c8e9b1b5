"""Descriptor retrieval: batched query-vs-database distance + exact top-k
(twin of the single-device part of ``epcnet_tpu/ops/retrieval.py``).

fp32 throughout (TF32 is off: ``epcnet_torch.ops`` imports ops/vlad.py).
Results are nearest first, ties to the lowest index, as ``jax.lax.top_k``.

``topk_neighbors`` and ``topk_neighbors_quantized`` (the serving path) walk
the database in blocks of ``block_rows`` rows, all of one shape (a tail
that does not fill a block is the last ``block_rows`` rows, the part
already seen masked out), so one GEMM configuration computes every
distance. A block gives its [Q, block] fp32 distances and keeps its k best;
the candidates of all blocks then merge into the final k. Transient memory
is bounded by the block, not by the database: the int8 path widens one
block to fp32 at a time, never the whole database.

Selection is ``torch.topk`` on unique int64 keys ``(bits(d) << 32) | row``:
distances are >= 0 (``+ 0.0`` turns a -0.0 into +0.0), so their fp32 bit
patterns order as the values do, and a key orders (distance, row) exactly
as JAX's ties do, whatever order ``torch.topk`` breaks ties in. The
full-matrix versions (``*_plain``: one [Q, N] matrix, one stable sort) are
the reference that tests and ``chip_smoke.py`` hold the blocked path to;
the serving path does not run them. The sharded and ring variants are the
multi-device slice (ROADMAP item 6).
"""

from __future__ import annotations

from typing import Callable

import torch

# rows a block, powers of two, so that they divide every serving capacity
# past them (the index's 4096-row blocks * 2^m). Each block costs a dozen
# launches, so fewer, larger blocks run faster (PERF.md §5: 2^16-row
# blocks were slower than the full sort at 10^6 rows); the int8 block is
# smaller because it is widened to fp32: 2^17 rows keep a Q=32 query's
# transients (the widened block 134 MB, distances and keys) under the
# 268 MB of a resident 2^20-row int8 DB
BLOCK_ROWS = 1 << 18
BLOCK_ROWS_INT8 = 1 << 17
_NEVER = torch.iinfo(torch.int64).max


def l2_distance_matrix(queries: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q, N] squared L2 distances (fp32)."""
    q = queries.float()
    d = database.float()
    qq = (q * q).sum(-1, keepdim=True)
    dd = (d * d).sum(-1)[None, :]
    return (qq + dd - 2.0 * (q @ d.t())).clamp_min(0.0)


def _smallest_k(d: torch.Tensor, k: int):
    """(idx int32 [Q, k], values [Q, k]): ascending value, then index."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return idx[:, :k].to(torch.int32), vals[:, :k]


def _keys(d: torch.Tensor, first: int) -> torch.Tensor:
    """[Q, n] distances >= 0 of rows ``first..first+n-1`` -> unique int64
    keys in (distance, row) order."""
    bits = (d + 0.0).view(torch.int32).to(torch.int64)
    rows = torch.arange(first, first + d.shape[1], dtype=torch.int64, device=d.device)
    return (bits << 32) | rows


def blocked_smallest_k(dist_fn: Callable[[int, int], torch.Tensor], n: int, k: int,
                       block_rows: int = BLOCK_ROWS, n_valid: int | None = None):
    """The k smallest of a [Q, n] distance matrix that ``dist_fn(start,
    stop)`` gives one [Q, stop - start] block at a time. Returns (idx int32
    [Q, k], distances fp32 [Q, k]), ascending distance, then index.

    With ``n_valid`` only rows below it are candidates: blocks past it are
    not computed, and the rows past it in the last block are masked out (an
    index's rows not yet synced, which may be being written). A result slot
    past the candidates (k > n_valid) holds index -1 and a NaN distance."""
    n_valid = n if n_valid is None else n_valid
    if not 1 <= k <= n or not 1 <= n_valid <= n:
        raise ValueError(f"k={k} or n_valid={n_valid} outside [1, {n}]")
    block = min(n, block_rows)
    starts = list(range(0, n - block + 1, block))
    if starts[-1] + block < n:
        starts.append(n - block)  # the tail, shifted back to a full block
    cands, seen = [], 0
    for s in starts:
        if s >= n_valid:
            break
        keys = _keys(dist_fn(s, s + block), s)
        if s < seen:  # rows [s, seen) were in the previous block
            keys[:, : seen - s] = _NEVER
        if s + block > n_valid:
            keys[:, n_valid - s:] = _NEVER
        cands.append(torch.topk(keys, min(k, block), dim=1, largest=False).values)
        del keys  # before the next block's distances: the peak is one block's
        seen = s + block
    keys = cands[0] if len(cands) == 1 else torch.topk(
        torch.cat(cands, 1), k, dim=1, largest=False).values
    idx = (keys & 0xFFFFFFFF).to(torch.int32)
    dist = (keys >> 32).to(torch.int32).view(torch.float32)
    return idx, dist


def topk_neighbors(queries: torch.Tensor, database: torch.Tensor, k: int,
                   block_rows: int = BLOCK_ROWS, n_valid: int | None = None):
    """Exact k-NN of each query in the database (its first ``n_valid``
    rows), a block of rows at a time. Returns (idx [Q, k] int32, sqdist
    [Q, k] fp32), nearest first."""
    return blocked_smallest_k(lambda s, e: l2_distance_matrix(queries, database[s:e]),
                              database.shape[0], k, block_rows, n_valid)


def topk_neighbors_plain(queries: torch.Tensor, database: torch.Tensor, k: int):
    """:func:`topk_neighbors` over the whole [Q, N] matrix at once."""
    return _smallest_k(l2_distance_matrix(queries, database), k)


def quantize_descriptors(desc: torch.Tensor):
    """Symmetric per-row int8: [N, D] fp32 -> (int8 [N, D], scale fp32
    [N, 1]) with ``dequant = int8 * scale``; round half to even, as
    ``jnp.round``."""
    desc = desc.float()
    scale = (desc.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(desc / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_descriptors(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_descriptors` (fp32); not on the hot path."""
    return q.float() * scale


def quantized_distance_matrix(queries: torch.Tensor, db_q: torch.Tensor,
                              db_scale: torch.Tensor) -> torch.Tensor:
    """[Q, D] fp32 x ([N, D] int8, [N, 1] scale) -> [Q, N] squared L2 in
    dequantised space, with the per-row scale factored out of both terms
    that touch the database:

      |x_n|^2   = s_n^2 * sum_d qi[n, d]^2   (exact in fp32)
      q_i . x_n = s_n * (q @ qi^T)[i, n]

    Unlike XLA, eager PyTorch does not fuse the int8 -> fp32 convert into
    the product, so the N rows it is given exist widened for the length of
    the call (squared in place after the product): the serving path gives
    it one block.
    """
    q = queries.float()
    qq = (q * q).sum(-1, keepdim=True)
    s = db_scale.float()[:, 0]
    dbf = db_q.float()
    cross = (q @ dbf.t()) * s[None, :]
    dd = (dbf.square_().sum(-1) * (s * s))[None, :]
    return (qq + dd - 2.0 * cross).clamp_min(0.0)


def topk_neighbors_quantized(queries: torch.Tensor, db_q: torch.Tensor,
                             db_scale: torch.Tensor, k: int, block_rows: int = BLOCK_ROWS_INT8,
                             n_valid: int | None = None):
    """k-NN against an int8 database (distances in dequantised space; its
    first ``n_valid`` rows), a block of rows at a time."""
    return blocked_smallest_k(
        lambda s, e: quantized_distance_matrix(queries, db_q[s:e], db_scale[s:e]),
        db_q.shape[0], k, block_rows, n_valid)


def topk_neighbors_quantized_plain(queries: torch.Tensor, db_q: torch.Tensor,
                                   db_scale: torch.Tensor, k: int):
    """:func:`topk_neighbors_quantized` over the whole [Q, N] matrix at once."""
    return _smallest_k(quantized_distance_matrix(queries, db_q, db_scale), k)
