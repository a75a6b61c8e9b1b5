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
the serving path does not run them.

Sharded retrieval runs in one process over a device-list ``Mesh``
(``parallel/mesh.py``): the rows are dealt out over the devices of the
"db" axis (row r to shard r % ndev, so that a serving index's shards grow
in place), and each shard retrieves its k best there, blocked as above; the candidates
are rebased to global rows, copied to the first device and merged on the
same keys, so ties go to the lowest global row. ``sharded_topk_neighbors``
merges every shard's candidates at once (JAX's all-gather);
``ring_topk_neighbors`` carries one list of k from shard to shard, merging
at each (JAX's ring). The ring kNN over the point axis
(``ring_knn_local``) runs one process a rank over a process group.
"""

from __future__ import annotations

from typing import Callable

import torch

from epcnet_torch.ops.knn import knn
from epcnet_torch.ops.pairwise import pairwise_sqdist
from epcnet_torch.parallel.collectives import all_gather, group_rank, group_size, ring_shift

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


def _pack(d: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Distances >= 0 and their rows (< 2^31) -> int64 keys that order as
    (distance, row) does."""
    bits = (d + 0.0).view(torch.int32).to(torch.int64)
    return (bits << 32) | rows.to(torch.int64)


def _keys(d: torch.Tensor, first: int) -> torch.Tensor:
    """[Q, n] distances >= 0 of rows ``first..first+n-1`` -> unique int64
    keys in (distance, row) order."""
    return _pack(d, torch.arange(first, first + d.shape[1], device=d.device))


def _unpack(keys: torch.Tensor):
    """(idx int32, distances fp32) of (distance bits, row) keys; a
    ``_NEVER`` slot gives index -1 and a NaN distance."""
    idx = (keys & 0xFFFFFFFF).to(torch.int32)
    dist = (keys >> 32).to(torch.int32).view(torch.float32)
    return idx, dist


def _blocked_keys(dist_fn: Callable[[int, int], torch.Tensor], n: int, k: int,
                  block_rows: int, n_valid: int | None) -> torch.Tensor:
    """The k smallest (distance bits, row) keys of :func:`blocked_smallest_k`."""
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
    return cands[0] if len(cands) == 1 else torch.topk(
        torch.cat(cands, 1), k, dim=1, largest=False).values


def blocked_smallest_k(dist_fn: Callable[[int, int], torch.Tensor], n: int, k: int,
                       block_rows: int = BLOCK_ROWS, n_valid: int | None = None):
    """The k smallest of a [Q, n] distance matrix that ``dist_fn(start,
    stop)`` gives one [Q, stop - start] block at a time. Returns (idx int32
    [Q, k], distances fp32 [Q, k]), ascending distance, then index.

    With ``n_valid`` only rows below it are candidates: blocks past it are
    not computed, and the rows past it in the last block are masked out (an
    index's rows not yet synced, which may be being written). A result slot
    past the candidates (k > n_valid) holds index -1 and a NaN distance."""
    return _unpack(_blocked_keys(dist_fn, n, k, block_rows, n_valid))


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


# -- sharded retrieval: one process over the devices of a mesh axis ---------


def _rebase(keys: torch.Tensor, stride: int, offset: int) -> torch.Tensor:
    """Keys of a shard's local rows -> keys of their global rows
    ``local * stride + offset`` (a ``_NEVER`` slot stays one)."""
    local = keys & 0xFFFFFFFF
    return torch.where(keys == _NEVER, keys, (keys - local) | (local * stride + offset))


def _shard_keys(queries: torch.Tensor, db: torch.Tensor, k: int, scale=None,
                n_valid: int | None = None) -> torch.Tensor:
    """One shard's k best (distance bits, local row) keys [Q, min(k, rows)],
    blocked, on the shard's device; int8 with ``scale``."""
    q = queries.to(db.device)
    k = min(k, db.shape[0])
    if scale is None:
        return _blocked_keys(lambda s, e: l2_distance_matrix(q, db[s:e]),
                             db.shape[0], k, BLOCK_ROWS, n_valid)
    return _blocked_keys(lambda s, e: quantized_distance_matrix(q, db[s:e], scale[s:e]),
                         db.shape[0], k, BLOCK_ROWS_INT8, n_valid)


def _merge(cands: list, k: int) -> torch.Tensor:
    """The k smallest keys of the concatenated candidate lists, padded with
    ``_NEVER`` where they hold fewer than k."""
    keys = torch.cat(cands, 1)
    if keys.shape[1] < k:
        keys = torch.cat([keys, torch.full((keys.shape[0], k - keys.shape[1]), _NEVER,
                                           dtype=keys.dtype, device=keys.device)], 1)
    return torch.topk(keys, k, dim=1, largest=False).values


def topk_over_shards(queries: torch.Tensor, shards: list, k: int, scales: list | None = None,
                     n_valid: list | None = None):
    """Exact k-NN over a database dealt out row by row over ``ndev`` shards,
    each on its own device (int8 with ``scales``): global row r is shard
    r % ndev's local row r // ndev, so that an index's shards grow in place.
    ``n_valid[s]``: the candidates of shard s are its first n_valid[s] rows
    (0: none; default: all). Returns (idx int32 [Q, k], sqdist [Q, k]) on the
    first shard's device, nearest first, ties to the lowest global row; a
    slot past every candidate holds -1 and NaN."""
    ndev, dest = len(shards), shards[0].device
    cands = []
    for s, db in enumerate(shards):
        v = db.shape[0] if n_valid is None else n_valid[s]
        if v == 0:  # an empty shard (a DB of fewer rows than shards)
            continue
        keys = _shard_keys(queries, db, k, None if scales is None else scales[s], v)
        cands.append(_rebase(keys, ndev, s).to(dest))
    return _unpack(_merge(cands, k))


def _deal(database: torch.Tensor, devices: list) -> list:
    """Row r of ``database`` to shard r % ndev, each shard on its device
    (the layout of :func:`topk_over_shards`)."""
    return [database[s::len(devices)].contiguous().to(dev) for s, dev in enumerate(devices)]


def sharded_topk_neighbors(queries: torch.Tensor, database: torch.Tensor, k: int, mesh,
                           axis: str = "db", db_scale: torch.Tensor | None = None):
    """Exact retrieval with the database's rows sharded over the devices of
    ``mesh``'s ``axis`` (a ``parallel.Mesh``), dealt out row by row. A shard
    holding fewer than k rows offers them all (n >= k). ``db_scale``
    given: ``database`` is int8 (``quantize_descriptors``), and each shard
    reads its own rows widened a block at a time. Every shard's k candidates
    are merged at once on the first device. Returns (idx, sqdist) there."""
    if not 1 <= k <= database.shape[0]:
        raise ValueError(f"k={k} outside [1, {database.shape[0]}]")
    devices = mesh.devices(axis)
    return topk_over_shards(queries, _deal(database, devices), k,
                            None if db_scale is None else _deal(db_scale, devices))


def ring_topk_neighbors(queries: torch.Tensor, database: torch.Tensor, k: int, mesh,
                        axis: str = "db"):
    """The ring variant of :func:`sharded_topk_neighbors` (fp32): one list
    of k candidates travels from shard to shard, each merging its own k
    into it, so a hop moves k candidates a query, not k * ndev. The same
    result; returned on the first device."""
    if not 1 <= k <= database.shape[0]:
        raise ValueError(f"k={k} outside [1, {database.shape[0]}]")
    devices = mesh.devices(axis)
    carried = None
    for s, db in enumerate(_deal(database, devices)):
        if db.shape[0] == 0:
            continue
        keys = _rebase(_shard_keys(queries, db, k), len(devices), s)
        carried = keys if carried is None else _merge([carried.to(db.device), keys], k)
    return _unpack(carried.to(devices[0]))


# -- the ring kNN over the point axis: one process a rank ------------------

# query rows a block of a cross-shard hop: the [rows, nl] distances and
# their keys (at nl = 65536: 268 MB and 537 MB) instead of JAX's whole
# [nl, nl] block (17 GB)
RING_BLOCK_ROWS = 1024


def ring_knn_local(xs: torch.Tensor, k: int, group):
    """One rank's part of the ring kNN over the point axis: ``xs`` is this
    rank's [nl, D] block of one cloud (rank r holds global rows r*nl ..);
    returns (idx [nl, k] int32 GLOBAL ids, sqdist [nl, k] fp32) of its rows,
    nearest first, ties to the lowest global id: exactly the single-device
    kNN's (``knn_plain``; JAX's ring breaks ties by merge order instead).

    Hop 0 is the rank's own block, its self-kNN: K2 on the card
    (``ops/knn.py::knn``), its plain version on the CPU, ids rebased by
    r*nl. At each later hop the candidate block of rank r - h arrives
    (``ring_shift``) and its distances are the plain diff² in coordinate
    order (``pairwise_sqdist``, bit-equal to K2's), a block of query rows
    at a time; each hop's k best merge into the running lists."""
    nl = xs.shape[0]
    if k > nl:
        raise ValueError(f"k={k} exceeds points-per-shard {nl}")
    w, r = group_size(group), group_rank(group)
    xs = xs.float().contiguous()
    idx0, d0 = knn(xs[None], k, return_dists=True)
    best = _pack(d0[0], idx0[0] + r * nl)
    blk = xs
    for h in range(1, w):
        blk = ring_shift(blk, group)
        parts = [_blocked_keys(lambda s, e: pairwise_sqdist(xs[q0:q0 + RING_BLOCK_ROWS], blk[s:e]),
                               nl, k, BLOCK_ROWS, None) for q0 in range(0, nl, RING_BLOCK_ROWS)]
        best = _merge([best, _rebase(torch.cat(parts), 1, (r - h) % w * nl)], k)
    return _unpack(best)


def ring_knn_points(x: torch.Tensor, k: int, group):
    """The kNN graph of ONE cloud [N, D] (given whole on every rank) with
    its point axis sharded over the ranks of ``group``: N is padded to a
    multiple of the group size with far rows (1e6), rank r computes its
    rows' lists (:func:`ring_knn_local`), and the lists are gathered.
    Returns (idx [N, k] int32, sqdist [N, k]) on every rank."""
    w, r = group_size(group), group_rank(group)
    n = x.shape[0]
    nl = -(-n // w)
    if k > nl:
        raise ValueError(f"k={k} exceeds points-per-shard {nl}")
    xp = torch.cat([x.float(), torch.full((nl * w - n, x.shape[1]), 1e6, device=x.device)])
    idx, dist = ring_knn_local(xp[r * nl:(r + 1) * nl], k, group)
    return (all_gather(idx, group).reshape(-1, k)[:n],
            all_gather(dist, group).reshape(-1, k)[:n])
