"""Descriptor retrieval: batched query-vs-database distance + exact top-k
(twin of the single-device part of ``epcnet_tpu/ops/retrieval.py``).

fp32 throughout (TF32 is off: ``epcnet_torch.ops`` imports ops/vlad.py).
Ties break by the lowest index, as ``jax.lax.top_k`` does: the k smallest
come from a stable sort, which ``torch.topk`` does not promise. The sharded and ring variants are the
multi-device slice (ROADMAP item 6).
"""

from __future__ import annotations

import torch


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


def topk_neighbors(queries: torch.Tensor, database: torch.Tensor, k: int):
    """Exact k-NN of each query in the database.
    Returns (idx [Q, k] int32, sqdist [Q, k] fp32), nearest first."""
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
    the product, so the widened database exists for the length of the call.
    """
    q = queries.float()
    qq = (q * q).sum(-1, keepdim=True)
    s = db_scale.float()[:, 0]
    dbf = db_q.float()
    dd = ((dbf * dbf).sum(-1) * (s * s))[None, :]
    cross = (q @ dbf.t()) * s[None, :]
    return (qq + dd - 2.0 * cross).clamp_min(0.0)


def topk_neighbors_quantized(queries: torch.Tensor, db_q: torch.Tensor,
                             db_scale: torch.Tensor, k: int):
    """k-NN against an int8 database (distances in dequantised space)."""
    return _smallest_k(quantized_distance_matrix(queries, db_q, db_scale), k)
