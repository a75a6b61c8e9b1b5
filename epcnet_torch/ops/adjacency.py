"""Neighbourhood mean through the dense 0/1 indicator adjacency (twin of the
dense parts of ``epcnet_tpu/ops/adjacency.py``).

ProxyConv averages each point's K neighbour features ("proxy point"). As in
the JAX package the kNN graph is built once per forward as an [N, N]
indicator and every layer's mean is one matmul ``A @ F`` scaled by 1/K
afterwards, so the [N, K, C] edge tensor never exists. The packed
(bit-plane) and gather routes are not ported yet (ROADMAP item 6).
"""

from __future__ import annotations

import torch

from epcnet_torch.ops.matmul import matmul_f32acc


def count_adjacency(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """Unnormalised adjacency counts: entry [..., i, j] is how often j occurs
    in row i's neighbour list — a scatter of ones. kNN indices are distinct,
    so the counts are the 0/1 indicator, exact in any dtype."""
    out = torch.zeros(idx.shape[:-1] + (n,), dtype=dtype, device=idx.device)
    idx = idx.long()
    return out.scatter_add_(-1, idx, torch.ones(idx.shape, dtype=dtype,
                                                device=idx.device))


def neighbor_mean(
    features: torch.Tensor,
    adjacency: torch.Tensor,
    compute_dtype=torch.bfloat16,
    adjacency_scale: float | None = None,
) -> torch.Tensor:
    """Per-point mean of neighbour features via a dense adjacency.

    ``adjacency`` [..., N, N] is either the 1/K-normalised matrix
    (``adjacency_scale=None``) or the 0/1 indicator with
    ``adjacency_scale=1/K``. Both operands go to ``compute_dtype``, the sum
    is fp32, the scale multiplies the fp32 sum after the product, and the
    result is cast back to the features' dtype — the arithmetic of
    ``epcnet_tpu.ops.adjacency.neighbor_mean``.
    """
    f = features.to(compute_dtype)
    out = matmul_f32acc(adjacency.to(compute_dtype), f)
    if adjacency_scale is not None:
        out = out * adjacency_scale
    return out.to(features.dtype)
