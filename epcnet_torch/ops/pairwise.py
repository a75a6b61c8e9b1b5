"""Pairwise squared Euclidean distances (twin of ``epcnet_tpu/ops/pairwise.py``).

Distances stay fp32: bf16 ties reorder neighbours and perturb descriptor
topology (SURVEY.md §7.4).
"""

from __future__ import annotations

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Squared L2 distances between row sets.

    Args:
      a: [..., N, D]
      b: [..., M, D] (defaults to ``a``)

    Returns:
      [..., N, M] fp32, d[i, j] = ||a_i - b_j||^2 (clamped at 0).

    For D <= 8 the sum is ``d = d + diff * diff`` per coordinate in
    coordinate order, as separate multiply and add (no fused multiply-add):
    bit-equal to the JAX function and to the K1 kernel
    (``csrc/knn_adj.cu``), so neighbour sets agree exactly under ties.
    """
    if b is None:
        b = a
    a = a.float()
    b = b.float()
    if a.shape[-1] <= 8:
        d = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32,
                        device=a.device)
        for c in range(a.shape[-1]):
            diff = a[..., :, c, None] - b[..., None, :, c]
            d = d + diff * diff
        return d
    a_sq = (a * a).sum(-1, keepdim=True)  # [..., N, 1]
    b_sq = (b * b).sum(-1, keepdim=True)  # [..., M, 1]
    # full fp32 product (TF32 is off for the port: ops/vlad.py)
    cross = torch.matmul(a, b.transpose(-1, -2))
    d = a_sq - 2.0 * cross + b_sq.transpose(-1, -2)
    return d.clamp_min(0.0)
