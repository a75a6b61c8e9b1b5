"""The PointNet++-family sampling and grouping ops (twin of
``epcnet_tpu/ops/sampling.py``): farthest point sampling, ``gather_point``,
``prob_sample``, ``ball_query``, ``group_point``, ``three_nn`` and
``three_interpolate``, as plain functions on tensors of any device.

No model path runs them (EPC-Net keeps all its points and uses kNN only),
and the JAX package has no Pallas kernel for them, so they are library ops
here; gradients come from autograd, as JAX's come from autodiff. Ids follow
the JAX functions exactly: FPS starts at index 0 and takes the first
maximum, distances are ``ops/pairwise.py``'s (bit-equal to JAX's), and
``three_nn`` breaks ties by the lowest index, as ``lax.top_k``.
"""

from __future__ import annotations

import torch

from epcnet_torch.ops.pairwise import pairwise_sqdist


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative max-min FPS. xyz: [..., N, 3] -> idx [..., npoint] int32;
    the first point is index 0."""
    lead = xyz.shape[:-2]
    pts = xyz.reshape((-1,) + tuple(xyz.shape[-2:])).float()
    b, n = pts.shape[:2]
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=pts.device)
    mind = torch.full((b, n), float("inf"), device=pts.device)
    rows = torch.arange(b, device=pts.device)
    for i in range(1, npoint):
        last = pts[rows, idx[:, i - 1]]  # [b, 3]
        diff = pts - last[:, None]
        # fma(dz, dz, fma(dy, dy, dx * dx)) in fp32, as XLA's CPU backend
        # contracts JAX's sum of squares (and nvcc the reference CUDA
        # kernel's): the product of two fp32 is exact in fp64, and the sum
        # rounds there before fp32 (a double rounding that can differ from
        # one fused rounding only where the fp64 sum lands on an fp32 midpoint)
        d = diff[..., 0] * diff[..., 0]
        for c in range(1, pts.shape[-1]):
            d = (diff[..., c].double() * diff[..., c] + d).float()
        mind = torch.minimum(mind, d)
        idx[:, i] = torch.argmax(mind, dim=-1)  # the first maximum
    return idx.to(torch.int32).reshape(tuple(lead) + (npoint,))


def gather_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [..., N, C], idx [..., M] -> [..., M, C]."""
    return torch.take_along_dim(points, idx[..., None].long(), dim=-2)


def prob_sample(inp: torch.Tensor, inpr: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sampling: for each draw ``r`` of ``inpr`` [..., M], the
    smallest index ``i`` with ``cumsum(inp)[i] >= r`` over a probability
    row ``inp`` [..., N] (not normalised: rows are meant to sum to 1); a
    draw past the total mass takes the last index. Returns [..., M] int32."""
    cdf = torch.cumsum(inp.float(), dim=-1).contiguous()
    idx = torch.searchsorted(cdf, inpr.float().contiguous(), right=False)
    return idx.clamp_max(inp.shape[-1] - 1).to(torch.int32)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """For each centre of ``new_xyz`` [..., M, 3], up to ``nsample``
    in-radius point indices of ``xyz`` [..., N, 3] in ascending order, the
    first hit repeated where there are fewer; a centre with no hit gets 0.
    Returns [..., M, nsample] int32."""
    n = xyz.shape[-2]
    d = pairwise_sqdist(new_xyz, xyz)  # [..., M, N]
    col = torch.arange(n, device=d.device).expand(d.shape)
    ranked = torch.where(d <= radius * radius, col, torch.full_like(col, n))
    ranked = torch.sort(ranked, dim=-1).values[..., :nsample]
    idx = torch.where(ranked == n, ranked[..., :1], ranked)
    return torch.where(idx == n, torch.zeros_like(idx), idx).to(torch.int32)


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [..., N, C], idx [..., M, K] -> [..., M, K, C]."""
    return torch.take_along_dim(points[..., None, :, :], idx[..., None].long(), dim=-2)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The 3 nearest ``known`` points of each ``unknown`` point. Returns
    (squared distances [..., N, 3], idx [..., N, 3] int32), nearest first."""
    d = pairwise_sqdist(unknown, known)
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :3], idx[..., :3].to(torch.int32)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, dists: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance-weighted interpolation over the 3-NN: weights 1/d
    normalised over the three neighbours."""
    w = 1.0 / (dists + eps)  # [..., N, 3]
    w = w / w.sum(-1, keepdim=True)
    return (group_point(points, idx) * w[..., None]).sum(-2)
