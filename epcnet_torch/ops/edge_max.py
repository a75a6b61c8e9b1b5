"""DGCNN's EdgeConv in eval from per-point products (K10,
``csrc/edge_max.cu``).

EdgeConv computes, over the k neighbours j of point i (self included),
``x'_i = max_j LeakyReLU(BN(W [x_j - x_i, x_i]))``. Split W = [W1 | W2]
over its input columns: ``W [x_j - x_i, x_i] = W1 x_j + (W2 - W1) x_i``. In
eval BN is a fixed affine map per channel, increasing where its scale is
>= 0 and decreasing where it is < 0 (``rsqrt(var + eps)`` is positive), and
the LeakyReLU is increasing, so the max over j passes inside both: per
channel c,

  x'_ic = LeakyReLU(BN_c((M_ic - Y1_ic) + Y2_ic)),
  M_ic = max_j Y1_jc where scale_c >= 0, min_j Y1_jc where scale_c < 0,

with ``Y1 = x W1ᵀ`` and ``Y2 = x W2ᵀ`` products over the points, not the
edges. Every rounded step after M is monotone in M too, so in any precision
this is the max of the same rounded function of ``Y1_j`` over j.

``edge_max_plain`` computes it from ``y = [Y1, Y2]`` ([..., N, 2·Cout]):
the max or min of the gathered Y1 rows, the subtraction and the sum each
rounded in y's dtype, then ``bn_affine`` (BN's order of operations, rounded
to ``dtype``) and the LeakyReLU. ``edge_max_cuda`` launches K10 on fp32 y,
bit-equal to it with bf16 output; ``edge_max`` takes the plain version on a
CPU tensor and K10 on a CUDA tensor, with no fallback between them. No
backward: the model calls it only where no autograd graph is built.
"""

from __future__ import annotations

import torch

from epcnet_torch.ops import _build
from epcnet_torch.ops.adjacency import gather_neighbors
from epcnet_torch.ops.bn_act import activation, bn_affine

# DGCNN's EdgeConv widths, the output widths K10 takes: half a warp a
# point at 64, a warp at 128, a warp with two 16-byte vectors a lane at 256
K10_WIDTHS = (64, 128, 256)
K10_MAX_K = 32
LEAKY_SLOPE = 0.2  # DGCNN's LeakyReLU, compiled into K10 (kSlope)


def edge_max_plain(y: torch.Tensor, ids: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor, epsilon: float,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """K10's plain version: y [..., N, 2·Cout] (fp32, or fp64) and ids
    [..., N, k] -> [..., N, Cout] in ``dtype``."""
    cout = y.shape[-1] // 2
    y1, y2 = y[..., :cout], y[..., cout:]
    nbr = gather_neighbors(y1, ids)  # [..., N, k, Cout]
    top = torch.where(scale >= 0, nbr.amax(-2), nbr.amin(-2))
    return activation(bn_affine((top - y1) + y2, mean, var, scale, bias, epsilon, dtype),
                      LEAKY_SLOPE)


def edge_max_cuda(y: torch.Tensor, ids: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Launch K10 on ``torch.cuda.current_stream()``: y a contiguous fp32
    [..., N, 2·Cout] on the card with Cout in ``K10_WIDTHS``, ids int32
    [..., N, k] with k <= 32 and every id in [0, N) (not checked: K2 and K8
    make them so), the four [Cout] vectors fp32 on the same card.
    ``rsqrt(var + eps)`` is computed here by torch, as ``bn_affine`` computes
    it. Returns bf16 [..., N, Cout]. Each launch adds one to
    ``edge_max_cuda.launches``."""
    vectors = (mean, var, scale, bias)
    if y.device.type != "cuda" or any(t.device != y.device for t in (ids, *vectors)):
        raise ValueError(f"K10 takes CUDA tensors on one card, got {y.device}, {ids.device} "
                         f"and {[str(v.device) for v in vectors]}")
    if y.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError(f"K10 takes fp32 products and int32 ids, got {y.dtype}, {ids.dtype}")
    if y.dim() < 2 or y.shape[-1] % 2 or y.shape[-1] // 2 not in K10_WIDTHS:
        raise ValueError(f"K10 takes [..., N, 2·Cout] with Cout in {K10_WIDTHS}, got "
                         f"{tuple(y.shape)}")
    cout, n, k = y.shape[-1] // 2, y.shape[-2], ids.shape[-1]
    if ids.shape[:-1] != y.shape[:-1] or not 1 <= k <= min(K10_MAX_K, n):
        raise ValueError(f"K10 takes ids [..., N, k] with k <= {K10_MAX_K} beside y, got "
                         f"{tuple(ids.shape)} and {tuple(y.shape)}")
    if not y.is_contiguous() or y.data_ptr() % 16 or not ids.is_contiguous():
        raise ValueError("K10 takes contiguous y at a 16-byte boundary and contiguous ids")
    if any(v.dtype != torch.float32 or v.shape != (cout,) for v in vectors):
        raise ValueError(f"K10 takes fp32 [{cout}] vectors, got "
                         f"{[(v.dtype, tuple(v.shape)) for v in vectors]}")
    points = y.numel() // (2 * cout)
    if points >= 2 ** 31:
        raise ValueError(f"K10 takes fewer than 2^31 points, got {points}")
    inv = torch.rsqrt(var + epsilon)
    mean, scale, bias = (v.contiguous() for v in (mean, scale, bias))
    if any(v.data_ptr() % 16 for v in (mean, scale, bias)):
        raise ValueError("K10 takes [Cout] vectors at 16-byte boundaries")
    out = torch.empty((*y.shape[:-1], cout), dtype=torch.bfloat16, device=y.device)
    with torch.cuda.device(y.device):
        _build.launch("edge_max", "edge_max_launch", "pppppppiiiip",
                      y.data_ptr(), ids.data_ptr(), mean.data_ptr(), inv.data_ptr(),
                      scale.data_ptr(), bias.data_ptr(), out.data_ptr(), points, n, k, cout,
                      torch.cuda.current_stream().cuda_stream)
    edge_max_cuda.launches += 1
    return out


edge_max_cuda.launches = 0


def edge_max(y: torch.Tensor, ids: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
             scale: torch.Tensor, bias: torch.Tensor, epsilon: float) -> torch.Tensor:
    """EdgeConv's eval output, bf16 [..., N, Cout], from the per-point
    products y [..., N, 2·Cout] and the ids [..., N, k]: the plain version
    on a CPU tensor, K10 on a CUDA tensor (which raises on what K10 does not
    take)."""
    if y.device.type == "cpu":
        return edge_max_plain(y, ids, mean, var, scale, bias, epsilon)
    return edge_max_cuda(y, ids, mean, var, scale, bias, epsilon)
