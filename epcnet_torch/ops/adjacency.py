"""Neighbourhood means through the kNN graph (twin of
``epcnet_tpu/ops/adjacency.py``).

ProxyConv averages each point's K neighbour features ("proxy point"). As in
the JAX package the kNN graph is built once per forward and every layer's
mean reads it in one of three layouts, the model's adjacency routes:

- dense: the [N, N] 0/1 indicator; the mean is one matmul ``A @ F`` scaled
  by 1/K afterwards (``neighbor_mean``);
- packed: the indicator as int32 bit planes [N, N/32] (``pack_indicator``);
  the mean is K4 (``csrc/packed_mean.cu``) on the card
  (``packed_neighbor_mean``);
- gather: the [N, K] id lists; the mean is a gather of [N, K, C] summed in
  fp32 (``gather_neighbor_mean``), which the JAX package computes outside
  any kernel too.

Bit-plane layout: for words w in [0, W) with W = n/32, bit j of word w is
column j*W + w, so plane j is the column slice [j*W, (j+1)*W). Plane 31 is
the int32 sign bit.
"""

from __future__ import annotations

import torch

from epcnet_torch.ops import _build
from epcnet_torch.ops.matmul import matmul_f32acc

_PLANES = 32


def mean_adjacency(idx: torch.Tensor, n: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense row-normalised adjacency [..., N, n] from kNN ids [..., N, K]:
    entry [i, j] is how often j occurs in row i's list, over K (duplicates
    counted with multiplicity), computed in fp32 and cast to ``dtype`` — the
    JAX ``mean_adjacency``. On no model path; it runs on ``idx``'s device."""
    k = idx.shape[-1]
    return (count_adjacency(idx, n, torch.float32) / float(k)).to(dtype)


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


def pack_indicator(indicator: torch.Tensor) -> torch.Tensor:
    """0/1 indicator [..., N, n] -> bit planes [..., N, n/32] int32 (the JAX
    ``pack_indicator``). ``n`` must be divisible by 32; entries > 0.5 pack
    to 1. Built a plane at a time, so the temporaries stay [..., N, n/32]."""
    *lead, n = indicator.shape
    if n % _PLANES:
        raise ValueError(f"columns {n} not divisible by {_PLANES}")
    w = n // _PLANES
    acc = torch.zeros((*lead, w), dtype=torch.int64, device=indicator.device)
    for j in range(_PLANES):
        acc |= (indicator[..., j * w:(j + 1) * w] > 0.5).long() << j
    # plane 31 is the int32 sign bit: wrap [2^31, 2^32) to the negative words
    return torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc).to(torch.int32)


def unpack_indicator(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """Bit planes [..., N, W] int32 -> 0/1 indicator [..., N, 32*W] in
    ``dtype`` (the JAX ``unpack_indicator``), a plane at a time."""
    w = packed.shape[-1]
    out = torch.empty((*packed.shape[:-1], _PLANES * w), dtype=dtype,
                      device=packed.device)
    for j in range(_PLANES):
        out[..., j * w:(j + 1) * w] = (packed >> j) & 1
    return out


def packed_neighbor_mean_plain(features: torch.Tensor, packed: torch.Tensor,
                               k: int, dtype=torch.bfloat16) -> torch.Tensor:
    """K4's plain version: unpack the planes to a 0/1 mask in ``dtype``,
    then ``neighbor_mean`` with the 1/k scale (the JAX ``impl="jnp"``
    route)."""
    return neighbor_mean(features, unpack_indicator(packed, dtype),
                         compute_dtype=dtype, adjacency_scale=1.0 / k)


def packed_neighbor_mean_cuda(features: torch.Tensor, packed: torch.Tensor,
                              k: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Launch K4 on ``torch.cuda.current_stream()``. packed [B, Nr, W] int32
    and features [B, 32 W, C] on the card; the output [B, Nr, C] is in the
    features' dtype. Each launch adds one to
    ``packed_neighbor_mean_cuda.launches``."""
    if packed.device.type != "cuda" or features.device != packed.device:
        raise ValueError(f"K4 takes CUDA tensors on one card, got {packed.device} "
                         f"and {features.device}")
    if packed.dtype != torch.int32 or packed.dim() != 3 or features.dim() != 3:
        raise ValueError(f"K4 takes int32 planes [B, Nr, W] and features [B, N, C], "
                         f"got {packed.dtype} {tuple(packed.shape)}, {tuple(features.shape)}")
    for dt in (dtype, features.dtype):
        if dt not in (torch.bfloat16, torch.float32):
            raise ValueError(f"K4 computes in bf16 or fp32, got {dt}")
    b, nrows, w = packed.shape
    if features.shape[:2] != (b, _PLANES * w):
        raise ValueError(f"features {tuple(features.shape)} do not match planes "
                         f"{tuple(packed.shape)} ({_PLANES}*{w} columns)")
    c = features.shape[-1]
    f = features.to(dtype).contiguous()
    packed = packed.contiguous()
    out = torch.empty((b, nrows, c), dtype=features.dtype, device=packed.device)
    with torch.cuda.device(packed.device):
        _build.launch("packed_mean", "packed_mean_launch", "pppiiiiiifp",
                      packed.data_ptr(), f.data_ptr(), out.data_ptr(), b, nrows, w,
                      c, int(dtype == torch.bfloat16),
                      int(features.dtype == torch.bfloat16), 1.0 / k,
                      torch.cuda.current_stream().cuda_stream)
    packed_neighbor_mean_cuda.launches += 1
    return out


packed_neighbor_mean_cuda.launches = 0


def packed_neighbor_mean(features: torch.Tensor, packed: torch.Tensor, k: int,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """Neighbour mean through the bit-packed adjacency (the JAX
    ``packed_neighbor_mean``).

    Args:
      features: [..., N, C] with N = 32 * packed.shape[-1].
      packed: [..., N_rows, W] int32 bit planes.
      k: the mean's 1/k scale. dtype: compute dtype (bf16 or fp32).

    Returns [..., N_rows, C] in features.dtype: K4 on a CUDA tensor, the
    plain unpack-then-``neighbor_mean`` on a CPU tensor.
    """
    *lead, nrows, w = packed.shape
    ncols, c = features.shape[-2], features.shape[-1]
    if ncols != _PLANES * w:
        raise ValueError(f"features rows {ncols} != {_PLANES}*{w} packed columns")
    if packed.device.type == "cpu":
        return packed_neighbor_mean_plain(features, packed, k, dtype)
    out = packed_neighbor_mean_cuda(features.reshape(-1, ncols, c),
                                    packed.reshape(-1, nrows, w), k, dtype)
    return out.reshape(*lead, nrows, c)


def gather_neighbor_mean(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour mean straight from the [..., N, K] id lists (the JAX
    ``gather_neighbor_mean``): a gather of [..., N, K, C], summed in fp32,
    times 1/K, cast back to the features' dtype."""
    *lead, n, c = features.shape
    k = idx.shape[-1]
    f = features.reshape(-1, n, c)
    flat = idx.reshape(f.shape[0], -1, 1).long()  # torch.gather takes int64
    nbr = torch.gather(f, 1, flat.expand(-1, -1, c)).reshape(*lead, idx.shape[-2], k, c)
    wide = torch.promote_types(features.dtype, torch.float32)  # fp32 (fp64 stays)
    return (nbr.to(wide).sum(-2) * (1.0 / k)).to(features.dtype)
