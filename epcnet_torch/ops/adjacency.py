"""Neighbourhood means through the kNN graph (twin of
``epcnet_tpu/ops/adjacency.py``).

ProxyConv averages each point's K neighbour features ("proxy point"). As in
the JAX package the kNN graph is built once per forward and every layer's
mean reads it in one of three layouts, the model's adjacency routes:

- dense: the [N, N] 0/1 indicator; in evaluation the mean reads the int8
  indicator (``indicator_neighbor_mean``: K7, ``csrc/indicator_mean.cu``, on
  the card); in training it is one matmul ``A @ F`` on the indicator cast
  to the compute dtype, scaled by 1/K afterwards (``neighbor_mean``);
- packed: the indicator as int32 bit planes [N, N/32] (``pack_indicator``);
  the mean is K4 (``csrc/packed_mean.cu``) on the card
  (``packed_neighbor_mean``);
- gather: the [N, K] id lists; the mean is a gather of [N, K, C]
  (``gather_neighbors``, which DGCNN-VLAD's edges share) summed in fp32
  (``gather_neighbor_mean``), which the JAX package computes outside any
  kernel too.

Bit-plane layout: for words w in [0, W) with W = n/32, bit j of word w is
column j*W + w, so plane j is the column slice [j*W, (j+1)*W). Plane 31 is
the int32 sign bit.
"""

from __future__ import annotations

import torch

from epcnet_torch.ops import _build
from epcnet_torch.ops.matmul import matmul_f32acc
from epcnet_torch.utils.profiling import profile_region

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


def indicator_neighbor_mean_plain(features: torch.Tensor, indicator: torch.Tensor,
                                  k: int, dtype=torch.bfloat16) -> torch.Tensor:
    """K7's plain version: the indicator cast to ``dtype``, then
    ``neighbor_mean`` with the 1/k scale (the dense route's training
    arithmetic)."""
    return neighbor_mean(features, indicator.to(dtype), compute_dtype=dtype,
                         adjacency_scale=1.0 / k)


def _check_indicator_mean(features: torch.Tensor, indicator: torch.Tensor, dtype) -> None:
    """K7's inputs: no gradient asked for (K7 has no backward), an int8
    indicator [..., Nr, N], features [..., N, C] with the same leading dims,
    and bf16 or fp32 features and compute dtype."""
    if torch.is_grad_enabled() and features.requires_grad:
        raise RuntimeError("indicator_neighbor_mean has no backward; training casts the "
                           "indicator and takes neighbor_mean")
    if indicator.dtype != torch.int8:
        raise ValueError(f"the indicator is int8, got {indicator.dtype}")
    for dt in (dtype, features.dtype):
        if dt not in (torch.bfloat16, torch.float32):
            raise ValueError(f"K7 computes in bf16 or fp32, got {dt}")
    if (features.dim() != indicator.dim() or indicator.dim() < 2
            or features.shape[:-1] != (*indicator.shape[:-2], indicator.shape[-1])):
        raise ValueError(f"features {tuple(features.shape)} do not match the indicator "
                         f"{tuple(indicator.shape)} ({indicator.shape[-1]} columns)")


def indicator_neighbor_mean_cuda(features: torch.Tensor, indicator: torch.Tensor,
                                 k: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Launch K7 on ``torch.cuda.current_stream()``. indicator [B, Nr, N]
    int8 and features [B, N, C] on the card; the output [B, Nr, C] is in the
    features' dtype. Each launch adds one to
    ``indicator_neighbor_mean_cuda.launches``."""
    _check_indicator_mean(features, indicator, dtype)
    if indicator.dim() != 3:
        raise ValueError(f"K7 takes an indicator [B, Nr, N], got {tuple(indicator.shape)}")
    if indicator.device.type != "cuda" or features.device != indicator.device:
        raise ValueError(f"K7 takes CUDA tensors on one card, got {indicator.device} "
                         f"and {features.device}")
    b, nrows, n = indicator.shape
    c = features.shape[-1]
    f = features.to(dtype).contiguous()
    indicator = indicator.contiguous()
    out = torch.empty((b, nrows, c), dtype=features.dtype, device=indicator.device)
    with torch.cuda.device(indicator.device):
        _build.launch("indicator_mean", "indicator_mean_launch", "pppiiiiiifp",
                      indicator.data_ptr(), f.data_ptr(), out.data_ptr(), b, nrows, n, c,
                      int(dtype == torch.bfloat16), int(features.dtype == torch.bfloat16),
                      1.0 / k, torch.cuda.current_stream().cuda_stream)
    indicator_neighbor_mean_cuda.launches += 1
    return out


indicator_neighbor_mean_cuda.launches = 0


def indicator_neighbor_mean(features: torch.Tensor, indicator: torch.Tensor, k: int,
                            dtype=torch.bfloat16) -> torch.Tensor:
    """Neighbour mean straight from the dense int8 indicator, with no
    backward: the dense route's mean in evaluation.

    Args:
      features: [..., N, C] with N = indicator.shape[-1], needing no
        gradient.
      indicator: [..., N_rows, N] int8 (K1's); a byte counts with its value.
      k: the mean's 1/k scale. dtype: compute dtype (bf16 or fp32).

    Returns [..., N_rows, C] in features.dtype: K7 on a CUDA tensor, the
    plain cast-then-``neighbor_mean`` on a CPU tensor.
    """
    _check_indicator_mean(features, indicator, dtype)
    *lead, nrows, n = indicator.shape
    c = features.shape[-1]
    if indicator.device.type == "cpu":
        return indicator_neighbor_mean_plain(features, indicator, k, dtype)
    out = indicator_neighbor_mean_cuda(features.reshape(-1, n, c),
                                       indicator.reshape(-1, nrows, n), k, dtype)
    return out.reshape(*lead, nrows, c)


def gather_neighbors(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each point's neighbours' features: [..., N, C] features and
    [..., Nr, K] ids (int32 or int64) -> [..., Nr, K, C] in the features'
    dtype, row r's K rows in its list's order."""
    *lead, n, c = features.shape
    k = idx.shape[-1]
    f = features.reshape(-1, n, c)
    flat = idx.reshape(f.shape[0], -1, 1).long()  # torch.gather takes int64
    return torch.gather(f, 1, flat.expand(-1, -1, c)).reshape(*lead, idx.shape[-2], k, c)


def gather_neighbor_mean(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour mean straight from the [..., N, K] id lists (the JAX
    ``gather_neighbor_mean``): ``gather_neighbors``, summed in fp32, times
    1/K, cast back to the features' dtype."""
    nbr = gather_neighbors(features, idx)
    wide = torch.promote_types(features.dtype, torch.float32)  # fp32 (fp64 stays)
    return (nbr.to(wide).sum(-2) * (1.0 / idx.shape[-1])).to(features.dtype)


class NeighborGraph:
    """One forward's kNN graph and the one place that maps (layout, layer,
    train) to a layer's neighbour mean. ``data``: for "dense" the [B, N, N]
    indicator (K1's int8, or a caller's in a float dtype), for "packed" the
    int32 bit planes [B, N, N/32], for "gather" the int32 ids [B, N, k];
    ``k`` the mean's 1/k scale; ``proxy0`` layer 0's proxy where K1 or K3
    gave one."""

    def __init__(self, layout: str, data: torch.Tensor, k: int, dtype=torch.bfloat16,
                 proxy0: torch.Tensor | None = None):
        if layout not in ("dense", "packed", "gather"):
            raise ValueError(f"layout must be dense|packed|gather, got {layout!r}")
        self.layout, self.data, self.k, self.dtype, self.proxy0 = (
            layout, data, k, dtype, proxy0)
        self.cast = None  # the int8 indicator in ``dtype``, once a training forward

    def rows(self, features: torch.Tensor) -> torch.Tensor:
        """The feature rows the gather ids index: the features themselves."""
        return features

    def proxy(self, i: int, features: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Layer ``i``'s proxy for ``features`` [B, N, C]: ``proxy0`` for layer
        0 where given, else the layout's mean (span ``epcnet/neighbor_mean``).
        Evaluation reads the dense int8 indicator as it is; training casts it
        once (span ``epcnet/indicator_cast``) for layers 1.., since K7 has no
        backward and the cast's ``A @ F`` has ``Aᵀ g``."""
        if i == 0 and self.proxy0 is not None:
            return self.proxy0
        a = self.data
        if self.layout == "dense" and a.dtype == torch.int8 and train:
            if self.cast is None:
                with profile_region("epcnet/indicator_cast"):
                    self.cast = a.to(self.dtype)
            a = self.cast
        with profile_region("epcnet/neighbor_mean"):
            if self.layout == "gather":
                return gather_neighbor_mean(self.rows(features), a)
            if self.layout == "packed":
                return packed_neighbor_mean(features, a, self.k, self.dtype)
            if a.dtype == torch.int8:
                return indicator_neighbor_mean(features, a, self.k, self.dtype)
            return neighbor_mean(features, a, compute_dtype=self.dtype,
                                 adjacency_scale=1.0 / self.k)
