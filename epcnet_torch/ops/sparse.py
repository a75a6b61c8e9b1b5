"""Sparse voxel tensors for MinkLoc3Dv2 (``models/minkloc.py``): voxel
coordinates at tensor strides 1-16, the kernel maps between them, built once
a forward and shared by the convolutions that use them (MinkowskiEngine's
coordinate manager), and the convolution over a map (K11,
``csrc/sparse_conv.cu``).

Voxels. A point p of cloud b lies in voxel ``c = floor(p / step)`` (fp32,
a true division; floor, not truncation, below 0); a cloud holds one voxel
for each distinct c. At tensor stride s (a power of two) coordinates are
multiples of s; the voxels at stride 2s are ``floor(c / 2s) · 2s`` of those
at stride s. A voxel is a key, one int64: the cloud in bits 48-62, and x, y
and z, each plus ``BIAS``, in 16 bits each below, so that sorting the keys
sorts (cloud, x, y, z) and the key of ``c + o`` is the key of c plus o's
key offset (no field borrows from the next while every coordinate, offsets
included, stays within ``COORD_LIMIT`` + 128 of 0: ±326 m at a step of
0.01). ``BIAS`` is a multiple of every stride and each field is >= 0, so
``floor(c / 2s) · 2s`` clears a field's low bits (``coarse_mask``), and a
voxel's offset under its parent at 2s is bit log2(s) of each field.

Fixed shapes. Every stride's voxels sit at the front of a [B·N] array of
sorted keys, ``SENTINEL`` after them; their count stays on the card. The
distinct keys come from a sort, a head mask and a cumulative sum
(``unique_rows``), not ``torch.unique``, whose output size makes the host
wait for the card; so no shape depends on the data, and a forward over
these arrays can be captured as a CUDA graph. Padding rows belong to a
dummy cloud B and have no pairs in any map.

Kernel maps, one table a map: ``nbr`` [B·N, K] int32, the input row of
output row u at offset o, or -1 where that input voxel does not exist.

- odd kernels (5³ at stride 1, 3³ at any stride): centred offsets o·s,
  o in {-r..r}³ ordered x slowest, z fastest; the output rows are the input
  voxels themselves (``odd_map``);
- the stride-2 kernel 2³ from stride s to 2s: offsets {0, 1}³ · s in the
  same order; output u = floor(c / 2s) · 2s takes input c at offset
  (c - u) / s, so every input voxel has exactly one output (``down_map``);
- its transpose from 2s back to the voxels at stride s: each output c takes
  its one parent u at the same offset (``up_map``).

The convolution over a map: ``out[u] = Σ_o W_o · in[nbr[u, o]]`` over the
offsets where ``nbr >= 0``, W [K, Cin, Cout], no bias.
``sparse_conv_plain`` gathers, multiplies and ``index_add``s an offset at a
time (operands in the input's dtype, bf16 products summed in fp32, the
result rounded once); it is differentiable and is what training runs.
``sparse_conv_cuda`` launches K11 (bf16 in, fp32 sums, bf16 out);
``sparse_conv`` takes the plain version on a CPU tensor and K11 on a CUDA
tensor, with no fallback between them.
"""

from __future__ import annotations

import functools

import torch

from epcnet_torch.ops import _build
from epcnet_torch.ops.matmul import matmul_f32acc

BIAS = 1 << 15
COORD_LIMIT = BIAS - 128
_CLOUD_SHIFT = 48
# the key of padding rows: past every voxel's (clouds below 0x7FF0), and
# far enough below 2^63 that a key offset added to it does not overflow
SENTINEL = 0x7FF0 << _CLOUD_SHIFT
K11_MAX_OFFSETS = 32  # offsets of a map K11's tiled kernel takes (3³ and 2³)
# (Cin, Cout) pairs K11's tiled kernel is compiled for: MinkLoc3Dv2's
K11_SHAPES = ((32, 32), (64, 32), (64, 64), (64, 128), (128, 64), (128, 128), (256, 256))
K11_C1_WIDTHS = (64,)  # Cout of the one-input-channel kernel (conv0)


_FIELD_SCALE = (1 << 32, 1 << 16, 1)


@functools.lru_cache(maxsize=8)
def _field_scale(device: torch.device) -> torch.Tensor:
    return torch.tensor(_FIELD_SCALE, device=device)


def encode(cloud: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Keys of voxels: cloud [M] and coords [M, 3] (int64) -> int64 [M]."""
    return ((coords + BIAS) * _field_scale(coords.device)).sum(-1) + (cloud << _CLOUD_SHIFT)


def coarse_mask(stride: int) -> int:
    """The key mask that takes a voxel at ``stride`` to its parent at
    2·stride: each field's low log2(2·stride) bits cleared."""
    low = 2 * stride - 1
    return ~(low * sum(_FIELD_SCALE))


def parent_slot(keys: torch.Tensor, stride: int) -> torch.Tensor:
    """Each voxel's offset under its parent at 2·stride, in {0, 1}³ ordered
    x slowest: bit log2(stride) of each field."""
    t = stride.bit_length() - 1
    return ((keys >> (30 + t)) & 4) | ((keys >> (15 + t)) & 2) | ((keys >> t) & 1)


def decode(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Keys -> (cloud [M], coords [M, 3]) int64."""
    mask = (1 << 16) - 1
    coords = torch.stack([(keys >> 32) & mask, (keys >> 16) & mask, keys & mask], 1) - BIAS
    return keys >> _CLOUD_SHIFT, coords


def kernel_offsets(size: int) -> torch.Tensor:
    """[size³, 3] int64 offsets in units of the input's stride, x slowest:
    centred for an odd size, {0, 1}³ for size 2."""
    if size == 2:
        r = torch.arange(2)
    elif size % 2:
        r = torch.arange(size) - size // 2
    else:
        raise ValueError(f"kernel size {size}: odd, or 2")
    return torch.cartesian_prod(r, r, r)


@functools.lru_cache(maxsize=64)
def offset_keys(size: int, stride: int, device: torch.device) -> torch.Tensor:
    """[size³] int64: each offset's key offset at ``stride``, made once on
    each device (a copy to the card each forward would cost a wait)."""
    o = kernel_offsets(size).to(device) * stride
    return (o[:, 0] << 32) + (o[:, 1] << 16) + o[:, 2]


class KernelMap:
    """A map's table ``nbr`` [rows_out, K] int32 (-1: no input) between
    ``rows_in`` input and ``rows_out`` output rows."""

    def __init__(self, nbr: torch.Tensor, rows_in: int):
        self.nbr, self.rows_in = nbr, rows_in
        self._lists = None

    @property
    def rows_out(self) -> int:
        return self.nbr.shape[0]

    @property
    def offsets(self) -> int:
        return self.nbr.shape[1]

    def pair_lists(self) -> list[tuple[int, torch.Tensor, torch.Tensor]]:
        """(offset, output rows, input rows) of each offset that has pairs,
        int64, built once (one wait for the card)."""
        if self._lists is None:
            t = self.nbr.t()
            o, rows = (t >= 0).nonzero(as_tuple=True)
            src = t[o, rows].long()
            counts = torch.bincount(o, minlength=self.offsets).tolist()
            self._lists = [(i, r, s) for i, (r, s) in
                           enumerate(zip(rows.split(counts), src.split(counts))) if len(r)]
        return self._lists


def unique_rows(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The distinct keys of ``keys`` [P] at the front of a [P] array, sorted,
    ``SENTINEL`` after them; their count (a 0-dim tensor on the device: no
    wait for the card); and each input key's row among them. Input rows that
    hold ``SENTINEL`` land on a row at or past the count."""
    ordered, order = torch.sort(keys)
    head = torch.ones_like(ordered, dtype=torch.bool)
    head[1:] = ordered[1:] != ordered[:-1]
    rank = torch.cumsum(head, 0) - 1
    out = torch.full_like(ordered, SENTINEL)
    out[rank] = ordered
    inverse = torch.empty_like(rank)
    inverse[order] = rank
    return out, (head & (ordered != SENTINEL)).sum(), inverse


def odd_map(keys: torch.Tensor, rows: torch.Tensor, size: int, stride: int) -> KernelMap:
    """The map of a size³ kernel (size odd) over the voxel keys at
    ``stride`` (sorted, ``rows`` of them before the padding): output rows are
    the voxels, input voxel ``c + o·stride``; padding rows have no pairs."""
    p = keys.shape[0]
    q = keys[:, None] + offset_keys(size, stride, keys.device)[None, :]
    pos = torch.searchsorted(keys, q).clamp_(max=p - 1)
    live = (keys[pos] == q) & (torch.arange(p, device=keys.device) < rows)[:, None]
    return KernelMap(torch.where(live, pos, -1).to(torch.int32), p)


def down_map(parent: torch.Tensor, slot: torch.Tensor, live: torch.Tensor,
             rows_out: int) -> KernelMap:
    """The stride-2 kernel 2³ from the voxels at stride s (each with its
    parent row at 2s and its offset slot; ``live`` the rows before the
    padding) to the ``rows_out`` rows at 2s."""
    p = parent.shape[0]
    nbr = torch.full((rows_out + 1, 8), -1, dtype=torch.int32, device=parent.device)
    # padding rows write to an extra last row, then cut off
    nbr[torch.where(live, parent, rows_out), slot] = torch.arange(p, dtype=torch.int32,
                                                                 device=parent.device)
    return KernelMap(nbr[:rows_out], p)


def up_map(parent: torch.Tensor, slot: torch.Tensor, live: torch.Tensor,
           rows_in: int) -> KernelMap:
    """The transpose of ``down_map``: from the ``rows_in`` rows at 2s back
    to the voxels at s, each taking its parent at its offset slot."""
    p = parent.shape[0]
    nbr = torch.full((p, 8), -1, dtype=torch.int32, device=parent.device)
    nbr[torch.arange(p, device=parent.device), slot] = torch.where(live, parent, -1).to(
        torch.int32)
    return KernelMap(nbr, rows_in)


def check_range(points: torch.Tensor, step: float) -> None:
    """Raise where a point's voxel coordinate lies beyond ``COORD_LIMIT`` (or
    is not finite): one wait for the card."""
    bound = (COORD_LIMIT + 1) * step
    if not bool((points.abs() < bound).all()):
        raise ValueError(f"voxel coordinates beyond ±{COORD_LIMIT} at step {step} "
                         "(or not finite)")


class SparseCoordinates:
    """The voxels of B clouds of N points at strides 1, 2, 4, ... ``top``,
    each in a fixed [B·N] array of sorted keys padded with ``SENTINEL``, and
    for each voxel at s < top its parent row at 2s and its offset slot
    there. Nothing waits for the card and every shape is fixed by B and N,
    so a forward built on it can be replayed as a CUDA graph; padding rows
    belong to a dummy cloud B and have no pairs in any map.

    ``keys[s]``: the keys; ``rows[s]``: the voxels before the padding (a
    0-dim tensor on the device); ``live[s]``: row < rows[s]; ``cloud[s]``:
    each row's cloud (B for padding); ``counts[s]``: rows a cloud [B + 1]
    (fp32; the dummy cloud's at least 1); ``means(s)``: the [B + 1, rows]
    matrix whose product with rows gives each cloud's mean. ``trim``: cut the
    padding (one wait for the card), where statistics over the rows must
    not see it."""

    def __init__(self, points: torch.Tensor, step: float, top: int, trim: bool = False):
        b, n, _ = points.shape
        if b >= SENTINEL >> _CLOUD_SHIFT:
            raise ValueError(f"{b} clouds: at most {(SENTINEL >> _CLOUD_SHIFT) - 1}")
        dev = points.device
        # a 0-dim tensor on the points' device: a true division on the card
        # too (a Python scalar there takes a * (1 / step), which rounds apart)
        q = torch.floor(points.float() / torch.full((), step, dtype=torch.float32, device=dev))
        cloud = torch.arange(b, device=dev).repeat_interleave(n)
        keys, rows, _ = unique_rows(encode(cloud, q.reshape(-1, 3).long()))
        self.batch = b
        self.keys, self.rows, self.parent, self.slot = {1: keys}, {1: rows}, {}, {}
        s = 1
        while s < top:
            self.slot[s] = parent_slot(self.keys[s], s)
            self.keys[2 * s], self.rows[2 * s], self.parent[s] = unique_rows(
                self.keys[s] & coarse_mask(s))
            s *= 2
        if trim:
            cut = {s: int(m) for s, m in self.rows.items()}
            self.keys = {s: k[:cut[s]] for s, k in self.keys.items()}
            self.parent = {s: v[:cut[s]] for s, v in self.parent.items()}
            self.slot = {s: v[:cut[s]] for s, v in self.slot.items()}
        index = torch.arange(b * n, device=dev)
        self.live = {s: index[:k.shape[0]] < self.rows[s] for s, k in self.keys.items()}
        self.cloud = {s: (k >> _CLOUD_SHIFT).clamp_(max=b) for s, k in self.keys.items()}
        # the keys sort by cloud: each cloud's voxels are one run of rows
        bounds = torch.arange(b + 2, device=dev)
        self.counts = {s: torch.diff(torch.searchsorted(c, bounds)).float().clamp_(min=1)
                       for s, c in self.cloud.items()}
        self._means: dict = {}

    def means(self, stride: int, dtype=torch.float32) -> torch.Tensor:
        """[B + 1, rows] in ``dtype``: 1 / (the cloud's rows) where a row
        belongs to the cloud, else 0, so that ``means(s) @ x`` is each
        cloud's mean of rows x (fp32 or fp64, no TF32). A product, where
        ``index_add`` would take atomics that every row of a cloud (and every
        padding row) contends for."""
        if (stride, dtype) not in self._means:
            cloud = self.cloud[stride]
            ids = torch.arange(self.batch + 1, device=cloud.device)
            self._means[stride, dtype] = ((cloud[None, :] == ids[:, None]).to(dtype)
                                          / self.counts[stride][:, None].to(dtype))
        return self._means[stride, dtype]

    def odd_map(self, size: int, stride: int) -> KernelMap:
        return odd_map(self.keys[stride], self.rows[stride], size, stride)

    def down_map(self, stride: int) -> KernelMap:
        """From stride s to 2s."""
        return down_map(self.parent[stride], self.slot[stride], self.live[stride],
                        self.keys[2 * stride].shape[0])

    def up_map(self, stride: int) -> KernelMap:
        """From stride 2s back to s."""
        return up_map(self.parent[stride], self.slot[stride], self.live[stride],
                      self.keys[2 * stride].shape[0])


def sparse_conv_plain(x: torch.Tensor, kmap: KernelMap, weight: torch.Tensor) -> torch.Tensor:
    """K11's plain version: x [rows_in, Cin], weight [K, Cin, Cout] (cast to
    x's dtype) -> [rows_out, Cout] in x's dtype. An offset at a time: the
    input rows gathered, multiplied by W_o (bf16 operands summed in fp32;
    fp32 and fp64 in their own type), ``index_add``ed into the fp32 (fp64)
    sum in offset order; the sum rounded once. Differentiable."""
    acc = torch.promote_types(x.dtype, torch.float32)
    w = weight.to(x.dtype)
    out = torch.zeros((kmap.rows_out, w.shape[2]), dtype=acc, device=x.device)
    for o, rows, src in kmap.pair_lists():
        a = x.index_select(0, src)
        prod = matmul_f32acc(a, w[o]) if x.dtype == torch.bfloat16 else a @ w[o]
        out = out.index_add(0, rows, prod.to(acc))
    return out.to(x.dtype)


def sparse_conv_cuda(x: torch.Tensor, kmap: KernelMap, weight: torch.Tensor) -> torch.Tensor:
    """Launch K11 on ``torch.cuda.current_stream()``: x a contiguous bf16
    [rows_in, Cin] on the card, weight [K, Cin, Cout] (cast to bf16 here),
    the map's table on the same card. Cin = 1 (any K, Cout in
    ``K11_C1_WIDTHS``) or (Cin, Cout) in ``K11_SHAPES`` with K <=
    ``K11_MAX_OFFSETS``. Every id in the table is < rows_in (not checked:
    ``SparseCoordinates`` makes them so). Returns bf16 [rows_out, Cout].
    Each launch adds one to ``sparse_conv_cuda.launches``."""
    nbr = kmap.nbr
    if x.device.type != "cuda" or nbr.device != x.device or weight.device != x.device:
        raise ValueError(f"K11 takes CUDA tensors on one card, got {x.device}, {nbr.device} "
                         f"and {weight.device}")
    if x.dtype != torch.bfloat16 or nbr.dtype != torch.int32:
        raise ValueError(f"K11 takes bf16 features and int32 maps, got {x.dtype}, {nbr.dtype}")
    k, cin, cout = weight.shape
    if x.dim() != 2 or x.shape != (kmap.rows_in, cin) or nbr.shape[1] != k:
        raise ValueError(f"K11: features {tuple(x.shape)}, map {tuple(nbr.shape)} over "
                         f"{kmap.rows_in} rows, weight {tuple(weight.shape)} do not fit")
    if cin == 1:
        if cout not in K11_C1_WIDTHS:
            raise ValueError(f"K11 takes Cout in {K11_C1_WIDTHS} at Cin 1, got {cout}")
    elif (cin, cout) not in K11_SHAPES or k > K11_MAX_OFFSETS:
        raise ValueError(f"K11 takes (Cin, Cout) in {K11_SHAPES} and at most "
                         f"{K11_MAX_OFFSETS} offsets, got ({cin}, {cout}) and {k}")
    if not (x.is_contiguous() and nbr.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("K11 takes contiguous features at a 16-byte boundary and a "
                         "contiguous map")
    w = weight.to(torch.bfloat16).contiguous()
    out = torch.empty((kmap.rows_out, cout), dtype=torch.bfloat16, device=x.device)
    if kmap.rows_out >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError("K11 takes fewer than 2^31 rows")
    with torch.cuda.device(x.device):
        _build.launch("sparse_conv", "sparse_conv_launch", "ppppiiiip",
                      x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
                      kmap.rows_out, k, cin, cout, torch.cuda.current_stream().cuda_stream)
    sparse_conv_cuda.launches += 1
    return out


sparse_conv_cuda.launches = 0


def sparse_conv(x: torch.Tensor, kmap: KernelMap, weight: torch.Tensor) -> torch.Tensor:
    """The convolution over ``kmap``: the plain version on a CPU tensor, K11
    on a CUDA tensor (which raises on what K11 does not take). No backward:
    a caller that wants one takes ``sparse_conv_plain``."""
    if x.device.type == "cpu":
        return sparse_conv_plain(x, kmap, weight)
    return sparse_conv_cuda(x, kmap, weight)
