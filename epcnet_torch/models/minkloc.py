"""MinkLoc3Dv2: a sparse voxel convolution network, a model of the port alone
(the JAX package has none).

MinkLoc3Dv2 [J. Komorowski, "Improving Point Cloud Based Place Recognition
with Ranking-based Loss and Large Batch Training", ICPR 2022,
arXiv:2203.00972; the authors' github.com/jac99/MinkLoc3Dv2, its MinkLoc3Dv2
model config, ``models/minkfpn.py`` and ``models/layers/eca_block.py``] runs
MinkLoc3D's MinkFPN [arXiv:2011.04530] with ECA blocks and a GeM head. The
authors build it on MinkowskiEngine; here the voxels, the kernel maps and
the convolutions are the port's own (``ops/sparse.py``, K11).

[B, N, 3] submap -> voxels ``floor(p / 0.01)`` with feature 1 -> conv0 (5³,
1 -> 64) + BN + ReLU -> four levels, each a stride-2 conv (2³) + BN + ReLU
and one ECABasicBlock, at planes 64, 128, 64, 32 and tensor strides 2, 4,
8, 16 -> the top-down path: a 1x1 lateral (32 -> 256) at stride 16; a
transposed conv (2³, stride 2) to stride 8 plus a 1x1 lateral of level 2's
output (64 -> 256); one to stride 4 plus a lateral of level 1's (128 ->
256) -> GeM over each cloud's voxels at stride 4 -> [B, 256] fp32, not
L2-normalised (``normalize_embeddings`` False; retrieval ranks by L2
distance either way).

As MinkowskiEngine's ResNet blocks are built (``ResNetBase._make_layer``),
each level's stride-2 conv keeps its input's width, and a block whose width
differs from its input's takes its residual through a 1x1 conv + BN
(``downsample``): levels 1, 2 and 3 here. Every convolution and BN is
MinkowskiEngine's default: no bias, BN eps 1e-5.

ECABasicBlock: conv 3³ + BN + ReLU + conv 3³ + BN, then ECA, then + the
residual, then ReLU. ECA scales the channels by sigmoid(conv1d(m)), m each
cloud's mean over its voxels and the conv1d a bias-free kernel over the
channels of size t or t + 1, whichever is odd, t = int(|log2 C + 1| / 2)
(3 at 32 and 64 channels, 5 at 128), zero-padded; computed as a product
with its banded [C, C] matrix in fp32, not cuDNN (which would take TF32). GeM: ``(mean over voxels of
clamp(x, 1e-6)^p)^(1/p)``, p a parameter, 3 at the start.

Paths. In eval on bf16 with no gradient wanted, every convolution with more
than one offset takes ``ops.sparse.sparse_conv`` (K11 on the card, its plain
version on the CPU), every BN ``DynamicBatchNorm.forward_act`` (K9 on the
card; a BN with no ReLU after it as K9 with the identity, a LeakyReLU of
slope 1), and the 1x1 convs cuBLAS through ``Dense``. Training, any call
that wants a gradient, and the fp32 and fp64 models take
``sparse_conv_plain`` (gather, ``mm``, ``index_add``) with autograd; BN
there normalises with the batch's statistics over all voxels of the batch
(the coordinates cut to the voxels, ``trim``: the padding below would count
in the statistics).

Shapes. ``ops/sparse.py::SparseCoordinates`` keeps every stride's voxels in
a [B·N] array padded past the voxels, and nothing in the forward waits for
the card but one check of the points' range (``check_input``): every shape
after it (``forward_checked``) is fixed by B and N. Padding rows belong to
a dummy cloud, have no pairs in any map and are cut from the output. A bf16
model says so (``graphable``), and the embed layer
(``train/step.py::model_embed_fn``) replays its eval forward on the card
as a CUDA graph: the host launches one graph where the eager forward
launches some 400 kernels and ops (10 ms of host time a batch of 32 at
N=4096 against 6 ms of the card's).

Configuration (``configs.minkloc3dv2_config``; ``ModelConfig`` gains no
field): ``proxyconv_channels`` holds the planes, ``lift_channels`` the
top-down width (256), ``feature_dim`` = ``output_dim`` = 256. The published
constants are below.

Spans (``profile_region``; a graph's replay has none: the forward called
eagerly opens them): ``minkloc/voxelize`` (the voxels at every stride),
``minkloc/kmap`` (every kernel map of the forward, built there and nowhere
else), ``minkloc/conv0``, ``minkloc/down_{i}`` (level i's stride-2
conv, BN, ReLU), ``minkloc/block_{i}``, ``minkloc/up_{i}`` (transposed conv
and lateral; ``up_0`` also the first lateral), ``minkloc/gem``.

Counters (``counters()``), cumulative: forwards, voxels at each stride and
each kernel map's pairs, all summed on the card by the forward itself, so
a graph's replays add to them and its capture does not; read only when
asked.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from epcnet_torch.configs import ModelConfig
from epcnet_torch.models.layers import Dense, DynamicBatchNorm
from epcnet_torch.models.vlad_head import compute_dtype
from epcnet_torch.ops.sparse import (
    KernelMap,
    SparseCoordinates,
    check_range,
    sparse_conv,
    sparse_conv_plain,
)
from epcnet_torch.utils.profiling import profile_region

# The published constants (MinkLoc3Dv2's model config; MinkowskiEngine's
# defaults for BN)
LAYERS = (1, 1, 1, 1)  # ECABasicBlocks a level
NUM_TOP_DOWN = 2
CONV0_KERNEL_SIZE = 5
QUANTIZATION_STEP = 0.01  # cartesian coordinates
BN_EPSILON = 1e-5
GEM_P = 3.0
GEM_EPS = 1e-6
ECA_GAMMA, ECA_B = 2, 1
# a BN with no activation after it (norm2, the residual's): a LeakyReLU of
# slope 1 is the identity, exactly, so in eval on the card it is K9 alone
IDENTITY = 1.0


def eca_kernel_size(channels: int) -> int:
    """ECA's kernel: t or t + 1, whichever is odd, t = int(|log2 C + b| / gamma)."""
    t = int(abs((math.log2(channels) + ECA_B) / ECA_GAMMA))
    return t if t % 2 else t + 1


def map_names() -> tuple[str, ...]:
    """The forward's kernel maps, in the order they are built: conv0's 5³,
    each level's 2³ down and 3³ block map, the two transposed maps."""
    levels = len(LAYERS)
    return ("conv0", *(f"{part}_{i}" for i in range(levels) for part in ("down", "block")),
            *(f"up_{j}" for j in range(NUM_TOP_DOWN)))


def _fixed(x: torch.Tensor, train: bool, *params: torch.Tensor) -> bool:
    """Eval on bf16 with no gradient wanted: the kernels' path."""
    return (not train and x.dtype == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (x, *params))))


class SparseConv(nn.Module):
    """A sparse convolution over a kernel map: ``offset_weight`` [K, Cin,
    Cout], one matrix an offset in ``ops.sparse.kernel_offsets`` order; no
    bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, dtype):
        super().__init__()
        self.offset_weight = nn.Parameter(
            torch.zeros(kernel_size ** 3, in_channels, out_channels))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, kmap: KernelMap, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        if _fixed(x, train, self.offset_weight):
            return sparse_conv(x, kmap, self.offset_weight)
        return sparse_conv_plain(x, kmap, self.offset_weight)


@functools.lru_cache(maxsize=16)
def _band(channels: int, k: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(tap, inside) [C, C]: the conv1d tap that joins input channel c' to
    output channel c, c' - c + (k - 1) / 2, clamped into the kernel, and
    whether it lies in it."""
    c = torch.arange(channels, device=device)
    tap = c[:, None] - c[None, :] + (k - 1) // 2
    return tap.clamp(0, k - 1), (tap >= 0) & (tap < k)


class ECA(nn.Module):
    """Efficient channel attention over each cloud's voxels. The zero-padded
    conv1d over the channels is one product with its banded [C, C] matrix
    (fp32 without TF32)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(eca_kernel_size(channels)))

    def forward(self, x: torch.Tensor, cloud: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        m = means @ xf  # each cloud's mean, [B + 1, C]
        tap, inside = _band(m.shape[1], self.weight.shape[0], m.device)
        band = torch.where(inside, self.weight.to(m.dtype)[tap], 0.0)
        return (xf * torch.sigmoid(m @ band)[cloud]).to(x.dtype)


class ECABasicBlock(nn.Module):
    """conv 3³ + BN + ReLU + conv 3³ + BN, ECA, + residual (through a 1x1
    conv + BN where the width changes), ReLU."""

    def __init__(self, in_channels: int, channels: int, dtype):
        super().__init__()
        self.conv1 = SparseConv(in_channels, channels, 3, dtype)
        self.norm1 = DynamicBatchNorm(channels, BN_EPSILON)
        self.conv2 = SparseConv(channels, channels, 3, dtype)
        self.norm2 = DynamicBatchNorm(channels, BN_EPSILON)
        self.eca = ECA(channels)
        if in_channels != channels:
            self.downsample = Dense(in_channels, channels, dtype, bias=False)
            self.downsample_bn = DynamicBatchNorm(channels, BN_EPSILON)

    def forward(self, x: torch.Tensor, kmap: KernelMap, cloud: torch.Tensor,
                means: torch.Tensor, train: bool = False, momentum=0.9) -> torch.Tensor:
        out = self.norm1.forward_act(self.conv1(x, kmap, train), train, momentum)
        out = self.norm2.forward_act(self.conv2(out, kmap, train), train, momentum, IDENTITY)
        out = self.eca(out, cloud, means)
        residual = x
        if hasattr(self, "downsample"):
            residual = self.downsample_bn.forward_act(self.downsample(x), train, momentum,
                                                      IDENTITY)
        return torch.relu(out + residual)


class GeM(nn.Module):
    """Generalised-mean pooling over each cloud's voxels, fp32."""

    def __init__(self):
        super().__init__()
        self.p = nn.Parameter(torch.full((1,), GEM_P))

    def forward(self, x: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        p = self.p.to(xf.dtype)
        return (means @ xf.clamp(min=GEM_EPS).pow(p)).pow(1.0 / p)


class MinkLoc3Dv2(nn.Module):
    """Submap [B, N, 3] -> descriptor [B, output_dim] (fp32, not normalised)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        planes = tuple(cfg.proxyconv_channels)
        width = cfg.lift_channels[-1] if cfg.lift_channels else 0
        if (len(planes) != len(LAYERS) or len(cfg.lift_channels) != 1
                or not width == cfg.feature_dim == cfg.output_dim):
            raise ValueError(f"MinkLoc3Dv2 takes {len(LAYERS)} planes and one top-down width "
                             f"equal to feature_dim and output_dim, got {planes}, "
                             f"{cfg.lift_channels}, {cfg.feature_dim}, {cfg.output_dim}")
        self.cfg = cfg
        dt = compute_dtype(cfg)
        self.conv0 = SparseConv(1, planes[0], CONV0_KERNEL_SIZE, dt)
        self.bn0 = DynamicBatchNorm(planes[0], BN_EPSILON)
        fan = planes[0]
        for i, plane in enumerate(planes):
            self.add_module(f"down_{i}", SparseConv(fan, fan, 2, dt))
            self.add_module(f"down_bn_{i}", DynamicBatchNorm(fan, BN_EPSILON))
            self.add_module(f"block_{i}", ECABasicBlock(fan, plane, dt))
            fan = plane
        # laterals: the last level's output, then levels -2, -3 (top-down)
        for j in range(NUM_TOP_DOWN + 1):
            self.add_module(f"conv1x1_{j}", Dense(planes[-1 - j], width, dt, bias=False))
        for j in range(NUM_TOP_DOWN):
            self.add_module(f"tconv_{j}", SparseConv(width, width, 2, dt))
        self.gem = GeM()
        # the kernels' path: an eval forward the embed layer may replay as a graph
        self.graphable = dt == torch.bfloat16
        self._counts = None  # on the device: forwards, voxels at each stride, odd maps' pairs

    def counters(self) -> dict:
        """Forwards, voxels at each stride and each kernel map's pairs, summed
        over every forward so far (summed on the card; reading them waits
        for it). A stride-2 map and its transpose have one pair a voxel at
        the finer stride."""
        strides = [2 ** i for i in range(len(LAYERS) + 1)]
        odd = [n for n in map_names() if n == "conv0" or n.startswith("block")]
        forwards, *summed = (self._counts.tolist() if self._counts is not None
                             else [0] * (1 + len(strides) + len(odd)))
        voxels = dict(zip(strides, summed))
        pairs = dict(zip(odd, summed[len(strides):]))
        for i in range(len(LAYERS)):
            pairs[f"down_{i}"] = voxels[2 ** i]
        for j in range(NUM_TOP_DOWN):
            pairs[f"up_{j}"] = voxels[strides[-1] // 2 ** (j + 1)]
        return {"forwards": forwards, "voxels": voxels,
                "pairs": {n: pairs[n] for n in map_names()}}

    def build_maps(self, coords: SparseCoordinates) -> dict[str, KernelMap]:
        """Every kernel map of a forward, by ``map_names``."""
        top = 2 ** len(LAYERS)
        maps = {"conv0": coords.odd_map(CONV0_KERNEL_SIZE, 1)}
        for i in range(len(LAYERS)):
            maps[f"down_{i}"] = coords.down_map(2 ** i)
            maps[f"block_{i}"] = coords.odd_map(3, 2 ** (i + 1))
        for j in range(NUM_TOP_DOWN):
            maps[f"up_{j}"] = coords.up_map(top // 2 ** (j + 1))
        return maps

    def _count(self, coords: SparseCoordinates, maps: dict[str, KernelMap]) -> None:
        one = torch.ones((), dtype=coords.rows[1].dtype, device=coords.rows[1].device)
        counts = torch.stack([one, *coords.rows.values(),
                              *(maps[n].nbr.ge(0).sum() for n in map_names()
                                if n == "conv0" or n.startswith("block"))])
        if self._counts is None:
            with torch.inference_mode(False):  # a normal tensor: any later mode adds to it
                self._counts = torch.zeros_like(counts)
        self._counts.add_(counts)  # in place: a graph's replays add too

    def check_input(self, points: torch.Tensor) -> None:
        """Raise where a voxel coordinate lies out of the keys' range: the
        forward's one wait for the card."""
        check_range(points, QUANTIZATION_STEP)

    def forward(self, points: torch.Tensor, train: bool = False,
                momentum=0.9) -> torch.Tensor:
        """The descriptors of ``points`` [B, N, 3]."""
        self.check_input(points)
        return self.forward_checked(points, train, momentum)

    def forward_checked(self, points: torch.Tensor, train: bool = False,
                        momentum=0.9) -> torch.Tensor:
        """``forward`` after ``check_input``: in eval no shape depends on
        the data and nothing waits for the card."""
        levels, top = len(LAYERS), 2 ** len(LAYERS)
        b = points.shape[0]
        with torch.no_grad():
            with profile_region("minkloc/voxelize"):
                coords = SparseCoordinates(points, QUANTIZATION_STEP, top, trim=train)
            with profile_region("minkloc/kmap"):
                maps = self.build_maps(coords)
                self._count(coords, maps)
        dt = compute_dtype(self.cfg)
        wide = torch.promote_types(dt, torch.float32)  # ECA's and GeM's means
        with profile_region("minkloc/conv0"):
            f = torch.ones((coords.keys[1].shape[0], 1), dtype=dt, device=points.device)
            f = self.bn0.forward_act(self.conv0(f, maps["conv0"], train), train, momentum)
        lateral = []
        for i in range(levels):
            s = 2 ** (i + 1)
            with profile_region(f"minkloc/down_{i}"):
                f = getattr(self, f"down_{i}")(f, maps[f"down_{i}"], train)
                f = getattr(self, f"down_bn_{i}").forward_act(f, train, momentum)
            with profile_region(f"minkloc/block_{i}"):
                f = getattr(self, f"block_{i}")(f, maps[f"block_{i}"], coords.cloud[s],
                                                coords.means(s, wide), train, momentum)
            if levels - 1 - NUM_TOP_DOWN <= i < levels - 1:
                lateral.append(f)
        for j in range(NUM_TOP_DOWN):
            with profile_region(f"minkloc/up_{j}"):
                if j == 0:
                    f = self.conv1x1_0(f)
                f = (getattr(self, f"tconv_{j}")(f, maps[f"up_{j}"], train)
                     + getattr(self, f"conv1x1_{j + 1}")(lateral[-1 - j]))
        s = top // 2 ** NUM_TOP_DOWN
        with profile_region("minkloc/gem"):
            return self.gem(f, coords.means(s, wide)[:b])  # the dummy cloud left out
