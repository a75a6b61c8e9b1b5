"""EPC-Net and EPC-Net-L (twin of ``epcnet_tpu/models/epcnet.py``).

[B, N, 3] submap -> kNN graph (computed ONCE on xyz) -> ProxyConv stack ->
multi-scale concat -> per-point lift -> G-VLAD -> [B, output_dim]
L2-normalised fp32 descriptor.

The kNN graph takes one of three routes, chosen as the JAX model chooses
(``adjacency_route``; ``adjacency_format`` keeps the JAX meaning), and
each layer takes its proxy from it (``ops/adjacency.py::NeighborGraph``):

- dense (``auto`` up to N=16384): K1 gives the int8 indicator and the
  layer-0 proxy; layers 1.. read the indicator (K7 on the card) in
  evaluation, and its cast to the compute dtype through ``A @ F`` in
  training;
- packed (``auto`` past N=16384 where the bit-plane layout accepts N): K3
  gives the indicator as bit planes and the layer-0 proxy; layers 1.. take
  K4 (``packed_neighbor_mean``);
- gather (``auto`` past N=32768): K2 gives the id lists; every layer,
  layer 0 included, takes ``gather_neighbor_mean``.

Training (``train=True``) never takes the packed route (K4 has no
backward) nor K7 (none either) and takes gather from N=32768 on, as the
JAX model does; the
graph is structure, built with no gradient, and every product of the
backward pass is a library one (``ops/matmul.py``; the gather's backward
is a scatter-add, whose fp32 sums the card adds in no fixed order).

``use_pallas`` has no effect here: a CPU tensor takes the plain twins, a
CUDA tensor the kernels.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from epcnet_torch.configs import ModelConfig
from epcnet_torch.models.layers import ProxyConv, SharedMLP
from epcnet_torch.models.vlad_head import GVLADHead, compute_dtype
from epcnet_torch.ops.adjacency import NeighborGraph
from epcnet_torch.ops.knn import knn, knn_adjacency
from epcnet_torch.utils.profiling import profile_region

# The JAX model's "auto" cutovers (models/epcnet.py there): packed past this
# N when the bit-plane layout accepts N, gather past _GATHER_AUTO_N. Kept so
# that this port runs dense exactly where the JAX model does.
_PACKED_AUTO_N = 16384
_GATHER_AUTO_N = 32768


def _packed_layout_supported(n: int, proxy_dtype: str, tile_q: int = 256) -> bool:
    """The JAX ``packed_layout_supported`` (ops/knn.py there): True iff the
    bit-plane layout accepts N, from the same tile/unit resolution."""
    bpe = 9 + (4 if proxy_dtype == "float32" else 2)
    pow2 = 1 << max(3, n.bit_length() - 1)
    if pow2 > n:
        pow2 //= 2
    tile = min(tile_q, max(8, pow2))
    npad128 = -(-n // 128) * 128
    while tile > 8 and tile * npad128 * bpe > 10 * 2**20:
        tile //= 2
    tile = max(8, tile)
    unit = tile * 128 // math.gcd(tile, 128)
    return n % unit == 0


def adjacency_route(cfg: ModelConfig, n: int, train: bool = False) -> str:
    """The route the JAX model takes for N points: dense, packed or gather.
    In training ``auto`` takes gather AT N=32768 (the dense [32k, 32k]
    indicator is the JAX package's measured compile failure) and nothing,
    ``adjacency_format="packed"`` included, takes the packed route."""
    fmt = cfg.adjacency_format
    if fmt == "gather" or (fmt == "auto" and (
            n > _GATHER_AUTO_N or (train and n >= _GATHER_AUTO_N))):
        return "gather"
    if train:
        return "dense"
    if fmt == "packed" or (
        fmt == "auto" and n > _PACKED_AUTO_N
        and _packed_layout_supported(n, cfg.compute_dtype)
    ):
        return "packed"
    return "dense"


class EPCNet(nn.Module):
    """Submap [B, N, 3] -> descriptor [B, output_dim] (L2-normalised fp32).

    ``group``: a process group the point axis is sharded over (the
    points-sharded EPC-Net, ``models/points_sharded.py``); every BN and the
    VLAD head complete their sums over it."""

    def __init__(self, cfg: ModelConfig, group=None):
        super().__init__()
        self.cfg, self.group = cfg, group
        dtype = compute_dtype(cfg)
        in_ch = 3
        for i, ch in enumerate(cfg.proxyconv_channels):
            self.add_module(f"proxyconv_{i}", ProxyConv(in_ch, ch, dtype, bn_group=group))
            in_ch = ch
        self.lift = SharedMLP(sum(cfg.proxyconv_channels), cfg.lift_channels, dtype,
                              bn_group=group)
        self.gvlad = GVLADHead(cfg, group=group)

    def forward(self, points: torch.Tensor, train: bool = False,
                momentum=0.9) -> torch.Tensor:
        x = points.float()
        route = adjacency_route(self.cfg, x.shape[-2], train)
        with profile_region("epcnet/knn_graph"), torch.no_grad():
            graph = self.build_graph(x, route)
        return self.forward_graph(x, graph, train, momentum)

    def build_graph(self, x: torch.Tensor, route: str) -> NeighborGraph:
        """The kNN graph of ``route``: the int8 indicator [B, N, N] and the
        layer-0 proxy (K1) for dense, the int32 bit planes [B, N, N/32] and
        the proxy (K3) for packed, the int32 ids [B, N, k] (K2) for gather."""
        k, dtype = self.cfg.knn_k, compute_dtype(self.cfg)
        if route == "gather":
            return NeighborGraph(route, knn(x, k), k, dtype)
        adj, proxy0 = knn_adjacency(x, k, dtype, with_proxy=True, fmt=route)
        return NeighborGraph(route, adj, k, dtype, proxy0)

    def forward_graph(self, x: torch.Tensor, graph: NeighborGraph, train: bool = False,
                      momentum=0.9, mask: torch.Tensor | None = None) -> torch.Tensor:
        """The network after the kNN graph, which a caller may build elsewhere
        (the card tests' plain twins; the points-sharded ring kNN); ``mask``
        [B, N] (1 real, 0 pad) goes to the VLAD head. Spans: ``epcnet/
        proxyconv_{i}`` (each holding the graph's ``epcnet/neighbor_mean``
        and ``epcnet/indicator_cast`` where they run), ``epcnet/lift``,
        ``epcnet/gvlad``."""
        f = x.float().to(compute_dtype(self.cfg))
        scales = []
        for i in range(len(self.cfg.proxyconv_channels)):
            with profile_region(f"epcnet/proxyconv_{i}"):
                proxy = graph.proxy(i, f, train)
                f = getattr(self, f"proxyconv_{i}")(f, proxy, train, momentum)
            scales.append(f)
        with profile_region("epcnet/lift"):
            f_lift = self.lift(torch.cat(scales, dim=-1), train, momentum)  # [B, N, feature_dim]
        with profile_region("epcnet/gvlad"):
            return self.gvlad(f_lift, mask=mask, train=train, momentum=momentum)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
