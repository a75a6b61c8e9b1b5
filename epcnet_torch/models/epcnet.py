"""EPC-Net and EPC-Net-L (twin of ``epcnet_tpu/models/epcnet.py``).

[B, N, 3] submap -> kNN graph (computed ONCE on xyz) -> ProxyConv stack ->
multi-scale concat -> per-point lift -> G-VLAD -> [B, output_dim]
L2-normalised fp32 descriptor.

The kNN graph takes one of three routes, chosen as the JAX model chooses
(``adjacency_route``; ``adjacency_format`` keeps the JAX meaning):

- dense (``auto`` up to N=16384): K1 gives the int8 indicator and the
  layer-0 proxy; in evaluation on the card layers 1.. take K7
  (``indicator_neighbor_mean``), which reads the int8 indicator; in
  training, and on the CPU, the indicator is cast to the compute dtype once
  and layers 1.. take ``A @ F`` (``neighbor_mean``; on the card the matrix
  units, whose product has the backward ``Aᵀ g``);
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
from epcnet_torch.ops.adjacency import gather_neighbor_mean, packed_neighbor_mean
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
    """Submap [B, N, 3] -> descriptor [B, output_dim] (L2-normalised fp32)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        in_ch = 3
        for i, ch in enumerate(cfg.proxyconv_channels):
            self.add_module(f"proxyconv_{i}", ProxyConv(in_ch, ch, cfg.knn_k, dtype))
            in_ch = ch
        self.lift = SharedMLP(sum(cfg.proxyconv_channels), cfg.lift_channels, dtype)
        self.gvlad = GVLADHead(cfg)

    def forward(self, points: torch.Tensor, train: bool = False,
                momentum=0.9) -> torch.Tensor:
        x = points.float()
        route = adjacency_route(self.cfg, x.shape[-2], train)
        with profile_region("epcnet/knn_graph"), torch.no_grad():
            graph, proxy0 = self.build_graph(x, route)
        return self.forward_graph(x, graph, proxy0, route, train, momentum)

    def build_graph(self, x: torch.Tensor, route: str):
        """The kNN graph of ``route`` and the layer-0 proxy: (int8 indicator
        [B, N, N], proxy0) for dense, (int32 bit planes [B, N, N/32], proxy0)
        for packed, (int32 ids [B, N, k], None) for gather."""
        k = self.cfg.knn_k
        if route == "gather":
            return knn(x, k), None
        return knn_adjacency(x, k, compute_dtype(self.cfg), with_proxy=True, fmt=route)

    def forward_graph(self, x: torch.Tensor, graph: torch.Tensor,
                      proxy0: torch.Tensor | None = None,
                      route: str = "dense", train: bool = False,
                      momentum=0.9) -> torch.Tensor:
        """The network after the kNN graph, as ``build_graph`` gives it for
        ``route``. Split from ``forward`` so a caller can feed a graph from
        another source (the plain twins on the card, to hold the kernel path
        against them). On the dense route layers 1.. take the mean from an
        int8 indicator on the card with ``train`` False through K7, and from
        the indicator cast to the compute dtype otherwise (training, the CPU,
        or a caller's graph already in that dtype). Its parts are named spans
        (``profile_region``): ``epcnet/indicator_cast`` (the cast, where it
        runs), ``epcnet/proxyconv_{i}`` (each holding
        ``epcnet/neighbor_mean`` on the dense route's layers 1..),
        ``epcnet/neighbor_mean`` before each layer on the gather route,
        ``epcnet/lift``, ``epcnet/gvlad``."""
        if route not in ("dense", "packed", "gather"):
            raise ValueError(f"route must be dense|packed|gather, got {route!r}")
        dtype = compute_dtype(self.cfg)
        f = x.float().to(dtype)
        a = None
        scales = []
        for i in range(len(self.cfg.proxyconv_channels)):
            proxy = None
            if route == "gather":
                with profile_region("epcnet/neighbor_mean"):
                    proxy = gather_neighbor_mean(f, graph)
            elif i == 0:
                proxy = proxy0
            elif route == "packed":
                proxy = packed_neighbor_mean(f, graph, self.cfg.knn_k, dtype)
            elif a is None and not train and graph.is_cuda:
                a = graph  # K7 reads the int8 indicator in each of layers 1..
            elif a is None:
                with profile_region("epcnet/indicator_cast"):
                    a = graph.to(dtype)  # once per forward, shared by layers 1..
            with profile_region(f"epcnet/proxyconv_{i}"):
                f = getattr(self, f"proxyconv_{i}")(f, a, proxy=proxy, train=train,
                                                    momentum=momentum)
            scales.append(f)
        with profile_region("epcnet/lift"):
            f_lift = self.lift(torch.cat(scales, dim=-1), train, momentum)  # [B, N, feature_dim]
        with profile_region("epcnet/gvlad"):
            return self.gvlad(f_lift, train=train, momentum=momentum)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
