"""DGCNN-VLAD: the DGCNN backbone under PointNetVLAD's NetVLAD head, a model
of the port alone (the JAX package has no DGCNN).

DGCNN [Wang et al., "Dynamic Graph CNN for Learning on Point Clouds", ACM
TOG 2019, arXiv:1801.07829; the authors' ``pytorch/model.py``, class
``DGCNN``] is the edge convolution that EPC-Net's ProxyConv simplifies; its
head here is PointNetVLAD's [Uy & Lee, CVPR 2018, arXiv:1804.03492], the
port's ``GVLADHead`` with one group (``skip_out_fc``: one C·D -> 256 FC),
context gating and the L2 norm.

[B, N, 3] submap -> four EdgeConv layers, each on a kNN graph built again
over its own input (layer 0 on xyz: K2, ``knn``; layers 1.. on the
previous layer's features as the model holds them: K8, ``knn_features``)
-> the concat of the four outputs -> conv5 (``lift``: Dense without bias,
BN, LeakyReLU) -> NetVLAD (``netvlad``) -> [B, output_dim] L2-normalised
fp32.

EdgeConv i, over the k neighbours j of point i (self included):
  e_ij = [x_j - x_i, x_i];  h_ij = LeakyReLU_0.2(BN(W_i e_ij)), no bias;
  x'_i = max over j of h_ij,
with BN over every edge (B·N·k rows), eps 1e-5, as published. The edges
are materialised, [B, N, k, 2C], and reduced with a max: the published
computation, with no algebraic shortcut (neither the linearity of
``W [x_j - x_i, x_i]`` nor a max taken before the affine BN).

Configuration (``configs.dgcnn_vlad_config``; ``ModelConfig`` gains no
field): ``proxyconv_channels`` holds the EdgeConv widths (64, 64, 128,
256), ``lift_channels`` conv5's (1024,), ``adjacency_format`` is
``"gather"`` (id lists; ``"auto"`` means the same here, and the dense and
packed layouts are refused). BN's epsilon and the LeakyReLU's slope are the
published constants below.

Precision is EPC-Net's: the features and every backbone product in bf16
(fp32 sums), BN computed in fp32, the max exact in any dtype, the VLAD sums
and the head in fp32. K8 takes bf16 features on the card; the fp32 and fp64
variants of the model run on the CPU (K8 raises on another dtype).

Spans (``profile_region``): ``dgcnn/knn_{i}`` (each layer's graph),
``dgcnn/edgeconv_{i}`` (gather, edges, Dense, BN, activation, max),
``dgcnn/lift``, ``dgcnn/vlad``.
"""

from __future__ import annotations

import torch
from torch import nn

from epcnet_torch.configs import ModelConfig
from epcnet_torch.models.layers import Dense, DynamicBatchNorm, SharedMLP
from epcnet_torch.models.vlad_head import GVLADHead, compute_dtype
from epcnet_torch.ops.adjacency import gather_neighbors
from epcnet_torch.ops.knn import knn, knn_features
from epcnet_torch.utils.profiling import profile_region

BN_EPSILON = 1e-5  # nn.BatchNorm2d's default in the authors' model
LEAKY_SLOPE = 0.2


class EdgeConv(nn.Module):
    """One EdgeConv layer: features [..., N, C] and the graph's ids
    [..., N, k] -> [..., N, out_channels]."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.dense = Dense(2 * in_channels, out_channels, dtype, bias=False)
        self.bn = DynamicBatchNorm(out_channels, BN_EPSILON)

    def forward(self, features: torch.Tensor, ids: torch.Tensor, train: bool = False,
                momentum=0.9) -> torch.Tensor:
        nbr = gather_neighbors(features, ids)  # [..., N, k, C]
        ctr = features.unsqueeze(-2).expand_as(nbr)
        edges = torch.cat([nbr - ctr, ctr], dim=-1)
        h = self.bn.forward_act(self.dense(edges), train, momentum, LEAKY_SLOPE)
        # amax, as the authors' max, splits the gradient evenly among ties
        return h.amax(dim=-2)


class DGCNNVLAD(nn.Module):
    """Submap [B, N, 3] -> descriptor [B, output_dim] (L2-normalised fp32)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.adjacency_format not in ("gather", "auto"):
            raise ValueError(f"DGCNN-VLAD builds id lists; adjacency_format="
                             f"{cfg.adjacency_format!r} is not 'gather' or 'auto'")
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        in_ch = 3
        for i, ch in enumerate(cfg.proxyconv_channels):
            self.add_module(f"edgeconv_{i}", EdgeConv(in_ch, ch, dtype))
            in_ch = ch
        self.lift = SharedMLP(sum(cfg.proxyconv_channels), cfg.lift_channels, dtype,
                              bias=False, epsilon=BN_EPSILON, negative_slope=LEAKY_SLOPE)
        self.netvlad = GVLADHead(cfg)

    def forward(self, points: torch.Tensor, train: bool = False,
                momentum=0.9) -> torch.Tensor:
        return self.forward_with_graphs(points, train, momentum)[0]

    def forward_with_graphs(self, points: torch.Tensor, train: bool = False,
                            momentum=0.9) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """The descriptors and each layer's graph (int32 ids [B, N, k],
        layer 0's on xyz first)."""
        x = points.float()
        k = self.cfg.knn_k
        f = x.to(compute_dtype(self.cfg))
        graphs, outs = [], []
        for i in range(len(self.cfg.proxyconv_channels)):
            with profile_region(f"dgcnn/knn_{i}"), torch.no_grad():
                ids = knn(x, k) if i == 0 else knn_features(f, k)
            graphs.append(ids)
            with profile_region(f"dgcnn/edgeconv_{i}"):
                f = getattr(self, f"edgeconv_{i}")(f, ids, train, momentum)
            outs.append(f)
        with profile_region("dgcnn/lift"):
            h = self.lift(torch.cat(outs, dim=-1), train, momentum)  # [B, N, feature_dim]
        with profile_region("dgcnn/vlad"):
            return self.netvlad(h, train=train, momentum=momentum), graphs
