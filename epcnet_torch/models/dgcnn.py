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
with BN over every edge (B·N·k rows), eps 1e-5, as published. Training,
any call that builds an autograd graph, and the fp32 and fp64 models
compute exactly that: the edges materialised, [B, N, k, 2C], and reduced
with a max. An eval call on bf16 features with no graph to build (where
``DynamicBatchNorm`` takes K9) uses the algebra instead: with W = [W1 | W2]
split over its input columns, W e_ij = W1 x_j + (W2 - W1) x_i; BN in eval
is a fixed affine map per channel and the LeakyReLU is increasing, so the
max over j passes inside both, and per channel c
  x'_ic = LeakyReLU(BN_c((M_ic - Y1_ic) + Y2_ic)),
  M_ic = max_j Y1_jc (BN's scale_c >= 0) or min_j Y1_jc (scale_c < 0),
with Y = x @ [W1; W2]ᵀ one product over the points (bf16 operands, fp32
sums and result) and ``ops/edge_max.py::edge_max`` the rest (K10 on the
card): the same function, with no [B, N, k, 2C] edges. It rounds less
than the edges do: ``x_j - x_i`` and the Dense's output are not rounded
to bf16, only the result is.

Configuration (``configs.dgcnn_vlad_config``; ``ModelConfig`` gains no
field): ``proxyconv_channels`` holds the EdgeConv widths (64, 64, 128,
256), ``lift_channels`` conv5's (1024,), ``adjacency_format`` is
``"gather"`` (id lists; ``"auto"`` means the same here, and the dense and
packed layouts are refused). BN's epsilon (below) and the LeakyReLU's slope
(``ops/edge_max.py::LEAKY_SLOPE``, which K10 compiles in) are the published
constants.

Precision is EPC-Net's: the features and every backbone product in bf16
(fp32 sums), BN computed in fp32, the max exact in any dtype, the VLAD sums
and the head in fp32. K8 takes bf16 features on the card; the fp32 and fp64
variants of the model run on the CPU (K8 raises on another dtype).

Spans (``profile_region``): ``dgcnn/knn_{i}`` (each layer's graph),
``dgcnn/edgeconv_{i}`` (gather, edges, Dense, BN, activation, max; in eval
the product over the points and K10), ``dgcnn/lift``, ``dgcnn/vlad``.
"""

from __future__ import annotations

import torch
from torch import nn

from epcnet_torch.configs import ModelConfig
from epcnet_torch.models.layers import Dense, DynamicBatchNorm, SharedMLP
from epcnet_torch.models.vlad_head import GVLADHead, compute_dtype
from epcnet_torch.ops.adjacency import gather_neighbors
from epcnet_torch.ops.edge_max import LEAKY_SLOPE, edge_max
from epcnet_torch.ops.knn import knn, knn_features
from epcnet_torch.ops.matmul import matmul_f32acc
from epcnet_torch.utils.profiling import profile_region

BN_EPSILON = 1e-5  # nn.BatchNorm2d's default in the authors' model


class EdgeConv(nn.Module):
    """One EdgeConv layer: features [..., N, C] and the graph's ids
    [..., N, k] -> [..., N, out_channels]."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.dense = Dense(2 * in_channels, out_channels, dtype, bias=False)
        self.bn = DynamicBatchNorm(out_channels, BN_EPSILON)

    def forward(self, features: torch.Tensor, ids: torch.Tensor, train: bool = False,
                momentum=0.9) -> torch.Tensor:
        if self.bn.fixed_in_eval(features, train, self.dense.weight):
            return self.forward_points(features, ids)
        return self.forward_edges(features, ids, train, momentum)

    def forward_edges(self, features: torch.Tensor, ids: torch.Tensor, train: bool = False,
                      momentum=0.9) -> torch.Tensor:
        """The published computation, over the [..., N, k, 2C] edges."""
        nbr = gather_neighbors(features, ids)  # [..., N, k, C]
        ctr = features.unsqueeze(-2).expand_as(nbr)
        edges = torch.cat([nbr - ctr, ctr], dim=-1)
        h = self.bn.forward_act(self.dense(edges), train, momentum, LEAKY_SLOPE)
        # amax, as the authors' max, splits the gradient evenly among ties
        return h.amax(dim=-2)

    def forward_points(self, features: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The eval algebra of the module docstring, with no edges: one
        product over the points, then ``edge_max`` (K10 on the card)."""
        c = features.shape[-1]
        w = self.dense.weight.to(features.dtype)  # [Cout, 2C]
        stacked = torch.cat([w[:, :c], w[:, c:]])  # [W1; W2], [2·Cout, C]
        y = matmul_f32acc(features.reshape(-1, c), stacked.t())
        bn = self.bn
        return edge_max(y.reshape(*features.shape[:-1], -1), ids, bn.mean, bn.var, bn.scale,
                        bn.bias, bn.epsilon)


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
