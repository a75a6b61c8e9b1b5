"""PointNetVLAD (twin of ``epcnet_tpu/models/pointnetvlad.py``;
BASELINE config #3).

PointNet backbone (input T-Net, shared MLP ``mlp1``, feature T-Net, shared
MLP ``mlp2`` up to 1024-D) then the head named ``netvlad``: ``GVLADHead``
with one group and group_dim = output_dim, which is plain NetVLAD with one
dense C·D -> 256 FC (``out_fc`` skipped), gating and the L2 norm. Library
products, BN and a max: no kernel of the port's own runs here.
"""

from __future__ import annotations

import torch
from torch import nn

from epcnet_torch.configs import ModelConfig
from epcnet_torch.models.layers import SharedMLP, TNet
from epcnet_torch.models.vlad_head import GVLADHead, compute_dtype


class PointNetVLAD(nn.Module):
    """Submap [B, N, 3] -> descriptor [B, output_dim] (L2-normalised fp32)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        c0, c1 = cfg.pointnet_channels[:2]
        if cfg.use_tnet:
            self.input_tnet = TNet(3, dtype)
        self.mlp1 = SharedMLP(3, (c0, c1), dtype)
        if cfg.use_tnet:
            self.feature_tnet = TNet(c1, dtype)
        self.mlp2 = SharedMLP(c1, cfg.pointnet_channels[2:], dtype)
        self.netvlad = GVLADHead(cfg)

    def forward(self, points: torch.Tensor, train: bool = False,
                momentum=0.9) -> torch.Tensor:
        dtype = compute_dtype(self.cfg)
        x = points.float()
        if self.cfg.use_tnet:  # the transforms are applied in fp32
            t_in = self.input_tnet(x.to(dtype), train, momentum)
            x = torch.einsum("bnd,bde->bne", x, t_in.float())
        h = self.mlp1(x.to(dtype), train, momentum)
        if self.cfg.use_tnet:
            t_feat = self.feature_tnet(h, train, momentum)
            h = torch.einsum("bnd,bde->bne", h.float(), t_feat.float()).to(dtype)
        return self.netvlad(self.mlp2(h, train, momentum), train=train, momentum=momentum)
