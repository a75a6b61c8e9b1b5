"""G-VLAD aggregation head (twin of ``epcnet_tpu/models/vlad_head.py``).

The C·D VLAD vector is split into G groups; a per-group FC maps each group
down, the results are concatenated and a final FC gives the 256-D
descriptor. With G=1 and group_dim=output_dim the final FC is skipped (the
PointNetVLAD single-FC head). Context gating and the final L2 norm follow.
"""

from __future__ import annotations

import torch
from torch import nn

from epcnet_torch.configs import ModelConfig
from epcnet_torch.models.layers import Dense
from epcnet_torch.ops.vlad import vlad_aggregate


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The backbone dtype: bf16 for ``compute_dtype="bfloat16"``, else fp32
    (the JAX package's mapping). ``"float64"``, the port's only, runs every
    stage in fp64 (the parameters converted with ``model.double()``): a
    reference that measures fp32's rounding, not a mode to train in."""
    return {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(cfg.compute_dtype,
                                                                      torch.float32)


class GVLADHead(nn.Module):
    """``group``: the process group the point axis is sharded over (the
    points-sharded EPC-Net); the VLAD sums are completed over it."""

    def __init__(self, cfg: ModelConfig, group=None):
        super().__init__()
        self.cfg = cfg
        self.group = group
        c, d, g = cfg.vlad_clusters, cfg.feature_dim, cfg.vlad_groups
        if (c * d) % g:
            raise ValueError(f"C*D={c * d} not divisible by groups={g}")
        self.group_in = (c * d) // g
        # assignment logits in the backbone dtype (bf16 under the default
        # config); the softmax and everything after stay fp32
        self.assign = Dense(d, c, compute_dtype(cfg))
        self.centroids = nn.Parameter(torch.zeros(c, d))
        self.group_w = nn.Parameter(torch.zeros(g, self.group_in, cfg.vlad_group_dim))
        self.group_b = nn.Parameter(torch.zeros(g, cfg.vlad_group_dim))
        # G=1 with group_dim=output_dim: the grouped FC IS the output FC
        self.skip_out_fc = g == 1 and cfg.vlad_group_dim == cfg.output_dim
        wide = torch.promote_types(compute_dtype(cfg), torch.float32)  # fp32, or fp64
        if not self.skip_out_fc:
            self.out_fc = Dense(g * cfg.vlad_group_dim, cfg.output_dim, wide)
        if cfg.gating:
            self.gate = Dense(cfg.output_dim, cfg.output_dim, wide)

    def forward(self, features: torch.Tensor, mask: torch.Tensor | None = None,
                train: bool = False, momentum=0.9) -> torch.Tensor:
        """features [B, N, D] -> L2-normalised [B, output_dim] fp32. The head
        has no BN: ``train`` and ``momentum`` are taken as the flax head
        takes them and change nothing."""
        cfg = self.cfg
        if features.shape[-1] != cfg.feature_dim:
            raise ValueError(f"features {tuple(features.shape)} != feature_dim "
                             f"{cfg.feature_dim}")
        logits = self.assign(features.to(compute_dtype(cfg)))
        v = vlad_aggregate(features, logits, self.centroids,
                           precision=cfg.vlad_precision, mask=mask,
                           group=self.group)  # [B, C*D]
        b, g = v.shape[0], cfg.vlad_groups
        h = torch.einsum("bgi,gio->bgo", v.reshape(b, g, self.group_in),
                         self.group_w) + self.group_b
        out = h.reshape(b, g * cfg.vlad_group_dim)
        if not self.skip_out_fc:
            out = self.out_fc(out)
        if cfg.gating:
            out = out * torch.sigmoid(self.gate(out))
        return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-12)
