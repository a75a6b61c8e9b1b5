"""Model zoo of the port: EPC-Net and EPC-Net-L (PointNetVLAD is ROADMAP
item 7)."""

from __future__ import annotations

import torch
from torch import nn

from epcnet_torch.configs import ModelConfig, epcnet_l_config
from epcnet_torch.device import resolve_device
from epcnet_torch.models.epcnet import EPCNet, param_count
from epcnet_torch.models.layers import Dense, DynamicBatchNorm, ProxyConv, SharedMLP
from epcnet_torch.models.vlad_head import GVLADHead


def get_model(cfg: ModelConfig, device: str | torch.device | None = None) -> nn.Module:
    """The model for ``cfg.name``, in eval mode, on ``device`` (the card
    unless ``"cpu"`` is asked for; raises without a card). Parameters are
    zeros until ``weights.load_flat_variables`` fills them."""
    if cfg.name == "pointnetvlad":
        raise NotImplementedError(
            "pointnetvlad is not ported yet (ROADMAP item 7, PointNetVLAD)"
        )
    if cfg.name not in ("epcnet", "epcnet_l"):
        raise ValueError(f"unknown model {cfg.name!r}")
    dev = resolve_device(device)
    return EPCNet(cfg).to(dev).eval()


__all__ = [
    "get_model",
    "EPCNet",
    "GVLADHead",
    "ProxyConv",
    "SharedMLP",
    "DynamicBatchNorm",
    "Dense",
    "param_count",
    "ModelConfig",
    "epcnet_l_config",
]
