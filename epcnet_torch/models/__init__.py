"""Model zoo of the port: EPC-Net, EPC-Net-L, PointNetVLAD, DGCNN-VLAD and
MinkLoc3Dv2 (the last two in the port alone). Each model's
``forward(points, train=False, momentum=0.9)`` takes the JAX call's
arguments; ``layers.commit_batch_stats`` applies a train forward's BN
statistics."""

from __future__ import annotations

import torch
from torch import nn

from epcnet_torch.configs import (
    ModelConfig,
    dgcnn_vlad_config,
    epcnet_l_config,
    minkloc3dv2_config,
    pointnetvlad_config,
)
from epcnet_torch.device import resolve_device
from epcnet_torch.models.dgcnn import DGCNNVLAD
from epcnet_torch.models.epcnet import EPCNet, param_count
from epcnet_torch.models.layers import (
    Dense,
    DynamicBatchNorm,
    ProxyConv,
    SharedMLP,
    TNet,
    commit_batch_stats,
)
from epcnet_torch.models.minkloc import MinkLoc3Dv2
from epcnet_torch.models.pointnetvlad import PointNetVLAD
from epcnet_torch.models.vlad_head import GVLADHead

MODELS = {"epcnet": EPCNet, "epcnet_l": EPCNet, "pointnetvlad": PointNetVLAD,
          "dgcnn_vlad": DGCNNVLAD, "minkloc3dv2": MinkLoc3Dv2}


def model_class(cfg: ModelConfig) -> type[nn.Module]:
    """The module class ``cfg.name`` names."""
    if cfg.name not in MODELS:
        raise ValueError(f"unknown model {cfg.name!r}")
    return MODELS[cfg.name]


def get_model(cfg: ModelConfig, device: str | torch.device | None = None) -> nn.Module:
    """The model for ``cfg.name``, in eval mode, on ``device`` (the card
    unless ``"cpu"`` is asked for; raises without a card). Parameters are
    zeros (a TNet's bias the identity) until ``weights.load_flat_variables``
    fills them."""
    cls = model_class(cfg)
    dev = resolve_device(device)
    return cls(cfg).to(dev).eval()


__all__ = [
    "get_model",
    "model_class",
    "EPCNet",
    "PointNetVLAD",
    "DGCNNVLAD",
    "MinkLoc3Dv2",
    "GVLADHead",
    "ProxyConv",
    "SharedMLP",
    "DynamicBatchNorm",
    "commit_batch_stats",
    "TNet",
    "Dense",
    "param_count",
    "ModelConfig",
    "epcnet_l_config",
    "pointnetvlad_config",
    "dgcnn_vlad_config",
    "minkloc3dv2_config",
]
