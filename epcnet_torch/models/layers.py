"""Shared NN building blocks (twin of ``epcnet_tpu/models/layers.py``).

Module and parameter names follow the flax modules one to one, so the flat
``params/...`` / ``batch_stats/...`` names of ``cli/export.py`` map onto
``state_dict`` keys by swapping ``/`` for ``.`` (``weights.py``). This slice
is eval only: every module raises on ``train=True`` (training is ROADMAP
item 4). Parameters are created as zeros; real values come from
``weights.load_flat_variables``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from epcnet_torch.ops.adjacency import neighbor_mean
from epcnet_torch.utils.profiling import profile_region

_TRAINING = "training is not ported yet (ROADMAP item 4, Training)"


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)``: input, weight and bias are cast to
    ``dtype`` and the output stays in it. ``weight`` is [out, in], torch's
    layout (flax's kernel is [in, out]); the bias is added after the
    product, as flax does."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)


class DynamicBatchNorm(nn.Module):
    """BatchNorm over all leading axes, eval mode: the running ``mean`` and
    ``var`` buffers, eps 1e-3 (reference tf_util), computed in fp32 and cast
    back to the input's dtype. Hand-written, not ``nn.BatchNorm1d``: the
    reference's running update and biased variance differ from torch's."""

    def __init__(self, channels: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(_TRAINING)
        y = (x.float() - self.mean) * torch.rsqrt(self.var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


class SharedMLP(nn.Module):
    """Per-point MLP stack: Dense -> BN -> ReLU per width (``dense_{i}``,
    ``bn_{i}``; the last BN/ReLU only with ``activate_final``)."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 dtype=torch.bfloat16, activate_final: bool = True):
        super().__init__()
        self.widths = tuple(widths)
        self.activate_final = activate_final
        for i, w in enumerate(self.widths):
            self.add_module(f"dense_{i}", Dense(in_features, w, dtype))
            if i < len(self.widths) - 1 or activate_final:
                self.add_module(f"bn_{i}", DynamicBatchNorm(w))
            in_features = w

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(_TRAINING)
        for i in range(len(self.widths)):
            x = getattr(self, f"dense_{i}")(x)
            if hasattr(self, f"bn_{i}"):
                x = F.relu(getattr(self, f"bn_{i}")(x))
        return x


class ProxyConv(nn.Module):
    """EPC-Net's ProxyConv [PAPER §III-B]: proxy_i = mean of the K
    neighbours' features (the 0/1 indicator matmul scaled by 1/K, or a
    precomputed ``proxy``); output = ReLU(BN(W · [proxy - f, f])) — the
    concatenation in that order."""

    def __init__(self, in_channels: int, out_channels: int, knn_k: int = 20,
                 dtype=torch.bfloat16):
        super().__init__()
        self.knn_k = knn_k
        self.dtype = dtype
        self.dense = Dense(2 * in_channels, out_channels, dtype)
        self.bn = DynamicBatchNorm(out_channels)

    def forward(self, features: torch.Tensor, adjacency: torch.Tensor | None,
                proxy: torch.Tensor | None = None, train: bool = False):
        if train:
            raise NotImplementedError(_TRAINING)
        if proxy is None:  # the dense route's A @ F, a span of its own
            with profile_region("epcnet/neighbor_mean"):
                proxy = neighbor_mean(features, adjacency, compute_dtype=self.dtype,
                                      adjacency_scale=1.0 / self.knn_k)
        h = torch.cat([proxy - features, features], dim=-1)
        return F.relu(self.bn(self.dense(h)))


class TNet(nn.Module):
    """PointNet's spatial / feature transform net (PointNetVLAD): a per-point
    MLP (64, 128, 1024), the max over points, an MLP (512, 256) and an fp32
    ``h @ transform_w + transform_b``, reshaped to a [B, dim, dim]
    transform. ``transform_w`` [256, dim²] keeps flax's param layout (it is
    no Dense ``kernel``, so the flat names map with no transpose);
    ``transform_b`` starts at the identity."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.dim = dim
        self.mlp = SharedMLP(dim, (64, 128, 1024), dtype)
        self.fc = SharedMLP(1024, (512, 256), dtype)
        self.transform_w = nn.Parameter(torch.zeros(256, dim * dim))
        self.transform_b = nn.Parameter(torch.eye(dim).reshape(-1))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(_TRAINING)
        h = self.mlp(x).amax(dim=-2)  # [B, 1024]
        h = self.fc(h)
        t = h.float() @ self.transform_w + self.transform_b
        return t.reshape(x.shape[0], self.dim, self.dim)
