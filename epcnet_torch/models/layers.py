"""Shared NN building blocks (twin of ``epcnet_tpu/models/layers.py``).

Module and parameter names follow the flax modules one to one, so the flat
``params/...`` / ``batch_stats/...`` names of ``cli/export.py`` map onto
``state_dict`` keys by swapping ``/`` for ``.`` (``weights.py``). Every
module takes ``train`` and ``momentum`` as call arguments, as the flax
modules do. Parameters are created as zeros; real values come from
``weights.load_flat_variables``.

BN's running statistics are updated functionally, as the JAX train step
does with ``mutable=["batch_stats"]``: in train mode ``DynamicBatchNorm``
only records its batch (mean, var) and the momentum it was called with, and
``commit_batch_stats`` applies the EMA once, after backward. A forward that
``torch.utils.checkpoint`` runs a second time during backward records the
same values again and so cannot apply the update twice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from epcnet_torch.ops.bn_act import activation, bn_act, bn_affine
from epcnet_torch.parallel.collectives import all_reduce_sum, group_size


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)``: input, weight and bias are cast to
    ``dtype`` and the output stays in it. ``weight`` is [out, in], torch's
    layout (flax's kernel is [in, out]); the bias is added after the
    product, as flax does. ``bias=False``: no bias parameter at all (flax's
    ``use_bias=False``)."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
        else:
            self.register_parameter("bias", None)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y if self.bias is None else y + self.bias.to(dt)


class DynamicBatchNorm(nn.Module):
    """BatchNorm over all leading axes with the momentum a call argument,
    eps 1e-3 (reference tf_util), computed in fp32 and cast back to the
    input's dtype. Eval mode normalises with the running ``mean`` and
    ``var`` buffers; train mode with the batch's fp32 mean and biased
    variance (``jnp.var``: the mean of the squared deviations), through
    which the gradient flows, and records ``(mean, var, momentum)`` for
    ``commit_batch_stats``. Hand-written, not ``nn.BatchNorm1d``: the
    reference's running update and biased variance differ from torch's.

    ``group``: a process group whose ranks each hold a part of the batch
    (data-parallel training: a block of the tuples; the points-sharded
    EPC-Net: a block of the points). Train-mode statistics span the whole
    batch, two passes as the JAX layer's: the mean from an
    ``all_reduce_sum`` of the [C] sums, then the variance from one of the
    centred squares (no group: the local sums); both are differentiable,
    and identical on every rank, so the running update stays identical."""

    def __init__(self, channels: int, epsilon: float = 1e-3, group=None):
        super().__init__()
        self.epsilon = epsilon
        self.group = group
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.pending = None  # (batch mean, batch var, momentum) of a train forward

    def forward(self, x: torch.Tensor, train: bool = False, momentum=0.9) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # fp32 (fp64 stays)
        if train:
            red = tuple(range(x.dim() - 1))
            total = x.numel() // x.shape[-1] * group_size(self.group)
            mean = all_reduce_sum(xf.sum(dim=red), self.group) / total
            var = all_reduce_sum(((xf - mean) ** 2).sum(dim=red), self.group) / total
            self.pending = (mean.detach(), var.detach(), momentum)
        else:
            mean, var = self.mean, self.var
        return bn_affine(xf, mean, var, self.scale, self.bias, self.epsilon, x.dtype)

    def forward_act(self, x: torch.Tensor, train: bool = False, momentum=0.9,
                    negative_slope: float = 0.0) -> torch.Tensor:
        """``activation(self(x, train, momentum), negative_slope)``: ReLU, or
        LeakyReLU with ``negative_slope``. In eval on bf16, where no autograd
        graph is built, the two go as one pass, ``ops.bn_act``: the chain's
        own arithmetic on the CPU, K9 on the card (which raises on an input
        it does not take), bit-equal to the chain. fp32 and fp64 models keep
        the chain: a model of ``compute_dtype="float32"`` embeds on the card
        too (the points-sharded fp32 embed of ``scripts/multidevice.py``)."""
        if self.fixed_in_eval(x, train):
            return bn_act(x, self.mean, self.var, self.scale, self.bias, self.epsilon,
                          negative_slope)
        return activation(self(x, train, momentum), negative_slope)

    def fixed_in_eval(self, x: torch.Tensor, train: bool, *more: torch.Tensor) -> bool:
        """Whether this call may take BN as the fixed per-channel affine map
        of its running statistics with no autograd graph: eval, a bf16
        input ``x``, and no gradient wanted of x, BN's parameters or
        ``more`` (the tensors that reach x, such as a Dense's weight)."""
        return (not train and x.dtype == torch.bfloat16
                and not (torch.is_grad_enabled()
                         and any(t.requires_grad for t in (x, self.scale, self.bias, *more))))


@torch.no_grad()
def commit_batch_stats(model: nn.Module) -> int:
    """Apply each train-mode BN's recorded batch statistics to its running
    ones, ``ra = m·ra + (1 - m)·batch`` with the momentum it was called
    with, in fp32, and clear the record. Returns how many BNs were updated.
    Called once per forward-backward by the train step (once per
    micro-batch under accumulation, so the updates chain as in JAX)."""
    n = 0
    for mod in model.modules():
        if isinstance(mod, DynamicBatchNorm) and mod.pending is not None:
            mean, var, m = mod.pending
            # m stays a host scalar: a copy of it to the card would wait for
            # the card (PyTorch synchronises pageable host-to-device copies)
            m = float(m)
            mod.mean.mul_(m).add_(mean, alpha=1.0 - m)
            mod.var.mul_(m).add_(var, alpha=1.0 - m)
            mod.pending = None
            n += 1
    return n


def set_bn_group(model: nn.Module, group) -> None:
    """Give every ``DynamicBatchNorm`` of ``model`` the process group its
    train-mode statistics span (None: the local batch). Data-parallel
    training sets the "data" group, so that BN sees the global batch as
    GSPMD makes it in the JAX step."""
    for mod in model.modules():
        if isinstance(mod, DynamicBatchNorm):
            mod.group = group


class SharedMLP(nn.Module):
    """Per-point MLP stack: Dense -> BN -> ReLU per width (``dense_{i}``,
    ``bn_{i}``; the last BN/ReLU only with ``activate_final``).
    ``negative_slope`` > 0 makes the activation a LeakyReLU; ``bias`` and
    ``epsilon`` go to every Dense and BN."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 dtype=torch.bfloat16, activate_final: bool = True, bn_group=None,
                 bias: bool = True, epsilon: float = 1e-3, negative_slope: float = 0.0):
        super().__init__()
        self.widths = tuple(widths)
        self.activate_final = activate_final
        self.negative_slope = negative_slope
        for i, w in enumerate(self.widths):
            self.add_module(f"dense_{i}", Dense(in_features, w, dtype, bias=bias))
            if i < len(self.widths) - 1 or activate_final:
                self.add_module(f"bn_{i}", DynamicBatchNorm(w, epsilon, group=bn_group))
            in_features = w

    def forward(self, x: torch.Tensor, train: bool = False, momentum=0.9) -> torch.Tensor:
        for i in range(len(self.widths)):
            x = getattr(self, f"dense_{i}")(x)
            if hasattr(self, f"bn_{i}"):
                x = getattr(self, f"bn_{i}").forward_act(x, train, momentum,
                                                         self.negative_slope)
        return x


class ProxyConv(nn.Module):
    """EPC-Net's ProxyConv [PAPER §III-B]: output = ReLU(BN(W · [proxy - f,
    f])), the concatenation in that order, where ``proxy`` is the mean of
    each point's K neighbours' features (``ops/adjacency.py::NeighborGraph``
    computes it)."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.bfloat16,
                 bn_group=None):
        super().__init__()
        self.dense = Dense(2 * in_channels, out_channels, dtype)
        self.bn = DynamicBatchNorm(out_channels, group=bn_group)

    def forward(self, features: torch.Tensor, proxy: torch.Tensor, train: bool = False,
                momentum=0.9):
        h = torch.cat([proxy - features, features], dim=-1)
        return self.bn.forward_act(self.dense(h), train, momentum)


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

    def forward(self, x: torch.Tensor, train: bool = False, momentum=0.9) -> torch.Tensor:
        # amax, as jnp.max, splits the gradient evenly among tied maxima
        h = self.mlp(x, train, momentum).amax(dim=-2)  # [B, 1024]
        h = self.fc(h, train, momentum)  # BN over [B, C]
        t = h.float() @ self.transform_w + self.transform_b
        return t.reshape(x.shape[0], self.dim, self.dim)
