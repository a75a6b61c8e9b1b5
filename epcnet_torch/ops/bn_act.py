"""Eval-mode BatchNorm and the activation after it, in one pass (K9,
``csrc/bn_act.cu``).

Every Dense of a ProxyConv, a ``SharedMLP`` and an EdgeConv is followed by
BN and a ReLU or LeakyReLU. In eval BN normalises with its running
statistics, so the two are one elementwise function of the Dense output:

  act(((x - mean) * rsqrt(var + eps)) * scale + bias, rounded to x's dtype)

computed in fp32, each operation rounded on its own, as
``models/layers.py::DynamicBatchNorm`` and ``F.relu`` / ``F.leaky_relu``
compute it. ``bn_act_plain`` is that chain; ``bn_act_cuda`` launches K9,
which reads the bf16 input once and writes the bf16 result once, bit-equal
to the chain; ``bn_act`` takes the plain chain on a CPU tensor and K9 on a
CUDA tensor, with no fallback between them. No backward: the model calls
it only where no autograd graph is built.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from epcnet_torch.ops import _build


def activation(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    """ReLU, or LeakyReLU with ``negative_slope`` where it is not 0."""
    return F.leaky_relu(x, negative_slope) if negative_slope else F.relu(x)


def bn_affine(xf: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor, epsilon: float,
              dtype: torch.dtype) -> torch.Tensor:
    """BN's affine map over the last axis of the widened input ``xf``, in
    ``DynamicBatchNorm``'s order of operations, cast to ``dtype``: the one
    copy of the formula, for both of BN's modes and for K9's plain version."""
    y = (xf - mean) * torch.rsqrt(var + epsilon)
    return (y * scale + bias).to(dtype)


def bn_act_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 scale: torch.Tensor, bias: torch.Tensor, epsilon: float,
                 negative_slope: float = 0.0) -> torch.Tensor:
    """K9's plain version: eval BN over the last axis in fp32 (fp64 stays),
    cast back to x's dtype, then ``activation``."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return activation(bn_affine(xf, mean, var, scale, bias, epsilon, x.dtype), negative_slope)


def bn_act_cuda(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor, epsilon: float,
                negative_slope: float = 0.0) -> torch.Tensor:
    """Launch K9 on ``torch.cuda.current_stream()``: x a contiguous bf16
    [..., C] on the card with C a multiple of 8, the four [C] vectors fp32
    on the same card. ``rsqrt(var + eps)`` is computed here by torch, as the
    chain computes it. Returns a new tensor like x. Each launch adds one to
    ``bn_act_cuda.launches``."""
    vectors = (mean, var, scale, bias)
    if x.device.type != "cuda" or any(v.device != x.device for v in vectors):
        raise ValueError(f"K9 takes CUDA tensors on one card, got {x.device} and "
                         f"{[str(v.device) for v in vectors]}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"K9 takes bf16 input, got {x.dtype}")
    c = x.shape[-1] if x.dim() else 0
    if c % 8 or c == 0:
        raise ValueError(f"K9 takes a multiple of 8 channels, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("K9 takes a contiguous input at a 16-byte boundary")
    if any(v.dtype != torch.float32 or v.shape != (c,) for v in vectors):
        raise ValueError(f"K9 takes fp32 [{c}] vectors, got "
                         f"{[(v.dtype, tuple(v.shape)) for v in vectors]}")
    rows = x.numel() // c
    if rows >= 2 ** 31:
        raise ValueError(f"K9 takes fewer than 2^31 rows, got {rows}")
    inv = torch.rsqrt(var + epsilon)
    mean, scale, bias = (v.contiguous() for v in (mean, scale, bias))
    if any(v.data_ptr() % 16 for v in (mean, scale, bias)):
        raise ValueError("K9 takes [C] vectors at 16-byte boundaries")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.launch("bn_act", "bn_act_launch", "ppppppiiifp",
                      x.data_ptr(), mean.data_ptr(), inv.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), rows, c, int(bool(negative_slope)),
                      float(negative_slope), torch.cuda.current_stream().cuda_stream)
    bn_act_cuda.launches += 1
    return out


bn_act_cuda.launches = 0


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
           bias: torch.Tensor, epsilon: float, negative_slope: float = 0.0) -> torch.Tensor:
    """Eval BN over x's last axis and its activation (ReLU, or LeakyReLU
    with ``negative_slope``): the plain chain on a CPU tensor, K9 on a CUDA
    tensor (which raises on what K9 does not take)."""
    if x.device.type == "cpu":
        return bn_act_plain(x, mean, var, scale, bias, epsilon, negative_slope)
    return bn_act_cuda(x, mean, var, scale, bias, epsilon, negative_slope)
