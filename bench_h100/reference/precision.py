"""The control's precision: operands rounded below the configuration's.

The configuration states a bf16 backbone and fp32 (no TF32) VLAD and head.
The control rounds each backbone product's operands to fp8 e4m3 with one
scale a tensor (its largest magnitude to 448, e4m3's largest finite value),
and each fp32 product's operands to TF32 (10 mantissa bits, round to
nearest even); the products themselves then run in fp32. Both roundings
pass the gradient through unchanged, so the control trains as the reference
does. ``FULL`` leaves every operand as it is: the reference.
"""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0


class _Straight(torch.autograd.Function):
    """``fn(x)`` forward, the identity backward (the rounding is treated as
    exact by the gradient)."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, _E4M3_MAX / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    # round to nearest even at the 13th bit: add 0xFFF plus the kept lsb
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x.float())
    return torch.where(finite, rounded.view(torch.float32), x.float()).to(x.dtype)


class Precision:
    """How the reference rounds the operands of its products: ``low(x)``
    for the backbone's (bf16 in the program), ``wide(x)`` for the VLAD's
    and the head's (fp32 in the program)."""

    def __init__(self, name: str):
        if name not in ("fp32", "control"):
            raise ValueError(f"precision {name!r} not in {{'fp32', 'control'}}")
        self.name = name

    def low(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "fp32" else _Straight.apply(x, _fp8)

    def wide(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "fp32" else _Straight.apply(x, _tf32)


FULL = Precision("fp32")
CONTROL = Precision("control")
