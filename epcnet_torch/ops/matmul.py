"""A matrix product with operands in a narrow type and an fp32 sum.

XLA's ``preferred_element_type=float32`` has no plain ``torch.matmul``
spelling: a bf16 ``matmul`` rounds its output to bf16. On the card,
``torch.bmm(..., out_dtype=torch.float32)`` runs cuBLAS with bf16 operands
and returns the fp32 accumulator; that overload has no derivative, so the
card's branch is an ``autograd.Function`` (``_BmmF32Acc``) whose backward is
JAX's transpose of the same product. On the CPU (tests) the operands are
widened to fp32 first: products of bf16 values are exact in fp32, so that is
the same arithmetic up to the order of the sum, and autograd derives the
same backward.
"""

from __future__ import annotations

import torch

# the backward's fp32 copy of an operand is taken this many matrices at a
# time: for the training batch (44 indicators of 4096 x 4096) a whole copy
# would be a 2.95 GB transient, a chunk of 8 is 0.54 GB
_BACKWARD_CHUNK = 8


def _chunked_f32(x: torch.Tensor, y: torch.Tensor, transpose_x: bool,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``op(x).float() @ y.float()`` over a [B, ., .] batch, a chunk of
    matrices at a time, each chunk's fp32 result rounded once to
    ``out_dtype``; ``op`` is the transpose of the last two dims where
    ``transpose_x``, and the identity otherwise (then ``y`` is transposed)."""
    out = []
    for s in range(0, x.shape[0], _BACKWARD_CHUNK):
        xs, ys = x[s:s + _BACKWARD_CHUNK].float(), y[s:s + _BACKWARD_CHUNK].float()
        prod = (torch.bmm(xs.transpose(1, 2), ys) if transpose_x
                else torch.bmm(xs, ys.transpose(1, 2)))
        out.append(prod.to(out_dtype))
    return torch.cat(out)


class _BmmF32Acc(torch.autograd.Function):
    """[B, M, K] x [B, K, N] in a narrow type -> [B, M, N] fp32 on the card.

    Backward, as JAX transposes ``dot_general(..., preferred_element_type=
    f32)``: the fp32 cotangent ``g`` is never rounded; each operand that
    needs a gradient gets an fp32 product with the other operand widened to
    fp32 (exact for bf16 values, and for a 0/1 indicator), rounded once to
    its own dtype: ``dB = Aᵀ g``, ``dA = g Bᵀ``. An indicator, which needs
    no gradient, is skipped through ``needs_input_grad``. TF32 is off
    (``ops/vlad.py``), so these products are full fp32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _chunked_f32(g, b, False, a.dtype)
        if ctx.needs_input_grad[1]:
            db = _chunked_f32(a, g, True, b.dtype)
        return da, db


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for [..., M, K] x [..., K, N] operands of one dtype, summed
    and returned in fp32. Leading dims must match exactly (no broadcast).
    Differentiable on either device."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    lead = a.shape[:-2]
    out = _BmmF32Acc.apply(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]))
    return out.reshape(*lead, a.shape[-2], b.shape[-1])
