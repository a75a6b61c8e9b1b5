"""A matrix product with operands in a narrow type and an fp32 sum.

XLA's ``preferred_element_type=float32`` has no plain ``torch.matmul``
spelling: a bf16 ``matmul`` rounds its output to bf16. On the card,
``torch.bmm(..., out_dtype=torch.float32)`` runs cuBLAS with bf16 operands
and returns the fp32 accumulator. On the CPU (tests) the operands are
widened to fp32 first: products of bf16 values are exact in fp32, so that is
the same arithmetic up to the order of the sum.
"""

from __future__ import annotations

import torch


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for [..., M, K] x [..., K, N] operands of one dtype, summed
    and returned in fp32. Leading dims must match exactly (no broadcast)."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    lead = a.shape[:-2]
    out = torch.bmm(
        a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
        out_dtype=torch.float32,
    )
    return out.reshape(*lead, a.shape[-2], b.shape[-1])
