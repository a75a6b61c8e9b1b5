"""(G-)VLAD aggregation core: soft-assignment softmax + residual accumulation
+ intra-normalisation (twin of ``epcnet_tpu/ops/vlad.py``).

``V = Aᵀ X - (Σ_i a_ik) c_k``: two products and an O(C·D) correction, so the
[N, C, D] residual tensor never exists. Library ops only — the JAX package
deleted its Pallas VLAD kernel after it measured slower than XLA.

The descriptor tail is fp32 with no TF32 (SURVEY.md §7.8). TF32 is a
process-wide PyTorch switch, and cuDNN's is on by default, so this module
turns both off once, at import; ``epcnet_torch/ops/__init__.py`` imports it,
so every use of the port's ops runs with TF32 off.
"""

from __future__ import annotations

import torch

from epcnet_torch.ops.matmul import matmul_f32acc

# fp32 products must stay fp32 on the card: TF32 keeps ~10 mantissa bits and
# would perturb descriptors by ~1e-3 (the parity contract is fp32-exact)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _finish(s: torch.Tensor, asum: torch.Tensor, centroids: torch.Tensor, eps: float):
    """Shared tail: residual correction, intra-norm, flatten, L2-norm."""
    v = s - asum[..., None] * centroids  # [..., C, D]
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)
    flat = v.reshape(*v.shape[:-2], -1)  # [..., C*D]
    return flat / (torch.linalg.vector_norm(flat, dim=-1, keepdim=True) + eps)


def vlad_aggregate(
    features: torch.Tensor,
    logits: torch.Tensor,
    centroids: torch.Tensor,
    eps: float = 1e-12,
    precision: str = "highest",
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """VLAD aggregation.

    Args:
      features: [..., N, D] per-point features.
      logits: [..., N, C] pre-softmax cluster assignment logits.
      centroids: [C, D] cluster centres.
      precision: "highest" — ``Aᵀ X`` in full fp32 (the parity default);
        "default" — bf16 operands with an fp32 sum, the counterpart of the
        TPU's single-pass bf16 MXU mode (~1e-3 relative drift, opt-in).
      mask: optional [..., N] point-validity mask (1 real, 0 pad); pad
        points' assignment mass is zeroed.

    Returns:
      [..., C*D] L2-normalised VLAD vector (fp32).
    """
    if precision not in ("highest", "default"):
        raise ValueError(f"precision={precision!r} not in {{'highest', 'default'}}")
    if features.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                             or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 was turned back on; VLAD must run in fp32")
    f = features.float()
    a = torch.softmax(logits.float(), dim=-1)  # [..., N, C]
    if mask is not None:
        a = a * mask.float()[..., None]
    at = a.transpose(-1, -2)
    if precision == "highest":
        s = torch.matmul(at, f)  # [..., C, D]
    else:
        s = matmul_f32acc(at.to(torch.bfloat16), f.to(torch.bfloat16))
    asum = a.sum(-2)  # [..., C]
    return _finish(s, asum, centroids.float(), eps)
