"""Metric-learning losses for place recognition (twin of
``epcnet_tpu/losses.py``).

Triplet / lazy-triplet / quadruplet / lazy-quadruplet over squared L2
distances between L2-normalised descriptors; ``best_pos_distance`` is the
MIN over the tuple's positives, "lazy" takes the MAX over negatives instead
of the sum. Margins default to (0.5, 0.2).

All functions take a whole batch of tuples:
  q          [B, D]      query descriptors
  pos        [B, P, D]   positive descriptors
  neg        [B, Ng, D]  negative descriptors
  other_neg  [B, D]      the quadruplet's "other negative"
and return a 0-d fp32 loss (mean over the batch).

Gradients at ties follow JAX: ``amax``/``amin`` split the gradient evenly
among tied elements as ``jnp.max``/``jnp.min`` do (``max(dim).values``
would send it all to one index), and the hinge is ``torch.maximum`` with
zero, which gives half the gradient at exactly zero as ``jnp.maximum``
does. Tied negatives are common: the loader repeats negatives when a pool
is short.
"""

from __future__ import annotations

import torch


def _sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def _hinge(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros_like(x))


def best_pos_distance(q: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Min squared distance from each query to its positives. [B]"""
    return torch.amin(_sq(pos - q[:, None, :]), dim=-1)


def _hinges(q, pos, neg, margin):
    best_pos = best_pos_distance(q, pos)  # [B]
    neg_d = _sq(neg - q[:, None, :])  # [B, Ng]
    return _hinge(margin + best_pos[:, None] - neg_d), best_pos


def triplet_loss(q, pos, neg, margin: float = 0.5) -> torch.Tensor:
    h, _ = _hinges(q, pos, neg, margin)
    return torch.mean(torch.sum(h, dim=-1))


def lazy_triplet_loss(q, pos, neg, margin: float = 0.5) -> torch.Tensor:
    h, _ = _hinges(q, pos, neg, margin)
    return torch.mean(torch.amax(h, dim=-1))


def _second_hinges(best_pos, neg, other_neg, margin2):
    other_d = _sq(neg - other_neg[:, None, :])  # [B, Ng]
    return _hinge(margin2 + best_pos[:, None] - other_d)


def quadruplet_loss(q, pos, neg, other_neg, margin_1: float = 0.5,
                    margin_2: float = 0.2) -> torch.Tensor:
    h1, best_pos = _hinges(q, pos, neg, margin_1)
    h2 = _second_hinges(best_pos, neg, other_neg, margin_2)
    return torch.mean(torch.sum(h1, dim=-1)) + torch.mean(torch.sum(h2, dim=-1))


def lazy_quadruplet_loss(q, pos, neg, other_neg, margin_1: float = 0.5,
                         margin_2: float = 0.2) -> torch.Tensor:
    h1, best_pos = _hinges(q, pos, neg, margin_1)
    h2 = _second_hinges(best_pos, neg, other_neg, margin_2)
    return torch.mean(torch.amax(h1, dim=-1)) + torch.mean(torch.amax(h2, dim=-1))


def distillation_loss(student_desc: torch.Tensor, teacher_desc: torch.Tensor) -> torch.Tensor:
    """Feature-mimic MSE on descriptors for EPC-Net-L [PAPER §III-D]."""
    return torch.mean(_sq(student_desc - teacher_desc))


LOSSES = {
    "triplet": triplet_loss,
    "lazy_triplet": lazy_triplet_loss,
    "quadruplet": quadruplet_loss,
    "lazy_quadruplet": lazy_quadruplet_loss,
}


def get_loss(name: str):
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name!r}; options: {sorted(LOSSES)}")
    return LOSSES[name]
