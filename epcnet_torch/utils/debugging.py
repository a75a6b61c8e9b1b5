"""Numeric-safety helpers (counterpart of ``epcnet_tpu/utils/debugging.py``).

  - ``assert_all_finite``: finiteness of tensors and arrays in nested dicts,
    lists and tuples, of a module's parameters and buffers, or of an
    optimiser's state, raising ``FloatingPointError`` that names the paths;
  - ``checked_step``: the counterpart of ``checkify_step``: wraps a train
    step (``step(state, batch, ...) -> (state, metrics)``) and raises on the
    first non-finite loss, gradient or parameter after a step, instead of
    letting NaNs reach a checkpoint.

``interpret_kernels`` (Pallas interpret mode) has no counterpart: a CUDA
kernel has no interpret mode, and its plain PyTorch twin already plays that
part in the tests (a CPU tensor takes the twin). Nothing here routes the
card to the twins.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn


def _leaves(obj, path: str):
    """(path, tensor or array) of every leaf under ``obj``."""
    if isinstance(obj, nn.Module):
        for k, t in list(obj.named_parameters()) + list(obj.named_buffers()):
            yield f"{path}.{k}", t
    elif isinstance(obj, torch.optim.Optimizer):
        yield from _leaves(obj.state_dict()["state"], f"{path}.state")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(obj, (torch.Tensor, np.ndarray, np.floating, float)):
        yield path, obj


def _finite(v) -> bool:
    if isinstance(v, torch.Tensor):
        return not v.is_floating_point() or bool(torch.isfinite(v.detach()).all())
    arr = np.asarray(v)
    return not np.issubdtype(arr.dtype, np.floating) or bool(np.isfinite(arr).all())


def assert_all_finite(obj, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming (up to 10 of) the paths under
    ``obj`` that hold a NaN or an infinity."""
    bad = [p for p, v in _leaves(obj, "") if not _finite(v)]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")


def checked_step(step_fn: Callable) -> Callable:
    """``step_fn`` that, after each step, checks the loss in its metrics,
    then the model's gradients and parameters (``state.model``), and raises
    ``FloatingPointError`` on the first that is not finite. Each check reads
    the card: use it to debug, not in a timed loop."""

    def run(state, *args, **kwargs):
        state, metrics = step_fn(state, *args, **kwargs)
        assert_all_finite({k: v for k, v in metrics.items() if "loss" in k}, "loss")
        assert_all_finite({k: p.grad for k, p in state.model.named_parameters()
                           if p.grad is not None}, "gradients")
        assert_all_finite(state.model, "model")
        return state, metrics

    return run
