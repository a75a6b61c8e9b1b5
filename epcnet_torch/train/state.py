"""Train state and schedules (twin of ``epcnet_tpu/train/state.py``).

The staircase learning rate (clamped at 1e-5) and the BN-momentum schedule
are the JAX functions in float32, on the host. The optimisers are optax's:
``adam`` (b1 0.9, b2 0.999, eps 1e-8) and ``sgd`` with momentum (no
dampening, no Nesterov), as ``torch.optim.Adam`` and ``torch.optim.SGD``,
whose updates are optax's in exact arithmetic. optax reads its schedule at
the update's own count before incrementing it, so the train step sets each
param group's ``lr`` to ``lr_schedule(state.step)`` just before
``optimizer.step()``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from epcnet_torch.configs import ModelConfig, TrainConfig
from epcnet_torch.models import get_model
from epcnet_torch.weights import init_train_variables, load_flat_variables


def lr_schedule(cfg: TrainConfig):
    """Staircase exponential decay, clamped below at 1e-5; float32 as in
    JAX. Returns ``fn(step) -> float``."""
    lr0, rate, steps = np.float32(cfg.learning_rate), np.float32(cfg.lr_decay_rate), \
        np.float32(cfg.lr_decay_steps)

    def fn(step) -> float:
        p = np.floor(np.float32(step) / steps)
        return float(np.maximum(lr0 * np.power(rate, p), np.float32(1e-5)))

    return fn


def bn_momentum_schedule(cfg: TrainConfig):
    """``min(clip, 1 - init * rate^floor(step / steps))``: the EMA momentum
    fed to BatchNorm; float32 as in JAX. Returns ``fn(step) -> float``."""
    init, rate, steps, clip = (np.float32(cfg.bn_init_decay), np.float32(cfg.bn_decay_rate),
                               np.float32(cfg.bn_decay_steps), np.float32(cfg.bn_decay_clip))

    def fn(step) -> float:
        p = np.floor(np.float32(step) / steps)
        return float(np.minimum(clip, np.float32(1.0) - init * np.power(rate, p)))

    return fn


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """optax's ``adam`` or ``sgd(momentum=...)`` over ``params``; the
    learning rate is set before each update by the train step. Both run
    their single-tensor (``foreach=False``) loops, whose arithmetic is the
    same on every device."""
    lr = lr_schedule(cfg)(0)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=False)
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum, dampening=0.0,
                               nesterov=False, foreach=False)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


@dataclasses.dataclass
class TrainState:
    """What a step changes and a checkpoint holds. ``step`` counts
    optimiser updates; ``epoch`` is the epoch in progress and
    ``epoch_start_step`` the step at its start, so a restore re-enters the
    epoch loop at the right place and skips a mid-epoch checkpoint's
    consumed batches. The model's parameters and BN buffers and the
    optimiser's moments live in ``model`` and ``optimizer``."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0
    epoch_start_step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                       device: str | torch.device | None = None,
                       variables=None) -> TrainState:
    """A fresh state on ``device`` (the card unless ``"cpu"``): the model
    ``model_cfg.name`` names, with ``variables`` (a ``flatten_variables``
    dict) or ``init_train_variables(model_cfg, train_cfg.seed)`` (the JAX
    model's initializers), and its optimiser."""
    model = get_model(model_cfg, device)
    load_flat_variables(model, variables if variables is not None
                        else init_train_variables(model_cfg, train_cfg.seed))
    return TrainState(model=model, optimizer=make_optimizer(train_cfg, model.parameters()))
