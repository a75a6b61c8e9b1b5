"""Training of the port (twin of ``epcnet_tpu/train``): schedules, the
train state, the train / distillation / embed steps, hard-negative mining,
checkpoints and the training loop."""

from epcnet_torch.train.mining import MiningCache
from epcnet_torch.train.state import (
    TrainState,
    bn_momentum_schedule,
    create_train_state,
    lr_schedule,
    make_optimizer,
)
from epcnet_torch.train.step import (
    build_distill_step,
    build_embed_fn,
    build_multi_train_step,
    build_train_step,
    model_embed_fn,
)
from epcnet_torch.train.trainer import Trainer

__all__ = [
    "TrainState",
    "create_train_state",
    "make_optimizer",
    "lr_schedule",
    "bn_momentum_schedule",
    "build_train_step",
    "build_multi_train_step",
    "build_distill_step",
    "build_embed_fn",
    "model_embed_fn",
    "MiningCache",
    "Trainer",
]
