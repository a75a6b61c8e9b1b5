"""Train, distillation and embed steps (twin of ``epcnet_tpu/train/step.py``).

One forward runs ALL clouds of the batch's tuples (query, positives,
negatives, other_neg) flattened to [B·T, N, 3], so BatchNorm's statistics
span the whole tuple batch, as in the JAX step, and the kNN graph is one
kernel launch for the step (K1 on the dense route, K2 on the gather route).

A step is ``step(state, batch) -> (state, metrics)``: it updates ``state``
(model, optimiser, counter) in place and returns it, with the metrics as
0-d tensors on the model's device, so a step asks the host for nothing;
the trainer reads them only where it logs. Per step: forward (wrapped in
``torch.utils.checkpoint`` with ``TrainConfig.remat``), loss, backward,
``commit_batch_stats`` (the BN running update, once per forward-backward),
then the optimiser update at ``lr_schedule(step)`` with the pre-increment
step, as optax. ``grad_accum_steps`` splits the B tuples into micro-batches
the JAX way (INTERLEAVED: micro j takes tuples ``j::accum``), sums their
gradients, divides by ``accum`` and applies one update; the BN updates
chain, one per micro-batch.

Data parallelism: a step built with ``group`` (the "data" group of a
``parallel.ProcessMesh``, one process a rank) takes the GLOBAL batch on
every rank and runs its rank's block of the tuple axis (JAX's
``P("data")``). BN's statistics span the global batch (``set_bn_group``:
as GSPMD makes them in the JAX step; DDP's per-replica BN would not match),
the gradients are summed over the group and divided by its size, so one
step equals the single-device step, and the metrics are averaged over the
group. Under ``grad_accum_steps`` micro-batch j of rank r is its local
tuples ``j::accum``: JAX's interleaved split restricted to the rank's block.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from epcnet_torch import losses as losses_lib
from epcnet_torch.configs import ModelConfig, TrainConfig
from epcnet_torch.device import resolve_device
from epcnet_torch.models import commit_batch_stats, get_model
from epcnet_torch.models.layers import set_bn_group
from epcnet_torch.parallel.collectives import all_reduce_, group_rank, group_size
from epcnet_torch.parallel.mesh import data_block
from epcnet_torch.train.state import TrainState, bn_momentum_schedule, lr_schedule
from epcnet_torch.utils.profiling import profile_region
from epcnet_torch.weights import init_flat_variables, load_flat_variables

TUPLE_KEYS = ("query", "positives", "negatives", "other_neg")


def to_device(batch: Mapping, device: torch.device) -> dict:
    """The batch's clouds as fp32 tensors on ``device`` (numpy arrays or
    tensors; ``ids`` and other keys are dropped)."""
    return {k: torch.as_tensor(batch[k], dtype=torch.float32, device=device)
            for k in TUPLE_KEYS if k in batch}


def _micro_batches(batch: dict, accum: int) -> list[dict]:
    """The JAX split: micro j takes tuples j::accum of the B axis."""
    b = batch["query"].shape[0]
    if b % accum:
        raise ValueError(f"batch size {b} is not divisible by grad_accum_steps={accum}")
    return [{k: v[j::accum] for k, v in batch.items()} for j in range(accum)]


def _flatten(batch: dict, quad: bool) -> tuple[torch.Tensor, int, int, int]:
    """[B, T, N, 3] tuples -> [B·T, N, 3] clouds; returns (flat, B, P, Ng)."""
    q, pos, neg = batch["query"], batch["positives"], batch["negatives"]
    b, p, n, _ = pos.shape
    parts = [q[:, None], pos, neg]
    if quad:
        parts.append(batch["other_neg"][:, None])
    clouds = torch.cat(parts, dim=1)
    return clouds.reshape(b * clouds.shape[1], n, 3), b, p, neg.shape[1]


def _metric_loss(desc, b, p, ng, quad, loss_fn, cfg: TrainConfig):
    """The tuple loss of flat descriptors [B·T, D]; returns (loss, q, pos, neg)."""
    desc = desc.reshape(b, -1, desc.shape[-1])
    qd, pd, nd = desc[:, 0], desc[:, 1:1 + p], desc[:, 1 + p:1 + p + ng]
    if quad:
        loss = loss_fn(qd, pd, nd, desc[:, -1], cfg.margin_1, cfg.margin_2)
    else:
        loss = loss_fn(qd, pd, nd, cfg.margin_1)
    return loss, qd, pd, nd


def _train_forward(model: nn.Module, flat: torch.Tensor, momentum: float,
                   remat: bool) -> torch.Tensor:
    """The model's train forward, under ``torch.utils.checkpoint`` with
    ``remat``: backward then runs the forward again instead of keeping its
    activations (the same values; BN records the same statistics twice and
    ``commit_batch_stats`` applies them once)."""
    if not remat:
        return model(flat, train=True, momentum=momentum)
    return torch.utils.checkpoint.checkpoint(
        lambda x: model(x, train=True, momentum=momentum), flat, use_reentrant=False)


def _backward_and_commit(model: nn.Module, loss: torch.Tensor) -> None:
    with profile_region("train/backward"):
        loss.backward()
    with profile_region("train/bn_update"):
        commit_batch_stats(model)


def average_grads(model: nn.Module, group, divisor: int = 1) -> None:
    """Each parameter's gradient summed over ``group`` (one collective of
    every gradient, flattened) and divided by ``divisor`` x the group size.
    A parameter that took no gradient gets zeros, as JAX's gradient tree
    has a zero leaf for it (optax's moments still decay)."""
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if group is None:
        if divisor > 1:
            for p in params:
                p.grad.div_(divisor)
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_(flat, group).div_(divisor * group_size(group))
    at = 0
    for p in params:
        p.grad.copy_(flat[at:at + p.numel()].view_as(p))
        at += p.numel()


def _local(batch: Mapping, group) -> Mapping:
    """This rank's block of the tuple axis (the whole batch without a group)."""
    if group is None:
        return batch
    return {k: data_block(v, group_rank(group), group_size(group)) for k, v in batch.items()}


def _group_mean(vals: torch.Tensor, group) -> torch.Tensor:
    """Per-rank metric means -> their mean over the group."""
    return vals if group is None else all_reduce_(vals, group).div_(group_size(group))


def _apply_update(state: TrainState, lr: float, accum: int, group=None) -> None:
    """Average accumulated gradients (over the micro-batches and the
    group's ranks), set the step's learning rate, update. The gradients
    stay in ``.grad`` until the next step starts (``weights.flat_grads``)."""
    with profile_region("train/optimizer"):
        average_grads(state.model, group, accum)
        for group_ in state.optimizer.param_groups:
            group_["lr"] = lr
        state.optimizer.step()
    state.step += 1


def build_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                     group=None) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``; data-parallel
    over ``group`` (see the module docstring) when one is given.

    batch: query [B,N,3], positives [B,P,N,3], negatives [B,Ng,N,3],
    other_neg [B,N,3] (needed by the quadruplet losses), numpy or tensors.
    Metrics, 0-d fp32 tensors: ``loss``, ``best_pos_dist`` and
    ``min_neg_dist`` on the model's device (averaged over micro-batches);
    ``learning_rate`` and ``bn_momentum`` at the pre-increment step, host
    values on the CPU (a copy to the card would wait for it).
    ``model_cfg`` names the model the state holds."""
    del model_cfg  # the state holds the model; kept for the JAX signature
    loss_fn = losses_lib.get_loss(train_cfg.loss)
    quad = "quadruplet" in train_cfg.loss
    bn_mom, lr = bn_momentum_schedule(train_cfg), lr_schedule(train_cfg)
    accum, remat = train_cfg.grad_accum_steps, train_cfg.remat

    def micro_step(model, mb, mom):
        flat, b, p, ng = _flatten(mb, quad)
        with profile_region("train/forward"):
            desc = _train_forward(model, flat, mom, remat)
            loss, qd, pd, nd = _metric_loss(desc, b, p, ng, quad, loss_fn, train_cfg)
        _backward_and_commit(model, loss)
        with torch.no_grad():
            best = losses_lib.best_pos_distance(qd, pd).mean()
            min_neg = ((nd - qd[:, None]) ** 2).sum(-1).amin(-1).mean()
        return torch.stack([loss.detach(), best, min_neg])

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        batch = to_device(_local(batch, group), state.device)
        set_bn_group(state.model, group)
        step0 = state.step
        mom = bn_mom(step0)
        micros = [batch] if accum == 1 else _micro_batches(batch, accum)
        state.optimizer.zero_grad(set_to_none=True)
        vals = torch.stack([micro_step(state.model, mb, mom) for mb in micros]).mean(0)
        vals = _group_mean(vals, group)
        _apply_update(state, lr(step0), accum, group)
        return state, {"loss": vals[0], "learning_rate": torch.tensor(lr(step0)),
                       "bn_momentum": torch.tensor(mom), "best_pos_dist": vals[1],
                       "min_neg_dist": vals[2]}

    return step


def build_multi_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                           group=None) -> Callable:
    """``steps_per_dispatch``: ``multi(state, batches)`` over a [S, ...]
    stack of batches runs S single steps in order (the JAX ``lax.scan`` of
    the single step, which eager PyTorch has no reason to fuse) and returns
    the LAST step's metrics."""
    single = build_train_step(model_cfg, train_cfg, group)

    def multi(state: TrainState, batches) -> tuple[TrainState, dict]:
        s = len(batches["query"])
        m = None
        for i in range(s):
            state, m = single(state, {k: v[i] for k, v in batches.items() if k in TUPLE_KEYS})
        return state, m

    return multi


def build_distill_step(
    student_cfg: ModelConfig,
    teacher_cfg: ModelConfig,
    train_cfg: TrainConfig,
    alpha: float = 1.0,
    group=None,
) -> Callable:
    """EPC-Net-L distillation [PAPER §III-D]: metric loss + ``alpha`` x the
    feature-mimic MSE against the frozen teacher's descriptors of the same
    flattened clouds.

    Returns ``step(state, teacher, batch) -> (state, metrics)``: ``teacher``
    is a model (``get_model(teacher_cfg)`` with its weights), run in eval
    mode under ``torch.no_grad`` on the student's device; ``remat`` wraps
    the student's forward only. Metrics: ``loss``, ``metric_loss``,
    ``mimic_loss`` (0-d tensors, averaged over micro-batches). Data-parallel
    over ``group`` as ``build_train_step``."""
    del student_cfg, teacher_cfg  # the state and the teacher hold the models
    loss_fn = losses_lib.get_loss(train_cfg.loss)
    quad = "quadruplet" in train_cfg.loss
    bn_mom, lr = bn_momentum_schedule(train_cfg), lr_schedule(train_cfg)
    accum, remat = train_cfg.grad_accum_steps, train_cfg.remat

    def micro_step(model, teacher, mb, mom):
        flat, b, p, ng = _flatten(mb, quad)
        with profile_region("train/forward"):
            desc = _train_forward(model, flat, mom, remat)
            with torch.no_grad():
                t_desc = teacher(flat, train=False)
            mimic = losses_lib.distillation_loss(desc, t_desc)
            metric = _metric_loss(desc, b, p, ng, quad, loss_fn, train_cfg)[0]
            loss = metric + alpha * mimic
        _backward_and_commit(model, loss)
        return torch.stack([loss.detach(), metric.detach(), mimic.detach()])

    def step(state: TrainState, teacher: nn.Module, batch) -> tuple[TrainState, dict]:
        batch = to_device(_local(batch, group), state.device)
        set_bn_group(state.model, group)
        step0 = state.step
        mom = bn_mom(step0)
        micros = [batch] if accum == 1 else _micro_batches(batch, accum)
        state.optimizer.zero_grad(set_to_none=True)
        vals = _group_mean(torch.stack([micro_step(state.model, teacher, mb, mom)
                                        for mb in micros]).mean(0), group)
        _apply_update(state, lr(step0), accum, group)
        return state, {"loss": vals[0], "metric_loss": vals[1], "mimic_loss": vals[2]}

    return step


def model_embed_fn(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """``embed(points[B, N, 3]) -> [B, output_dim]`` with ``model`` as it
    stands (its current weights, running BN statistics) under
    ``torch.inference_mode``, on the model's device; ``points`` may be numpy
    or a tensor. Carries ``embed.model`` and ``embed.device``. Mining and
    the recall hook embed the training model through it."""
    dev = next(model.parameters()).device

    def embed(points) -> torch.Tensor:
        with torch.inference_mode():
            return model(torch.as_tensor(points, dtype=torch.float32, device=dev))

    embed.model = model
    embed.device = dev
    return embed


def build_embed_fn(
    model_cfg: ModelConfig,
    device: str | torch.device | None = None,
    variables: Mapping[str, np.ndarray] | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns ``embed(points[B, N, 3]) -> [B, output_dim]`` in inference mode
    (running BN stats), on ``device`` (the card unless ``"cpu"``).

    Weights come from ``variables`` (a ``flatten_variables`` dict, e.g. from
    ``weights.load_export``) or, when it is None, from
    ``init_flat_variables(model_cfg, seed=0)``. ``points`` may be a numpy array
    or a tensor; it is moved to the model's device. The returned function
    carries the model as ``embed.model`` and its device as ``embed.device``.
    """
    model = get_model(model_cfg, resolve_device(device))
    load_flat_variables(
        model, variables if variables is not None else init_flat_variables(model_cfg, seed=0)
    )
    return model_embed_fn(model)
