"""Points-sharded EPC-Net (counterpart of ``epcnet_tpu/models/points_sharded.py``):
ONE submap whose POINT axis is sharded over the ranks of a process group,
for clouds past one card's memory or to split one embed's time over cards.
The top rung of the capacity ladder (dense K1, packed K3 + K4, gather K2,
then this).

How each stage crosses the shard boundary (one process a rank,
``parallel/collectives.py``):

- kNN graph: ``ops/retrieval.py::ring_knn_local``; hop 0 (the rank's own
  block) is K2 on the card, the candidate blocks of the other ranks arrive
  around the ring; each rank ends with the exact global kNN ids of its
  rows.
- ProxyConv neighbour mean: one differentiable ``all_gather`` of the
  [T, nl, C] features a layer, then a gather of each row's k global rows
  and their fp32 mean: N·C values a layer where the dense row block would
  be N²/ndev.
- BatchNorm (train mode): [C] sums completed over the group
  (``DynamicBatchNorm(group=)``); VLAD: the partial residual sums and the
  assignment mass completed with one ``all_reduce_sum`` each
  (``vlad_aggregate(group=)``), so the descriptor is identical on every
  rank.
- Pad rows (N padded up to a multiple of the group size, coordinates at
  1e6) are masked out of VLAD and are never a real point's neighbour.

Inference runs BN on running statistics, so the sharded embed is the
single-device gather-route embed up to summation order. Training needs N
divisible by the group size (pad rows would enter the BN statistics).

Gradients: each rank differentiates the replicated loss through
collectives whose backward is a sum over ranks, so the sum of the ranks'
parameter gradients counts the loss once per rank; the steps average them
over the group (JAX's ``pmean``; the tests hold the result to JAX's
single-device gradients).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from epcnet_torch import losses as losses_lib
from epcnet_torch.configs import ModelConfig, TrainConfig
from epcnet_torch.device import resolve_device
from epcnet_torch.models.layers import ProxyConv, SharedMLP
from epcnet_torch.models.vlad_head import GVLADHead, compute_dtype
from epcnet_torch.ops.adjacency import gather_neighbor_mean
from epcnet_torch.ops.retrieval import ring_knn_local
from epcnet_torch.parallel.collectives import all_gather, group_rank, group_size
from epcnet_torch.train.state import TrainState, bn_momentum_schedule, lr_schedule, make_optimizer
from epcnet_torch.train.step import _apply_update, _backward_and_commit, average_grads
from epcnet_torch.weights import init_flat_variables, load_flat_variables


class _ShardEPCNet(nn.Module):
    """One rank's body: ``EPCNet``'s submodule tree and names
    (``proxyconv_{i}``, ``lift``, ``gvlad``), so its flat weights load
    verbatim, with every BN and the VLAD head completed over ``group``."""

    def __init__(self, cfg: ModelConfig, group=None):
        super().__init__()
        self.cfg = cfg
        self.group = group
        dtype = compute_dtype(cfg)
        in_ch = 3
        for i, ch in enumerate(cfg.proxyconv_channels):
            self.add_module(f"proxyconv_{i}",
                            ProxyConv(in_ch, ch, cfg.knn_k, dtype, bn_group=group))
            in_ch = ch
        self.lift = SharedMLP(sum(cfg.proxyconv_channels), cfg.lift_channels, dtype,
                              bn_group=group)
        self.gvlad = GVLADHead(cfg, group=group)

    def forward(self, xs: torch.Tensor, mask: torch.Tensor | None = None,
                train: bool = False, momentum=0.99) -> torch.Tensor:
        """xs: [nl, 3] this rank's rows of ONE cloud, or [T, nl, 3] of a
        tuple of T clouds (BN statistics span the whole tuple, as the dense
        step's flattened batch). mask: optional [nl] (1 real, 0 pad).
        Returns the [output_dim] (or [T, output_dim]) descriptor, the same
        on every rank."""
        k, w = self.cfg.knn_k, group_size(self.group)
        single = xs.dim() == 2
        if single:
            xs = xs[None]
        t, nl, _ = xs.shape
        with torch.no_grad():
            idx = torch.stack([ring_knn_local(xs[i], k, self.group)[0] for i in range(t)])
        f = xs.float().to(compute_dtype(self.cfg))
        scales = []
        for i in range(len(self.cfg.proxyconv_channels)):
            # every rank's rows in rank order: global row = rank * nl + row,
            # the ring kNN's ids
            full = all_gather(f, self.group).transpose(0, 1).reshape(t, w * nl, -1)
            proxy = gather_neighbor_mean(full, idx)
            f = getattr(self, f"proxyconv_{i}")(f, None, proxy=proxy, train=train,
                                                momentum=momentum)
            scales.append(f)
        f_lift = self.lift(torch.cat(scales, dim=-1), train, momentum)
        desc = self.gvlad(f_lift, mask=None if mask is None else mask.expand(t, nl),
                          train=train, momentum=momentum)
        return desc[0] if single else desc


def shard_model(cfg: ModelConfig, variables: Mapping[str, np.ndarray], group=None,
                device: str | torch.device | None = None) -> _ShardEPCNet:
    """A rank's ``_ShardEPCNet`` on ``device`` (the card unless ``"cpu"``)
    with a trained EPCNet's flat variables (``flatten_variables`` names)."""
    model = _ShardEPCNet(cfg, group).to(resolve_device(device)).eval()
    load_flat_variables(model, variables)
    return model


def _rank_block(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s ``axis`` (JAX's ``P(axis)``)."""
    nl = x.shape[axis] // group_size(group)
    return x.narrow(axis, group_rank(group) * nl, nl)


def _check_train_n(cfg: ModelConfig, n: int, group) -> None:
    w = group_size(group)
    if n % w:
        raise ValueError(f"points-sharded training needs N divisible by the {w} ranks, "
                         f"got N={n} (drop {n % w} points)")
    if cfg.knn_k > n // w:
        raise ValueError(f"knn_k={cfg.knn_k} exceeds points-per-shard {n // w}")


def embed_points_sharded(variables: Mapping[str, np.ndarray], points, cfg: ModelConfig,
                         mesh, axis: str = "db", npad_multiple: int = 1,
                         device: str | torch.device | None = None) -> torch.Tensor:
    """Embed ONE [N, 3] submap (numpy or a tensor, whole on every rank) with
    its point axis sharded over ``mesh``'s ``axis`` (a
    ``parallel.ProcessMesh``; a world of one without a process group).
    ``variables`` are a trained EPCNet's. N is padded to a multiple of the
    group size times ``npad_multiple`` (pad rows are masked: the descriptor
    does not depend on it). Returns the [output_dim] fp32 L2-normalised
    descriptor on every rank, on ``device`` (the card unless ``"cpu"``)."""
    group = mesh.group(axis)
    w = group_size(group)
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n = pts.shape[0]
    q = w * max(1, npad_multiple)
    npad = -(-n // q) * q
    if cfg.knn_k > npad // w:
        raise ValueError(f"knn_k={cfg.knn_k} exceeds points-per-shard {npad // w} "
                         f"(N={n} over {w} ranks)")
    if n < cfg.knn_k:
        raise ValueError(f"need at least knn_k={cfg.knn_k} points, got {n}")
    xp = torch.cat([pts, torch.full((npad - n, 3), 1e6, device=dev)])
    mask = (torch.arange(npad, device=dev) < n).float()
    model = shard_model(cfg, variables, group, dev)
    with torch.inference_mode():
        return model(_rank_block(xp, group), _rank_block(mask, group))


def build_points_sharded_distill_fn(cfg: ModelConfig, mesh, axis: str = "db",
                                    remat: bool = False):
    """Gradient step for giant-submap distillation: the student embeds one
    points-sharded cloud and mimics a teacher descriptor
    (``losses.distillation_loss``).

    Returns ``fn(model, points [N, 3], teacher_desc [output_dim],
    momentum=0.99) -> loss``: ``model`` is a ``_ShardEPCNet`` on ``mesh``'s
    ``axis`` group (``shard_model``); afterwards each parameter's ``.grad``
    holds the full gradient (averaged over the ranks, the same on every
    rank) for any optimiser, and the BN running statistics are updated.
    ``remat``: ``torch.utils.checkpoint`` the forward, which the backward
    runs again (its collectives included) instead of keeping activations:
    the same values."""
    group = mesh.group(axis)

    def step(model: _ShardEPCNet, points, teacher_desc, momentum=0.99) -> torch.Tensor:
        dev = next(model.parameters()).device
        pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
        _check_train_n(cfg, pts.shape[0], group)
        xs = _rank_block(pts, group)
        target = torch.as_tensor(teacher_desc, dtype=torch.float32, device=dev)
        model.zero_grad(set_to_none=True)
        if remat:
            desc = torch.utils.checkpoint.checkpoint(
                lambda x: model(x, None, True, momentum), xs, use_reentrant=False)
        else:
            desc = model(xs, None, True, momentum)
        loss = losses_lib.distillation_loss(desc, target)
        _backward_and_commit(model, loss)
        average_grads(model, group)
        return loss.detach()

    return step


def points_sharded_train_state(cfg: ModelConfig, train_cfg: TrainConfig, mesh,
                               axis: str = "db", device: str | torch.device | None = None,
                               variables=None) -> TrainState:
    """A ``TrainState`` whose model is a ``_ShardEPCNet`` on ``mesh``'s
    ``axis`` group, with ``variables`` (else ``init_flat_variables(cfg,
    train_cfg.seed)``, as ``create_train_state``) and its optimiser."""
    flat = variables if variables is not None else init_flat_variables(cfg, train_cfg.seed)
    model = shard_model(cfg, flat, mesh.group(axis), device)
    return TrainState(model=model, optimizer=make_optimizer(train_cfg, model.parameters()))


def build_points_sharded_train_step(cfg: ModelConfig, train_cfg: TrainConfig, mesh,
                                    axis: str = "db"):
    """The metric-learning step on ONE giant-submap tuple, the dense step's
    contract except that the batch has no leading B axis: ``query`` [N, 3],
    ``positives`` [P, N, 3], ``negatives`` [Ng, N, 3] and, for quadruplet
    losses, ``other_neg`` [N, 3]. All clouds go through the shard body
    together, so BN statistics span the whole tuple. ``state`` comes from
    ``points_sharded_train_state``. Returns ``step(state, batch) -> (state,
    metrics)``; N must be divisible by the group size."""
    if train_cfg.grad_accum_steps != 1:
        raise ValueError("grad_accum_steps does not apply to the points-sharded step "
                         "(one tuple per optimizer step: there is no batch axis to split; "
                         "use train.remat or more ranks on the point axis)")
    group = mesh.group(axis)
    loss_fn = losses_lib.get_loss(train_cfg.loss)
    quad = "quadruplet" in train_cfg.loss
    bn_mom, lr = bn_momentum_schedule(train_cfg), lr_schedule(train_cfg)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        dev = state.device
        b = {key: torch.as_tensor(batch[key], dtype=torch.float32, device=dev)
             for key in ("query", "positives", "negatives", "other_neg") if key in batch}
        _check_train_n(cfg, b["query"].shape[0], group)
        parts = [b["query"][None], b["positives"], b["negatives"]]
        if quad:
            parts.append(b["other_neg"][None])
        clouds = _rank_block(torch.cat(parts), group, axis=1)  # [T, nl, 3]
        p, ng = b["positives"].shape[0], b["negatives"].shape[0]
        step0, mom = state.step, bn_mom(state.step)
        model = state.model
        state.optimizer.zero_grad(set_to_none=True)
        if train_cfg.remat:
            desc = torch.utils.checkpoint.checkpoint(
                lambda x: model(x, None, True, mom), clouds, use_reentrant=False)
        else:
            desc = model(clouds, None, True, mom)
        qd, pd, nd = desc[0][None], desc[1:1 + p][None], desc[1 + p:1 + p + ng][None]
        if quad:
            loss = loss_fn(qd, pd, nd, desc[-1][None], train_cfg.margin_1, train_cfg.margin_2)
        else:
            loss = loss_fn(qd, pd, nd, train_cfg.margin_1)
        _backward_and_commit(model, loss)
        _apply_update(state, lr(step0), 1, group)
        with torch.no_grad():
            best = losses_lib.best_pos_distance(qd, pd).mean()
            min_neg = ((nd - qd[:, None]) ** 2).sum(-1).amin(-1).mean()
        return state, {"loss": loss.detach(), "learning_rate": torch.tensor(lr(state.step)),
                       "bn_momentum": torch.tensor(bn_mom(state.step)),
                       "best_pos_dist": best, "min_neg_dist": min_neg}

    return step
