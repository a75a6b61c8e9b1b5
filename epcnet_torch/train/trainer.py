"""The training loop (twin of ``epcnet_tpu/train/trainer.py``).

Epoch loop over shuffled tuples, hard-negative mining refreshes, the
learning-rate and BN-momentum schedules, checkpoints at a step cadence and
at every epoch end, JSONL metrics, and an exact resume at an epoch or in the
middle of one. Batches go to the card from pinned host memory while the
loader's threads assemble the next ones; the step returns its metrics as
tensors, which are read (a host sync) only where they are logged.

With ``mesh`` (a ``parallel.ProcessMesh``, one process a rank) training is
data-parallel over its "data" axis: every rank holds the replicated state
(broadcast from rank 0 at the start), loads the same global batches and
runs its block of each (``train/step.py``). Only rank 0 logs and writes
checkpoints, the other ranks waiting at a barrier; ``--restore`` reads on
every rank; the mining sweep is split over the ranks and gathered; a
preemption stops every rank at the same dispatch (an ``all_reduce`` MAX of
the local flags every 8 dispatches).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from epcnet_torch.configs import ExperimentConfig
from epcnet_torch.data.loader import TupleLoader
from epcnet_torch.data.tuples import TrainingTuples
from epcnet_torch.device import resolve_device
from epcnet_torch.parallel.collectives import all_reduce_, barrier, group_size
from epcnet_torch.parallel.mesh import replicate_
from epcnet_torch.train.checkpoint import CheckpointManager
from epcnet_torch.train.mining import MiningCache
from epcnet_torch.train.state import TrainState, create_train_state
from epcnet_torch.train.step import (
    TUPLE_KEYS,
    build_multi_train_step,
    build_train_step,
    model_embed_fn,
)
from epcnet_torch.utils.logging import MetricsLogger, log_string
from epcnet_torch.utils.profiling import profile_region

# dispatches between two preemption-consensus collectives
_POLL_EVERY = 8


class Trainer:
    def __init__(
        self,
        cfg: ExperimentConfig,
        tuples: TrainingTuples,
        mesh=None,
        checkpoints: bool = True,
        step_fn=None,
        metrics_name: str = "train",
        device: str | torch.device | None = None,
    ):
        """``step_fn``: an optional ``(state, batch) -> (state, metrics)``
        (e.g. a distillation step with the teacher bound) in place of the
        standard step; ``steps_per_dispatch`` applies to the standard step
        only (a custom step is built data-parallel by its caller).
        ``device``: the card unless ``"cpu"``; each rank's own with
        ``mesh``."""
        if "quadruplet" in cfg.train.loss and not cfg.data.use_other_neg:
            raise ValueError(
                f"train.loss={cfg.train.loss!r} needs the tuple's fourth element: set "
                "data.use_other_neg=true (or pick a triplet loss)")
        self.cfg = cfg
        self.tuples = tuples
        self.device = resolve_device(device)
        self.mesh = mesh
        group = None if mesh is None else mesh.group("data")
        self.world = None if mesh is None else mesh.world
        self.primary = mesh is None or mesh.primary
        self.state: TrainState = create_train_state(cfg.model, cfg.train, self.device)
        replicate_(self.state.model.state_dict().values(), self.world)
        self.step_fn = (step_fn if step_fn is not None
                        else build_train_step(cfg.model, cfg.train, group))
        self.multi_step_fn = (build_multi_train_step(cfg.model, cfg.train, group)
                              if cfg.train.steps_per_dispatch > 1 and step_fn is None else None)
        self.embed_fn = model_embed_fn(self.state.model)
        self.loader = TupleLoader(tuples, cfg.data, cfg.train.batch_num_queries,
                                  seed=cfg.train.seed)
        self.mining = MiningCache(tuples, cfg.data, cfg.train)
        self.metrics = MetricsLogger(cfg.log_dir, metrics_name,
                                     tensorboard=cfg.train.tensorboard, primary=self.primary)
        self.ckpt = (CheckpointManager(f"{cfg.log_dir}/ckpt", cfg.train.keep_checkpoints)
                     if checkpoints else None)

    # ------------------------------------------------------------------
    def _device_batch(self, batch: dict) -> dict:
        """The clouds on the training device: from pinned host memory,
        without waiting, when that is the card."""
        out = {}
        for k in TUPLE_KEYS:
            if k in batch:
                t = torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[k] = t
        return out

    def _dispatch(self, batches: list) -> dict:
        """Run len(batches) train steps; returns the last one's metrics."""
        if len(batches) == 1:
            self.state, m = self.step_fn(self.state, self._device_batch(batches[0]))
            return m
        stacked = {k: np.stack([b[k] for b in batches]) for k in TUPLE_KEYS
                   if k in batches[0]}
        self.state, m = self.multi_step_fn(self.state, self._device_batch(stacked))
        return m

    def maybe_restore(self) -> int:
        """Every rank reads the latest checkpoint."""
        if self.ckpt is not None:
            self.state = self.ckpt.restore(self.state)
        return self.state.step

    def save_checkpoint(self, manager: CheckpointManager) -> None:
        """Rank 0 writes; every rank leaves once the file is in place."""
        if self.primary:
            manager.save(self.state)
        barrier(self.world)

    def _mark_epoch(self, epoch: int) -> None:
        """Record (epoch, step at its start), so checkpoints carry the
        resume position."""
        self.state.epoch = epoch
        self.state.epoch_start_step = self.state.step

    def _refresh_mining(self) -> None:
        with profile_region("mining_refresh"):
            self.mining.refresh(self.state.model, self.world)

    # ------------------------------------------------------------------
    def train(self, on_epoch_end=None, should_stop=None) -> TrainState:
        """Epoch loop. After ``maybe_restore()`` it re-enters at the
        restored epoch, and the loader fast-forwards past the batches the
        interrupted epoch had consumed, from metadata alone (the order is
        (seed, epoch)-keyed), so a restarted run continues the
        uninterrupted one exactly: bit for bit at an epoch boundary; in the
        middle of an epoch the data order realigns while the mining cache is
        rebuilt from the current weights.

        ``should_stop`` (e.g. a ``parallel.PreemptionGuard``) is polled after
        every dispatch; when it fires, the loop checkpoints and returns."""
        cfg = self.cfg
        t_start = time.time()
        if should_stop is not None and group_size(self.world) > 1:
            should_stop = self._consensus(should_stop)
        clouds_per_tuple = (1 + cfg.data.num_positives + cfg.data.num_negatives
                            + (1 if cfg.data.use_other_neg else 0))
        start_epoch = self.state.epoch
        host_step = self.state.step
        resume_skip = host_step - self.state.epoch_start_step
        s_per = max(1, cfg.train.steps_per_dispatch) if self.multi_step_fn is not None else 1
        for epoch in range(start_epoch, cfg.train.max_epoch):
            skip = resume_skip if epoch == start_epoch else 0
            if skip == 0:
                self._mark_epoch(epoch)
            if epoch >= cfg.train.mining_start_epoch:
                self._refresh_mining()
                self.mining.attach(self.loader)
            n_steps = 0
            m = {"loss": float("nan")}  # stays if the epoch yields no batches
            t_epoch = time.time()

            def crossed(prev: int, cur: int, every: int) -> bool:
                # a multiple of `every` lies in (prev, cur]
                return cur // every > prev // every

            def post_dispatch(prev_step: int, step: int, metrics_m: dict) -> None:
                nonlocal m
                m = metrics_m
                if (epoch >= cfg.train.mining_start_epoch
                        and crossed(prev_step, step, cfg.train.mining_refresh_steps)):
                    self._refresh_mining()
                if crossed(prev_step, step, cfg.train.log_every_steps):
                    dt = time.time() - t_epoch
                    tput = n_steps * cfg.train.batch_num_queries * clouds_per_tuple / max(dt, 1e-9)
                    self.metrics.write(step, m, epoch=epoch, submaps_per_sec=round(tput, 2))
                if self.ckpt is not None and crossed(prev_step, step,
                                                     cfg.train.checkpoint_every_steps):
                    self.save_checkpoint(self.ckpt)

            preempted = False
            pending: list = []
            batches_seen = 0

            def run(group: list) -> bool:
                """Dispatch ``group``; True when a stop was requested."""
                nonlocal host_step, n_steps
                prev = host_step
                with profile_region("train_step"):
                    mm = self._dispatch(group)
                n_steps += len(group)
                host_step += len(group)
                post_dispatch(prev, host_step, mm)
                return should_stop is not None and should_stop()

            for batch in self.loader.epoch(epoch, skip_batches=skip):
                batches_seen += 1
                pending.append(batch)
                if len(pending) == s_per:
                    group, pending = pending, []
                    if run(group):
                        preempted = True
                        break
            if not preempted:
                for batch in pending:  # the epoch's tail: single steps
                    if run([batch]):
                        preempted = True
                        break
            if preempted:
                self.loader.stop()
                if self.ckpt is not None:
                    self.save_checkpoint(self.ckpt)
                self.metrics.flush()
                log_string(f"preemption requested: checkpointed at step {self.state.step} "
                           f"(epoch {epoch}) and stopping — resume with --restore")
                return self.state
            batches_seen += getattr(self.loader, "skipped_batches", 0)
            if n_steps:
                loss_txt = f"loss={float(m['loss']):.4f}"
            elif batches_seen:
                loss_txt = "no new batches (already consumed before restart)"
            else:
                loss_txt = ("0 usable tuples (check data.num_positives/"
                            "num_negatives vs the dataset's pools)")
            log_string(f"epoch {epoch}: {n_steps} steps, {loss_txt}, "
                       f"{time.time() - t_epoch:.1f}s")
            # advance the marker BEFORE saving: an epoch-boundary checkpoint
            # resumes straight into the next epoch
            self._mark_epoch(epoch + 1)
            if self.ckpt is not None:
                self.save_checkpoint(self.ckpt)
            if on_epoch_end is not None:
                on_epoch_end(self, epoch)
        log_string(f"training done in {time.time() - t_start:.1f}s")
        self.metrics.flush()
        return self.state

    def _consensus(self, local_stop):
        """``local_stop`` agreed over the ranks: signals reach ranks at
        different times, and a rank that stops one dispatch after the others
        would wait in a collective no one joins. Every ``_POLL_EVERY``
        dispatches the ranks take the MAX of their flags (the count advances
        alike on every rank, so the collectives match), and all stop at that
        dispatch."""
        state = {"calls": 0, "stop": False}

        def should_stop() -> bool:
            if state["stop"]:
                return True
            state["calls"] += 1
            if state["calls"] % _POLL_EVERY:
                return False
            flag = torch.tensor([float(local_stop())], device=self.device)
            state["stop"] = bool(all_reduce_(flag, self.world, dist.ReduceOp.MAX))
            return state["stop"]

        return should_stop
