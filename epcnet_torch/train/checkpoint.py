"""Checkpoints of the port's training (counterpart of
``epcnet_tpu/train/checkpoint.py``, in the port's own format: an Orbax
checkpoint cannot be read without JAX).

One ``torch.save`` file per step, ``<directory>/step_<step>.pt``, holding the
step, epoch, ``epoch_start_step``, the model's ``state_dict`` (parameters
and BN running statistics) and the optimiser's ``state_dict`` (moments and
counts), all on the CPU. A file is written to a temporary name and moved
into place with ``os.replace``, so a reader never sees half a checkpoint;
the ``keep`` newest are kept. The mining cache is rebuilt after a restore
(derived state), and the data order is (seed, epoch)-keyed, so these files
alone make a resume exact. Weights leave for the JAX package only through
the flat export (``cli/export.py``).
"""

from __future__ import annotations

import os
import re

import torch

from epcnet_torch.train.state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> None:
        """Write ``state`` at its step; a step already saved is skipped
        (e.g. an epoch boundary that is also a step multiple)."""
        step = int(state.step)
        if step in self.all_steps():
            return
        payload = {
            "step": step,
            "epoch": int(state.epoch),
            "epoch_start_step": int(state.epoch_start_step),
            "model": _to_cpu(state.model.state_dict()),
            "optimizer": _to_cpu(state.optimizer.state_dict()),
        }
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.keep]:
            os.remove(self._path(old))

    def restore(self, state: TrainState, require: bool = False) -> TrainState:
        """Load the latest checkpoint into ``state`` (its model and optimiser
        in place, on their device) and return it. With no checkpoint:
        ``FileNotFoundError`` if ``require`` (evaluating, distilling or
        serving from random weights would be a silent failure), else
        ``state`` unchanged."""
        step = self.latest_step()
        if step is None:
            if require:
                raise FileNotFoundError(
                    f"no checkpoint found under {self.directory} — "
                    "check the --log_dir / --teacher_log_dir path")
            return state
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.epoch = int(payload["epoch"])
        state.epoch_start_step = int(payload["epoch_start_step"])
        return state

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight. The recall hook
        returns it as its ``finalize``, where the JAX manager's
        asynchronous saves need a wait."""
