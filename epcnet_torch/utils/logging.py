"""Structured JSONL metrics and plain-text logging (twin of
``epcnet_tpu/utils/logging.py``): ``log_string`` prints a timestamped line
and appends it to an open log file; ``MetricsLogger`` writes one
``{"step": ..., "time": ..., metrics...}`` object per line."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


def log_string(msg: str, log_file=None) -> None:
    line = f"[{time.strftime('%H:%M:%S')}] {msg}"
    print(line, flush=True)
    if log_file is not None:
        log_file.write(line + "\n")
        log_file.flush()


class MetricsLogger:
    """JSONL metrics writer.

    ``tensorboard=True`` also mirrors every numeric metric as a TensorBoard
    scalar under ``<log_dir>/tb`` through ``torch.utils.tensorboard``; where
    no backend can be imported the logger degrades to JSONL with a logged
    notice, as the JAX logger does. A value that is a tensor is read here
    (``float``), so the train loop reads the card only where it logs.
    ``primary=False`` (every rank but 0 of a multi-process run) makes every
    write a no-op: ranks appending to one file would interleave lines."""

    def __init__(self, log_dir: str, name: str = "metrics", tensorboard: bool = False,
                 primary: bool = True):
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._f = self._tb = None
        if not primary:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(self.path, "a")
        self._name = name
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except ImportError as e:  # missing backend: degrade, don't fail
                log_string(f"tensorboard writer unavailable ({e!r}); JSONL only")

    def write(self, step: int, metrics: Mapping[str, Any], **extra) -> None:
        if self._f is None:
            return
        rec = {"step": int(step), "time": time.time(), **extra}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{self._name}/{k}", float(v), int(step))

    def flush(self) -> None:
        """A durability point (end of training, preemption): the JSONL file
        is flushed per write, the TensorBoard writer buffers."""
        if self._f is not None:
            self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
