"""Multi-slice meshes, the process-group bootstrap and preemption safety
(counterpart of ``epcnet_tpu/parallel/multislice.py``).

- ``maybe_initialize_distributed``: one-call ``torch.distributed`` bootstrap
  for a run of one process a rank, from the JAX package's ``EPCNET_*``
  variables; a no-op when nothing is configured, so every CLI calls it
  unconditionally, before any CUDA work.
- ``make_multislice_mesh``: the ("data", "db") device mesh with the data
  axis slice-major and the db axis inside one slice. A slice is a host:
  the devices one process sees are one slice unless a ``slice_index_fn``
  says otherwise (the tests inject one).
- ``PreemptionGuard``: SIGTERM/SIGINT -> a cooperative stop flag.
"""

from __future__ import annotations

import datetime
import os
import signal

import numpy as np
import torch
import torch.distributed as dist

from epcnet_torch.configs import MeshConfig
from epcnet_torch.device import resolve_device
from epcnet_torch.parallel.mesh import Mesh, local_devices, make_mesh


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; an address with a scheme
    (``tcp://``, ``file://``) is taken as it is."""
    return address if "://" in address else f"tcp://{address}"


def maybe_initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
) -> bool:
    """Initialise the default process group when a multi-process run is
    asked for.

    Arguments fall back to ``EPCNET_COORDINATOR_ADDRESS`` (``host:port``, or
    a ``tcp://`` / ``file://`` init method) / ``EPCNET_NUM_PROCESSES`` /
    ``EPCNET_PROCESS_ID``. ``EPCNET_DISTRIBUTED=1`` alone initialises from
    torch's own environment (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``, as
    ``torchrun`` sets them). Nothing configured, or one process with no
    coordinator: a no-op (returns False). The backend follows ``device``:
    NCCL on the card (the default; each rank takes card ``rank % count``),
    gloo with ``"cpu"``. Returns True iff a process group is up (an
    existing one is kept).
    """
    dev = resolve_device(device)
    if dist.is_initialized():  # a caller in the same process set it up
        return True
    coordinator_address = coordinator_address or os.environ.get("EPCNET_COORDINATOR_ADDRESS")
    if num_processes is None:
        raw = os.environ.get("EPCNET_NUM_PROCESSES")
        num_processes = int(raw) if raw else None
    if process_id is None:
        raw = os.environ.get("EPCNET_PROCESS_ID")
        process_id = int(raw) if raw else None
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None and num_processes in (None, 1):
        if os.environ.get("EPCNET_DISTRIBUTED", "") not in ("1", "true", "auto"):
            return False
        kwargs = {}  # torch's env:// defaults
    else:
        kwargs = dict(init_method=_init_method(coordinator_address),
                      world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, timeout=datetime.timedelta(minutes=10), **kwargs)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return True


def _slice_index(d) -> int:
    """A ``torch.device`` is on this process's host: one slice."""
    return getattr(d, "slice_index", None) or 0


def slice_groups(devices, slice_index_fn=None) -> list[list]:
    """Devices grouped by slice, slice-index-sorted; ``slice_index_fn``
    injects a synthetic assignment (tests)."""
    fn = slice_index_fn or _slice_index
    groups: dict[int, list] = {}
    for d in devices:
        groups.setdefault(fn(d), []).append(d)
    return [groups[k] for k in sorted(groups)]


def retrieval_db_axis(devices=None, slice_index_fn=None) -> int:
    """Largest valid "db" axis for a retrieval mesh: the devices of one
    slice (the db axis stays inside a slice; ``make_multislice_mesh``
    raises otherwise). Default devices: every visible card."""
    devices = list(devices) if devices is not None else local_devices()
    return len(slice_groups(devices, slice_index_fn)[0])


def make_multislice_mesh(cfg: MeshConfig | None = None, devices=None,
                         slice_index_fn=None) -> Mesh:
    """("data", "db") mesh whose data axis is slice-major: each slice
    contributes a contiguous [per_slice_data, db] block, stacked along the
    data axis; the db axis never crosses slices. One slice: ``make_mesh``."""
    cfg = cfg or MeshConfig()
    devices = list(devices) if devices is not None else local_devices()
    groups = slice_groups(devices, slice_index_fn)
    if len(groups) == 1:
        return make_mesh(cfg, devices)
    per = len(groups[0])
    if any(len(g) != per for g in groups):
        raise ValueError(f"unequal devices per slice: {[len(g) for g in groups]}")
    db = max(1, cfg.db_axis)
    if per % db != 0:
        raise ValueError(f"db axis {db} does not divide per-slice count {per}")
    if cfg.data_axis > 0 and cfg.data_axis != len(groups) * (per // db):
        raise ValueError(f"data_axis={cfg.data_axis} != {len(groups)} slices x {per // db}")

    def block(g):
        arr = np.empty(len(g), dtype=object)
        arr[:] = g
        return arr.reshape(per // db, db)

    return Mesh(np.concatenate([block(g) for g in groups]), cfg.axis_names)


class PreemptionGuard:
    """Turn SIGTERM/SIGINT into a cooperative stop flag.

    A preemption delivers SIGTERM with a grace window; the guard records the
    request and the Trainer (polling ``guard()`` after each dispatch) saves
    a checkpoint and returns instead of dying mid-step. The context manager
    restores the previous handlers on exit; the guard is also the
    ``should_stop`` callable itself.

    The SECOND signal aborts hard (KeyboardInterrupt): the flag is polled
    only between steps, so a run stuck before its first step (a kernel
    build) must stay interruptible: one Ctrl+C means "checkpoint then
    stop", two mean "stop now".
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._old: dict = {}
        self.requested = False

    def _handle(self, signum, frame):
        if self.requested:
            raise KeyboardInterrupt  # second signal: abort hard
        self.requested = True
        print("[preemption] will checkpoint after the in-flight step and stop; "
              "signal again to abort immediately", flush=True)

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> bool:
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()
        return False

    def __call__(self) -> bool:
        return self.requested
