"""Meshes (counterpart of ``epcnet_tpu/parallel/mesh.py``).

Two kinds, chosen by what crosses the shards (``parallel/__init__.py``):

- ``Mesh``: one process over a ("data", "db") grid of ``torch.device``s, for
  retrieval, whose only cross-shard step is a merge of candidates;
- ``ProcessMesh``: the ("data", "db") grid of the ranks of a
  ``torch.distributed`` process group, one process a rank, for the model
  paths, whose collectives sit inside the forward and the backward.

``data_block`` and ``replicate_`` are the counterparts of JAX's
``data_sharding`` (``P("data")``: a block of the leading axis a rank) and
``replicated`` (one value on every rank).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from epcnet_torch.configs import MeshConfig
from epcnet_torch.device import resolve_device
from epcnet_torch.parallel.collectives import broadcast_


def local_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """Every visible device of ``device``'s type: the cards (the default;
    raises without one), or ``[cpu]``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid_shape(cfg: MeshConfig, n: int) -> tuple[int, int]:
    """(data, db) for ``n`` devices or ranks; data_axis=-1 takes every one
    the db axis leaves."""
    db = max(1, cfg.db_axis)
    data = cfg.data_axis if cfg.data_axis > 0 else n // db
    if data * db != n:
        raise ValueError(f"mesh {data}x{db} != {n} devices")
    return data, db


class Mesh:
    """A named [data, db] grid of ``torch.device``s in one process (the JAX
    ``Mesh``'s layout: row-major ``reshape(data, db)`` of the device list).
    A device may appear more than once: ``[cuda:0, cuda:0]`` shards over one
    card."""

    def __init__(self, grid: np.ndarray, axis_names=("data", "db")):
        if grid.ndim != len(axis_names):
            raise ValueError(f"grid of {grid.ndim} axes for names {axis_names}")
        self.grid = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.grid.shape))

    def devices(self, axis: str = "db") -> list[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis (where a
        sharded retrieval keeps its shards)."""
        ax = self.axis_names.index(axis)
        index = [0] * self.grid.ndim
        index[ax] = slice(None)
        return list(self.grid[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.grid.flat]})"


def make_mesh(cfg: MeshConfig | None = None, devices=None) -> Mesh:
    """The (data, db) mesh over ``devices`` (``torch.device``s or their
    names; default: every visible card). data_axis=-1 takes every device
    not used by the db axis."""
    cfg = cfg or MeshConfig()
    devs = local_devices() if devices is None else [torch.device(d) for d in devices]
    for d in devs:
        resolve_device(d)  # a card asked for without one raises
    data, db = _grid_shape(cfg, len(devs))
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(data, db), cfg.axis_names)


class ProcessMesh:
    """The (data, db) grid of a process group's ranks, row-major like JAX's
    ``reshape(data, db)``. Without a process group it is a world of one:
    both axes of size 1, and ``group`` gives None, which the collectives of
    ``parallel/collectives.py`` take as "no one else"."""

    def __init__(self, cfg: MeshConfig | None = None):
        cfg = cfg or MeshConfig()
        self.axis_names = tuple(cfg.axis_names)
        world = dist.get_world_size() if dist.is_initialized() else 1
        data, db = _grid_shape(cfg, world)
        self.shape = dict(zip(self.axis_names, (data, db)))
        self._mesh = None
        if dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh

            # the mesh's device type only says which backend its groups use
            dtype = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self._mesh = init_device_mesh(dtype, (data, db), mesh_dim_names=self.axis_names)

    def group(self, axis: str):
        """The process group along ``axis`` through this rank; None in a
        world of one."""
        return None if self._mesh is None else self._mesh.get_group(axis)

    @property
    def world(self):
        """The group of every rank; None in a world of one."""
        return None if self._mesh is None else dist.group.WORLD

    def rank(self, axis: str) -> int:
        return 0 if self._mesh is None else self._mesh.get_local_rank(axis)

    @property
    def primary(self) -> bool:
        return is_primary()


def is_primary() -> bool:
    """Rank 0 of the world (or no process group): the one process that logs
    and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def data_block(x, rank: int, size: int):
    """Rank ``rank``'s block of the leading axis of ``x`` split ``size`` ways
    (JAX's ``P("data")``: contiguous, equal blocks)."""
    n = x.shape[0]
    if n % size:
        raise ValueError(f"leading axis {n} does not split {size} ways")
    b = n // size
    return x[rank * b:(rank + 1) * b]


@torch.no_grad()
def replicate_(tensors, group) -> None:
    """Make ``tensors`` (an iterable of tensors, e.g. a module's
    ``state_dict().values()``) equal to the group's first rank's, in place:
    one value on every rank, as JAX's ``replicated``."""
    for t in tensors:
        broadcast_(t, group)
