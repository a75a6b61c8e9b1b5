"""The port's multi-device layer (counterpart of ``epcnet_tpu/parallel``).

JAX has one notion of a mesh: one controller over many devices, with
``shard_map`` / GSPMD. PyTorch has an idiom for each kind of path, and the
port uses the one that fits what crosses the shards:

- **Retrieval: one process over a list of devices** (``Mesh``,
  ``make_mesh``, ``make_multislice_mesh``). Sharded and ring top-k, a
  sharded ``PlaceIndex``, ``evaluate --mesh`` and ``serve --mesh``: each
  shard's work is independent, and the only cross-shard step is the merge
  of ``k * ndev`` candidates, copied to the first device. The devices may
  repeat: ``[cuda:0, cuda:0]`` shards over one card, ``["cpu"] * 8`` over
  the CPU.
- **Model paths: one process a rank over ``torch.distributed``**
  (``ProcessMesh``, ``maybe_initialize_distributed``). Data-parallel
  training with BatchNorm over the global batch, the ring kNN and the
  points-sharded EPC-Net have collectives in the middle of the forward and
  the backward (BN statistics, VLAD sums, the per-layer feature gather,
  the ring), so they run as SPMD ranks. The collectives are
  ``torch.autograd.Function``s in ``parallel/collectives.py``. Without a
  process group a ``ProcessMesh`` is a world of one.
"""

from epcnet_torch.parallel.mesh import (
    Mesh,
    ProcessMesh,
    data_block,
    local_devices,
    make_mesh,
    replicate_,
)
from epcnet_torch.parallel.multislice import (
    PreemptionGuard,
    make_multislice_mesh,
    maybe_initialize_distributed,
    retrieval_db_axis,
    slice_groups,
)

__all__ = [
    "Mesh",
    "ProcessMesh",
    "make_mesh",
    "data_block",
    "replicate_",
    "local_devices",
    "PreemptionGuard",
    "make_multislice_mesh",
    "maybe_initialize_distributed",
    "retrieval_db_axis",
    "slice_groups",
]
