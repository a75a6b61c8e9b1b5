"""Every collective of the port, in one module.

The model paths (data-parallel training with global-batch BatchNorm, the
ring kNN, the points-sharded EPC-Net) run one process a rank and call
these on a process group (``ProcessMesh.group``). ``group=None`` is a world
of one: no process group, nothing to exchange, every function the identity
(this differs from ``torch.distributed``, where None means the world).

``all_reduce_sum`` and ``all_gather`` are differentiable, as JAX's
``psum`` and ``all_gather`` are under autodiff: the backward of a sum over
ranks is the sum over ranks of the cotangents, and the backward of a
gather is that sum cut to the rank's own slice (``psum_scatter``).

Transport follows the backend, never a caught error: NCCL takes CUDA
tensors as they are; gloo runs ``all_reduce``, ``broadcast`` and
``all_gather`` on CUDA tensors itself (``GLOO_CUDA_OPS``: probed on an
H100 with torch 2.11, each op in processes of its own, values checked;
``scripts/multidevice.py::gloo_cuda_ops``) but not send/recv, which fails
("writev ... Bad address"), so the ring shift of a CUDA tensor over gloo is
staged through pinned host memory and copied back. The compute stays on
the card; only the transport differs. The first staging of each
collective is logged once a process.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from epcnet_torch.utils.logging import log_string

# the collectives gloo runs on CUDA tensors itself
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})
_staging_logged: set[str] = set()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group, op: str) -> bool:
    """True where ``op`` of ``t`` over ``group`` goes through host memory:
    a CUDA tensor over gloo, for a collective gloo does not take on CUDA."""
    stage = t.is_cuda and op not in GLOO_CUDA_OPS and dist.get_backend(group) == "gloo"
    if stage and op not in _staging_logged:
        _staging_logged.add(op)
        log_string(f"collectives: {op} of CUDA tensors over gloo goes through pinned "
                   "host memory")
    return stage


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place: ``t`` reduced over ``group``."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (differentiable)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (no gradient): summed
    gradients, the preemption flag's MAX."""
    return _all_reduce(t, group, op)


@torch.no_grad()
def broadcast_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` set to the group's first rank's value, in place."""
    if group is not None:
        dist.broadcast(t, dist.get_global_rank(group, 0), group=group)
    return t


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """[W, *x.shape]: every rank's ``x``, in group-rank order."""
    src = x.contiguous()
    staged = _staged(src, group, "all_gather")
    if staged:
        src = _host(src)
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.to(x.device) if staged else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g.contiguous().clone(), ctx.group)
        return g[group_rank(ctx.group)], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[W, *x.shape]: every rank's ``x`` stacked in group-rank order
    (differentiable; W = 1 without a group)."""
    if group is None:
        return x[None]
    return _AllGather.apply(x, group)


@torch.no_grad()
def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The ``x`` of the previous rank of the ring (rank r receives rank
    r - 1's and sends its own to r + 1): JAX's ``ppermute`` with the perm
    ``i -> i + 1``."""
    w = group_size(group)
    if w == 1:
        return x
    r = dist.get_rank(group)
    src = x.contiguous()
    staged = _staged(src, group, "send/recv")
    if staged:
        src = _host(src)
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, dist.get_global_rank(group, (r + 1) % w), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - 1) % w), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if staged else out


def barrier(group) -> None:
    """Wait for every rank of ``group`` (the other ranks wait while rank 0
    writes a checkpoint)."""
    if group is not None:
        dist.barrier(group=group)
