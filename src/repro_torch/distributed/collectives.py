"""The port's collectives over one axis (or the data axes together) of a
bound mesh, as operations autograd can see.

Tensor parallelism (Megatron's conjugate pairs; every activation outside
a sharded product is replicated over "model"):

* :func:`all_reduce` sum: forward sums the ranks' partials, backward is
  the identity (the output's gradient is replicated);
* :func:`copy_to`: the input of a column-parallel product, forward the
  identity, backward sums the ranks' partial gradients;
* :func:`all_gather`: forward gathers the ranks' slices, backward takes
  this rank's slice of the (replicated) gradient;
* :func:`split`: this rank's slice of a replicated tensor, backward
  gathers the slices' gradients.

FSDP, where each data rank's consumers differ (its own rows):

* :func:`gather_shards`: forward gathers, backward sums over the ranks
  and keeps this rank's slice (a reduce-scatter);
* :func:`broadcast`: one rank's tensor to all, backward sums the
  gradients on that rank.

With autograd off (serving) each op issues exactly its forward.  Floating
tensors travel as float32 (bf16 partial sums are added in float32 and
rounded once; a gather of bf16 values is exact either way), and a group
of one rank is never called.  A backend that lacks one of these
collectives for the tensors' device raises.  Nothing is copied to the
host here.

Under :func:`recording` every collective issued is logged as an
:class:`Issued` record: its op, the bytes that travel (the float32 wire
form of a floating tensor; an all-gather's gathered output, as XLA's
HLO states it), the group's size, the call site (the public function,
or its ``.backward``) and the bytes the tensor holds in its own dtype.
Over a mesh from ``launch.mesh.simulate`` (stand-in groups) nothing is
sent: each op logs itself and returns a tensor of the right shape and
dtype on the input's device (meta included), built by the same aten
ops as the real path minus the exchange.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import SimGroup

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass(frozen=True)
class Issued:
    op: str             # "all-reduce" | "all-gather" | "broadcast"
    nbytes: int         # payload on the wire
    group: int          # ranks in the group
    site: str           # e.g. "all_reduce", "gather_shards.backward"
    dtype_nbytes: int   # the payload in the tensor's own dtype


_CALLS: List[Optional[List[Issued]]] = [None]


@contextlib.contextmanager
def recording():
    """Log every collective the process issues in the block (autograd's
    backward threads included) into the yielded list."""
    calls: List[Issued] = []
    prev, _CALLS[0] = _CALLS[0], calls
    try:
        yield calls
    finally:
        _CALLS[0] = prev


def _record(op: str, t: torch.Tensor, factor: int, group: int,
            site: str) -> None:
    calls = _CALLS[0]
    if calls is not None:
        n = t.numel() * factor
        calls.append(Issued(op, n * _wire_size(t), group, site,
                            n * t.element_size()))


def _wire_size(t: torch.Tensor) -> int:
    return 4 if t.is_floating_point() else t.element_size()


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.is_floating_point() else t


def _records(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _reduce(t: torch.Tensor, mesh, axes, op: str,
            site: str = "all_reduce") -> torch.Tensor:
    group = mesh.group(axes)
    buf = _wire(t).clone()
    _record("all-reduce", t, 1, mesh.axis_size(axes), site)
    if not isinstance(group, SimGroup):
        dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(t.dtype)


def _gather(t: torch.Tensor, mesh, axes, dim: int,
            site: str = "all_gather") -> torch.Tensor:
    group, n = mesh.group(axes), mesh.axis_size(axes)
    src = _wire(t).contiguous()
    _record("all-gather", t, n, n, site)
    if isinstance(group, SimGroup):
        parts = [src] * n
    else:
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.dtype)


def _slice(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    part = t.shape[dim] // mesh.axis_size(axes)
    return t.narrow(dim, mesh.coord(axes) * part, part)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return _reduce(t, mesh, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (_reduce(g, ctx.mesh, ctx.axes, "sum", "copy_to.backward"),
                None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_slice(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None,
                None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _slice(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_gather(g, ctx.mesh, ctx.axes, ctx.dim, "split.backward"),
                None, None, None)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(t, mesh, axes, dim, "gather_shards")

    @staticmethod
    def backward(ctx, g):
        g = _reduce(g, ctx.mesh, ctx.axes, "sum", "gather_shards.backward")
        return (_slice(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None,
                None, None)


def _bcast(t: torch.Tensor, mesh, axes, src: int) -> torch.Tensor:
    """``t`` of the rank at coordinate ``src`` along ``axes`` (every rank
    passes a tensor of its shape and dtype)."""
    group = mesh.group(axes)
    _record("broadcast", t, 1, mesh.axis_size(axes), "broadcast")
    if isinstance(group, SimGroup):
        return _wire(t).clone().to(t.dtype)
    buf = _wire(t).clone() if mesh.coord(axes) == src else \
        torch.empty(t.shape, dtype=_wire(t).dtype, device=t.device)
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(t.dtype)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, src):
        ctx.mesh, ctx.axes, ctx.src = mesh, axes, src
        return _bcast(t, mesh, axes, src)

    @staticmethod
    def backward(ctx, g):
        g = _reduce(g, ctx.mesh, ctx.axes, "sum", "broadcast.backward")
        mine = ctx.mesh.coord(ctx.axes) == ctx.src
        return (g if mine else None), None, None, None


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum" or "max") of ``t`` over the ranks of ``axes``,
    returned in ``t``'s dtype (``t`` itself is not written).  A sum's
    gradient is the identity; a max is not differentiated (it feeds a
    stabiliser, or takes detached values)."""
    if mesh.axis_size(axes) == 1:
        return t
    if op == "sum" and _records(t):
        return _AllReduce.apply(t, mesh, axes)
    return _reduce(t.detach() if op == "max" else t, mesh, axes, op)


def copy_to(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` unchanged; in backward its gradient is summed over ``axes``
    (the replicated input of a column-parallel product)."""
    if mesh.axis_size(axes) == 1 or not _records(t):
        return t
    return _CopyTo.apply(t, mesh, axes)


def all_gather(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The ranks' ``t`` over ``axes`` concatenated along ``dim``, in the
    order of their coordinates along ``axes``; backward keeps this rank's
    slice of the gradient."""
    if mesh.axis_size(axes) == 1:
        return t
    if _records(t):
        return _AllGather.apply(t, mesh, axes, dim)
    return _gather(t, mesh, axes, dim)


def split(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``t`` (replicated over
    ``axes``); backward gathers the slices' gradients."""
    if mesh.axis_size(axes) == 1:
        return t
    if _records(t):
        return _Split.apply(t, mesh, axes, dim)
    return _slice(t, mesh, axes, dim)


def gather_shards(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The ranks' shards of one tensor gathered along ``dim``; backward
    sums the gradient over ``axes`` and keeps this rank's slice."""
    if mesh.axis_size(axes) == 1:
        return t
    if _records(t):
        return _GatherShards.apply(t, mesh, axes, dim)
    return _gather(t, mesh, axes, dim, "gather_shards")


def broadcast(t: torch.Tensor, mesh, axes, src: int) -> torch.Tensor:
    """The tensor of the rank at coordinate ``src`` along ``axes``;
    backward sums the gradient over ``axes`` into that rank's ``t`` (the
    others' ``t`` get none)."""
    if mesh.axis_size(axes) == 1:
        return t
    if _records(t):
        return _Broadcast.apply(t, mesh, axes, src)
    return _bcast(t, mesh, axes, src)
