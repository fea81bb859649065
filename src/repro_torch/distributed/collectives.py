"""The port's collective helper: ``all_reduce`` and ``all_gather`` over
one axis (or the data axes together) of a bound mesh.

Floating tensors travel as float32 (bf16 partial sums are added in
float32 and rounded once; a gather of bf16 values is exact either way),
and a group of one rank is never called.  A backend that lacks one of
these collectives for the tensors' device raises.  Nothing is copied to
the host here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.is_floating_point() else t


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum" or "max") of ``t`` over the ranks of ``axes``,
    returned in ``t``'s dtype (``t`` itself is not written)."""
    if mesh.axis_size(axes) == 1:
        return t
    buf = _wire(t).clone()
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group(axes))
    return buf.to(t.dtype)


def all_gather(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The ranks' ``t`` over ``axes`` concatenated along ``dim``, in the
    order of their coordinates along ``axes``."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    src = _wire(t).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.group(axes))
    return torch.cat(parts, dim=dim).to(t.dtype)
