"""Meshes: named axes over ranks (port of ``repro.launch.mesh``).

A :class:`Mesh` is first a description: its ordered axes and their
sizes.  The sharding rules and the planner read only that
(``mesh.shape`` / ``mesh.axis_names``, as the reference's rules read a
JAX mesh).  :func:`bind` attaches it to an initialised process group of
the same size: a ``torch.distributed.device_mesh.DeviceMesh`` with the
same named dimensions, one process group per axis (and one over the
data axes together, and the world over all of them), and this rank's
coordinate on each axis.  Nothing
here initialises ``torch.distributed``: the caller does that, with its
own address, world size and rank.

:func:`simulate` gives a mesh whose groups are stand-ins: the step runs
one rank's program (its coordinates), and each collective is recorded
by ``distributed.collectives`` instead of sent, so a cell's traffic can
be counted with no process group (``launch.dryrun``).

The batch shards over ("pod", "data"); tensor, expert and sequence
parallelism over "model".
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np

Axes = Union[str, Tuple[str, ...]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return axes if isinstance(axes, tuple) else (axes,)


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; after :func:`bind`, also the live groups."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device_mesh: Any = field(default=None, compare=False, repr=False)
    groups: Dict[Tuple[str, ...], Any] = field(default=None, compare=False,
                                               repr=False)
    coords: Dict[str, int] = field(default=None, compare=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) \
                or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} do not match one to one")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def bound(self) -> bool:
        return self.groups is not None

    def axis_size(self, axes: Axes) -> int:
        shape = self.shape
        return math.prod(shape[a] for a in _axes(axes))

    def coord(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (row-major over them, in the
        order given, as a ``PartitionSpec`` entry orders its axes)."""
        self._require_bound()
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: Axes):
        """The process group over ``axes`` that holds this rank."""
        self._require_bound()
        key = tuple(a for a in self.axis_names if a in _axes(axes))
        if key != _axes(axes):
            raise ValueError(f"axes {axes} are not in mesh order "
                             f"{self.axis_names}")
        return self.groups[key]

    def _require_bound(self):
        if not self.bound:
            raise RuntimeError("the mesh is a description only; bind() it "
                               "to an initialised process group first")


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """An arbitrary mesh description."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes as descriptions: 16x16 = 256
    chips per pod; ``multi_pod`` stacks 2 pods = 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def data_axes(mesh) -> tuple:
    """Axes over which the batch dimension shards."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    if "model" not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no 'model'")
    return "model"


def _rank_grid(mesh: Mesh) -> np.ndarray:
    return np.arange(mesh.size).reshape(mesh.sizes)


def _subgroups(dist, mesh: Mesh, axes: Tuple[str, ...], rank: int):
    """Create (collectively, on every rank) the groups spanning ``axes``
    and return the one holding ``rank``."""
    idx = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.sizes)) if i not in idx]
    rows = np.transpose(_rank_grid(mesh), rest + idx).reshape(
        -1, math.prod(mesh.sizes[i] for i in idx))
    mine = None
    for row in rows:
        g = dist.new_group(ranks=[int(r) for r in row])
        if rank in row:
            mine = g
    return mine


def bind(mesh: Mesh, device_type: str) -> Mesh:
    """``mesh`` attached to the initialised default process group, whose
    world size must equal ``mesh.size``.  Every rank calls it, in the
    same order (it creates process groups).  ``device_type`` is the
    ``DeviceMesh``'s (``"cuda"`` or ``"cpu"``, the ranks' tensors').
    """
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("bind() needs torch.distributed initialised "
                           "(init_process_group with an address, world "
                           "size and rank)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != mesh.size:
        raise ValueError(f"mesh {mesh.shape} has {mesh.size} ranks; the "
                         f"process group has {world}")
    dm = DeviceMesh(device_type, torch.from_numpy(_rank_grid(mesh)),
                    mesh_dim_names=mesh.axis_names)
    groups = {(a,): dm.get_group(a) for a in mesh.axis_names}
    daxes = data_axes(mesh)
    if len(daxes) > 1:
        groups[daxes] = _subgroups(dist, mesh, daxes, rank)
    if len(mesh.axis_names) > 1:        # a leaf cut over every axis
        groups[mesh.axis_names] = dist.group.WORLD
    coords = dict(zip(mesh.axis_names, dm.get_coordinate()))
    return replace(mesh, device_mesh=dm, groups=groups, coords=coords)


@dataclass(frozen=True)
class SimGroup:
    """A stand-in process group of ``size`` ranks (:func:`simulate`):
    ``distributed.collectives`` records a call over it and sends
    nothing."""
    size: int


def simulate(mesh: Mesh, rank: int = 0) -> Mesh:
    """``mesh`` as rank ``rank`` would hold it after :func:`bind`, with
    :class:`SimGroup` stand-ins for its process groups: the step runs
    that rank's program and every collective is recorded (shapes right,
    values not exchanged).  Needs no process group and no socket."""
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} outside a mesh of {mesh.size}")
    coords = dict(zip(mesh.axis_names,
                      (int(c) for c in np.unravel_index(rank, mesh.sizes))))
    keys = [(a,) for a in mesh.axis_names]
    daxes = data_axes(mesh)
    if len(daxes) > 1:
        keys.append(daxes)
    if len(mesh.axis_names) > 1:
        keys.append(mesh.axis_names)
    groups = {k: SimGroup(mesh.axis_size(k)) for k in keys}
    return replace(mesh, groups=groups, coords=coords)
