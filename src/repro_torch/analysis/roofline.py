"""Roofline of one step counted on the meta device (port of
``repro.analysis.roofline``, with the parts that read XLA replaced).

Three terms per (arch x shape x mesh) cell, in seconds a step on one
card of the mesh:

  compute    = FLOPs_per_device / peak FLOP rate
  memory     = bytes_per_device / HBM rate
  collective = wire_bytes_per_device / NVLink rate

The rates are the datasheet figures of an NVIDIA H100 80GB HBM3 (SXM,
700 W): 989e12 bf16 dense FLOP/s, 3.35e12 B/s of HBM, 450e9 B/s of
NVLink in each direction and 80 GB a card (``core.hw.H100``).  They are
not measurements.  As the reference's ICI term does, the collective term
assumes a link between every pair of ranks at that rate, which a
256-rank mesh does not have (NVLink joins the cards of one host).

:func:`count_step` runs the step (one rank's program: a mesh from
``launch.mesh.simulate``) on meta tensors, which hold shapes and no
data, under three counters:

* ``torch.utils.flop_counter.FlopCounterMode``: the FLOPs of the aten
  products (mm, bmm, addmm, ...), every loop iteration counted;
* :class:`ByteCounter`, a ``TorchDispatchMode``: each op's tensor
  inputs and outputs, the counterpart of XLA's "bytes accessed" (views
  and allocations move nothing; a gather reads its indices and the rows
  it takes; a scatter writes as many bytes as its values), and the peak
  of the bytes held by tensors the step allocated (each storage counted
  from the op that made it until it is freed: a finalizer on the
  storage, which autograd's saved tensors keep alive);
* ``kernels.ops.counting``: the port's kernels by their formulas (on a
  meta tensor a kernel entry only returns empty outputs);

and ``distributed.collectives.recording``, which logs every collective
the simulated ranks' program issues.  XLA's ``cost_analysis`` counts a
loop body once; this count has no such undercount, so the reference's
``analytic_corrections`` have no counterpart here.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.hw import H100
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops as kops

#: NVIDIA H100 80GB HBM3 (SXM, 700 W) datasheet figures
PEAK_FLOPS = H100.peak_flops          # bf16 dense
HBM_BW = H100.hbm_bw_bytes
LINK_BW = H100.nvlink_bw_bytes        # per direction
HBM_GB = H100.hbm_gb


def ring_wire_bytes(op: str, payload: int, p: int) -> int:
    """Bytes a device moves for one collective of ``payload`` bytes over
    ``p`` ranks, on a ring (the reference's formulas; ``payload`` is the
    op's output as XLA states it: the gathered tensor of an all-gather,
    the scattered shard of a reduce-scatter).  ``broadcast``, the port's
    own: every rank but the source receives the payload once, so a
    device moves ``payload``."""
    p = max(2, p)
    if op == "all-reduce":
        return int(2 * (p - 1) / p * payload)
    if op == "all-gather":
        return int((p - 1) / p * payload)
    if op == "reduce-scatter":
        return int((p - 1) * payload)
    if op == "all-to-all":
        return int((p - 1) / p * payload)
    if op in ("collective-permute", "broadcast"):
        return payload
    raise ValueError(f"unknown collective {op!r}")


@dataclass
class CollectiveProfile:
    bytes_by_op: Dict[str, int] = field(default_factory=dict)
    wire_bytes: int = 0           # ring-schedule bytes per device
    count: int = 0

    def add(self, op: str, payload: int, wire: int):
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + payload
        self.wire_bytes += wire
        self.count += 1


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    hbm_bytes_per_device: float
    collective: CollectiveProfile
    memory_stats: Optional[dict] = None
    model_flops: Optional[float] = None   # 6*N*D (dense) / 6*N_active*D

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective.wire_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """The dominant term over the sum: 1.0 means one bottleneck
        perfectly overlapping the others."""
        tot = self.t_compute + self.t_memory + self.t_collective
        return max(self.t_compute, self.t_memory, self.t_collective) / tot \
            if tot else 0.0

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        if self.model_flops is None or not self.flops_per_device:
            return None
        return self.model_flops / self.n_devices / self.flops_per_device

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "devices": self.n_devices,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_wire_bytes": self.collective.wire_bytes,
            "collective_by_op": self.collective.bytes_by_op,
            "collective_count": self.collective.count,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "memory_stats": self.memory_stats,
        }


# ---------------------------------------------------------------------------
# Counting a step
# ---------------------------------------------------------------------------
_GATHERS = {"index", "embedding", "gather", "index_select"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "index_copy", "index_copy_", "index_add",
             "index_add_", "scatter_add", "scatter_add_"}
_VIEWS = {"_unsafe_view", "_reshape_alias", "lift_fresh"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() \
        if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _aliases(func) -> bool:
    """The op returns a view of (or writes into) an input."""
    return any(r.alias_info is not None for r in func._schema.returns)


class ByteCounter(TorchDispatchMode):
    """Bytes each aten op reads and writes, and the peak of the bytes
    held by the tensors ops allocated while it is active."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _VIEWS or name.startswith("empty") \
                or name.startswith("new_empty"):
            return out
        if _aliases(func) and name not in _SCATTERS \
                and not name.endswith("_"):
            return out                       # a view
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name in _GATHERS:
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            self.bytes += sum(map(_nbytes, idx)) + 2 * sum(map(_nbytes,
                                                                outs))
        elif name in _SCATTERS:
            vals = ins[-1] if len(ins) > 1 else ins[0]
            idx = [t for t in ins[1:-1] if not t.is_floating_point()]
            self.bytes += sum(map(_nbytes, idx)) + 2 * _nbytes(vals)
        else:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if not _aliases(func):
            for t in outs:
                self._hold(t)
        return out

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)


@dataclass
class StepCount:
    """What :func:`count_step` counted over one step."""
    aten_flops: float
    aten_bytes: float
    kernels: "kops.KernelWork"
    collectives: List["C.Issued"]
    peak_bytes: int                       # tensors the step allocated
    output_bytes: int                     # outputs not aliasing arguments
    alias_bytes: int                      # outputs in arguments' storage
    outputs: Any = None

    @property
    def flops(self) -> float:
        return self.aten_flops + self.kernels.total_flops

    @property
    def bytes(self) -> float:
        return self.aten_bytes + self.kernels.total_bytes


def count_step(fn: Callable, *args) -> StepCount:
    """Run ``fn(*args)`` once under the counters (``args`` on the meta
    device for a dry run; any device counts the same aten ops)."""
    arg_keys = {t.untyped_storage()._cdata for t in _tensors(args)}
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    with C.recording() as calls, kops.counting() as kwork, flops, nbytes:
        out = fn(*args)
    outs = _tensors(out)
    seen, out_b, alias_b = set(), 0, 0
    for t in outs:
        st = t.untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        if st._cdata in arg_keys:
            alias_b += st.nbytes()
        else:
            out_b += st.nbytes()
    return StepCount(float(flops.get_total_flops()), float(nbytes.bytes),
                     kwork, list(calls), nbytes.peak, out_b, alias_b, out)


# ---------------------------------------------------------------------------
# The reference's model FLOPs (copied)
# ---------------------------------------------------------------------------
def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for train;
    2*N_active*tokens for inference steps."""
    spec = cfg.nmp_spec()
    n_active = spec.active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch          # one token per request
    return 2.0 * n_active * tokens
