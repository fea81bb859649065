"""Public entry points of the port's kernels (port of
``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel (or the wrapper raises);
a CPU tensor runs the plain PyTorch version.  Nothing falls back from
one to the other.  A meta tensor (``launch.dryrun``) runs neither: the
entry returns empty outputs of the right shape, dtype and device.

Under :func:`counting` each call adds its kernel's work, from the
formula beside its entry (``_*_work``), to the yielded
:class:`KernelWork`: the same work ``chip_smoke.py``'s ``bound_ms``
reckons (every input read once, every output written once, the
products' FLOPs), except that an attention entry counts its whole
window (every cached position, as a full cell's cache holds), where on
a card the kernel stops at ``lengths[b]``.  The entry itself then runs
with the dispatch modes above it switched off, so a counter of aten ops
(``FlopCounterMode``) sees the kernel's share only through the formula,
on every device.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref
from repro_torch.kernels import snake_gemm as sg
from repro_torch.kernels import wkv6 as wk

#: every kernel wrapper's launch counts (each module's ``LAUNCHES``; the
#: dicts are reset in place, so these references stay valid)
LAUNCH_COUNTS = (fd.LAUNCHES, sg.LAUNCHES, wk.LAUNCHES)


@dataclass
class KernelWork:
    """Calls, FLOPs and bytes of the kernel entries called under
    :func:`counting`, by entry name."""
    calls: Dict[str, int] = field(default_factory=dict)
    flops: Dict[str, float] = field(default_factory=dict)
    bytes: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.flops[name] = self.flops.get(name, 0.0) + flops
        self.bytes[name] = self.bytes.get(name, 0.0) + nbytes

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())


_COUNTER: List[Optional[KernelWork]] = [None]


@contextlib.contextmanager
def counting():
    """Count the work of every kernel entry called in the block."""
    work = KernelWork()
    prev, _COUNTER[0] = _COUNTER[0], work
    try:
        yield work
    finally:
        _COUNTER[0] = prev


def _route(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type


def _counted(name: str, work, entry, *args):
    """Under :func:`counting`: add ``work`` = (FLOPs, bytes) under
    ``name``, then run ``entry(*args)`` uncounted, on a CPU or CUDA
    tensor with the dispatch modes above it off."""
    counter = _COUNTER[0]
    counter.add(name, *work)
    _COUNTER[0] = None
    try:
        if args[0].device.type == "meta":
            return entry(*args)
        with _disable_current_modes():
            return entry(*args)
    finally:
        _COUNTER[0] = counter


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _gemm_work(a, b):
    """2 M N K FLOPs; a and b read, (M, N) written."""
    m, k = a.shape
    n = b.shape[1]
    return 2.0 * m * n * k, (m * k + k * n + m * n) * a.element_size()


def decode_gemm(a, b):
    """Shape-adaptive small-M GEMM: a (M, K) @ b (K, N)."""
    if _COUNTER[0] is not None:
        return _counted("snake_decode_gemm", _gemm_work(a, b), decode_gemm,
                        a, b)
    route = _route(a)
    if route == "meta":
        return a.new_empty((a.shape[0], b.shape[1]))
    if route == "cuda":
        return sg.snake_decode_gemm(a, b)
    return ref.decode_gemm_ref(a, b)


def decode_gemm_mapping(m: int, n: int, k: int, dtype=torch.bfloat16):
    return sg.choose_mapping(m, n, k, dtype)


def _attn_work(q: torch.Tensor, window: int, hkv: int, esize: int):
    """(FLOPs, K/V bytes) of decode attention of q (B, Hq, D) over
    ``window`` cached positions a lane: 4 Hq D per position (q.k and
    p.v), each position's K and V read once."""
    b, hq, d = q.shape
    return 4.0 * b * hq * d * window, 2.0 * b * window * hkv * d * esize


def _decode_work(q, k, lengths):
    """:func:`_attn_work` over S; q read, the output written, the lengths
    read."""
    flops, kv = _attn_work(q, k.shape[1], k.shape[2], k.element_size())
    return flops, kv + 2 * _nbytes(q) + _nbytes(lengths)


def attention_decode(q, k, v, lengths):
    """GQA flash-decode: q (B,Hq,D) against (B,S,Hkv,D) caches."""
    if _COUNTER[0] is not None:
        return _counted("flash_decode", _decode_work(q, k, lengths),
                        attention_decode, q, k, v, lengths)
    route = _route(q)
    if route == "meta":
        return torch.empty_like(q)
    if route == "cuda":
        return fd.flash_decode(q, k, v, lengths)
    return ref.flash_decode_ref(q, k, v, lengths)


def _partial_work(q, k, lengths):
    """:func:`_attn_work` over the shard's S; q and the lengths read, acc,
    l and m written (float32)."""
    b, hq, d = q.shape
    flops, kv = _attn_work(q, k.shape[1], k.shape[2], k.element_size())
    return flops, kv + _nbytes(q, lengths) + 4 * b * hq * (d + 2)


def attention_decode_partial(q, k, v, lengths):
    """The flash-decode partial of one context shard: q (B,Hq,D) against
    (B,S,Hkv,D) caches -> (acc (B,Hkv,G,D), l (B,Hkv,G), m (B,Hkv,G)),
    float32, un-normalised (``layers.decode_attention_core``'s
    contract)."""
    if _COUNTER[0] is not None:
        return _counted("flash_decode_partial", _partial_work(q, k, lengths),
                        attention_decode_partial, q, k, v, lengths)
    route = _route(q)
    if route == "meta":
        b, hq, d = q.shape
        hkv = k.shape[2]
        f32 = dict(dtype=torch.float32)
        return (q.new_empty((b, hkv, hq // hkv, d), **f32),
                q.new_empty((b, hkv, hq // hkv), **f32),
                q.new_empty((b, hkv, hq // hkv), **f32))
    if route == "cuda":
        return fd.flash_decode_partial(q, k, v, lengths)
    return ref.flash_decode_partial_ref(q, k, v, lengths)


def _paged_work(q, k_pool, tables, lengths):
    """:func:`_attn_work` over the table's window (nblk pages); q, the
    table and the lengths read, the output written."""
    flops, kv = _attn_work(q, tables.shape[1] * k_pool.shape[1],
                           k_pool.shape[2], k_pool.element_size())
    return flops, kv + 2 * _nbytes(q) + _nbytes(tables, lengths)


def attention_decode_paged(q, k_pool, v_pool, tables, lengths):
    """GQA flash-decode through a block table: q (B,Hq,D) against page
    pools (P+1,page,Hkv,D) mapped by tables (B,nblk)."""
    if _COUNTER[0] is not None:
        return _counted("paged_flash_decode",
                        _paged_work(q, k_pool, tables, lengths),
                        attention_decode_paged, q, k_pool, v_pool, tables,
                        lengths)
    route = _route(q)
    if route == "meta":
        return torch.empty_like(q)
    if route == "cuda":
        return fd.paged_flash_decode(q, k_pool, v_pool, tables, lengths)
    return ref.paged_flash_decode_ref(q, k_pool, v_pool, tables, lengths)


def _wkv6_work(r, u, state0):
    """5 hs FLOPs a (b, t, h, channel) (y = r.S + v (r.(u k)),
    S <- w S + k v^T); r, k, v, w and u read, y written, the float32
    state read and written."""
    n = r.numel()
    return 5.0 * n * r.shape[-1], (5 * n * r.element_size() + _nbytes(u)
                                   + 2 * state0.numel() * 4)


def wkv6_scan(r, k, v, w, u, state0, state_out=None):
    """RWKV6 recurrence with the state resident on chip for the sweep:
    r/k/v/w (B,T,H,hs), u (H,hs), state0 (B,H,hs,hs) -> (y, state_T);
    state_T goes into ``state_out`` when given (it may be ``state0``)."""
    if _COUNTER[0] is not None:
        return _counted("wkv6", _wkv6_work(r, u, state0), wkv6_scan,
                        r, k, v, w, u, state0, state_out)
    route = _route(r)
    if route == "meta":
        return torch.empty_like(r), (state_out if state_out is not None
                                     else torch.empty_like(state0))
    if route == "cuda":
        return wk.wkv6(r, k, v, w, u, state0, state_out)
    return ref.wkv6_ref(r, k, v, w, u, state0, state_out)
