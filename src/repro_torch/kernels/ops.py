"""Public entry points of the port's kernels (port of
``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel (or the wrapper raises);
a CPU tensor runs the plain PyTorch version.  Nothing falls back from
one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref
from repro_torch.kernels import snake_gemm as sg
from repro_torch.kernels import wkv6 as wk

#: every kernel wrapper's launch counts (each module's ``LAUNCHES``; the
#: dicts are reset in place, so these references stay valid)
LAUNCH_COUNTS = (fd.LAUNCHES, sg.LAUNCHES, wk.LAUNCHES)


def _route(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type


def decode_gemm(a, b):
    """Shape-adaptive small-M GEMM: a (M, K) @ b (K, N)."""
    if _route(a) == "cuda":
        return sg.snake_decode_gemm(a, b)
    return ref.decode_gemm_ref(a, b)


def decode_gemm_mapping(m: int, n: int, k: int, dtype=torch.bfloat16):
    return sg.choose_mapping(m, n, k, dtype)


def attention_decode(q, k, v, lengths):
    """GQA flash-decode: q (B,Hq,D) against (B,S,Hkv,D) caches."""
    if _route(q) == "cuda":
        return fd.flash_decode(q, k, v, lengths)
    return ref.flash_decode_ref(q, k, v, lengths)


def attention_decode_paged(q, k_pool, v_pool, tables, lengths):
    """GQA flash-decode through a block table: q (B,Hq,D) against page
    pools (P+1,page,Hkv,D) mapped by tables (B,nblk)."""
    if _route(q) == "cuda":
        return fd.paged_flash_decode(q, k_pool, v_pool, tables, lengths)
    return ref.paged_flash_decode_ref(q, k_pool, v_pool, tables, lengths)


def wkv6_scan(r, k, v, w, u, state0, state_out=None):
    """RWKV6 recurrence with the state resident on chip for the sweep:
    r/k/v/w (B,T,H,hs), u (H,hs), state0 (B,H,hs,hs) -> (y, state_T);
    state_T goes into ``state_out`` when given (it may be ``state0``)."""
    if _route(r) == "cuda":
        return wk.wkv6(r, k, v, w, u, state0, state_out)
    return ref.wkv6_ref(r, k, v, w, u, state0, state_out)
