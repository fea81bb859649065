"""Public entry points of the decode-attention kernels (port of
``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel (or the wrapper raises);
a CPU tensor runs the plain PyTorch version.  Nothing falls back from
one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref


def _route(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no decode attention for device {q.device}")
    return q.device.type


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
