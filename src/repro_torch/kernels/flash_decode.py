"""Flash-decode attention on Hopper: wrappers of the CUDA kernels in
``csrc/flash_decode.cu`` (port of ``repro.kernels.flash_decode``).

``flash_decode`` attends over contiguous ``(B, S, Hkv, D)`` caches and
``paged_flash_decode`` over ``(P+1, page, Hkv, D)`` page pools through a
``(B, nblk)`` block table; both take CUDA tensors only (``kernels.ops``
routes CPU tensors to the plain versions in ``kernels.ref``).  Each
wrapper validates its inputs, allocates the output, launches on the
current stream, raises if the launch failed, and counts the launch in
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash_decode": 0, "paged_flash_decode": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "repro_flash_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _P],
    "repro_paged_flash_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _L, _L, _L, _L, _L, _L, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor,
               tables: Optional[torch.Tensor] = None) -> None:
    """Raise ``ValueError`` on anything the kernels do not take: shapes,
    dtypes, head dim and group size, and the layout the vector loads
    need (last dim contiguous, rows aligned to the vector width)."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Hq,D) and k/v of one 4-d shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                         f"kernels take one of {list(_DTYPE_CODE)} for all")
    b, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape[3] != d or d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} (k has {k.shape[3]}): the kernels "
                         f"take D in {HEAD_DIMS}")
    if hkv < 1 or hq % hkv or not 1 <= hq // hkv <= MAX_GROUP:
        raise ValueError(f"Hq={hq}, Hkv={hkv}: want Hq = G * Hkv with "
                         f"1 <= G <= {MAX_GROUP}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise ValueError(f"lengths must be contiguous int32 ({b},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if tables is None:
        if k.shape[0] != b:
            raise ValueError(f"cache batch {k.shape[0]} != q batch {b}")
    elif (tables.ndim != 2 or tables.shape[0] != b
          or tables.dtype != torch.int32 or tables.stride(1) != 1):
        raise ValueError(f"tables must be int32 (B={b}, nblk) with a "
                         f"contiguous last dim, got {tables.dtype} "
                         f"{tuple(tables.shape)}")
    if k.stride() != v.stride():
        raise ValueError("k and v must share strides")
    epl = d // 32
    width = q.element_size() * epl
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
        if t.data_ptr() % width or any(s % epl for s in t.stride()[:-1]):
            raise ValueError(f"{name} rows must be {width}-byte aligned")


def _launch(fn: str, *args) -> None:
    build.launch(build.library("flash_decode", _ARGTYPES), fn, *args)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D); k/v: (B, S, Hkv, D); lengths: (B,) int32 ->
    (B, Hq, D) in q's dtype."""
    check_args(q, k, v, lengths)
    build.require_cuda(q, k, v, lengths)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    b, hq, d = q.shape
    _launch("repro_flash_decode",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), _DTYPE_CODE[q.dtype], b, hq, k.shape[2], d,
            k.shape[1], q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            k.stride(2), torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_decode"] += 1
    return out


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D); k_pool/v_pool: (P+1, page, Hkv, D) with scratch page
    P; tables: (B, nblk) int32 page ids (unmapped -> P); lengths: (B,)
    int32 -> (B, Hq, D) in q's dtype.  Table entries are trusted to be
    page ids of the pool, as in the reference kernel."""
    check_args(q, k_pool, v_pool, lengths, tables)
    build.require_cuda(q, k_pool, v_pool, tables, lengths)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    b, hq, d = q.shape
    _launch("repro_paged_flash_decode",
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            out.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            _DTYPE_CODE[q.dtype], b, hq, k_pool.shape[2], d,
            k_pool.shape[1], tables.shape[1], q.stride(0), q.stride(1),
            k_pool.stride(0), k_pool.stride(1), k_pool.stride(2),
            tables.stride(0),
            torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["paged_flash_decode"] += 1
    return out
