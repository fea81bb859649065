"""Flash-decode attention on Hopper: wrappers of the CUDA kernels in
``csrc/flash_decode.cu`` (port of ``repro.kernels.flash_decode``).

``flash_decode`` attends over contiguous ``(B, S, Hkv, D)`` caches and
``paged_flash_decode`` over ``(P+1, page, Hkv, D)`` page pools through a
``(B, nblk)`` block table; both take CUDA tensors only (``kernels.ops``
routes CPU tensors to the plain versions in ``kernels.ref``).  Each
wrapper validates its inputs, picks the context split from shapes alone
(:func:`split_plan`; nothing is read back from the card), allocates the
output and the f32 partials, launches the two kernels (chunk partials,
then the combine) on the current stream, raises if a launch failed, and
counts the call in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

#: wrapper calls that launched their kernels (two device launches each:
#: partials and combine) since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash_decode": 0, "paged_flash_decode": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernels are built for (80: stablelm-3b; 112:
#: kimi-k2-1t-a32b; 256: recurrentgemma-9b), each a multiple of 16 for
#: the bf16 tensor-core tiles
HEAD_DIMS = (32, 64, 80, 112, 128, 256)
#: query heads per kv head; a group of more than 8 heads (recurrentgemma's
#: MQA has 16) takes 16 rows of shared memory for its heads, 8 otherwise
MAX_GROUP = 16
#: context positions per block the plan chooses among, largest first
CHUNKS = (256, 128, 64, 32)
#: a chunk's K rows (and its V rows) take at most this much shared memory
MAX_TILE_BYTES = 64 << 10
#: blocks the plan wants when every lane fills the cap (4 waves of the
#: H100's 132 SMs, so ragged lengths still leave one wave active)
MIN_BLOCKS = 4 * 132
MAX_SPLITS = 65535             # the grid's z limit

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "repro_flash_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I, _L, _L, _L, _L, _L, _P],
    "repro_paged_flash_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L,
                                 _L, _L, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def split_plan(cap: int, batch: int, hkv: int, page: int = 1,
               row_bytes: int = 256,
               chunk: Optional[int] = None) -> Tuple[int, int]:
    """``(C, n_split)``: context positions per block and blocks per
    (request, kv head), from shapes alone.

    ``cap`` is the context the kernel may read (S, or nblk * page),
    ``row_bytes`` one K row (D * element size).  C is a multiple of 16
    (and of ``page`` where one of :data:`CHUNKS` is), at most 256, and
    its K rows fit :data:`MAX_TILE_BYTES`; the plan takes the largest such
    C that still gives :data:`MIN_BLOCKS` blocks when every lane fills
    the cap, else the smallest.  ``chunk`` overrides the choice (for
    timing sweeps).  ``n_split = ceil(cap / C)``, at least 1.
    """
    fits = [c for c in CHUNKS if c * row_bytes <= MAX_TILE_BYTES]
    if chunk is None:
        cands = [c for c in fits if c % page == 0] or fits[-1:]
        chunk = next((c for c in cands
                      if batch * hkv * -(-cap // c) >= MIN_BLOCKS),
                     cands[-1])
    elif chunk % 16 or not 16 <= chunk <= CHUNKS[0] \
            or chunk * row_bytes > MAX_TILE_BYTES:
        raise ValueError(f"chunk {chunk}: want a multiple of 16 in "
                         f"[16, {CHUNKS[0]}] whose K rows fit "
                         f"{MAX_TILE_BYTES} bytes")
    n_split = max(1, -(-cap // chunk))
    if n_split > MAX_SPLITS:
        raise ValueError(f"context {cap} needs {n_split} blocks of "
                         f"{chunk} positions per head (> {MAX_SPLITS})")
    return chunk, n_split


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor,
               tables: Optional[torch.Tensor] = None) -> None:
    """Raise ``ValueError`` on anything the kernels do not take: shapes,
    dtypes, head dim and group size, and the layout the 16-byte copies
    need (last dim contiguous, rows 16-byte aligned)."""
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
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"{name} rows must be 16-byte aligned")


def _scratch(q: torch.Tensor, hkv: int, n_split: int):
    """Output and f32 partials (acc, m, l) of one call."""
    b, hq, d = q.shape
    g = hq // hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty((b, hkv, n_split, g, d), **f32),
            torch.empty((b, hkv, n_split, g), **f32),
            torch.empty((b, hkv, n_split, g), **f32))


def _launch(fn: str, *args) -> None:
    build.launch(build.library("flash_decode", _ARGTYPES), fn, *args)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor,
                 chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, D); k/v: (B, S, Hkv, D); lengths: (B,) int32 ->
    (B, Hq, D) in q's dtype.  ``chunk`` overrides :func:`split_plan`."""
    check_args(q, k, v, lengths)
    build.require_cuda(q, k, v, lengths)
    b, hq, d = q.shape
    hkv, s = k.shape[2], k.shape[1]
    c, n_split = split_plan(s, b, hkv, 1, d * q.element_size(), chunk)
    out, acc, m, l = _scratch(q, hkv, n_split)
    _launch("repro_flash_decode",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            _DTYPE_CODE[q.dtype], b, hq, hkv, d, s, c, n_split,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["flash_decode"] += 1
    return out


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, D); k_pool/v_pool: (P+1, page, Hkv, D) with scratch page
    P; tables: (B, nblk) int32 page ids (unmapped -> P); lengths: (B,)
    int32 -> (B, Hq, D) in q's dtype.  Table entries are trusted to be
    page ids of the pool, as in the reference kernel.  ``chunk``
    overrides :func:`split_plan`."""
    check_args(q, k_pool, v_pool, lengths, tables)
    build.require_cuda(q, k_pool, v_pool, tables, lengths)
    b, hq, d = q.shape
    hkv, page, nblk = k_pool.shape[2], k_pool.shape[1], tables.shape[1]
    c, n_split = split_plan(nblk * page, b, hkv, page,
                            d * q.element_size(), chunk)
    out, acc, m, l = _scratch(q, hkv, n_split)
    _launch("repro_paged_flash_decode",
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            out.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            _DTYPE_CODE[q.dtype], b, hq, hkv, d, page, nblk, c, n_split,
            q.stride(0), q.stride(1), k_pool.stride(0), k_pool.stride(1),
            k_pool.stride(2), tables.stride(0),
            torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["paged_flash_decode"] += 1
    return out
