"""WKV6 recurrence on Hopper: wrapper of the CUDA kernel in
``csrc/wkv6.cu`` (port of ``repro.kernels.wkv6``).

:func:`wkv6` takes CUDA tensors only (``kernels.ops`` routes CPU tensors
to ``kernels.ref.wkv6_ref``).  It validates its inputs, picks the design
with :func:`chunk_plan` (the serial sweep for short T, the chunk-parallel
form for long T; from shapes alone, so a call never reads the device and
stays capturable in a CUDA graph), allocates ``y`` (and the final state
unless ``state_out`` is given), launches on the current stream, raises
if the launch failed, and counts the launch in :data:`LAUNCHES`.
``r/k/v/w`` are read in their ``(B, T, H, hs)`` layout through their
strides: unlike the TPU wrapper, nothing is transposed or copied.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

#: kernel launches since the last :func:`reset_launches`: every call
#: under "wkv6", the chunked design's also under "wkv6_chunked"
LAUNCHES: Dict[str, int] = {"wkv6": 0, "wkv6_chunked": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (32, 64, 128)
#: chunk lengths C the chunked design is built for
CHUNKS = (16, 32, 64)
#: the planned C and the shortest T that takes the chunked design
#: (chip_smoke.py --sweep)
PLANNED_CHUNK = 32
CHUNKED_MIN_T = 48
MAX_SMEM = 232448            # a block's shared memory on sm_90

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {"repro_wkv6": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _L, _L, _L, _I, _P, _P]}


class WkvPlan(NamedTuple):
    design: str          # "serial" or "chunked"
    chunk: int           # C (0 for the serial design)
    blocks: int          # blocks of the serial launch, or of each of the
                         # chunked design's per-chunk launches
    chunks: int          # chunks of C steps covering T (0 if serial)


def smem_bytes(hs: int, chunk: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the chunked design's output
    launch, its largest (``OutLayout`` in csrc/wkv6.cu): the chunk's raw
    r/k/w/v rows, then float32 the entering state, rtil, rhat and A (both
    transposed), khat for each pair of 16-step sub-blocks, the
    sub-blocks' decays and u; rows padded by 16 bytes."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nsb = chunk // 16
    floats = (hs * hs + chunk * (hs + 4) + (hs + chunk) * (chunk + 4)
              + nsb * (nsb - 1) // 2 * 16 * (hs + 4) + nsb * hs + hs)
    return 4 * chunk * (hs * esize + 16) + 4 * floats


def scratch_floats(b: int, h: int, hs: int, plan: "WkvPlan") -> int:
    """float32 scratch of a chunked call: each chunk's state contribution
    and entering state (hs x hs each) and decay (hs) per (b, h)."""
    return b * h * plan.chunks * (2 * hs * hs + hs)


def chunk_plan(b: int, t: int, h: int, hs: int, dtype: torch.dtype,
               chunk: Optional[int] = None) -> WkvPlan:
    """The design of a call at these shapes.  ``chunk=None`` plans: the
    chunked design with C = PLANNED_CHUNK for T >= CHUNKED_MIN_T, else
    the serial one.  An override (timing sweeps, tests) is 0 for the
    serial design or a C of CHUNKS whose blocks fit in shared memory
    (all but C = 64 at hs = 128); anything else raises ``ValueError``."""
    if chunk is None:
        chunk = PLANNED_CHUNK if t >= CHUNKED_MIN_T else 0
    if chunk == 0:
        return WkvPlan("serial", 0, b * h, 0)
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk}: want 0 (serial) or one of "
                         f"{CHUNKS}")
    if smem_bytes(hs, chunk, dtype) > MAX_SMEM:
        raise ValueError(f"chunk {chunk} at hs {hs} needs "
                         f"{smem_bytes(hs, chunk, dtype)} bytes of shared "
                         f"memory a block, over {MAX_SMEM}")
    chunks = -(-t // chunk)
    return WkvPlan("chunked", chunk, b * h * chunks, chunks)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_args(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state0: torch.Tensor) -> None:
    """Raise ``ValueError`` on anything the kernel does not take: shapes,
    dtypes, head size, and the layouts it addresses (one set of strides
    for r/k/v/w with a contiguous last dim; u and the state contiguous)."""
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"want r/k/v/w of one (B, T, H, hs) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, _, h, hs = r.shape
    if hs not in HEAD_SIZES:
        raise ValueError(f"head size {hs}: the kernel takes hs in "
                         f"{HEAD_SIZES}")
    if r.dtype not in _DTYPE_CODE or any(t.dtype != r.dtype
                                         for t in (k, v, w, u)):
        raise ValueError(f"dtypes {[t.dtype for t in (r, k, v, w, u)]}: "
                         f"r/k/v/w/u share one of {list(_DTYPE_CODE)}")
    if u.shape != (h, hs) or not u.is_contiguous():
        raise ValueError(f"u must be contiguous ({h}, {hs}), got "
                         f"{tuple(u.shape)}")
    if (state0.shape != (b, h, hs, hs) or state0.dtype != torch.float32
            or not state0.is_contiguous()):
        raise ValueError(f"a state must be contiguous float32 "
                         f"({b}, {h}, {hs}, {hs}), got {state0.dtype} "
                         f"{tuple(state0.shape)}")
    if r.stride(-1) != 1 or any(t.stride() != r.stride() for t in (k, v, w)):
        raise ValueError("r/k/v/w must share strides with a contiguous "
                         "last dim")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
         state_out: Optional[torch.Tensor] = None,
         chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, T, H, hs); u: (H, hs); state0: (B, H, hs, hs) float32.

    Returns (y: (B, T, H, hs) in r's dtype, state_T: (B, H, hs, hs)
    float32).  ``state_T`` is written into ``state_out`` when it is given
    (it may be ``state0`` itself: the kernel reads each part of the state
    before it writes it), else into a new tensor.  ``chunk`` overrides
    the plan (see :func:`chunk_plan`).
    """
    check_args(r, k, v, w, u, state0)
    s_t = torch.empty_like(state0) if state_out is None else state_out
    check_args(r, k, v, w, u, s_t)
    build.require_cuda(r, k, v, w, u, state0, s_t)
    b, t, h, hs = r.shape
    plan = chunk_plan(b, t, h, hs, r.dtype, chunk)
    y = torch.empty((b, t, h, hs), dtype=r.dtype, device=r.device)
    scratch = (torch.empty(scratch_floats(b, h, hs, plan),
                           dtype=torch.float32, device=r.device)
               if plan.design == "chunked" else None)
    build.launch(build.library("wkv6", _ARGTYPES), "repro_wkv6",
                 r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state0.data_ptr(), y.data_ptr(),
                 s_t.data_ptr(), _DTYPE_CODE[r.dtype], b, t, h, hs,
                 r.stride(0), r.stride(1), r.stride(2), plan.chunk,
                 None if scratch is None else scratch.data_ptr(),
                 torch.cuda.current_stream(r.device).cuda_stream)
    LAUNCHES["wkv6"] += 1
    if plan.design == "chunked":
        LAUNCHES["wkv6_chunked"] += 1
    return y, s_t
