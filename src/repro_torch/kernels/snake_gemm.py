"""SNAKE decode GEMM on Hopper: the shape-adaptive mapping and the
wrapper of the CUDA kernels in ``csrc/snake_gemm.cu`` (port of
``repro.kernels.snake_gemm``).

The paper reconfigures its systolic array per operator shape; on the
TPU the reference reconfigures the mapping, and so does the port.  Its
rule (paper §3.1) is unchanged: input-stationary (IS, A resident, B
streamed) when N > K and A fits on chip, output-stationary (OS, the
float32 accumulator resident while K streams in blocks of at most 2048)
otherwise.  What "fits" means is restated for Hopper:

* the TPU's 12 MB VMEM budget becomes one block's shared memory, 227 KB
  on the H100 (:data:`SMEM_BUDGET`);
* the GPU streams B through registers, so IS needs room for the block's
  resident rows of A (:func:`row_tile` x K) plus the cross-warp sum
  buffer, not for a whole K x block_n tile of B;
* M is padded to the reference's granularity, 8 rows for float32 and 16
  for bfloat16, which is also the row tile of one block.

So the two packages can pick different dataflows for one shape: at
float32 with K = 8192, A's 8 rows alone take 256 KB, so
``(8, 28672, 8192, float32)`` is OS here where the TPU picks IS.  The
product is the same either way.

:func:`snake_decode_gemm` takes CUDA tensors only (``kernels.ops`` routes
CPU tensors to ``kernels.ref.decode_gemm_ref``) and counts each launch in
:data:`LAUNCHES` under its dataflow.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

#: kernel launches per dataflow since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"snake_decode_gemm_is": 0,
                            "snake_decode_gemm_os": 0}

SMEM_BUDGET = 232448     # shared memory one H100 block can use (227 KB)
BLOCK_N = 64             # output columns per block (csrc kBlockN)
WARPS = 8                # warps per block (csrc kThreads / 32)
MAX_BLOCK_K = 2048       # deepest K block OS stages at once
LANE = 128               # OS K blocks are whole multiples of this

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {"repro_snake_gemm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _L, _L, _P]}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def row_tile(dtype) -> int:
    """M granularity: 16 rows for bfloat16, 8 otherwise (the reference's
    sublane granularity, and one block's rows here)."""
    return 16 if dtype == torch.bfloat16 else 8


def _round_up(x: int, g: int) -> int:
    return -(-x // g) * g


@dataclass(frozen=True)
class GemmMapping:
    dataflow: str        # "IS" | "OS"
    block_m: int         # M padded to row_tile
    block_n: int
    block_k: int         # == K for IS

    def smem_bytes(self, dtype) -> int:
        """Shared memory one block of this mapping uses: its rows of A for
        one K block, plus the float32 cross-warp sum buffer."""
        rows = row_tile(dtype)
        a_bytes = _round_up(rows * self.block_k * dtype.itemsize, 16)
        return a_bytes + WARPS * rows * self.block_n * 4


def choose_mapping(m: int, n: int, k: int,
                   dtype=torch.bfloat16) -> GemmMapping:
    """The paper's §3.1 rule in Hopper shared-memory terms."""
    bm = _round_up(max(1, m), row_tile(dtype))
    is_map = GemmMapping("IS", bm, BLOCK_N, k)
    if n > k and is_map.smem_bytes(dtype) <= SMEM_BUDGET:
        return is_map
    return GemmMapping("OS", bm, BLOCK_N, min(_round_up(k, LANE),
                                              MAX_BLOCK_K))


def check_args(a: torch.Tensor, b: torch.Tensor, mp: GemmMapping) -> None:
    """Raise ``ValueError`` on what the kernels do not take: shapes,
    dtypes, a strided last dim, or a mapping other than one of this
    shape's (block_m padded to the row tile, block_n the kernels', IS
    over all of K, a K block within the shared-memory budget)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want a (M, K) and b (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"dtypes {a.dtype}/{b.dtype}: the kernels take "
                         f"one of {list(_DTYPE_CODE)} for both")
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("a and b must have a contiguous last dim")
    m, k = a.shape
    ok = (mp.dataflow in ("IS", "OS") and mp.block_n == BLOCK_N
          and mp.block_m == _round_up(max(1, m), row_tile(a.dtype))
          and (mp.block_k == k if mp.dataflow == "IS" else mp.block_k > 0)
          and mp.smem_bytes(a.dtype) <= SMEM_BUDGET)
    if not ok:
        raise ValueError(f"mapping {mp} does not fit ({m}, {b.shape[1]}, "
                         f"{k}) {a.dtype} on this kernel")


def snake_decode_gemm(a: torch.Tensor, b: torch.Tensor,
                      mapping: Optional[GemmMapping] = None) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, float32 accumulation,
    with the mapping :func:`choose_mapping` picks unless one is given."""
    m, k = a.shape
    n = b.shape[-1]
    mp = mapping or choose_mapping(m, n, k, a.dtype)
    check_args(a, b, mp)
    build.require_cuda(a, b)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    vw = 16 // a.element_size()
    vec = n % vw == 0 and b.stride(0) % vw == 0 and b.data_ptr() % 16 == 0
    build.launch(build.library("snake_gemm", _ARGTYPES), "repro_snake_gemm",
                 a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[a.dtype], int(mp.dataflow == "IS"), int(vec),
                 m, n, k, mp.block_k, a.stride(0), b.stride(0),
                 torch.cuda.current_stream(a.device).cuda_stream)
    LAUNCHES[f"snake_decode_gemm_{mp.dataflow.lower()}"] += 1
    return out
