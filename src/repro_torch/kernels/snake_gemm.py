"""SNAKE decode GEMM on Hopper: the shape-adaptive mapping, the split of
K across blocks, and the wrapper of the CUDA kernel in
``csrc/snake_gemm.cu`` (port of ``repro.kernels.snake_gemm``).

The paper reconfigures its systolic array per operator shape; on the
TPU the reference reconfigures the mapping, and so does the port.  Its
rule (paper §3.1) is unchanged: input-stationary (IS, A resident, B
streamed) when N > K and A fits on chip, output-stationary (OS, the
float32 accumulator resident while K streams in blocks of at most 2048)
otherwise.  What "fits" means is restated for Hopper:

* the TPU's 12 MB VMEM budget becomes one block's shared memory, 227 KB
  on the H100 (:data:`SMEM_BUDGET`);
* a block owns :data:`BLOCK_N` output columns and stages B through a
  ring of :data:`STAGES` ``cp.async`` stages of :data:`STAGE_BYTES`
  each; IS needs room for that ring plus the block's rows of A
  (:func:`row_tile` x K, each row padded by 16 bytes), OS for the ring
  with a stage of A beside each stage of B
  (:meth:`GemmMapping.smem_bytes`);
* M is padded to the reference's granularity, 8 rows for float32 and 16
  for bfloat16, which is also the row tile of one block.  bf16 runs on
  the tensor cores with the batch on the mma's n8 side, so a 16-row
  tile is two n8 tiles and the second is skipped when it holds no row.

So the two packages can pick different dataflows for one shape: at
float32 with K = 8192, A's 8 rows alone take 256 KB, so
``(8, 28672, 8192, float32)`` is OS here where the TPU picks IS.  The
product is the same either way.

K is split across blocks (:func:`split_k_plan`, from shapes alone).  The
chunks' float32 partials are summed in split order, inside the same
launch, by the last block of each output tile to finish, so a call is
one launch, deterministic, and capturable in a CUDA graph.  The
mapping's ``block_k`` is the most K rows one block walks: all of K for
IS, at most 2048 for OS.

:func:`snake_decode_gemm` takes CUDA tensors only (``kernels.ops`` routes
CPU tensors to ``kernels.ref.decode_gemm_ref``) and counts each launch in
:data:`LAUNCHES` under its dataflow.  The tile counters are shared by
the calls on one device that have the same number of tiles, so two calls
must not run at once on two streams.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

#: kernel launches per dataflow since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"snake_decode_gemm_is": 0,
                            "snake_decode_gemm_os": 0}

SMEM_BUDGET = 232448     # shared memory one H100 block can use (227 KB)
BLOCK_N = 128            # output columns per block (csrc kBlockN)
STAGES = 4               # cp.async ring depth (csrc kStages)
STAGE_BYTES = 16384      # bytes of B per ring stage (csrc kStageBytes)
MAX_BLOCK_K = 2048       # most K rows one OS block walks by default
LANE = 128               # OS's default block_k is a multiple of this
K_STEP = 16              # a K chunk is a multiple of the mma's depth
SMS = 132                # the H100's SMs
SM_SMEM = 233472         # shared memory of one SM (228 KB)
BLOCK_SMEM_RESERVED = 1024   # the runtime's share of it per block
#: blocks per SM the kernel's registers allow (csrc __launch_bounds__)
REG_BLOCKS = {torch.bfloat16: 4, torch.float32: 3}
#: blocks the plan wants: 2 per SM
MIN_BLOCKS = 2 * SMS
MAX_SPLITS = 65535       # the grid's z limit

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {"repro_snake_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _L, _L, _P]}
#: per (device, tile count): the zeroed tile counters; the kernel sets
#: each back to 0, so one buffer serves every call and graph replay
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def row_tile(dtype) -> int:
    """M granularity: 16 rows for bfloat16, 8 otherwise (the reference's
    sublane granularity, and one block's rows here)."""
    return 16 if dtype == torch.bfloat16 else 8


def _round_up(x: int, g: int) -> int:
    return -(-x // g) * g


def stage_k(dtype) -> int:
    """K rows of one ring stage: 64 for bfloat16, 32 for float32."""
    return STAGE_BYTES // (BLOCK_N * dtype.itemsize)


@dataclass(frozen=True)
class GemmMapping:
    dataflow: str        # "IS" | "OS"
    block_m: int         # M padded to row_tile
    block_n: int
    block_k: int         # most K rows a block walks; == K for IS

    def smem_bytes(self, dtype, bk: Optional[int] = None) -> int:
        """Shared memory of one block whose K chunk is ``bk`` (default:
        ``block_k``): the ring of B stages (rows padded by 16 bytes) and
        either A's rows for the whole chunk (IS) or a stage of A beside
        each stage of B (OS)."""
        es, rows, sk = dtype.itemsize, row_tile(dtype), stage_k(dtype)
        b_stage = sk * (BLOCK_N * es + 16)
        if self.dataflow == "IS":
            k = self.block_k if bk is None else bk
            return STAGES * b_stage + rows * (_round_up(k, sk) * es + 16)
        return STAGES * (b_stage + rows * (sk * es + 16))


def choose_mapping(m: int, n: int, k: int,
                   dtype=torch.bfloat16) -> GemmMapping:
    """The paper's §3.1 rule in Hopper shared-memory terms."""
    bm = _round_up(max(1, m), row_tile(dtype))
    is_map = GemmMapping("IS", bm, BLOCK_N, k)
    if n > k and is_map.smem_bytes(dtype) <= SMEM_BUDGET:
        return is_map
    return GemmMapping("OS", bm, BLOCK_N, min(_round_up(k, LANE),
                                              MAX_BLOCK_K))


def resident_blocks(mp: GemmMapping, dtype, bk: int) -> int:
    """Blocks of ``mp`` with K chunks of ``bk`` that the card holds at
    once: 132 SMs times what one SM's shared memory and registers allow
    (at most 8 blocks of 256 threads)."""
    smem = mp.smem_bytes(dtype, bk) + BLOCK_SMEM_RESERVED
    return SMS * min(REG_BLOCKS[dtype], 8, SM_SMEM // smem)


def split_k_plan(m: int, n: int, k: int, dtype=torch.bfloat16,
                 split: Optional[int] = None,
                 mapping: Optional[GemmMapping] = None) -> Tuple[int, int]:
    """``(bk, n_split)``: K rows per block and blocks per output tile,
    from shapes alone (nothing is read from the card).

    ``bk = ceil(k / split)`` rounded up to a multiple of :data:`K_STEP`,
    at most ``mapping``'s ``block_k`` (rounded up the same way; default
    mapping: :func:`choose_mapping`'s), and ``n_split = ceil(k / bk)``,
    so the chunks cover K and only the last may be short.  The plan takes the
    fewest splits that give :data:`MIN_BLOCKS` blocks of
    ``ceil(n / BLOCK_N) x n_split x ceil(m / row_tile)`` (at most one per
    :data:`K_STEP` rows), then fewer while the blocks are more than one
    wave of :func:`resident_blocks` (all blocks do the same work, so a
    second, partial wave would add a whole block's time), but never
    chunks above the cap.  ``split`` overrides the count (for sweeps).
    Needs ``k >= 1``.
    """
    mp = mapping or choose_mapping(m, n, k, dtype)
    cap = _round_up(mp.block_k, K_STEP)
    most = -(-k // K_STEP)

    def plan(s: int) -> Tuple[int, int]:
        bk = _round_up(-(-k // s), K_STEP)
        return bk, -(-k // bk)

    if split is None:
        tiles = -(-n // BLOCK_N) * -(-max(1, m) // row_tile(dtype))
        least = -(-k // cap)
        split = max(least, min(-(-MIN_BLOCKS // tiles), most))
        while split < most and tiles * plan(split)[1] < MIN_BLOCKS:
            split += 1
        while split > least and tiles * plan(split)[1] > resident_blocks(
                mp, dtype, plan(split)[0]):
            split -= 1
    elif not 1 <= split <= most:
        raise ValueError(f"split {split}: want 1 <= split <= "
                         f"ceil(K / {K_STEP}) = {most}")
    bk, n_split = plan(split)
    if bk > cap:
        raise ValueError(f"split {split}: chunks of {bk} rows exceed "
                         f"the mapping's block_k {cap}")
    if n_split > MAX_SPLITS:
        raise ValueError(f"K = {k} needs {n_split} chunks of {bk} rows "
                         f"(> {MAX_SPLITS})")
    return bk, n_split


def check_args(a: torch.Tensor, b: torch.Tensor, mp: GemmMapping) -> None:
    """Raise ``ValueError`` on what the kernel does not take: shapes,
    dtypes, a strided last dim, or a mapping other than one of this
    shape's (block_m padded to the row tile, block_n the kernel's, IS
    over all of K, an OS block_k a positive multiple of 16, a block
    within the shared-memory budget)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"want a (M, K) and b (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"dtypes {a.dtype}/{b.dtype}: the kernel takes "
                         f"one of {list(_DTYPE_CODE)} for both")
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("a and b must have a contiguous last dim")
    m, k = a.shape
    ok = (mp.dataflow in ("IS", "OS") and mp.block_n == BLOCK_N
          and mp.block_m == _round_up(max(1, m), row_tile(a.dtype))
          and (mp.block_k == k if mp.dataflow == "IS"
               else mp.block_k > 0 and mp.block_k % K_STEP == 0)
          and mp.smem_bytes(a.dtype) <= SMEM_BUDGET)
    if not ok:
        raise ValueError(f"mapping {mp} does not fit ({m}, {b.shape[1]}, "
                         f"{k}) {a.dtype} on this kernel")


def _counters(device: torch.device, n: int) -> torch.Tensor:
    key = (device, n)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def snake_decode_gemm(a: torch.Tensor, b: torch.Tensor,
                      mapping: Optional[GemmMapping] = None,
                      split: Optional[int] = None) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, float32 accumulation,
    with the mapping :func:`choose_mapping` picks unless one is given;
    ``split`` overrides :func:`split_k_plan`'s count."""
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
    bk, n_split = split_k_plan(m, n, k, a.dtype, split, mp)
    ws = (torch.empty((n_split, m, n), dtype=torch.float32, device=a.device)
          if n_split > 1 else None)
    tiles = -(-n // BLOCK_N) * -(-m // row_tile(a.dtype))
    counters = _counters(a.device, tiles)
    vw = 16 // a.element_size()
    vec = (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
           and a.stride(0) % vw == 0 and b.stride(0) % vw == 0)
    build.launch(build.library("snake_gemm", _ARGTYPES), "repro_snake_gemm",
                 a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 ws.data_ptr() if ws is not None else None,
                 counters.data_ptr(), _DTYPE_CODE[a.dtype],
                 int(mp.dataflow == "IS"), int(vec), m, n, k, bk, n_split,
                 a.stride(0), b.stride(0),
                 torch.cuda.current_stream(a.device).cuda_stream)
    LAUNCHES[f"snake_decode_gemm_{mp.dataflow.lower()}"] += 1
    return out
