"""Which limit binds the decode GEMM: time variants of its CUDA kernel
beside ``torch.matmul`` under two ways of flushing the L2.

  PYTHONPATH=src python -m repro_torch.launch.gemm_variants   # card only

Each variant is ``csrc/snake_gemm.cu`` with one edit, built with the
package's nvcc flags into ``build/gemm_variants/`` and called through
the same C interface at its own split plan:

* ``kernel``      the source as it is;
* ``stage_8k``    8 KB ring stages (the first design point);
* ``no_combine``  every block returns after writing its partial: the
                  call without the in-launch sum of the partials;
* ``no_compute``  the ring is filled but never read: the loads alone.

The last two compute wrong outputs on purpose and are only timed.  Each
time is the median of 20 replays of a CUDA graph holding one call,
between CUDA events, after either a 256 MB write (``write``, the flush of
``chip_smoke.py``, which leaves the L2 full of dirty lines the call must
write back) or a 256 MB read (``read``, which leaves it clean).  The
shapes are rwkv6-7b's decode products at a batch of 4 in bf16.  Prints
one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import snake_gemm as sg

SHAPES = [(4, 14336, 4096), (4, 4096, 14336), (4, 4096, 4096)]
_STAGE = "constexpr int kStageBytes = 16384;"
_COMBINE = "  if (g.n_split == 1) return;"
_COMPUTE = "    cp_async_commit();\n    const unsigned char* slot"
#: name: (edits of the source, STAGE_BYTES the plan assumes, checked)
VARIANTS: Dict[str, Tuple[List[Tuple[str, str]], int, bool]] = {
    "kernel": ([], 16384, True),
    "stage_8k": ([(_STAGE, "constexpr int kStageBytes = 8192;")], 8192,
                 True),
    "no_combine": ([(_COMBINE, "  return;")], 16384, False),
    "no_compute": ([(_COMPUTE, _COMPUTE.replace(
        "\n", "\n    if (g.M > 0) continue;\n", 1))], 16384, False),
}


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Compile every variant in parallel (one nvcc each); their
    libraries bound to the kernel's C interface."""
    out = build.BUILD_DIR.parent / "gemm_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "common.cuh").write_text((build.SRC_DIR / "common.cuh")
                                    .read_text())
    src = (build.SRC_DIR / "snake_gemm.cu").read_text()
    jobs = {}
    for name, (edits, _, _) in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.repro_snake_gemm.argtypes = sg._ARGTYPES["repro_snake_gemm"]
        lib.repro_snake_gemm.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _call(lib, a, b, is_, bk, n_split, counters) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    ws = torch.empty(n_split, m, n, device=a.device) if n_split > 1 else None
    err = lib.repro_snake_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, counters.data_ptr(), 1,
        is_, 1, m, n, k, bk, n_split, a.stride(0), b.stride(0),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def time_ms(fn: Callable[[], torch.Tensor], flush: str,
            iters: int = 20) -> float:
    """Median CUDA-event time of a graph replay of ``fn`` after a 256 MB
    write or read."""
    buf = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    sink = torch.empty((), device="cuda")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(iters):
        if flush == "write":
            buf.zero_()
        else:
            sink.copy_(buf.sum())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_variants: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_variants()
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    rows = []
    try:
        for m, n, k in SHAPES:
            a = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
            b = torch.randn(k, n, generator=gen, device="cuda").to(bf16)
            want = ref.decode_gemm_ref(a, b).float()
            is_ = int(sg.choose_mapping(m, n, k, bf16).dataflow == "IS")
            for flush in ("write", "read"):
                row = {"shape": [m, n, k], "flush": flush,
                       "matmul_ms": time_ms(lambda: torch.matmul(a, b),
                                            flush)}
                for name, lib in libs.items():
                    sg.STAGE_BYTES = VARIANTS[name][1]
                    bk, ns = sg.split_k_plan(m, n, k, bf16)
                    args = (lib, a, b, is_, bk, ns, counters)
                    got = _call(*args).float()
                    if VARIANTS[name][2] and not torch.allclose(
                            got, want, rtol=2e-2, atol=2e-2):
                        raise AssertionError(f"{name} {m}x{n}x{k} is wrong")
                    row[name] = {"bk": bk, "n_split": ns, "ms": time_ms(
                        lambda: _call(*args), flush)}
                rows.append(row)
    finally:
        sg.STAGE_BYTES = VARIANTS["kernel"][1]
    print(json.dumps({"card": card, "rows": rows}))


if __name__ == "__main__":
    main()
