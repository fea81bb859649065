"""Which phase of the chunked WKV6 design takes the time: device times of
its three launches with phases of the chunk-output launch cut out.

  PYTHONPATH=src python -m repro_torch.launch.wkv6_variants   # card only

Each variant is ``csrc/wkv6.cu`` with one edit, built with the package's
nvcc flags into ``build/wkv6_variants/`` and called through the same C
interface:

* ``kernel``      the source as it is;
* ``no_pre``      no decay products (rtil, rhat, khat);
* ``no_diag``     no walk over A's diagonal sub-blocks;
* ``no_offdiag``  no products below them;
* ``no_y``        no y = rhat S_in + A v (the stores stay);
* ``only_load``   all four cut: staging, barriers and stores alone.

All but ``kernel`` compute wrong outputs on purpose and are only timed.
Shape: rwkv6-7b's prefill (B=1, H=64, hs=64, float32) at T=1024 for each
C of ``wkv6.CHUNKS``; each number is the mean device time of a launch
from ``torch.profiler`` over 10 calls, the L2 flushed by a 256 MB write
before each.  Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import wkv6 as wk

_PRE = [("    for (int t = q0; t < qe; ++t) {\n      rtil",
         "    for (int t = q0; t < q0; ++t) {\n      rtil"),
        ("    for (int s = qe - 1; s >= q0; --s) {\n      const float ks",
         "    for (int s = q0 - 1; s >= q0; --s) {\n      const float ks")]
_DIAG = [("    if (t < n) {\n#pragma unroll\n      for (int i0 = 4 * g;",
          "    if (t < 0) {\n#pragma unroll\n      for (int i0 = 4 * g;")]
_OFFDIAG = [("  for (int tile = tid; tile < L::NPAIR",
             "  for (int tile = tid; tile < 0 * L::NPAIR")]
_Y = [("  for (int i = 0; i < HS; ++i)\n    fma2x4",
       "  for (int i = 0; i < 0; ++i)\n    fma2x4"),
      ("  for (int s = 0; s < s_end; ++s)", "  for (int s = 0; s < 0; ++s)")]
#: name: edits of the source
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [], "no_pre": _PRE, "no_diag": _DIAG,
    "no_offdiag": _OFFDIAG, "no_y": _Y,
    "only_load": _PRE + _DIAG + _OFFDIAG + _Y,
}
T, H, HS = 1024, 64, 64


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Compile every variant in parallel (one nvcc each); their
    libraries bound to the kernel's C interface."""
    out = build.BUILD_DIR.parent / "wkv6_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "common.cuh").write_text((build.SRC_DIR / "common.cuh")
                                    .read_text())
    src = (build.SRC_DIR / "wkv6.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
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
        lib.repro_wkv6.argtypes = wk._ARGTYPES["repro_wkv6"]
        lib.repro_wkv6.restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(fn, iters: int = 10) -> Dict[str, float]:
    """Mean device time of each WKV6 launch of ``fn``, by kernel name."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in ("wkv6_chunk_state", "wkv6_chunk_scan",
                     "wkv6_chunk_out"):
            if name in e.key:
                out[name] = e.self_device_time_total / e.count / 1e3
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_variants: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = (randn(1, T, H, HS) for _ in range(3))
    w = torch.sigmoid(randn(1, T, H, HS)) * 0.5 + 0.4
    u = randn(H, HS) * 0.1
    s0 = randn(1, H, HS, HS) * 0.1
    y, s_t = torch.empty_like(r), torch.empty_like(s0)
    want = ref.wkv6_ref(r, k, v, w, u, s0)
    rows = []
    for chunk in wk.CHUNKS:
        plan = wk.chunk_plan(1, T, H, HS, torch.float32, chunk)
        scratch = torch.empty(wk.scratch_floats(1, H, HS, plan),
                              device="cuda")
        row = {"C": chunk}
        for name, lib in libs.items():
            def call(lib=lib):
                err = lib.repro_wkv6(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), s0.data_ptr(), y.data_ptr(),
                    s_t.data_ptr(), 0, 1, T, H, HS, r.stride(0),
                    r.stride(1), r.stride(2), chunk, scratch.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            call()
            if name == "kernel" and not (
                    torch.allclose(y, want[0], rtol=1e-4, atol=1e-4)
                    and torch.allclose(s_t, want[1], rtol=1e-4, atol=1e-4)):
                raise AssertionError(f"kernel at C={chunk} is wrong")
            row[name] = device_ms(call)
        rows.append(row)
    print(json.dumps({"card": card, "shape": {"B": 1, "T": T, "H": H,
                                              "hs": HS}, "rows": rows}))


if __name__ == "__main__":
    main()
