"""Build the port's CUDA kernels with ``nvcc`` at first use.

Every ``csrc/*.cu`` source compiles, for ``sm_90a``, into a shared
library with a plain C interface that the kernel wrappers load with
``ctypes``.  Libraries go to ``build/repro_torch_kernels/`` at the root
of the checkout, named by a hash of the sources and the flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.
Stale sources compile in parallel, one ``nvcc`` each; a failed build
raises with the compiler's output.  The compiler's report for each
library (``-Xptxas -v``: registers, shared memory, spills) is kept
beside it as ``<library>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path(src: Path) -> Path:
    """Where ``src`` builds to: keyed on its bytes, the shared headers'
    bytes and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; returns the
    library of each source, by source stem."""
    todo = [s for s in sources() if not library_path(s).exists()]
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for src in todo:
            tmp = library_path(src).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, proc in jobs:
            log, _ = proc.communicate()
            library_path(src).with_suffix(".log").write_text(log)
            if proc.returncode:
                failed.append(f"{src.name} (nvcc exit {proc.returncode}):"
                              f"\n{log}")
            else:
                os.replace(tmp, library_path(src))
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    return {s.stem: library_path(s) for s in sources()}


def library(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built first if
    needed), with each exported function of ``argtypes`` bound to its
    argument types and an ``int`` (``cudaError_t``) result."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def launch(lib: ctypes.CDLL, fn: str, *args) -> None:
    """Call the launcher ``fn`` of ``lib``; raise if the launch failed."""
    err = getattr(lib, fn)(*args)
    if err:
        raise RuntimeError(f"{fn} launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")


def require_cuda(*ts) -> None:
    """Raise ``ValueError`` unless every tensor lies on one CUDA device."""
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("the CUDA kernels take tensors on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
