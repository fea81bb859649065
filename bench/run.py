"""Run one cell of ``BENCHMARK.json`` once, on the card of this machine.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
untraced, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``check``: each number compared
beside its limit, also the last lines of standard error.

Exits non-zero and prints no result without a CUDA card (or with fewer
cards than the cell asks for), and when JAX, Flax or the JAX package
``repro`` is loaded once the window has closed.  Kernel builds and
caches stay under ``build/`` in the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; one
    intra-op thread on the host (the served path is one Python thread
    issuing to the card, and idle pool threads only add jitter)."""
    build = ROOT / "build"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules(modules=None) -> list:
    """Loaded modules (``sys.modules`` by default) whose top-level name
    is JAX's, Flax's or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch
    torch.set_num_threads(1)
    from bench.harness import cell as cell_run
    from bench.harness import spec
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = cell_run.run(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
