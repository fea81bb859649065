"""Matrix products' share of their roofline over the profiled slice (%):
the least time of the slice's products (projections, FFN or experts,
router, head, and a chunk's attention products) over the device time of
the cuBLAS / CUTLASS kernels."""
from bench.harness import trace
from bench.metrics import _slice


def read(run):
    w = _slice.least(run)
    if w is None or w["gemm_least_s"] <= 0:
        return None
    dev = run.slice.seconds(trace.GEMM)
    return 100.0 * w["gemm_least_s"] / dev if dev > 0 else None
