"""The paged flash-decode kernel's share of its roofline over the
profiled slice (%): bytes of q, of K/V over each lane's context and of
the output, over the HBM bandwidth, divided by the device time of the
``decode_*_kernel`` launches."""
from bench.harness import trace
from bench.metrics import _slice


def read(run):
    w = _slice.least(run)
    if w is None or w["flash_least_s"] <= 0:
        return None
    dev = run.slice.seconds(trace.FLASH_DECODE)
    return 100.0 * w["flash_least_s"] / dev if dev > 0 else None
