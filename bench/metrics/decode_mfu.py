"""The whole step's share of the chip's peak over the profiled slice (%):
the least time of the slice's work (each tick the larger of its FLOPs
over the bf16 peak and its bytes over the HBM bandwidth, from
``count/``) over the slice's wall time."""
from bench.metrics import _slice


def read(run):
    w = _slice.least(run)
    if w is None or w["least_s"] <= 0:
        return None
    return 100.0 * w["least_s"] / run.slice.window_s
