"""The general part of the benchmark: cell resolution, weights, the
driven window, the profiled slice and the correctness check."""
