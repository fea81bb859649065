"""Shared by the readers of the profiled slice: the least seconds its
work needs, from the configuration's counts and the device's peaks."""


def least(run):
    """``counts.total`` over the slice's ticks, or None where there is no
    slice, no peak for the device, or the chunk counts are unsound."""
    sl = run.slice
    if sl is None or not sl.ticks or not run.peaks or not run.chunks_sound:
        return None
    return run.counts.total(((t.steps, t.chunk) for t in sl.ticks),
                            run.shape, run.peaks["bf16_flops_per_s"],
                            run.peaks["hbm_bytes_per_s"])
