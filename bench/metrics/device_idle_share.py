"""Share of the profiled slice in which no operation ran on the device
(%): one minus the union of the device's kernel, copy and fill
intervals over the slice's wall time."""


def read(run):
    sl = run.slice
    if sl is None or sl.window_s <= 0 or not sl.ops:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
