"""Share of the window's ticks that advanced a prefill chunk (%)."""


def read(run):
    if not run.ticks or not run.chunks_sound:
        return None
    return 100.0 * sum(1 for t in run.ticks if t.chunk) / len(run.ticks)
