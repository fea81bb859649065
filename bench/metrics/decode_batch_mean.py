"""Slots in a decode step, over the window's decode steps: decode tokens
over decode steps."""


def read(run):
    steps = sum(t.horizon for t in run.ticks)
    if not steps:
        return None
    return sum(t.decode_tokens for t in run.ticks) / steps
