"""Decode steps per decoding tick in the window: the most decode tokens
any request gained in the tick (1 on the per-step path, K for a fused
horizon of K)."""


def read(run):
    h = [t.horizon for t in run.ticks if t.steps]
    return sum(h) / len(h) if h else None
