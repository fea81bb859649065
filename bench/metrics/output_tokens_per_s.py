"""Tokens delivered to clients in the window over the window's length
(host clock): a request's tokens regenerated after a preemption are not
delivered twice."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(t.delivered for t in run.ticks) / run.window_s
