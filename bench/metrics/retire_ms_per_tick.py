"""Host milliseconds a tick spends after its token fetch (tokens
appended, requests finished, slots and pages released): self time of
the ``host.retire`` spans over the traced slice's ticks."""
from bench.harness import spans


def read(run):
    return spans.ms_per_tick(run, "host.retire")
