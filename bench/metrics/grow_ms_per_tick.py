"""Host milliseconds a tick spends growing page mappings before decode
(and forking shared pages): self time of the ``host.grow`` spans over
the traced slice's ticks."""
from bench.harness import spans


def read(run):
    return spans.ms_per_tick(run, "host.grow")
