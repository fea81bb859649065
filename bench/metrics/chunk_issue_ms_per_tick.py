"""Host milliseconds a tick spends on its prefill chunk (the slot's
window gathered, ``extend_step`` issued, the chunk scattered, the
prefix committed), its first-token fetch left out: self time of the
``host.chunk`` spans over the traced slice's ticks."""
from bench.harness import spans


def read(run):
    return spans.ms_per_tick(run, "host.chunk")
