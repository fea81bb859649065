"""Host milliseconds a tick spends admitting requests (the engine's
``admit``: slot and prompt pages claimed): self time of the
``host.admit`` spans over the traced slice's ticks."""
from bench.harness import spans


def read(run):
    return spans.ms_per_tick(run, "host.admit")
