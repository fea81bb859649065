"""Host milliseconds to issue one decode step (inputs to the device, the
table mirror, the forward's launches; a fused horizon's copies and
graph replay): self time of the ``host.decode`` spans over the decode
steps they issued, a fused replay of K steps counting K."""
from bench.harness import spans as sp


def read(run):
    spans = getattr(run, "spans", None)
    if not spans:
        return None
    steps = sum(s.args.get("steps", 0) for s in spans
                if s.kind == "host.decode")
    return 1e3 * sp.self_seconds(spans, "host.decode") / steps \
        if steps else None
