"""A scheduler metric emitted without a contract entry (AST fixture,
never executed), cut from the port's ``Scheduler.metrics``.

``metrics`` returns the legitimate serving keys plus ``decode_watts`` —
a metric never registered in ``repro_torch.obs.metrics``'s
``SCHEDULER_METRIC_CONTRACT``.  ``mirror_drift.check_metrics_registered``
must flag the undeclared key (``unregistered-metric``): a metric the
registry never learns about is invisible to the exporters and the
mirror checker's report diffing.
"""


class Scheduler:
    """Minimal stand-in — only the ``metrics`` surface is analyzed."""

    def metrics(self, wall: float, t0: float) -> dict:
        return {"wall_s": wall,
                "requests": 0,
                "decoded_tokens": 0,
                "tokens_per_s": 0.0,
                # drifted: emitted but never declared in the contract
                "decode_watts": 0.0}
