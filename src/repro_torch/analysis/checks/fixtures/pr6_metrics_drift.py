"""Mirror-drift reproduction (AST fixture, never executed), cut from the
port's ``Router.metrics``.

A cluster roll-up that aggregates the co-design metrics it knew about
when it was written — and silently drops ``substrate_configs``, which
``Scheduler.metrics`` also emits.  Per-replica keys are picked up by
ad-hoc name matching, so a new key on the scheduler side changes nothing
here and the cluster report under-reports.
``mirror_drift.check_router_aggregation`` must flag the missing key.
"""


class Router:
    def metrics(self, wall: float, t0: float) -> dict:
        reconfigs = 0
        modeled_rate = 0.0
        util_sum, util_n = 0.0, 0
        for i, (eng, sch) in enumerate(zip(self.engines,
                                           self.schedulers)):
            m = sch.metrics(wall, t0)
            reconfigs += m.get("reconfigurations", 0)
            modeled_rate += m.get("modeled_tokens_per_s", 0.0)
            if m.get("modeled_time_s", 0.0) > 0:
                util_sum += m.get("array_util_mean", 0.0)
                util_n += 1
            # BUG: m["substrate_configs"] is never read — the scheduler
            # emits it, the cluster report silently drops it
        return {
            "reconfigurations": reconfigs,
            "modeled_tokens_per_s": modeled_rate,
            "array_util_mean": util_sum / util_n if util_n else 0.0,
        }
