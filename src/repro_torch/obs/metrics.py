"""Metrics registry: counters, gauges, fixed-bucket histograms (a copy
of ``repro.obs.metrics``).

The single producer behind ``Scheduler.metrics``: it builds a
:func:`serving_registry`, feeds it the run's samples and reads every
statistical value back out of it.  Histograms keep the exact sample list
alongside the fixed bucket counts, so means and percentiles are exact
while the bucketed summaries (the ``"hists"`` metrics key) stay
export-friendly.

:data:`SCHEDULER_METRIC_CONTRACT` / :data:`ROUTER_METRIC_CONTRACT` are
the exact key sets the two ``metrics()`` dicts may emit; the port's
tests hold them equal to the reference's.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def pctl(xs: Sequence[float], q: float) -> float:
    """The one percentile helper (empty input -> 0.0, matching the
    legacy ad-hoc ``np.percentile`` call sites it replaced)."""
    xs = np.asarray(xs, dtype=float)
    return float(np.percentile(xs, q)) if xs.size else 0.0


class Counter:
    """Monotonic count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram that also retains the exact samples.

    ``buckets`` are upper bounds (le); one overflow bucket is implicit.
    ``mean`` / ``quantile`` are computed from the exact samples so the
    registry can stand behind the legacy metrics without changing a
    single reported number; ``summary()`` is the compact exportable view.
    """

    __slots__ = ("name", "buckets", "counts", "samples")

    def __init__(self, name: str, buckets: Sequence[float]):
        if not buckets:
            raise ValueError(f"histogram {name!r} needs at least 1 bucket")
        self.name = name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.samples.append(v)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def mean(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0

    def quantile(self, q: float) -> float:
        return pctl(self.samples, q)

    def summary(self) -> dict:
        b = {f"le_{ub:g}": c for ub, c in zip(self.buckets, self.counts)}
        b["inf"] = self.counts[-1]
        return {"count": self.count, "mean": self.mean,
                "p50": self.quantile(50), "p99": self.quantile(99),
                "buckets": b}


#: Standard fixed buckets per histogram instrument (seconds unless the
#: name says otherwise).  TTFT spans prefill work, TPOT is per-token
#: decode cadence, gather cost is the modeled block-table DMA time, the
#: fused horizon counts steps per scan, e2e covers whole requests.
DEFAULT_BUCKETS: Dict[str, Tuple[float, ...]] = {
    "ttft_s": (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0),
    "tpot_s": (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
               0.25, 1.0),
    "gather_cost_s": (1e-7, 5e-7, 1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 1e-3),
    "fused_horizon": (1, 2, 4, 8, 16, 32, 64, 128),
    "e2e_s": (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
}


class MetricsRegistry:
    """Name-keyed instrument store with get-or-create accessors."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            if buckets is None:
                buckets = DEFAULT_BUCKETS.get(name)
            if buckets is None:
                raise ValueError(f"histogram {name!r} has no default "
                                 f"buckets; pass them explicitly")
            h = self.histograms[name] = Histogram(name, buckets)
        return h

    def observe_all(self, name: str, values: Iterable[float]) -> Histogram:
        h = self.histogram(name)
        for v in values:
            h.observe(v)
        return h

    def summaries(self) -> dict:
        return {"counters": {k: c.value
                             for k, c in sorted(self.counters.items())},
                "gauges": {k: g.value
                           for k, g in sorted(self.gauges.items())},
                "histograms": {k: h.summary()
                               for k, h in sorted(
                                   self.histograms.items())}}


def serving_registry() -> MetricsRegistry:
    """Registry pre-declaring the serving-path histogram instruments."""
    reg = MetricsRegistry()
    for name in ("ttft_s", "tpot_s", "gather_cost_s", "fused_horizon",
                 "e2e_s"):
        reg.histogram(name)
    return reg


# ---------------------------------------------------------------------------
# The metric-name contracts
# ---------------------------------------------------------------------------
SCHEDULER_METRIC_CONTRACT: Tuple[str, ...] = (
    "wall_s", "requests", "decoded_tokens", "tokens_per_s",
    "tbt_mean_s", "tbt_p99_s", "ttft_mean_s", "tpot_mean_s",
    "preemptions", "finish_eos", "finish_budget",
    "kv_mode", "kv_reserved_tokens", "kv_peak_tokens",
    "kv_logical_peak_pages", "kv_shared_pages", "kv_dedup_ratio_peak",
    "cow_forks", "defrag_runs", "prefill_skipped_tokens",
    "kv_migrated_pages", "kv_migration_cost_s", "placement_policy",
    "kv_gather_cost_mean_s", "kv_gather_concentration", "kv_region_peak",
    "codesign_substrate", "modeled_time_s", "modeled_tokens_per_s",
    "reconfigurations", "substrate_configs", "array_util_mean",
    "fused_ticks", "fused_steps_mean", "fused_host_frac", "hists",
)

ROUTER_METRIC_CONTRACT: Tuple[str, ...] = (
    "policy", "replicas", "wall_s", "requests", "decoded_tokens",
    "tokens_per_s", "e2e_p50_s", "e2e_p99_s", "tbt_mean_s", "tbt_p99_s",
    "preemptions", "finish_eos", "finish_budget", "dedup_ratio_agg",
    "reconfigurations", "substrate_configs", "modeled_tokens_per_s",
    "array_util_mean", "tiers", "shipments", "shipped_pages",
    "ship_cost_s", "per_replica", "hists",
)
