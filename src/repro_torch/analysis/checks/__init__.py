"""Invariant checker suite over the port (CI gate:
``python -m repro_torch.analysis.checks``; port of
``repro.analysis.checks``).

Three passes over the serving stack, each returning
:class:`~repro_torch.analysis.checks.common.Finding` records:

* **kernel-aliasing** (:mod:`kernel_lint`) — traces the scatter paths to
  aten graphs and verifies scratch routing for inactive/out-of-window
  lanes; probes the kernels' entries with NaN past every valid position
  and NaN output sentinels (the CUDA kernels on the card, the plain
  versions on the CPU: ``run_all(device)``, no default).
* **allocator-model** (:mod:`allocator_model`) — exhaustive small-scope
  exploration of ``PageAllocator``/``PrefixIndex`` op sequences with
  minimal counterexample traces.
* **mirror-drift** (:mod:`mirror_drift`) — AST diff of the live engine
  against its analytic mirror (config knobs, metric keys, report
  fields) driven by the explicit contract in :mod:`mirror_spec`.

``run_fixture`` points a pass at a regression fixture re-introducing a
historical bug; the CLI must exit non-zero on every one of them.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from .common import Finding, render_report  # noqa: F401  (CLI re-export)

PASS_NAMES = ("kernel-aliasing", "allocator-model", "mirror-drift")

_FIXDIR = Path(__file__).resolve().parent / "fixtures"


def run_pass(name: str, device: str,
             log: Optional[Callable[[str], None]] = None,
             errs: Optional[Dict[str, float]] = None) -> List[Finding]:
    """One pass; ``device`` is where the kernel probes run ("cuda" or
    "cpu"), ``errs`` collects their largest errors by output."""
    if name == "kernel-aliasing":
        from . import kernel_lint
        return kernel_lint.run(device, errs)
    if name == "allocator-model":
        from . import allocator_model
        return allocator_model.run(log=log)
    if name == "mirror-drift":
        from . import mirror_drift
        return mirror_drift.run()
    raise ValueError(f"unknown pass {name!r} (know {PASS_NAMES})")


def run_all(device: str, passes: Optional[Sequence[str]] = None,
            log: Optional[Callable[[str], None]] = None,
            errs: Optional[Dict[str, float]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for name in passes or PASS_NAMES:
        findings += run_pass(name, device, log=log, errs=errs)
    return findings


# --- regression fixtures (seeded historical bugs) -------------------------
def _fx_scatter_clip(log=None) -> List[Finding]:
    from . import kernel_lint
    from .fixtures import pr2_scatter_clip as fx
    return kernel_lint.lint_scatter_token(fx.scatter_token_clipped)


def _fx_inactive_lane(log=None) -> List[Finding]:
    from . import kernel_lint
    return kernel_lint.check_inactive_lane_ast(
        path=str(_FIXDIR / "pr2_inactive_lane.py"))


def _fx_refcount_free(log=None) -> List[Finding]:
    from . import allocator_model as am
    from .fixtures import pr2_refcount_free as fx
    findings = am.explore(am.ModelConfig(num_pages=4, depth=4,
                                         placed=False),
                          allocator_cls=fx.RefcountIgnoringAllocator,
                          log=log)
    findings += am.explore(am.ModelConfig(depth=3),
                           defrag_mapping=fx.cross_region_defrag_mapping,
                           log=log)
    return findings


def _fx_metrics_drift(log=None) -> List[Finding]:
    from . import mirror_drift
    return mirror_drift.check_router_aggregation(
        router_path=str(_FIXDIR / "pr6_metrics_drift.py"))


def _fx_fused_double_count(log=None) -> List[Finding]:
    from . import mirror_drift
    return mirror_drift.check_fused_emit_guard(
        engine_path=str(_FIXDIR / "pr8_fused_double_count.py"))


def _fx_metrics_unregistered(log=None) -> List[Finding]:
    from . import mirror_drift
    return mirror_drift.check_metrics_registered(
        sched_path=str(_FIXDIR / "pr9_metrics_unregistered.py"))


def _fx_ship_trie_drop(log=None) -> List[Finding]:
    from . import allocator_model
    from .fixtures import pr10_ship_trie_drop as fx
    return allocator_model.check_ship_integrity(
        cache_cls=fx.TrieDroppingCache, log=log)


FIXTURES = {
    "pr2-scatter-clip": _fx_scatter_clip,
    "pr2-inactive-lane": _fx_inactive_lane,
    "pr2-refcount-free": _fx_refcount_free,
    "pr6-metrics-drift": _fx_metrics_drift,
    "pr8-fused-double-count": _fx_fused_double_count,
    "pr9-metrics-unregistered": _fx_metrics_unregistered,
    "pr10-ship-trie-drop": _fx_ship_trie_drop,
}
FIXTURE_NAMES = tuple(sorted(FIXTURES))


def run_fixture(name: str,
                log: Optional[Callable[[str], None]] = None
                ) -> List[Finding]:
    try:
        fn = FIXTURES[name]
    except KeyError:
        raise ValueError(
            f"unknown fixture {name!r} (know {FIXTURE_NAMES})") from None
    return fn(log=log)
