"""The port's invariant checks (``repro_torch.analysis.checks``).

The counterparts of the reference's ``tests/test_checks.py``: the three
passes land clean on the port, each regression fixture (a historical bug
re-introduced into port-shaped code) is flagged with the reference's
invariant ids at a location in the port's fixture file, and the CLI
exits 0 clean / 1 on findings.  Beside them: the allocator pass explores
as many states as the reference's and finds the same minimal
counterexample traces op for op; the fixtures the reference can still
run give its invariant ids; the engine's ``device`` field is the one
declared one-sided name; the kernel probes catch a plain version that
lets a NaN past a length through.
"""
import time

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import checks as JC  # noqa: E402
from repro.analysis.checks import allocator_model as JAM  # noqa: E402
from repro_torch.analysis.checks import (FIXTURE_NAMES, run_all,  # noqa: E402
                                         run_fixture, run_pass)
from repro_torch.analysis.checks import allocator_model as TAM  # noqa: E402
from repro_torch.analysis.checks.__main__ import main as checks_main  # noqa: E402

#: fixtures whose reference pass still runs (the reference's kernel lint
#: imports ``jax.core.Literal``, which jax 0.9 no longer has)
REF_RUNNABLE = ("pr2-refcount-free", "pr6-metrics-drift",
                "pr8-fused-double-count", "pr9-metrics-unregistered",
                "pr10-ship-trie-drop")


# --- the port itself is clean ------------------------------------------
def test_repo_clean_kernel_aliasing():
    assert run_pass("kernel-aliasing", "cpu") == []


def test_repo_clean_allocator_model_under_budget():
    t0 = time.time()
    assert run_pass("allocator-model", "cpu") == []
    assert time.time() - t0 < 60          # the CI budget, with margin


def test_repo_clean_mirror_drift():
    assert run_pass("mirror-drift", "cpu") == []


# --- seeded regressions are flagged with actionable locations ----------
def test_scatter_clip_fixture_flags_all_three_invariants():
    findings = run_fixture("pr2-scatter-clip")
    invariants = {f.invariant for f in findings}
    assert {"scatter-window-guard", "scatter-scratch-route",
            "scatter-active-guard"} <= invariants
    for f in findings:
        assert f.file and f.file.endswith("pr2_scatter_clip.py")
        assert f.line and f.line > 0
        assert "pr2_scatter_clip.py" in f.location


def test_inactive_lane_fixture_flagged_at_function():
    findings = run_fixture("pr2-inactive-lane")
    assert findings
    assert all(f.invariant == "host-inactive-lane" for f in findings)
    f = findings[0]
    assert f.file.endswith("pr2_inactive_lane.py") and f.line > 0
    assert "_decode_paged_kernel" in f.message


def test_refcount_fixture_yields_minimal_counterexample_traces():
    findings = run_fixture("pr2-refcount-free")
    assert findings
    shared_free = [f for f in findings
                   if "reference(s) remain" in f.message]
    assert shared_free, "the shared-page free was not caught"
    f = shared_free[0]
    assert f.file.endswith("pr2_refcount_free.py")
    assert "minimal op trace" in f.detail
    # BFS order: the very shortest reproduction is alloc/incref/decref
    steps = [ln for ln in f.detail.splitlines()
             if ln.strip() and ln.strip()[0].isdigit()]
    assert len(steps) == 3
    cross = [f for f in findings if "cross-region" in f.message]
    assert cross, "the cross-region defrag move was not caught"
    assert "defrag()" in cross[0].detail


def test_metrics_drift_fixture_flags_dropped_key():
    findings = run_fixture("pr6-metrics-drift")
    assert findings
    f = findings[0]
    assert f.invariant == "cluster-aggregation"
    assert "substrate_configs" in f.message
    assert f.file.endswith("pr6_metrics_drift.py") and f.line > 0


def test_fused_double_count_fixture_flagged():
    findings = run_fixture("pr8-fused-double-count")
    assert findings
    assert all(f.invariant == "fused-emit-guard" for f in findings)
    f = findings[0]
    assert f.file.endswith("pr8_fused_double_count.py") and f.line > 0
    assert "_apply_fused" in f.message


def test_metrics_unregistered_fixture_flagged():
    findings = run_fixture("pr9-metrics-unregistered")
    assert findings
    assert all(f.invariant == "unregistered-metric" for f in findings)
    f = findings[0]
    assert "decode_watts" in f.message
    assert f.file.endswith("pr9_metrics_unregistered.py") and f.line > 0


def test_ship_trie_drop_fixture_flagged():
    findings = run_fixture("pr10-ship-trie-drop")
    assert findings
    assert all(f.invariant == "ship-integrity" for f in findings)
    assert "trie" in findings[0].message
    assert findings[0].file.endswith("pr10_ship_trie_drop.py")


def test_metric_contract_clean_and_stale_entry_flagged(monkeypatch):
    """The port's Scheduler/Router surfaces match the metric-name
    contract exactly; a contract entry without an emitter is a
    stale-contract finding."""
    from repro_torch.analysis.checks import mirror_drift, mirror_spec
    assert mirror_drift.check_metrics_registered() == []
    monkeypatch.setattr(
        mirror_spec, "SCHEDULER_METRIC_CONTRACT",
        tuple(mirror_spec.SCHEDULER_METRIC_CONTRACT) + ("decode_watts",))
    findings = mirror_drift.check_metrics_registered()
    assert any(f.invariant == "stale-contract"
               and "decode_watts" in f.message for f in findings)


def test_stale_contract_entries_are_findings(monkeypatch):
    """The contract file itself is checked: an entry naming a metric
    that no longer exists must surface, not rot silently."""
    from repro_torch.analysis.checks import mirror_drift, mirror_spec
    monkeypatch.setattr(
        mirror_spec, "ROUTER_MUST_AGGREGATE",
        list(mirror_spec.ROUTER_MUST_AGGREGATE) + ["modeled_flops"])
    findings = mirror_drift.check_router_aggregation()
    assert any(f.invariant == "stale-contract"
               and "modeled_flops" in f.message for f in findings)


# --- CLI contract -------------------------------------------------------
def test_cli_exit_codes(capsys):
    assert checks_main(["--pass", "mirror-drift", "-q"]) == 0
    out = capsys.readouterr().out
    assert "OK (0 findings)" in out
    for name in ("pr6-metrics-drift", "pr2-scatter-clip"):
        assert checks_main(["--fixture", name, "-q"]) == 1
        out = capsys.readouterr().out
        assert "finding(s)" in out


def test_cli_kernel_probes_need_a_device_named(capsys, monkeypatch):
    """The kernel probes run on the card by default: without one the CLI
    refuses rather than probe the plain versions; ``--device cpu`` asks
    for them, and the probes' errors are collected."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        checks_main(["--pass", "kernel-aliasing", "-q"])
    assert "--device cpu" in capsys.readouterr().err
    assert checks_main(["--pass", "kernel-aliasing", "--device", "cpu",
                        "-q"]) == 0
    errs = {}
    assert run_all("cpu", ["kernel-aliasing"], errs=errs) == []
    assert errs and all(e == 0.0 for e in errs.values())


def test_cli_rejects_unknown_fixture():
    with pytest.raises(SystemExit):
        checks_main(["--fixture", "no-such-fixture"])
    assert set(FIXTURE_NAMES) == {"pr2-scatter-clip", "pr2-inactive-lane",
                                  "pr2-refcount-free", "pr6-metrics-drift",
                                  "pr8-fused-double-count",
                                  "pr9-metrics-unregistered",
                                  "pr10-ship-trie-drop"}
    assert FIXTURE_NAMES == JC.FIXTURE_NAMES
    assert JC.PASS_NAMES == ("kernel-aliasing", "allocator-model",
                             "mirror-drift")


# --- against the reference ----------------------------------------------
@pytest.mark.parametrize("name", REF_RUNNABLE)
def test_fixture_invariants_equal_the_reference(name):
    want = [(f.pass_name, f.invariant) for f in JC.run_fixture(name)]
    got = [(f.pass_name, f.invariant) for f in run_fixture(name)]
    assert got == want


def _traces(findings):
    return [(f.invariant, f.message, f.detail) for f in findings]


def test_allocator_counterexample_traces_equal_the_reference():
    from repro.analysis.checks.fixtures import pr2_refcount_free as jfx
    from repro_torch.analysis.checks.fixtures import pr2_refcount_free as tfx
    cfg = dict(num_pages=4, depth=4, placed=False)
    assert _traces(TAM.explore(
        TAM.ModelConfig(**cfg),
        allocator_cls=tfx.RefcountIgnoringAllocator)) == _traces(JAM.explore(
            JAM.ModelConfig(**cfg),
            allocator_cls=jfx.RefcountIgnoringAllocator))
    assert _traces(TAM.explore(
        TAM.ModelConfig(depth=3),
        defrag_mapping=tfx.cross_region_defrag_mapping)) == \
        _traces(JAM.explore(JAM.ModelConfig(depth=3),
                            defrag_mapping=jfx.cross_region_defrag_mapping))


@pytest.mark.parametrize("cfg", [dict(depth=5),
                                 dict(num_pages=4, placed=False)],
                         ids=["placed", "unplaced"])
def test_allocator_explores_the_reference_states(cfg):
    logs = {}
    for name, mod in (("ref", JAM), ("port", TAM)):
        lines = []
        assert mod.explore(mod.ModelConfig(**cfg), log=lines.append) == []
        logs[name] = lines[0].split(" in ")[0]
    assert logs["port"] == logs["ref"]
    assert "explored" in logs["port"]


def test_engine_device_is_the_declared_one_sided_config(monkeypatch):
    from repro_torch.analysis.checks import mirror_drift, mirror_spec
    assert "device" in mirror_spec.ENGINE_ONLY_CONFIG
    declared = dict(mirror_spec.ENGINE_ONLY_CONFIG)
    declared.pop("device")
    monkeypatch.setattr(mirror_spec, "ENGINE_ONLY_CONFIG", declared)
    findings = mirror_drift.check_engine_sim_config()
    assert [(f.invariant, "'device'" in f.message) for f in findings] == \
        [("config-mirror", True)]


def test_probe_catches_a_plain_version_reading_past_lengths(monkeypatch):
    """A flash decode that lets V past a length into its product (0 x NaN)
    is a finding; the port's plain version and the CUDA kernels zero
    them."""
    import math
    from repro_torch.analysis.checks import kernel_lint
    from repro_torch.kernels import ref

    def unguarded(q, k, v, lengths):
        b, hq, d = q.shape
        hkv = k.shape[2]
        qr = q.reshape(b, hkv, hq // hkv, d).float() / math.sqrt(d)
        s = torch.einsum("bhgd,bshd->bhgs", qr, k.float())
        valid = (torch.arange(k.shape[1])[None, :]
                 < lengths[:, None])[:, None, None, :]
        p = torch.softmax(torch.where(valid, s, -math.inf), -1)
        p = torch.nan_to_num(p)
        out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
        return out.reshape(b, hq, d).to(q.dtype)

    monkeypatch.setattr(ref, "flash_decode_ref", unguarded)
    findings = kernel_lint.lint_flash_decode("cpu")
    assert {f.invariant for f in findings} == {"kernel-probe-finite"}
    assert any("flash_decode float32" in f.message for f in findings)
