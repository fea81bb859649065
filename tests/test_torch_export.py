"""The port's trace exporters against ``repro.obs.export`` (mirrors the
exporter tests of ``tests/test_obs.py``).

* Parity: events recorded by a reference ``Tracer`` (the analytic serving
  sim and the tiered cluster sim, on the modeled clock) are loaded into
  the port's ``TraceEvent``s; ``export_perfetto`` and ``trace_report``
  give the reference's output on them, and the port's own sims record
  the very same events.
* Round trips on the port: the Perfetto file is the returned document
  with monotone per-track timestamps; a replayed JSONL log is
  field-exact and reproduces the report; a live engine's trace exports
  with the phases summing to the makespan.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hw as jhw  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core import serving_sim as jsim  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import tracer as jtracer  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import serving_sim as tsim  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.obs import tracer as ttracer  # noqa: E402
from repro_torch.obs import (TraceEvent, Tracer, export_perfetto,  # noqa: E402
                             load_jsonl, save_jsonl, trace_report)
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

# package -> (hw, operators, serving_sim, tracer module)
PKGS = {"reference": (jhw, jops, jsim, jtracer),
        "port": (thw, tops, tsim, ttracer)}


def _serving(pkg, tracer):
    """``tests/test_obs.py``'s sim case: paged, chunked, fused."""
    hw, ops, sim, _ = PKGS[pkg]
    spec = ops.PAPER_MODELS["LLaMA3-70B"]
    lat = sim.nmp_latency_model(hw.snake_system(), spec, tp=8)
    return sim.simulate_serving(lat, spec, 0.5, system="SNAKE",
                                n_requests=8, input_len=256, output_len=48,
                                max_batch=4, cache_mode="paged",
                                page_size=16, prefill_on_device=True,
                                prefill_chunk=64, fuse_steps=8,
                                tracer=tracer)


def _tiered(pkg, tracer):
    """``tests/test_disagg.py``'s sim case: 2:2 tiers, priced ships."""
    hw, ops, sim, _ = PKGS[pkg]
    spec = ops.PAPER_MODELS["LLaMA3-70B"]
    system = hw.snake_system()
    lat = sim.nmp_latency_model(system, spec, tp=8)
    return sim.simulate_cluster(lat, spec, 50.0, n_replicas=4,
                                n_requests=12, input_len=512,
                                output_len=32, max_batch=4, page_size=64,
                                seed=0, tiers=(2, 2), tracer=tracer,
                                sys=system)


CASES = {"serving": _serving, "tiered": _tiered}


def _record(pkg, case):
    tr = PKGS[pkg][3].Tracer(t0=0.0)
    CASES[case](pkg, tr)
    return tr.events


@pytest.mark.parametrize("case", sorted(CASES))
def test_exports_match_reference_on_reference_events(case, tmp_path):
    ref = _record("reference", case)
    port = [TraceEvent.from_json(e.to_json()) for e in ref]
    assert [e.to_json() for e in port] == [e.to_json() for e in ref]
    want = jexport.export_perfetto(ref, str(tmp_path / "ref.json"))
    got = export_perfetto(port, str(tmp_path / "port.json"))
    assert got == want
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    assert trace_report(port) == jexport.trace_report(ref)
    if case == "tiered":
        assert trace_report(port)["phases"]["ship_s"] > 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_sims_record_the_reference_events(case):
    ref = _record("reference", case)
    port = _record("port", case)
    assert [e.to_json() for e in port] == [e.to_json() for e in ref]


def test_perfetto_roundtrip_monotone_tracks(tmp_path):
    events = _record("port", "serving")
    path = tmp_path / "trace.json"
    obj = export_perfetto(events, str(path))
    loaded = json.loads(path.read_text())
    assert loaded == json.loads(json.dumps(obj))
    evs = loaded["traceEvents"]
    assert any(e["ph"] == "X" for e in evs)
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    last = {}
    for e in evs:
        if e["ph"] not in ("X", "C"):
            continue
        key = (e["pid"], e["tid"])
        assert e["ts"] >= last.get(key, float("-inf")), \
            f"track {key} timestamps regressed"
        last[key] = e["ts"]


def test_jsonl_replay_reproduces_trace_report(tmp_path):
    events = _record("port", "tiered")
    path = tmp_path / "trace.jsonl"
    save_jsonl(events, str(path))
    replayed = load_jsonl(str(path))
    assert replayed == events
    assert trace_report(replayed) == trace_report(events)
    assert all(isinstance(e, TraceEvent) for e in replayed)
    assert trace_report([]) == jexport.trace_report([])


def test_engine_trace_exports_with_phases_summing_to_makespan(tmp_path):
    """A live port engine (reduced yi-6b, chunked, fused, shared) traced
    and exported: one process, an engine lane and one lane per slot, and
    phases that partition the makespan."""
    eng = TE.make_engine(TR.get("yi-6b", reduced=True), TE.EngineConfig(
        max_batch=3, max_seq=64, max_new_tokens=4, paged=True, page_size=8,
        prefix_sharing=True, prefill_chunk=4, fuse_steps=4, device="cpu"))
    tr = Tracer()
    eng.set_tracer(tr, replica=3)
    eng.run_trace(tsched.make_shared_prefix_trace(
        512, rate_req_s=500.0, n_requests=4, prefix_len=16, tail_len=5,
        seed=2))
    obj = export_perfetto(tr.events, str(tmp_path / "e.json"))
    names = {(e["pid"], e["tid"], e["args"]["name"])
             for e in obj["traceEvents"] if e["name"] == "thread_name"}
    assert (3, 0, "engine") in names
    assert any(e["ph"] == "C" and e["name"] == "free_pages"
               for e in obj["traceEvents"])
    assert {n for _, tid, n in names if tid} <= {"slot 0", "slot 1",
                                                 "slot 2"}
    rep = trace_report(tr.events)
    assert rep["finished"] == 4
    assert rep["events"]["fused_tick"] > 0
    assert sum(rep["phases"].values()) == pytest.approx(rep["makespan_s"])
    assert np.isclose(rep["phases"]["ship_s"], 0.0)
