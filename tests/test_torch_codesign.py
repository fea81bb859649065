"""Live array-shape/dataflow co-design in the port against the reference
(mirrors ``tests/test_codesign.py``).

The tick model of the port's ``core`` copy against the offline scheduler
and the reference's tick model (decisions equal field by field), its
memoisation and reconfiguration accounting, and the codesign-enabled
engines: tokens exact with pricing on or off, and the modeled clock,
reconfigurations and utilization equal to the reference's as floats on
the same trace (all arrivals at t~0, so both sides tick the same
compositions).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import serving_sim as jss  # noqa: E402
from repro.core.hw import snake_system as j_snake  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.core.hw import (fixed_sa_system, mactree_system,  # noqa: E402
                                 snake_system)
from repro_torch.core.pipeline import decode_step  # noqa: E402
from repro_torch.core.schedule import exec_config, shape_profile  # noqa: E402
from repro_torch.core.serving_sim import (nmp_tick_model,  # noqa: E402
                                          simulate_serving)
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

SNAKE = snake_system()
SPEC = registry.get_config("llama3-70b").nmp_spec()
MOE_SPEC = registry.get_config("qwen3-30b-a3b").nmp_spec()


def _astuple(d):
    """A TickDecision as plain values (its enums by value)."""
    return tuple(v.value if hasattr(v, "value") else v
                 for v in dataclasses.astuple(d))


# --- TickLatencyModel vs the offline scheduler -------------------------
def test_tick_decision_matches_offline_schedule():
    tm = nmp_tick_model(SNAKE, SPEC, tp=8)
    d = tm.step(8, [4096] * 8)
    rep = decode_step(SNAKE, SPEC, 8, 4096, tp=8)
    assert d.config == exec_config(rep.op_execs)
    assert d.shapes == shape_profile(rep.op_execs)
    assert d.decode_s == pytest.approx(rep.time_s)
    assert d.prefill_s == 0.0
    ref = jss.nmp_tick_model(j_snake(), JR.get_config("llama3-70b")
                             .nmp_spec(), tp=8).step(8, [4096] * 8)
    assert (d.time_s, d.decode_s, d.util, str(d.shapes)) == \
        (ref.time_s, ref.decode_s, ref.util, str(ref.shapes))


def test_tick_prefill_chunk_priced_without_head():
    tm = nmp_tick_model(SNAKE, SPEC, tp=8)
    d = tm.step(0, [], prefill_tokens=256, prefill_ctx=2048)
    rep = decode_step(SNAKE, SPEC, 256, 2048, include_head=False, tp=8)
    assert d.prefill_s == pytest.approx(rep.time_s)
    assert d.decode_s == 0.0


def test_tick_latency_monotone_in_ctx_and_batch():
    tm = nmp_tick_model(SNAKE, SPEC, tp=8)
    times = [tm.step(8, [c] * 8).decode_s for c in (2048, 4096, 8192)]
    assert all(t1 >= t0 * 0.999 for t0, t1 in zip(times, times[1:]))
    fixed = nmp_tick_model(fixed_sa_system(16, 256), SPEC, tp=8)
    ftimes = [fixed.step(b, [4096] * b).decode_s for b in (4, 8, 16, 32)]
    assert all(t1 >= t0 * 0.999 for t0, t1 in zip(ftimes, ftimes[1:]))
    per_tok = [tm.step(b, [4096] * b).decode_s / b for b in (4, 8, 16, 32)]
    assert all(t1 <= t0 * 1.001 for t0, t1 in zip(per_tok, per_tok[1:]))


def test_tick_model_memoizes_on_shape_signature():
    tm = nmp_tick_model(SNAKE, SPEC, tp=8)
    d1 = tm.step(4, [1000, 1100, 900, 1024])
    n_cached = len(tm._cache)
    d2 = tm.step(4, [1010, 1090, 910, 1014])
    assert len(tm._cache) == n_cached
    assert d2 is d1


def test_reconfiguration_accounting_per_stream():
    jtm = jss.nmp_tick_model(j_snake(), JR.get_config("qwen3-30b-a3b")
                             .nmp_spec(), tp=8)
    tm = nmp_tick_model(SNAKE, MOE_SPEC, tp=8)
    profiles = set()
    for batch, pf in ((1, 0), (32, 0), (1, 256), (64, 0)):
        kw = dict(prefill_tokens=pf, prefill_ctx=2048, stream="a")
        d = tm.step(batch, [2048] * batch, **kw)
        assert _astuple(d) == _astuple(jtm.step(batch, [2048] * batch,
                                                **kw))
        profiles.add(d.shapes)
    assert len(profiles) > 1
    assert tm.reconfigurations == jtm.reconfigurations > 0
    before = tm.reconfigurations
    tm.step(1, [2048], stream="b")
    assert tm.reconfigurations == before
    fixed = nmp_tick_model(fixed_sa_system(16, 256), MOE_SPEC, tp=8)
    for batch, pf in ((1, 0), (32, 0), (1, 256), (64, 0)):
        fixed.step(batch, [2048] * batch, prefill_tokens=pf,
                   prefill_ctx=2048, stream="a")
    assert fixed.reconfigurations == 0
    assert len({s for s in fixed._last_shapes.values()}) == 1


def test_tick_model_is_decode_latency_model_compatible():
    tm = nmp_tick_model(SNAKE, SPEC, tp=8)
    assert tm(8, 4096) == pytest.approx(tm.step(8, [4096] * 8).time_s)


# --- simulate_serving mirror ------------------------------------------
SIM_KW = dict(rate_req_s=100.0, system="SNAKE", n_requests=4,
              input_len=512, output_len=32, max_batch=4,
              prefill_on_device=True, prefill_chunk=256)


def test_simulate_serving_tick_model_drives_clock():
    rep = simulate_serving(nmp_tick_model(SNAKE, SPEC, tp=8), SPEC,
                           **SIM_KW)
    assert rep.completed == 4
    assert rep.decoded_tokens == 4 * 32
    assert rep.makespan_s > 0 and rep.tokens_per_s > 0
    assert rep.substrate_configs >= 1
    assert 0.0 < rep.array_util_mean <= 1.0
    rf = simulate_serving(nmp_tick_model(fixed_sa_system(16, 256), SPEC,
                                         tp=8), SPEC, **SIM_KW)
    assert rf.decoded_tokens == rep.decoded_tokens
    assert rf.reconfigurations == 0
    jspec = JR.get_config("llama3-70b").nmp_spec()
    ref = jss.simulate_serving(jss.nmp_tick_model(j_snake(), jspec, tp=8),
                               jspec, **SIM_KW)
    assert (rep.makespan_s, rep.tokens_per_s, rep.array_util_mean,
            rep.reconfigurations) == (ref.makespan_s, ref.tokens_per_s,
                                      ref.array_util_mean,
                                      ref.reconfigurations)


# --- codesign engines (accounting channel) ----------------------------
@functools.lru_cache(maxsize=None)
def _weights():
    cfg = JR.get("yi-6b", reduced=True).config
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), cfg))
    return params_from_numpy(tree, registry.get("yi-6b",
                                                reduced=True).config,
                             device="cpu")


def _ecfg(**over):
    return dict(dict(max_batch=2, max_seq=64, max_new_tokens=4,
                     paged=True, page_size=8, prefill_chunk=16), **over)


def _port(trace_kw, maker="make_trace", **over):
    eng = TE.make_engine(registry.get("yi-6b", reduced=True),
                         TE.EngineConfig(device="cpu", **_ecfg(**over)),
                         params=_weights())
    eng.run_trace(getattr(tsched, maker)(512, rate_req_s=1e9, **trace_kw))
    return eng


def _reference(trace_kw, maker="make_trace", **over):
    eng = JE.make_engine(JR.get("yi-6b", reduced=True),
                         JE.EngineConfig(**_ecfg(**over)))
    eng.run_trace(getattr(jsched, maker)(512, rate_req_s=1e9, **trace_kw))
    return eng


def _toks(e):
    return {r.rid: list(map(int, r.tokens_out)) for r in e.completed}


TRACE = dict(n_requests=4, prompt_len=40, seed=3)


def test_codesign_engine_token_exact_and_reports():
    base = _port(TRACE)
    snake_eng = _port(TRACE, codesign=True)
    fixed_eng = _port(TRACE, codesign=True, codesign_rows=16)
    assert _toks(base) == _toks(snake_eng) == _toks(fixed_eng)
    assert base.codesign_report() == {}
    cd = snake_eng.codesign_report()
    assert cd["substrate"] == "SNAKE"
    assert cd["modeled_time_s"] > 0
    assert cd["substrate_configs"] >= 1
    assert fixed_eng.codesign_report()["reconfigurations"] == 0
    assert cd == _reference(TRACE, codesign=True).codesign_report()
    assert fixed_eng.codesign_report() == _reference(
        TRACE, codesign=True, codesign_rows=16).codesign_report()

    m = tsched.Scheduler(snake_eng).metrics(1.0, 0.0)
    assert m["codesign_substrate"] == "SNAKE"
    assert m["modeled_time_s"] == cd["modeled_time_s"]
    assert m["modeled_tokens_per_s"] > 0


def test_codesign_dense_engine_matches_reference():
    """The dense engine prices its ticks too (whole-prompt prefill)."""
    over = dict(paged=False, prefill_chunk=None, codesign=True)
    port, ref = _port(TRACE, **over), _reference(TRACE, **over)
    assert _toks(port) == _toks(ref)
    assert port.codesign_report() == ref.codesign_report()
    assert port.codesign_report()["modeled_time_s"] > 0


def test_codesign_spec_and_tp_override():
    eng = _port(dict(n_requests=2, prompt_len=24, seed=0), codesign=True,
                codesign_spec=SPEC, codesign_tp=8)
    assert eng._tick_model.spec is SPEC
    assert eng._tick_model.tp == 8
    assert eng.codesign_report()["modeled_time_s"] > 0
    ref = _reference(dict(n_requests=2, prompt_len=24, seed=0),
                     codesign=True,
                     codesign_spec=JR.get_config("llama3-70b").nmp_spec(),
                     codesign_tp=8)
    assert eng.codesign_report() == ref.codesign_report()


def test_chunked_prefill_skips_resident_prefix_token_exact():
    trace = dict(n_requests=5, prefix_len=24, tail_len=6, seed=4)
    maker = "make_shared_prefix_trace"
    dense = _port(trace, maker, max_batch=3, max_new_tokens=5,
                  paged=False, prefill_chunk=None)
    shared = _port(trace, maker, max_batch=3, max_new_tokens=5,
                   prefix_sharing=True, prefill_chunk=8, codesign=True)
    assert _toks(dense) == _toks(shared)
    assert shared.prefill_tokens_skipped > 0
    assert shared.kv_report()["prefill_skipped_tokens"] \
        == shared.prefill_tokens_skipped
    ref = _reference(trace, maker, max_batch=3, max_new_tokens=5,
                     prefix_sharing=True, prefill_chunk=8, codesign=True)
    assert shared.codesign_report() == ref.codesign_report()


# --- reconfiguration pricing (fill/drain penalty) ----------------------
def test_reconfig_cost_derived_from_array_geometry():
    sa = SNAKE.substrate
    cyc = sa.phys_rows + sa.phys_cols - 2 + sa.reconfig_cycles
    tm = nmp_tick_model(SNAKE, SPEC, tp=8)
    assert tm.reconfig_cost_s == pytest.approx(cyc / SNAKE.freq_hz)
    assert tm.reconfig_cost_s > 0
    assert nmp_tick_model(mactree_system(), SPEC).reconfig_cost_s == 0.0
    assert nmp_tick_model(SNAKE, SPEC, reconfig_cost_s=0.25
                          ).reconfig_cost_s == 0.25


def test_reconfiguration_pricing_dips_modeled_throughput():
    seq = ((1, 0), (32, 0), (1, 256), (64, 0), (32, 0))

    def run(tm):
        total = 0.0
        for batch, pf in seq:
            d = tm.step(batch, [2048] * batch, prefill_tokens=pf,
                        prefill_ctx=2048, stream="a")
            total += d.time_s + d.reconfig_s
        return total

    free = nmp_tick_model(SNAKE, MOE_SPEC, tp=8, reconfig_cost_s=0.0)
    t_free = run(free)
    assert free.reconfigurations > 0
    cost = 1e-3
    priced = nmp_tick_model(SNAKE, MOE_SPEC, tp=8, reconfig_cost_s=cost)
    t_priced = run(priced)
    assert priced.reconfigurations == free.reconfigurations
    assert t_priced == pytest.approx(
        t_free + cost * priced.reconfigurations)
    d1 = priced.step(32, [2048] * 32, stream="a")
    d2 = priced.step(32, [2048] * 32, stream="a")
    assert d2 is d1 and d2.reconfig_s == 0.0
    fixed = nmp_tick_model(fixed_sa_system(16, 256), MOE_SPEC, tp=8,
                           reconfig_cost_s=cost)
    for batch, pf in seq:
        d = fixed.step(batch, [2048] * batch, prefill_tokens=pf,
                       prefill_ctx=2048, stream="a")
        assert d.reconfig_s == 0.0
    assert fixed.reconfigurations == 0


def test_simulate_serving_charges_reconfigurations():
    free = simulate_serving(
        nmp_tick_model(SNAKE, MOE_SPEC, tp=8, reconfig_cost_s=0.0),
        MOE_SPEC, **SIM_KW)
    priced = simulate_serving(
        nmp_tick_model(SNAKE, MOE_SPEC, tp=8, reconfig_cost_s=5e-3),
        MOE_SPEC, **SIM_KW)
    assert priced.decoded_tokens == free.decoded_tokens
    assert priced.reconfigurations > 0
    assert priced.makespan_s > free.makespan_s
    assert priced.tokens_per_s < free.tokens_per_s


@pytest.mark.parametrize("fuse", [1, 4], ids=["per_tick", "fused"])
def test_engine_reconfig_cost_knob_charges_modeled_clock(fuse):
    """The engine's modeled clock pays time_s + reconfig_s per priced
    step, so the total penalty is exactly cost x reconfigurations; the
    fused tick prices each step of a horizon after its single fetch."""
    cost = 2e-3
    eng = TE.make_engine(registry.get("yi-6b", reduced=True),
                         TE.EngineConfig(device="cpu", fuse_steps=fuse,
                                         **_ecfg(codesign=True,
                                                 codesign_reconfig_cost_s=
                                                 cost)),
                         params=_weights())
    tm = eng._tick_model
    assert tm.reconfig_cost_s == cost
    seen = []
    orig = tm.step

    def recording_step(*a, **kw):
        d = orig(*a, **kw)
        seen.append(d)
        return d

    tm.step = recording_step
    eng.run_trace(tsched.make_trace(512, rate_req_s=1e9, **TRACE))
    assert seen
    assert eng.modeled_time_s == pytest.approx(
        sum(d.time_s + d.reconfig_s for d in seen))
    assert sum(d.reconfig_s for d in seen) == pytest.approx(
        cost * tm.reconfigurations)
    if fuse > 1:
        assert eng.fused_report()["fused_ticks"] > 0
        assert 0.0 < eng.pricing_host_s
    eng2 = TE.make_engine(registry.get("yi-6b", reduced=True),
                          TE.EngineConfig(device="cpu", max_batch=2,
                                          max_seq=64, max_new_tokens=4,
                                          paged=True, page_size=8,
                                          codesign=True),
                          params=_weights())
    assert eng2._tick_model.reconfig_cost_s > 0
