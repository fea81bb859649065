"""The program's host spans and engine counters as the serving tick's
readers see them, on the CPU-sized cells: the counters give what the
harness infers from outside, the span readers read a slice of ticks,
and the idle, clock and coverage reductions of ``harness/spans.py``."""
import time
from types import SimpleNamespace

import pytest
import torch

from bench.harness import cell as cell_run
from bench.harness import spans as sp
from bench.harness import trace, weights, window
from bench.metrics import (admit_ms_per_tick, chunk_issue_ms_per_tick,
                           chunk_tick_share, decode_batch_mean,
                           decode_issue_ms_per_step, fused_horizon_mean,
                           grow_ms_per_tick, page_edge_clamp_share,
                           retire_ms_per_tick)
from bench.tests import tiny

SPAN_READERS = (admit_ms_per_tick, chunk_issue_ms_per_tick,
                grow_ms_per_tick, decode_issue_ms_per_step,
                retire_ms_per_tick)
SEED = 2 ** 31 + 7


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _served(config, mix):
    """The harness's engine, scheduler, backlog and observer for a
    CPU-sized cell, ramped until the window would open."""
    from repro_torch.models import registry
    from repro_torch.serving.engine import make_engine
    from repro_torch.serving.scheduler import RequestState, Scheduler
    c = tiny.cell(config, mix)
    cfg, traffic = c.config, c.traffic
    arch = cell_run.arch_config(cfg)
    ecfg = cell_run.engine_config(cfg, traffic, "cpu")
    eng = make_engine(registry.from_config(arch), ecfg,
                      params=weights.make(cfg, SEED, torch.device("cpu")))
    backlog = window.Backlog(traffic, arch.vocab, SEED, RequestState)
    obs = window.Observer(Scheduler(eng), backlog, ecfg.prefill_chunk,
                          pages_fn=eng.paged.pages_in_use)
    t_base = time.perf_counter()
    window.run_until(obs, backlog,
                     cell_run._opened(traffic, ecfg.max_batch), t_base)
    return eng, obs, backlog, t_base


def _ticks(obs, backlog, t_base, n):
    i0 = len(obs.ticks)
    window.run_until(obs, backlog, lambda o: len(o.ticks) - i0 >= n, t_base)
    return obs.ticks[i0:]


@pytest.mark.parametrize("case", tiny.CASES, ids=lambda c: ".".join(c))
def test_counters_give_what_the_harness_infers(case):
    eng, obs, backlog, t_base = _served(*case)
    c0 = eng.counters()
    ticks = _ticks(obs, backlog, t_base, 40)
    c = sp.delta(eng.counters(), c0)
    seen = SimpleNamespace(ticks=ticks, chunks_sound=obs.chunks_sound)
    assert obs.chunks_sound and c["ticks"] == len(ticks)
    assert chunk_tick_share.read(seen) == pytest.approx(
        100.0 * c["chunk_ticks"] / c["ticks"], rel=1e-12)
    assert decode_batch_mean.read(seen) == pytest.approx(
        c["decode_lanes"] / c["decode_steps"], rel=1e-12)
    assert fused_horizon_mean.read(seen) == pytest.approx(
        c["decode_steps"] / c["decode_ticks"], rel=1e-12)
    assert c["decode_ticks"] == sum(c["clamp_" + k] for k in
                                    ("fuse_steps", "page_edge", "budget"))


@pytest.mark.parametrize("case", tiny.CASES[:2], ids=lambda c: ".".join(c))
def test_span_readers_read_a_traced_slice(case):
    eng, obs, backlog, t_base = _served(*case)
    c0 = eng.counters()
    _ticks(obs, backlog, t_base, 10)
    c1 = eng.counters()
    tracer = sp.attach(eng)
    sl = _ticks(obs, backlog, t_base, 12)
    sp.detach(eng, tracer)
    _ticks(obs, backlog, t_base, 2)      # untraced again
    spans = sp.of(tracer)
    assert sp.ticks(spans) == len(sl)
    run = SimpleNamespace(spans=spans, counters=sp.delta(c1, c0))
    for reader in SPAN_READERS:
        assert reader.read(run) > 0, reader.__name__
    assert 0.0 <= page_edge_clamp_share.read(run) <= 100.0
    assert sp.coverage(spans) > 0.5
    # the slice's ticks on the profiler's clock: each span lies within
    # the harness's stamps of its tick
    roots = [s for s in spans if s.kind == "host.tick"]
    for s, t in zip(roots, sl):
        assert t.wall_ns[0] - 50_000 <= s.start_ns
        assert s.end_ns <= t.wall_ns[1] + 50_000


def test_readers_read_nothing_without_spans_or_counters():
    bare = SimpleNamespace(ticks=[], slice=None)
    for reader in SPAN_READERS + (page_edge_clamp_share,):
        assert reader.read(bare) is None


def test_untraced_run_attaches_no_tracer(monkeypatch):
    from repro_torch.obs.tracer import NULL_TRACER
    from repro_torch.serving import engine
    made = []
    real = engine.make_engine

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]
    monkeypatch.setattr(engine, "make_engine", spy)
    tiny.run(tiny.cell(), trace=False, ticks=4)
    assert len(made) == 1 and made[0].tracer is NULL_TRACER


def _span(kind, a, b, parent=-1):
    return sp.Span(kind, a, b, parent)


def _tree():
    """Two ticks: [100, 200) with a grow [110, 130) and a decode
    [130, 190) holding a fetch [170, 185); [300, 350) with a chunk
    [300, 340)."""
    spans = [_span("host.tick", 100, 200), _span("host.grow", 110, 130, 0),
             _span("host.decode", 130, 190, 0),
             _span("host.fetch", 170, 185, 2),
             _span("host.tick", 300, 350), _span("host.chunk", 300, 340, 4)]
    for i, s in enumerate(spans):
        if s.parent >= 0:
            spans[s.parent].children.append(i)
    return spans


def test_idle_by_span_takes_the_innermost_span():
    ops = [trace.DeviceOp("k", 0, 105), trace.DeviceOp("k", 150, 175),
           trace.DeviceOp("Memcpy DtoH (Device -> Pinned)", 175, 180),
           trace.DeviceOp("k", 320, 400)]
    sl = trace.Slice(window_s=4e-7, start_ns=0, end_ns=400, ops=ops)
    got = sp.idle_by_span(sl, _tree())
    assert got == pytest.approx({
        "host.tick": (110 - 105 + 200 - 190) / 1e9,
        "host.grow": 20 / 1e9, "host.decode": (150 - 130 + 190 - 185) / 1e9,
        "host.fetch": 5 / 1e9,
        sp.BETWEEN: (300 - 200) / 1e9, "host.chunk": 20 / 1e9})
    idle = sum(got.values())
    assert idle == pytest.approx((sl.window_s - sl.busy_s))
    share, lag = sp.fetch_clock(sl, _tree())
    assert share == 1.0 and lag == pytest.approx((185 - 180) / 1e3)


def test_self_time_and_coverage():
    spans = _tree()
    assert sp.self_ns(spans, 0) == 100 - 20 - 60
    assert sp.self_ns(spans, 2) == 60 - 15
    assert sp.self_seconds(spans, "host.tick") == (20 + 10) / 1e9
    assert sp.coverage(spans) == pytest.approx((0.8 + 0.8) / 2)
    run = SimpleNamespace(spans=spans)
    assert grow_ms_per_tick.read(run) == pytest.approx(1e3 * 20e-9 / 2)
