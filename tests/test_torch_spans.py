"""The port's host spans (``Tracer(spans=True)``) and the engine's
always-on counters, on tiny engines driven by ``Scheduler.tick`` on the
CPU: one ``host.tick`` tree a call, children nested in their parents
and disjoint from their siblings, one growth pass a decoding tick (the
1-step fallback's too), one token fetch a decoding tick, request ids,
the clock mapping, and tokens unchanged with the tracer on."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.obs import export_perfetto  # noqa: E402
from repro_torch.obs.tracer import (EVENT_KINDS, NULL_TRACER,  # noqa: E402
                                    SPAN_KINDS, Tracer)
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import scheduler as TS  # noqa: E402

PROMPTS = np.array([9, 17, 5, 30, 12, 24])
EPS = 1e-9           # seconds: spans share one clock, so only rounding

# name -> EngineConfig overrides
ENGINES = {
    # fused horizons, and the k <= 1 fallback at a page edge
    "fused": dict(paged=True, page_size=8, prefill_chunk=8, fuse_steps=8),
    "per_step": dict(paged=True, page_size=8, prefill_chunk=8),
    "shared_fused": dict(paged=True, page_size=8, prefill_chunk=4,
                         fuse_steps=4, prefix_sharing=True),
    "dense_chunked": dict(prefill_chunk=8),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One host thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def entry():
    return TR.get("yi-6b", reduced=True)


@pytest.fixture(scope="module")
def params(entry):
    return entry.module.init(entry.config, 1, device="cpu", seed=0)


@pytest.fixture(scope="module")
def traced(entry, params):
    """``name`` -> (engine, tracer, requests, calls, spans by event
    index) of one traced run of that engine, made once."""
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = _traced(entry, params, name)
        return runs[name]
    return get


def _engine(entry, params, name, **extra):
    ecfg = TE.EngineConfig(device="cpu", max_batch=3, max_seq=64,
                           max_new_tokens=12, **dict(ENGINES[name], **extra))
    return TE.make_engine(entry, ecfg, params=params)


def _reqs(entry, name):
    if name == "shared_fused":
        return TS.make_shared_prefix_trace(entry.config.vocab,
                                           rate_req_s=1e9, n_requests=4,
                                           prefix_len=19, tail_len=3, seed=3)
    return TS.make_trace(entry.config.vocab, rate_req_s=1e9,
                         n_requests=len(PROMPTS), prompt_len=0,
                         prompt_lens=PROMPTS, seed=3)


def _drive(eng, reqs, after_tick=None):
    """Tick a scheduler over ``reqs`` until all finish; returns the
    number of calls."""
    sched = TS.Scheduler(eng)
    sched.enqueue(reqs)
    calls = 0
    while len(eng.completed) < len(reqs):
        sched.tick(1e9)
        calls += 1
        if after_tick is not None:
            after_tick(eng)
        assert calls < 500
    return calls


def _traced(entry, params, name):
    eng = _engine(entry, params, name)
    tracer = Tracer(spans=True)
    eng.set_tracer(tracer)
    reqs = _reqs(entry, name)
    calls = _drive(eng, reqs)
    spans = {i: e for i, e in enumerate(tracer.events)
             if e.kind in SPAN_KINDS}
    return eng, tracer, reqs, calls, spans


def _children(spans, i):
    return sorted((j for j, e in spans.items()
                   if e.args["parent"] == i), key=lambda j: spans[j].ts)


def _ancestors(spans, i):
    out, p = [], spans[i].args["parent"]
    while p >= 0:
        out.append(spans[p].kind)
        p = spans[p].args["parent"]
    return out


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_one_tick_root_per_call(traced, name):
    _, _, _, calls, spans = traced(name)
    roots = [e for e in spans.values() if e.args["parent"] < 0]
    assert len(roots) == calls
    assert all(e.kind == "host.tick" for e in roots)
    assert all(e.args["parent"] >= 0 for e in spans.values()
               if e.kind != "host.tick")


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_spans_nest_and_siblings_are_disjoint(traced, name):
    _, _, _, _, spans = traced(name)
    for i, e in spans.items():
        p = e.args["parent"]
        if p >= 0:
            par = spans[p]
            assert par.ts - EPS <= e.ts
            assert e.ts + e.dur <= par.ts + par.dur + EPS
        kids = _children(spans, i)
        for a, b in zip(kids, kids[1:]):
            assert spans[a].ts + spans[a].dur <= spans[b].ts + EPS
        assert e.dur - sum(spans[c].dur for c in kids) >= -EPS


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_one_fetch_a_decoding_tick(traced, name):
    _, _, _, _, spans = traced(name)
    decoding = 0
    for i, e in spans.items():
        if e.kind != "host.tick" or not e.args["horizon"]:
            continue
        decoding += 1
        fetches = [j for j, f in spans.items() if f.kind == "host.fetch"
                   and i == _root(spans, j)
                   and "host.chunk" not in _ancestors(spans, j)]
        assert len(fetches) == 1
    assert decoding > 0
    # the last chunk of each prompt fetches its first token inside it
    last = [j for j, f in spans.items() if f.kind == "host.fetch"
            and "host.chunk" in _ancestors(spans, j)]
    assert last


def _root(spans, j):
    while spans[j].args["parent"] >= 0:
        j = spans[j].args["parent"]
    return j


def test_fallback_tick_grows_twice(traced):
    """The fallback tick (horizon 1) no longer grows twice: it replays
    the 1-step graph instead of calling ``step()``, whose second growth
    pass grew nothing.  Every decoding tick, of either horizon, has one
    ``host.grow`` child."""
    _, _, _, _, spans = traced("fused")
    seen = {1: 0, 2: 0}
    for i, e in spans.items():
        if e.kind != "host.tick" or not e.args["horizon"]:
            continue
        grows = [j for j in _children(spans, i)
                 if spans[j].kind == "host.grow"]
        assert len(grows) == 1
        seen[min(e.args["horizon"], 2)] += 1
    assert seen[1] and seen[2]


@pytest.mark.parametrize("name", ["fused", "per_step", "dense_chunked"])
def test_request_spans_carry_their_rid(traced, name):
    _, _, reqs, _, spans = traced(name)
    chunked = {}
    for e in spans.values():
        if e.kind == "host.chunk":
            chunked[e.rid] = chunked.get(e.rid, 0) + e.args["tokens"]
    assert chunked == {r.rid: len(r.prompt) for r in reqs}
    admitted = [e.rid for e in spans.values()
                if e.kind == "host.admit" and e.args["admitted"]]
    assert admitted == [r.rid for r in reqs]


def test_tick_args_and_counters_agree(traced):
    eng, _, _, calls, spans = traced("fused")
    c = eng.counters()
    ticks = [e for e in spans.values() if e.kind == "host.tick"]
    assert c["ticks"] == calls == len(ticks)
    assert c["chunk_ticks"] == sum(1 for e in ticks
                                   if e.args["chunk_tokens"])
    assert c["decode_ticks"] == sum(1 for e in ticks if e.args["horizon"])
    assert c["decode_steps"] == sum(e.args["horizon"] for e in ticks)
    clamps = [e.args["clamp"] for e in ticks if e.args["horizon"]]
    for why in ("fuse_steps", "page_edge", "budget"):
        assert c["clamp_" + why] == clamps.count(why)
    assert c["clamp_page_edge"] > 0
    assert c["admissions"] == c["finishes"] == len(PROMPTS)
    assert c["decode_lanes"] == sum(len(r.tokens_out) - 1
                                    for r in eng.completed)
    assert c["pages_grown"] == sum(e.args["pages"] for e in spans.values()
                                   if e.kind == "host.grow")
    # every step of the fused engine ran through a graph
    assert c["graph_steps"] == c["decode_steps"]


def test_counters_run_without_a_tracer(entry, params):
    eng = _engine(entry, params, "per_step")
    assert eng.tracer is NULL_TRACER
    _drive(eng, _reqs(entry, "per_step"))
    c = eng.counters()
    assert c["ticks"] > c["decode_ticks"] > 0
    assert c["clamp_fuse_steps"] == c["decode_ticks"] == c["decode_steps"]
    assert c["graph_steps"] == 0


def test_default_tracer_records_no_host_span(entry, params):
    """A plain ``Tracer()`` records the reference's lifecycle events
    alone, so both packages' streams stay comparable."""
    eng = _engine(entry, params, "fused")
    tracer = Tracer()
    eng.set_tracer(tracer)
    _drive(eng, _reqs(entry, "fused"))
    kinds = {e.kind for e in tracer.events}
    assert kinds <= set(EVENT_KINDS) and "fused_tick" in kinds


def test_wall_clock_mapping_brackets_a_span():
    tracer = Tracer(spans=True)
    w0 = time.time_ns()
    i = tracer.begin("host.tick")
    time.sleep(0.002)
    tracer.end(i)
    w1 = time.time_ns()
    time.sleep(0.001)
    tracer.stop()
    a, b = tracer.wall_ns(tracer.events[i])
    slack = 50_000                      # ns between the anchor's readings
    assert w0 - slack <= a < b <= w1 + slack
    assert b - a >= 2_000_000 - slack


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_tokens_identical_tracer_on_off(entry, params, traced, name):
    off = _engine(entry, params, name)
    _drive(off, _reqs(entry, name))
    on = traced(name)[0]
    assert ({r.rid: (r.tokens_out, r.finish_reason) for r in off.completed}
            == {r.rid: (r.tokens_out, r.finish_reason)
                for r in on.completed})


def test_fused_tick_tokens_share_the_fetch_stamp(entry, params):
    """Every token of a fused horizon is stamped when the fetch returned,
    the first moment a client can have any of them."""
    eng = _engine(entry, params, "fused")
    reqs = _reqs(entry, "fused")
    sched = TS.Scheduler(eng)
    sched.enqueue(reqs)
    shared = 0
    while len(eng.completed) < len(reqs):
        before = {r.rid: len(r.token_times) for r in reqs}
        t0 = time.perf_counter()
        sched.tick(1e9)
        t1 = time.perf_counter()
        if eng.tick_args()["horizon"] < 2:
            continue
        for r in reqs:
            new = r.token_times[before[r.rid]:]
            if new:
                assert len(set(new)) == 1 and t0 < new[0] < t1
                shared += len(new) > 1
    assert shared > 0


def test_perfetto_puts_host_spans_on_their_own_lane(traced):
    _, tracer, _, calls, _ = traced("per_step")
    obj = export_perfetto(tracer.events)
    names = {e["tid"]: e["args"]["name"] for e in obj["traceEvents"]
             if e["name"] == "thread_name"}
    assert names[-1] == "host" and names[0] == "engine"
    ticks = [e for e in obj["traceEvents"] if e["name"] == "host.tick"]
    assert len(ticks) == calls and {e["tid"] for e in ticks} == {-1}
    assert all(e["tid"] != -1 for e in obj["traceEvents"]
               if e["ph"] == "X" and not e["name"].startswith("host."))
