"""The fused engine's 1-step tick: when the horizon collapses to one step
(a slot at its page edge, or on its last token), the paged engine
replays the 1-step fused graph in place of the eager ``step()``.

On the CPU the graph's body runs eagerly, so this route runs here too.
It must give the per-step engine's tokens and finish reasons, and the
reference's fused engine's tokens, finish reasons, event stream and
``fused_ticks``, on the same trace and the reference's own reduced yi-6b
weights (bridged), in float32.  ``graph_steps`` counts every decode step
of the fused engine and none of the per-step one's.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.obs import tracer as jtracer  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.obs import tracer as ttracer  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

SKEWED = np.array([9, 17, 5, 30, 12, 24])
BASE = dict(max_batch=3, max_seq=48, max_new_tokens=6, paged=True,
            page_size=8, fuse_steps=8)
# name -> (EngineConfig overrides, trace maker, trace kwargs)
CASES = {
    # ragged prompts: the page edge keeps cutting the horizon to 1
    "skewed": (dict(), "make_trace",
               dict(n_requests=len(SKEWED), prompt_len=0,
                    prompt_lens=SKEWED, seed=3)),
    "skewed_kernel": (dict(use_pallas_decode=True), "make_trace",
                      dict(n_requests=len(SKEWED), prompt_len=0,
                           prompt_lens=SKEWED, seed=3)),
    # shared 16-token prefixes with 7 unique tokens in chunks of 4 (slots
    # mid-prompt hold live shared pages), pages placed by region
    "shared_chunked_placed": (
        dict(prefix_sharing=True, prefill_chunk=4, placement="affinity",
             placement_regions=2, max_seq=64, max_new_tokens=12),
        "make_shared_prefix_trace",
        dict(n_requests=5, prefix_len=16, tail_len=7, seed=2)),
}


def _trace(sched, name):
    _, maker, kw = CASES[name]
    return getattr(sched, maker)(512, rate_req_s=1e9, **kw)


def _streams(eng):
    return ({r.rid: list(r.tokens_out) for r in eng.completed},
            {r.rid: r.finish_reason for r in eng.completed})


def _events(tracer):
    """(kind, slot, rid, untimed args) of each traced event."""
    return [(e.kind, e.slot, e.rid,
             {k: v for k, v in e.args.items() if not k.endswith("_s")})
            for e in tracer.events]


@pytest.fixture(scope="module")
def weights():
    cfg = JR.get("yi-6b", reduced=True).config
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), cfg))
    return params_from_numpy(tree, TR.get("yi-6b", reduced=True).config,
                             device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(name):
    eng = JE.make_engine(JR.get("yi-6b", reduced=True), JE.EngineConfig(
        **dict(BASE, **CASES[name][0])))
    eng.set_tracer(jtracer.Tracer())
    metrics = eng.run_trace(_trace(jsched, name))
    return eng, metrics


@pytest.fixture(scope="module")
def runs(weights):
    """``(name, fuse_steps)`` -> (engine, metrics, eager ``step()``
    calls) of the port, run once each."""
    done = {}

    def get(name, fuse):
        if (name, fuse) not in done:
            eng = TE.make_engine(TR.get("yi-6b", reduced=True),
                                 TE.EngineConfig(device="cpu", **dict(
                                     BASE, **CASES[name][0],
                                     fuse_steps=fuse)), params=weights)
            eng.set_tracer(ttracer.Tracer())
            calls = {"step": 0}
            step = eng.step

            def counted():
                calls["step"] += 1
                return step()

            eng.step = counted
            metrics = eng.run_trace(_trace(tsched, name))
            done[(name, fuse)] = eng, metrics, calls["step"]
        return done[(name, fuse)]
    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_step_matches_per_step_and_reference(name, runs):
    eng, m, eager = runs(name, 8)
    per_step = runs(name, 1)[0]
    ref, jm = _reference(name)
    assert _streams(eng) == _streams(per_step) == _streams(ref)
    assert m["fused_ticks"] == jm["fused_ticks"] > 0
    # every horizon of one step took the graph, none the eager step
    assert eager == 0 and 1 in eng._fused_graphs
    assert eng._fused_graphs[1].n_steps == 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_step_events_match_reference(name, runs):
    """The 1-step tick traces ``decode_step``, never ``fused_tick``, so
    the event stream is the reference fused engine's, event by event."""
    eng = runs(name, 8)[0]
    got, want = _events(eng.tracer), _events(_reference(name)[0].tracer)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"event {i}: port {g} != reference {w}"
    kinds = [e.kind for e in eng.tracer.events]
    assert kinds.count("decode_step") > 0 and kinds.count("fused_tick") > 0
    per_step = [e.kind for e in runs(name, 1)[0].tracer.events]
    assert "fused_tick" not in per_step and "decode_step" in per_step


@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_steps_count_every_fused_engine_step(name, runs):
    eng, m, _ = runs(name, 8)
    c = eng.counters()
    assert c["graph_steps"] == c["decode_steps"] > 0
    # fused_ticks and the horizons count only horizons of 2 steps or more
    assert len(eng.fused_horizons) == m["fused_ticks"]
    assert min(eng.fused_horizons) >= 2
    ones = c["decode_ticks"] - m["fused_ticks"]
    assert ones > 0
    assert c["decode_steps"] == ones + sum(eng.fused_horizons)
    per_step = runs(name, 1)[0].counters()
    assert per_step["graph_steps"] == 0
    assert per_step["decode_lanes"] == c["decode_lanes"]
