"""The port's multi-replica router against ``repro.serving.router``
(mirrors ``tests/test_serving_router.py`` and the tier-dispatch tests of
``tests/test_disagg.py``).

* Policies: a copy of the reference's stub replica drives both packages'
  ``Router``s through the same load reports, sessions and prefix
  residencies; the dispatch logs must be equal for every policy and for
  tiers, and the reference's policy and validation tests hold on the
  port.
* Cluster tokens: two replicas of reduced yi-6b in float32 with the
  reference's weights (bridged), the reference's ``ENG_KW`` and grouped
  trace, under each policy: tokens and finish reasons per rid equal the
  reference bare engine's (greedy decode does not depend on which
  replica runs a request, nor when), and prefix affinity's aggregate
  dedup is at least round robin's.  Dispatch follows the wall clock, so
  the logs of these runs are not compared.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import replica_api as japi  # noqa: E402
from repro.serving import router as JRT  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import replica_api as tapi  # noqa: E402
from repro_torch.serving import router as TRT  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

# the two packages side by side: (router module, replica_api, scheduler)
PACKAGES = {"reference": (JRT, japi, jsched), "port": (TRT, tapi, tsched)}


# ---------------------------------------------------------------------------
# Policy tests on stub replicas
# ---------------------------------------------------------------------------
class _StubReplica:
    """A copy of the reference's stub (``tests/test_serving_router.py``),
    reporting through either package's ``LoadReport``."""

    def __init__(self, api, free_pages=10, queue_depth=0, residency=None):
        class _E:
            page_size = 8
        self.api = api
        self.ecfg = _E()
        self.role = "mixed"
        self.requeue = []
        self.completed = []
        self.preemption_count = 0
        self.free_pages = free_pages
        self.queue_depth = queue_depth
        self.residency = residency or (lambda prompt: 0)
        self.imported = []

    def admit(self, req):
        return True

    def tick(self):
        return 0

    def load_report(self):
        return self.api.LoadReport(
            active=self.queue_depth, prefilling=0,
            queue_depth=self.queue_depth, free_slots=4,
            free_pages=self.free_pages, min_region_free=self.free_pages)

    def prefix_residency(self, prompt):
        return self.residency(prompt)

    def busy(self):
        return False

    def export_slot_pages(self, rid):
        raise KeyError(f"stub replica holds no request {rid}")

    def import_slot_pages(self, shipment):
        self.imported.append(shipment)
        return True


def _req(sched, rid, prompt=None, session=None):
    if prompt is None:
        prompt = np.arange(rid, rid + 8, dtype=np.int32)
    return sched.RequestState(rid, np.asarray(prompt, np.int32),
                              session=session)


PROMPT_A = np.arange(16, dtype=np.int32)
PROMPT_B = np.arange(100, 116, dtype=np.int32)


def _holds_a(prompt):
    """Residency of a replica that holds PROMPT_A's two leading pages."""
    return 2 if np.array_equal(prompt[:8], PROMPT_A[:8]) else 0


# name -> (stub kwargs per replica, requests as (rid, prompt, session))
SCENARIOS = {
    "even": ([{}, {}, {}],
             [(i, None, None) for i in range(6)]),
    "queues": ([dict(queue_depth=q) for q in (2, 0, 1, 0)],
               [(i, None, None) for i in range(5)]),
    "pages": ([dict(free_pages=f) for f in (3, 9, 6)],
              [(i, None, None) for i in range(4)]),
    "sessions": ([{}, {}],
                 [(0, None, 7), (1, None, 8), (2, None, 7), (3, None, 7),
                  (4, None, None), (5, None, 8)]),
    "prefixes": ([{}, dict(residency=_holds_a), {}],
                 [(0, PROMPT_A, None), (1, PROMPT_B, None),
                  (2, PROMPT_B, None), (3, PROMPT_A, None),
                  (4, PROMPT_B[::-1].copy(), None), (5, PROMPT_B, None)]),
}


def _dispatch(pkg, scenario, policy, tiers=None):
    router_mod, api, sched = PACKAGES[pkg]
    stubs, reqs = SCENARIOS[scenario]
    router = router_mod.Router([_StubReplica(api, **kw) for kw in stubs],
                               policy=policy, tiers=tiers)
    for rid, prompt, session in reqs:
        router.dispatch(_req(sched, rid, prompt, session))
    return router


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("policy", TRT.POLICIES)
def test_dispatch_log_matches_reference(policy, scenario):
    """The same stub states and requests give the same (rid, replica)
    log in both packages, under every policy."""
    logs = [_dispatch(pkg, scenario, policy).dispatch_log
            for pkg in PACKAGES]
    assert logs[0] == logs[1]
    assert len(logs[1]) == len(SCENARIOS[scenario][1])


@pytest.mark.parametrize("scenario,tiers", [
    ("queues", (2, 2)), ("queues", (1, 3)), ("queues", (3, 1)),
    ("prefixes", (1, 2)), ("prefixes", (2, 1)), ("pages", (2, 1))])
def test_tiered_dispatch_log_matches_reference(scenario, tiers):
    routers = [_dispatch(pkg, scenario, "round_robin", tiers)
               for pkg in PACKAGES]
    assert routers[0].dispatch_log == routers[1].dispatch_log
    assert [e.role for e in routers[1].engines] == \
        [e.role for e in routers[0].engines]
    assert {i for _, i in routers[1].dispatch_log} <= set(range(tiers[0]))


def test_policies_and_metric_contract_match_reference():
    assert TRT.POLICIES == JRT.POLICIES
    from repro.obs import metrics as jmetrics
    assert tmetrics.ROUTER_METRIC_CONTRACT == \
        jmetrics.ROUTER_METRIC_CONTRACT


def _stubs(n=2, **kw):
    return [_StubReplica(tapi, **kw) for _ in range(n)]


def test_round_robin_cycles():
    router = TRT.Router(_stubs(3), policy="round_robin")
    picks = [router.dispatch(_req(tsched, i)) for i in range(5)]
    assert picks == [0, 1, 2, 0, 1]


def test_least_loaded_prefers_shallow_queue_then_free_pages():
    reps = [_StubReplica(tapi, queue_depth=q) for q in (2, 0, 1)]
    router = TRT.Router(reps, policy="least_loaded")
    assert router.select(_req(tsched, 0)) == 1
    reps2 = [_StubReplica(tapi, free_pages=f) for f in (3, 9, 6)]
    assert TRT.Router(reps2, policy="least_loaded").select(
        _req(tsched, 0)) == 1
    assert TRT.Router(_stubs(2), policy="least_loaded").select(
        _req(tsched, 0)) == 0


def test_least_loaded_counts_undelivered_backlog():
    router = TRT.Router(_stubs(2), policy="least_loaded")
    assert router.dispatch(_req(tsched, 0)) == 0
    assert router.dispatch(_req(tsched, 1)) == 1
    assert router.dispatch(_req(tsched, 2)) == 0


def test_session_affinity_sticks():
    router = TRT.Router(_stubs(2), policy="session_affinity")
    first = router.dispatch(_req(tsched, 0, session=7))
    assert router.dispatch(_req(tsched, 1, session=8)) != first
    assert router.dispatch(_req(tsched, 2, session=7)) == first
    assert router.dispatch(_req(tsched, 3, session=7)) == first
    assert router.dispatch(_req(tsched, 4)) in (0, 1)


def test_prefix_affinity_follows_residency_then_hint():
    reps = [_StubReplica(tapi), _StubReplica(tapi, residency=_holds_a)]
    router = TRT.Router(reps, policy="prefix_affinity")
    assert router.dispatch(_req(tsched, 0, PROMPT_A)) == 1
    first_b = router.dispatch(_req(tsched, 1, PROMPT_B))
    assert router.dispatch(_req(tsched, 2, PROMPT_B)) == first_b
    assert router.dispatch(_req(tsched, 3, PROMPT_A)) == 1


def test_router_rejects_unknown_policy_empty_cluster_and_bad_tiers():
    with pytest.raises(ValueError):
        TRT.Router(_stubs(1), policy="fastest_first")
    with pytest.raises(ValueError):
        TRT.Router([], policy="round_robin")
    with pytest.raises(ValueError):
        TRT.Router(_stubs(3), tiers=(0, 3))
    with pytest.raises(ValueError):
        TRT.Router(_stubs(3), tiers=(2, 2))
    with pytest.raises(ValueError, match="paged"):
        TRT.make_cluster(TR.get("yi-6b", reduced=True),
                         TE.EngineConfig(max_batch=2, max_seq=32,
                                         paged=False, device="cpu"),
                         2, tiers=(1, 1))


def test_tiered_dispatch_targets_prefill_tier_only():
    stubs = [_StubReplica(tapi, queue_depth=q) for q in (2, 0, 1, 0)]
    router = TRT.Router(stubs, policy="round_robin", tiers=(2, 2))
    assert [e.role for e in stubs] == ["prefill", "prefill",
                                       "decode", "decode"]
    picks = [router.dispatch(_req(tsched, i)) for i in range(4)]
    assert set(picks) <= {0, 1}
    stubs2 = [_StubReplica(tapi, queue_depth=q) for q in (2, 0, 1, 0)]
    router2 = TRT.Router(stubs2, policy="round_robin", tiers=(2, 2))
    assert [router2.dispatch(_req(tsched, i)) for i in range(4)] == picks


def test_router_traces_dispatch_with_the_chosen_replica():
    from repro_torch.obs.tracer import Tracer
    router = TRT.Router(_stubs(2), policy="round_robin")
    tr = Tracer()
    router.set_tracer(tr)
    for i in range(3):
        router.dispatch(_req(tsched, i))
    ev = [e for e in tr.events if e.kind == "dispatch"]
    assert [(e.rid, e.replica) for e in ev] == router.dispatch_log
    assert all(e.args == {"policy": "round_robin"} for e in ev)


# ---------------------------------------------------------------------------
# Real engines: cluster tokens against the reference's bare engine
# ---------------------------------------------------------------------------
# tests/test_disagg.py ENG_KW and the grouped trace of both reference files
ENG_KW = dict(max_batch=3, max_seq=64, max_new_tokens=6, paged=True,
              page_size=8, num_pages=24, prefix_sharing=True,
              prefill_chunk=8)


def _grouped_trace(sched, n=8, seed=0):
    return sched.make_grouped_prefix_trace(512, rate_req_s=200.0,
                                           n_requests=n, n_groups=2,
                                           prefix_len=16, tail_len=6,
                                           skew=0.8, seed=seed)


def _streams(engines):
    done = [r for e in engines for r in e.completed]
    return ({r.rid: list(r.tokens_out) for r in done},
            {r.rid: r.finish_reason for r in done})


@pytest.fixture(scope="module")
def weights():
    cfg = JR.get("yi-6b", reduced=True).config
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), cfg))
    return params_from_numpy(tree, TR.get("yi-6b", reduced=True).config,
                             device="cpu")


@functools.lru_cache(maxsize=None)
def _reference_bare():
    eng = JE.make_engine(JR.get("yi-6b", reduced=True),
                         JE.EngineConfig(**ENG_KW))
    eng.run_trace(_grouped_trace(jsched))
    return _streams([eng])


_CLUSTERS = {}


def _cluster(policy, weights):
    if policy not in _CLUSTERS:
        router = TRT.make_cluster(
            TR.get("yi-6b", reduced=True),
            TE.EngineConfig(device="cpu", **ENG_KW), 2, policy=policy,
            params=weights)
        m = router.run_trace(_grouped_trace(tsched))
        _CLUSTERS[policy] = router, m
    return _CLUSTERS[policy]


@pytest.mark.parametrize("policy", TRT.POLICIES)
def test_cluster_tokens_match_reference_bare_engine(policy, weights):
    router, m = _cluster(policy, weights)
    assert _streams(router.engines) == _reference_bare()
    assert m["requests"] == m["finish_budget"] == 8
    assert m["decoded_tokens"] == 8 * ENG_KW["max_new_tokens"]
    assert m["policy"] == policy and m["replicas"] == 2
    assert m["tiers"] == "" and m["shipments"] == 0
    assert sorted(rid for rid, _ in router.dispatch_log) == list(range(8))
    assert sum(p["requests"] for p in m["per_replica"]) == 8
    assert set(m) == set(tmetrics.ROUTER_METRIC_CONTRACT)


def test_prefix_affinity_dedup_at_least_round_robin(weights):
    rr = _cluster("round_robin", weights)[1]
    pa = _cluster("prefix_affinity", weights)[1]
    assert pa["dedup_ratio_agg"] >= rr["dedup_ratio_agg"]
    assert pa["dedup_ratio_agg"] > 1.0


def test_cluster_shares_weights_and_nothing_else(weights):
    """One set of weights, given or made by the first replica; every
    replica its own pool, slots and fused-graph cache."""
    router = TRT.make_cluster(
        TR.get("yi-6b", reduced=True),
        TE.EngineConfig(device="cpu", fuse_steps=4, **ENG_KW), 3,
        params=weights)
    a, b, c = router.engines
    assert a.params is b.params is c.params is weights
    assert a.ecfg is not b.ecfg
    pools = [[p.data_ptr() for p in e.paged.store] for e in router.engines]
    assert len({tuple(p) for p in pools}) == 3
    assert a._fused_graphs is not b._fused_graphs
    assert len(router.schedulers) == 3
    made = TRT.make_cluster(TR.get("yi-6b", reduced=True),
                            TE.EngineConfig(device="cpu", **ENG_KW), 2)
    assert made.engines[0].params is made.engines[1].params


def test_run_workload_eos_aware_finish_reasons(weights):
    """Mirrors ``test_engine_eos_aware_finish_reasons``: the port's
    ``run_workload`` threads ``eos_rate`` through to ``make_trace``."""
    eng = TE.make_engine(TR.get("yi-6b", reduced=True), TE.EngineConfig(
        max_batch=3, max_seq=64, max_new_tokens=6, paged=True, page_size=8,
        device="cpu"), params=weights)
    m = eng.run_workload(rate_req_s=200.0, n_requests=6, prompt_len=10,
                         seed=2, eos_rate=0.5)
    assert m["finish_eos"] + m["finish_budget"] == m["requests"] == 6
    assert m["finish_eos"] > 0
    want = jsched.make_trace(eng.cfg.vocab, rate_req_s=200.0, n_requests=6,
                             prompt_len=10, seed=2, eos_rate=0.5)
    budgets = {r.rid: r.decode_len for r in want}
    for r in eng.completed:
        budget = min(6, max(1, budgets[r.rid]))
        assert len(r.tokens_out) == budget
        assert r.finish_reason == ("eos" if budget < 6 else "budget")
