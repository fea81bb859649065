"""Stack-aware page placement in the port against the reference
(mirrors ``tests/test_placement.py``).

Each case runs on both packages with the same inputs: the placement
map's geometry, the placed allocator's picks (co-location, striping,
spill, communal routing), the gather cost model, region-preserving
defrag with the spilled-page migration (pages, tables and the priced
seconds equal as floats; the port's pool contents survive the in-place
copies), the engines' reports and the analytic mirror.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import placement as JPL  # noqa: E402
from repro.core.hw import snake_system as j_snake  # noqa: E402
from repro.core.noc import page_gather as j_page_gather  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import paged_cache as JP  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.core import placement as TPL  # noqa: E402
from repro_torch.core.hw import snake_system as t_snake  # noqa: E402
from repro_torch.core.noc import page_gather as t_page_gather  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import paged_cache as TP  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAS_HYPOTHESIS = True
except ImportError:
    HAS_HYPOTHESIS = False

needs_hypothesis = pytest.mark.skipif(
    not HAS_HYPOTHESIS, reason="property tests need hypothesis "
    "(pip install -r requirements-dev.txt)")

JSYS, TSYS = j_snake(), t_snake()


def _geometry(pm):
    return (pm.num_pages, pm.n_regions, pm.communal_pages,
            [(r, pm.region_pages(r), pm.region_size(r))
             for r in pm.regions()],
            [pm.region_of(p) for p in range(pm.num_pages)])


# ---------------------------------------------------------------------------
# PlacementMap geometry
# ---------------------------------------------------------------------------
def test_map_partitions_every_page_once():
    pm = TPL.PlacementMap(48, 4, communal_pages=8)
    seen = []
    for r in pm.regions():
        seen.extend(pm.region_pages(r))
    assert sorted(seen) == list(range(48))
    for r in pm.regions():
        assert all(pm.region_of(p) == r for p in pm.region_pages(r))
    assert _geometry(pm) == _geometry(JPL.PlacementMap(48, 4,
                                                       communal_pages=8))


def test_map_uneven_split_front_loads_remainder():
    pm = TPL.PlacementMap(10, 3, communal_pages=0)
    assert [pm.region_size(r) for r in range(3)] == [4, 3, 3]
    assert _geometry(pm) == _geometry(JPL.PlacementMap(10, 3,
                                                       communal_pages=0))


def test_map_from_system_caps_regions():
    pm = TPL.PlacementMap.from_system(TSYS, 8)
    assert pm.n_regions == 8            # 16 PUs capped by 8 pages
    assert _geometry(pm) == _geometry(JPL.PlacementMap.from_system(JSYS,
                                                                   8))
    pm = TPL.PlacementMap.from_system(TSYS, 64, communal_frac=0.25)
    assert pm.n_regions == TSYS.pus and pm.communal_pages == 16
    assert _geometry(pm) == _geometry(JPL.PlacementMap.from_system(
        JSYS, 64, communal_frac=0.25))
    for args, kw in (((8, 9), {}), ((8, 1), dict(communal_pages=8))):
        with pytest.raises(ValueError):
            JPL.PlacementMap(*args, **kw)
        with pytest.raises(ValueError):
            TPL.PlacementMap(*args, **kw)


# ---------------------------------------------------------------------------
# Placement-policy allocation (the same op script on both allocators)
# ---------------------------------------------------------------------------
def _allocs(policy, num_pages=48, n_regions=4, communal=8):
    return (JP.PageAllocator(num_pages, placement=JPL.PlacementMap(
                num_pages, n_regions, communal_pages=communal),
                policy=policy),
            TP.PageAllocator(num_pages, placement=TPL.PlacementMap(
                num_pages, n_regions, communal_pages=communal),
                policy=policy))


def _both(pair, op):
    want, got = (op(a) for a in pair)
    assert got == want
    return got


def test_affinity_colocates_and_spills():
    pair = _allocs("affinity")
    pm = pair[1].placement
    got = _both(pair, lambda a: a.alloc(5, home=2))
    assert all(pm.region_of(p) == 2 for p in got)
    # home (10 pages) runs dry -> spill covers the rest, never fails
    more = _both(pair, lambda a: a.alloc(8, home=2))
    assert sum(pm.region_of(p) == 2 for p in more) == 5
    assert all(pm.region_of(p) != TPL.COMMUNAL for p in more)


def test_communal_routing_prefers_communal_region():
    pair = _allocs("affinity")
    pm = pair[1].placement
    got = _both(pair, lambda a: a.alloc(5, home=1, communal=3))
    assert sum(pm.region_of(p) == TPL.COMMUNAL for p in got) == 3
    assert sum(pm.region_of(p) == 1 for p in got) == 2


def test_interleave_stripes_across_regions():
    pair = _allocs("interleave")
    pm = pair[1].placement
    got = _both(pair, lambda a: a.alloc(8))
    per = {r: sum(pm.region_of(p) == r for p in got) for r in range(4)}
    assert per == {0: 2, 1: 2, 2: 2, 3: 2}
    # the stripe cursor carries across calls, communal last
    _both(pair, lambda a: [a.alloc(3) for _ in range(12)])


def test_free_first_policy_keeps_plain_layout():
    pair = _allocs("free-first")
    assert _both(pair, lambda a: a.alloc(5, home=3)) == \
        TP.PageAllocator(48).alloc(5)
    assert not pair[1].placed


def test_placed_alloc_is_atomic_and_conserving():
    pair = _allocs("affinity", num_pages=12, n_regions=3, communal=0)
    held = _both(pair, lambda a: a.alloc(10, home=0))
    before = _both(pair, lambda a: (a.free_pages, a.used_pages))
    assert _both(pair, lambda a: a.alloc(3, home=1)) is None  # 2 free
    assert _both(pair, lambda a: (a.free_pages, a.used_pages)) == before
    for a in pair:
        a.free(held)
    assert _both(pair, lambda a: a.free_pages) == 12
    # alloc_in never spills
    assert _both(pair, lambda a: a.alloc_in(2, 5)) is None
    got = _both(pair, lambda a: a.alloc_in(2, 4))
    assert sorted(got) == list(pair[1].placement.region_pages(2))


def test_region_accounting():
    pair = _allocs("affinity")
    pm = pair[1].placement
    _both(pair, lambda a: a.alloc(4, home=0))
    _both(pair, lambda a: a.alloc(2, communal=2))
    used = _both(pair, lambda a: a.region_used())
    free = _both(pair, lambda a: a.region_free())
    assert used[0] == 4 and used[TPL.COMMUNAL] == 2
    assert free[0] == pm.region_size(0) - 4
    assert sum(free.values()) + sum(used.values()) == 48


# ---------------------------------------------------------------------------
# Gather cost model
# ---------------------------------------------------------------------------
def _gc(counts, bpp=4096, **kw):
    want = JPL.gather_cost(JSYS, counts, bpp, **kw)
    got = TPL.gather_cost(TSYS, counts, bpp, **kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    return got


def test_gather_cost_local_beats_mixed_beats_striped():
    local = _gc({1: 8})
    mixed = _gc({1: 6, 2: 2})
    striped = _gc({0: 2, 1: 2, 2: 2, 3: 2})
    assert local.time_s < mixed.time_s < striped.time_s
    assert local.concentration == 1.0 and local.remote_regions == 0
    assert mixed.home == 1 and mixed.concentration == 0.75
    assert striped.remote_regions == 3


def test_gather_cost_empty_table():
    gc = _gc({})
    assert gc.time_s == 0.0 and gc.concentration == 1.0


def test_page_gather_charges_injection_port_and_hops():
    for args in ((1024, 0, 0), (0, 1024, 1)):
        assert dataclasses.astuple(t_page_gather(TSYS, *args)) == \
            dataclasses.astuple(j_page_gather(JSYS, *args))
    a = t_page_gather(TSYS, 1024, 0, 0)
    b = t_page_gather(TSYS, 0, 1024, 1)
    assert a.time_s < b.time_s
    assert b.time_s >= TSYS.noc_latency_cycles / TSYS.freq_hz
    with pytest.raises(ValueError):
        t_page_gather(TSYS, -1, 0, 0)


# ---------------------------------------------------------------------------
# Region-preserving defrag and the spilled-page migration
# ---------------------------------------------------------------------------
def _caches(policy="affinity", share=False, num_pages=24, n_regions=3,
            communal=6):
    kw = dict(max_batch=4, max_seq=32, page_size=4, num_pages=num_pages,
              share=share, placement_policy=policy)
    j = JP.PagedCache(JR.get("yi-6b", reduced=True),
                      placement=JPL.PlacementMap(
                          num_pages, n_regions,
                          communal_pages=communal if share else 0), **kw)
    t = TP.PagedCache(TR.get("yi-6b", reduced=True),
                      placement=TPL.PlacementMap(
                          num_pages, n_regions,
                          communal_pages=communal if share else 0),
                      device="cpu", **kw)
    return j, t


def _assert_caches_equal(j, t):
    np.testing.assert_array_equal(t.tables, j.tables)
    assert {p: t.alloc.refcount(p) for p in t.alloc.live_pages()} == \
        {p: j.alloc.refcount(p) for p in j.alloc.live_pages()}
    assert t.home_region == j.home_region
    assert t.alloc.region_free() == j.alloc.region_free()
    assert (t.migrated_pages, t.migration_cost_s, t.defrag_move_cost_s,
            t.shipped_pages, t.ship_cost_s) == \
        (j.migrated_pages, j.migration_cost_s, j.defrag_move_cost_s,
         j.shipped_pages, j.ship_cost_s)
    assert t.fragmentation() == j.fragmentation()
    assert t.placement_report().to_dict() == j.placement_report().to_dict()
    assert t.bytes_per_page() == j.bytes_per_page()
    assert t.mirror_consistent()


def test_defrag_preserves_regions_and_refcounts():
    j, t = _caches()
    for pc in (j, t):
        for slot in range(4):
            assert pc.alloc_slot(slot, 12)
        pc.free_slot(1)
        pc.free_slot(2)
    before = {p: t.alloc.refcount(p) for p in t.alloc.live_pages()}
    t.tables_device()                     # a live mirror to invalidate
    mapping = t.defrag()
    assert mapping == j.defrag()
    _assert_caches_equal(j, t)
    after = {p: t.alloc.refcount(p) for p in t.alloc.live_pages()}
    assert after == {mapping[p]: rc for p, rc in before.items()}
    for old, new in mapping.items():
        assert t.placement.region_of(old) == t.placement.region_of(new)
    for r in t.placement.regions():
        live_r = [p for p in t.alloc.live_pages()
                  if t.placement.region_of(p) == r]
        assert live_r == list(t.placement.region_pages(r))[:len(live_r)]
    # a hole below a live page: defrag moves it, rebuilds the region's
    # free list, and the next allocations pick the reference's pages
    for pc in (j, t):
        pc.free_slot(0)
    mapping = t.defrag()
    assert mapping == j.defrag()
    assert any(o != n for o, n in mapping.items())
    for pc in (j, t):
        assert pc.alloc_slot(1, 10) and pc.alloc_slot(0, 20)
    np.testing.assert_array_equal(t.tables, j.tables)
    _assert_caches_equal(j, t)


def test_defrag_trie_renumbering_consistent_under_regions():
    j, t = _caches(share=True)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 100, size=10).astype(np.int32)
    other = rng.integers(100, 200, size=12).astype(np.int32)
    for pc in (j, t):
        assert pc.alloc_slot(0, 11, tokens=prompt)
        pc.commit_prefix(0)
        assert pc.alloc_slot(1, 13, tokens=other)
        pc.commit_prefix(1)
        pc.free_slot(1)
    hit_before = t.prefix.match(prompt, t.page_size)
    assert hit_before == j.prefix.match(prompt, j.page_size)
    mapping = t.defrag()
    assert mapping == j.defrag()
    hit_after = t.prefix.match(prompt, t.page_size)
    assert hit_after == [mapping.get(p, p) for p in hit_before]
    assert hit_after == j.prefix.match(prompt, j.page_size)
    for p in hit_after:
        assert t.alloc.refcount(p) > 0
        assert p in t.blocks_of(0)
    _assert_caches_equal(j, t)


def test_defrag_migrates_spilled_pages_home():
    """Growth pages spilled under pressure are copied home once the pool
    relaxes, priced exactly as the reference prices them; the port's
    copy runs in place, so each pool keeps its storage."""
    j, t = _caches()
    for pc in (j, t):
        assert pc.alloc_slot(0, 8)
    home = t.home_region[0]
    for pc in (j, t):
        for slot, n in ((1, 24), (2, 24), (3, 24)):
            assert pc.alloc_slot(slot, n)
        assert pc.alloc.region_free()[home] == 0
        assert pc.extend_slot(0, 24)          # growth is forced to spill
    before = t.gather_cost_slot(TSYS, 0)
    assert before.remote_regions > 0
    assert before.time_s == j.gather_cost_slot(JSYS, 0).time_s
    seq_i = t.is_seq.index(True)
    for k, page in enumerate(t.blocks_of(0)):
        j.store[seq_i] = j.store[seq_i].at[:, page].set(float(k + 1))
        t.store[seq_i][:, page] = float(k + 1)
    want = t.gather()[seq_i][:, 0].clone()
    ptrs = [p.data_ptr() for p in t.store]
    t.tables_device()
    for pc, sys_ in ((j, JSYS), (t, TSYS)):
        pc.free_slot(3)                       # pressure relaxes
        pc.defrag(sys_)
    after = t.gather_cost_slot(TSYS, 0)
    assert t.migrated_pages == 4 and t.migration_cost_s > 0.0
    assert after.time_s < before.time_s
    assert after.remote_regions == 0 and after.concentration == 1.0
    assert set(t.slot_region_counts(0)) == {home}
    torch.testing.assert_close(t.gather()[seq_i][:, 0], want, rtol=0,
                               atol=0)
    np.testing.assert_array_equal(
        t.gather()[seq_i][:, 0].numpy(),
        np.asarray(jax.tree.leaves(j.gather())[seq_i][:, 0]))
    assert [p.data_ptr() for p in t.store] == ptrs
    assert all(t.alloc.refcount(p) == 1 for p in t.alloc.live_pages())
    _assert_caches_equal(j, t)


def test_transfer_pages_kinds_and_counters():
    j, t = _caches()
    for kind, hops in (("migrate", 0), ("defrag", 0), ("ship", 2)):
        got = t.transfer_pages(3, sys=TSYS, hops=hops, kind=kind)
        want = j.transfer_pages(3, sys=JSYS, hops=hops, kind=kind)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert dataclasses.astuple(t.transfer_pages(0)) == \
        dataclasses.astuple(j.transfer_pages(0))
    _assert_caches_equal(j, t)
    with pytest.raises(ValueError, match="unknown transfer kind"):
        t.transfer_pages(1, kind="teleport")
    assert TP.TRANSFER_KINDS == JP.TRANSFER_KINDS


@needs_hypothesis
@settings(max_examples=50, deadline=None) if HAS_HYPOTHESIS else (lambda f: f)
@given(st.lists(st.tuples(st.booleans(), st.integers(0, 3)), min_size=1,
                max_size=30),
       st.sampled_from(["free-first", "interleave", "affinity"])) \
    if HAS_HYPOTHESIS else (lambda f: f)
def test_defrag_region_property(ops, policy):
    """Any alloc/free interleaving, then a region-preserving rebuild,
    keeps every live page in its region with its refcount, and both
    allocators pick the same pages throughout."""
    pair = _allocs(policy, num_pages=18, n_regions=3, communal=3)
    pm = pair[1].placement
    held = []
    for i, (is_alloc, n) in enumerate(ops):
        if is_alloc:
            got = _both(pair, lambda a: a.alloc(n, home=i % 3,
                                                communal=n % 2))
            if got is not None:
                held.append(got)
        elif held:
            pages = held.pop()
            for a in pair:
                a.free(pages)
    live = {p: pair[1].refcount(p) for p in pair[1].live_pages()}
    mapping = {}
    for r in pm.regions():
        live_r = [p for p in sorted(live) if pm.region_of(p) == r]
        mapping.update(zip(live_r, pm.region_pages(r)))
    for a in pair:
        a.rebuild({mapping[p]: rc for p, rc in live.items()})
    for p, rc in live.items():
        assert pm.region_of(mapping[p]) == pm.region_of(p)
        assert pair[1].refcount(mapping[p]) == rc
    assert pair[1].free_pages + pair[1].used_pages == 18
    _both(pair, lambda a: (a.region_free(), a.alloc(2, home=1)))


# ---------------------------------------------------------------------------
# Engine integration + analytic mirror
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _weights():
    cfg = JR.get("yi-6b", reduced=True).config
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), cfg))
    return params_from_numpy(tree, TR.get("yi-6b", reduced=True).config,
                             device="cpu")


def _trace(sched, vocab, n=6):
    # all arrivals at t~0: admission depends on capacity alone, so both
    # packages schedule identically
    return sched.make_grouped_prefix_trace(
        vocab, rate_req_s=1e9, n_requests=n, n_groups=2, prefix_len=8,
        tail_len=4, skew=0.8, seed=0)


def _engines(n=6, **over):
    kw = dict(dict(max_batch=3, max_seq=32, max_new_tokens=6, paged=True,
                   page_size=4), **over)
    j = JE.make_engine(JR.get("yi-6b", reduced=True), JE.EngineConfig(**kw))
    t = TE.make_engine(TR.get("yi-6b", reduced=True),
                       TE.EngineConfig(device="cpu", **kw),
                       params=_weights())
    jm = j.run_trace(_trace(jsched, j.cfg.vocab, n))
    tm = t.run_trace(_trace(tsched, t.cfg.vocab, n))
    return (j, jm), (t, tm)


def _toks(eng):
    return {r.rid: list(map(int, r.tokens_out)) for r in eng.completed}


@pytest.mark.parametrize("policy", ["free-first", "interleave", "affinity"])
def test_engine_placement_token_exact_and_reported(policy):
    (_, _), (base, _) = _engines(prefix_sharing=True)
    (j, jm), (t, m) = _engines(prefix_sharing=True, placement=policy,
                               placement_regions=4)
    assert _toks(t) == _toks(base) == _toks(j)
    assert m["placement_policy"] == policy
    assert m["kv_gather_cost_mean_s"] > 0.0
    assert 0.0 < m["kv_gather_concentration"] <= 1.0
    for key in ("kv_gather_cost_mean_s", "kv_gather_concentration",
                "kv_region_peak", "kv_migrated_pages",
                "kv_migration_cost_s", "preemptions", "defrag_runs"):
        assert m[key] == jm[key], key
    assert t.gather_cost_samples == j.gather_cost_samples
    assert m["hists"]["gather_cost_s"] == jm["hists"]["gather_cost_s"]
    rep = t.load_report()
    assert rep.min_region_free == min(rep.region_free)
    d = rep.to_dict()
    assert d == j.load_report().to_dict()
    assert d["min_region_free"] == min(d["region_free"])


def test_engine_without_placement_reports_none():
    (j, jm), (t, m) = _engines(n=3, max_new_tokens=4)
    assert m["placement_policy"] == "none" == jm["placement_policy"]
    assert m["kv_gather_cost_mean_s"] == 0.0
    rep = t.load_report()
    assert rep.region_free == ()
    assert rep.min_region_free == rep.free_pages
    assert "region_free" not in rep.to_dict()
    assert t.kv_report() == j.kv_report()
    assert t.paged.placement_report().empty


def test_sim_placement_scores_policies_without_changing_schedule():
    from repro_torch.core.operators import PAPER_MODELS
    from repro_torch.core.serving_sim import (nmp_latency_model,
                                              simulate_serving)
    spec = PAPER_MODELS["LLaMA3-70B"]
    lat = nmp_latency_model(TSYS, spec, tp=8)
    reports = {}
    for policy in ("free-first", "interleave", "affinity"):
        reports[policy] = simulate_serving(
            lat, spec, 0.5, system="SNAKE", n_requests=12,
            cache_mode="paged", prefix_sharing=True,
            shared_prefix_len=1024, page_size=64, num_pages=1600,
            placement=policy, n_regions=8, hw=TSYS)
    e2e = {rep.e2e_mean_s for rep in reports.values()}
    assert len(e2e) == 1                 # placement never changes latency
    aff, ff = reports["affinity"], reports["free-first"]
    assert aff.gather_cost_mean_s < ff.gather_cost_mean_s
    assert aff.gather_concentration > reports["interleave"] \
        .gather_concentration
    assert sum(rep.region_peak_pages[0] > 0 for rep in reports.values())


def test_sim_placement_requires_paged():
    from repro_torch.core.operators import PAPER_MODELS
    from repro_torch.core.serving_sim import (nmp_latency_model,
                                              simulate_serving)
    spec = PAPER_MODELS["LLaMA3-70B"]
    lat = nmp_latency_model(TSYS, spec, tp=8)
    with pytest.raises(ValueError):
        simulate_serving(lat, spec, 0.5, system="SNAKE", n_requests=4,
                         cache_mode="dense", placement="affinity")
    with pytest.raises(ValueError):
        simulate_serving(lat, spec, 0.5, system="SNAKE", n_requests=4,
                         cache_mode="paged", placement="bogus")


def test_default_system_is_snake():
    assert TPL.default_system().name == "SNAKE"
    assert isinstance(TPL.gather_cost(TPL.default_system(), {0: 1}, 1),
                      TPL.GatherCost)


def test_paged_cache_rejects_a_foreign_map_size():
    with pytest.raises(ValueError, match="placement map covers"):
        TP.PagedCache(TR.get("yi-6b", reduced=True), max_batch=2,
                      max_seq=16, page_size=4, num_pages=8,
                      placement=TPL.PlacementMap(12, 2),
                      placement_policy="affinity", device="cpu")
    with pytest.raises(ValueError, match="unknown placement policy"):
        TP.PageAllocator(8, policy="random")


# ---------------------------------------------------------------------------
# Placement under the fused tick: a spill, then a migrate at defrag
# ---------------------------------------------------------------------------
# 2 regions of 6 pages: decode growth spills out of a full home region,
# preemption relaxes the pool and the defrag that follows copies the
# spilled page home, between fused ticks (the reference migrates 1 page)
FUSED_PLACED = dict(max_batch=3, max_seq=48, max_new_tokens=12,
                    paged=True, page_size=8, num_pages=12, fuse_steps=8)
SKEWED = np.array([9, 17, 5, 30, 12, 24])


def _fused_placed(device, params, **over):
    eng = TE.make_engine(TR.get("yi-6b", reduced=True),
                         TE.EngineConfig(device=device,
                                         **dict(FUSED_PLACED, **over)),
                         params=params)
    migrated = []
    migrate = eng.paged.migrate_spilled

    def checked(sys=None):
        n = migrate(sys)
        # the copy happened in place; the table mirror is rebuilt at its
        # next use, before the next graph input copy
        assert eng.paged._tables_dev is None or n == 0
        migrated.append(n)
        return n

    eng.paged.migrate_spilled = checked
    m = eng.run_trace(tsched.make_trace(
        512, rate_req_s=1e9, n_requests=len(SKEWED), prompt_len=0,
        prompt_lens=SKEWED, seed=7))
    return eng, m, _toks(eng)


def test_fused_placed_spill_and_migrate_match_reference():
    ref = JE.make_engine(JR.get("yi-6b", reduced=True), JE.EngineConfig(
        placement="affinity", placement_regions=2, **FUSED_PLACED))
    jm = ref.run_trace(jsched.make_trace(
        512, rate_req_s=1e9, n_requests=len(SKEWED), prompt_len=0,
        prompt_lens=SKEWED, seed=7))
    eng, m, toks = _fused_placed("cpu", _weights(), placement="affinity",
                                 placement_regions=2)
    _, _, plain = _fused_placed("cpu", _weights())
    assert jm["kv_migrated_pages"] > 0 and m["fused_ticks"] > 0
    assert toks == plain == _toks(ref)
    for key in ("kv_migrated_pages", "kv_migration_cost_s",
                "kv_gather_cost_mean_s", "kv_gather_concentration",
                "preemptions", "defrag_runs", "fused_ticks"):
        assert m[key] == jm[key], key
    assert eng.paged.mirror_consistent()


def _cuda_params(weights):
    return {k: _cuda_params(v) if isinstance(v, dict) else v.cuda()
            for k, v in weights.items()}


@pytest.mark.cuda
def test_cuda_fused_placed_spill_and_migrate():
    """Affinity placement under the fused tick's CUDA graphs: a page
    spills, is copied home in place at defrag, and the graphs keep
    replaying on the same pools; tokens equal the unplaced run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels "
                    "have no CPU mode)")
    params = _cuda_params(_weights())
    _, base, plain = _fused_placed("cuda", params, use_pallas_decode=True)
    eng, m, toks = _fused_placed("cuda", params, use_pallas_decode=True,
                                 placement="affinity", placement_regions=2)
    assert m["kv_migrated_pages"] > 0 and m["fused_ticks"] > 0
    assert toks == plain
    assert eng.paged.mirror_consistent()
    assert m["preemptions"] == base["preemptions"]
