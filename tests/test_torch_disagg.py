"""Prefill/decode disaggregation in the port against ``repro`` (mirrors
``tests/test_disagg.py``).

* The ``Replica`` protocol: both engines and the analytic cluster mirror
  conform, and ``REPLICA_METHODS`` is the reference's.
* Cache level: the same export / import ops on both packages'
  ``PagedCache`` with the same numpy data give the same shipment (pages,
  payload, priced bytes and seconds as floats) and leave the same
  tables, refcounts, trie and page contents; the destination dedups
  against its own trie; the pools keep their addresses (a captured
  fused-tick graph holds them); an import that does not fit maps
  nothing and the source re-absorbs the shipment.  The recurrent
  ``_import_dense`` against the reference's on rwkv6's state.
* Engines: tiered clusters of reduced yi-6b (1:1, 1:2 and 1:1 fusing 4
  steps) and of reduced rwkv6-7b (1:1) in float32 on the reference's
  weights, the reference's ``ENG_KW`` and grouped trace: tokens and
  finish reasons per rid, shipments, shipped pages and their modeled
  cost equal the reference's tiered cluster's (whose tokens
  ``tests/test_disagg.py`` holds equal to its bare engine's); the
  prefill tier completes nothing.  The deferred export mid chunked
  prefill, as the reference's test.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.operators import PAPER_MODELS  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import rwkv6 as JW  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.transformer import KVCache as JKV  # noqa: E402
from repro.obs import tracer as jtracer  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import paged_cache as JP  # noqa: E402
from repro.serving import replica_api as japi  # noqa: E402
from repro.serving import router as JRT  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.core import hw as thw  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import serving_sim as tsim  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import KVCache as TKV  # noqa: E402
from repro_torch.obs import tracer as ttracer  # noqa: E402
from repro_torch.obs.export import trace_report  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import paged_cache as TP  # noqa: E402
from repro_torch.serving import replica_api as tapi  # noqa: E402
from repro_torch.serving import router as TRT  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402


# ---------------------------------------------------------------------------
# The Replica protocol
# ---------------------------------------------------------------------------
def test_replica_methods_match_reference():
    assert tapi.REPLICA_METHODS == japi.REPLICA_METHODS
    for name in tapi.REPLICA_METHODS:
        assert callable(getattr(TE.ServingEngine, name))
        assert callable(getattr(tsim._Replica, name))


@pytest.mark.parametrize("paged", [False, True])
def test_engines_are_replicas(paged):
    eng = TE.make_engine(TR.get("yi-6b", reduced=True), TE.EngineConfig(
        max_batch=2, max_seq=32, paged=paged, page_size=8, device="cpu"))
    assert isinstance(eng, tapi.Replica)
    assert eng.role == "mixed"
    if not paged:
        with pytest.raises(RuntimeError, match="paged engine"):
            eng.export_slot_pages(0)
        with pytest.raises(RuntimeError, match="paged engine"):
            eng.import_slot_pages(None)


def test_sim_replica_is_a_replica():
    spec = tops.PAPER_MODELS["LLaMA3-70B"]
    lat = tsim.nmp_latency_model(thw.snake_system(), spec, tp=8)
    r = tsim._Replica(lat, spec, max_batch=4, pages_cap=32, page_size=64,
                      shared_full=0)
    assert isinstance(r, tapi.Replica)
    assert set(PAPER_MODELS) == set(tops.PAPER_MODELS)


# ---------------------------------------------------------------------------
# Cache level: export / import against the reference's PagedCache
# ---------------------------------------------------------------------------
MAX_SEQ = 32


def _caches(num_pages=12, max_batch=3):
    kw = dict(max_batch=max_batch, max_seq=MAX_SEQ, page_size=8,
              num_pages=num_pages, share=True)
    return (JP.PagedCache(JR.get("yi-6b", reduced=True), **kw),
            TP.PagedCache(TR.get("yi-6b", reduced=True), device="cpu",
                          **kw))


def _kv(rng, length):
    k = rng.standard_normal((2, 1, MAX_SEQ, 4, 32)).astype(np.float32)
    v = rng.standard_normal((2, 1, MAX_SEQ, 4, 32)).astype(np.float32)
    ln = np.asarray([length], np.int32)
    return (JKV(jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln)),
            TKV(torch.from_numpy(k), torch.from_numpy(v),
                torch.from_numpy(ln)))


def _fill(pair, slot, prompt, rng):
    """Admit ``prompt`` into ``slot`` of both caches and write the same
    random KV."""
    for pc in pair:
        assert pc.alloc_slot(slot, len(prompt) + 1, tokens=prompt)
    jc, tc = _kv(rng, len(prompt))
    pair[0].write_slot(slot, jc, len(prompt))
    pair[1].write_slot(slot, tc, len(prompt))


def _assert_same(j, t):
    np.testing.assert_array_equal(t.tables, j.tables)
    np.testing.assert_array_equal(t.shared_count, j.shared_count)
    assert t.alloc.live_pages() == j.alloc.live_pages()
    for p in t.alloc.live_pages():
        assert t.alloc.refcount(p) == j.alloc.refcount(p)
    assert sorted(t.prefix._by_page) == sorted(j.prefix._by_page)
    assert (t.shipped_pages, t.ship_cost_s) == \
        (j.shipped_pages, j.ship_cost_s)
    assert t.mirror_consistent()
    mapped = t.tables >= 0
    for jl, tl in zip(j.gather()[:2], t.gather()[:2]):
        jl = np.asarray(jl).reshape(2, t.max_batch, -1, 8, 4, 32)
        tl = tl.numpy().reshape(2, t.max_batch, -1, 8, 4, 32)
        np.testing.assert_array_equal(tl[:, mapped], jl[:, mapped])
    np.testing.assert_array_equal(t.store[2].numpy(), np.asarray(j.store[2]))


def _ptrs(pc):
    return [p.data_ptr() for p in pc.store]


def _pool_ptrs(pc):
    """The page pools' addresses (what a captured fused-tick graph holds;
    the engine replaces the lengths leaf every decode step)."""
    return [p.data_ptr() for p, seq in zip(pc.store, pc.is_seq) if seq]


PROMPT = (np.arange(20, dtype=np.int32) * 3 + 1) % 97     # 2.5 pages


def test_ship_matches_reference_and_dedups_in_place():
    """Export a 20-token slot from both packages' caches, import it into
    a destination holding a request that shares the first page: the same
    shipment, the first page mapped from the destination's trie, the
    other two written from the payload, into unmoved pools."""
    rng = np.random.default_rng(0)
    src, dst = _caches(), _caches()
    _fill(src, 1, PROMPT, rng)
    other = np.concatenate([PROMPT[:8], np.full(8, 5, np.int32)])
    _fill(dst, 0, other, rng)
    before = src[1].gather()
    ptrs = (_ptrs(src[1]), _ptrs(dst[1]))
    jship, tship = (pc.export_slot_pages(1, 20, tokens=PROMPT)
                    for pc in src)
    assert tship.n_pages == jship.n_pages == 3
    assert tship.bytes_on_wire == jship.bytes_on_wire > 0
    assert tship.cost_s == jship.cost_s > 0.0
    for jp_, tp_ in zip(jship.seq_payload, tship.seq_payload):
        if jp_ is None:
            assert tp_ is None
        else:
            np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp_))
    np.testing.assert_array_equal(tship.slot_payload[2].numpy(),
                                  np.asarray(jship.slot_payload[2]))
    _assert_same(*src)
    assert src[1].pages_in_use() == 0 and len(src[1].prefix) == 0
    assert dst[0].import_slot_pages(2, jship)
    assert dst[1].import_slot_pages(2, tship)
    _assert_same(*dst)
    assert int(dst[1].shared_count[2]) == 1
    assert dst[1].prefix_residency(PROMPT) == 3     # coverage registered
    after = dst[1].gather()
    for b, a in zip(before[:2], after[:2]):
        # the first page is the destination's own (the same tokens' KV in
        # a real run), the rest the shipped payload
        torch.testing.assert_close(a[:, 2, :8], a[:, 0, :8], rtol=0, atol=0)
        torch.testing.assert_close(a[:, 2, 8:20], b[:, 1, 8:20], rtol=0,
                                   atol=0)
    assert int(after[2][2]) == 20
    assert (_ptrs(src[1]), _ptrs(dst[1])) == ptrs


def test_import_that_does_not_fit_maps_nothing():
    """A two-page pool cannot take three pages: ``False`` with nothing
    mapped, incref'd or written, in both packages; the source then
    re-absorbs the shipment into the slot it came from."""
    rng = np.random.default_rng(1)
    src = _caches()
    _fill(src, 0, PROMPT, rng)
    before = src[1].gather()
    ships = [pc.export_slot_pages(0, 20, tokens=PROMPT) for pc in src]
    tiny = _caches(num_pages=2)
    ptrs = _ptrs(tiny[1])
    for pc, ship in zip(tiny, ships):
        assert not pc.import_slot_pages(1, ship)
        assert pc.pages_in_use() == 0 and not pc.home_region
        assert (pc.tables == -1).all() and len(pc.prefix) == 0
    assert _ptrs(tiny[1]) == ptrs
    for pc, ship in zip(src, ships):
        assert pc.import_slot_pages(0, ship)
    _assert_same(*src)
    for b, a in zip(before, src[1].gather()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ship_rejects_a_page_size_mismatch():
    src = _caches()
    _fill(src, 0, PROMPT, np.random.default_rng(2))
    ship = src[1].export_slot_pages(0, 20, tokens=PROMPT)
    other = TP.PagedCache(TR.get("yi-6b", reduced=True), max_batch=2,
                          max_seq=32, page_size=4, num_pages=16,
                          device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        other.import_slot_pages(0, ship)


def test_import_dense_matches_reference():
    """rwkv6's state has no sequence leaf: the shipment carries only the
    slot columns (no pages, nothing priced), written in place into the
    state the next step reads."""
    rng = np.random.default_rng(3)
    kw = dict(max_batch=3, max_seq=MAX_SEQ, page_size=8, num_pages=12)
    jc = JP.PagedCache(JR.get("rwkv6-7b", reduced=True), **kw)
    tc = TP.PagedCache(TR.get("rwkv6-7b", reduced=True), device="cpu", **kw)
    assert not tc.has_seq
    one = tc.entry.cache_zeros(1, MAX_SEQ, device="cpu")
    jone = jc.entry.cache_zeros(1, MAX_SEQ)
    assert one._fields == jone._fields
    vals = [rng.standard_normal(tuple(x.shape)).astype(np.asarray(y).dtype)
            for x, y in zip(one, jone)]
    jc.write_slot(1, type(jone)(*map(jnp.asarray, vals)), 9)
    tc.write_slot(1, type(one)(*map(torch.from_numpy, vals)), 9)
    jship = jc.export_slot_pages(1, 9)
    tship = tc.export_slot_pages(1, 9)
    assert tship.n_pages == jship.n_pages == 0
    assert tship.cost_s == jship.cost_s == 0.0
    assert tc.shipped_pages == jc.shipped_pages == 0
    ptrs = _ptrs(tc)
    assert jc.import_slot_pages(2, jship) and tc.import_slot_pages(2, tship)
    assert _ptrs(tc) == ptrs
    for jl, tl, v in zip(jc.store, tc.store, vals):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        got = tl[2] if tl.ndim == 1 else tl[:, 2]
        np.testing.assert_array_equal(got.numpy(), v[0] if v.ndim == 1
                                      else v[:, 0])


# ---------------------------------------------------------------------------
# Engines: tiered clusters against the reference's
# ---------------------------------------------------------------------------
# tests/test_disagg.py ENG_KW and grouped trace
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


def _ships(tracer):
    return {e.rid: (e.args["pages"], e.args["bytes"], e.args["cost_s"],
                    e.args["src"], e.args["dst"])
            for e in tracer.events if e.kind == "ship"}


@functools.lru_cache(maxsize=None)
def _reference_tiered(arch="yi-6b"):
    router = JRT.make_cluster(JR.get(arch, reduced=True),
                              JE.EngineConfig(**ENG_KW), 2, tiers=(1, 1))
    tr = jtracer.Tracer()
    router.set_tracer(tr)
    m = router.run_trace(_grouped_trace(jsched))
    return m, _streams(router.engines), sorted(router.ship_log), _ships(tr)


def _weights(arch, module):
    cfg = JR.get(arch, reduced=True).config
    tree = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(0), cfg))
    return params_from_numpy(tree, TR.get(arch, reduced=True).config,
                             device="cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights("yi-6b", JT)


_RUNS = {}


def _tiered(tiers, fuse, params, arch="yi-6b"):
    """The port's tiered cluster (cached per module), with the decode
    tier's pool addresses before the run and a tracer attached."""
    key = (tiers, fuse, arch)
    if key not in _RUNS:
        router = TRT.make_cluster(
            TR.get(arch, reduced=True),
            TE.EngineConfig(device="cpu", fuse_steps=fuse, **ENG_KW), 2
            if tiers is None else sum(tiers), tiers=tiers, params=params)
        ptrs = [_pool_ptrs(e.paged) for e in router.engines]
        tr = ttracer.Tracer()
        router.set_tracer(tr)
        m = router.run_trace(_grouped_trace(tsched))
        _RUNS[key] = router, m, ptrs, tr
    return _RUNS[key]


TIERS = [((1, 1), 1), ((1, 2), 1), ((1, 1), 4)]


@pytest.mark.parametrize("tiers,fuse", TIERS,
                         ids=["1:1", "1:2", "1:1-fused4"])
def test_tiered_cluster_matches_reference(tiers, fuse, weights):
    router, m, ptrs, _ = _tiered(tiers, fuse, weights)
    ref_m, ref_streams, _, _ = _reference_tiered()
    assert _streams(router.engines) == ref_streams
    n = len(ref_streams[0])
    assert m["tiers"] == f"{tiers[0]}:{tiers[1]}"
    assert m["shipments"] == ref_m["shipments"] == n
    assert m["shipped_pages"] == ref_m["shipped_pages"] == 3 * n
    assert m["ship_cost_s"] == ref_m["ship_cost_s"] > 0.0
    assert len(router.ship_log) == n
    assert not router.engines[0].completed           # the prefill tier
    assert sum(len(e.completed) for e in router.engines[1:]) == n
    assert [e.role for e in router.engines] == \
        ["prefill"] + ["decode"] * tiers[1]
    # the shipments wrote into the decode tier's existing pools
    assert [_pool_ptrs(e.paged) for e in router.engines] == ptrs
    for e in router.engines:
        assert e.paged.pages_in_use() == 0 and e.paged.mirror_consistent()
    if fuse > 1:
        assert all(e.fused_report()["fused_ticks"] > 0
                   for e in router.engines[1:])
        assert not router.engines[0].fused_report()


def test_tiered_ship_log_and_events_match_reference(weights):
    """1:1 ships every request from replica 0 to replica 1, whatever the
    timing: the logs and each ship event's pages, bytes, cost and
    endpoints equal the reference's; the trace's phases sum to its
    makespan, and the prefill replica emitted no decode span."""
    router, m, _, tr = _tiered((1, 1), 1, weights)
    _, _, ref_log, ref_ships = _reference_tiered()
    assert sorted(router.ship_log) == ref_log
    assert all((src, dst) == (0, 1) for _, src, dst in ref_log)
    assert _ships(tr) == ref_ships
    rep = trace_report(tr.events)
    assert rep["events"]["ship"] == m["shipments"]
    assert rep["finished"] == m["requests"]
    assert sum(rep["phases"].values()) == pytest.approx(rep["makespan_s"])
    assert not [e for e in tr.events if e.replica == 0
                and e.kind in ("decode_step", "fused_tick", "finish")]


def test_rwkv_tiered_cluster_matches_reference():
    """rwkv6-7b 1:1: no pages ship, the state column does (whole-prompt
    prefill; prefill_chunk and sharing do nothing for it)."""
    router, m, _, _ = _tiered((1, 1), 1, _weights("rwkv6-7b", JW),
                              arch="rwkv6-7b")
    ref_m, ref_streams, ref_log, ref_ships = _reference_tiered("rwkv6-7b")
    assert _streams(router.engines) == ref_streams
    assert m["shipments"] == ref_m["shipments"] == len(ref_streams[0])
    assert m["shipped_pages"] == ref_m["shipped_pages"] == 0
    assert m["ship_cost_s"] == ref_m["ship_cost_s"] == 0.0
    assert sorted(router.ship_log) == ref_log
    assert not router.engines[0].completed


def _engine(params, **over):
    return TE.make_engine(TR.get("yi-6b", reduced=True), TE.EngineConfig(
        device="cpu", **dict(ENG_KW, **over)), params=params)


def test_export_deferred_mid_chunked_prefill(weights):
    """Mirrors the reference's test: a request mid chunked prefill
    exports as ``None``; once its prefill ends the shipment carries the
    prompt and the first token, and the destination decodes the
    colocated engine's tokens."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 512, 24).astype(np.int32)
    ref = _engine(weights)
    assert ref.admit(tsched.RequestState(0, prompt.copy()))
    while ref.busy():
        ref.tick()
    want = ref.completed[0].tokens_out
    src, dst = _engine(weights), _engine(weights)
    src.role, dst.role = "prefill", "decode"
    assert src.admit(tsched.RequestState(0, prompt.copy()))
    assert src._prefilling is not None, "24 tokens must chunk at 8"
    assert src.export_slot_pages(0) is None
    while src._prefilling is not None:
        src.tick()
    with pytest.raises(KeyError):
        src.export_slot_pages(7)
    ship = src.export_slot_pages(0)
    assert ship is not None and ship.n_tokens == len(prompt)
    assert ship.cost_s > 0.0 and ship.next_tok >= 0
    assert not src.active and not src.busy()
    assert dst.import_slot_pages(ship)
    assert src.paged.alloc.used_pages == 0
    assert src.paged.shipped_pages == ship.n_pages
    assert dst.paged.alloc.used_pages >= ship.n_pages
    assert dst.paged.mirror_consistent()
    while dst.busy():
        dst.tick()
    assert dst.completed[0].tokens_out == want
    assert dst.paged.alloc.used_pages == 0


def test_engine_import_is_atomic_and_the_source_reabsorbs(weights):
    """A decode engine whose pool cannot take the shipment refuses it
    with nothing changed; the source takes it back into a free slot and
    (as a mixed engine again) decodes the colocated tokens."""
    prompt = np.arange(22, dtype=np.int32)
    ref = _engine(weights)
    assert ref.admit(tsched.RequestState(0, prompt.copy()))
    while ref.busy():
        ref.tick()
    src = _engine(weights)
    src.role = "prefill"
    assert src.admit(tsched.RequestState(0, prompt.copy()))
    while src._prefilling is not None:
        src.tick()
    assert not src.completed and len(src.active) == 1
    # a full-length resident request leaves one free page of eight
    dst = _engine(weights, num_pages=8, max_batch=2)
    assert dst.admit(tsched.RequestState(1, np.arange(50, dtype=np.int32)))
    tables, used = dst.paged.tables.copy(), dst.paged.pages_in_use()
    slots = list(dst.free_slots)
    ship = src.export_slot_pages(0)
    assert not dst.import_slot_pages(ship)
    np.testing.assert_array_equal(dst.paged.tables, tables)
    assert dst.paged.pages_in_use() == used and dst.free_slots == slots
    assert 0 not in {r.rid for r in dst.active.values()}
    assert src.import_slot_pages(ship)
    src.role = "mixed"
    while src.busy():
        src.tick()
    assert src.completed[0].tokens_out == ref.completed[0].tokens_out


def test_prefill_role_never_decodes_or_prices_a_decode(weights):
    """A prefill-tier engine's tick runs the chunk and no decode, also
    with the fused tick configured; its co-design composition prices no
    decode batch."""
    eng = _engine(weights, fuse_steps=4, codesign=True)
    eng.role = "prefill"
    assert eng.admit(tsched.RequestState(0, np.arange(10, dtype=np.int32)))
    for _ in range(4):
        assert eng.tick() == 0
    req = next(iter(eng.active.values()))
    assert req.tokens_out and len(req.tokens_out) == 1
    assert eng._active_ctxs() == [] and not eng.fused_report()


# ---------------------------------------------------------------------------
# On the card: the tiered cluster with the paged kernel under CUDA graphs
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_tiered_fused_cluster_matches_cpu(weights):
    """1:1 tiers with the paged flash-decode kernel and fuse_steps=4 on
    the card: the CPU cluster's tokens, the kernel launched on the decode
    tier (inside its captured graphs too), and the decode tier's pools
    unmoved by the imports."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels "
                    "have no CPU mode)")
    from repro_torch.kernels import flash_decode as fd

    def cuda(tree):
        return {k: cuda(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}

    router = TRT.make_cluster(
        TR.get("yi-6b", reduced=True),
        TE.EngineConfig(device="cuda", fuse_steps=4, use_pallas_decode=True,
                        **ENG_KW), 2, tiers=(1, 1), params=cuda(weights))
    ptrs = [_pool_ptrs(e.paged) for e in router.engines]
    fd.reset_launches()
    m = router.run_trace(_grouped_trace(tsched))
    cpu = _tiered((1, 1), 4, weights)[0]
    assert _streams(router.engines) == _streams(cpu.engines)
    assert m["shipments"] == 8
    assert fd.LAUNCHES["paged_flash_decode"] > 0
    dec = router.engines[1]
    assert dec._fused_graphs and all(g.graph is not None and g.replays
                                     for g in dec._fused_graphs.values())
    assert [_pool_ptrs(e.paged) for e in router.engines] == ptrs
