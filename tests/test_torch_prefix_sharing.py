"""Prefix sharing in the port against ``repro`` (mirrors
``tests/test_prefix_sharing.py`` and the sharing case of
``tests/test_fused_decode.py``, placement left out).

* Allocator and trie: the same op sequences through both packages'
  ``PageAllocator`` and ``PrefixIndex`` give the same pages, matches and
  renumberings (fixed scripts and hypothesis properties).
* Cache level: the same sharing, fork, chunk and defrag ops on both
  packages' ``PagedCache(share=True)`` with the same numpy data leave the
  same tables, refcounts, counters and ``gather()`` contents.
* Engine level: the reference's reduced yi-6b weights (bridged), float32,
  traces from the same seeds at rate 1e9 (all arrivals at t~0, so both
  packages schedule alike): the port's shared engine, with its kernel
  path (plain on the CPU), gives the reference engine's token streams,
  finish reasons and sharing metrics, per tick, chunked and fused.
* Copy-on-write order: every decode write, per tick and inside the fused
  loop (frozen lanes included), lands on a page with refcount 1 or on the
  scratch page.  This stands in for the reference's jaxpr lint
  ``host-cow-before-write``.
"""
import functools
from collections import Counter

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.transformer import KVCache as JKV  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import paged_cache as JP  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import KVCache as TKV  # noqa: E402
from repro_torch.obs import tracer as ttracer  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import paged_cache as TP  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

# metrics that must equal the reference's on the same trace
SHARED_KEYS = ("requests", "decoded_tokens", "preemptions", "finish_eos",
               "finish_budget", "defrag_runs", "kv_peak_tokens",
               "kv_logical_peak_pages", "kv_shared_pages",
               "kv_dedup_ratio_peak", "cow_forks", "prefill_skipped_tokens",
               "fused_ticks")


@pytest.fixture(scope="module")
def weights():
    cfg = JR.get("yi-6b", reduced=True).config
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), cfg))
    return params_from_numpy(tree, TR.get("yi-6b", reduced=True).config,
                             device="cpu")


# ---------------------------------------------------------------------------
# PageAllocator and PrefixIndex
# ---------------------------------------------------------------------------
@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 5)),
                max_size=60))
def test_allocator_refcount_invariants_match_reference(ops):
    """Any alloc/incref/decref interleaving: both allocators hand out the
    same pages and free the same ones, pages are conserved, a page is
    never freed while references remain, and returns to the free list
    exactly at refcount zero."""
    ja, ta = JP.PageAllocator(12), TP.PageAllocator(12)
    held = []                           # the reference multiset
    for kind, arg in ops:
        if kind == 0:
            got = ta.alloc(arg)
            assert got == ja.alloc(arg)
            if got is not None:
                held.extend(got)
        elif kind == 1 and held:
            p = held[arg % len(held)]
            ja.incref(p)
            ta.incref(p)
            held.append(p)
        elif kind == 2 and held:
            p = held.pop(arg % len(held))
            assert ta.decref(p) == ja.decref(p)
        model = Counter(held)
        assert ta.used_pages == ja.used_pages == len(model)
        assert ta.free_pages + ta.used_pages == 12
        assert ta.shared_pages == ja.shared_pages
        for p, rc in model.items():
            assert ta.refcount(p) == ja.refcount(p) == rc
        # no held page is on the free list
        grabbed = ta.alloc(ta.free_pages)
        assert not (set(model) & set(grabbed))
        ta.free(grabbed)
        ja.free(ja.alloc(ja.free_pages))
    for p in held:
        ta.decref(p)
    assert ta.free_pages == 12 and ta.used_pages == 0


def test_prefix_index_script_matches_reference():
    """match / register (first writer wins, exact ragged tail) / remap /
    remove on both tries."""
    tries = (JP.PrefixIndex(), TP.PrefixIndex())
    toks = np.arange(20, dtype=np.int32)
    other = np.concatenate([toks[:8], np.full(8, 99, np.int32)])
    queries = [toks, toks[:16], toks[:18], other, toks.astype(np.int64),
               toks[:3], np.zeros(0, np.int32)]

    def same():
        for q in queries:
            got = [t.match(q, 8) for t in tries]
            assert got[0] == got[1], q
        assert len(tries[0]) == len(tries[1])
        return tries[1].match(toks, 8)

    for t in tries:
        t.register(toks, [4, 7, 9], 8)
    assert same() == [4, 7, 9]
    for t in tries:
        t.register(toks, [1, 2, 3], 8)           # duplicates stay private
        t.register(other, [4, 5], 8)
    assert same() == [4, 7, 9]
    assert tries[1].match(other, 8) == [4, 5]
    for t in tries:
        t.remap({4: 0, 7: 1, 9: 2, 5: 3})
    assert same() == [0, 1, 2]
    for t in tries:
        t.remove(1)
        t.remove(11)                             # not registered: no-op
    assert same() == [0]
    assert len(tries[1]) == 3


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2),
                          st.lists(st.integers(0, 2), min_size=1,
                                   max_size=11)),
                max_size=25))
def test_prefix_index_property_matches_reference(ops):
    """Random registers, removes, remaps and matches of prompts over a
    3-token alphabet with page size 4: both tries answer alike."""
    jt, tt = JP.PrefixIndex(), TP.PrefixIndex()
    next_page = 0
    for kind, toks in ops:
        toks = np.asarray(toks, np.int32)
        if kind == 0:                            # register fresh pages
            pages = list(range(next_page, next_page + -(-len(toks) // 4)))
            next_page += len(pages)
            jt.register(toks, pages, 4)
            tt.register(toks, pages, 4)
        elif kind == 1 and len(tt):              # forget one page
            page = sorted(tt._by_page)[toks[0] % len(tt)]
            jt.remove(page)
            tt.remove(page)
        elif kind == 2:                          # defrag renumbering
            mapping = {p: i for i, p in enumerate(sorted(tt._by_page))}
            jt.remap(mapping)
            tt.remap(mapping)
        assert tt.match(toks, 4) == jt.match(toks, 4)
        assert sorted(tt._by_page) == sorted(jt._by_page)


# ---------------------------------------------------------------------------
# PagedCache(share=True)
# ---------------------------------------------------------------------------
MAX_SEQ = 32


def _caches(max_batch=3, num_pages=12):
    kw = dict(max_batch=max_batch, max_seq=MAX_SEQ, page_size=8,
              num_pages=num_pages, share=True)
    return (JP.PagedCache(JR.get("yi-6b", reduced=True), **kw),
            TP.PagedCache(TR.get("yi-6b", reduced=True), device="cpu",
                          **kw))


def _kv(rng, b, lengths):
    """The same random batch-``b`` cache for both packages."""
    k = rng.standard_normal((2, b, MAX_SEQ, 4, 32)).astype(np.float32)
    v = rng.standard_normal((2, b, MAX_SEQ, 4, 32)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    return (JKV(jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln)),
            TKV(torch.from_numpy(k), torch.from_numpy(v),
                torch.from_numpy(ln)))


def _assert_same(j, t):
    """Tables, refcounts, counters, the trie's pages and every live
    page's contents (through ``gather()``) equal the reference's."""
    np.testing.assert_array_equal(t.tables, j.tables)
    np.testing.assert_array_equal(t.shared_count, j.shared_count)
    assert t.alloc.live_pages() == j.alloc.live_pages()
    for p in t.alloc.live_pages():
        assert t.alloc.refcount(p) == j.alloc.refcount(p)
    assert sorted(t.prefix._by_page) == sorted(j.prefix._by_page)
    assert t.sharing_report() == j.sharing_report()
    assert t.mirror_consistent()
    mapped = t.tables >= 0                 # unmapped entries read scratch
    for jl, tl in zip(j.gather()[:2], t.gather()[:2]):
        jl = np.asarray(jl).reshape(2, t.max_batch, -1, 8, 4, 32)
        tl = tl.numpy().reshape(2, t.max_batch, -1, 8, 4, 32)
        np.testing.assert_array_equal(tl[:, mapped], jl[:, mapped])


def test_cache_maps_and_isolates_like_reference():
    """Mirrors ``test_paged_cache_prefix_sharing_maps_and_isolates``: an
    identical prompt maps all three prompt pages, its own write_slot
    skips them, a fork isolates the tail page, and a decode write after
    the fork leaves the first holder's KV untouched."""
    j, t = _caches()
    rng = np.random.default_rng(0)
    prompt = (np.arange(20, dtype=np.int32) * 3 + 1) % 97
    for pc in (j, t):
        assert pc.alloc_slot(0, 21, tokens=prompt)
    jc, tc = _kv(rng, 1, [20])
    j.write_slot(0, jc, 20)
    t.write_slot(0, tc, 20)
    assert t.prefix_residency(prompt) == j.prefix_residency(prompt) == 3
    for pc in (j, t):
        assert pc.alloc_slot(1, 21, tokens=prompt)
    assert int(t.shared_count[1]) == 3 and t.pages_in_use() == 3
    jc, tc = _kv(rng, 1, [20])            # other values: must be skipped
    j.write_slot(1, jc, 20)
    t.write_slot(1, tc, 20)
    _assert_same(j, t)
    assert t.sharing_report()["dedup_ratio"] == 2.0
    for pc in (j, t):
        assert pc.fork_page(1, 2)
    assert t.pages_in_use() == 4 and t.alloc.shared_pages == 2
    assert t.cow_forks == 1
    jc, tc = _kv(rng, 3, [0, 21, 0])
    active = np.array([False, True, False])
    j.scatter_token(jc, np.array([0, 20, 0]), active)
    t.scatter_token(tc, np.array([0, 20, 0]), active)
    _assert_same(j, t)
    for pc in (j, t):
        pc.free_slot(0)
    _assert_same(j, t)
    assert t.pages_in_use() == 3           # still held by slot 1
    for pc in (j, t):
        pc.free_slot(1)
    assert t.pages_in_use() == 0 and len(t.prefix) == 0


def test_cache_chunks_skip_shared_pages_like_reference():
    """scatter_chunk routes positions inside shared pages to the scratch
    page (the exact-tail recompute must not overwrite the first holder's
    KV) and writes the rest; commit_prefix publishes the new pages."""
    j, t = _caches()
    rng = np.random.default_rng(1)
    prompt = np.arange(100, 113, dtype=np.int32)          # 13: ragged
    longer = np.concatenate([prompt[:8], np.arange(7, dtype=np.int32)])
    for pc in (j, t):
        assert pc.alloc_slot(0, 14, tokens=prompt)
    jc, tc = _kv(rng, 1, [0])
    for pos, take in ((0, 5), (5, 8)):
        j.scatter_chunk(0, jc, pos, take)
        t.scatter_chunk(0, tc, pos, take)
    for pc in (j, t):
        pc.commit_prefix(0)
        assert pc.alloc_slot(1, 14, tokens=prompt)     # exact tail: 2
        assert pc.alloc_slot(2, 16, tokens=longer)     # first page: 1
    assert list(t.shared_count) == list(j.shared_count) == [0, 2, 1]
    jc, tc = _kv(rng, 1, [0])
    for pc, c in ((j, jc), (t, tc)):
        pc.scatter_chunk(1, c, 12, 1)                  # exact-tail token
        pc.scatter_chunk(2, c, 8, 7)
        pc.commit_prefix(1)
        pc.commit_prefix(2)
    _assert_same(j, t)
    assert t.prefix_residency(longer) == 2


def test_cow_for_write_only_forks_shared_pages_like_reference():
    """Mirrors ``test_cow_for_write_only_forks_shared_pages``."""
    j, t = _caches(max_batch=2, num_pages=8)
    prompt = np.arange(12, dtype=np.int32)
    for pc in (j, t):
        assert pc.alloc_slot(0, 13, tokens=prompt)
    jc, tc = _kv(np.random.default_rng(2), 1, [12])
    j.write_slot(0, jc, 12)
    t.write_slot(0, tc, 12)
    for pc in (j, t):
        assert pc.alloc_slot(1, 13, tokens=prompt)
        assert pc.cow_for_write(1, 12)
        assert pc.cow_forks == 1
        assert pc.cow_for_write(0, 12)     # exclusive again: no fork
        assert pc.cow_for_write(0, 10_000)  # out of window: no fork
        assert pc.cow_forks == 1
    _assert_same(j, t)
    assert t.alloc.shared_pages == 1       # the full page stays shared


def test_defrag_renumbers_the_trie_like_reference():
    """Mirrors ``test_defrag_refcount_aware_with_sharing``: the same
    mapping, the same contents, refcounts kept, and the renumbered trie
    still maps a third sharer.  The pools keep their storage."""
    j, t = _caches()
    rng = np.random.default_rng(3)
    filler = np.arange(100, 116, dtype=np.int32)
    prompt = np.arange(20, dtype=np.int32)
    for slot, toks, n in ((0, filler, 16), (1, prompt, 20),
                          (2, prompt, 20)):
        jc, tc = _kv(rng, 1, [n])
        for pc, c in ((j, jc), (t, tc)):
            assert pc.alloc_slot(slot, n + 1, tokens=toks)
            pc.write_slot(slot, c, n)
    for pc in (j, t):
        pc.free_slot(0)
    assert t.fragmentation() == j.fragmentation() > 0.4
    ptrs = [x.data_ptr() for x in t.store]
    assert t.defrag() == j.defrag()
    assert [x.data_ptr() for x in t.store] == ptrs
    _assert_same(j, t)
    assert t.alloc.shared_pages == 3 and t.fragmentation() == 0.0
    for pc in (j, t):
        assert pc.alloc_slot(0, 21, tokens=prompt)
    _assert_same(j, t)
    assert int(t.shared_count[0]) == 3
    assert t.alloc.refcount(int(t.tables[0, 0])) == 3


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------
def _streams(eng):
    return ({r.rid: list(r.tokens_out) for r in eng.completed},
            {r.rid: r.finish_reason for r in eng.completed})


# name -> (EngineConfig fields, shared-prefix trace kwargs)
RUNS = {
    # test_prefix_sharing.py:301: six prompts, 24 shared + 5 unique
    "trace": (dict(max_batch=3, max_seq=64, max_new_tokens=5),
              dict(n_requests=6, prefix_len=24, tail_len=5, seed=2)),
    # :332: identical prompts (whole-prompt prefill; the ragged tail page
    # is shared and forked)
    "identical": (dict(max_batch=3, max_seq=64, max_new_tokens=4),
                  dict(n_requests=4, prefix_len=16, tail_len=0, seed=4)),
    # :352: identical prompts in chunks of 4: a slot mid-prefill maps
    # live shared pages while the decode batch runs
    "chunked": (dict(max_batch=2, max_seq=48, max_new_tokens=6,
                     prefill_chunk=4),
                dict(n_requests=3, prefix_len=16, tail_len=0, seed=6)),
    # test_fused_decode.py:66 without placement: sharing, chunking and
    # the horizon-boundary fork under one fused engine
    "fused": (dict(max_batch=3, max_seq=64, max_new_tokens=5,
                   prefill_chunk=4, fuse_steps=16),
              dict(n_requests=6, prefix_len=16, tail_len=5, seed=2)),
    # identical 19-token prompts: exact-tail recompute and the fork of
    # the shared tail page inside fused horizons (a budget long enough
    # that request 0 is still resident when the others are admitted)
    "fused_identical": (dict(max_batch=3, max_seq=48, max_new_tokens=16,
                             prefill_chunk=8, fuse_steps=8),
                        dict(n_requests=4, prefix_len=19, tail_len=0,
                             seed=5)),
    # 16 shared + 9 unique tokens in chunks of 4 and a 16-token budget:
    # requests 1 and 2 map the two shared pages and spend three chunks
    # outside the decode batch while request 0's fused horizons run, so
    # their lanes must write the scratch page
    "long_tail": (dict(max_batch=3, max_seq=64, max_new_tokens=16,
                       prefill_chunk=4, fuse_steps=8),
                  dict(n_requests=3, prefix_len=16, tail_len=9, seed=7)),
}


def _trace(mod, trace_kw):
    return mod.make_shared_prefix_trace(512, rate_req_s=1e9, **trace_kw)


@functools.lru_cache(maxsize=None)
def _reference(name, share=True):
    over, trace_kw = RUNS[name]
    eng = JE.make_engine(JR.get("yi-6b", reduced=True), JE.EngineConfig(
        paged=True, page_size=8, prefix_sharing=share, **over))
    metrics = eng.run_trace(_trace(jsched, trace_kw))
    return metrics, *_streams(eng)


def _port(name, params, tracer=None, **extra):
    over, trace_kw = RUNS[name]
    cfg = dict(dict(paged=True, page_size=8, prefix_sharing=True), **over)
    cfg.update(extra)
    eng = TE.make_engine(TR.get("yi-6b", reduced=True),
                         TE.EngineConfig(device="cpu", **cfg), params=params)
    if tracer is not None:
        eng.set_tracer(tracer)
    metrics = eng.run_trace(_trace(tsched, trace_kw))
    return eng, metrics, *_streams(eng)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_shared_engine_matches_reference(name, weights):
    """Tokens, finish reasons and every sharing metric equal the
    reference's, with the kernel path on; nothing launches on the CPU."""
    fd.reset_launches()
    eng, m, toks, reasons = _port(name, weights, use_pallas_decode=True)
    jm, jtoks, jreasons = _reference(name)
    assert toks == jtoks and reasons == jreasons
    for key in SHARED_KEYS:
        assert m[key] == jm[key], key
    assert m["kv_dedup_ratio_peak"] > 1.0
    assert eng.paged.pages_in_use() == 0 and len(eng.paged.prefix) == 0
    assert fd.LAUNCHES == {"flash_decode": 0, "paged_flash_decode": 0,
                           "flash_decode_partial": 0}
    trace_kw = RUNS[name][1]
    if trace_kw["tail_len"] == 0 and trace_kw["prefix_len"] % 8:
        assert m["cow_forks"] > 0       # identical prompts, ragged tail
    if "prefill_chunk" in RUNS[name][0]:
        assert m["prefill_skipped_tokens"] > 0
    if "fuse_steps" in RUNS[name][0]:
        assert m["fused_ticks"] > 0


def test_sharing_keeps_tokens_and_lowers_resident_kv(weights):
    """Mirrors ``test_shared_prefix_trace_token_exact_and_resident_below_
    paged``: the dense, paged and shared engines give the same tokens,
    and sharing keeps the page peak below the unshared paged engine."""
    _, dense_m, dense_t, _ = _port("trace", weights, paged=False,
                                   prefix_sharing=False)
    paged, paged_m, paged_t, _ = _port("trace", weights,
                                       prefix_sharing=False)
    shared, m, shared_t, _ = _port("trace", weights)
    assert dense_t == paged_t == shared_t
    assert shared.pages_peak < paged.pages_peak
    assert m["kv_peak_tokens"] < paged_m["kv_peak_tokens"]
    assert paged_m["kv_dedup_ratio_peak"] == 1.0 < m["kv_dedup_ratio_peak"]
    assert m["kv_shared_pages"] == 0              # all released by now
    assert paged_m["kv_peak_tokens"] == _reference("trace", False)[0][
        "kv_peak_tokens"]
    assert dense_m["kv_mode"] == "dense"


@pytest.mark.parametrize("name", ["fused", "fused_identical"])
def test_fused_shared_matches_per_tick(name, weights):
    """The fused shared engine gives its per-tick engine's tokens and
    reasons (the reference's own check), with both kernel paths."""
    for kernel in (False, True):
        _, _, toks, reasons = _port(name, weights, fuse_steps=1,
                                    use_pallas_decode=kernel)
        _, m, f_toks, f_reasons = _port(name, weights,
                                        use_pallas_decode=kernel)
        assert f_toks == toks and f_reasons == reasons
        assert m["fused_ticks"] > 0


def _identical(n=2, length=12):
    prompt = ((np.arange(length, dtype=np.int32) * 7 + 3) % 512
              ).astype(np.int32)
    return [tsched.RequestState(i, prompt.copy()) for i in range(n)]


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_cow_fork_under_interleaved_decode(kernel, weights):
    """Mirrors ``test_engine_cow_fork_under_interleaved_decode``: two
    identical 12-token prompts share both pages; the first decode step
    forks the shared tail page once; the tokens equal the reference's
    shared engine and the port's dense engine."""
    def run(mod, ecfg, **kw):
        eng = mod.make_engine(entry[mod], ecfg(max_batch=2, max_seq=32,
                                               max_new_tokens=6, **kw),
                              **extra[mod])
        reqs = [mod.RequestState(r.rid, r.prompt) for r in _identical()]
        assert eng.submit(reqs[0])
        one = eng.paged.pages_in_use() if kw else 0
        assert eng.submit(reqs[1])
        if kw:
            assert eng.paged.pages_in_use() == one      # fully mapped
            assert eng.paged.alloc.shared_pages == 2
            eng.step()
            assert eng.paged.cow_forks == 1
            assert eng.paged.alloc.shared_pages == 1    # full page
        while eng.active:
            eng.step()
        if kw:
            assert eng.paged.pages_in_use() == 0
        return [r.tokens_out for r in reqs]

    entry = {JE: JR.get("yi-6b", reduced=True),
             TE: TR.get("yi-6b", reduced=True)}
    extra = {JE: {}, TE: {"params": weights}}
    jcfg = JE.EngineConfig
    tcfg = functools.partial(TE.EngineConfig, device="cpu")
    shared = dict(paged=True, page_size=8, prefix_sharing=True)
    got = run(TE, tcfg, use_pallas_decode=kernel, **shared)
    assert got == run(JE, jcfg, **shared)
    assert got == run(TE, tcfg)


def test_prefix_residency_on_both_engines(weights):
    prompt = _identical(1, 20)[0].prompt
    dense = TE.make_engine(TR.get("yi-6b", reduced=True), TE.EngineConfig(
        device="cpu", max_batch=2, max_seq=32), params=weights)
    paged = TE.make_engine(TR.get("yi-6b", reduced=True), TE.EngineConfig(
        device="cpu", max_batch=2, max_seq=32, paged=True, page_size=8,
        prefix_sharing=True), params=weights)
    assert dense.prefix_residency(prompt) == 0
    assert paged.prefix_residency(prompt) == 0
    assert paged.submit(tsched.RequestState(0, prompt))
    assert paged.prefix_residency(prompt) == 3     # 2 full pages + tail
    assert paged.prefix_residency(prompt[:17]) == 2
    assert dense.submit(tsched.RequestState(0, prompt))
    assert dense.prefix_residency(prompt) == 0


# ---------------------------------------------------------------------------
# Copy-on-write before every decode write
# ---------------------------------------------------------------------------
def _guard_writes(monkeypatch, eng):
    """Check every decode write of ``eng`` as it happens: the page it
    lands on has refcount 1, or is the scratch page.  Per tick the write
    is ``PagedCache.scatter_token`` (plain path) or ``decode_step_paged``
    (kernel path); in the fused loop every step's ``decode_step_paged``,
    frozen lanes included.  Returns the counts of checked writes, of
    frozen-lane writes (a lane writing the same slot of a page as in the
    step before, inside one fused loop) and of steps run while a lane
    outside the decode batch mapped a shared page."""
    seen = {"writes": 0, "frozen": 0, "inactive_shared": 0, "prev": {}}
    paged = eng.paged
    scratch = paged.num_pages

    def check(page, where):
        assert page == scratch or paged.alloc.refcount(page) == 1, (
            f"{where} writes page {page} with refcount "
            f"{paged.alloc.refcount(page)}")
        seen["writes"] += page != scratch

    step = TT.decode_step_paged

    def guarded_step(params, cfg, tokens, k_pool, v_pool, tables, lengths,
                     **kw):
        ps, nblk = k_pool.shape[2], tables.shape[1]
        seen["inactive_shared"] += any(
            bool((tables[b] == scratch).all())
            and any(paged.alloc.refcount(p) > 1
                    for p in paged.blocks_of(b))
            for b in range(tables.shape[0]))
        for b, n in enumerate(lengths.tolist()):
            page = int(tables[b, n // ps]) if n // ps < nblk else scratch
            check(page, f"decode_step_paged lane {b}")
            if page != scratch:
                seen["frozen"] += seen["prev"].get(b) == (page, n % ps)
                seen["prev"][b] = (page, n % ps)
        return step(params, cfg, tokens, k_pool, v_pool, tables, lengths,
                    **kw)

    fused = TT.decode_fused_paged

    def guarded_fused(*a, **kw):
        seen["prev"] = {}
        return fused(*a, **kw)

    scatter = paged.scatter_token

    def guarded_scatter(cache, positions, active):
        for b in np.flatnonzero(active):
            blk = int(positions[b]) // paged.page_size
            if blk < paged.max_blocks and paged.tables[b, blk] >= 0:
                check(int(paged.tables[b, blk]), f"scatter_token lane {b}")
        return scatter(cache, positions, active)

    monkeypatch.setattr(TT, "decode_step_paged", guarded_step)
    monkeypatch.setattr(TT, "decode_fused_paged", guarded_fused)
    monkeypatch.setattr(paged, "scatter_token", guarded_scatter)
    return seen


# name -> (run, fields over it): identical 19-token prompts fork their
# shared tail page; the long tails keep lanes mid-prefill over shared
# pages beside the decode batch
COW_CASES = {
    "per_tick": ("fused_identical", dict(fuse_steps=1, prefill_chunk=None)),
    "per_tick_kernel": ("fused_identical", dict(
        fuse_steps=1, prefill_chunk=None, use_pallas_decode=True)),
    "chunked_kernel": ("fused_identical", dict(fuse_steps=1,
                                               use_pallas_decode=True)),
    "fused_kernel": ("fused_identical", dict(use_pallas_decode=True)),
    # a token-level eos freezes lanes mid-horizon; their writes repeat
    "fused_eos": ("fused_identical", dict(use_pallas_decode=True)),
    "long_tail_kernel": ("long_tail", dict(fuse_steps=1,
                                           use_pallas_decode=True)),
    "long_tail_fused": ("long_tail", dict(use_pallas_decode=True)),
}


@pytest.mark.parametrize("case", sorted(COW_CASES))
def test_cow_before_every_decode_write(case, weights, monkeypatch):
    run, over = COW_CASES[case]
    over = dict(over)
    if case == "fused_eos":
        # the first token request 0 emits late in its stream (once the
        # others share its pages) and not before: an eos there freezes
        # lanes mid-horizon
        t = _port("fused_identical", weights)[2][0]
        over["eos_id"] = next(x for i, x in enumerate(t)
                              if i >= 8 and x not in t[:i])
    real = TE.make_engine

    def make(*a, **kw):
        eng = real(*a, **kw)
        make.seen = _guard_writes(monkeypatch, eng)
        return eng

    monkeypatch.setattr(TE, "make_engine", make)
    eng, m, toks, reasons = _port(run, weights, **over)
    assert make.seen["writes"] > 0
    if run == "long_tail":
        assert make.seen["inactive_shared"] > 0
    else:
        assert m["cow_forks"] > 0
    if eng.ecfg.fuse_steps > 1:
        assert m["fused_ticks"] > 0
        # lanes frozen past k_active (bucketed horizons) or by an eos
        assert make.seen["frozen"] > 0 or run == "long_tail"
    if case == "fused_eos":
        assert "eos" in reasons.values()


def test_horizon_fork_alone_covers_the_horizon(weights, monkeypatch):
    """``_cow_horizon`` by itself forks every shared page the fused loop
    writes: with the per-tick pass (``_pre_decode_grow``) taken out, a
    fused tick over two identical 12-token prompts (the tail page shared,
    a horizon of 4 steps inside it) still writes no shared page."""
    eng = TE.make_engine(TR.get("yi-6b", reduced=True), TE.EngineConfig(
        device="cpu", max_batch=2, max_seq=32, max_new_tokens=8,
        paged=True, page_size=8, prefix_sharing=True, fuse_steps=8),
        params=weights)
    tracer = ttracer.Tracer()
    eng.set_tracer(tracer)
    for req in _identical():
        assert eng.submit(req)
    assert eng.paged.alloc.shared_pages == 2
    seen = _guard_writes(monkeypatch, eng)
    monkeypatch.setattr(eng, "_pre_decode_grow", lambda: None)
    eng.tick()
    assert eng.fused_horizons == [4] and eng.paged.cow_forks == 1
    assert seen["writes"] > 0
    forks = [e for e in tracer.events if e.kind == "cow_fork"]
    assert [(e.slot, e.args["blk"]) for e in forks] == [(0, 1)]


# ---------------------------------------------------------------------------
# on the card: forks under captured CUDA graphs
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_shared_fused_matches_per_tick(weights):
    """On the card the fused shared engine (one CUDA graph per bucket,
    forks copied in place between replays) gives the per-tick engine's
    tokens, and the paged kernel launches once per layer on every decode
    step, per tick and through the replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels "
                    "have no CPU mode)")

    def cuda(tree):
        return {k: cuda(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}

    params = cuda(weights)
    runs = {}
    for fuse in (1, 8):
        over, trace_kw = RUNS["fused_identical"]
        eng = TE.make_engine(TR.get("yi-6b", reduced=True), TE.EngineConfig(
            device="cuda", paged=True, page_size=8, prefix_sharing=True,
            use_pallas_decode=True, **dict(over, fuse_steps=fuse)),
            params=params)
        steps = {"n": 0}
        decode = eng._decode_batch

        def counted(toks, decode=decode, steps=steps):
            steps["n"] += 1
            return decode(toks)

        eng._decode_batch = counted
        fd.reset_launches()
        m = eng.run_trace(_trace(tsched, trace_kw))
        n_steps = steps["n"] + sum(1 << (k - 1).bit_length()
                                   for k in eng.fused_horizons)
        assert fd.LAUNCHES == {"flash_decode": 0, "paged_flash_decode":
                               n_steps * eng.cfg.num_layers,
                               "flash_decode_partial": 0}
        assert m["cow_forks"] > 0
        runs[fuse] = _streams(eng)
        if fuse > 1:
            assert m["fused_ticks"] > 0
            assert all(g.graph is not None
                       for g in eng._fused_graphs.values())
    assert runs[8] == runs[1]
