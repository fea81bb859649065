"""The port's paged KV cache against ``repro.serving.paged_cache``.

The same op script (alloc, write_slot, scatter_chunk, growth,
scatter_token, free, defrag) runs on both caches with the same numpy
data; afterwards the allocators must hand out the same pages in the same
order, the pools must be element-equal on every live page (the scratch
page only ever receives discarded writes, whose order under duplicate
indices is unspecified), and the device table mirror must equal the host
tables.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import registry as JR  # noqa: E402
from repro.models.transformer import KVCache as JKV  # noqa: E402
from repro.serving import paged_cache as JP  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.transformer import KVCache as TKV  # noqa: E402
from repro_torch.serving import paged_cache as TP  # noqa: E402

PAGE, MAX_SEQ, BATCH, PAGES = 4, 32, 4, 16


def _caches():
    j = JP.PagedCache(JR.get("yi-6b", reduced=True), max_batch=BATCH,
                      max_seq=MAX_SEQ, page_size=PAGE, num_pages=PAGES)
    t = TP.PagedCache(TR.get("yi-6b", reduced=True), max_batch=BATCH,
                      max_seq=MAX_SEQ, page_size=PAGE, num_pages=PAGES,
                      device="cpu")
    return j, t


def _kv(rng, b, lengths):
    k = rng.standard_normal((2, b, MAX_SEQ, 4, 32)).astype(np.float32)
    v = rng.standard_normal((2, b, MAX_SEQ, 4, 32)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    return (JKV(jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln)),
            TKV(torch.from_numpy(k), torch.from_numpy(v),
                torch.from_numpy(ln)))


def _run_script(j, t, seed=0):
    """Apply one op sequence to both caches; returns the slots' lengths."""
    rng = np.random.default_rng(seed)
    for pc in (j, t):
        assert pc.alloc_slot(0, 10) and pc.alloc_slot(1, 6)
        assert pc.alloc_slot(2, 17)
    jc, tc = _kv(rng, 1, [9])
    j.write_slot(0, jc, 9)
    t.write_slot(0, tc, 9)
    jc, tc = _kv(rng, 1, [0])
    for pos, take in ((0, 4), (4, 1)):            # two prefill chunks
        j.scatter_chunk(1, jc, pos, take)
        t.scatter_chunk(1, tc, pos, take)
    jc, tc = _kv(rng, 1, [16])
    j.write_slot(2, jc, 16)
    t.write_slot(2, tc, 16)
    for pc in (j, t):
        assert pc.extend_slot(0, 13)              # decode growth
    positions = np.asarray([12, 5, 16, 0])
    active = np.asarray([True, True, True, False])
    jc, tc = _kv(rng, BATCH, positions + 1)
    j.scatter_token(jc, positions, active)
    t.scatter_token(tc, positions, active)
    for pc in (j, t):
        pc.free_slot(1)
        assert pc.alloc_slot(3, 3)
        pc.free_slot(0)
    assert j.fragmentation() == t.fragmentation() > 0
    assert j.defrag() == t.defrag()


def _assert_same(j, t):
    np.testing.assert_array_equal(j.tables, t.tables)
    live = slice(0, PAGES)                        # scratch page excluded
    for jl, tl, seq in zip(j.store, t.store, t.is_seq):
        jl, tl = np.asarray(jl), tl.numpy()
        if seq:
            np.testing.assert_array_equal(tl[:, live], jl[:, live])
        else:
            np.testing.assert_array_equal(tl, jl)
    assert t.mirror_consistent()
    ref = np.where(t.tables < 0, PAGES, t.tables)
    np.testing.assert_array_equal(t.tables_device().numpy(), ref)
    np.testing.assert_array_equal(np.asarray(j.tables_device()),
                                  t.tables_device().numpy())


def test_op_script_matches_reference():
    j, t = _caches()
    _run_script(j, t)
    _assert_same(j, t)
    # the allocators hand out the same pages, in the same order
    for pc in (j, t):
        assert pc.alloc_slot(0, 14) and pc.alloc_slot(1, 9)
    np.testing.assert_array_equal(j.tables, t.tables)
    assert t.pages_in_use() == j.pages_in_use()
    assert t.sharing_report() == j.sharing_report()


def test_gather_views_match_reference():
    j, t = _caches()
    _run_script(j, t, seed=1)
    for jv, tv in zip(j.gather_slot(2, 16), t.gather_slot(2, 16)):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jg, tg = j.gather(), t.gather()
    mapped = t.tables >= 0                       # unmapped -> scratch
    for jv, tv in zip(jg[:2], tg[:2]):
        jv = np.asarray(jv).reshape(2, BATCH, -1, PAGE, 4, 32)
        tv = tv.numpy().reshape(2, BATCH, -1, PAGE, 4, 32)
        np.testing.assert_array_equal(tv[:, mapped], jv[:, mapped])


def test_mirror_stays_incremental_and_consistent():
    _, t = _caches()
    dev = t.tables_device()
    assert t.alloc_slot(1, 9)
    assert t.tables_device() is dev               # updated in place
    assert t.extend_slot(1, 13) and t.mirror_consistent()
    t.free_slot(1)
    assert t.mirror_consistent()
    assert (t.tables_device() == PAGES).all()


def test_probe_finds_kv_seq_leaves():
    assert TP.probe_seq_leaves(TR.get("yi-6b", reduced=True), 3) == \
        [True, True, False]


def test_scatter_token_past_window_goes_to_scratch():
    _, t = _caches()
    assert t.alloc_slot(0, 8)                     # 2 pages, window 32
    before = [p.clone() for p in t.store[:2]]
    _, tc = _kv(np.random.default_rng(2), BATCH, [33, 0, 0, 0])
    t.scatter_token(tc, np.asarray([MAX_SEQ + 1, 0, 0, 0]),
                    np.asarray([True, False, False, False]))
    for pool, old in zip(t.store[:2], before):
        assert torch.equal(pool[:, :PAGES], old[:, :PAGES])


# ---------------------------------------------------------------------------
# PageAllocator
# ---------------------------------------------------------------------------
def test_allocator_order_matches_reference():
    ja, ta = JP.PageAllocator(12), TP.PageAllocator(12)
    for n in (3, 2, 4):
        assert ja.alloc(n) == ta.alloc(n)
    for a in (ja, ta):
        a.free([1, 3])
        a.incref(4)
        a.decref(4)
    assert ja.alloc(3) == ta.alloc(3) == [3, 1, 9]
    assert ja.live_pages() == ta.live_pages()


def test_allocator_failed_alloc_leaves_state():
    a = TP.PageAllocator(4)
    a.alloc(3)
    assert a.alloc(2) is None
    assert a.free_pages == 1 and a.used_pages == 3


def test_allocator_refcounts_and_double_free():
    a = TP.PageAllocator(4)
    (p,) = a.alloc(1)
    a.incref(p)
    assert a.shared_pages == 1
    assert not a.decref(p) and a.decref(p)
    with pytest.raises(ValueError):
        a.decref(p)
    with pytest.raises(ValueError):
        a.incref(p)


def test_allocator_rebuild_hands_out_lowest_first():
    a = TP.PageAllocator(6)
    a.rebuild({4: 1, 1: 2})
    assert a.refcount(1) == 2 and a.free_pages == 4
    assert a.alloc(3) == [0, 2, 3]
    with pytest.raises(ValueError):
        a.rebuild({9: 1})
    with pytest.raises(ValueError):
        a.rebuild({2: 0})


@pytest.mark.parametrize("bad", [0, -3])
def test_bad_sizes_rejected(bad):
    with pytest.raises(ValueError):
        TP.PageAllocator(bad)
    with pytest.raises(ValueError):
        TP.PagedCache(TR.get("yi-6b", reduced=True), max_batch=2,
                      max_seq=16, page_size=bad, num_pages=4, device="cpu")


def test_recurrent_state_stays_slot_dense():
    """RWKV6 has no sequence leaf: the probe finds none, no page is ever
    mapped, and write_slot / gather / scatter_token act on the dense
    slot columns exactly as the reference's cache does."""
    from repro.models.rwkv6 import RWKVState as JS
    from repro_torch.models.rwkv6 import RWKVState as TS
    j = JP.PagedCache(JR.get("rwkv6-7b", reduced=True), max_batch=BATCH,
                      max_seq=MAX_SEQ, page_size=PAGE, num_pages=PAGES)
    t = TP.PagedCache(TR.get("rwkv6-7b", reduced=True), max_batch=BATCH,
                      max_seq=MAX_SEQ, page_size=PAGE, num_pages=PAGES,
                      device="cpu")
    assert t.is_seq == list(j.is_seq) == [False] * 4
    assert not t.has_seq and not j.has_seq
    rng = np.random.default_rng(0)

    def state(b, length):
        leaves = [rng.standard_normal((2, b, 128)).astype(np.float32),
                  rng.standard_normal((2, b, 128)).astype(np.float32),
                  rng.standard_normal((2, b, 4, 32, 32)).astype(np.float32),
                  np.full((b,), length, np.int32)]
        return (JS(*(jnp.asarray(a) for a in leaves)),
                TS(*(torch.from_numpy(a) for a in leaves)))

    for pc in (j, t):
        assert pc.alloc_slot(2, 30) and pc.extend_slot(2, 31)
    js, ts = state(1, 9)
    j.write_slot(2, js, 9)
    t.write_slot(2, ts, 9)
    assert t.pages_in_use() == j.pages_in_use() == 0
    for a, b in zip(j.gather(), t.gather()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    js, ts = state(BATCH, 10)
    active = np.array([False, True, True, False])
    j.scatter_token(js, np.zeros(BATCH, np.int64), active)
    t.scatter_token(ts, np.zeros(BATCH, np.int64), active)
    for a, b, want in zip(j.gather(), t.gather(), ts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert b is want      # replaced wholesale, as the reference does
    t.free_slot(2)
    assert t.fragmentation() == 0.0 and t.alloc.free_pages == PAGES
