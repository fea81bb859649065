"""The port's fused decode tick against ``repro``'s (mirrors
``tests/test_fused_decode.py``).

The fused engine runs up to ``fuse_steps`` decode steps per tick on the
device (``transformer.decode_fused_paged``; on the card one CUDA graph
per power-of-two horizon) and must give exactly the per-tick engine's
tokens and finish reasons, and the reference's fused engine's, on the
same trace and the reference's own reduced yi-6b weights (bridged), in
float32.  Arrivals are all at t~0 (rate 1e9), so both packages schedule
identically and their fused-tick counts agree too.

The ``cuda``-marked tests need the card: graph capture, replay, launch
accounting through replays, and defrag under captured graphs.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.paged_cache import PagedCache  # noqa: E402

# skewed prompt lengths: ragged tails, different page phases, one prompt
# spanning four pages — the horizon must keep collapsing and recovering
SKEWED_LENS = np.array([9, 17, 5, 30, 12, 24])
BASE = dict(max_batch=3, max_seq=48, max_new_tokens=5, paged=True,
            page_size=8)
POOLS = dict(rtol=1e-5, atol=1e-5)   # float32, sums in another order


@pytest.fixture(scope="module")
def weights():
    cfg = JR.get("yi-6b", reduced=True).config
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), cfg))
    return params_from_numpy(tree, TR.get("yi-6b", reduced=True).config,
                             device="cpu")


def _trace(make, eos_rate=None):
    return make(512, rate_req_s=1e9, n_requests=len(SKEWED_LENS),
                prompt_len=0, prompt_lens=SKEWED_LENS, seed=3,
                eos_rate=eos_rate)


def _streams(eng):
    return ({r.rid: list(r.tokens_out) for r in eng.completed},
            {r.rid: r.finish_reason for r in eng.completed})


def _port(params, device="cpu", **over):
    eng = TE.make_engine(TR.get("yi-6b", reduced=True),
                         TE.EngineConfig(device=device, **dict(BASE, **over)),
                         params=params)
    metrics = eng.run_trace(_trace(tsched.make_trace))
    return eng, metrics, *_streams(eng)


@functools.lru_cache(maxsize=None)
def _reference(fuse_steps, prefill_chunk=None):
    eng = JE.make_engine(JR.get("yi-6b", reduced=True), JE.EngineConfig(
        fuse_steps=fuse_steps, prefill_chunk=prefill_chunk, **BASE))
    metrics = eng.run_trace(_trace(jsched.make_trace))
    return metrics, *_streams(eng)


@pytest.fixture(scope="module")
def per_tick(weights):
    """The port's per-tick engine's (tokens, reasons), by prefill_chunk."""
    runs = {}

    def streams(prefill_chunk=None):
        if prefill_chunk not in runs:
            runs[prefill_chunk] = _port(weights,
                                        prefill_chunk=prefill_chunk)[2:]
        return runs[prefill_chunk]
    return streams


# ---------------------------------------------------------------------------
# token exactness: fused == per-tick == the reference's fused engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("fuse", [1, 8, 32])
def test_fused_matches_per_tick_and_reference(fuse, kernel, weights,
                                             per_tick):
    """On the CPU the kernel route is the plain paged attention; the
    reference runs its plain route."""
    eng, metrics, toks, reasons = _port(weights, fuse_steps=fuse,
                                        use_pallas_decode=kernel)
    assert (toks, reasons) == per_tick()
    jm, jtoks, jreasons = _reference(fuse)
    assert toks == jtoks and reasons == jreasons
    if fuse > 1:
        assert metrics["fused_ticks"] == jm["fused_ticks"] > 0
    else:
        assert metrics["fused_ticks"] == 0 and not eng._fused_graphs
    assert fd.LAUNCHES == {"flash_decode": 0, "paged_flash_decode": 0,
                           "flash_decode_partial": 0}


def test_fused_chunked_prefill_matches(weights, per_tick):
    """Chunked prefill: a slot mid-prompt has pages mapped while the
    fused loop runs, so its lane must write only the scratch page."""
    _, metrics, toks, reasons = _port(weights, fuse_steps=8,
                                      prefill_chunk=8)
    assert (toks, reasons) == per_tick(prefill_chunk=8)
    jm, jtoks, jreasons = _reference(8, prefill_chunk=8)
    assert toks == jtoks and reasons == jreasons
    assert metrics["fused_ticks"] == jm["fused_ticks"] > 0


def test_fused_eos_freezes_lane_mid_horizon(weights, per_tick):
    """A token-level eos cannot be predicted from host state: the lane
    freezes inside the loop (emit mask) and the finish reason still
    matches the per-tick engine."""
    base_t, _ = per_tick()
    eos_id = next(t[2] for t in base_t.values() if len(t) > 3)
    _, _, b_t, b_r = _port(weights, eos_id=eos_id, max_new_tokens=8)
    _, m, f_t, f_r = _port(weights, fuse_steps=64, eos_id=eos_id,
                           max_new_tokens=8)
    assert f_t == b_t and f_r == b_r
    assert "eos" in set(b_r.values())          # the stop actually fired
    assert m["fused_ticks"] > 0


def test_fused_horizon_page_and_budget_cutoffs(weights):
    entry = TR.get("yi-6b", reduced=True)

    def engine(max_new):
        eng = TE.make_engine(entry, TE.EngineConfig(
            device="cpu", max_batch=2, max_seq=64, max_new_tokens=max_new,
            paged=True, page_size=8, fuse_steps=64), params=weights)
        assert eng.submit(tsched.RequestState(0, np.arange(9,
                                                           dtype=np.int32)))
        return eng

    eng = engine(32)
    # 9 prompt tokens resident; growth maps a 2nd page, so 7 decode
    # writes (9..15) fit before the window edge: the page binds
    eng._pre_decode_grow()
    assert eng._fused_horizon() == 7
    assert eng._last_horizon_clamp == "page_edge"
    slot, req = next(iter(eng.active.items()))
    eng.tick()
    assert int(eng._lengths_host[slot]) == 16
    eng._pre_decode_grow()
    assert eng._fused_horizon() == min(8, 32 - len(req.tokens_out)) == 8
    while eng.active:
        eng.tick()
    assert eng.completed[0].finish_reason == "budget"
    assert len(eng.completed[0].tokens_out) == 32
    # budget cutoff: with 12 in all the 2nd horizon is the 4 steps left
    eng = engine(12)
    eng.tick()                                  # 7 steps: page-capped
    eng._pre_decode_grow()
    assert eng._fused_horizon() == 4
    assert eng._last_horizon_clamp == "budget"
    while eng.active:
        eng.tick()
    assert len(eng.completed[0].tokens_out) == 12
    assert eng.completed[0].finish_reason == "budget"


def test_fused_metrics_match_reference(weights):
    eng, m, _, _ = _port(weights, fuse_steps=8)
    jm = _reference(8)[0]
    fr = eng.fused_report()
    assert fr["fused_ticks"] == m["fused_ticks"] == jm["fused_ticks"] > 0
    assert m["fused_steps_mean"] == jm["fused_steps_mean"] > 1.0
    assert m["fused_steps_mean"] == pytest.approx(fr["fused_steps_mean"])
    assert 0.0 <= m["fused_host_frac"] <= 1.0
    hist = m["hists"]["fused_horizon"]
    assert hist == jm["hists"]["fused_horizon"] and hist["count"] > 0
    eng.reset_fused_counters()
    assert eng.fused_report() == {} and eng.fused_horizons == []


# ---------------------------------------------------------------------------
# decode_fused_paged against the reference's function
# ---------------------------------------------------------------------------
def _fused_inputs():
    rng = np.random.default_rng(0)
    p = 9
    kp = rng.standard_normal((2, p + 1, 4, 4, 32)).astype(np.float32)
    vp = rng.standard_normal((2, p + 1, 4, 4, 32)).astype(np.float32)
    # lanes 0 and 1 alive with room for 4 more tokens; lane 2 inactive,
    # its row routed to the scratch page as the engine routes it
    tables = np.asarray([[2, 7, 0], [4, 5, p], [p, p, p]], np.int32)
    lengths = np.asarray([6, 3, 0], np.int32)
    alive = np.asarray([True, True, False])
    toks = rng.integers(0, 512, size=3).astype(np.int32)
    return toks, kp, vp, tables, lengths, alive


@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
def test_decode_fused_paged_matches_reference(eos, weights):
    """n_steps 4 with k_active 3: tokens, emit mask and lengths exact,
    pools within 1e-5; with eos, lane 0 stops on its second token."""
    cfg = JR.get("yi-6b", reduced=True).config
    jparams = JT.init(jax.random.PRNGKey(0), cfg)
    toks, kp, vp, tables, lengths, alive = _fused_inputs()

    def reference(eos_id):
        out = JT.decode_fused_paged(
            jparams, cfg, jnp.asarray(toks), jnp.asarray(kp),
            jnp.asarray(vp), jnp.asarray(tables), jnp.asarray(lengths),
            jnp.asarray(alive), jnp.asarray(3, jnp.int32), 4,
            eos_id=eos_id)
        return [np.asarray(x) for x in out]

    eos_id = int(reference(-1)[0][1, 0]) if eos else -1
    want = reference(eos_id)
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = TT.decode_fused_paged(
        weights, TR.get("yi-6b", reduced=True).config,
        torch.from_numpy(toks), kt, vt, torch.from_numpy(tables),
        torch.from_numpy(lengths), torch.from_numpy(alive),
        torch.tensor(3, dtype=torch.int32), 4, eos_id=eos_id)
    assert got[2] is kt and got[3] is vt        # written in place
    for i in (0, 1, 4):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    np.testing.assert_allclose(kt.numpy(), want[2], **POOLS)
    np.testing.assert_allclose(vt.numpy(), want[3], **POOLS)
    emitted = got[1].numpy()
    assert not emitted[3].any() and not emitted[:, 2].any()
    if eos:
        assert emitted[:, 0].tolist() == [True, True, False, False]


# ---------------------------------------------------------------------------
# defrag keeps the pools' storage (captured graphs hold their addresses)
# ---------------------------------------------------------------------------
def test_defrag_keeps_pool_storage():
    pc = PagedCache(TR.get("yi-6b", reduced=True), max_batch=3, max_seq=32,
                    page_size=4, num_pages=16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for i, pool in enumerate(pc.store):
        if pc.is_seq[i]:
            pool.copy_(torch.randn(pool.shape, generator=gen))
    assert pc.alloc_slot(0, 10) and pc.alloc_slot(1, 6)
    assert pc.alloc_slot(2, 17)
    pc.free_slot(0)
    assert pc.fragmentation() > 0
    ptrs = [t.data_ptr() for t in pc.store]
    pools = list(pc.store)
    before = [t.clone() for t in pc.gather()]
    mapping = pc.defrag()
    assert any(o != n for o, n in mapping.items())
    assert [t.data_ptr() for t in pc.store] == ptrs
    assert all(a is b for a, b in zip(pc.store, pools))
    for a, b in zip(pc.gather(), before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert pc.mirror_consistent()


def test_fused_tick_refuses_moved_pools(weights):
    """A captured graph writes the pools at their captured addresses, so
    a pool that was replaced (not permuted in place) must be refused."""
    eng = TE.make_engine(TR.get("yi-6b", reduced=True), TE.EngineConfig(
        device="cpu", fuse_steps=8, **dict(BASE, max_new_tokens=20)),
        params=weights)
    assert eng.submit(tsched.RequestState(0, np.arange(9, dtype=np.int32)))
    eng.tick()                      # 7 steps to the page edge: bucket 8
    assert eng.fused_horizons == [7] and list(eng._fused_graphs) == [8]
    ki = eng.paged.is_seq.index(True)
    eng.paged.store[ki] = eng.paged.store[ki].clone()
    with pytest.raises(RuntimeError, match="moved"):
        eng.tick()


# ---------------------------------------------------------------------------
# serve CLI
# ---------------------------------------------------------------------------
def test_cli_serves_fused_on_cpu(capsys):
    m = serve.main(["--device", "cpu", "--n-requests", "2",
                    "--prompt-len", "6", "--max-new", "5", "--paged",
                    "--page-size", "4", "--fuse-steps", "8", "--rate",
                    "1e9"])
    assert m["requests"] == 2 and m["decoded_tokens"] == 10
    assert m["fused_ticks"] > 0 and m["fused_steps_mean"] > 1.0
    assert "[serve] yi-6b on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("argv,msg", [
    (["--fuse-steps", "8"], "--fuse-steps requires --paged"),
    (["--fuse-steps", "0", "--paged"], "--fuse-steps must be >= 1"),
])
def test_cli_refuses_bad_fuse_steps(argv, msg, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err


def test_profile_step_times_fused_windows_on_cpu(capsys):
    from repro_torch.launch import profile_step
    out = profile_step.main(["--device", "cpu", "--batch", "2",
                             "--context", "20", "--chunk", "8",
                             "--steps", "2", "--fuse-steps", "4"])
    fused = out["fused"]
    assert fused["buckets"] == [2, 4] and len(fused["rounds"]) == 3
    for r in fused["rounds"]:
        assert sum(r["fused_horizons"]) >= 8
    assert fused["profiled_tick_horizon"] == 4
    assert fused["fused_report"]["fused_ticks"] > 0
    # no device on the CPU: no device shares
    assert fused["device_busy_share"] is None
    assert '"fuse_steps": 4' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card: CUDA graphs
# ---------------------------------------------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels "
                    "have no CPU mode)")


def _cuda_params(weights):
    return {k: _cuda_params(v) if isinstance(v, dict) else v.cuda()
            for k, v in weights.items()}


def _steps_per_tick(eng):
    """Count the per-tick decode steps (the fused engine's k <= 1
    fallback) an engine runs."""
    seen = {"steps": 0}
    decode = eng._decode_batch

    def counted(toks):
        seen["steps"] += 1
        return decode(toks)

    eng._decode_batch = counted
    return seen


@pytest.mark.cuda
def test_cuda_one_graph_per_bucket(weights):
    _need_cuda()
    eng, m, toks, reasons = _port(_cuda_params(weights), "cuda",
                                  fuse_steps=32, use_pallas_decode=True,
                                  max_new_tokens=16)
    buckets = {1 << (k - 1).bit_length() for k in eng.fused_horizons}
    assert m["fused_ticks"] > 0 and set(eng._fused_graphs) == buckets
    assert all(g.graph is not None for g in eng._fused_graphs.values())
    assert sum(g.replays for g in eng._fused_graphs.values()) \
        == m["fused_ticks"]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_cuda_replay_matches_eager(kernel, weights):
    """A graph replay gives the eager fused loop's tokens on the same
    inputs, and the fused engine the per-tick engine's."""
    _need_cuda()
    params = _cuda_params(weights)
    _, _, toks, reasons = _port(params, "cuda", use_pallas_decode=kernel,
                                max_new_tokens=12)
    eng, _, f_toks, f_reasons = _port(params, "cuda", fuse_steps=8,
                                      use_pallas_decode=kernel,
                                      max_new_tokens=12)
    assert f_toks == toks and f_reasons == reasons
    # one more horizon on a live batch: eager body, then the replay
    assert eng.submit(tsched.RequestState(99, np.arange(1, 12,
                                                        dtype=np.int32)))
    eng._pre_decode_grow()
    b = eng.ecfg.max_batch
    active = np.zeros(b, bool)
    active[list(eng.active)] = True
    packed = np.concatenate([eng._next_tok,
                             np.where(active, eng._lengths_host, 0),
                             active, [eng._fused_horizon()]]
                            ).astype(np.int32)
    graph = eng._fused_fn(8)
    tables = eng.paged.tables_device()
    out_eager, len_eager = graph.body(torch.from_numpy(packed).cuda(),
                                      tables.clone())
    out_eager, len_eager = out_eager.cpu().numpy(), len_eager.cpu()
    pools = [t for t, seq in zip(eng.paged.store, eng.paged.is_seq) if seq]
    out, lengths = graph(packed, tables, pools)
    np.testing.assert_array_equal(out, out_eager)
    assert torch.equal(lengths.cpu(), len_eager)


@pytest.mark.cuda
def test_cuda_defrag_between_fused_ticks(weights):
    """Defrag runs between fused ticks (the skewed trace fragments the
    pool): the pools keep their addresses and the tokens do not move."""
    _need_cuda()
    params = _cuda_params(weights)
    _, _, toks, reasons = _port(params, "cuda", use_pallas_decode=True,
                                defrag_threshold=None, max_new_tokens=12)
    eng, m, f_toks, f_reasons = _port(params, "cuda", fuse_steps=8,
                                      use_pallas_decode=True,
                                      max_new_tokens=12)
    assert m["defrag_runs"] > 0 and m["fused_ticks"] > 0
    assert f_toks == toks and f_reasons == reasons


@pytest.mark.cuda
def test_cuda_launches_count_replays(weights):
    """Each replay adds its capture's launches: the paged kernel counts
    (per-tick steps + the bucketed n_steps of every horizon) x layers,
    warm-ups and captures not at all."""
    _need_cuda()
    params = _cuda_params(weights)
    eng = TE.make_engine(TR.get("yi-6b", reduced=True), TE.EngineConfig(
        device="cuda", fuse_steps=16, use_pallas_decode=True,
        **dict(BASE, max_new_tokens=16)), params=params)
    seen = _steps_per_tick(eng)
    fd.reset_launches()
    eng.run_trace(_trace(tsched.make_trace))
    n_steps = sum(1 << (k - 1).bit_length() for k in eng.fused_horizons)
    layers = eng.cfg.num_layers
    assert eng.fused_horizons and fd.LAUNCHES == {
        "flash_decode": 0, "flash_decode_partial": 0,
        "paged_flash_decode": (seen["steps"] + n_steps) * layers}
    for graph in eng._fused_graphs.values():
        assert [(name, n) for _, name, n in graph.launches] == [
            ("paged_flash_decode", graph.n_steps * layers)]
    fd.reset_launches()                 # counts only, never the records
    assert all(g.launches for g in eng._fused_graphs.values())
