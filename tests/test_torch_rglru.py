"""The port's RecurrentGemma (``repro_torch.models.rglru``) against
``repro.models.rglru`` on the reference's own reduced recurrentgemma-9b
weights (``init(PRNGKey(0), cfg)``, moved across with
``bridge.params_from_numpy``), in float32.

The reduced config has 5 layers (one (rec, rec, attn) group and a
recurrent tail of 2), width 128 and a local-attention window of 64, so
prompts of 17 and 100 tokens take both prefill branches (left-padded
window, last-64 window) and a decode from 17 tokens crosses the window.

Tolerance 1e-4 (rtol and atol) on logits and every state leaf: both
sides run the same float32 algorithm, but the port's doubling scan sums
the recurrence in another order than ``lax.associative_scan``.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import rglru as JG  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import rglru as TG  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = JR.get(ARCH, reduced=True).config
    tcfg = TR.get(ARCH, reduced=True).config
    jparams = JG.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


@functools.lru_cache(maxsize=None)
def _jit_step(cfg):
    return jax.jit(lambda p, t, s: JG.decode_step(p, cfg, t, s))


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def _close_state(jstate, tstate):
    for name, a, b in zip(JG.RGState._fields, jstate, tstate):
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), err_msg=name,
                                   **TOL)


def test_config_is_the_reference_config():
    for reduced in (False, True):
        jc = JR.get(ARCH, reduced=reduced).config
        tc = TR.get(ARCH, reduced=reduced).config
        assert {f: getattr(tc, f) for f in tc.__dataclass_fields__} == \
            {f: getattr(jc, f) for f in tc.__dataclass_fields__}
    assert TR.get(ARCH).module is TG


def test_init_builds_the_reference_tree(model):
    jcfg, tcfg, jparams, _ = model
    ours = TG.init(tcfg, device="cpu", seed=3)
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jparams))[0]
    want = {jax.tree_util.keystr(p): (a.shape, str(a.dtype))
            for p, a in flat_j}
    flat_t = jax.tree_util.tree_flatten_with_path(ours)[0]
    got = {jax.tree_util.keystr(p): (tuple(t.shape),
                                     str(t.dtype).replace("torch.", ""))
           for p, t in flat_t}
    assert got == want
    assert ours["rec_groups"]["w_in_x"].shape[:2] == (1, 2)
    lam = ours["rec_groups"]["lru"]["lam"]
    assert 0.9 <= float(lam.min()) and float(lam.max()) < 0.999


@pytest.mark.parametrize("sq,skv,window,q_offset,blocks", [
    (100, 100, 16, 0, (32, 16)),     # kv tiles wholly before the window
    (70, 70, 64, 0, (512, 512)),     # the model's call, one tile
    (9, 60, 20, 51, (4, 8)),         # a continuation chunk
    (40, 40, 0, 0, (16, 16)),        # no window: causal only
])
@pytest.mark.parametrize("g", [1, 4])
def test_blocked_attention_window_matches_reference(sq, skv, window,
                                                    q_offset, blocks, g):
    rng = np.random.default_rng(sq + window + g)
    q = rng.standard_normal((2, sq, 2 * g, 32)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, skv, 2, 32)).astype(np.float32)
    qb, kb = blocks
    want = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                q_block=qb, kv_block=kb, q_offset=q_offset)
    got = TL.blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               window=window, q_block=qb, kv_block=kb,
                               q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 5, 64, 100])
def test_lru_scan_matches_reference(model, s):
    """The doubling scan against ``lax.associative_scan`` from a nonzero
    state, and the single step against the reference's step."""
    jcfg, _, jparams, tparams = model
    jlp = jax.tree.map(lambda a: a[0, 1], jparams["rec_groups"])["lru"]
    tlp = TG._take(tparams["rec_groups"], 0, 1)["lru"]
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 128)).astype(np.float32)
    h0 = rng.standard_normal((2, 128)).astype(np.float32)
    jh, jlast = JG._lru_seq(jlp, jnp.asarray(x), jnp.asarray(h0))
    th, tlast = TG._lru_seq(tlp, torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    jstep, _ = JG._lru_step(jlp, jnp.asarray(x[:, 0]), jnp.asarray(h0))
    tstep = TG._lru_step(tlp, torch.from_numpy(x[:, 0]),
                         torch.from_numpy(h0))
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), **TOL)


@pytest.mark.parametrize("s", [1, 2, 17])
def test_conv1d_matches_reference(model, s):
    _, _, jparams, tparams = model
    jlp = jax.tree.map(lambda a: a[0], jparams["rec_tail"])
    tlp = TG._take(tparams["rec_tail"], 0)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 128)).astype(np.float32)
    look = rng.standard_normal((2, 3, 128)).astype(np.float32)
    jy, jl = JG._conv1d_seq(jlp, jnp.asarray(x), jnp.asarray(look))
    ty, tl = TG._conv1d_seq(tlp, torch.from_numpy(x),
                            torch.from_numpy(look))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_forward_seq_matches_reference(model):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(2, 30)
    jh, (jk, jv) = JG.forward_seq(jparams, jcfg, jnp.asarray(toks))
    th, (tk, tv) = TG.forward_seq(tparams, tcfg, torch.from_numpy(toks))
    for a, b in ((jh, th), (jk, tk), (jv, tv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("s", [17, 100])
def test_prefill_matches_reference(model, s):
    """Logits and every state leaf: a left-padded window (17 < 64) and the
    last 64 of 100 positions."""
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(2, s, seed=s)
    jl, js = JG.prefill(jparams, jcfg, jnp.asarray(toks))
    tl, ts = TG.prefill(tparams, tcfg, torch.from_numpy(toks), max_seq=300)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_state(js, ts)
    assert (ts.pos_cache == -1).sum().item() == 2 * max(0, 64 - s)


@pytest.mark.parametrize("s,steps", [(17, 50), (100, 6)])
def test_decode_matches_reference(model, s, steps):
    """Greedy decode, every step's logits; from 17 tokens the window fills
    after 47 steps and then evicts (a step across the window)."""
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(2, s, seed=s + 1)
    jl, js = JG.prefill(jparams, jcfg, jnp.asarray(toks))
    tl, ts = TG.prefill(tparams, tcfg, torch.from_numpy(toks))
    step = _jit_step(jcfg)
    for i in range(steps):
        nxt = np.array(jnp.argmax(jl[:, :jcfg.vocab], -1), np.int32)
        jl, js = step(jparams, jnp.asarray(nxt), js)
        tl, ts = TG.decode_step(tparams, tcfg, torch.from_numpy(nxt), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **TOL)
    _close_state(js, ts)
    assert int(ts.lengths[0]) == s + steps
    if s + steps > 64:                  # the window has evicted
        assert (ts.pos_cache >= 0).all()
        assert int(ts.pos_cache[0, 0, 0]) == s + steps - 64


def test_decode_matches_prefill(model):
    """prefill(t[:n]) then decode(t[n]) gives prefill(t[:n+1])'s logits
    (ref tests/test_arch_smoke.py::test_decode_matches_prefill)."""
    _, tcfg, _, tparams = model
    toks = torch.from_numpy(_tokens(1, 13, seed=3))
    _, state = TG.prefill(tparams, tcfg, toks[:, :12])
    lg_step, _ = TG.decode_step(tparams, tcfg, toks[:, 12], state)
    lg_all, _ = TG.prefill(tparams, tcfg, toks)
    torch.testing.assert_close(lg_step, lg_all, **TOL)


def test_bf16_dtypes_match_reference():
    """At bf16 weights every state leaf and the logits take the
    reference's dtype (float32 recurrence, bf16 conv lookback and
    caches)."""
    jcfg = JR.get(ARCH, reduced=True, dtype="bfloat16").config
    tcfg = TR.get(ARCH, reduced=True, dtype="bfloat16").config
    jparams = JG.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    toks = _tokens(1, 9)
    jl, js = JG.prefill(jparams, jcfg, jnp.asarray(toks))
    tl, ts = TG.prefill(tparams, tcfg, torch.from_numpy(toks))
    nxt = np.array(jnp.argmax(jl[:, :jcfg.vocab], -1), np.int32)
    jl2, js2 = JG.decode_step(jparams, jcfg, jnp.asarray(nxt), js)
    tl2, ts2 = TG.decode_step(tparams, tcfg, torch.from_numpy(nxt), ts)
    for (ja, ta) in [(jl, tl), (jl2, tl2), *zip(js, ts), *zip(js2, ts2)]:
        assert str(ta.dtype).replace("torch.", "") == str(ja.dtype)
    np.testing.assert_allclose(tl2.float().numpy(),
                               np.asarray(jl2, np.float32), rtol=5e-2,
                               atol=5e-2)
