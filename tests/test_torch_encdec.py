"""The port's Whisper encoder-decoder (``repro_torch.models.encdec``)
against ``repro.models.encdec`` on the reference's own reduced
whisper-small weights (``init(PRNGKey(0), cfg)``, moved across with
``bridge.params_from_numpy``), in float32.

The reduced config has 2 encoder and 2 decoder layers, width 128, 32
frames and a 256-row decoder position table.  Tolerance 1e-4 (rtol and
atol): both sides run the same float32 algorithm, summed in another
order.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import encdec as JD  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.models import encdec as TD  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

ARCH = "whisper-small"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = JR.get(ARCH, reduced=True).config
    tcfg = TR.get(ARCH, reduced=True).config
    jparams = JD.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def _frames(cfg, b, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)


def _close_cache(jcache, tcache):
    for name, a, b in zip(JD.EncDecCache._fields, jcache, tcache):
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
    assert TR.get(ARCH).module is TD


def test_init_builds_the_reference_tree(model):
    jcfg, tcfg, jparams, _ = model
    ours = TD.init(tcfg, device="cpu", seed=3)
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jparams))[0]
    want = {jax.tree_util.keystr(p): (a.shape, str(a.dtype))
            for p, a in flat_j}
    flat_t = jax.tree_util.tree_flatten_with_path(ours)[0]
    got = {jax.tree_util.keystr(p): (tuple(t.shape),
                                     str(t.dtype).replace("torch.", ""))
           for p, t in flat_t}
    assert got == want
    assert "head" not in ours["embed"]            # tied, as the reference


def test_sinusoid_matches_reference():
    """Whisper's 1500 x 768 table: angles up to 1500 rad, whose float32
    sines differ by ~3e-5 between the two libraries' range reductions."""
    np.testing.assert_allclose(TD._sinusoid(1500, 768).numpy(),
                               np.asarray(JD._sinusoid(1500, 768)), **TOL)


def test_encode_matches_reference(model):
    jcfg, tcfg, jparams, tparams = model
    fr = _frames(jcfg, 2)
    want = JD.encode(jparams, jcfg, jnp.asarray(fr))
    got = TD.encode(tparams, tcfg, torch.from_numpy(fr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [1, 13])
def test_prefill_matches_reference(model, s):
    """Logits and every cache leaf, the self K/V padded to max_seq."""
    jcfg, tcfg, jparams, tparams = model
    toks, fr = _tokens(2, s, seed=s), _frames(jcfg, 2, seed=s)
    jl, jc = JD.prefill(jparams, jcfg, jnp.asarray(toks), jnp.asarray(fr),
                        max_seq=20)
    tl, tc = TD.prefill(tparams, tcfg, torch.from_numpy(toks),
                        torch.from_numpy(fr), max_seq=20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(jc, tc)
    assert tc.self_k.shape[2] == 20


def test_decode_matches_reference(model):
    """Eight greedy steps: every step's logits and the final cache."""
    jcfg, tcfg, jparams, tparams = model
    toks, fr = _tokens(2, 9, seed=4), _frames(jcfg, 2, seed=4)
    jl, jc = JD.prefill(jparams, jcfg, jnp.asarray(toks), jnp.asarray(fr),
                        max_seq=20)
    tl, tc = TD.prefill(tparams, tcfg, torch.from_numpy(toks),
                        torch.from_numpy(fr), max_seq=20)
    step = jax.jit(lambda p, t, c: JD.decode_step(p, jcfg, t, c))
    for i in range(8):
        nxt = np.array(jnp.argmax(jl[:, :jcfg.vocab], -1), np.int32)
        jl, jc = step(jparams, jnp.asarray(nxt), jc)
        tl, tc = TD.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **TOL)
    _close_cache(jc, tc)


def test_decode_matches_prefill(model):
    """prefill(t[:n]) then decode(t[n]) gives prefill(t[:n+1])'s logits
    (ref tests/test_arch_smoke.py::test_decode_matches_prefill)."""
    jcfg, tcfg, _, tparams = model
    toks = torch.from_numpy(_tokens(1, 13, seed=3))
    fr = torch.from_numpy(_frames(jcfg, 1, seed=3))
    _, cache = TD.prefill(tparams, tcfg, toks[:, :12], fr, max_seq=16)
    lg_step, _ = TD.decode_step(tparams, tcfg, toks[:, 12], cache)
    lg_all, _ = TD.prefill(tparams, tcfg, toks, fr, max_seq=17)
    torch.testing.assert_close(lg_step, lg_all, **TOL)


def test_stale_lanes_match_reference(model):
    """Lanes past the cache and past the position table (only a lane out
    of the decode batch gets there): the write lands at S-1 and the
    position embedding reads NaN, as the reference's clamped
    dynamic_update_slice and jnp.take's fill do; the in-range lane is
    unchanged by them."""
    jcfg, tcfg, jparams, tparams = model
    toks, fr = _tokens(3, 5, seed=6), _frames(jcfg, 3, seed=6)
    jl, jc = JD.prefill(jparams, jcfg, jnp.asarray(toks), jnp.asarray(fr),
                        max_seq=24)
    tl, tc = TD.prefill(tparams, tcfg, torch.from_numpy(toks),
                        torch.from_numpy(fr), max_seq=24)
    rows = jcfg.max_seq
    lens = np.asarray([5, 30, rows + 7], np.int32)
    jc = jc._replace(lengths=jnp.asarray(lens))
    tc = tc._replace(lengths=torch.from_numpy(lens))
    nxt = np.asarray([1, 2, 3], np.int32)
    jl, jc = JD.decode_step(jparams, jcfg, jnp.asarray(nxt), jc)
    tl, tc = TD.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc)
    jl = np.asarray(jl)
    assert np.isnan(jl[2]).all() and torch.isnan(tl[2]).all()
    np.testing.assert_allclose(tl[:2].numpy(), jl[:2], **TOL)
    for name, a, b in zip(JD.EncDecCache._fields, jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   equal_nan=True, **TOL)
    assert torch.isnan(tc.self_k[:, 2, 23]).all()


def test_bf16_dtypes_match_reference():
    """bf16 weights with the engine's float32 frames: the encoder output
    and the prefill's cross K/V are float32 (JAX promotes f32 @ bf16),
    the self K/V and logits bf16, on both sides; decode on a bf16 cache
    keeps the reference's dtypes too."""
    jcfg = JR.get(ARCH, reduced=True, dtype="bfloat16").config
    tcfg = TR.get(ARCH, reduced=True, dtype="bfloat16").config
    jparams = JD.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    toks, fr = _tokens(2, 7), _frames(jcfg, 2)
    jenc = JD.encode(jparams, jcfg, jnp.asarray(fr))
    tenc = TD.encode(tparams, tcfg, torch.from_numpy(fr))
    jl, jc = JD.prefill(jparams, jcfg, jnp.asarray(toks), jnp.asarray(fr),
                        max_seq=12)
    tl, tc = TD.prefill(tparams, tcfg, torch.from_numpy(toks),
                        torch.from_numpy(fr), max_seq=12)
    assert str(jenc.dtype) == "float32" and tenc.dtype == torch.float32
    assert str(jc.cross_k.dtype) == "float32"
    assert str(jc.self_k.dtype) == "bfloat16"
    # the engine's cache: the cross K/V cast to the cache's dtype
    jz = JD.EncDecCache.zeros(jcfg, 2, 12)
    tz = TD.EncDecCache.zeros(tcfg, 2, 12, device="cpu")
    jc = jax.tree.map(lambda z, n: n.astype(z.dtype), jz, jc)
    tc = TD.EncDecCache(*(n.to(z.dtype) for z, n in zip(tz, tc)))
    nxt = np.asarray([3, 4], np.int32)
    jl2, jc2 = JD.decode_step(jparams, jcfg, jnp.asarray(nxt), jc)
    tl2, tc2 = TD.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc)
    for ja, ta in [(jl, tl), (jl2, tl2), *zip(jc, tc), *zip(jc2, tc2)]:
        assert str(ta.dtype).replace("torch.", "") == str(ja.dtype)
