"""Layer functions of the PyTorch port against ``repro.models.layers``.

Every case feeds the same numpy inputs (seeded) to the JAX function and
its port and compares in float32.  Tolerances: 1e-5 for pointwise work
(norms, rope, projections — both sides run the same float32 operations,
only the matmul summation order differs); 2e-5 for attention, whose
online softmax sums in another order.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models.config import ArchConfig as JArchConfig  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402

PW = dict(rtol=1e-5, atol=1e-5)
ATTN = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64)
    p = {"scale": _rand(rng, 64)}
    if kind == "layernorm":
        p["bias"] = _rand(rng, 64)
    pj, pt = _both(p)
    _close(TL.apply_norm(kind, pt, torch.from_numpy(x)),
           JL.apply_norm(kind, pj, jnp.asarray(x)), PW)


@pytest.mark.parametrize("theta", [10000.0, 5000000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 6, 3, 32)
    pos = rng.integers(0, 4096, size=(2, 6)).astype(np.int32)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), PW)
    _close(TL.rope_freqs(32, theta), JL.rope_freqs(32, theta), PW)


@pytest.mark.parametrize("d,sections", [(128, (16, 24, 24)),
                                         (32, (16, 24, 24)),
                                         (32, (4, 6, 6))])
def test_apply_mrope(d, sections):
    """(B, S, 3) positions with three distinct streams; at D = 32 the
    published sections are cut to D/2 (all in section 0)."""
    rng = np.random.default_rng(d + sections[0])
    x = _rand(rng, 2, 6, 3, d)
    pos = rng.integers(0, 4096, size=(2, 6, 3)).astype(np.int32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                        sections)
    _close(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              sections), PW)
    one = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]),
                        1e6)
    assert torch.equal(got, one) == (sum(sections[:1]) >= d // 2)


def test_apply_mrope_refuses_short_sections():
    x = torch.zeros(1, 2, 1, 128)
    with pytest.raises(ValueError, match="sections"):
        TL.apply_rope(x, torch.zeros(1, 2, 3, dtype=torch.int32), 1e4,
                      (8, 8, 8))


@pytest.mark.parametrize("bias", [False, True])
def test_qkv_project(bias):
    rng = np.random.default_rng(2)
    hq, hkv, dh, d = 4, 2, 16, 64
    p = {"wq": _rand(rng, d, hq * dh), "wk": _rand(rng, d, hkv * dh),
         "wv": _rand(rng, d, hkv * dh)}
    if bias:
        p.update(bq=_rand(rng, hq * dh), bk=_rand(rng, hkv * dh),
                 bv=_rand(rng, hkv * dh))
    pj, pt = _both(p)
    x = _rand(rng, 2, 3, d)
    for got, want in zip(TL.qkv_project(pt, torch.from_numpy(x), hq, hkv, dh),
                         JL.qkv_project(pj, jnp.asarray(x), hq, hkv, dh)):
        _close(got, want, PW)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("silu", False)])
def test_apply_ffn(act, gated):
    rng = np.random.default_rng(3)
    p = {"w_up": _rand(rng, 32, 64) * 0.2, "w_down": _rand(rng, 64, 32) * 0.2}
    if gated:
        p["w_gate"] = _rand(rng, 32, 64) * 0.2
    pj, pt = _both(p)
    x = _rand(rng, 2, 5, 32)
    _close(TL.apply_ffn(pt, torch.from_numpy(x), act),
           JL.apply_ffn(pj, jnp.asarray(x), act), PW)


@pytest.mark.parametrize("tie", [False, True])
def test_embed_unembed(tie):
    rng = np.random.default_rng(4)
    p = {"table": _rand(rng, 50, 16)}
    if not tie:
        p["head"] = _rand(rng, 16, 50)
    pj, pt = _both(p)
    toks = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    _close(TL.embed(pt, torch.from_numpy(toks)),
           JL.embed(pj, jnp.asarray(toks)), dict(rtol=0, atol=0))
    h = _rand(rng, 3, 16)
    _close(TL.unembed(pt, torch.from_numpy(h)),
           JL.unembed(pj, jnp.asarray(h)), PW)


# (sq, skv, q_offset, hq, hkv, q_block, kv_block): whole-prompt prefill
# with ragged tiles, and chunk continuations against a longer buffer
BLOCKED = [
    (24, 24, 0, 4, 4, 512, 512),
    (24, 24, 0, 4, 1, 8, 5),
    (9, 40, 16, 8, 2, 4, 16),
    (8, 64, 56, 4, 4, 512, 512),
]


@pytest.mark.parametrize("sq,skv,q_offset,hq,hkv,qb,kb", BLOCKED)
def test_blocked_attention(sq, skv, q_offset, hq, hkv, qb, kb):
    rng = np.random.default_rng(sq + skv)
    q, k, v = (_rand(rng, 2, sq, hq, 16), _rand(rng, 2, skv, hkv, 16),
               _rand(rng, 2, skv, hkv, 16))
    want = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, q_block=qb,
                                kv_block=kb, q_offset=q_offset)
    got = TL.blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               q_block=qb, kv_block=kb, q_offset=q_offset)
    _close(got, want, ATTN)


def test_blocked_attention_non_causal():
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, 1, 7, 2, 8), _rand(rng, 1, 11, 1, 8), \
        _rand(rng, 1, 11, 1, 8)
    want = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False, q_block=4,
                                kv_block=4)
    got = TL.blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=False,
                               q_block=4, kv_block=4)
    _close(got, want, ATTN)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_decode_attention(hq, hkv):
    rng = np.random.default_rng(6)
    q, k, v = _rand(rng, 3, hq, 16), _rand(rng, 3, 20, hkv, 16), \
        _rand(rng, 3, 20, hkv, 16)
    lengths = np.asarray([0, 9, 20], np.int32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lengths))
    got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lengths))
    _close(got, want, ATTN)


def test_paged_decode_attention_scratch_entries():
    """Unmapped table entries point at the scratch page, which holds
    garbage that must not reach the output."""
    rng = np.random.default_rng(7)
    page, p = 4, 6
    kp, vp = _rand(rng, p + 1, page, 2, 16), _rand(rng, p + 1, page, 2, 16)
    kp[p] = vp[p] = 1e3
    tables = np.asarray([[3, 0, p], [5, p, p]], np.int32)
    lengths = np.asarray([6, 4], np.int32)
    q = _rand(rng, 2, 4, 16)
    want = JL.paged_decode_attention(*(jnp.asarray(a) for a in
                                       (q, kp, vp, tables, lengths)))
    got = TL.paged_decode_attention(*(torch.from_numpy(a) for a in
                                      (q, kp, vp, tables, lengths)))
    _close(got, want, ATTN)
    assert np.abs(got.numpy()).max() < 10


def test_init_matches_reference_distributions():
    """The port draws its own weights, with the reference's shapes,
    dtypes and scales (N(0, 0.02^2), output projections scaled by
    1/sqrt(2 * num_layers))."""
    cfg = ArchConfig("t", "dense", num_layers=2, d_model=256,
                     num_q_heads=4, num_kv_heads=2, d_head=64, d_ff=512,
                     vocab=1000, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = TL.init_attention(gen, cfg, torch.float32, 4, 2, lead=(2,))
    assert tuple(p["wq"].shape) == (2, 256, 256)
    assert tuple(p["wk"].shape) == (2, 256, 128)
    assert abs(p["wq"].std().item() - 0.02) < 1e-3
    assert abs(p["wo"].std().item() - 0.02 / math.sqrt(4)) < 1e-3
    f = TL.init_ffn(gen, 256, 512, True, torch.bfloat16, 2, lead=(2,))
    assert f["w_gate"].dtype == torch.bfloat16
    assert abs(f["w_up"].float().mean().item()) < 1e-3
    assert JArchConfig.__dataclass_fields__.keys() >= \
        ArchConfig.__dataclass_fields__.keys()
