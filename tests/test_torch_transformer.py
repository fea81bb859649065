"""The port's transformer against ``repro.models.transformer`` on the
reference's own reduced weights (``init(PRNGKey(0), cfg)``, moved across
with ``bridge.params_from_numpy``), in float32: yi-6b, then every other
dense, MoE and VLM config the port serves (``NEW_ARCHS``), whose norm
scales and biases and QKV biases are drawn at random (the reference
initialises them to ones and zeros, which would hide them).

Tolerances: logits 1e-4 and K/V 1e-5 absolute — both sides run the same
float32 algorithm; matmul and softmax summation orders differ, which
moves values by ~1e-6 at these widths.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

LOGITS = dict(rtol=1e-4, atol=1e-4)
KV = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    cfg = JR.get("yi-6b", reduced=True).config
    tcfg = TR.get("yi-6b", reduced=True).config
    jparams = JT.init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=shape
                                                ).astype(np.int32)


def test_bridge_converts_and_validates(model):
    cfg, tcfg, jparams, params = model
    assert params["blocks"]["attn"]["wq"].shape == (2, 128, 128)
    assert params["blocks"]["ffn"]["w_gate"].dtype == torch.float32
    tree = jax.tree.map(np.asarray, jparams)
    _close(params["embed"]["table"], tree["embed"]["table"],
           dict(rtol=0, atol=0))
    del tree["blocks"]["ffn"]["w_gate"]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(tree, tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tree["ln_f"]["scale"] = tree["ln_f"]["scale"][:64]
    with pytest.raises(ValueError, match="ln_f"):
        params_from_numpy(tree, tcfg, device="cpu")


def test_bridge_bf16_leaves():
    cfg = JR.get("yi-6b", reduced=True, dtype="bfloat16").config
    tcfg = TR.get("yi-6b", reduced=True, dtype="bfloat16").config
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(1), cfg))
    params = params_from_numpy(tree, tcfg, device="cpu")
    wq = params["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    _close(wq.float(), tree["blocks"]["attn"]["wq"].astype(np.float32),
           dict(rtol=0, atol=0))


@pytest.mark.parametrize("chunk", [None, 8])
def test_prefill_logits_and_kv(model, chunk):
    cfg, tcfg, jparams, params = model
    toks = _tokens(0, (2, 24))
    jl, jc = JT.prefill(jparams, cfg, jnp.asarray(toks), max_seq=40,
                        chunk=chunk)
    tl, tc = TT.prefill(params, tcfg, torch.from_numpy(toks), max_seq=40,
                        chunk=chunk)
    _close(tl, jl, LOGITS)
    _close(tc.k, jc.k, KV)
    _close(tc.v, jc.v, KV)
    _close(tc.lengths, jc.lengths, dict(rtol=0, atol=0))


def test_extend_step(model):
    cfg, tcfg, jparams, params = model
    toks = _tokens(1, (1, 20))
    _, jc = JT.prefill(jparams, cfg, jnp.asarray(toks[:, :12]), max_seq=32)
    _, tc = TT.prefill(params, tcfg, torch.from_numpy(toks[:, :12]),
                       max_seq=32)
    jl, jc = JT.extend_step(jparams, cfg, jnp.asarray(toks[:, 12:]), jc)
    tl, tc = TT.extend_step(params, tcfg, torch.from_numpy(toks[:, 12:]), tc)
    _close(tl, jl, LOGITS)
    _close(tc.k, jc.k, KV)
    assert int(tc.lengths[0]) == int(jc.lengths[0]) == 20


def _decode_inputs(seed, b=3, s=24):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((2, b, s, 4, 32)).astype(np.float32)
    v = rng.standard_normal((2, b, s, 4, 32)).astype(np.float32)
    return k, v, _tokens(seed, (b,))


@pytest.mark.parametrize("lengths", [[5, 0, 23], [30, 11, 2]])
def test_decode_step(model, lengths):
    """Ragged lengths, including a stale lane past the window (the
    reference clamps its write to position S-1)."""
    cfg, tcfg, jparams, params = model
    k, v, toks = _decode_inputs(2)
    ln = np.asarray(lengths, np.int32)
    jl, jc = JT.decode_step(jparams, cfg, jnp.asarray(toks),
                            JT.KVCache(jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(ln)))
    tl, tc = TT.decode_step(params, tcfg, torch.from_numpy(toks),
                            TT.KVCache(torch.from_numpy(k.copy()),
                                       torch.from_numpy(v.copy()),
                                       torch.from_numpy(ln)))
    _close(tl, jl, LOGITS)
    _close(tc.k, jc.k, KV)
    _close(tc.v, jc.v, KV)
    _close(tc.lengths, jc.lengths, dict(rtol=0, atol=0))


def _pools(seed, p=10, page=4):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((2, p + 1, page, 4, 32)).astype(np.float32)
    vp = rng.standard_normal((2, p + 1, page, 4, 32)).astype(np.float32)
    return kp, vp


def test_decode_step_paged(model):
    cfg, tcfg, jparams, params = model
    kp, vp = _pools(3)
    tables = np.asarray([[2, 7, 10], [0, 10, 10], [4, 5, 9]], np.int32)
    ln = np.asarray([6, 3, 11], np.int32)
    toks = _tokens(3, (3,))
    jl, (jk, jv, jln) = JT.decode_step_paged(
        jparams, cfg, jnp.asarray(toks), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ln))
    tl, (tk, tv, tln) = TT.decode_step_paged(
        params, tcfg, torch.from_numpy(toks), torch.from_numpy(kp.copy()),
        torch.from_numpy(vp.copy()), torch.from_numpy(tables),
        torch.from_numpy(ln))
    _close(tl, jl, LOGITS)
    _close(tk, jk, KV)
    _close(tv, jv, KV)
    _close(tln, jln, dict(rtol=0, atol=0))


def _paged_step(params, tcfg, kp, vp, tables, ln, toks):
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    TT.decode_step_paged(params, tcfg, torch.from_numpy(toks), kt, vt,
                         torch.from_numpy(tables), torch.from_numpy(ln))
    return kt.numpy(), vt.numpy()


def test_write_past_window_goes_to_scratch(model):
    """A position past the mapped window writes the scratch page P; it
    must not be clipped onto the window's last live page."""
    _, tcfg, _, params = model
    kp, vp = _pools(4)
    p = kp.shape[1] - 1
    tables = np.asarray([[3, 6]], np.int32)          # window of 8 tokens
    kt, vt = _paged_step(params, tcfg, kp, vp, tables,
                         np.asarray([8], np.int32), _tokens(4, (1,)))
    np.testing.assert_array_equal(kt[:, :p], kp[:, :p])
    np.testing.assert_array_equal(vt[:, :p], vp[:, :p])
    assert not np.array_equal(kt[:, p, 0], kp[:, p, 0])


def test_inactive_lane_never_writes_a_live_page(model):
    """An inactive lane (table row routed to scratch, as the engine does)
    writes only the scratch page; the active lane writes exactly its one
    position."""
    _, tcfg, _, params = model
    kp, vp = _pools(5)
    p = kp.shape[1] - 1
    tables = np.asarray([[1, 2, 9], [p, p, p]], np.int32)
    ln = np.asarray([5, 7], np.int32)   # lane 1 is inactive but "long"
    kt, vt = _paged_step(params, tcfg, kp, vp, tables, ln, _tokens(5, (2,)))
    changed = np.argwhere((kt != kp).any(axis=(0, 3, 4)))
    assert {tuple(c) for c in changed} == {(2, 1), (p, 3)}
    changed_v = np.argwhere((vt != vp).any(axis=(0, 3, 4)))
    assert {tuple(c) for c in changed_v} == {(2, 1), (p, 3)}


# ---------------------------------------------------------------------------
# The rest of the dense family, MoE and the VLM text backbone
# ---------------------------------------------------------------------------
NEW_ARCHS = ["stablelm-3b", "granite-3-8b", "qwen1.5-110b", "opt-66b",
             "llama3-70b", "qwen3-30b-a3b", "mixtral-8x22b", "dbrx-132b",
             "kimi-k2-1t-a32b", "qwen2-vl-7b"]
# leaves the reference initialises to constants: drawn at random here
_CONST_LEAVES = ("scale", "bias", "bq", "bk", "bv")


@functools.lru_cache(maxsize=None)
def _arch_model(arch, **over):
    cfg = JR.get(arch, reduced=True, **over).config
    tcfg = TR.get(arch, reduced=True, **over).config
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(len(arch))

    def perturb(path, leaf):
        if path[-1].key in _CONST_LEAVES:
            return (leaf + 0.1 * rng.standard_normal(leaf.shape)
                    ).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    return cfg, tcfg, jparams, params_from_numpy(tree, tcfg, device="cpu")


def test_new_arch_trees_bridge():
    """MoE trees (f32 router, 3-d expert weights, the shared expert) and
    QKV-bias trees convert; the blocks hold ``moe`` instead of ``ffn``."""
    _, _, _, kimi = _arch_model("kimi-k2-1t-a32b")
    moe = kimi["blocks"]["moe"]
    assert "ffn" not in kimi["blocks"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_up"].shape == (2, 8, 128, 128)
    assert moe["shared"]["w_gate"].shape == (2, 128, 128)
    _, _, _, vl = _arch_model("qwen2-vl-7b")
    assert vl["blocks"]["attn"]["bq"].shape == (2, 128)
    assert TT.init(TR.get("qwen3-30b-a3b", reduced=True).config,
                   device="meta")["blocks"]["moe"]["w_down"].shape == (
        2, 8, 128, 128)


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_prefill(arch, chunk):
    cfg, tcfg, jparams, params = _arch_model(arch)
    toks = _tokens(10, (2, 24))
    jl, jc = JT.prefill(jparams, cfg, jnp.asarray(toks), max_seq=40,
                        chunk=chunk)
    tl, tc = TT.prefill(params, tcfg, torch.from_numpy(toks), max_seq=40,
                        chunk=chunk)
    _close(tl, jl, LOGITS)
    _close(tc.k, jc.k, KV)
    _close(tc.v, jc.v, KV)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_extend_step(arch):
    cfg, tcfg, jparams, params = _arch_model(arch)
    toks = _tokens(11, (1, 20))
    _, jc = JT.prefill(jparams, cfg, jnp.asarray(toks[:, :12]), max_seq=32)
    _, tc = TT.prefill(params, tcfg, torch.from_numpy(toks[:, :12]),
                       max_seq=32)
    jl, jc = JT.extend_step(jparams, cfg, jnp.asarray(toks[:, 12:]), jc)
    tl, tc = TT.extend_step(params, tcfg, torch.from_numpy(toks[:, 12:]), tc)
    _close(tl, jl, LOGITS)
    _close(tc.k, jc.k, KV)
    _close(tc.v, jc.v, KV)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_decode_step(arch):
    cfg, tcfg, jparams, params = _arch_model(arch)
    k, v, toks = _decode_inputs(12)
    ln = np.asarray([5, 0, 23], np.int32)
    jl, jc = JT.decode_step(jparams, cfg, jnp.asarray(toks),
                            JT.KVCache(jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(ln)))
    tl, tc = TT.decode_step(params, tcfg, torch.from_numpy(toks),
                            TT.KVCache(torch.from_numpy(k.copy()),
                                       torch.from_numpy(v.copy()),
                                       torch.from_numpy(ln)))
    _close(tl, jl, LOGITS)
    _close(tc.k, jc.k, KV)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_decode_step_paged(arch):
    cfg, tcfg, jparams, params = _arch_model(arch)
    kp, vp = _pools(13)
    tables = np.asarray([[2, 7, 10], [0, 10, 10], [4, 5, 9]], np.int32)
    ln = np.asarray([6, 3, 11], np.int32)
    toks = _tokens(13, (3,))
    jl, (jk, jv, _) = JT.decode_step_paged(
        jparams, cfg, jnp.asarray(toks), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ln))
    tl, (tk, tv, _) = TT.decode_step_paged(
        params, tcfg, torch.from_numpy(toks), torch.from_numpy(kp.copy()),
        torch.from_numpy(vp.copy()), torch.from_numpy(tables),
        torch.from_numpy(ln))
    _close(tl, jl, LOGITS)
    _close(tk, jk, KV)
    _close(tv, jv, KV)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_decode_fused_paged(arch):
    """n_steps 4 with k_active 3, lane 2 inactive (routed to scratch):
    tokens, emit mask and lengths exact, pools within 1e-5."""
    cfg, tcfg, jparams, params = _arch_model(arch)
    kp, vp = _pools(14, p=9)
    p = kp.shape[1] - 1
    tables = np.asarray([[2, 7, 0], [4, 5, p], [p, p, p]], np.int32)
    ln = np.asarray([6, 3, 0], np.int32)
    alive = np.asarray([True, True, False])
    toks = _tokens(14, (3,))
    want = [np.asarray(x) for x in JT.decode_fused_paged(
        jparams, cfg, jnp.asarray(toks), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ln), jnp.asarray(alive),
        jnp.asarray(3, jnp.int32), 4)]
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = TT.decode_fused_paged(
        params, tcfg, torch.from_numpy(toks), kt, vt,
        torch.from_numpy(tables), torch.from_numpy(ln),
        torch.from_numpy(alive), torch.tensor(3, dtype=torch.int32), 4)
    for i in (0, 1, 4):
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    _close(kt, want[2], KV)
    _close(vt, want[3], KV)


@pytest.mark.parametrize("chunk", [None, 8])
def test_vlm_prefill_embeds(chunk):
    """Precomputed patch embeddings (the frontend stub) in place of
    tokens; such a prompt is never chunked, as in the reference."""
    cfg, tcfg, jparams, params = _arch_model("qwen2-vl-7b")
    emb = np.random.default_rng(15).standard_normal(
        (2, 24, 128)).astype(np.float32)
    jl, jc = JT.prefill(jparams, cfg, None, embeds=jnp.asarray(emb),
                        max_seq=40, chunk=chunk)
    tl, tc = TT.prefill(params, tcfg, None, embeds=torch.from_numpy(emb),
                        max_seq=40, chunk=chunk)
    _close(tl, jl, LOGITS)
    _close(tc.k, jc.k, KV)
    _close(tc.lengths, jc.lengths, dict(rtol=0, atol=0))


def test_mrope_forward_seq_three_streams():
    """Three distinct M-RoPE position streams.  The reduced head dim (32)
    cuts the published sections (16, 24, 24) to section 0 alone, so the
    sections here are (4, 6, 6): all three streams in use (the published
    sections at D = 128 are held in ``test_torch_layers.py``)."""
    cfg, tcfg, jparams, params = _arch_model("qwen2-vl-7b",
                                             mrope_sections=(4, 6, 6))
    rng = np.random.default_rng(16)
    toks = _tokens(16, (2, 12))
    pos = rng.integers(0, 300, size=(2, 12, 3)).astype(np.int32)
    jh, (jk, _) = JT.forward_seq(jparams, cfg, jnp.asarray(toks),
                                 positions=jnp.asarray(pos),
                                 collect_cache=True, remat=False)
    th, (tk, _) = TT.forward_seq(params, tcfg, torch.from_numpy(toks),
                                 positions=torch.from_numpy(pos),
                                 collect_cache=True)
    _close(th, jh, LOGITS)
    _close(tk, jk, KV)
    # the streams matter: one stream repeated gives other keys
    _, (k1, _) = TT.forward_seq(params, tcfg, torch.from_numpy(toks),
                                positions=torch.from_numpy(pos[..., :1]
                                                           .repeat(3, -1)),
                                collect_cache=True)
    assert (k1 - tk).abs().max() > 1e-3
