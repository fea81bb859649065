"""The port's RWKV6 against ``repro.models.rwkv6`` on the reference's own
reduced rwkv6-7b weights (``init(PRNGKey(0), cfg)``, moved across with
``bridge.params_from_numpy``), in float32.

Tolerance 1e-4 absolute on logits, hidden states and every state leaf:
both sides run the same float32 algorithm, but the port runs each layer
over the whole sequence ((B*T, d) products, one recurrence call) where
the reference scans token by token, so sums are taken in another order;
the largest difference seen at these widths is ~1e-6.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import registry as JR  # noqa: E402
from repro.models import rwkv6 as JW  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import rwkv6 as TW  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = JR.get("rwkv6-7b", reduced=True).config
    tcfg = TR.get("rwkv6-7b", reduced=True).config
    jparams = JW.init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def _close_state(jstate, tstate):
    for name, a, b in zip(JW.RWKVState._fields, jstate, tstate):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **TOL)


def test_config_is_the_reference_config():
    jc, tc = JR.get_config("rwkv6-7b"), TR.get_config("rwkv6-7b")
    assert {f: getattr(tc, f) for f in tc.__dataclass_fields__} == \
        {f: getattr(jc, f) for f in tc.__dataclass_fields__}


def test_init_builds_the_reference_tree(model):
    jcfg, tcfg, jparams, _ = model
    ours = TW.init(tcfg, device="cpu", seed=3)
    ref_tree = jax.tree.map(np.asarray, jparams)
    flat_j = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = {jax.tree_util.keystr(p): (a.shape, str(a.dtype))
           for p, a in flat_j}
    flat_t = jax.tree_util.tree_flatten_with_path(ours)[0]
    want = {jax.tree_util.keystr(p): (tuple(t.shape),
                                      str(t.dtype).replace("torch.", ""))
            for p, t in flat_t}
    assert got == want
    mu = ours["blocks"]["mix"]["mu"]
    assert 0.25 <= float(mu.min()) and float(mu.max()) < 0.75


@pytest.mark.parametrize("carry", [False, True])
def test_forward_seq_matches_reference(model, carry):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(2, 9)
    jstate = tstate = None
    if carry:   # continue from the state a first segment left
        first = _tokens(2, 5, seed=1)
        _, jstate = JW.forward_seq(jparams, jcfg, jnp.asarray(first))
        _, tstate = TW.forward_seq(tparams, tcfg, torch.from_numpy(first))
    jh, js = JW.forward_seq(jparams, jcfg, jnp.asarray(toks), state=jstate)
    th, ts = TW.forward_seq(tparams, tcfg, torch.from_numpy(toks),
                            state=tstate)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    _close_state(js, ts)


def test_prefill_and_decode_chain_match_reference(model):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(3, 7, seed=2)
    jl, js = JW.prefill(jparams, jcfg, jnp.asarray(toks))
    tl, ts = TW.prefill(tparams, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_state(js, ts)
    nxt = _tokens(4, 3, seed=3)
    for step in range(4):
        jl, js = JW.decode_step(jparams, jcfg, jnp.asarray(nxt[step]), js)
        tl, ts = TW.decode_step(tparams, tcfg, torch.from_numpy(nxt[step]),
                                ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {step}", **TOL)
    _close_state(js, ts)


def test_layer_parallel_prefill_equals_token_by_token_decode(model):
    _, tcfg, _, tparams = model
    toks = torch.from_numpy(_tokens(2, 11, seed=4))
    logits, state = TW.prefill(tparams, tcfg, toks)
    step_state = TW.RWKVState.zeros(tcfg, 2, device="cpu")
    for t in range(toks.shape[1]):
        step_logits, step_state = TW.decode_step(tparams, tcfg, toks[:, t],
                                                 step_state)
    torch.testing.assert_close(step_logits, logits, **TOL)
    for name, a, b in zip(TW.RWKVState._fields, state, step_state):
        torch.testing.assert_close(b, a, msg=name, **TOL)


def test_every_layer_runs_the_recurrence_hook(model):
    _, tcfg, _, tparams = model
    shapes = []

    def hook(r, k, v, w, u, s0, s_out):
        shapes.append(tuple(r.shape))
        assert r.dtype == k.dtype == v.dtype == w.dtype == torch.float32
        assert s_out is s0            # the layer's state, advanced in place
        return ref.wkv6_ref(r, k, v, w, u, s0, s_out)

    toks = torch.from_numpy(_tokens(2, 6, seed=5))
    want, _ = TW.prefill(tparams, tcfg, toks)
    got, state = TW.prefill(tparams, tcfg, toks, wkv_fn=hook)
    TW.decode_step(tparams, tcfg, toks[:, 0], state, wkv_fn=hook)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    heads = tcfg.d_model // tcfg.rwkv_head_size
    n = tcfg.num_layers
    assert shapes == [(2, 6, heads, 32)] * n + [(2, 1, heads, 32)] * n


def test_bridge_rejects_mismatched_trees(model):
    jcfg, tcfg, jparams, _ = model
    tree = jax.tree.map(np.asarray, jparams)
    missing = dict(tree, blocks={k: v for k, v in tree["blocks"].items()
                                 if k != "u_bonus"})
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(missing, tcfg, device="cpu")
    wide = jax.tree.map(np.asarray, JW.init(
        jax.random.PRNGKey(0), jcfg.reduced(d_model=256)))
    with pytest.raises(ValueError):
        params_from_numpy(wide, tcfg, device="cpu")
    dense = jax.tree.map(np.asarray, JT.init(
        jax.random.PRNGKey(0), JR.get("yi-6b", reduced=True).config))
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(dense, tcfg, device="cpu")
