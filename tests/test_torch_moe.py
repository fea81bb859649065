"""The port's MoE layer against ``repro.models.layers`` (single device).

Every case feeds the same numpy inputs (seeded) and the reference's own
``init_moe`` weights to both packages, in float32, at the reduced MoE
configs (qwen3, mixtral, dbrx, and kimi with its shared expert).
Tolerance 1e-5: both sides run the same float32 operations; matmul
summation orders differ.  Routing must agree exactly (ranks, drops), so
the comparisons of ranks and capacities are exact.

The ``cuda``-marked test holds the layer on the card to its CPU result,
eagerly and replayed from a CUDA graph (the fused tick captures it).
"""
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.bridge import _to_tensor  # noqa: E402

MOE = dict(rtol=1e-5, atol=1e-5)
MOE_ARCHS = ["qwen3-30b-a3b", "mixtral-8x22b", "dbrx-132b",
             "kimi-k2-1t-a32b"]


def _configs(arch):
    return (JR.get(arch, reduced=True).config,
            TR.get(arch, reduced=True).config)


def _weights(arch, seed=0):
    """The reference's init_moe weights as (jax tree, torch tree)."""
    jcfg, _ = _configs(arch)
    jp = JL.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return jp, jax.tree.map(lambda a: _to_tensor(a, "cpu"), tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               **tol)


@pytest.mark.parametrize("tokens", [1, 4, 7, 16, 128, 1000])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_capacity(arch, tokens):
    cfg = TR.get_config(arch)
    e, k, f = cfg.num_experts, cfg.topk, cfg.capacity_factor
    got = TL.moe_capacity(tokens, e, k, f)
    assert got == JL.moe_capacity(tokens, e, k, f)
    assert got % 16 == 0 and got >= math.ceil(tokens * k / e * f)


@pytest.mark.parametrize("n,e", [(1, 4), (16, 4), (200, 8), (1024, 128),
                                 (96, 384)])
def test_local_ranks(n, e):
    flat = np.random.default_rng(n + e).integers(0, e, size=n)
    got = TL._local_ranks(torch.from_numpy(flat), n, e)
    want = np.asarray(JL._local_ranks(jnp.asarray(flat, jnp.int32), n, e))
    np.testing.assert_array_equal(got.numpy(), want)
    # ranks are 0..count-1 within each expert, in flat order
    for x in range(e):
        np.testing.assert_array_equal(got.numpy()[flat == x],
                                      np.arange((flat == x).sum()))


def _dropped(pt, cfg, x):
    """Pairs past capacity in the port's routing of ``x``."""
    t = x.shape[0]
    probs = torch.softmax(x.float() @ pt["router"], -1)
    experts = torch.topk(probs, cfg.topk, -1).indices.reshape(-1)
    rank = TL._local_ranks(experts, t * cfg.topk, cfg.num_experts)
    c = TL.moe_capacity(t, cfg.num_experts, cfg.topk, cfg.capacity_factor)
    return int((rank >= c).sum())


@pytest.mark.parametrize("tokens", [1, 6, 64])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe(arch, tokens):
    jcfg, tcfg = _configs(arch)
    jp, pt = _weights(arch)
    assert ("shared" in pt) == (arch == "kimi-k2-1t-a32b")
    assert pt["router"].dtype == torch.float32
    assert pt["w_up"].shape == (8, 128, 128)
    x = np.random.default_rng(tokens).standard_normal(
        (tokens, 128)).astype(np.float32)
    got = TL.apply_moe(pt, torch.from_numpy(x), tcfg)
    _close(got, JL.apply_moe(jp, jnp.asarray(x), jcfg), MOE)
    assert _dropped(pt, tcfg, torch.from_numpy(x)) == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_drops_at_capacity(arch):
    """A router skewed so every token picks the same top-k experts: each
    of them receives all T pairs against a capacity of C < T, so pairs
    are dropped, and the outputs still match the reference's."""
    jcfg, tcfg = _configs(arch)
    _, pt = _weights(arch, seed=1)
    rng = np.random.default_rng(7)
    u = rng.standard_normal(128).astype(np.float32)
    u /= np.linalg.norm(u)
    router = pt["router"].numpy().copy()
    router[:, :tcfg.topk] += 4.0 * u[:, None]
    tree = jax.tree.map(lambda t: t.numpy(), pt)
    tree["router"] = router
    jp = jax.tree.map(jnp.asarray, tree)
    pt = jax.tree.map(lambda a: _to_tensor(a, "cpu"), tree)
    t = 64
    x = (rng.standard_normal((t, 128)) * 0.1 + 3.0 * u).astype(np.float32)
    c = TL.moe_capacity(t, tcfg.num_experts, tcfg.topk,
                        tcfg.capacity_factor)
    assert c < t
    assert _dropped(pt, tcfg, torch.from_numpy(x)) == tcfg.topk * (t - c)
    got = TL.apply_moe(pt, torch.from_numpy(x), tcfg)
    _close(got, JL.apply_moe(jp, jnp.asarray(x), jcfg), MOE)
    # the tokens past capacity get nothing from the routed experts
    if "shared" not in pt:
        assert not got[c:].any() and got[:c].abs().sum() > 0


def test_init_moe_shapes_and_distributions():
    _, tcfg = _configs("kimi-k2-1t-a32b")
    gen = torch.Generator().manual_seed(0)
    p = TL.init_moe(gen, tcfg, torch.float32, lead=(2,))
    jp = JL.init_moe(jax.random.PRNGKey(0), JR.get(
        "kimi-k2-1t-a32b", reduced=True).config, jnp.float32)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in path]
        got = p
        for k in keys:
            got = got[k]
        assert tuple(got.shape) == (2, *leaf.shape), keys
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got.std()), float(np.std(leaf)),
                                   rtol=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cuda_moe_matches_cpu_and_captures(arch):
    """On the card: the CPU's result (TF32 off), drops included, and a
    CUDA graph of the layer replays to the eager result on new inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tcfg = _configs(arch)
    _, pt = _weights(arch)
    pc = jax.tree.map(lambda t: t.cuda(), pt)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    _close(TL.apply_moe(pc, x.cuda(), tcfg), TL.apply_moe(pt, x, tcfg), MOE)
    xs = x.cuda()
    TL.apply_moe(pc, xs, tcfg)                    # warm-up before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = TL.apply_moe(pc, xs, tcfg)
    x2 = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    xs.copy_(x2.cuda())
    graph.replay()
    torch.cuda.synchronize()
    _close(out, TL.apply_moe(pt, x2, tcfg), MOE)
