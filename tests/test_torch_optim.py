"""The port's AdamW (``repro_torch.optim.adamw``) and data pipeline
(``repro_torch.data.pipeline``) against the reference's on the same
inputs: the schedule, clipping, int8 error-feedback compression and the
update on the same gradients and state (atol 1e-6: the same float32
arithmetic, reductions summed in other orders), and the batches bitwise
for every (seed, step, shard, num_shards) tried.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as JP  # noqa: E402
from repro.optim import adamw as jaxw  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.optim import adamw as taxw  # noqa: E402

ATOL = 1e-6


def _tree(seed, scale=1.0):
    """A small nested tree of float32 leaves, one of them stacked and
    one 0-d."""
    rng = np.random.default_rng(seed)
    return {"embed": {"table": rng.standard_normal((16, 8)) * scale},
            "blocks": {"w": rng.standard_normal((3, 8, 4)) * scale,
                       "b": rng.standard_normal((3, 4)) * scale},
            "gain": np.asarray(rng.standard_normal() * scale)}


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, atol=ATOL):
    for g, w in zip(jax.tree.leaves(jax.tree.map(
            lambda t: t.numpy(), got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol)


@pytest.mark.parametrize("step", [0, 1, 5, 19, 20, 21, 57, 99, 100, 150])
def test_schedule_matches_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=20, total_steps=100)
    want = jaxw.schedule(jnp.int32(step), jaxw.AdamWConfig(**cfg))
    got = taxw.schedule(torch.tensor(step, dtype=torch.int32),
                        taxw.AdamWConfig(**cfg))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _f32(_tree(1))
    jg, jn = jaxw.clip_by_global_norm(g, max_norm)
    tg, tn = taxw.clip_by_global_norm(_torch(g), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    _close(tg, jg)


def test_ef_compress_grads_matches_reference():
    g, e = _f32(_tree(2)), _f32(_tree(3, scale=0.01))
    jg, je = jaxw.ef_compress_grads(g, e)
    tg, te = taxw.ef_compress_grads(_torch(g), _torch(e))
    _close(tg, jg)
    _close(te, je)
    q, s = taxw.compress_int8(torch.tensor([0.5, -1.5, 2.5, 127.0]))
    assert q.tolist() == [0, -2, 2, 127]      # halves round to even


@pytest.mark.parametrize("compress", [False, True])
def test_update_matches_reference(compress):
    """Three updates from the same parameters, gradients and state; the
    port writes its parameters and moments in place."""
    ocfg = dict(warmup_steps=2, total_steps=10, lr=1e-2,
                compress_grads=compress)
    jcfg, tcfg = jaxw.AdamWConfig(**ocfg), taxw.AdamWConfig(**ocfg)
    jp = _f32(_tree(4))
    tp = _torch(jp)
    table = tp["embed"]["table"]
    js, ts = jaxw.init(jp, jcfg), taxw.init(tp, tcfg)
    for i in range(3):
        g = _f32(_tree(10 + i, scale=0.5))
        jp, js, jm = jaxw.update(g, js, jp, jcfg)
        tp, ts, tm = taxw.update(_torch(g), ts, tp, tcfg)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        _close(tp, jp)
        _close(ts.mu, js.mu)
        _close(ts.nu, js.nu)
        if compress:
            _close(ts.ef, js.ef)
        else:
            assert ts.ef is None and js.ef is None
        assert int(ts.step) == int(js.step) == i + 1
    assert tp["embed"]["table"] is table            # updated in place


def test_update_in_slices_changes_no_value(monkeypatch):
    """Slicing the layer axis (the full-width memory bound) gives the
    values of the whole-leaf update exactly."""
    ocfg = taxw.AdamWConfig(warmup_steps=1, lr=1e-2)
    g = _torch(_f32(_tree(6)))
    outs = []
    for slice_elems in (taxw._SLICE, 8):
        monkeypatch.setattr(taxw, "_SLICE", slice_elems)
        p = _torch(_f32(_tree(5)))
        s = taxw.init(p, ocfg)
        for _ in range(2):
            p, s, m = taxw.update(g, s, p, ocfg)
        outs.append((p, s, m))
    (p1, s1, m1), (p2, s2, m2) = outs
    for a, b in zip(taxw.tree_leaves(p1) + taxw.tree_leaves(s1.nu),
                    taxw.tree_leaves(p2) + taxw.tree_leaves(s2.nu)):
        assert torch.equal(a, b)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=1e-6)


def test_bf16_leaves_update_in_float32_and_cast_back():
    ocfg = taxw.AdamWConfig(warmup_steps=1, lr=1e-2)
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    s = taxw.init(p, ocfg)
    g = {"w": torch.full((4, 4), 0.25, dtype=torch.bfloat16)}
    p, s, _ = taxw.update(g, s, p, ocfg)
    assert p["w"].dtype == torch.bfloat16
    assert s.mu["w"].dtype == torch.float32
    assert float(p["w"][0, 0]) < 1.0


@pytest.mark.parametrize("seed,step,shard,num_shards",
                         [(0, 0, 0, 1), (0, 5, 2, 4), (3, 17, 1, 2),
                          (7, 1000, 3, 4), (1, 2, 0, 8)])
def test_pipeline_bitwise(seed, step, shard, num_shards):
    kw = dict(vocab=1000, seq_len=16, global_batch=8, seed=seed)
    want = JP.TokenPipeline(JP.DataConfig(**kw), shard=shard,
                            num_shards=num_shards).batch_at(step)
    got = TP.TokenPipeline(TP.DataConfig(**kw), shard=shard,
                           num_shards=num_shards).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_data_pipeline_shard_determinism():
    """Mirror of the reference's test: shard batches are deterministic
    and distinct; the iterator walks the steps."""
    cfg = TP.DataConfig(vocab=1000, seq_len=16, global_batch=8)
    shards = [TP.TokenPipeline(cfg, shard=i, num_shards=4).batch_at(5)
              for i in range(4)]
    assert not np.array_equal(shards[0]["tokens"], shards[1]["tokens"])
    again = TP.TokenPipeline(cfg, shard=2, num_shards=4).batch_at(5)
    np.testing.assert_array_equal(shards[2]["tokens"], again["tokens"])
    it = iter(TP.TokenPipeline(cfg))
    next(it)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  TP.TokenPipeline(cfg).batch_at(1)["tokens"])
    with pytest.raises(ValueError, match="shards"):
        TP.TokenPipeline(cfg, num_shards=3)
