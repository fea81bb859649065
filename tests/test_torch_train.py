"""The port's training path against the reference's, on the reference's
own reduced weights (``init(PRNGKey(0), cfg)``, moved across with
``bridge.params_from_numpy``) and numpy batches from a seed, in
float32: each family's ``loss`` and its gradients against
``jax.grad``, ``lm_loss_chunked``, the windowed attention's backward,
a 5-step loss curve of ``launch.steps.make_train_step`` against the
jitted reference step, and port mirrors of the reference's trainer
tests (``tests/test_train_serve.py``).

Tolerances: losses 1e-5 relative; gradients rtol 1e-4 with an atol of
1e-6 x max|g| per leaf (both sides run the same float32 algorithm,
summed in other orders); loss curves 1e-4 relative.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402,E501
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim import adamw as jaxw  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as taxw  # noqa: E402

ARCHS = ["yi-6b", "qwen3-30b-a3b", "qwen2-vl-7b", "rwkv6-7b",
         "recurrentgemma-9b", "whisper-small"]
LOSS_RTOL = 1e-5
CURVE_RTOL = 1e-4


def _bridge(arch):
    jentry = JR.get(arch, reduced=True)
    tentry = TR.get(arch, reduced=True)
    jparams = jentry.module.init(jax.random.PRNGKey(0), jentry.config)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                tentry.config, device="cpu")
    return jentry, tentry, jparams, tparams


def _batch(cfg, seed=0, b=2, s=32):
    """Tokens, labels and a ragged mask; the VLM's one-hot embeds in place
    of tokens; the audio family's random frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    if cfg.family == "vlm":
        batch["embeds"] = np.eye(cfg.d_model, dtype=np.float32)[
            batch.pop("tokens") % cfg.d_model]
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _loss_and_grads(arch):
    """Both packages' step-0 loss and gradients (as numpy leaves in
    ``jax.tree.leaves`` order) on one batch; recurrentgemma's sequence
    is longer than its window of 64."""
    jentry, tentry, jparams, tparams = _bridge(arch)
    cfg = jentry.config
    batch = _batch(cfg, s=96 if arch == "recurrentgemma-9b" else 32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jentry.module.loss(p, cfg, b)))(jparams, batch)
    view = taxw.tree_map(lambda t: t.detach().requires_grad_(), tparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl = tentry.module.loss(view, tentry.config, tb)
    tg = torch.autograd.grad(tl, taxw.tree_leaves(view), allow_unused=True,
                             materialize_grads=True)
    return (float(jl), [np.asarray(g) for g in jax.tree.leaves(jg)],
            float(tl.detach()), [g.numpy() for g in tg])


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_loss_matches_reference(arch):
    jl, _, tl, _ = _loss_and_grads(arch)
    assert np.isfinite(tl)
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    _, jg, _, tg = _loss_and_grads(arch)
    assert len(jg) == len(tg)
    for want, got in zip(jg, tg):
        assert got.shape == want.shape
        assert not np.isnan(got).any()
        np.testing.assert_allclose(
            got, want, rtol=1e-4, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("window", [0, 24])
def test_blocked_attention_backward_matches_reference(window):
    """Small tiles, so with a window whole rows of a tile are masked (the
    -inf guards' backward must give no NaN)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
               for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    dy = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=True, window=window, q_block=16, kv_block=16)

    def jfn(q, k, v):
        return jnp.sum(JL.blocked_attention(q, k, v, **kw) * dy)

    jg = jax.grad(jfn, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TL.blocked_attention(tq, tk, tv, **kw)
    tg = torch.autograd.grad((out * torch.from_numpy(dy)).sum(),
                             (tq, tk, tv))
    for want, got in zip(jg, tg):
        assert not torch.isnan(got).any()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_chunked_matches_reference(masked):
    """Four chunks of 8 over an untied head, with and without a mask."""
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, 32, 16)).astype(np.float32)
    p = {"table": rng.standard_normal((64, 16)).astype(np.float32),
         "head": rng.standard_normal((16, 64)).astype(np.float32) * 0.1}
    labels = rng.integers(0, 64, (2, 32)).astype(np.int32)
    mask = (rng.random((2, 32)) > 0.3).astype(np.float32) if masked \
        else None

    def jfn(h, head):
        return JL.lm_loss_chunked({"table": p["table"], "head": head}, h,
                                  labels, mask, chunk=8)

    jl, jg = jax.value_and_grad(jfn, argnums=(0, 1))(h, p["head"])
    th = torch.from_numpy(h).requires_grad_()
    thead = torch.from_numpy(p["head"]).requires_grad_()
    tl = TL.lm_loss_chunked(
        {"table": torch.from_numpy(p["table"]), "head": thead}, th,
        torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), chunk=8)
    tg = torch.autograd.grad(tl, (th, thead))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    for want, got in zip(jg, tg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-7)
    with pytest.raises(ValueError, match="multiple"):
        TL.lm_loss_chunked({"table": torch.zeros(64, 16)},
                           torch.zeros(1, 12, 16),
                           torch.zeros(1, 12, dtype=torch.int32), chunk=8)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
CURVE_OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def _reference_curve(microbatch):
    jentry, _, jparams, _ = _bridge("yi-6b")
    ocfg = jaxw.AdamWConfig(**CURVE_OCFG)
    step = jax.jit(j_make_train_step(jentry, ocfg, 1,
                                     make_mesh((1, 1), ("data", "model")),
                                     microbatch=microbatch))
    data = TokenPipeline(DataConfig(vocab=jentry.config.vocab, seq_len=32,
                                    global_batch=4))
    params, opt, out = jparams, jaxw.init(jparams, ocfg), []
    for i in range(5):
        batch = {k: v for k, v in data.batch_at(i).items() if k != "mask"}
        params, opt, m = step(params, opt, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_curve_matches_reference(microbatch):
    _, tentry, _, tparams = _bridge("yi-6b")
    ocfg = taxw.AdamWConfig(**CURVE_OCFG)
    step = TS.make_train_step(tentry, ocfg, microbatch=microbatch)
    data = TokenPipeline(DataConfig(vocab=tentry.config.vocab, seq_len=32,
                                    global_batch=4))
    params, opt = tparams, taxw.init(tparams, ocfg)
    for i, (jloss, jnorm) in enumerate(_reference_curve(microbatch)):
        batch = {k: v for k, v in data.batch_at(i).items() if k != "mask"}
        params, opt, m = step(params, opt, batch)
        assert float(m["loss"]) == pytest.approx(jloss, rel=CURVE_RTOL), i
        assert float(m["grad_norm"]) == pytest.approx(jnorm, rel=1e-3), i
    assert int(opt.step) == 5


def test_bf16_train_step_curve_matches_reference():
    """The bf16 path the full-width run takes (weights, activations and
    gradients in bf16; AdamW in float32, cast back): reduced stablelm-3b
    in bfloat16, 5 steps from the same weights, losses within 1e-3 and
    gradient norms within 1e-2 (bf16 rounds each side's products and
    updates on its own)."""
    jentry = JR.get("stablelm-3b", reduced=True, dtype="bfloat16")
    tentry = TR.get("stablelm-3b", reduced=True, dtype="bfloat16")
    jparams = jentry.module.init(jax.random.PRNGKey(0), jentry.config)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                tentry.config, device="cpu")
    assert tparams["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    kw = dict(total_steps=10, warmup_steps=4)
    jcfg, tcfg = jaxw.AdamWConfig(**kw), taxw.AdamWConfig(**kw)
    jstep = jax.jit(j_make_train_step(jentry, jcfg, 1,
                                      make_mesh((1, 1), ("data", "model"))))
    tstep = TS.make_train_step(tentry, tcfg)
    jopt, topt = jaxw.init(jparams, jcfg), taxw.init(tparams, tcfg)
    data = TokenPipeline(DataConfig(vocab=tentry.config.vocab, seq_len=32,
                                    global_batch=4))
    for i in range(5):
        batch = {k: v for k, v in data.batch_at(i).items() if k != "mask"}
        jparams, jopt, jm = jstep(jparams, jopt, batch)
        tparams, topt, tm = tstep(tparams, topt, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-3), i
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-2), i
    assert tparams["blocks"]["attn"]["wq"].dtype == torch.bfloat16


def test_microbatched_step_matches_full_batch():
    """Gradient accumulation gives (numerically) the same update (mirror
    of the reference's test)."""
    entry = TR.get("yi-6b", reduced=True)
    ocfg = taxw.AdamWConfig()
    data = TokenPipeline(DataConfig(vocab=entry.config.vocab, seq_len=32,
                                    global_batch=4))
    batch = {k: v for k, v in data.batch_at(0).items() if k != "mask"}
    out = []
    for mb in (1, 2):
        params = entry.module.init(entry.config, device="cpu", seed=0)
        opt = taxw.init(params, ocfg)
        _, _, m = TS.make_train_step(entry, ocfg, microbatch=mb)(
            params, opt, batch)
        out.append(m)
    assert float(out[0]["loss"]) == pytest.approx(float(out[1]["loss"]),
                                                  rel=1e-5)
    assert float(out[0]["grad_norm"]) == pytest.approx(
        float(out[1]["grad_norm"]), rel=1e-3)
    with pytest.raises(ValueError, match="microbatches"):
        TS.make_train_step(entry, ocfg, microbatch=3)(params, opt, batch)


def test_failed_step_changes_nothing():
    """A step whose loss raises leaves the parameters and the optimizer
    state untouched, so the trainer's retry starts from the same
    point."""
    entry = TR.get("yi-6b", reduced=True)
    params = entry.module.init(entry.config, device="cpu", seed=0)
    ocfg = taxw.AdamWConfig()
    opt = taxw.init(params, ocfg)
    before = [t.clone() for t in taxw.tree_leaves(params)]
    toks = np.zeros((2, 32), np.int32)
    bad = {"tokens": toks, "labels": toks + 10 * entry.config.vocab}
    with pytest.raises((RuntimeError, IndexError)):
        TS.make_train_step(entry, ocfg)(params, opt, bad)
    for a, b in zip(before, taxw.tree_leaves(params)):
        assert torch.equal(a, b)
    assert int(opt.step) == 0
    assert all(float(t.abs().max()) == 0.0
               for t in taxw.tree_leaves(opt.mu))


# ---------------------------------------------------------------------------
# The trainer (mirrors of tests/test_train_serve.py)
# ---------------------------------------------------------------------------
def test_train_loss_decreases(tmp_path):
    out = TT.train("yi-6b", steps=14, global_batch=4, seq=64,
                   ckpt_dir=str(tmp_path), save_every=6, log_every=100,
                   device="cpu")
    assert out["steps"] == 14
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] < out["first_loss"]
    # saves at 6 and 12 and the final 14; keep=3 retains all three
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000006", "step_0000000012", "step_0000000014"]


def test_train_resume_is_exact(tmp_path):
    """Crash/restart replays to the same loss as an uninterrupted run
    (atomic checkpoints + shard-deterministic data)."""
    kw = dict(steps=10, global_batch=2, seq=32, log_every=100, seed=3,
              device="cpu")
    a = TT.train("stablelm-3b", ckpt_dir=None, **kw)
    TT.train("stablelm-3b", stop_step=6, ckpt_dir=str(tmp_path),
             save_every=6, **kw)
    b = TT.train("stablelm-3b", ckpt_dir=str(tmp_path), save_every=100,
                 **kw)
    assert b["steps"] == 4
    assert b["final_loss"] == pytest.approx(a["final_loss"], rel=1e-4)


def test_grad_compression_trains():
    out = TT.train("yi-6b", steps=8, global_batch=2, seq=32, ckpt_dir=None,
                   compress_grads=True, log_every=100, device="cpu")
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] < out["first_loss"] + 0.5


def test_train_retries_transient_failures(monkeypatch):
    """Bounded retry: a step that fails transiently is retried and the
    run completes."""
    state = {"fails_left": 2}
    real = TT.make_train_step

    def flaky(*a, **k):
        step = real(*a, **k)

        def wrapper(*args):
            if state["fails_left"] > 0:
                state["fails_left"] -= 1
                raise RuntimeError("injected transient failure")
            return step(*args)
        return wrapper

    monkeypatch.setattr(TT, "make_train_step", flaky)
    out = TT.train("yi-6b", steps=4, global_batch=2, seq=32, ckpt_dir=None,
                   log_every=100, max_retries=3, device="cpu")
    assert out["steps"] == 4
    assert state["fails_left"] == 0
    assert np.isfinite(out["final_loss"])


@pytest.mark.parametrize("arch", ["qwen3-30b-a3b", "qwen2-vl-7b",
                                  "rwkv6-7b", "recurrentgemma-9b",
                                  "whisper-small"])
def test_trainer_trains_every_family(arch):
    out = TT.train(arch, steps=4, global_batch=2, seq=32, ckpt_dir=None,
                   log_every=100, device="cpu")
    assert out["steps"] == 4 and len(out["step_s"]) == 4
    assert all(np.isfinite(out["losses"]))


def test_trainer_refuses_a_mesh():
    with pytest.raises(ValueError, match="item 10"):
        TT.train("yi-6b", steps=1, global_batch=2, seq=32, ckpt_dir=None,
                 mesh_shape=(2, 1), device="cpu")
