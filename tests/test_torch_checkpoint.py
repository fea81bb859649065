"""The port's checkpoints (``repro_torch.checkpoint.manager``) against the
reference's (``repro.checkpoint.manager``): the same directory layout,
manifest and leaf keys, so each package restores the other's
checkpoints and trains on from them.

A run stopped at step 3 of 6 by one package and resumed by the other
must end at the loss of an uninterrupted 6-step run of the package that
stopped (1e-4 relative: both train the same float32 steps, summed in
other orders).  The reference's own ``restore`` cannot cast a bfloat16
file (``np.load`` gives raw ``|V2`` items), so bfloat16 goes one way:
a reference-written bf16 leaf restores in the port bit for bit.
"""
import json
import os
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JM  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager as TM  # noqa: E402,E501
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim import adamw as taxw  # noqa: E402

RUN = dict(steps=6, global_batch=2, seq=32, log_every=100, seed=0)


def _like(arch="yi-6b"):
    entry = TR.get(arch, reduced=True)
    params = entry.module.init(entry.config, device="cpu", seed=1)
    return {"params": params,
            "opt": taxw.init(params, taxw.AdamWConfig())}


def _leaves_by_key(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        man = json.load(f)
    return {k: np.load(os.path.join(step_dir, v["file"]))
            for k, v in man["leaves"].items()}, man


def test_reference_checkpoint_restores_and_trains_on_in_port(tmp_path):
    """The reference stops at step 3, and its manager writes that step
    again with one bf16 leaf beside the float32 tree; the port restores
    it (same keys, same values, the bf16 leaf bit for bit) and trains
    steps 3-5 to the reference's uninterrupted loss."""
    full = JT.train("yi-6b", ckpt_dir=None, **RUN)
    JT.train("yi-6b", ckpt_dir=str(tmp_path), stop_step=3, **RUN)
    entry = JT.registry.get("yi-6b", reduced=True)

    def jlike():
        params = entry.module.init(jax.random.PRNGKey(0), entry.config)
        return {"params": params,
                "opt": JT.axw.init(params, JT.axw.AdamWConfig())}

    mgr = JM(str(tmp_path))
    jtree, jextra = mgr.restore(3, jax.eval_shape(jlike))
    ema = jnp.asarray(np.random.default_rng(0).standard_normal((4, 8)),
                      jnp.bfloat16)
    mgr.save(3, dict(jtree, ema=ema), extra=jextra)
    files, man = _leaves_by_key(tmp_path / "step_0000000003")
    assert man["leaves"]["ema"]["dtype"] == "bfloat16"
    like = dict(_like(), ema=torch.zeros((4, 8), dtype=torch.bfloat16))
    tree, extra = TM(str(tmp_path)).restore(3, like, device="cpu")
    flat = {"/".join(p): t for p, t in _walk(tree)}
    assert sorted(flat) == sorted(files)
    assert extra["next_step"] == 3
    for key, arr in files.items():
        if key == "ema":
            assert flat[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(flat[key].view(torch.int16).numpy(),
                                          arr.view(np.int16))
            continue
        assert flat[key].dtype == torch.from_numpy(arr).dtype, key
        np.testing.assert_array_equal(flat[key].numpy(), arr)
    out = TT.train("yi-6b", ckpt_dir=str(tmp_path), device="cpu", **RUN)
    assert out["steps"] == 3
    assert out["final_loss"] == pytest.approx(full["final_loss"], rel=1e-4)


def test_port_checkpoint_restores_and_trains_on_in_reference(tmp_path):
    full = TT.train("yi-6b", ckpt_dir=None, device="cpu", **RUN)
    TT.train("yi-6b", ckpt_dir=str(tmp_path), stop_step=3, device="cpu",
             **RUN)
    files, man = _leaves_by_key(tmp_path / "step_0000000003")
    assert "opt/step" in files and "opt/ef" not in str(sorted(files))
    assert man["leaves"]["opt/step"]["dtype"] == "int32"
    entry = JT.registry.get("yi-6b", reduced=True)

    def like():
        params = entry.module.init(jax.random.PRNGKey(0), entry.config)
        return {"params": params,
                "opt": JT.axw.init(params, JT.axw.AdamWConfig())}

    jlike = jax.eval_shape(like)
    tree, _ = JM(str(tmp_path)).restore(3, jlike)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), files[key])
    out = JT.train("yi-6b", ckpt_dir=str(tmp_path), **RUN)
    assert out["steps"] == 3
    assert out["final_loss"] == pytest.approx(full["final_loss"], rel=1e-4)


def test_reference_bf16_leaf_restores_bitwise(tmp_path):
    vals = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                       jnp.bfloat16)
    JM(str(tmp_path)).save(7, {"w": vals, "n": jnp.arange(4)})
    files, man = _leaves_by_key(tmp_path / "step_0000000007")
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
    like = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
            "n": torch.zeros(4, dtype=torch.int32)}
    tree, _ = TM(str(tmp_path)).restore(7, like, device="cpu")
    assert tree["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tree["w"].view(torch.int16).numpy(),
        np.asarray(vals).view(np.int16))
    assert tree["n"].tolist() == [0, 1, 2, 3]
    # and the port writes bf16 the same way: raw 16-bit items, "bfloat16"
    TM(str(tmp_path / "port")).save(7, tree)
    pfiles, pman = _leaves_by_key(tmp_path / "port" / "step_0000000007")
    assert pman["leaves"]["w"]["dtype"] == "bfloat16"
    assert pfiles["w"].dtype.itemsize == 2 and pfiles["w"].dtype.kind == "V"
    np.testing.assert_array_equal(pfiles["w"].view(np.int16),
                                  files["w"].view(np.int16))


def test_retention_atomicity_and_async_snapshot(tmp_path):
    """keep=2 holds the newest two steps; an async save writes what the
    tree held when ``save`` was called, whatever the loop does next; a
    stale ``.tmp`` directory from a crashed save is replaced."""
    mgr = TM(str(tmp_path), keep=2, async_save=True)
    t = {"x": torch.zeros(4), "opt": taxw.AdamWState(
        torch.tensor(0, dtype=torch.int32), {"x": torch.zeros(4)},
        {"x": torch.zeros(4)})}
    os.makedirs(tmp_path / ".tmp-3")
    for step in (1, 2, 3):
        t["x"].fill_(float(step))
        mgr.save(step, t, extra={"next_step": step})
        t["x"].fill_(-1.0)                  # the loop moves on
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    assert not (tmp_path / ".tmp-3").exists()
    assert mgr.latest_step() == 3
    step, tree, extra = mgr.restore_latest(t, device="cpu")
    assert step == 3 and extra == {"next_step": 3}
    assert tree["x"].tolist() == [3.0] * 4
    assert isinstance(tree["opt"], taxw.AdamWState) and tree["opt"].ef is None
    files, _ = _leaves_by_key(tmp_path / "step_0000000003")
    assert sorted(files) == ["opt/mu/x", "opt/nu/x", "opt/step", "x"]
    shutil.rmtree(tmp_path / "step_0000000002")
    assert TM(str(tmp_path)).all_steps() == [3]
    assert TM(str(tmp_path / "empty")).restore_latest(t) == (None, None,
                                                             None)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            if v is not None:
                yield from _walk(v, path + (k,))
    else:
        yield path, tree
