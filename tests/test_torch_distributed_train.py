"""The port's sharded train step on CPU ``gloo`` ranks against the
reference's GSPMD train step on a 4-device host mesh, the port's
elastic restart (a port of ``tests/test_elastic_restart.py``), and the
FSDP serve step's per-layer gathers.

One subprocess runs the reference with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``:
``jax.jit(make_train_step(entry, ocfg, tp, mesh, microbatch))`` with
``assemble_shardings``' shardings, five steps on real arrays, for
reduced yi-6b and qwen3-30b-a3b in float32 at the meshes (2, 1), (1, 2),
(2, 2) and (4, 1), and at (2, 2) with ``microbatch=2`` and with
``compress_grads``, and at (2, 2) reduced granite-3-8b (a tied
embedding table) and qwen2-vl-7b (the VLM text backbone on one-hot
embeds); then its trainer on (2, 2), stopped at step 4 of 8 and
resumed.  The port's ranks are spawned once per world size (2 and
4), all while the reference runs, and run the same cases through
``build_cell``'s train ``Cell`` on the same weights (the reference's
``init(PRNGKey(0), cfg, tp)`` through ``bridge.params_from_numpy``) and
the same ``TokenPipeline`` batches; at (2, 2) and (4, 1) also with
FSDP (``steps.FSDP_RESIDENCY_BYTES`` set to 0 in the port's ranks only:
GSPMD values do not depend on the sharding, so these are held against
the reference at the same mesh).

The step-0 gradient of each leaf is read back from the first moment
after step 0, on both sides: ``mu_1 = (1 - b1) g_c`` where ``g_c`` is
the clipped gradient (with compression ``g_c = mu_1 / (1 - b1) + ef_1``),
divided by the clip scale the step's gradient norm gives.

Tolerances: step-0 gradients rtol 1e-4, atol 1e-6 x max|want| per leaf;
five-step losses within 1e-5 and gradient norms within 1e-3, relative.
"""
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro.models import registry as JR  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["yi-6b", "qwen3-30b-a3b"]
# (mesh, microbatch, compress_grads); FSDP cases are the port's only
REF_CASES = [((2, 1), 1, False), ((1, 2), 1, False), ((2, 2), 1, False),
             ((4, 1), 1, False), ((2, 2), 2, False), ((2, 2), 1, True)]
FSDP_CASES = [((2, 2), 1, False), ((4, 1), 1, False)]
# at (2, 2): a tied embedding table, d-sharded (its logits are a
# row-parallel product), and the VLM text backbone on one-hot embeds
MORE = ["granite-3-8b", "qwen2-vl-7b"]
MORE_CASE = ((2, 2), 1, False)
STEPS, BATCH, SEQ = 5, 8, 32
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
SERVE_LAYERS = 4
B1 = 0.9
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-3
TIMEOUT = 600


def _case(shape, mb, comp, fsdp=False):
    return (f"{shape[0]}x{shape[1]}" + (f"-mb{mb}" if mb > 1 else "")
            + ("-comp" if comp else "") + ("-fsdp" if fsdp else ""))


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


COMMON = r'''
import os, sys, time
import numpy as np
ARCHS = ["yi-6b", "qwen3-30b-a3b"]
REF_CASES = [((2, 1), 1, False), ((1, 2), 1, False), ((2, 2), 1, False),
             ((4, 1), 1, False), ((2, 2), 2, False), ((2, 2), 1, True)]
FSDP_CASES = [((2, 2), 1, False), ((4, 1), 1, False)]
MORE = ["granite-3-8b", "qwen2-vl-7b"]
MORE_CASE = ((2, 2), 1, False)
STEPS, BATCH, SEQ = 5, 8, 32
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
ELASTIC = dict(steps=8, global_batch=8, seq=32, save_every=100,
               log_every=100, seed=1)
SERVE_LAYERS = 4


def case(shape, mb, comp, fsdp=False):
    return (f"{shape[0]}x{shape[1]}" + (f"-mb{mb}" if mb > 1 else "")
            + ("-comp" if comp else "") + ("-fsdp" if fsdp else ""))


def unflatten(flat, prefix, conv):
    tree = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = conv(val)
    return tree


def batch_at(inp, i, cfg):
    """Step i's batch as the model takes it: the VLM's tokens become
    one-hot embeds of ``tokens % d_model`` (both trainers' stub)."""
    batch = {n: inp[f"batch{i}/{n}"] for n in ("tokens", "labels")}
    if cfg.family == "vlm":
        eye = np.eye(cfg.d_model, dtype=np.float32)
        batch = {"embeds": eye[batch["tokens"] % cfg.d_model],
                 "labels": batch["labels"]}
    return batch


def flatten(tree, prefix, out, conv):
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(v, f"{prefix}{k}/", out, conv)
        else:
            out[prefix + k] = conv(v)
'''

REF_SCRIPT = COMMON + r'''
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import shutil
import jax
import jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.launch.steps import assemble_shardings, make_train_step
from repro.launch.train import train
from repro.models import registry as JR
from repro.models.config import ShapeCell
from repro.optim import adamw as axw

d = sys.argv[1]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
out = {}
# the elastic legs first: the port's (1, 2) ranks resume the checkpoint
ck = os.path.join(d, "ref_ckpt")
train("yi-6b", stop_step=4, ckpt_dir=ck, mesh_shape=(2, 2), **ELASTIC)
open(os.path.join(d, "ref_ckpt.done"), "w").close()
shutil.copytree(ck, ck + "_ref")
res = train("yi-6b", ckpt_dir=ck + "_ref", mesh_shape=(2, 2), **ELASTIC)
out["elastic/ref_resumed_loss"] = np.float32(res["final_loss"])
for arch, (shape, mb, comp) in ([(a, c) for a in ARCHS for c in REF_CASES]
                                + [(a, MORE_CASE) for a in MORE]):
    entry = JR.get(arch, reduced=True)
    mesh = make_mesh(shape, ("data", "model"))
    ocfg = axw.AdamWConfig(compress_grads=comp, **OCFG)
    _, in_sh, out_sh = assemble_shardings(
        entry, mesh, "train", ShapeCell("t", SEQ, BATCH, "train"), ocfg)
    step = jax.jit(make_train_step(entry, ocfg, shape[1], mesh, mb),
                   in_shardings=in_sh, out_shardings=out_sh)
    params = jax.device_put(unflatten(inp, f"{arch}/p/", jnp.asarray),
                            in_sh[0])
    opt = jax.device_put(axw.init(params, ocfg), in_sh[1])
    key = f"{arch}/{case(shape, mb, comp)}"
    losses, norms = [], []
    for i in range(STEPS):
        batch = {n: jnp.asarray(v)
                 for n, v in batch_at(inp, i, entry.config).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            flatten(opt.mu, f"{key}/mu0/", out, np.asarray)
            if comp:
                flatten(opt.ef, f"{key}/ef0/", out, np.asarray)
    out[f"{key}/loss"] = np.array(losses)
    out[f"{key}/gnorm"] = np.array(norms)
np.savez(os.path.join(d, "ref.npz"), **out)
print("REF DONE")
'''

PORT_SCRIPT = COMMON + r'''
import shutil
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, port, d = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as M, steps, train as TRAIN
from repro_torch.models import registry as R
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.config import ShapeCell
from repro_torch.optim import adamw as axw

inp = dict(np.load(os.path.join(d, "inputs.npz")))
T = lambda a: torch.from_numpy(np.array(a))
out = {}


def train_case(entry, shape, mb, comp, fsdp):
    mesh = M.bind(M.make_mesh(shape, ("data", "model")), "cpu")
    ocfg = axw.AdamWConfig(compress_grads=comp, **OCFG)
    saved = steps.FSDP_RESIDENCY_BYTES
    if fsdp:
        steps.FSDP_RESIDENCY_BYTES = 0
    try:
        cell, _ = steps.build_cell(entry, mesh,
                                   ShapeCell("t", SEQ, BATCH, "train"),
                                   ocfg=ocfg, microbatch=mb)
    finally:
        steps.FSDP_RESIDENCY_BYTES = saved
    assert (cell.fsdp is not None) == fsdp
    arch = entry.config.name
    full = params_from_numpy(unflatten(inp, f"{arch}/p/", np.asarray),
                             entry.config, device="cpu")
    params, opt, _ = cell.shard(full, axw.init(full, ocfg), None)
    key = f"{arch}/{case(shape, mb, comp, fsdp)}"
    losses, norms = [], []
    for i in range(STEPS):
        _, _, batch = cell.shard(None, None,
                                 batch_at(inp, i, entry.config))
        params, opt, m = cell.step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            _, o, _ = cell.gather((None, opt, None))
            flatten(o.mu, f"{key}/mu0/", out, lambda t: t.numpy().copy())
            if comp:
                flatten(o.ef, f"{key}/ef0/", out, lambda t: t.numpy().copy())
    out[f"{key}/loss"] = np.array(losses)
    out[f"{key}/gnorm"] = np.array(norms)
    if fsdp:
        out[f"{key}/layer_gathers"] = np.int64(cell.fsdp.layer_gathers)


def serve_fsdp(arch):
    """The serve Cell at (2, 2) of a 4-layer reduced config (the port's
    own weights, seed 0) with and without FSDP: the same greedy tokens;
    with it, a step gathers each layer once and never holds more than
    two gathered layers (the one running and the one before it)."""
    import weakref
    entry = R.get(arch, reduced=True, num_layers=SERVE_LAYERS)
    cfg = entry.config
    mesh = M.bind(M.make_mesh((2, 2), ("data", "model")), "cpu")
    full = entry.module.init(cfg, 2, device="cpu", seed=0)
    toks = {}
    for fsdp in (False, True):
        saved = steps.FSDP_RESIDENCY_BYTES
        if fsdp:
            steps.FSDP_RESIDENCY_BYTES = 0
        try:
            cell, _ = steps.build_cell(entry, mesh,
                                       ShapeCell("d", SEQ, 4, "decode"),
                                       seq_sharded_attn=True)
        finally:
            steps.FSDP_RESIDENCY_BYTES = saved
        assert (cell.fsdp is not None) == fsdp
        prefill = steps.make_prefill_step(
            entry, 2, mesh, max_seq=SEQ,
            shape=ShapeCell("p", SEQ, 4, "prefill"))
        live, most = [], [0]
        if fsdp:
            gather = cell.fsdp.layer

            def watched(pieces, li):
                layer = gather(pieces, li)
                mine = {id(t) for _, t in S.tree_leaves_with_path(pieces)}
                live.append([weakref.ref(t) for _, t in
                             S.tree_leaves_with_path(layer)
                             if id(t) not in mine])
                most[0] = max(most[0], sum(
                    any(r() is not None for r in g) for g in live))
                return layer
            cell.fsdp.layer = watched
        params = S.shard_tree(full, cell.in_specs[0], mesh)
        rows = cell.in_specs[2] + (None,)
        prompt = S.shard_tensor(T(inp[f"{arch}/prompt"]), rows, mesh)
        logits, cache = cell.run_with(prefill, params, {"tokens": prompt})
        tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
        seq = [tok]
        before = cell.fsdp.layer_gathers if fsdp else 0
        for _ in range(4):
            logits, cache = cell.step(params, cache, tok)
            tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
            seq.append(tok)
        toks[fsdp] = S.gather_tensor(torch.stack(seq, 1), rows,
                                     mesh).numpy()
        if fsdp:
            out[f"serve/{arch}/gathers_per_step"] = np.float64(
                (cell.fsdp.layer_gathers - before) / 4)
            out[f"serve/{arch}/most_live_layers"] = np.int64(most[0])
    out[f"serve/{arch}/tokens"] = toks[False]
    out[f"serve/{arch}/tokens_fsdp"] = toks[True]


for arch in ARCHS:
    entry = R.get(arch, reduced=True)
    for shape, mb, comp in REF_CASES:
        if shape[0] * shape[1] == world:
            train_case(entry, shape, mb, comp, False)
    for shape, mb, comp in FSDP_CASES:
        if shape[0] * shape[1] == world:
            train_case(entry, shape, mb, comp, True)
    if world == 4:
        serve_fsdp(arch)
if world == 4:
    for arch in MORE:
        train_case(R.get(arch, reduced=True), *MORE_CASE, False)

if world == 4:
    # a port run on (2, 2) stopped at step 4 of 8, resumed on (1, 4)
    ck = os.path.join(d, "port_ckpt")
    out["elastic/full_loss"] = np.float32(TRAIN.train(
        "yi-6b", ckpt_dir=None, mesh_shape=(2, 2), device="cpu",
        **ELASTIC)["final_loss"])
    a = TRAIN.train("yi-6b", ckpt_dir=ck, stop_step=4, mesh_shape=(2, 2),
                    device="cpu", **ELASTIC)
    b = TRAIN.train("yi-6b", ckpt_dir=ck, mesh_shape=(1, 4), device="cpu",
                    **ELASTIC)
    out["elastic/steps"] = np.array([a["steps"], b["steps"]])
    out["elastic/resumed_loss"] = np.float32(b["final_loss"])
else:
    # the reference's (2, 2) checkpoint of step 4, resumed on (1, 2)
    done = os.path.join(d, "ref_ckpt.done")
    deadline = time.monotonic() + 500
    while not os.path.exists(done):
        assert time.monotonic() < deadline, "no reference checkpoint"
        time.sleep(0.5)
    ck = os.path.join(d, "ref_ckpt")
    if rank == 0:
        shutil.copytree(ck, ck + "_port")
    dist.barrier()
    b = TRAIN.train("yi-6b", ckpt_dir=ck + "_port", mesh_shape=(1, 2),
                    device="cpu", **ELASTIC)
    out["elastic/from_ref_steps"] = np.int64(b["steps"])
    out["elastic/from_ref_loss"] = np.float32(b["final_loss"])
dist.barrier()
dist.destroy_process_group()
np.savez(os.path.join(d, f"port_{world}_{rank}.npz"), **out)
print("PORT DONE", rank)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    """The reference's weights (one set per arch serves tp 1, 2 and 4),
    five TokenPipeline batches and the serve prompts."""
    inp = {}
    rng = np.random.default_rng(0)
    for arch in ARCHS + MORE:
        entry = JR.get(arch, reduced=True)
        cfg = entry.config
        assert cfg.padded_heads(1) == cfg.padded_heads(2) \
            == cfg.padded_heads(4)
        assert cfg.padded_vocab(1) == cfg.padded_vocab(4)
        params = entry.module.init(jax.random.PRNGKey(0), cfg, 2)
        inp.update(_flatten(params, f"{arch}/p/"))
        inp[f"{arch}/prompt"] = rng.integers(0, cfg.vocab, (4, 12),
                                             dtype=np.int32)
    data = TokenPipeline(DataConfig(vocab=JR.get(ARCHS[0], reduced=True)
                                    .config.vocab, seq_len=SEQ,
                                    global_batch=BATCH))
    for i in range(STEPS):
        for n, v in data.batch_at(i).items():
            if n in ("tokens", "labels"):
                inp[f"batch{i}/{n}"] = v
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_train"))
    inp = _inputs()
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [("reference", subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, d], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))]
    for world in (2, 4):
        port = _free_port()
        for rank in range(world):
            procs.append((f"port world {world} rank {rank}", subprocess.Popen(
                [sys.executable, "-c", PORT_SCRIPT, str(rank), str(world),
                 str(port), d], cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, proc in procs:
        try:
            log, _ = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name} (exit {proc.returncode}):\n{log[-4000:]}")
    assert not failed, "\n".join(failed)
    port = {(w, r): dict(np.load(os.path.join(d, f"port_{w}_{r}.npz")))
            for w in (2, 4) for r in range(w)}
    return inp, dict(np.load(os.path.join(d, "ref.npz"))), port


def _step0_grads(res, key, comp):
    """Per leaf, the clipped step-0 gradient over the clip scale."""
    scale = min(1.0, 1.0 / max(float(res[f"{key}/gnorm"][0]), 1e-9))
    out = {}
    for k, mu in res.items():
        if k.startswith(f"{key}/mu0/"):
            leaf = k[len(f"{key}/mu0/"):]
            g = mu.astype(np.float64) / (1 - B1)
            if comp:
                g = g + res[f"{key}/ef0/{leaf}"]
            out[leaf] = g / scale
    return out


def _check_case(runs, arch, shape, mb, comp, fsdp):
    _, ref, port = runs
    world = shape[0] * shape[1]
    want_key = f"{arch}/{_case(shape, mb, comp)}"
    got_key = f"{arch}/{_case(shape, mb, comp, fsdp)}"
    want = _step0_grads(ref, want_key, comp)
    assert len(want) > 5
    for r in range(world):
        got = port[(world, r)]
        grads = _step0_grads(got, got_key, comp)
        assert sorted(grads) == sorted(want)
        for leaf, w in want.items():
            np.testing.assert_allclose(
                grads[leaf], w, rtol=GRAD_RTOL,
                atol=GRAD_ATOL * np.abs(w).max(), err_msg=leaf)
        np.testing.assert_allclose(got[f"{got_key}/loss"],
                                   ref[f"{want_key}/loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[f"{got_key}/gnorm"],
                                   ref[f"{want_key}/gnorm"], rtol=GNORM_RTOL)
        if fsdp:
            # each step gathers every layer twice: forward, recomputation
            layers = JR.get(arch, reduced=True).config.num_layers
            assert got[f"{got_key}/layer_gathers"] == 2 * layers * STEPS


@pytest.mark.parametrize("case", REF_CASES,
                         ids=[_case(*c) for c in REF_CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_reference(runs, arch, case):
    _check_case(runs, arch, *case, False)


@pytest.mark.parametrize("case", FSDP_CASES,
                         ids=[_case(*c) for c in FSDP_CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_train_step_matches_reference(runs, arch, case):
    _check_case(runs, arch, *case, True)


@pytest.mark.parametrize("arch", MORE)
def test_tied_table_and_vlm_train_steps_match_reference(runs, arch):
    """At (2, 2): a tied, d-sharded table, whose loss logits are the
    row-parallel product summed over "model" (reduced granite-3-8b), and
    the VLM text backbone on embeds (reduced qwen2-vl-7b)."""
    _check_case(runs, arch, *MORE_CASE, False)


def test_elastic_restart_on_resharded_mesh(runs):
    """A port run on (2, 2) stopped at step 4 of 8 and resumed on (1, 4)
    ends at the uninterrupted (2, 2) run's loss."""
    _, _, port = runs
    for r in range(4):
        got = port[(4, r)]
        np.testing.assert_array_equal(got["elastic/steps"], [4, 4])
        np.testing.assert_allclose(got["elastic/resumed_loss"],
                                   got["elastic/full_loss"], rtol=1e-5)


def test_reference_checkpoint_resumes_on_another_mesh(runs):
    """The reference's checkpoint of step 4, written on its (2, 2) host
    mesh, resumes in the port on (1, 2) to the loss of the reference's
    own resume."""
    _, ref, port = runs
    for r in range(2):
        got = port[(2, r)]
        assert got["elastic/from_ref_steps"] == 4
        np.testing.assert_allclose(got["elastic/from_ref_loss"],
                                   ref["elastic/ref_resumed_loss"],
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_serve_cell_gathers_one_layer_at_a_time(runs, arch):
    """With the residency rule at 0 the serve Cell's greedy tokens are
    unchanged (a 4-layer reduced config at (2, 2)); a step gathers each
    of the L layers once, and never holds more than two gathered
    layers."""
    _, _, port = runs
    for r in range(4):
        got = port[(4, r)]
        np.testing.assert_array_equal(got[f"serve/{arch}/tokens_fsdp"],
                                      got[f"serve/{arch}/tokens"])
        assert got[f"serve/{arch}/gathers_per_step"] == SERVE_LAYERS
        assert got[f"serve/{arch}/most_live_layers"] <= 2


def test_remat_recomputes_under_the_forward_context():
    """Autograd runs the backward of CUDA tensors in a thread of its own,
    where the forward's (thread-local) distribution context is not set:
    ``layers.remat`` must recompute under the forward's context."""
    import threading

    from repro_torch.distributed import context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as TL
    mesh = make_mesh((2, 2), ("data", "model"))
    seen = []

    def block(x):
        seen.append((context.current_mesh(), context.batch_local()))
        return x * x

    x = torch.ones(3, requires_grad=True)
    with context.use_mesh(mesh, local_batch=True):
        y = TL.remat(block, x).sum()
    worker = threading.Thread(target=y.backward)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert seen == [(mesh, True), (mesh, True)]
    assert x.grad.tolist() == [2.0, 2.0, 2.0]     # d(x^2)/dx at 1
