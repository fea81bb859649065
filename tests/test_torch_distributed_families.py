"""The port's sharded prefill, serve and train steps of the recurrent and
encoder-decoder families (rwkv6, RecurrentGemma, Whisper) on CPU
``gloo`` ranks against the reference's GSPMD cells on a 4-device host
mesh.

One subprocess runs the reference with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: ``build_cell``'s
prefill (an 80-token prompt, batch 4), its serve cell (8 greedy steps
from the reference's unsharded prefill of a 40-token prompt into a
64-deep cache) and ``jax.jit(make_train_step(...))`` with
``assemble_shardings``' shardings (five steps, global batch 8 of 32
tokens), for reduced rwkv6-7b, recurrentgemma-9b and whisper-small in
float32 at the meshes (1, 2) and (2, 2).  The port's ranks are spawned
once per world size (2 and 4), all while the reference runs, and run
the same cells through ``launch.steps.build_cell`` on the same weights
(the reference's ``init(PRNGKey(0), cfg, 2)`` through
``bridge.params_from_numpy``) and the same numpy inputs; at (2, 2) also
each family's train Cell under FSDP (``steps.FSDP_RESIDENCY_BYTES`` set
to 0 in the port's ranks only: GSPMD values do not depend on the
sharding, so it is held against the reference at the same mesh), whose
layer gathers are counted.

Tolerances: prefill logits within 2e-5 (absolute and relative); each
cache leaf within 2e-5, rank by rank on its own shard and on the
gathered cache; 8 greedy decode tokens equal (their logits within
2e-5); train losses over 5 steps within 1e-5 and gradient norms within
1e-3, relative; step-0 gradients (read back from the first moment, as
``tests/test_torch_distributed_train.py``) within rtol 1e-4, atol 1e-6
x max|want| per leaf.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import steps as TSTEPS  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.config import ShapeCell  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["rwkv6-7b", "recurrentgemma-9b", "whisper-small"]
MESHES = [(1, 2), (2, 2)]
FSDP_MESH = (2, 2)
BATCH, PREFILL, PROMPT, SEQ, STEPS = 4, 80, 40, 64, 8
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 8, 32
B1 = 0.9
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-3
TIMEOUT = 600


def _tag(shape, fsdp=False):
    return f"{shape[0]}x{shape[1]}" + ("-fsdp" if fsdp else "")


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


COMMON = r'''
import os, sys
import numpy as np
ARCHS = ["rwkv6-7b", "recurrentgemma-9b", "whisper-small"]
MESHES = [(1, 2), (2, 2)]
FSDP_MESH = (2, 2)
BATCH, PREFILL, SEQ, STEPS = 4, 80, 64, 8
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 8, 32
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def tag(shape, fsdp=False):
    return f"{shape[0]}x{shape[1]}" + ("-fsdp" if fsdp else "")


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


def flatten(tree, prefix, out, conv):
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten(v, f"{prefix}{k}/", out, conv)
        else:
            out[prefix + k] = conv(v)


def prefill_inputs(inp, arch, n, conv):
    x = {"tokens": conv(inp[f"{arch}/tok{n}"])}
    if f"{arch}/frames" in inp:
        x["frames"] = conv(inp[f"{arch}/frames"])
    return x


def train_batch(inp, arch, i):
    batch = {n: inp[f"batch{i}/{n}"] for n in ("tokens", "labels")}
    if f"{arch}/frames{i}" in inp:
        batch["frames"] = inp[f"{arch}/frames{i}"]
    return batch
'''

REF_SCRIPT = COMMON + r'''
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.launch.steps import (assemble_shardings, build_cell,
                                make_train_step)
from repro.models import registry as JR
from repro.models.config import ShapeCell
from repro.optim import adamw as axw

d = sys.argv[1]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
out = {}
for shape in MESHES:
    mesh = make_mesh(shape, ("data", "model"))
    t = tag(shape)
    for arch in ARCHS:
        entry = JR.get(arch, reduced=True)
        cfg = entry.config
        params = unflatten(inp, f"{arch}/p/", jnp.asarray)
        jf, _ = build_cell(entry, mesh,
                           ShapeCell("p", PREFILL, BATCH, "prefill"))
        logits, cache = jf(params, prefill_inputs(inp, arch, PREFILL,
                                                  jnp.asarray))
        out[f"{arch}/{t}/prefill/logits"] = np.asarray(logits)
        for n, x in zip(cache._fields, cache):
            out[f"{arch}/{t}/prefill/{n}"] = np.asarray(x)
        jf, _ = build_cell(entry, mesh, ShapeCell("d", SEQ, BATCH, "decode"))
        cache = type(cache)(*(jnp.asarray(inp[f"{arch}/cache0/{n}"])
                              for n in cache._fields))
        tok = jnp.asarray(inp[f"{arch}/first"])
        toks, logs = [], []
        for _ in range(STEPS):
            logits, cache = jf(params, cache, tok)
            tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            logs.append(np.asarray(logits))
        out[f"{arch}/{t}/serve/tokens"] = np.stack(toks)
        out[f"{arch}/{t}/serve/logits"] = np.stack(logs)
        for n, x in zip(cache._fields, cache):
            out[f"{arch}/{t}/serve/{n}"] = np.asarray(x)
        ocfg = axw.AdamWConfig(**OCFG)
        _, in_sh, out_sh = assemble_shardings(
            entry, mesh, "train",
            ShapeCell("t", TRAIN_SEQ, TRAIN_BATCH, "train"), ocfg)
        step = jax.jit(make_train_step(entry, ocfg, shape[1], mesh),
                       in_shardings=in_sh, out_shardings=out_sh)
        p = jax.device_put(params, in_sh[0])
        opt = jax.device_put(axw.init(p, ocfg), in_sh[1])
        losses, norms = [], []
        for i in range(TRAIN_STEPS):
            batch = {n: jnp.asarray(v)
                     for n, v in train_batch(inp, arch, i).items()}
            p, opt, m = step(p, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i == 0:
                flatten(opt.mu, f"{arch}/{t}/train/mu0/", out, np.asarray)
        out[f"{arch}/{t}/train/loss"] = np.array(losses)
        out[f"{arch}/{t}/train/gnorm"] = np.array(norms)
np.savez(os.path.join(d, "ref.npz"), **out)
print("REF DONE")
'''

PORT_SCRIPT = COMMON + r'''
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, port, d = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as M, steps
from repro_torch.models import registry as R
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.config import ShapeCell
from repro_torch.optim import adamw as axw

inp = dict(np.load(os.path.join(d, "inputs.npz")))
T = lambda a: torch.from_numpy(np.array(a))
out = {}


def serve_cases(entry, mesh, t, full):
    arch, cfg = entry.config.name, entry.config
    cell, _ = steps.build_cell(entry, mesh,
                               ShapeCell("p", PREFILL, BATCH, "prefill"))
    logits, cache = cell(full, prefill_inputs(inp, arch, PREFILL, T))
    for n, x in zip(cache._fields, cache):
        out[f"{arch}/{t}/prefill/local/{n}"] = x.numpy().copy()
    logits, cache = cell.gather((logits, cache))
    out[f"{arch}/{t}/prefill/logits"] = logits.numpy()
    for n, x in zip(cache._fields, cache):
        out[f"{arch}/{t}/prefill/{n}"] = x.numpy()
    cell, _ = steps.build_cell(entry, mesh, ShapeCell("d", SEQ, BATCH,
                                                      "decode"))
    params_l = S.shard_tree(full, cell.in_specs[0], mesh)
    rows = cell.in_specs[2] + (None,)
    cache0 = type(cache)(*(T(inp[f"{arch}/cache0/{n}"])
                           for n in cache._fields))
    _, cache, tok = cell.shard(None, cache0, T(inp[f"{arch}/first"]))
    toks, logs = [], []
    for _ in range(STEPS):
        logits, cache = cell.step(params_l, cache, tok)
        tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
        toks.append(S.gather_tensor(tok, rows[:1], mesh).numpy())
        logs.append(S.gather_tensor(logits, rows, mesh).numpy())
    out[f"{arch}/{t}/serve/tokens"] = np.stack(toks)
    out[f"{arch}/{t}/serve/logits"] = np.stack(logs)
    for n, x in zip(cache._fields, S.gather_tree(cache, cell.in_specs[1],
                                                 mesh)):
        out[f"{arch}/{t}/serve/{n}"] = x.numpy()


def train_case(entry, mesh, shape, full, fsdp):
    arch = entry.config.name
    ocfg = axw.AdamWConfig(**OCFG)
    saved = steps.FSDP_RESIDENCY_BYTES
    if fsdp:
        steps.FSDP_RESIDENCY_BYTES = 0
    try:
        cell, _ = steps.build_cell(
            entry, mesh, ShapeCell("t", TRAIN_SEQ, TRAIN_BATCH, "train"),
            ocfg=ocfg)
    finally:
        steps.FSDP_RESIDENCY_BYTES = saved
    assert (cell.fsdp is not None) == fsdp
    full = S.tree_map(lambda x: x.clone(), full)
    params, opt, _ = cell.shard(full, axw.init(full, ocfg), None)
    key = f"{arch}/{tag(shape, fsdp)}/train"
    losses, norms, gathers = [], [], []
    for i in range(TRAIN_STEPS):
        _, _, batch = cell.shard(None, None, train_batch(inp, arch, i))
        before = cell.fsdp.layer_gathers if fsdp else 0
        params, opt, m = cell.step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if fsdp:
            gathers.append(cell.fsdp.layer_gathers - before)
        if i == 0:
            _, o, _ = cell.gather((None, opt, None))
            flatten(o.mu, f"{key}/mu0/", out, lambda x: x.numpy().copy())
    out[f"{key}/loss"] = np.array(losses)
    out[f"{key}/gnorm"] = np.array(norms)
    if fsdp:
        out[f"{key}/layer_gathers"] = np.array(gathers)


for shape in [s for s in MESHES if s[0] * s[1] == world]:
    mesh = M.bind(M.make_mesh(shape, ("data", "model")), "cpu")
    for arch in ARCHS:
        entry = R.get(arch, reduced=True)
        full = params_from_numpy(unflatten(inp, f"{arch}/p/", np.asarray),
                                 entry.config, device="cpu", tp=2)
        serve_cases(entry, mesh, tag(shape), full)
        train_case(entry, mesh, shape, full, False)
        if shape == FSDP_MESH:
            train_case(entry, mesh, shape, full, True)
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
    """The reference's weights (one set per arch serves tp 1 and 2), the
    prompts and frames, the reference's unsharded prefill of the
    40-token prompt into a 64-deep cache (the serve loops' start), five
    TokenPipeline batches and, for whisper, five batches of frames."""
    rng = np.random.default_rng(0)
    inp = {}
    for arch in ARCHS:
        entry = JR.get(arch, reduced=True)
        cfg, mod = entry.config, entry.module
        assert cfg.padded_heads(1) == cfg.padded_heads(2)
        assert cfg.padded_vocab(1) == cfg.padded_vocab(2)
        params = mod.init(jax.random.PRNGKey(0), cfg, 2)
        inp.update(_flatten(params, f"{arch}/p/"))
        for n in (PREFILL, PROMPT):
            inp[f"{arch}/tok{n}"] = rng.integers(0, cfg.vocab, (BATCH, n),
                                                 dtype=np.int32)
        kw = {}
        if cfg.family == "audio":
            inp[f"{arch}/frames"] = rng.standard_normal(
                (BATCH, cfg.encoder_frames, cfg.d_model), dtype=np.float32)
            kw = {"frames": jnp.asarray(inp[f"{arch}/frames"])}
            for i in range(TRAIN_STEPS):
                inp[f"{arch}/frames{i}"] = rng.standard_normal(
                    (TRAIN_BATCH, cfg.encoder_frames, cfg.d_model),
                    dtype=np.float32)
        logits, cache = jax.jit(lambda p, t: mod.prefill(
            p, cfg, t, tp=2, max_seq=SEQ, **kw))(
                params, jnp.asarray(inp[f"{arch}/tok{PROMPT}"]))
        inp[f"{arch}/first"] = np.asarray(
            jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32))
        for n, x in zip(cache._fields, cache):
            inp[f"{arch}/cache0/{n}"] = np.asarray(x)
    data = TokenPipeline(DataConfig(vocab=JR.get(ARCHS[0], reduced=True)
                                    .config.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    for i in range(TRAIN_STEPS):
        for n, v in data.batch_at(i).items():
            if n in ("tokens", "labels"):
                inp[f"batch{i}/{n}"] = v
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_families"))
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


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, err_msg=msg, **tol)


def _local_block(full, spec, shape, rank):
    """The block of ``full`` that rank ``rank`` of a ("data", "model")
    mesh of ``shape`` holds under ``spec``."""
    coords = {"data": rank // shape[1], "model": rank % shape[1]}
    sizes = {"data": shape[0], "model": shape[1]}
    out = full
    for d, e in enumerate(spec):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        n, i = 1, 0
        for a in names:
            n, i = n * sizes[a], i * sizes[a] + coords[a]
        if n > 1:
            part = out.shape[d] // n
            out = np.take(out, range(i * part, (i + 1) * part), axis=d)
    return out


def _cache_specs(arch, shape):
    entry = TR.get(arch, reduced=True)
    mesh = TM.make_mesh(shape, ("data", "model"))
    _, _, out_specs = TSTEPS.assemble_shardings(
        entry, mesh, "prefill", ShapeCell("p", PREFILL, BATCH, "prefill"))
    return out_specs[1]


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cell_matches_reference(runs, arch, shape):
    """``build_cell``'s prefill: the last logits, and every cache leaf on
    each rank's own shard (the cache spec's block of the reference's
    cache) and gathered."""
    _, ref, port = runs
    key, world = f"{arch}/{_tag(shape)}/prefill", shape[0] * shape[1]
    specs = _cache_specs(arch, shape)
    fields = specs._fields
    cut = 0
    for r in range(world):
        got = port[(world, r)]
        _close(got[f"{key}/logits"], ref[f"{key}/logits"], TOL, "logits")
        for n, spec in zip(fields, specs):
            want = ref[f"{key}/{n}"]
            _close(got[f"{key}/{n}"], want, TOL, n)
            local = got[f"{key}/local/{n}"]
            block = _local_block(want, spec, shape, r)
            assert local.shape == block.shape, n
            _close(local, block, TOL, f"{n} shard")
            cut += local.size < want.size
    assert cut > world        # the caches are held sharded


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cell_greedy_tokens_match_reference(runs, arch, shape):
    """8 greedy steps of ``build_cell``'s serve cell from the same cache:
    the tokens equal, the logits and the final cache within 2e-5."""
    _, ref, port = runs
    key, world = f"{arch}/{_tag(shape)}/serve", shape[0] * shape[1]
    fields = _cache_specs(arch, shape)._fields
    for r in range(world):
        got = port[(world, r)]
        np.testing.assert_array_equal(got[f"{key}/tokens"],
                                      ref[f"{key}/tokens"])
        _close(got[f"{key}/logits"], ref[f"{key}/logits"], TOL, "logits")
        for n in fields:
            _close(got[f"{key}/{n}"], ref[f"{key}/{n}"], TOL, n)


def _step0_grads(res, key):
    """Per leaf, the clipped step-0 gradient over the clip scale."""
    scale = min(1.0, 1.0 / max(float(res[f"{key}/gnorm"][0]), 1e-9))
    return {k[len(f"{key}/mu0/"):]: mu.astype(np.float64) / (1 - B1) / scale
            for k, mu in res.items() if k.startswith(f"{key}/mu0/")}


def _check_train(runs, arch, shape, fsdp):
    _, ref, port = runs
    world = shape[0] * shape[1]
    want_key = f"{arch}/{_tag(shape)}/train"
    got_key = f"{arch}/{_tag(shape, fsdp)}/train"
    want = _step0_grads(ref, want_key)
    assert len(want) > 5
    for r in range(world):
        got = port[(world, r)]
        grads = _step0_grads(got, got_key)
        assert sorted(grads) == sorted(want)
        for leaf, w in want.items():
            np.testing.assert_allclose(
                grads[leaf], w, rtol=GRAD_RTOL,
                atol=GRAD_ATOL * np.abs(w).max(), err_msg=leaf)
        np.testing.assert_allclose(got[f"{got_key}/loss"],
                                   ref[f"{want_key}/loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[f"{got_key}/gnorm"],
                                   ref[f"{want_key}/gnorm"], rtol=GNORM_RTOL)
    return port


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(runs, arch, shape):
    _check_train(runs, arch, shape, False)


def _layers_gathered_per_step(cfg):
    """Layer gathers of one FSDP train step: every layer in the forward,
    and again where backward recomputes it (every layer of rwkv6 and of
    both whisper stacks; RecurrentGemma's (rec, rec, attn) groups, not
    its recurrent tail, as the reference checkpoints them)."""
    if cfg.family == "hybrid":
        return cfg.num_layers + 3 * (cfg.num_layers // 3)
    return 2 * (cfg.num_layers + cfg.encoder_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_train_step_gathers_one_layer_at_a_time(runs, arch):
    """With the residency rule at 0 the (2, 2) train Cell holds each
    leaf's data shard too, gathers each layer where it runs (counted a
    step), and still gives the reference's losses and gradients."""
    port = _check_train(runs, arch, FSDP_MESH, True)
    cfg = TR.get(arch, reduced=True).config
    per_step = _layers_gathered_per_step(cfg)
    assert per_step > cfg.num_layers
    for r in range(FSDP_MESH[0] * FSDP_MESH[1]):
        got = port[(4, r)][f"{arch}/{_tag(FSDP_MESH, True)}/train/"
                           f"layer_gathers"]
        np.testing.assert_array_equal(got, [per_step] * TRAIN_STEPS)
