"""The port's sharded serving path on CPU ``gloo`` ranks against the
reference's sharded programs on a 4-device host mesh.

One subprocess runs the reference with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: its
``make_seq_sharded_attn``, its ``build_cell`` prefill and serve steps
(``jf(params, ...)`` on real arrays, cells of seq 64 and batch 4) and
``apply_moe`` under ``use_mesh`` (the ``shard_map`` branch where the
mesh has a data axis), at the meshes (1, 2), (1, 4) and (2, 2), on
reduced yi-6b and qwen3-30b-a3b in float32.  The port's ranks are
spawned once per world size (2 and 4) by the module's fixture, all of
them while the reference runs; each binds its meshes
(``launch.mesh.bind``) and runs the same cases on the same numpy inputs
and weights (the reference's ``init``).

Tolerances: the attention's partials and combine within 1e-6; logits
within 2e-5 (absolute and relative); greedy tokens over 8 decode steps
equal; MoE outputs within 1e-6 with the same pairs dropped.
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

from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import steps as TSTEPS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.config import ShapeCell  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["yi-6b", "qwen3-30b-a3b"]
MESHES = [(1, 2), (1, 4), (2, 2)]
STEPS, PROMPT, SEQ, BATCH = 8, 40, 64, 4
ATTN = dict(b=4, hq=8, hkv=2, d=32, lengths=[0, 5, 33, 64])
MOE_TOKENS = 128
TOL = dict(rtol=2e-5, atol=2e-5)
TIGHT = dict(rtol=1e-6, atol=1e-6)
TIMEOUT = 600


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


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
MESHES = [(1, 2), (1, 4), (2, 2)]
ARCHS = ["yi-6b", "qwen3-30b-a3b"]
STEPS = 8


def tag(shape):
    return f"{shape[0]}x{shape[1]}"


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
'''

REF_SCRIPT = COMMON + r'''
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from repro.distributed.context import use_mesh
from repro.distributed.seq_attention import make_seq_sharded_attn
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_cell, make_prefill_step
from repro.models import layers as JL, registry as JR, transformer as JT
from repro.models.config import ShapeCell

d = sys.argv[1]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
out = {}
moe_cfg = JR.get("qwen3-30b-a3b", reduced=True,
                 capacity_factor=1.0).config
moe_p = unflatten(inp, "moe/p/", jnp.asarray)
for shape in MESHES:
    mesh = make_mesh(shape, ("data", "model"))
    t = tag(shape)
    attn = jax.jit(make_seq_sharded_attn(mesh))
    out[f"attn/{t}"] = np.asarray(attn(*(jnp.asarray(inp[f"attn/{n}"])
                                         for n in ("q", "k", "v",
                                                   "lengths"))))

    def moe(p, x):
        with use_mesh(mesh):
            return JL.apply_moe(p, x, moe_cfg)
    out[f"moe/{t}"] = np.asarray(jax.jit(moe)(moe_p,
                                              jnp.asarray(inp["moe/x"])))
    for arch in ARCHS:
        entry = JR.get(arch, reduced=True)
        vocab = entry.config.vocab
        params = unflatten(inp, f"{arch}/p/", jnp.asarray)
        jf, _ = build_cell(entry, mesh, ShapeCell("p", 64, 4, "prefill"))
        logits, cache = jf(params, {"tokens": jnp.asarray(
            inp[f"{arch}/tok64"])})
        out[f"{arch}/{t}/prefill_logits"] = np.asarray(logits)
        out[f"{arch}/{t}/prefill_k"] = np.asarray(cache.k)
        out[f"{arch}/{t}/prefill_v"] = np.asarray(cache.v)
        # the 40-token prompt into a 64-deep cache, under the mesh
        logits, cache = jax.jit(make_prefill_step(
            entry, shape[1], mesh, max_seq=64))(params, {
                "tokens": jnp.asarray(inp[f"{arch}/tok40"])})
        out[f"{arch}/{t}/prefill40_logits"] = np.asarray(logits)
        out[f"{arch}/{t}/prefill40_k"] = np.asarray(cache.k)
        for seqsh in ([True, False] if shape == (1, 2) else [True]):
            jf, _ = build_cell(entry, mesh, ShapeCell("d", 64, 4, "decode"),
                               seq_sharded_attn=seqsh)
            cache = JT.KVCache(*(jnp.asarray(inp[f"{arch}/cache0_{n}"])
                                 for n in ("k", "v", "lengths")))
            tok = jnp.asarray(inp[f"{arch}/first"])
            toks, logs = [], []
            for _ in range(STEPS):
                logits, cache = jf(params, cache, tok)
                tok = jnp.argmax(logits[:, :vocab], -1).astype(jnp.int32)
                toks.append(np.asarray(tok))
                logs.append(np.asarray(logits))
            key = f"{arch}/{t}/serve_{'seq' if seqsh else 'gather'}"
            out[key + "_tokens"] = np.stack(toks)
            out[key + "_logits"] = np.stack(logs)
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
from repro_torch.distributed import context, sharding as S
from repro_torch.distributed.seq_attention import make_seq_sharded_attn
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M, steps
from repro_torch.models import layers as L, registry as R
from repro_torch.models.config import ShapeCell

inp = dict(np.load(os.path.join(d, "inputs.npz")))
T = lambda a: torch.from_numpy(np.array(a))
out = {}
moe_cfg = R.get("qwen3-30b-a3b", reduced=True, capacity_factor=1.0).config
moe_p = unflatten(inp, "moe/p/", T)
for shape in [s for s in MESHES if s[0] * s[1] == world]:
    mesh = M.bind(M.make_mesh(shape, ("data", "model")), "cpu")
    t = tag(shape)
    rows = ("data", None, None)
    # sequence-sharded attention, and this rank's partial
    q, k, v = (S.shard_tensor(T(inp[f"attn/{n}"]), spec, mesh)
               for n, spec in (("q", rows), ("k", ("data", "model", None,
                                                   None)),
                               ("v", ("data", "model", None, None))))
    lengths = S.shard_tensor(T(inp["attn/lengths"]), ("data",), mesh)
    o = make_seq_sharded_attn(mesh)(q, k, v, lengths)
    out[f"attn/{t}"] = S.gather_tensor(o, rows, mesh).numpy()
    start = mesh.coord("model") * k.shape[1]
    local = (lengths - start).clamp(0, k.shape[1]).to(torch.int32)
    acc, l, m = ops.attention_decode_partial(q, k, v, local)
    for n, x in (("acc", acc), ("l", l), ("m", m), ("local", local)):
        out[f"attn/{t}/{n}"] = x.numpy()
    # the MoE layer: this rank's experts, its data shard of the tokens
    dsize = mesh.shape["data"]
    p = dict(moe_p, **{n: S.shard_tensor(moe_p[n], ("model", None, None),
                                         mesh)
                       for n in ("w_up", "w_gate", "w_down")})
    x = T(inp["moe/x"])
    x = S.shard_tensor(x, ("data", None), mesh) if dsize > 1 else x
    with context.use_mesh(mesh, local_batch=dsize > 1):
        y = L.apply_moe(p, x, moe_cfg)
    out[f"moe/{t}"] = (S.gather_tensor(y, ("data", None), mesh)
                       if dsize > 1 else y).numpy()
    for arch in ARCHS:
        entry = R.get(arch, reduced=True)
        vocab = entry.config.vocab
        tp = mesh.shape["model"]
        params = unflatten(inp, f"{arch}/p/", T)
        cell, _ = steps.build_cell(entry, mesh,
                                   ShapeCell("p", 64, 4, "prefill"))
        logits, cache = cell.gather(cell(params, {"tokens": T(
            inp[f"{arch}/tok64"])}))
        out[f"{arch}/{t}/prefill_logits"] = logits.numpy()
        out[f"{arch}/{t}/prefill_k"] = cache.k.numpy()
        out[f"{arch}/{t}/prefill_v"] = cache.v.numpy()
        for seqsh in ([True, False] if shape == (1, 2) else [True]):
            cell, _ = steps.build_cell(entry, mesh,
                                       ShapeCell("d", 64, 4, "decode"),
                                       seq_sharded_attn=seqsh)
            params_l = S.shard_tree(params, cell.in_specs[0], mesh)
            batch = cell.in_specs[2] + (None,)
            if seqsh:
                # the 40-token prompt into a 64-deep cache, sharded
                prefill = steps.make_prefill_step(
                    entry, tp, mesh, max_seq=64,
                    shape=ShapeCell("p", 64, 4, "prefill"))
                logits, cache = prefill(params_l, {"tokens": S.shard_tensor(
                    T(inp[f"{arch}/tok40"]), batch, mesh)})
                out[f"{arch}/{t}/prefill40_logits"] = S.gather_tensor(
                    logits, batch, mesh).numpy()
                out[f"{arch}/{t}/prefill40_k"] = S.gather_tree(
                    cache, cell.in_specs[1], mesh).k.numpy()
            # the decode loop starts where the reference's does: its
            # unsharded prefill's cache and first token
            _, cache, tok = cell.shard(params, type(cache)(*(
                T(inp[f"{arch}/cache0_{n}"]) for n in ("k", "v",
                                                       "lengths"))),
                T(inp[f"{arch}/first"]))
            key = f"{arch}/{t}/serve_{'seq' if seqsh else 'gather'}"
            toks, logs = [], []
            for _ in range(STEPS):
                logits, cache = cell.step(params_l, cache, tok)
                tok = logits[:, :vocab].argmax(-1).to(torch.int32)
                toks.append(S.gather_tensor(tok, batch[:1], mesh).numpy())
                logs.append(S.gather_tensor(logits, batch, mesh).numpy())
            out[key + "_tokens"] = np.stack(toks)
            out[key + "_logits"] = np.stack(logs)
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
    """Weights (the reference's init) and inputs, with the reference's
    unsharded prefill of the 40-token prompt for the serve loops."""
    rng = np.random.default_rng(0)
    inp = {}
    a = ATTN
    inp["attn/q"] = rng.standard_normal((a["b"], a["hq"], a["d"]),
                                        dtype=np.float32)
    for n in ("k", "v"):
        inp[f"attn/{n}"] = rng.standard_normal(
            (a["b"], SEQ, a["hkv"], a["d"]), dtype=np.float32)
    inp["attn/lengths"] = np.array(a["lengths"], np.int32)
    mcfg = JR.get("qwen3-30b-a3b", reduced=True, capacity_factor=1.0).config
    inp.update(_flatten(JL.init_moe(jax.random.PRNGKey(1), mcfg,
                                    jnp.float32), "moe/p/"))
    inp["moe/x"] = rng.standard_normal((MOE_TOKENS, mcfg.d_model),
                                       dtype=np.float32)
    for arch in ARCHS:
        entry = JR.get(arch, reduced=True)
        cfg = entry.config
        # the same padded shapes at tp 2 and 4, so one set of weights
        assert cfg.padded_heads(2) == cfg.padded_heads(4)
        assert cfg.padded_vocab(2) == cfg.padded_vocab(4)
        params = entry.module.init(jax.random.PRNGKey(0), cfg, 2)
        inp.update(_flatten(params, f"{arch}/p/"))
        inp[f"{arch}/tok64"] = rng.integers(0, cfg.vocab, (BATCH, SEQ),
                                            dtype=np.int32)
        tok40 = rng.integers(0, cfg.vocab, (BATCH, PROMPT), dtype=np.int32)
        inp[f"{arch}/tok40"] = tok40
        logits, cache = jax.jit(lambda p, t: JT.prefill(
            p, cfg, t, tp=2, max_seq=SEQ))(params, jnp.asarray(tok40))
        inp[f"{arch}/prefill40"] = np.asarray(logits)
        inp[f"{arch}/first"] = np.asarray(
            jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32))
        for n, x in zip(("k", "v", "lengths"), cache):
            inp[f"{arch}/cache0_{n}"] = np.asarray(x)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
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


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_seq_sharded_attention_matches_reference(runs, shape):
    inp, ref, port = runs
    t, world = _tag(shape), shape[0] * shape[1]
    empty = 0
    for r in range(world):
        got = port[(world, r)]
        _close(got[f"attn/{t}"], ref[f"attn/{t}"], TIGHT)
        # this rank's partial against the reference's core on its shard
        dc, mc = divmod(r, shape[1])
        bl, sl = ATTN["b"] // shape[0], SEQ // shape[1]
        rows, cols = slice(dc * bl, (dc + 1) * bl), slice(mc * sl,
                                                          (mc + 1) * sl)
        local = got[f"attn/{t}/local"]
        valid = np.arange(sl)[None, :] < local[:, None]
        want = JL.decode_attention_core(
            jnp.asarray(inp["attn/q"][rows]),
            jnp.asarray(inp["attn/k"][rows, cols]),
            jnp.asarray(inp["attn/v"][rows, cols]), jnp.asarray(valid))
        for n, w in zip(("acc", "l", "m"), want):
            _close(got[f"attn/{t}/{n}"], np.asarray(w), TIGHT)
        glob = inp["attn/lengths"][rows]
        empty += int(((local == 0) & (glob > 0)).sum())
    assert empty > 0          # some lane's local shard held nothing


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cell_matches_reference(runs, arch, shape):
    """``build_cell``'s prefill (a 64-token prompt), and
    ``make_prefill_step`` of a 40-token prompt into a 64-deep cache."""
    _, ref, port = runs
    key = f"{arch}/{_tag(shape)}"
    for r in range(shape[0] * shape[1]):
        for n in ("prefill_logits", "prefill_k", "prefill_v",
                  "prefill40_logits", "prefill40_k"):
            _close(port[(shape[0] * shape[1], r)][f"{key}/{n}"],
                   ref[f"{key}/{n}"], TOL)


def _serve_case(runs, arch, shape, mode):
    _, ref, port = runs
    key = f"{arch}/{_tag(shape)}/serve_{mode}"
    for r in range(shape[0] * shape[1]):
        got = port[(shape[0] * shape[1], r)]
        np.testing.assert_array_equal(got[key + "_tokens"],
                                      ref[key + "_tokens"])
        _close(got[key + "_logits"], ref[key + "_logits"], TOL)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cell_greedy_tokens_match_reference(runs, arch, shape):
    _serve_case(runs, arch, shape, "seq")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cell_without_seq_sharded_attention(runs, arch):
    """At (1, 2) the cache shards are gathered before the attention."""
    _serve_case(runs, arch, (1, 2), "gather")


def _dropped(p, x, cfg, nx):
    """(port, reference) masks of the (token, k) pairs past capacity,
    with each of ``nx`` chunks ranking its own pairs."""
    t = x.shape[0]
    tl, e, k = t // nx, cfg.num_experts, cfg.topk
    c = TL.moe_capacity(tl, e, k, cfg.capacity_factor)
    _, experts = TL._route({"router": torch.tensor(p["router"])},
                           torch.tensor(x), cfg)
    port = np.concatenate([
        TL._local_ranks(ch.reshape(-1), tl * k, e).numpy() >= c
        for ch in experts.reshape(nx, tl, k)])
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
    _, jexp = jax.lax.top_k(probs, k)
    ref = np.concatenate([
        np.asarray(JL._local_ranks(ch.reshape(-1), tl * k, e)) >= c
        for ch in jexp.reshape(nx, tl, k)])
    return port, ref


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_moe_expert_parallel_matches_reference(runs, shape):
    inp, ref, port = runs
    t = _tag(shape)
    for r in range(shape[0] * shape[1]):
        _close(port[(shape[0] * shape[1], r)][f"moe/{t}"], ref[f"moe/{t}"],
               TIGHT)
    cfg = TR.get("qwen3-30b-a3b", reduced=True, capacity_factor=1.0).config
    p = {"router": inp["moe/p/router"]}
    got, want = _dropped(p, inp["moe/x"], cfg, shape[0])
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0      # capacity binds: some pairs are dropped


def test_waiting_families_raise_their_item():
    mesh = TM.make_mesh((1, 2), ("data", "model"))
    cell = ShapeCell("d", 64, 4, "decode")
    for arch in ("rwkv6-7b", "recurrentgemma-9b", "whisper-small"):
        entry = TR.get(arch, reduced=True)
        with pytest.raises(ValueError, match="item 11"):
            TSTEPS.make_serve_step(entry, 2, mesh, shape=cell)
        with pytest.raises(ValueError, match="item 11"):
            TSTEPS.build_cell(entry, mesh, cell)
    with pytest.raises(ValueError, match="item 10"):
        TSTEPS.build_cell(TR.get("yi-6b", reduced=True), mesh,
                          ShapeCell("t", 64, 4, "train"))


def test_mesh_description_runs_the_sharded_program_in_one_process(runs):
    """Under a mesh that is a description only, the port runs the whole
    sharded program in this process: the MoE layer takes the reference's
    expert-parallel form with its per-chunk capacities (every model
    rank's part in turn), so the (2, 2) results hold here too."""
    from repro_torch.distributed import context
    from repro_torch.models import transformer as TT
    inp, ref, _ = runs
    mesh = TM.make_mesh((2, 2), ("data", "model"))
    tensor = lambda a: torch.from_numpy(np.array(a))   # noqa: E731
    cfg = TR.get("qwen3-30b-a3b", reduced=True, capacity_factor=1.0).config
    p = {n: tensor(inp[f"moe/p/{n}"]) for n in ("router", "w_up", "w_gate",
                                                 "w_down")}
    with context.use_mesh(mesh):
        y = TL.apply_moe(p, tensor(inp["moe/x"]), cfg)
    _close(y.numpy(), ref["moe/2x2"], TIGHT)
    arch = "qwen3-30b-a3b"
    entry = TR.get(arch, reduced=True)
    prefix = f"{arch}/p/"
    params = {}
    for key, val in inp.items():
        if key.startswith(prefix):
            node, parts = params, key[len(prefix):].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = tensor(val)
    cache = TT.KVCache(*(tensor(inp[f"{arch}/cache0_{n}"])
                         for n in ("k", "v", "lengths")))
    tok, toks = tensor(inp[f"{arch}/first"]), []
    with context.use_mesh(mesh):
        for _ in range(STEPS):
            logits, cache = TT.decode_step(params, entry.config, tok, cache,
                                           tp=2)
            tok = logits[:, :entry.config.vocab].argmax(-1).to(torch.int32)
            toks.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(toks),
                                  ref[f"{arch}/2x2/serve_seq_tokens"])
    _close(logits.numpy(), ref[f"{arch}/2x2/serve_seq_logits"][-1], TOL)
