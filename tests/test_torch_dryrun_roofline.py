"""The port's dry run and roofline (``launch.dryrun``,
``analysis.roofline``) against the reference's, and its counts against
what the port's steps really do.

* the ring formulas equal the reference's HLO parser on synthetic lines
  (all five ops at 2, 4 and 16 ranks), exactly;
* ``model_flops_for`` equals the reference's for every arch id and
  shape (rel 1e-12);
* counted = issued: the collectives one rank's program records under
  ``mesh.simulate`` on meta tensors equal those the same cell issues on
  4 CPU ``gloo`` ranks at mesh (2, 2), op by op in count and bytes
  (reduced yi-6b and qwen3-30b-a3b serve cells, a reduced stablelm-3b
  train cell, and the same train cell under FSDP);
* meta = CPU: the FLOPs and bytes counted on meta tensors equal the
  counts of the same step run on CPU tensors;
* calibration: the extrapolation from ``L0`` and ``2*L0`` layers equals
  the full count at reduced depth;
* the argument bytes are the shard sizes ``sharding.shard_tree`` gives;
* the CLI prints ``OK`` for one cell per mesh kind
  (``REPRO_DRYRUN_DEVICES=8``) and the reference's ``SKIP`` for a
  full-attention ``long_500k`` cell;
* ``launch.schedule_explorer`` prints the reference script's text.
"""
import contextlib
import io
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import roofline as JRL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro_torch.analysis import roofline as TRL  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun, schedule_explorer, steps  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeCell  # noqa: E402
from repro_torch.optim import adamw as axw  # noqa: E402
from test_torch_distributed import _free_port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 2)
SEQ, BATCH = 32, 4
SERVE = ShapeCell("d", SEQ, BATCH, "decode")
TRAIN = ShapeCell("t", SEQ, BATCH, "train")
#: (name, arch, shape, fsdp) of the counted = issued cells
CELLS = [("yi-6b serve", "yi-6b", SERVE, None),
         ("qwen3-30b-a3b serve", "qwen3-30b-a3b", SERVE, None),
         ("stablelm-3b train", "stablelm-3b", TRAIN, None),
         ("stablelm-3b train fsdp", "stablelm-3b", TRAIN, True)]
TIMEOUT = 300


# ---------------------------------------------------------------------------
# the reference's formulas
# ---------------------------------------------------------------------------
_HLO_OPS = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute"]


@pytest.mark.parametrize("p", [2, 4, 16])
def test_ring_wire_bytes_equal_reference_parser(p):
    lines, want = [], 0
    for i, op in enumerate(_HLO_OPS):
        dims, dt, esize = (64 * (i + 1), 24), ("f32", "bf16")[i % 2], \
            (4, 2)[i % 2]
        groups = "" if op == "collective-permute" else \
            f", replica_groups=[{64 // p},{p}]<=[64]"
        lines.append(f"%c{i} = {dt}[{dims[0]},{dims[1]}]{{1,0}} "
                     f"{op}(%x{i}){groups}")
        payload = dims[0] * dims[1] * esize
        want += TRL.ring_wire_bytes(op, payload, p)
        one = JRL.parse_collectives(lines[-1], 64)
        assert one.wire_bytes == TRL.ring_wire_bytes(op, payload, p), op
        assert one.bytes_by_op == {op: payload}
    prof = JRL.parse_collectives("\n".join(lines), 64)
    assert prof.count == len(_HLO_OPS) and prof.wire_bytes == want
    # the port's own broadcast: every receiving rank takes the payload
    assert TRL.ring_wire_bytes("broadcast", 1000, p) == 1000


@pytest.mark.parametrize("arch", TR.ARCH_IDS + TR.EXTRA_ARCH_IDS)
def test_analytic_counts_equal_reference(arch):
    jcfg, tcfg = JR.get_config(arch), TR.get_config(arch)
    for name in SHAPES:
        assert TRL.model_flops_for(tcfg, SHAPES[name]) == pytest.approx(
            JRL.model_flops_for(jcfg, JSHAPES[name]), rel=1e-12)


def test_roofline_terms_on_the_h100_datasheet():
    prof = dryrun._profile(dryrun._tally(
        [C.Issued("all-reduce", 1000, 4, "x", 500)], "op"))
    rep = TRL.RooflineReport("a", "s", "m", 4, 989e12, 3.35e12, prof,
                             memory_stats={"fits_h100_80gb": True})
    d = rep.to_dict()
    assert d["t_compute_s"] == pytest.approx(1.0)
    assert d["t_memory_s"] == pytest.approx(1.0)
    assert d["t_collective_s"] == pytest.approx(1500 / 450e9)
    assert set(d) == {"arch", "shape", "mesh", "devices", "flops_per_device",
                      "hbm_bytes_per_device", "collective_wire_bytes",
                      "collective_by_op", "collective_count", "t_compute_s",
                      "t_memory_s", "t_collective_s", "bottleneck",
                      "model_flops", "useful_flops_fraction",
                      "memory_stats"}
    assert TRL.HBM_GB == 80.0


# ---------------------------------------------------------------------------
# the recording mesh
# ---------------------------------------------------------------------------
def test_simulated_mesh_holds_a_rank_without_a_process_group():
    mesh = M.make_mesh((2, 2, 4), ("pod", "data", "model"))
    sim = M.simulate(mesh, rank=13)
    assert sim.bound and sim == mesh
    assert sim.coords == {"pod": 1, "data": 1, "model": 1}
    assert sim.coord(("pod", "data")) == 3
    assert sim.group("model").size == 4
    assert sim.group(("pod", "data")).size == 4
    assert sim.group(("pod", "data", "model")).size == 16
    with pytest.raises(ValueError):
        M.simulate(mesh, rank=16)
    with pytest.raises(TypeError):
        M.bind(mesh)                     # the device type is required
    x = torch.ones(3, 2, dtype=torch.bfloat16)
    with C.recording() as calls:
        y = C.all_gather(C.all_reduce(x, sim, "model"), sim, "model", 0)
        z = C.broadcast(x, sim, ("pod", "data"), 1)
    assert y.shape == (12, 2) and z.shape == x.shape
    assert y.dtype == z.dtype == torch.bfloat16
    # float32 on the wire; an all-gather's payload is its gathered output
    assert [(c.op, c.nbytes, c.group, c.dtype_nbytes) for c in calls] == [
        ("all-reduce", 24, 4, 12), ("all-gather", 96, 4, 48),
        ("broadcast", 24, 4, 12)]
    with C.recording() as calls:
        C.all_reduce(torch.empty(5, device="meta"), sim, "data")
    assert calls[0].nbytes == 20


RANK_SCRIPT = r'''
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from repro_torch.distributed import collectives as C
from repro_torch.launch import mesh as M, steps
from repro_torch.models import registry as R
from repro_torch.models.config import ShapeCell
from repro_torch.optim import adamw as axw
CELLS = json.loads(sys.argv[5])
mesh = M.bind(M.make_mesh((2, 2), ("data", "model")), "cpu")
logs = {}
for name, arch, shape, fsdp in CELLS:
    shape = ShapeCell(*shape)
    entry = R.get(arch, reduced=True)
    cfg, tp = entry.config, mesh.shape["model"]
    cell, _ = steps.build_cell(entry, mesh, shape, ocfg=axw.AdamWConfig(),
                               fsdp=fsdp)
    params = entry.module.init(cfg, tp, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    if shape.kind == "train":
        toks = torch.randint(0, cfg.vocab, (shape.global_batch,
                                            shape.seq_len), generator=gen,
                             dtype=torch.int32)
        full = (params, axw.init(params, axw.AdamWConfig()),
                {"tokens": toks, "labels": toks})
    else:
        cache = entry.cache_zeros(shape.global_batch, shape.seq_len, tp,
                                  device="cpu")
        cache = cache._replace(lengths=torch.full_like(cache.lengths, 5))
        full = (params, cache, torch.randint(0, cfg.vocab,
                                             (shape.global_batch,),
                                             generator=gen,
                                             dtype=torch.int32))
    local = cell.shard(*full)
    with C.recording() as calls:
        cell.step(*local)
    logs[name] = [[c.op, c.nbytes, c.group, c.site] for c in calls]
json.dump(logs, open(f"{out}/rank{rank}.json", "w"))
dist.barrier()
dist.destroy_process_group()
print("RANK DONE", rank)
'''


def _cells_arg():
    return json.dumps([[n, a, [s.name, s.seq_len, s.global_batch, s.kind],
                        f] for n, a, s, f in CELLS])


@pytest.fixture(scope="module")
def issued(tmp_path_factory):
    """Each gloo rank's log of the collectives every cell issued."""
    d = str(tmp_path_factory.mktemp("issued"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    port, world = _free_port(), MESH[0] * MESH[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world), str(port),
         d, _cells_arg()], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    failed = []
    for r, proc in enumerate(procs):
        try:
            log, _ = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"rank {r} (exit {proc.returncode}):\n"
                          f"{log[-4000:]}")
    assert not failed, "\n".join(failed)
    return [json.load(open(os.path.join(d, f"rank{r}.json")))
            for r in range(world)]


@pytest.mark.parametrize("name,arch,shape,fsdp", CELLS,
                         ids=[c[0] for c in CELLS])
def test_counted_collectives_equal_the_issued_ones(issued, name, arch,
                                                    shape, fsdp):
    entry = TR.get(arch, reduced=True)
    for rank, logs in enumerate(issued):
        mesh = M.simulate(M.make_mesh(MESH, ("data", "model")), rank)
        got = dryrun.count_cell(entry, mesh, shape, fsdp=fsdp)
        counted = [[c.op, c.nbytes, c.group, c.site]
                   for c in got["collectives"]]
        assert counted == logs[name], (name, rank)
        assert got["fsdp"] == bool(fsdp)
    # per op: the same count and bytes the roofline reports
    prof = dryrun._profile(dryrun._tally(got["collectives"], "op"))
    for op in {op for op, *_ in issued[0][name]}:
        assert prof.bytes_by_op[op] == sum(
            b for o, b, *_ in issued[0][name] if o == op)
    if fsdp:
        sites = {s for *_, s in issued[0][name]}
        assert {"gather_shards", "gather_shards.backward"} <= sites


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------
def _full_args(cell, args, device):
    """Real CPU tensors (zeros) in the stand-ins' shapes."""
    def real(t):
        if t is None:
            return None
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    return tuple(sh.tree_map(real, a) for a in args)


@pytest.mark.parametrize("arch,shape", [
    ("yi-6b", SERVE), ("qwen3-30b-a3b", ShapeCell("p", SEQ, BATCH,
                                                   "prefill")),
    ("rwkv6-7b", ShapeCell("p", SEQ, BATCH, "prefill")),
    ("stablelm-3b", TRAIN)], ids=["yi-6b serve", "qwen3 prefill",
                                  "rwkv6 prefill", "stablelm train"])
def test_meta_count_equals_the_cpu_count(arch, shape):
    entry = TR.get(arch, reduced=True)
    mesh = M.simulate(M.make_mesh(MESH, ("data", "model")))
    cell, args = steps.build_cell(entry, mesh, shape, ocfg=axw.AdamWConfig())
    meta = TRL.count_step(cell.step, *cell.shard(*args))
    cell, args = steps.build_cell(entry, mesh, shape, ocfg=axw.AdamWConfig())
    cpu = TRL.count_step(cell.step, *cell.shard(*_full_args(cell, args,
                                                            "cpu")))
    assert meta.aten_flops == cpu.aten_flops > 0
    assert meta.aten_bytes == cpu.aten_bytes > 0
    assert meta.kernels.flops == cpu.kernels.flops
    assert [c.nbytes for c in meta.collectives] == \
        [c.nbytes for c in cpu.collectives]
    if arch == "rwkv6-7b":         # the WKV6 entry, by its formula
        assert meta.kernels.calls == {"wkv6": entry.config.num_layers}


@pytest.mark.parametrize("arch,layers,shape", [
    ("yi-6b", 4, TRAIN), ("yi-6b", 4, SERVE),
    ("recurrentgemma-9b", 6, ShapeCell("p", SEQ, BATCH, "prefill"))],
    ids=["yi-6b train", "yi-6b serve", "recurrentgemma prefill"])
def test_calibration_equals_the_full_count(arch, layers, shape):
    cfg = TR.get(arch, reduced=True).config
    l0 = len(cfg.block_pattern) if cfg.block_pattern else 1
    mesh = M.simulate(M.make_mesh(MESH, ("data", "model")))

    def at(n):
        return dryrun.count_cell(TR.get(arch, reduced=True, num_layers=n),
                                 mesh, shape)
    full = at(layers)
    est = dryrun.extrapolate(at(l0), at(2 * l0), layers / l0)
    for key in ("flops", "kernel_flops", "output", "alias"):
        assert est[key] == pytest.approx(full[key], rel=1e-9), key
    assert est["by_op"] == dryrun._tally(full["collectives"], "op")
    assert est["by_site"] == dryrun._tally(full["collectives"], "site")
    if shape.kind == "train":
        # ZeRO-1 cuts a one-layer stack along another dim than a stack
        # whose depth divides the data axis (the reference's rule), and
        # gathering that strided slice copies it first: the bytes of the
        # L0 count differ from the slope's by those copies
        assert est["bytes"] == pytest.approx(full["bytes"], rel=1e-2)
        assert est["temp"] == pytest.approx(full["temp"], rel=1e-2)
    else:
        assert est["bytes"] == pytest.approx(full["bytes"], rel=1e-9)


def test_argument_bytes_are_the_shard_sizes():
    entry = TR.get("qwen3-30b-a3b", reduced=True)
    mesh = M.simulate(M.make_mesh(MESH, ("data", "model")), rank=3)
    got = dryrun.count_cell(entry, mesh, TRAIN)
    cell, args = steps.build_cell(entry, mesh, TRAIN, ocfg=axw.AdamWConfig())
    want = 0
    for a, s in zip(args, cell.in_specs):
        for _, t in sh.tree_leaves_with_path(sh.shard_tree(a, s, mesh)):
            if t is not None:
                want += t.numel() * t.element_size()
    assert got["argument"] == want


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_counts_a_cell_on_a_single_mesh(tmp_path):
    env = dict(os.environ, REPRO_DRYRUN_DEVICES="8",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "stablelm-3b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=TIMEOUT)
    assert r.returncode == 0 and " OK " in r.stdout, r.stdout + r.stderr
    rec, = json.load(open(tmp_path / "dryrun_single_stablelm-3b_"
                                      "decode_32k.json"))
    assert rec["status"] == "OK" and rec["mesh"] == "single-8"
    assert rec["collective_count"] > 0 and rec["t_memory_s"] > 0
    assert rec["collective_by_op"]["all-gather"] > 0
    ms = rec["memory_stats"]
    assert ms["argument_size_in_bytes"] > 0 and ms["temp_size_in_bytes"] > 0
    assert ms["fits_h100_80gb"] == (ms["total_hbm_bytes"] <= 80 * 2**30)


def test_cli_counts_a_cell_on_a_multi_pod_mesh_and_skips(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    recs = dryrun.main(["--arch", "stablelm-3b", "--shape", "decode_32k",
                        "--mesh", "multi", "--no-calibrate", "--out",
                        str(tmp_path)])
    out = capsys.readouterr().out
    assert recs[0]["status"] == "OK" and recs[0]["mesh"] == "multi-8", out
    assert recs[0]["devices"] == 8 and not recs[0]["calibrated"]
    assert "multi-8" in out and " OK " in out
    recs = dryrun.main(["--arch", "yi-6b", "--shape", "long_500k",
                        "--out", str(tmp_path)])
    assert "SKIP(full-attention" in capsys.readouterr().out
    assert recs[0]["status"].startswith("SKIP(full-attention")


# ---------------------------------------------------------------------------
# the schedule explorer
# ---------------------------------------------------------------------------
def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


@pytest.mark.parametrize("argv", [
    [], ["--model", "LLaMA3-70B", "--batch", "4", "--ctx", "2048", "--tp",
         "4"]], ids=["defaults", "llama3-70b"])
def test_schedule_explorer_prints_the_reference_text(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["schedule_explorer.py"] + argv)
    want = _printed(lambda: runpy.run_path(
        os.path.join(REPO, "examples", "schedule_explorer.py"),
        run_name="__main__"))
    got = _printed(lambda: schedule_explorer.main(argv))
    assert got == want and "partition plan" in got


def test_dryrun_results_default_under_build():
    assert dryrun.RESULTS == os.environ.get("REPRO_DRYRUN_OUT",
                                            "build/dryrun_results")
    assert np.isclose(TRL.PEAK_FLOPS, 989e12)
