"""Multi-pod dry run: count every (arch x shape x mesh) cell on the meta
device (port of ``repro.launch.dryrun``).

For each cell the step's arguments are meta stand-ins
(``steps.assemble_shardings``) cut to one rank's shards, and that
rank's program runs on them under a mesh from ``launch.mesh.simulate``:
nothing holds data, no process group exists, and every collective is
recorded instead of sent.  ``analysis.roofline.count_step`` counts its
FLOPs, bytes, collectives and memory; the record holds the roofline
terms on an NVIDIA H100 80GB HBM3's datasheet figures and whether the
rank's memory fits the card's 80 GB.

Memory (``memory_stats``): the arguments are this rank's shards of the
stand-ins; the temp bytes are the peak of the bytes held by tensors the
step allocated (outputs live at its end included, autograd's saved
tensors too); an output written into an argument's storage (a cache
updated in place, a parameter after the optimizer) is alias bytes.

Calibration: the count covers every loop iteration, so there is no
undercount to correct (the reference calibrates because XLA counts a
scan body once).  ``calibrate`` keeps the reference's method to save
time: count the cell at ``L0`` and ``2*L0`` layers (``L0`` the layer
period: 1, or the hybrid block pattern's length) at full width and
extrapolate every count linearly to the full depth,
``c(L0) + (L/L0 - 1) * (c(2 L0) - c(L0))``, with the full-depth cell's
FSDP choice.  At a depth that is a whole number of periods the FLOPs and
collectives equal the full count, as long as the spec tables cut the
short stacks as they cut the full one: the ZeRO-1 and FSDP rules cut a
stack along its layer dim only when the depth divides the data axes
(else along an inner dim, whose slices are copied before a gather, and
whose FSDP layers are all-gathered rather than broadcast by their
owner).  ``--no-calibrate`` counts such a cell's own program.

Each record also holds ``collective_by_site``: per call site of
``distributed.collectives`` (``all_reduce``, ``gather_shards.backward``,
...) the count, the payload on the wire (float32 for floating tensors),
the ring's wire bytes and the payload in the tensors' own dtypes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi --no-calibrate
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, List

from repro_torch.analysis.roofline import (HBM_GB, CollectiveProfile,
                                           RooflineReport, count_step,
                                           model_flops_for, ring_wire_bytes)
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh, simulate
from repro_torch.models import registry
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.optim import adamw as axw

RESULTS = os.environ.get("REPRO_DRYRUN_OUT", "build/dryrun_results")


def _mesh_for(name: str):
    """(the mesh, simulated at rank 0, and its label): the production
    meshes, or ``(2, n//2)`` / ``(2, 2, n//4)`` for
    ``REPRO_DRYRUN_DEVICES=n``."""
    if os.environ.get("REPRO_DRYRUN_DEVICES"):
        n = int(os.environ["REPRO_DRYRUN_DEVICES"])
        if name == "multi":
            return simulate(make_mesh((2, 2, n // 4),
                                      ("pod", "data", "model"))), \
                f"multi-{n}"
        return simulate(make_mesh((2, n // 2), ("data", "model"))), \
            f"single-{n}"
    if name == "multi":
        return simulate(make_production_mesh(multi_pod=True)), "2x16x16"
    return simulate(make_production_mesh(multi_pod=False)), "16x16"


def _nbytes(args) -> int:
    """Bytes of the tensors in a step's argument trees."""
    return sum(t.numel() * t.element_size() for a in args
               for _, t in sh.tree_leaves_with_path(a) if t is not None)


def count_cell(entry: registry.ArchEntry, mesh, shape,
               seq_sharded: bool = False, microbatch: int = 1,
               prefill_chunk=None, fsdp=None) -> Dict[str, object]:
    """One rank's step of the cell on meta tensors: its counts (flops,
    bytes, kernels, collectives, memory) and the argument bytes."""
    cell, args = steps.build_cell(entry, mesh, shape,
                                  seq_sharded_attn=seq_sharded,
                                  ocfg=axw.AdamWConfig(),
                                  microbatch=microbatch,
                                  prefill_chunk=prefill_chunk, fsdp=fsdp)
    local = cell.shard(*args)
    c = count_step(cell.step, *local)
    return {"flops": c.flops, "bytes": c.bytes,
            "kernel_flops": c.kernels.total_flops,
            "kernel_calls": dict(c.kernels.calls),
            "collectives": c.collectives, "temp": c.peak_bytes,
            "output": c.output_bytes, "alias": c.alias_bytes,
            "argument": _nbytes(local), "fsdp": cell.fsdp is not None}


def _entry_at(arch: str, nl: int) -> registry.ArchEntry:
    cfg = registry.get_config(arch)
    over = {"num_layers": nl}
    if cfg.encoder_layers:
        over["encoder_layers"] = max(1, round(
            cfg.encoder_layers * nl / cfg.num_layers))
    return registry.get(arch, **over)


def _tally(calls, key: str) -> Dict[str, List[int]]:
    """The recorded collectives summed by ``key`` ("op" or "site"):
    ``[count, payload bytes, wire bytes, bytes in the tensors' own
    dtypes]``."""
    out: Dict[str, List[int]] = {}
    for c in calls:
        n, b, w, d = out.get(getattr(c, key), (0, 0, 0, 0))
        out[getattr(c, key)] = [n + 1, b + c.nbytes,
                                w + ring_wire_bytes(c.op, c.nbytes, c.group),
                                d + c.dtype_nbytes]
    return out


def extrapolate(c1: dict, c2: dict, periods: float) -> dict:
    """Every count of ``c1`` (L0 layers) carried to ``periods`` periods
    by the slope ``c2 - c1`` (2 L0 layers); the collectives by op and by
    call site as :func:`_tally` sums them."""
    k = periods - 1
    out = {key: c1[key] + k * (c2[key] - c1[key])
           for key in ("flops", "bytes", "kernel_flops", "temp", "output",
                       "alias")}
    for key in ("op", "site"):
        t1, t2 = _tally(c1["collectives"], key), _tally(c2["collectives"],
                                                        key)
        out["by_" + key] = {
            name: [int(round(a + k * (b - a))) for a, b in zip(
                t1.get(name, [0] * 4), t2.get(name, [0] * 4))]
            for name in set(t1) | set(t2)}
    return out


def _profile(by_op: Dict[str, List[int]]) -> CollectiveProfile:
    prof = CollectiveProfile()
    for op, (n, b, w, _) in sorted(by_op.items()):
        prof.bytes_by_op[op] = b
        prof.wire_bytes += w
        prof.count += n
    return prof


def _memory_stats(argument: int, temp: float, output: float,
                  alias: float) -> dict:
    ms = {"argument_size_in_bytes": int(argument),
          "output_size_in_bytes": int(output),
          "temp_size_in_bytes": int(temp),
          "alias_size_in_bytes": int(alias)}
    ms["total_hbm_bytes"] = ms["argument_size_in_bytes"] \
        + ms["temp_size_in_bytes"]
    ms["fits_h100_80gb"] = ms["total_hbm_bytes"] <= HBM_GB * 2**30
    return ms


def run_cell(arch: str, shape_name: str, mesh_name: str,
             seq_sharded: bool = False, remat: bool = True,
             calibrate: bool = True, microbatch: int = 1,
             prefill_chunk=None) -> dict:
    t0 = time.time()
    cfg = registry.get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": why}
        print(f"[dryrun] {arch:18s} {shape_name:12s} {mesh_name:8s} {why}")
        return rec
    mesh, mesh_label = _mesh_for(mesh_name)
    try:
        if not remat:
            raise ValueError("the port's train step always recomputes "
                             "each block in backward (layers.remat)")
        kw = dict(seq_sharded=seq_sharded, microbatch=microbatch,
                  prefill_chunk=prefill_chunk)
        entry = registry.get(arch)
        if calibrate:
            fsdp = steps.fsdp_by_rule(
                entry.module.init(cfg, mesh.shape["model"], device="meta"),
                mesh, shape.kind)
            L0 = max(1, len(cfg.block_pattern)) if cfg.block_pattern else 1
            c1 = count_cell(_entry_at(arch, L0), mesh, shape, fsdp=fsdp,
                            **kw)
            c2 = count_cell(_entry_at(arch, 2 * L0), mesh, shape,
                            fsdp=fsdp, **kw)
            tot = extrapolate(c1, c2, cfg.num_layers / L0)
            # the arguments at full depth need no run: their stand-ins
            cell, args = steps.build_cell(
                entry, mesh, shape, seq_sharded_attn=seq_sharded,
                ocfg=axw.AdamWConfig(), microbatch=microbatch,
                prefill_chunk=prefill_chunk, fsdp=fsdp)
            argument = _nbytes(cell.shard(*args))
        else:
            tot = count_cell(entry, mesh, shape, **kw)
            fsdp, argument = tot["fsdp"], tot["argument"]
            for key in ("op", "site"):
                tot["by_" + key] = _tally(tot["collectives"], key)
        prof = _profile(tot["by_op"])
        mf = model_flops_for(cfg, shape)
        rep = RooflineReport(
            arch=arch, shape=shape_name, mesh=mesh_label,
            n_devices=mesh.size, flops_per_device=tot["flops"],
            hbm_bytes_per_device=tot["bytes"], collective=prof,
            memory_stats=_memory_stats(argument, tot["temp"],
                                       tot["output"], tot["alias"]),
            model_flops=mf)
        rec = {"status": "OK", "count_s": round(time.time() - t0, 1),
               "seq_sharded_attn": seq_sharded, "calibrated": calibrate,
               "fsdp": bool(fsdp), **rep.to_dict(),
               "kernel_flops_per_device": tot["kernel_flops"],
               # [count, payload, wire, payload in the tensors' dtypes]
               "collective_by_site": tot["by_site"]}
        fits = rep.memory_stats["fits_h100_80gb"]
        print(f"[dryrun] {arch:18s} {shape_name:12s} {mesh_label:10s} OK "
              f"count={rec['count_s']}s bottleneck={rep.bottleneck} "
              f"t=({rep.t_compute:.3e},{rep.t_memory:.3e},"
              f"{rep.t_collective:.3e})s fits80GB={fits}")
    except Exception as e:                      # noqa: BLE001 - report all
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": f"FAIL: {type(e).__name__}: {e}"}
        print(f"[dryrun] {arch:18s} {shape_name:12s} {mesh_name:8s} "
              f"FAILED: {e}")
        traceback.print_exc()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch",
                    choices=registry.ARCH_IDS + registry.EXTRA_ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--seq-sharded-attn", action="store_true",
                    help="combine the context shards' flash-decode "
                         "partials (distributed.seq_attention)")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="Sarathi-style chunked prefill (prefill cells)")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="count the full depth instead of extrapolating "
                         "from L0 and 2*L0 layers")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    calibrate = not args.no_calibrate

    archs = registry.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    out_dir = args.out or RESULTS
    os.makedirs(out_dir, exist_ok=True)
    records = []
    for a in archs:
        for s in shapes:
            records.append(run_cell(a, s, args.mesh,
                                    seq_sharded=args.seq_sharded_attn,
                                    calibrate=calibrate,
                                    microbatch=args.microbatch,
                                    prefill_chunk=args.prefill_chunk))
    tag = f"{args.mesh}_{archs[0] if len(archs) == 1 else 'all'}_" \
          f"{shapes[0] if len(shapes) == 1 else 'all'}"
    if args.seq_sharded_attn:
        tag += "_seqattn"
    path = os.path.join(out_dir, f"dryrun_{tag}.json")
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    print(f"[dryrun] wrote {path}")
    n_ok = sum(1 for r in records if r.get("status") == "OK")
    n_skip = sum(1 for r in records if "SKIP" in str(r.get("status")))
    print(f"[dryrun] {n_ok} OK / {n_skip} skipped / "
          f"{len(records) - n_ok - n_skip} failed of {len(records)}")
    return records


if __name__ == "__main__":
    main()
