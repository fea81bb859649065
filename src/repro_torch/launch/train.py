"""Training driver: data pipeline -> train step -> checkpoints (port of
``repro.launch.train``).

* the train step of ``launch.steps`` (autograd through the model's
  ``loss``, AdamW written in place), optional int8 error-feedback
  gradient compression; under a mesh (``mesh_shape`` / ``--data``,
  ``--model``) the sharded step of a train ``Cell``: tensor-parallel
  parameter shards over "model", data-parallel gradients, ZeRO-1
  moments over the data axes, and FSDP where the residency rule asks;
* fault tolerance: atomic step-tagged checkpoints (async), resume from
  the latest, and a bounded retry of a step that raised (a failed step
  changes nothing, see ``launch.steps``; under a mesh of more than one
  rank a failed step raises, as the ranks could not agree to retry it);
* straggler mitigation hook: a per-step wall-time EMA; steps slower than
  ``straggler_factor`` x EMA are logged and counted;
* deterministic restart: the TokenPipeline is a pure function of (seed,
  step, shard), so a resumed run replays the exact token stream.
  Checkpoints keep the reference's mesh-independent layout: saving
  gathers full leaves, restoring reads full leaves and cuts this rank's
  shards, so a run resumes on another mesh, and in the other package.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch yi-6b --steps 4 --global-batch 2 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --full \\
      --arch stablelm-3b --steps 8 --global-batch 8 --seq 512
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
      --arch qwen3-30b-a3b --data 2 --model 2 --steps 4 --seq 32

Runs on the CUDA card by default (``--device cpu`` runs on the host);
the reduced config is the default and ``--full`` trains the published
widths.  A mesh of more than one rank runs one process per rank: if
``torch.distributed`` is initialised the caller chose its backend;
otherwise the process group is initialised from the environment that
``torch.distributed.run`` sets (NCCL with one card per ``LOCAL_RANK``;
gloo with ``--device cpu``).  Rank 0 prints and saves.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import bind, make_mesh
from repro_torch.launch.steps import build_cell, make_train_step
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.config import ShapeCell
from repro_torch.optim import adamw as axw


class StragglerDetector:
    """Per-step wall-time EMA; flags steps slower than factor x EMA."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.1):
        self.factor = factor
        self.alpha = alpha
        self.ema: Optional[float] = None
        self.events = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        if slow:
            self.events += 1
        return slow


def model_batch(cfg, data: TokenPipeline, step: int) -> dict:
    """Step ``step``'s batch as the model takes it: tokens and labels; the
    VLM's tokens become one-hot embeds of ``tokens % d_model`` (the
    frontend stub, in the config's dtype, where the reference passes
    float32 into its promoting matmuls: the values are 0 and 1 either
    way); the audio family gets zero frames."""
    batch = {k: v for k, v in data.batch_at(step).items()
             if k in ("tokens", "labels")}
    if cfg.family == "vlm":
        eye = np.eye(cfg.d_model, dtype=np.float32)
        emb = torch.from_numpy(eye[batch["tokens"] % cfg.d_model])
        batch = {"embeds": emb.to(L._dtype(cfg.dtype)),
                 "labels": batch["labels"]}
    if cfg.family == "audio":
        batch["frames"] = np.zeros(
            (data.local_batch, cfg.encoder_frames, cfg.d_model), np.float32)
    return batch


def _process_group(mesh_shape, device) -> Tuple[torch.device, bool]:
    """(this rank's device, whether the group was initialised here).
    An initialised group is the caller's; otherwise the environment of
    ``torch.distributed.run`` names the rank and world."""
    if dist.is_initialized():
        dev = resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev, False
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        n = int(np.prod(mesh_shape))
        raise RuntimeError(
            f"mesh {tuple(mesh_shape)} needs {n} ranks and there is no "
            f"process group: launch one process per rank with `python -m "
            f"torch.distributed.run --standalone --nproc-per-node {n} -m "
            f"repro_torch.launch.train ...`, or initialise "
            f"torch.distributed before calling train()")
    dev = resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev, True


def train(arch: str, *, steps: int, global_batch: int, seq: int,
          ckpt_dir: Optional[str], save_every: int = 20,
          reduced: bool = True, compress_grads: bool = False,
          mesh_shape=(1, 1), log_every: int = 10, resume: bool = True,
          max_retries: int = 2, seed: int = 0,
          stop_step: Optional[int] = None, device="cuda") -> dict:
    """``steps`` fixes the schedule horizon; ``stop_step`` (if set) halts
    the loop early: a resumed run with the same ``steps`` then replays
    the identical trajectory (exact-resume invariant).  Besides the
    reference's results, returns ``losses`` and ``step_s`` (each step's
    wall time, ended by reading its loss, which waits for the card).
    Under a mesh (``mesh_shape`` other than (1, 1), or an initialised
    process group) every rank calls this and gets the same results."""
    entry = registry.get(arch, reduced=True) if reduced \
        else registry.get(arch)
    cfg = entry.config
    ocfg = axw.AdamWConfig(total_steps=max(steps, 10),
                           warmup_steps=min(20, steps),
                           compress_grads=compress_grads)
    meshed = tuple(mesh_shape) != (1, 1) or dist.is_initialized()
    created, rank, cell = False, 0, None
    try:
        if meshed:
            dev, created = _process_group(mesh_shape, device)
            rank = dist.get_rank()
            mesh = bind(make_mesh(mesh_shape, ("data", "model")), dev.type)
            tp = mesh.shape["model"]
            cell, _ = build_cell(entry, mesh, ShapeCell(
                "train", seq, global_batch, "train"), ocfg=ocfg)
            step_fn = cell.step
        else:
            dev, tp = resolve(device), 1
            step_fn = make_train_step(entry, ocfg)
        return _loop(entry, cfg, ocfg, cell, step_fn, dev, tp, rank,
                     steps=steps, global_batch=global_batch, seq=seq,
                     ckpt_dir=ckpt_dir, save_every=save_every,
                     log_every=log_every, resume=resume,
                     max_retries=0 if meshed and dist.get_world_size() > 1
                     else max_retries, seed=seed, stop_step=stop_step)
    finally:
        if created:
            dist.destroy_process_group()


def _loop(entry, cfg, ocfg, cell, step_fn, dev, tp: int, rank: int, *,
          steps, global_batch, seq, ckpt_dir, save_every, log_every,
          resume, max_retries, seed, stop_step) -> dict:
    """The training loop; ``cell`` is the train Cell under a mesh (each
    rank holds its shards), None for the one-rank step."""
    def say(msg):
        if rank == 0:
            print(msg)

    if cell is None:
        params = entry.module.init(cfg, device=dev, seed=seed)
        opt_state = axw.init(params, ocfg)
    else:
        meta = entry.module.init(cfg, tp, device="meta")
        params = sh.shard_tree(entry.module.init(cfg, tp, device=dev,
                                                 seed=seed),
                               cell.in_specs[0], cell.mesh)
        opt_state = sh.local_zeros(axw.init(meta, ocfg), cell.in_specs[1],
                                   cell.mesh, dev)

    def full_state():
        if cell is None:
            return {"params": params, "opt": opt_state}
        p, o, _ = cell.gather((params, opt_state, None))
        return {"params": p, "opt": o}

    mgr = CheckpointManager(ckpt_dir, keep=3, async_save=True) \
        if ckpt_dir else None
    start = 0
    if mgr and resume:
        like = {"params": params, "opt": opt_state} if cell is None else \
            {"params": meta, "opt": axw.init(meta, ocfg)}
        latest, tree, extra = mgr.restore_latest(like, device=dev)
        if latest is not None:
            params, opt_state = tree["params"], tree["opt"]
            if cell is not None:
                params, opt_state, _ = cell.shard(params, opt_state, None)
            del tree
            start = int(extra.get("next_step", latest))
            say(f"[train] resumed from step {latest} -> next {start}")

    def save(step, loss):
        tree = full_state()
        if rank == 0:
            mgr.save(step, tree, extra={"next_step": step, "loss": loss})

    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=global_batch, seed=seed))
    strag = StragglerDetector()
    losses: List[float] = []
    step_s: List[float] = []
    t_start = time.perf_counter()
    end = min(stop_step, steps) if stop_step is not None else steps
    for step in range(start, end):
        batch = model_batch(cfg, data, step)
        if cell is not None:
            _, _, batch = cell.shard(None, None, batch)
        t0 = time.perf_counter()
        for attempt in range(max_retries + 1):
            try:       # bounded retry: transient host/infra failures
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                break
            except Exception:
                if attempt == max_retries:
                    raise
                say(f"[train] step {step} attempt {attempt} failed; "
                    f"retrying")
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        step_s.append(dt)
        if strag.observe(dt):
            say(f"[train] straggler: step {step} took {dt * 1e3:.0f}ms "
                f"(ema {strag.ema * 1e3:.0f}ms)")
        losses.append(loss)
        if step % log_every == 0:
            say(f"[train] step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"{dt * 1e3:.0f}ms")
        if mgr and (step + 1) % save_every == 0:
            save(step + 1, loss)
    if mgr:
        save(end, losses[-1])
        mgr.wait()
        if cell is not None:        # every rank resumes from what is saved
            dist.barrier()
    wall = time.perf_counter() - t_start
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "steps": len(losses), "wall_s": wall,
            "straggler_events": strag.events,
            "losses": losses, "step_s": step_s}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", choices=registry.ARCH_IDS
                    + registry.EXTRA_ARCH_IDS, default="yi-6b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: reduced)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the host)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    out = train(args.arch, steps=args.steps, global_batch=args.global_batch,
                seq=args.seq, ckpt_dir=args.ckpt_dir,
                save_every=args.save_every, reduced=not args.full,
                compress_grads=args.compress_grads,
                mesh_shape=(args.data, args.model), device=args.device)
    if int(os.environ.get("RANK", 0)) == 0:
        print(f"[train] done: {out}")
    return out


if __name__ == "__main__":
    main()
