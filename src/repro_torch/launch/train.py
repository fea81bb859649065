"""Training driver: data pipeline -> train step -> checkpoints (port of
``repro.launch.train``).

* the train step of ``launch.steps`` (autograd through the model's
  ``loss``, AdamW written in place), optional int8 error-feedback
  gradient compression;
* fault tolerance: atomic step-tagged checkpoints (async), resume from
  the latest, and a bounded retry of a step that raised (a failed step
  changes nothing, see ``launch.steps``);
* straggler mitigation hook: a per-step wall-time EMA; steps slower than
  ``straggler_factor`` x EMA are logged and counted;
* deterministic restart: the TokenPipeline is a pure function of (seed,
  step, shard), so a resumed run replays the exact token stream.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch yi-6b --steps 4 --global-batch 2 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --full \\
      --arch stablelm-3b --steps 8 --global-batch 8 --seq 512

Runs on the CUDA card by default (``--device cpu`` runs on the host);
the reduced config is the default and ``--full`` trains the published
widths.  One card has no mesh: ``--data`` / ``--model`` above 1 are
refused until the distribution slice (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as L
from repro_torch.models import registry
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
    wall time, ended by reading its loss, which waits for the card)."""
    if tuple(mesh_shape) != (1, 1):
        raise ValueError(f"mesh {tuple(mesh_shape)}: one card has no mesh; "
                         f"data and model parallelism come with the "
                         f"distribution slice (ROADMAP queue 1, item 9)")
    dev = resolve(device)
    entry = registry.get(arch, reduced=True) if reduced \
        else registry.get(arch)
    cfg = entry.config
    ocfg = axw.AdamWConfig(total_steps=max(steps, 10),
                           warmup_steps=min(20, steps),
                           compress_grads=compress_grads)
    step_fn = make_train_step(entry, ocfg)

    params = entry.module.init(cfg, device=dev, seed=seed)
    opt_state = axw.init(params, ocfg)

    mgr = CheckpointManager(ckpt_dir, keep=3, async_save=True) \
        if ckpt_dir else None
    start = 0
    if mgr and resume:
        latest, tree, extra = mgr.restore_latest(
            {"params": params, "opt": opt_state}, device=dev)
        if latest is not None:
            params, opt_state = tree["params"], tree["opt"]
            start = int(extra.get("next_step", latest))
            print(f"[train] resumed from step {latest} -> next {start}")

    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=global_batch, seed=seed))
    strag = StragglerDetector()
    losses: List[float] = []
    step_s: List[float] = []
    t_start = time.perf_counter()
    end = min(stop_step, steps) if stop_step is not None else steps
    for step in range(start, end):
        batch = model_batch(cfg, data, step)
        t0 = time.perf_counter()
        for attempt in range(max_retries + 1):
            try:       # bounded retry: transient host/infra failures
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                break
            except Exception:
                if attempt == max_retries:
                    raise
                print(f"[train] step {step} attempt {attempt} failed; "
                      f"retrying")
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        step_s.append(dt)
        if strag.observe(dt):
            print(f"[train] straggler: step {step} took {dt * 1e3:.0f}ms "
                  f"(ema {strag.ema * 1e3:.0f}ms)")
        losses.append(loss)
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt * 1e3:.0f}ms")
        if mgr and (step + 1) % save_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     extra={"next_step": step + 1, "loss": loss})
    if mgr:
        mgr.save(end, {"params": params, "opt": opt_state},
                 extra={"next_step": end, "loss": losses[-1]})
        mgr.wait()
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
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.data, args.model) != (1, 1):
        ap.error(f"--data {args.data} --model {args.model}: one card has no "
                 f"mesh; data and model parallelism come with the "
                 f"distribution slice (ROADMAP queue 1, item 9)")
    out = train(args.arch, steps=args.steps, global_batch=args.global_batch,
                seq=args.seq, ckpt_dir=args.ckpt_dir,
                save_every=args.save_every, reduced=not args.full,
                compress_grads=args.compress_grads, device=args.device)
    print(f"[train] done: {out}")
    return out


if __name__ == "__main__":
    main()
