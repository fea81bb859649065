"""End-to-end training driver: a small dense LM trained for a few hundred
steps through the whole training path (port of ``examples/train_lm.py``):
the train step, AdamW, atomic checkpoints, resume and straggler
detection.

``--size 10m`` finishes on a host CPU in minutes (``--device cpu``);
``--size 100m`` is the full sizing, for the card.

  PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \\
      --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train_lm --size 100m \\
      --steps 300
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from repro_torch.launch import train as T
from repro_torch.models import registry

SIZES = {
    # ~9.8M params: d=256, 6L, ff=1024, vocab=8192
    "10m": dict(d_model=256, num_layers=6, d_ff=1024, vocab=8192,
                num_q_heads=8, num_kv_heads=4, d_head=32),
    # ~101M params: d=640, 12L, ff=2560, vocab=16384
    "100m": dict(d_model=640, num_layers=12, d_ff=2560, vocab=16384,
                 num_q_heads=10, num_kv_heads=5, d_head=64),
}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train_lm")
    ap.add_argument("--size", choices=list(SIZES), default="10m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="build/train_lm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the host)")
    args = ap.parse_args(argv)

    # a custom-size dense config in the yi-6b (llama-arch) family
    base = registry.get_config("yi-6b")
    cfg = dataclasses.replace(base, name=f"lm-{args.size}",
                              max_seq=args.seq, dtype="float32",
                              **SIZES[args.size])
    entry = registry.from_config(cfg)
    shapes = entry.module.init(cfg, device="meta")
    n = sum(t.numel() for t in T.axw.tree_leaves(shapes))
    print(f"[train_lm] size={args.size}: {n / 1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.global_batch} x seq {args.seq}")

    # resolve the custom name through the registry for the trainer, as
    # the reference does
    orig_get = registry.get

    def patched_get(name, reduced=False, **over):
        if name == cfg.name:
            return entry
        return orig_get(name, reduced=reduced, **over)

    registry.get = patched_get
    try:
        out = T.train(cfg.name, steps=args.steps,
                      global_batch=args.global_batch, seq=args.seq,
                      ckpt_dir=args.ckpt_dir, save_every=50, reduced=False,
                      log_every=10, device=args.device)
    finally:
        registry.get = orig_get
    print(f"[train_lm] loss {out['first_loss']:.3f} -> "
          f"{out['final_loss']:.3f} over {out['steps']} steps "
          f"({out['wall_s']:.0f}s)")
    if not out["final_loss"] < out["first_loss"]:
        raise RuntimeError("loss must decrease")
    return out


if __name__ == "__main__":
    main()
