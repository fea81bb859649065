"""Quickstart: the two halves of the repo in about a minute (port of
``examples/quickstart.py``).

1. The paper's evaluation stack: schedule one LLaMA3-70B decode step on
   the SNAKE 3D-NMP system against the Stratum-configured MAC-tree
   baseline.
2. The PyTorch half: a reduced yi-6b end to end (one train step, a
   prefill and four decode steps), on the card (``--device cpu`` for the
   host).

  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.hw import mactree_system, snake_system
from repro_torch.core.operators import PAPER_MODELS
from repro_torch.core.pipeline import decode_step
from repro_torch.device import resolve
from repro_torch.launch.steps import make_train_step
from repro_torch.models import registry
from repro_torch.optim import adamw as axw


def nmp_half():
    print("=== 1. NMP substrate study (paper reproduction) ===")
    spec = PAPER_MODELS["LLaMA3-70B"]
    for sys in (snake_system(), mactree_system()):
        rep = decode_step(sys, spec, batch=32, ctx=8704, tp=8)
        print(f"{sys.name:10s} decode step {rep.time_s * 1e3:7.2f} ms "
              f"({rep.tokens_per_s:8.0f} tok/s)  "
              f"logic-die {rep.energy.logic_die_j:6.3f} J  "
              f"modes={rep.mode_histogram()}")
    snake = decode_step(snake_system(), spec, 32, 8704, tp=8)
    mac = decode_step(mactree_system(), spec, 32, 8704, tp=8)
    print(f"SNAKE speedup vs MAC tree: {mac.time_s / snake.time_s:.2f}x  "
          f"(paper avg across models/batches: 2.90x)")


def torch_half(device="cuda") -> list:
    """One train step, a prefill and 4 greedy decode steps of reduced
    yi-6b; returns the decoded tokens (B, 4)."""
    dev = resolve(device)
    print(f"\n=== 2. PyTorch port (reduced yi-6b on {dev.type}) ===")
    entry = registry.get("yi-6b", reduced=True)
    cfg = entry.config
    params = entry.module.init(cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in axw.tree_leaves(params))
    print(f"arch=yi-6b(reduced) params={n_params / 1e6:.1f}M")

    # one train step
    ocfg = axw.AdamWConfig()
    opt = axw.init(params, ocfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    params, opt, metrics = make_train_step(entry, ocfg)(params, opt, batch)
    print(f"train: loss={float(metrics['loss']):.3f} "
          f"grad_norm={float(metrics['grad_norm']):.3f}")

    # prefill + 4 decode steps
    with torch.no_grad():
        prompt = torch.from_numpy(toks[:, :32]).to(dev)
        logits, cache = entry.module.prefill(params, cfg, prompt, tp=1,
                                             max_seq=64)
        tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
        out = []
        for _ in range(4):
            logits, cache = entry.module.decode_step(params, cfg, tok,
                                                     cache, tp=1)
            tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
            out.append(tok.cpu().numpy())
    gen = np.stack(out, 1).tolist()
    print(f"decode: generated {gen}")
    return gen


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the host)")
    args = ap.parse_args(argv)
    nmp_half()
    return torch_half(args.device)


if __name__ == "__main__":
    main()
