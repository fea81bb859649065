"""Schedule explorer: walk the paper's §5 scheduling space for any model
(port of ``examples/schedule_explorer.py``; host only, no card).

For a chosen (model, batch, ctx):
  * evaluates all four multi-PU partitioning modes per projection operator
    on the SNAKE system and prints the per-mode times + the winner,
  * shows the partition planner's column/row (OS-S/IS-S) choice and
    collective bytes per GEMM (the reference's TPU-side translation,
    priced with its TPU v5e link rate).

  PYTHONPATH=src python -m repro_torch.launch.schedule_explorer \\
      --model Qwen3-30B-A3B --batch 16 --ctx 8192
"""
from __future__ import annotations

import argparse

from repro_torch.core.hw import snake_system
from repro_torch.core.operators import _ROW_PARALLEL, PAPER_MODELS, layer_ops_tp
from repro_torch.core.schedule import mode_candidates
from repro_torch.distributed import planner


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=list(PAPER_MODELS),
                    default="Qwen3-30B-A3B")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ctx", type=int, default=8192)
    ap.add_argument("--tp", type=int, default=8)
    args = ap.parse_args(argv)

    spec = PAPER_MODELS[args.model]
    sys = snake_system()
    lo = layer_ops_tp(spec, args.batch, args.ctx, args.tp)

    print(f"=== {args.model} batch={args.batch} ctx={args.ctx} tp={args.tp}"
          f" on {sys.name} ===")
    print(f"{'operator':18s} {'M':>5s} {'N':>7s} {'K':>7s} | "
          f"{'IS-S':>8s} {'IS-ST':>8s} {'OS-S':>8s} {'OS-ST':>8s} | best")
    for g in lo.projections:
        if g.count != 1:
            continue
        cands = mode_candidates(sys, g)
        times = {c.mode: c.time_s * 1e6 for c in cands}
        best = min(cands, key=lambda c: c.time_s)
        print(f"{g.name:18s} {g.m:5d} {g.n:7d} {g.k:7d} | "
              + " ".join(f"{times[m]:8.2f}" for m in
                         ("IS-S", "IS-ST", "OS-S", "OS-ST"))
              + f" | {best.mode}")

    print("\n--- TPU partition plan (planner.py: column=OS-S row=IS-S) ---")
    plans = []
    for g in lo.projections:
        if g.count != 1:
            continue
        leaf = g.name.split(".")[-1]
        # reconstruct the full (unsharded) GEMM dims from the per-device op
        if leaf in _ROW_PARALLEL:
            full_n, full_k = g.n, g.k * args.tp
        else:
            full_n, full_k = g.n * args.tp, g.k
        plans.append(planner.plan_projection(
            g.name, g.m, full_n, full_k, args.tp,
            consumer_contracts_n=leaf in ("up_gate", "up")))
    plans.append(planner.plan_decode_attention(
        args.batch, args.ctx, spec.num_q_heads, spec.d_head, args.tp))
    print(planner.describe(plans))


if __name__ == "__main__":
    main()
