"""Serving entry point: continuous-batching decode on the port (port of
``repro.launch.serve`` for the flags this slice carries).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --full \
      --paged --prefill-chunk 128 --pallas
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --full --paged --pallas
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-30b-a3b \
      --full --paged --prefill-chunk 128 --pallas --fuse-steps 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --full \
      --paged --prefill-chunk 128 --pallas --fuse-steps 16 \
      --placement affinity --codesign

Runs on the CUDA card by default (``--device cpu`` runs the plain
PyTorch path on the host); the reduced config is the default and
``--full`` serves the published widths.  The ported architectures are
the dense, MoE and VLM-text transformers (every id but two, the extra
Table 1 models included) and rwkv6-7b (ssm); recurrentgemma-9b and
whisper-small are refused with an error naming their slice.  At full
width qwen1.5-110b, opt-66b, llama3-70b, mixtral-8x22b, dbrx-132b and
kimi-k2-1t-a32b do not fit one 80 GB card (nothing is sharded yet).
``--pallas`` routes decode attention through the flash-decode CUDA
kernel (the block-table kernel with ``--paged``) and, for rwkv6-7b, the
recurrence of prefill and decode through the WKV6 CUDA kernel;
``--paged`` switches KV residency to the page pool (``--page-size``,
``--num-pages`` to oversubscribe; a recurrent state stays slot-dense)
and ``--prefill-chunk`` interleaves Sarathi prefill chunks with the
decode batch (attention families only: rwkv6 prefills whole prompts).
``--fuse-steps K`` (with ``--paged``) fuses up to K decode steps per
tick, each power-of-two horizon one CUDA graph on the card (attention
families; rwkv6 decode stays per tick).  ``--prefix-sharing`` (with
``--paged``) adds refcounted prompt-prefix pages with copy-on-write;
``--shared-prefix N`` drives a trace whose prompts share their first N
tokens (``--groups G`` of them, Zipf ``--group-skew`` popularity).
``--placement`` (with ``--paged``) places pages by channel region of the
near-memory substrate model (``--placement-regions`` of them) and
reports the modeled gather cost; ``--codesign`` prices every tick on
the reconfigurable substrate (``--codesign-rows`` a fixed array instead,
``--reconfig-cost`` the modeled charge per reconfiguration) and reports
the modeled throughput beside the wall clock.
``--eos-rate`` samples per-request early-stop decode lengths;
``--trace-file`` replays a recorded JSON trace.

Flags of features that later slices port (multi-replica routing, tiers
and Perfetto export) are accepted by the parser and refused with an
error that names them.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.core.placement import PLACEMENT_POLICIES
from repro_torch.models import registry
from repro_torch.serving.engine import EngineConfig, make_engine
from repro_torch.serving.scheduler import (load_trace,
                                          make_grouped_prefix_trace,
                                          make_shared_prefix_trace,
                                          make_trace)

# flag -> (value that means "not used", the slice that ports it)
UNPORTED = {
    "replicas": (1, "router and tiers"),
    "router_policy": ("round_robin", "router and tiers"),
    "tiers": (None, "router and tiers"),
    "trace_out": (None, "Perfetto export"),
}


# the reference router's dispatch policies (serving/router.py)
ROUTER_POLICIES = ("round_robin", "least_loaded", "session_affinity",
                   "prefix_affinity")


def build_trace(args, vocab: int):
    """The request trace the flags ask for (the reference's selection)."""
    if args.trace_file:
        return load_trace(args.trace_file, vocab=vocab)
    if args.shared_prefix > 0:
        # total prompt length stays --prompt-len: N shared + unique tail
        prefix = min(args.shared_prefix, args.prompt_len - 1)
        if args.groups > 1:
            return make_grouped_prefix_trace(
                vocab, rate_req_s=args.rate, n_requests=args.n_requests,
                n_groups=args.groups, prefix_len=prefix,
                tail_len=args.prompt_len - prefix, skew=args.group_skew,
                eos_rate=args.eos_rate)
        return make_shared_prefix_trace(
            vocab, rate_req_s=args.rate, n_requests=args.n_requests,
            prefix_len=prefix, tail_len=args.prompt_len - prefix,
            eos_rate=args.eos_rate)
    return make_trace(vocab, rate_req_s=args.rate,
                      n_requests=args.n_requests,
                      prompt_len=args.prompt_len, eos_rate=args.eos_rate)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="yi-6b",
                    choices=registry.ARCH_IDS + registry.EXTRA_ARCH_IDS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--pallas", action="store_true",
                    help="the CUDA kernels: flash-decode attention "
                         "(transformers), the WKV6 recurrence (rwkv6-7b)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="Sarathi-style chunked prefill")
    ap.add_argument("--paged", action="store_true",
                    help="block-table paged KV cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size (oversubscribe below the dense-"
                         "equivalent capacity to exercise preemption)")
    ap.add_argument("--defrag-threshold", type=float, default=0.5,
                    help="fragmentation fraction that triggers pool "
                         "defrag (negative disables)")
    ap.add_argument("--eos-rate", type=float, default=None,
                    help="per-step early-stop probability (samples "
                         "per-request decode budgets)")
    ap.add_argument("--trace-file", type=str, default=None,
                    help="replay a recorded JSON trace "
                         "(serving.scheduler.load_trace format)")
    ap.add_argument("--fuse-steps", type=int, default=1,
                    help="fuse up to K decode steps per tick (paged "
                         "engine; one CUDA graph per power-of-two "
                         "horizon on the card)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="refcounted prompt-prefix page sharing + CoW")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="common system-prompt tokens per request "
                         "(0: fully unique prompts)")
    ap.add_argument("--groups", type=int, default=1,
                    help="distinct system-prompt groups (with "
                         "--shared-prefix)")
    ap.add_argument("--group-skew", type=float, default=1.0,
                    help="Zipf popularity skew across groups")
    ap.add_argument("--placement", default=None,
                    choices=list(PLACEMENT_POLICIES),
                    help="stack-aware page placement: per-channel page "
                         "regions, each slot's pages co-located "
                         "(affinity) or striped (interleave); free-first "
                         "keeps the plain layout but reports its gather "
                         "cost")
    ap.add_argument("--placement-regions", type=int, default=None,
                    help="per-channel regions (default: one per PU of "
                         "the SNAKE template, capped by pool size)")
    ap.add_argument("--codesign", action="store_true",
                    help="price every tick on the SNAKE substrate model "
                         "and report modeled throughput, "
                         "reconfigurations and array utilization")
    ap.add_argument("--codesign-rows", type=int, default=None,
                    choices=[8, 16, 32, 64],
                    help="price a fixed rows x (4096/rows) array instead "
                         "of the reconfigurable substrate")
    ap.add_argument("--reconfig-cost", type=float, default=None,
                    metavar="SECONDS",
                    help="modeled-clock charge per substrate "
                         "reconfiguration (default: the pipeline "
                         "fill/drain cost of the array geometry)")
    # not ported yet: refused in main()
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--router-policy", default="round_robin",
                    choices=ROUTER_POLICIES)
    ap.add_argument("--tiers", type=str, default=None)
    ap.add_argument("--trace-out", type=str, default=None)
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.prefix_sharing and not args.paged:
        ap.error("--prefix-sharing requires --paged (the dense engine "
                 "has no page tables to share)")
    if args.placement and not args.paged:
        ap.error("--placement requires --paged (the dense cache has no "
                 "page pool to partition)")
    if args.fuse_steps > 1 and not args.paged:
        ap.error("--fuse-steps requires --paged (the fused scan runs on "
                 "the block-table decode step)")
    if args.fuse_steps < 1:
        ap.error("--fuse-steps must be >= 1")
    if args.codesign_rows and not args.codesign:
        ap.error("--codesign-rows requires --codesign")
    if args.reconfig_cost is not None and not args.codesign:
        ap.error("--reconfig-cost requires --codesign (there is no "
                 "modeled clock to charge otherwise)")
    if args.reconfig_cost is not None and args.reconfig_cost < 0:
        ap.error("--reconfig-cost must be >= 0")
    for dest, (unused, feature) in UNPORTED.items():
        if getattr(args, dest) != unused:
            ap.error(f"--{dest.replace('_', '-')} is not ported yet "
                     f"({feature} arrives with a later slice)")
    try:
        entry = registry.get(args.arch, reduced=not args.full)
    except NotImplementedError as exc:   # an architecture not ported yet
        ap.error(str(exc))
    ecfg = EngineConfig(max_batch=args.max_batch,
                        max_seq=args.prompt_len + args.max_new + 2,
                        max_new_tokens=args.max_new,
                        use_pallas_decode=args.pallas,
                        prefill_chunk=args.prefill_chunk,
                        paged=args.paged,
                        page_size=args.page_size,
                        num_pages=args.num_pages,
                        prefix_sharing=args.prefix_sharing,
                        defrag_threshold=(None if args.defrag_threshold < 0
                                          else args.defrag_threshold),
                        fuse_steps=args.fuse_steps,
                        placement=args.placement,
                        placement_regions=args.placement_regions,
                        codesign=args.codesign,
                        codesign_rows=args.codesign_rows,
                        codesign_reconfig_cost_s=args.reconfig_cost,
                        device=args.device)
    reqs = build_trace(args, entry.config.vocab)
    metrics = make_engine(entry, ecfg).run_trace(reqs)
    print(f"[serve] {args.arch} on {args.device}: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
