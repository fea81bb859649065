"""Serving entry point: continuous-batching decode on the port (port of
``repro.launch.serve`` for the flags this slice carries).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --full \
      --paged --prefill-chunk 128 --pallas
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --full --paged --pallas
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --full --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-30b-a3b \
      --full --paged --prefill-chunk 128 --pallas --fuse-steps 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --full \
      --paged --prefill-chunk 128 --pallas --fuse-steps 16 \
      --placement affinity --codesign

Runs on the CUDA card by default (``--device cpu`` runs the plain
PyTorch path on the host); the reduced config is the default and
``--full`` serves the published widths.  Every reference id is served:
the dense, MoE and VLM-text transformers (the extra Table 1 models
included), rwkv6-7b (ssm), recurrentgemma-9b (hybrid) and whisper-small
(audio, fed zero frames in place of the audio frontend).  At full
width qwen1.5-110b, opt-66b, llama3-70b, mixtral-8x22b, dbrx-132b and
kimi-k2-1t-a32b do not fit one 80 GB card (nothing is sharded yet).
``--pallas`` routes decode attention through the flash-decode CUDA
kernel (the block-table kernel with ``--paged``) and, for rwkv6-7b, the
recurrence of prefill and decode through the WKV6 CUDA kernel (the
hybrid and audio families take no kernel, as in the reference);
``--paged`` switches KV residency to the page pool (``--page-size``,
``--num-pages`` to oversubscribe; a recurrent state stays slot-dense,
whisper's cross-attention K/V too) and ``--prefill-chunk`` interleaves
Sarathi prefill chunks with the decode batch (attention families only:
the others prefill whole prompts).
``--fuse-steps K`` (with ``--paged``) fuses up to K decode steps per
tick, each power-of-two horizon one CUDA graph on the card (attention
families; the others decode per tick).  ``--prefix-sharing`` (with
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

``--replicas N`` stands up N engine replicas (one set of weights on the
card) behind the front-end router, ``--router-policy`` picks the
dispatch policy (``prefix_affinity`` needs ``--prefix-sharing``), and
``--tiers P:D`` (with ``--paged``, ``P + D == N``) splits them into a
prefill tier and a decode tier that KV pages are shipped to.  The
replicas share the card and tick one after another.  ``--trace-out
FILE`` writes a Perfetto timeline of the run (open it at
https://ui.perfetto.dev), a lossless ``FILE.jsonl`` event log beside
it, and prints the phase report:

  PYTHONPATH=src python -m repro_torch.launch.serve --full --paged \
      --pallas --prefill-chunk 128 --prefix-sharing --shared-prefix 768 \
      --groups 2 --replicas 2 --tiers 1:1 --fuse-steps 16 \
      --trace-out serve.trace.json
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.core.placement import PLACEMENT_POLICIES
from repro_torch.models import registry
from repro_torch.obs import Tracer, export_perfetto, save_jsonl, trace_report
from repro_torch.serving.engine import EngineConfig, make_engine
from repro_torch.serving.router import POLICIES, make_cluster
from repro_torch.serving.scheduler import (load_trace,
                                          make_grouped_prefix_trace,
                                          make_shared_prefix_trace,
                                          make_trace)


def dump_trace(events, path: str, tag: str = "serve") -> dict:
    """Write ``events`` as a Perfetto timeline at ``path`` and a lossless
    event log at ``path.jsonl``; print and return the phase report."""
    export_perfetto(events, path)
    save_jsonl(events, path + ".jsonl")
    rep = trace_report(events)
    print(f"[{tag}] trace: {len(events)} events -> {path} "
          f"(+ {path}.jsonl)")
    print(f"[{tag}] phases: {rep['phases']} "
          f"makespan={rep['makespan_s']:.3f}s")
    return rep


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
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the front-end router")
    ap.add_argument("--router-policy", choices=POLICIES,
                    default="round_robin")
    ap.add_argument("--tiers", type=str, default=None, metavar="P:D",
                    help="disaggregate the cluster into P prefill and D "
                         "decode replicas (P+D must equal --replicas; "
                         "requires --paged): finished prefills ship their "
                         "KV pages to the decode tier")
    ap.add_argument("--trace-out", type=str, default=None,
                    metavar="PERFETTO_JSON",
                    help="write a Perfetto timeline of the run, a "
                         "lossless .jsonl event log next to it, and print "
                         "the phase-attribution report")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.prefix_sharing and not args.paged:
        ap.error("--prefix-sharing requires --paged (the dense engine "
                 "has no page tables to share)")
    if args.router_policy == "prefix_affinity" and not args.prefix_sharing:
        ap.error("--router-policy prefix_affinity requires "
                 "--prefix-sharing (nothing resident to probe otherwise)")
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
    tiers = None
    if args.tiers is not None:
        try:
            p_n, d_n = (int(v) for v in args.tiers.split(":"))
        except ValueError:
            ap.error("--tiers must look like P:D, e.g. 1:3")
        if not args.paged:
            ap.error("--tiers requires --paged (page shipping moves "
                     "block-table pages)")
        if p_n < 1 or d_n < 1:
            ap.error("--tiers needs at least one replica per tier")
        if p_n + d_n != args.replicas:
            ap.error(f"--tiers {p_n}:{d_n} must sum to --replicas "
                     f"({args.replicas})")
        tiers = (p_n, d_n)
    entry = registry.get(args.arch, reduced=not args.full)
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
    tracer = Tracer() if args.trace_out else None
    if args.replicas > 1:
        router = make_cluster(entry, ecfg, args.replicas,
                              policy=args.router_policy, tiers=tiers)
        if tracer is not None:
            router.set_tracer(tracer)
        metrics = router.run_trace(reqs)
        per = metrics.pop("per_replica")
        print(f"[serve] {args.arch} x{args.replicas} "
              f"({args.router_policy}) on {args.device}: {metrics}")
        for rep in per:
            print(f"[serve]   replica {rep['replica']}: {rep}")
        metrics["per_replica"] = per
    else:
        eng = make_engine(entry, ecfg)
        if tracer is not None:
            eng.set_tracer(tracer)
        metrics = eng.run_trace(reqs)
        print(f"[serve] {args.arch} on {args.device}: {metrics}")
    if tracer is not None:
        dump_trace(tracer.events, args.trace_out)
    return metrics


if __name__ == "__main__":
    main()
