"""End-to-end serving demo (port of ``examples/serve_decode.py``):
batched Poisson requests through the continuous-batching engine on two
architecture families, a GQA dense LM (yi-6b) and the attention-free
RWKV6, reduced configs, with the port's CUDA kernels optionally on.

``--pallas`` routes decode attention through the flash-decode kernel
(and RWKV6's recurrence through the WKV6 kernel); ``--paged`` switches
both engines to the block-table paged KV cache (the RWKV state has no
sequence axis, so the comparison shows zero pages); ``--prefill-chunk``
co-schedules Sarathi prefill chunks with the decode batch; ``--share``
turns on refcounted prefix sharing and drives a shared-system-prompt
trace (16 common + 8 unique tokens per request).

``--replicas N`` (with ``--share``) stands the dense-LM engine up N
times behind the front-end router on a 2-group multi-tenant trace under
``--policy``.  ``--fuse-steps K`` fuses up to K decode steps a tick,
and ``--trace-out FILE`` records a Perfetto timeline of any of the runs
(plus a lossless ``.jsonl`` event log and a printed phase report).

Runs on the CUDA card by default; ``--device cpu`` runs the plain
PyTorch path on the host:

  PYTHONPATH=src python -m repro_torch.launch.serve_decode --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_decode --pallas --paged
  PYTHONPATH=src python -m repro_torch.launch.serve_decode --share \\
      --replicas 2 --policy prefix_affinity
  PYTHONPATH=src python -m repro_torch.launch.serve_decode --share \\
      --fuse-steps 4 --trace-out serve.trace.json
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.models import registry
from repro_torch.launch.serve import dump_trace
from repro_torch.obs import Tracer
from repro_torch.serving.engine import EngineConfig, make_engine
from repro_torch.serving.router import POLICIES, make_cluster
from repro_torch.serving.scheduler import (make_grouped_prefix_trace,
                                          make_shared_prefix_trace)


def run_cluster(args) -> dict:
    entry = registry.get("yi-6b", reduced=True)
    ecfg = EngineConfig(max_batch=4, max_seq=64, max_new_tokens=12,
                        use_pallas_decode=args.pallas, paged=True,
                        page_size=16, prefix_sharing=True,
                        fuse_steps=args.fuse_steps,
                        prefill_chunk=args.prefill_chunk,
                        device=args.device)
    router = make_cluster(entry, ecfg, args.replicas, policy=args.policy)
    tracer = Tracer() if args.trace_out else None
    if tracer is not None:
        router.set_tracer(tracer)
    reqs = make_grouped_prefix_trace(entry.config.vocab,
                                     rate_req_s=args.rate,
                                     n_requests=args.n_requests,
                                     n_groups=2, prefix_len=16, tail_len=8,
                                     skew=0.5)
    m = router.run_trace(reqs)
    print(f"[serve_decode] yi-6b x{args.replicas} ({args.policy})  "
          f"{m['requests']} reqs  {m['decoded_tokens']} toks  "
          f"{m['tokens_per_s']:.1f} tok/s  "
          f"p99 e2e {m['e2e_p99_s'] * 1e3:.0f}ms  "
          f"dedup x{m['dedup_ratio_agg']:.2f}")
    for rep in m["per_replica"]:
        print(f"[serve_decode]   replica {rep['replica']}: "
              f"{rep['requests']} reqs  {rep['decoded_tokens']} toks  "
              f"dedup x{rep['dedup_ratio_peak']:.2f}")
    if tracer is not None:
        dump_trace(tracer.events, args.trace_out, tag="serve_decode")
    return {"yi-6b": m}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve_decode")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--pallas", action="store_true",
                    help="the CUDA kernels (flash decode, WKV6)")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--share", action="store_true",
                    help="prefix sharing on a shared-prompt trace "
                         "(implies --paged)")
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--fuse-steps", type=int, default=1,
                    help="decode steps fused per tick (needs --paged or "
                         "--share)")
    ap.add_argument("--n-requests", type=int, default=10)
    ap.add_argument("--rate", type=float, default=6.0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="with --share: replicas behind the router")
    ap.add_argument("--policy", choices=POLICIES, default="prefix_affinity")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write a Perfetto timeline (+ .jsonl event log) "
                         "of the run")
    args = ap.parse_args(argv)
    if args.replicas > 1 and not args.share:
        ap.error("--replicas needs --share (the router demo drives a "
                 "grouped shared-prefix trace)")
    if args.fuse_steps > 1 and not (args.paged or args.share):
        ap.error("--fuse-steps needs --paged or --share (the fused loop "
                 "runs on the block-table decode step)")
    if args.share and args.replicas > 1:
        return run_cluster(args)

    tracer = Tracer() if args.trace_out else None
    out = {}
    for replica, arch in enumerate(("yi-6b", "rwkv6-7b")):
        entry = registry.get(arch, reduced=True)
        ecfg = EngineConfig(max_batch=4, max_seq=64, max_new_tokens=12,
                            use_pallas_decode=args.pallas,
                            paged=args.paged or args.share, page_size=16,
                            prefix_sharing=args.share,
                            fuse_steps=(args.fuse_steps
                                        if args.paged or args.share else 1),
                            prefill_chunk=args.prefill_chunk,
                            device=args.device)
        eng = make_engine(entry, ecfg)
        if tracer is not None:
            eng.set_tracer(tracer, replica=replica)
        if args.share:
            reqs = make_shared_prefix_trace(entry.config.vocab,
                                            rate_req_s=args.rate,
                                            n_requests=args.n_requests,
                                            prefix_len=16, tail_len=8)
            m = eng.run_trace(reqs)
        else:
            m = eng.run_workload(rate_req_s=args.rate,
                                 n_requests=args.n_requests, prompt_len=24)
        extra = (f"  dedup x{m['kv_dedup_ratio_peak']:.2f} "
                 f"cow {m['cow_forks']}" if args.share else "")
        print(f"[serve_decode] {arch:10s} {m['requests']} reqs  "
              f"{m['decoded_tokens']} toks  {m['tokens_per_s']:.1f} tok/s  "
              f"TBT mean {m['tbt_mean_s'] * 1e3:.1f}ms "
              f"p99 {m['tbt_p99_s'] * 1e3:.1f}ms  "
              f"kv={m['kv_mode']} peak {m['kv_peak_tokens']} tok{extra}")
        out[arch] = m
    if tracer is not None:
        dump_trace(tracer.events, args.trace_out, tag="serve_decode")
    return out


if __name__ == "__main__":
    main()
