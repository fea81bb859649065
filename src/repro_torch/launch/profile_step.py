"""Where a serving tick's time goes: time the paged engine's decode step
and its chunked-prefill chunk apart, and summarise the device kernels of
one decode step with ``torch.profiler``.

  PYTHONPATH=src python -m repro_torch.launch.profile_step --full

Runs the main path (paged engine, flash-decode kernel) on ``--device``
(cuda by default) with random weights from seed 0: ``--batch`` requests
of ``--context`` prompt tokens are prefilled whole (untimed), then
``--steps`` decode steps are timed one by one on the host clock (each
step ends in the argmax fetch, a synchronisation), one more step runs
under the profiler, and a separate request of the same length is
prefilled in ``--chunk``-token chunks, each timed with a synchronise (a
family without chunked prefill, rwkv6, prefills it whole, timed the
same way).  One more prefill unit of another request (a chunk, or a
whole prompt) then runs under the profiler.  Each profiled window lists
its largest device ops with their share of its device time.  Prints one
JSON line.

Each profiled window also splits its device time by kind (GEMMs from
cuBLAS, the port's attention kernels, everything else).  For an MoE
config, one layer's ``apply_moe`` is profiled on its own at the decode
step's and the prefill chunk's token counts, which splits the layer into
its expert and router GEMMs and its dispatch / combine (routing, ranks,
scatter, gather; every other kernel of the layer).

With ``--fuse-steps K`` the engine fuses up to K decode steps a tick
(one CUDA graph per power-of-two horizon on the card, every bucket up to
K captured first and timed as ``capture_s``).  After the per-tick steps,
three per-tick windows (``--steps`` steps through ``step()``) alternate
with three fused windows (ticks through ``tick()`` until ``max(--steps,
2K)`` steps are decoded) on the same prompts, each timed on the host
clock and reported as ms per decoded step; then one fused tick of
horizon K runs under the profiler.  Both profiled windows report the
host's launches (kernel launches, graph launches and copies issued by
the host) beside the device's, and the span between CUDA events around
the window, which reads the device's time even where a profiler does
not see the kernels inside a graph replay.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time
from typing import List, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import registry, transformer
from repro_torch.serving.engine import EngineConfig, make_engine
from repro_torch.serving.scheduler import make_trace

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# the port's hand-written kernels (csrc/*.cu), by __global__ name
PORT_KERNELS = re.compile(r"wkv6_\w+|decode_\w+_kernel|snake_gemm_kernel")
# device kernels by kind: cuBLAS / CUTLASS matrix products, the port's
# attention kernels (flash decode); everything else is "other"
KINDS = (("gemm", re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.I)),
         ("attention", re.compile(r"decode_\w+_kernel")))
# the host's submissions of device work, by CUDA API name
HOST_LAUNCHES = re.compile(r"^cu(da)?(LaunchKernel\w*|GraphLaunch|"
                           r"Memcpy\w*|Memset\w*)$")


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return str(device)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _profile(fn, device: torch.device) -> dict:
    """Wall time, device busy time, device launches, the eight largest
    device ops (each with its share of the busy time) and the device time
    of each of the port's own kernels of one ``fn()``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    events = None
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        if events:
            events[0].record()
        fn()
        if events:
            events[1].record()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device-side entries only: an op's own row repeats the time of
    # the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    port = {}
    by_kind = {name: 0.0 for name, _ in KINDS}
    by_kind["other"] = 0.0
    for e in kernels:
        ms = e.self_device_time_total / 1e3
        m = PORT_KERNELS.search(e.key)
        if m:
            port[m.group(0)] = port.get(m.group(0), 0.0) + ms
        kind = next((name for name, pat in KINDS if pat.search(e.key)),
                    "other")
        by_kind[kind] += ms
    host = sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU
               and HOST_LAUNCHES.match(e.key))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "event_span_ms": (events[0].elapsed_time(events[1])
                              if events else None),
            "port_kernels_ms": port,
            "device_ms_by_kind": by_kind,
            "launches": sum(e.count for e in kernels),
            "host_launches": host,
            "top": [{"name": e.key[:60], "count": e.count,
                     "ms": e.self_device_time_total / 1e3,
                     "share": (e.self_device_time_total / 1e3 / busy_ms
                               if busy_ms else 0.0)} for e in top]}


def _fused_windows(eng, steps: int, window: int,
                   device: torch.device) -> dict:
    """Capture every bucket up to ``fuse_steps``, then alternate three
    per-tick windows of ``steps`` steps with three fused windows of at
    least ``window`` decoded steps; then profile one fused tick of the
    full horizon."""
    fuse = eng.ecfg.fuse_steps
    t0 = time.perf_counter()
    for n in range(1, fuse.bit_length()):
        eng._fused_fn(1 << n)
    _sync(device)
    capture_s = time.perf_counter() - t0

    def tick() -> int:
        """One tick; the steps it decoded."""
        n0 = len(eng.fused_horizons)
        eng.tick()
        return eng.fused_horizons[-1] if len(eng.fused_horizons) > n0 else 1

    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        per_tick_ms = (time.perf_counter() - t0) * 1e3
        horizons = []
        t0 = time.perf_counter()
        while sum(horizons) < window:
            horizons.append(tick())
        fused_ms = (time.perf_counter() - t0) * 1e3
        rounds.append({"per_tick_ms_per_step": per_tick_ms / steps,
                       "fused_ms_per_step": fused_ms / sum(horizons),
                       "fused_horizons": horizons})
    # align to a page edge so the profiled tick runs the full horizon
    eng._pre_decode_grow()
    if eng._fused_horizon() < fuse:
        tick()
    eng._pre_decode_grow()
    horizon = eng._fused_horizon()
    prof = _profile(tick, device)
    fused_ms = statistics.median(r["fused_ms_per_step"] for r in rounds)
    on_card = device.type == "cuda"
    return {"fuse_steps": fuse, "capture_s": capture_s,
            "buckets": sorted(eng._fused_graphs), "rounds": rounds,
            "per_tick_ms_per_step_median": statistics.median(
                r["per_tick_ms_per_step"] for r in rounds),
            "fused_ms_per_step_median": fused_ms,
            "profiled_tick_horizon": horizon,
            "profiled_tick": prof,
            # against unprofiled fused steps: the profiler slows the host
            "device_busy_share": (prof["device_busy_ms"]
                                  / (fused_ms * horizon)
                                  if on_card else None),
            "host_launches_per_horizon": prof["host_launches"],
            "fused_report": eng.fused_report()}


def _moe_layer(params, cfg, tokens: int, device: torch.device) -> dict:
    """Layer 0's ``apply_moe`` on ``tokens`` random rows, profiled alone
    (after one warm-up call): its GEMMs (experts, router) and the rest,
    the dispatch and combine."""
    lp = transformer.layer_params(params, 0)["moe"]
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((tokens, cfg.d_model), generator=gen, device=device
                    ).to(L._dtype(cfg.dtype))
    L.apply_moe(lp, x, cfg)
    _sync(device)
    prof = _profile(lambda: L.apply_moe(lp, x, cfg), device)
    kinds = prof["device_ms_by_kind"]
    return {"tokens": tokens, "device_busy_ms": prof["device_busy_ms"],
            "gemm_ms": kinds["gemm"],
            "dispatch_combine_ms": kinds["other"] + kinds["attention"],
            "launches": prof["launches"], "top": prof["top"]}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile_step")
    ap.add_argument("--arch", choices=registry.ARCH_IDS
                    + registry.EXTRA_ARCH_IDS, default="yi-6b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=768)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--fuse-steps", type=int, default=None,
                    help="also time fused ticks of up to K steps, in "
                         "windows alternated with per-tick ones")
    args = ap.parse_args(argv)
    try:
        entry = registry.get(args.arch, reduced=not args.full)
    except NotImplementedError as exc:   # an architecture not ported yet
        ap.error(str(exc))
    cfg = entry.config
    fuse = args.fuse_steps
    if fuse is not None and fuse < 1:
        ap.error("--fuse-steps must be >= 1")
    # decode steps the run takes: the per-tick steps, then (fused) three
    # pairs of windows, an alignment tick and the profiled tick
    window = max(args.steps, 2 * (fuse or 0))
    budget = args.steps + 4
    if fuse:
        budget += 3 * (args.steps + window + fuse) + 2 * fuse
    base = dict(max_batch=args.batch,
                max_seq=args.context + budget + 4,
                max_new_tokens=budget, paged=True,
                use_pallas_decode=True, device=args.device,
                fuse_steps=fuse or 1)
    eng = make_engine(entry, EngineConfig(**base))
    dev = eng.device
    for req in make_trace(cfg.vocab, rate_req_s=1e9, n_requests=args.batch,
                          prompt_len=args.context, seed=0):
        if not eng.submit(req):
            raise RuntimeError("the engine refused a request")
    eng.step()                                   # warm-up
    step_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        eng.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    step = _profile(eng.step, dev)
    fused = _fused_windows(eng, args.steps, window, dev) if fuse else None

    chunked = make_engine(entry, EngineConfig(**dict(
        base, prefill_chunk=args.chunk, fuse_steps=1)), params=eng.params)
    (req,) = make_trace(cfg.vocab, rate_req_s=1e9, n_requests=1,
                        prompt_len=args.context, seed=1)
    chunk_ms = []
    if not chunked._chunkable():
        t0 = time.perf_counter()
        if not chunked.submit(req):
            raise RuntimeError("the engine refused a request")
        _sync(dev)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    elif not chunked.admit(req):
        raise RuntimeError("the engine refused a request")
    while chunked._prefilling is not None:
        t0 = time.perf_counter()
        chunked._prefill_chunk_tick()
        _sync(dev)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    (req,) = make_trace(cfg.vocab, rate_req_s=1e9, n_requests=1,
                        prompt_len=args.context, seed=2)
    if chunked._chunkable():
        if not chunked.admit(req):
            raise RuntimeError("the engine refused a request")
        prefill = _profile(chunked._prefill_chunk_tick, dev)
    else:
        prefill = _profile(lambda: chunked.submit(req), dev)

    # least bytes a decode step moves: every layer's weights and the head
    # once, and the batch's valid K/V once per layer (a recurrent state:
    # all of it, read and written)
    emb = eng.params["embed"]
    weight_bytes = _nbytes(eng.params["blocks"]) + _nbytes(
        emb["head"] if "head" in emb else emb["table"])
    store = eng.paged.store
    if eng.paged.has_seq:
        cache_bytes = (2 * args.batch * (args.context + args.steps)
                       * store[0][0, 0, 0].numel() * store[0].element_size()
                       * cfg.num_layers)
    else:
        cache_bytes = 2 * sum(t.numel() * t.element_size()
                              for t in store[:-1])
    out = {
        "arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
        "batch": args.batch, "context": args.context,
        "decode_step_ms_median": statistics.median(step_ms),
        "decode_step_ms": step_ms,
        "profiled_step_wall_ms": step["wall_ms"],
        "profiled_step_device_busy_ms": step["device_busy_ms"],
        # against an unprofiled step: the profiler slows the host side
        "device_busy_share": (step["device_busy_ms"]
                              / statistics.median(step_ms)),
        "device_launches_per_step": step["launches"],
        "host_launches_per_step": step["host_launches"],
        "top_device_ops": step["top"],
        "device_ms_by_kind_per_step": step["device_ms_by_kind"],
        "port_kernels_ms_per_step": step["port_kernels_ms"],
        "weight_bytes_per_step": weight_bytes,
        "weights_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "cache_bytes_per_step": cache_bytes,
        "cache_bound_ms": cache_bytes / HBM_BYTES_PER_S * 1e3,
        "chunk": args.chunk if chunked._chunkable() else None,
        "prefill_chunk_ms": chunk_ms,
        # one more prefill unit (a chunk, or a whole prompt) profiled
        "profiled_prefill": prefill,
        "fused": fused,
        # one MoE layer alone, at the decode step's and the chunk's tokens
        "moe_layer": ({"decode": _moe_layer(eng.params, cfg, args.batch,
                                            dev),
                       "prefill_chunk": _moe_layer(eng.params, cfg,
                                                   args.chunk, dev)}
                      if cfg.num_experts else None),
        "card": _card(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
