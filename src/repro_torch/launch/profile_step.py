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

from repro_torch.models import registry
from repro_torch.serving.engine import EngineConfig, make_engine
from repro_torch.serving.scheduler import make_trace

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# the port's hand-written kernels (csrc/*.cu), by __global__ name
PORT_KERNELS = re.compile(r"wkv6_\w+|decode_\w+_kernel|snake_gemm_kernel")


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
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device-side entries only: an op's own row repeats the time of
    # the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    port = {}
    for e in kernels:
        m = PORT_KERNELS.search(e.key)
        if m:
            port[m.group(0)] = port.get(m.group(0), 0.0) + \
                e.self_device_time_total / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "port_kernels_ms": port,
            "launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:60], "count": e.count,
                     "ms": e.self_device_time_total / 1e3,
                     "share": (e.self_device_time_total / 1e3 / busy_ms
                               if busy_ms else 0.0)} for e in top]}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile_step")
    ap.add_argument("--arch", choices=registry.ARCH_IDS, default="yi-6b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=768)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    entry = registry.get(args.arch, reduced=not args.full)
    cfg = entry.config
    base = dict(max_batch=args.batch,
                max_seq=args.context + args.steps + 8,
                max_new_tokens=args.steps + 4, paged=True,
                use_pallas_decode=True, device=args.device)
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

    chunked = make_engine(entry, EngineConfig(**dict(
        base, prefill_chunk=args.chunk)), params=eng.params)
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
        "top_device_ops": step["top"],
        "port_kernels_ms_per_step": step["port_kernels_ms"],
        "weight_bytes_per_step": weight_bytes,
        "weights_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "cache_bytes_per_step": cache_bytes,
        "cache_bound_ms": cache_bytes / HBM_BYTES_PER_S * 1e3,
        "chunk": args.chunk if chunked._chunkable() else None,
        "prefill_chunk_ms": chunk_ms,
        # one more prefill unit (a chunk, or a whole prompt) profiled
        "profiled_prefill": prefill,
        "card": _card(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
