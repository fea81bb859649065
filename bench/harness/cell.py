"""One run of one cell: set up, warm up, measure the window, optionally
profile a slice after it, then check the served tokens.

Set-up runs from the start of the process to the opening of the window:
the weights made on the device from the seed, the engine, the capture
of every fused-decode bucket the engine can replay, and the ramp, in
which the backlog fills the engine until the mix's opening condition
holds.  The window then ticks for ``seconds`` (the last tick ends it).
A traced run ticks on under the profiler for ``SLICE_S`` seconds more.
The page pool and the engine are freed before the reference runs.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from bench.harness import check, routes, spec, trace, weights, window

#: seconds the traced run profiles after the window
SLICE_S = 3.0

# Hugging Face config keys -> the port's ArchConfig fields
_ARCH_KEYS = {
    "num_hidden_layers": "num_layers", "hidden_size": "d_model",
    "num_attention_heads": "num_q_heads",
    "num_key_value_heads": "num_kv_heads", "head_dim": "d_head",
    "intermediate_size": "d_ff", "vocab_size": "vocab",
    "num_experts": "num_experts", "num_experts_per_tok": "topk",
    "moe_intermediate_size": "d_ff_expert", "rope_theta": "rope_theta",
    "tie_word_embeddings": "tie_embeddings",
    "capacity_factor": "capacity_factor", "torch_dtype": "dtype",
}


def arch_config(cfg: Dict[str, Any]):
    """The port's ArchConfig for a configuration file: its named config
    with every size of the file, held to what the configuration's
    reference takes for granted of the model."""
    from repro_torch.models import registry
    base = registry.get_config(cfg["port"]["arch"])
    over = {f: cfg[k] for k, f in _ARCH_KEYS.items() if k in cfg}
    arch = dataclasses.replace(base, **over)
    want = spec.reference(cfg).assumes(cfg)
    got = {k: getattr(arch, k) for k in want}
    if got != want:
        raise ValueError(f"the port's {cfg['port']['arch']} is {got}, the "
                         f"configuration states {want}")
    return arch


def engine_config(cfg: Dict[str, Any], mix: Dict[str, Any], device: str):
    """EngineConfig of a configuration under a mix: the window holds the
    mix's longest request; the pool is the dense-equivalent one, capped
    at ``kv_pool_bytes``."""
    from repro_torch.serving.engine import EngineConfig
    e = cfg["engine"]
    gen = spec.generator(mix)
    ps = int(e["page_size"])
    max_seq = gen.max_context(mix)
    blocks = -(-max_seq // ps)
    page_bytes = ps * spec.counts(cfg).Shape.of(cfg).kv_bytes_per_token
    pages = min(int(e["max_batch"]) * blocks,
                int(e["kv_pool_bytes"]) // page_bytes)
    return EngineConfig(
        max_batch=int(e["max_batch"]), max_seq=max_seq,
        max_new_tokens=gen.max_output(mix), eos_id=-1,
        use_pallas_decode=bool(e["use_pallas_decode"]),
        prefill_chunk=int(e["prefill_chunk"]), paged=bool(e["paged"]),
        page_size=ps, num_pages=pages, fuse_steps=int(e["fuse_steps"]),
        device=device)


@dataclass
class Run:
    """What the metric readers read."""
    cell: spec.Cell
    setup_s: float
    window_s: float
    ticks: List[window.Tick]
    gaps: List[float]
    pool_pages: int
    chunks_sound: bool
    shape: Any
    counts: Any
    peaks: Optional[Dict[str, float]]
    slice: Optional[trace.Slice] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _opened(mix: Dict[str, Any], max_batch: int) -> Callable:
    want = mix["open_when_active"]
    n = max_batch if want == "full" else int(want)
    return lambda obs: len(obs.in_flight) >= n and obs.decoding() >= n - 1


def run(cell: spec.Cell, seed: int, seconds: float, trace_on: bool,
        device: str, t_start: float, log=sys.stderr,
        control: bool = False,
        window_ticks: Optional[int] = None) -> Dict[str, Any]:
    """One run; returns the result line's object (``correct`` and the
    metrics of the run's kind).  ``control`` also reads the control's gap
    on the same sample (``calibrate.py``; the benchmark's runs do not).
    ``window_ticks`` closes the window after that many ticks instead of
    ``seconds`` (the CPU tests, whose clock is the load of the host)."""
    from repro_torch.serving.engine import make_engine
    from repro_torch.serving.scheduler import RequestState, Scheduler
    from repro_torch.models import registry

    cfg, mix = cell.config, cell.traffic
    dev = torch.device(device)
    counts = spec.counts(cfg)
    shape = counts.Shape.of(cfg)
    arch = arch_config(cfg)
    moe = spec.reference(cfg).moe_layers(cfg)
    if bool(moe) != bool(arch.num_experts):
        raise ValueError(f"the reference routes in layers {moe}, the port's "
                         f"{cfg['port']['arch']} has {arch.num_experts} "
                         f"experts")
    params = weights.make(cfg, seed, dev)
    ecfg = engine_config(cfg, mix, device)
    eng = make_engine(registry.from_config(arch), ecfg, params=params)
    # an MoE's routing is recorded on the timed path, one row of ids an
    # MoE layer, for the reference to follow (``harness/routes.py``)
    tap = routes.Tap(eng, len(moe), arch.topk) if moe else None
    try:
        sched = Scheduler(eng)
        backlog = window.Backlog(mix, arch.vocab, seed, RequestState)
        paged = getattr(eng, "paged", None)
        obs = window.Observer(sched, backlog, ecfg.prefill_chunk,
                              pages_fn=getattr(paged, "pages_in_use", None))
        # capture every fused-decode bucket up front, so none is captured in
        # the window (an all-inactive capture writes only the scratch page)
        capture = getattr(eng, "_fused_fn", None)
        if capture is not None and ecfg.fuse_steps > 1:
            for n in range(1, ecfg.fuse_steps.bit_length()):
                capture(1 << n)
        t_base = time.perf_counter()
        window.run_until(obs, backlog, _opened(mix, ecfg.max_batch), t_base)
        # what set-up made lives to the end: keep the collector off it
        gc.collect()
        gc.freeze()
        _sync(dev)
        t_open = time.perf_counter()
        i_open = len(obs.ticks)
        setup_s = t_open - t_start
        if window_ticks is None:
            closed = lambda o: time.perf_counter() - t_open >= seconds
        else:
            closed = lambda o: len(o.ticks) - i_open >= window_ticks
        window.run_until(obs, backlog, closed, t_base)
        t_close = obs.ticks[-1].t1
        i_close = len(obs.ticks)
        sl = None
        if trace_on and dev.type == "cuda":
            sl = trace.profile(lambda stop: window.run_until(
                obs, backlog, lambda o: stop(), t_base), SLICE_S,
                lambda: _sync(dev))
            sl.ticks = obs.ticks[i_close:]
        _sync(dev)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        ticks = obs.ticks[i_open:i_close]
        done = [r for r in obs.finished if t_open < r.finish_s <= t_close]
        info = {"setup_s": setup_s, "window_s": t_close - t_open,
                "ticks": len(ticks), "ramp_ticks": i_open,
                "requests_finished": len(done), "preemptions": obs.preemptions,
                "pool_pages": ecfg.num_pages,
                "ttft_mean_s": float(np.mean(obs.ttft)) if obs.ttft else None,
                "tick_ms_p10_p50_p90": {
                    kind: [round(1e3 * float(np.percentile(d, q)), 2)
                           for q in (10, 50, 90)] if d else None
                    for kind, d in (
                        ("chunk", [t.t1 - t.t0 for t in ticks if t.chunk]),
                        ("decode", [t.t1 - t.t0 for t in ticks
                                    if not t.chunk]))},
                "chunks_sound": obs.chunks_sound}
        run_rec = Run(cell=cell, setup_s=setup_s,
                      window_s=t_close - t_open, ticks=ticks,
                      gaps=[g for t, g in obs.gaps if t_open < t <= t_close],
                      pool_pages=ecfg.num_pages, chunks_sound=obs.chunks_sound,
                      shape=shape, counts=counts,
                      peaks=(spec.peaks(torch.cuda.get_device_name(dev))
                             if dev.type == "cuda" else None),
                      slice=sl)
        metrics = {}
        for m in cell.metrics(trace_on):
            v = m.reader().read(run_rec)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}

    finally:
        if tap is not None:
            tap.remove()

    # the program's state goes before the reference runs
    del sched, eng, obs, paged, capture
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec = None
    if tap is None:
        reqs = check.sample(done, seed)
    else:
        # a preempted request's positions were computed twice: left out
        kept = [r for r in done if not r.preemptions]
        info["left_out_preempted"] = len(done) - len(kept)
        info["route_fault"] = tap.fault
        reqs = check.sample(kept, seed)
        rec = [tap.routes[r.rid] for r in reqs]
        ring = tap.decode_steps()
        steps = [tap.steps[r.rid] for r in reqs]
        slots = [tap.slots[r.rid] for r in reqs]
        del tap
    ref = spec.reference(cfg).Reference(cfg, params,
                                        prefill_chunk=ecfg.prefill_chunk)
    t_ref = time.perf_counter()
    got, rows = (check.served_gap(ref, reqs, dev, rec) if reqs
                 else (None, None))
    if got is not None and rec is not None:
        held, fault = check.decode_record(ref, *ring, rec, steps, slots)
        got.update(held)
        info["route_fault"] = info["route_fault"] or fault
        info.update({k: v for k, v in held.items()
                     if k not in check.ROUTE_NUMBERS})
        del ring
    info["reference_s"] = time.perf_counter() - t_ref
    compared = {}
    correct, failed = got is not None, 0
    if got is not None:
        per = got["per_request"]
        over = [False] * len(reqs)
        for name, lim in cell.limits.items():
            lim = float(lim["limit"])
            compared[name] = {"value": got[name], "limit": lim}
            correct = correct and got[name] <= lim
            for i, v in enumerate(per.get(name, ())):
                over[i] = over[i] or v > lim
        failed = sum(over)
        if info.get("route_fault"):
            correct = False
        if not correct and not failed:
            failed = len(reqs)
        info.update(requests_compared=len(reqs),
                    tokens_compared=got["tokens"],
                    gap_per_request=per["max_logit_gap"],
                    **{k: got[k] for k in check.NUMBERS + check.ROUTE_NUMBERS
                       if k in got})
    if control and reqs:
        if cfg["torch_dtype"] not in ("bfloat16", "float16"):
            raise ValueError("the control (float8 products) is that of a "
                             "16-bit configuration")
        ctl = spec.reference(cfg).Reference(
            cfg, params, precision="fp8", prefill_chunk=ecfg.prefill_chunk)
        info["control"] = check.control_gap(ctl, reqs, dev, rows, rec)
        if rec is not None:
            info["control"].update(check.control_routing(ref, ctl, reqs,
                                                         dev))
            # the same readings with each side routing by itself
            free, rows = check.served_gap(ref, reqs, dev)
            info["unforced"] = {k: free[k] for k in check.NUMBERS}
            info["control_unforced"] = check.control_gap(ctl, reqs, dev,
                                                         rows)
    result = {
        "correct": bool(correct),
        "attempted": len(done),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if sl is not None:
        result["device"]["busy_s"] = sl.busy_s
        result["device"]["window_s"] = sl.window_s
        result["breakdown"] = trace.breakdown(sl)
    result["check"] = compared
    print("info " + _json(info), file=log)
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=log)
    return result


def _json(obj) -> str:
    import json
    return json.dumps(obj, default=str)
