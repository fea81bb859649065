#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --sweep    # build, then time both flash-decode
                                     # kernels at both phase-2 shapes for
                                     # every chunk C in fd.CHUNKS, the
                                     # decode GEMM at its three bf16 shapes
                                     # for each K split of GEMM_SPLITS, and
                                     # WKV6 on both designs (serial, and
                                     # chunked at every C of wk.CHUNKS) for
                                     # T in WKV_SWEEP_T, with the crossover

Phases, one line each; any failure raises and exits non-zero:

1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
             with nvcc (one process per source, in parallel); print the
             card's name and power limit.
2. kernels — each kernel against its plain PyTorch version, with its time
             on the card beside the bound:
             * flash decode at full-width yi-6b shapes in bf16 (Hq=32,
               Hkv=4, D=128, page 16), timed at B=8 with ragged lengths
               0..4096 and at the serve's decode shape (B=4, lengths
               768-778), garbage past every length and in the scratch
               page, rtol = atol = 2e-2 (the bf16 tolerance of
               tests/test_kernels.py), and at stablelm-3b's decode shape
               (B=4, Hq=Hkv=32, D=80, the serve's lengths); the split
               plan (C, n_split, blocks holding valid positions) of each
               timed case; then every instantiation (f32 / bf16 x D
               32/64/80/112/128 x G 1/4/6/7/8) on lengths at the chunk
               edges, f32 within 2e-5;
             * WKV6 at rwkv6-7b shapes (H=64, hs=64): decode B=4, T=1 (the
               serial design) and whole-prompt prefills B=1, T=128, 768
               and 1024 (the chunked design), each with its plan (design,
               C, blocks, chunks), in float32 (tolerance 1e-4, as
               tests/test_kernels.py) and bf16 inputs (2e-2), a chunked
               call also against the plain rendering of its chunks; decays
               as the model forms them, exp(-exp(x)) for x in [-8, 5]
               (exact zeros included) on the chunked design; the state
               carry wkv6(T1+T2) == wkv6(T2) . wkv6(T1) and the new state
               written over the old one in place, on the chunked design;
             * the decode GEMM at rwkv6-7b's decode products, M=4, bf16:
               (N, K) = (14336, 4096) IS, (4096, 14336) and (4096, 4096)
               OS, then (16, 14336, 4096) IS, a ragged bf16 case of each
               dataflow (N % 8 != 0, K % 16 != 0) and a ragged float32
               (13, 257, 129) (tests/test_kernels.py tolerances), each
               also against the plain rendering of its K split and
               checked bitwise repeatable over two calls and two CUDA
               graph replays; each case's split plan (bk, n_split,
               blocks) and achieved TB/s.
3. parity  — full-width yi-6b, rwkv6-7b, qwen3-30b-a3b (MoE),
             stablelm-3b (D=80, MHA, layernorm) and qwen2-vl-7b (M-RoPE,
             G=7) at 2 layers in float32 (TF32 off): each engine with its
             kernels against the same engine on the plain path,
             teacher-forced on the plain run's tokens; per-step logits
             within 1e-3.  Then yi-6b's and qwen3-30b-a3b's fused paged
             engine (fuse_steps=8, kernels on, one CUDA graph per
             bucketed horizon) against its per-tick paged engine on the
             same trace: identical tokens and finish reasons; and, for
             yi-6b, the same pair with prefix sharing on and prefill chunks of 4, on
             four 37-token identical prompts of which two are extended
             by 11 unique tokens (the ragged tail page is shared and
             forked; the extended ones hold shared pages while their
             chunks run beside the decode batch); then yi-6b's fused
             engine with affinity placement over 2 regions and sharing,
             on a 14-page pool that spills and then migrates at defrag,
             against the same engine unplaced: identical tokens, at
             least one page migrated, the device table mirror
             consistent.
4. serve   — full-width, full-depth models in bf16 (random weights from a
             seeded generator), 4 requests of 256-1024 prompt tokens and
             32 new tokens each through ``Scheduler.run_trace``: yi-6b on
             the paged engine (chunked prefill 128, paged kernel), then the
             same engine fusing up to 16 decode steps a tick (one CUDA
             graph per bucketed horizon, every bucket captured before the
             trace), which must give the per-tick run's tokens and finish
             reasons and launch the paged kernel (per-tick steps + the
             bucketed steps of every horizon) x 32 times, counted through
             the replays; then the same fused run with affinity placement
             and co-design pricing, which must give the unplaced fused
             run's tokens: its TBT, TTFT and tokens/s beside the
             unplaced run's, the modeled tokens/s, reconfigurations,
             array utilization and gather cost, the host ms a horizon
             spends pricing, and the paged kernel at the serve's decode
             shape with its table laid out by each placement policy
             (the same output, timed); then the paper's GPU model
             (``gpu_decode_step`` at B=4, tp=1) beside a measured fused
             step at B=4 on 768-token prompts (also for qwen3-30b-a3b
             below).  Then prefix sharing, every run fusing up to 16
             steps: 4 prompts of 768 shared + 128 unique tokens at 4
             req/s without and with sharing (768 is a whole number of
             pages and chunks, so both compute the same KV: identical
             tokens; the three later requests skip 768 prefill tokens
             each; a lower KV peak; dedup > 1), then 4 identical
             777-token prompts, shared, per tick and fused (identical
             tokens, copy-on-write forks of the ragged tail), and the
             cost of one fork at full width (host time of ``fork_page``;
             device time of its in-place page copies).  Then yi-6b on the
             dense engine (dense kernel), without and with co-design
             pricing (the same tokens), and rwkv6-7b on the paged
             engine with the WKV6 kernel (every prefill on the chunked
             design, every decode step on the serial one).  Then
             stablelm-3b (D=80) on the paged and the dense engine, and,
             with every earlier model, engine and graph freed,
             qwen3-30b-a3b (48 layers, 128 experts top-8, ~61 GB of
             bf16 weights) on the paged engine per tick and fusing up to
             16 steps a tick: the same tokens, the paged kernel launched
             (per-tick steps + bucketed fused steps) x 48 times, with the
             weights' size and the peak of allocated device memory.
             Every launch
             counter is set to 0 just before each run and read just after
             it; the decode GEMM is not wired into any model (as in the
             reference), so its count on these runs is 0.

The last three lines are the kernels' JSON, the card's name and power
limit as nvidia-smi reports them, and the result JSON.  Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor rate
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
HQ, HKV, D, PAGE = 32, 4, 128, 16
LENGTHS = [0, 1, 16, 17, 255, 1000, 2048, 4096]
# profile_step.py's decode step: B=4, contexts 768-778, a window of 800
SERVE_LENGTHS, SERVE_CAP = [768, 771, 775, 778], 800
# stablelm-3b's attention: MHA (Hq = Hkv = 32), D = 80
STABLELM_HEADS, STABLELM_D = 32, 80
# group sizes of the instantiation grid: yi-6b and qwen3 (8), mixtral and
# dbrx (6), qwen2-vl (7), stablelm (1)
GROUPS = (1, 4, 6, 7, 8)
# the shared-prefix serve: a system prompt of a whole number of pages and
# of 128-token chunks, then an identical prompt with a ragged tail page
SHARED_PREFIX, SHARED_TAIL, IDENTICAL_PROMPT = 768, 128, 777
# the 2-layer placed run: affinity over 2 regions of 7 pages with prefix
# sharing and the fused tick; decode growth spills out of a full home
# region, preemption relaxes the pool, and the defrag that follows
# copies the spilled pages home (the schedule depends on the lengths
# alone, so it is the one the CPU tests see at the reduced widths)
PLACED_LENS = np.array([40, 70, 10, 100, 30, 60])
PLACED = dict(max_batch=4, max_new_tokens=32, page_size=PAGE, num_pages=14,
              prefill_chunk=16, prefix_sharing=True, fuse_steps=8,
              paged=True, use_pallas_decode=True, placement_regions=2)
# the paper's GPU model against a measured fused step: B=4, 768-token
# prompts, then a window of at least 48 decoded steps
GPU_MODEL_BATCH, GPU_MODEL_CTX, GPU_MODEL_WINDOW = 4, 768, 48
KERNEL_TOL = dict(rtol=2e-2, atol=2e-2)
F32_KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
PARITY_TOL = dict(rtol=1e-3, atol=1e-3)
GARBAGE = 60.0
WKV_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
GEMM_TOL = {torch.float32: dict(rtol=5e-3, atol=1e-3),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
WKV_H, WKV_HS = 64, 64          # rwkv6-7b: d 4096 / head size 64
# whole-prompt prefills (B, T): a short prompt, the profiled context and
# PR 12's timed shape
WKV_PREFILLS = ((1, 128), (1, 768), (1, 1024))
WKV_SWEEP_T = (1, 8, 32, 48, 64, 96, 128, 512, 1024)
# rwkv6-7b's decode products at a batch of 4: (M, N, K), IS then OS twice
GEMM_SHAPES = [(4, 14336, 4096), (4, 4096, 14336), (4, 4096, 4096)]
GEMM_SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 17, 18, 24, 32, 48, 64)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Median device time of one call: ``fn`` is captured once in a CUDA
    graph and each replay is timed between CUDA events, so the host's
    dispatch (Python, argument checks, ctypes) is not counted; the 50 MB
    L2 is flushed before each replay (a decode step finds each layer's
    data cold)."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


def phase_build(build, smi):
    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    logs = "".join(p.with_suffix(".log").read_text()
                   for p in libs.values()
                   if p.with_suffix(".log").exists())
    regs = [int(w) for line in logs.splitlines() if "registers" in line
            for w, nxt in zip(line.split(), line.split()[1:])
            if nxt.startswith("registers")]
    spills = sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                 for line in logs.splitlines() if "spill stores" in line)
    print(f"[build] {sorted(libs)} in {secs:.1f} s (max {max(regs or [0])} "
          f"registers/thread, {spills} bytes spilled); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; card {smi}")


def _fd_inputs(gen, lengths, cap, dtype=torch.bfloat16, d=D, hq=HQ,
               hkv=HKV, page=PAGE):
    """Flash-decode inputs on the card: contiguous caches of ``cap``
    positions and page pools dealt in a seeded shuffle, with garbage past
    every length, in the scratch page and in table entries past each
    length.  Also returns the number of table entries the kernel reads."""
    dev = "cuda"
    b = len(lengths)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q = rand(b, hq, d)
    k, v = rand(b, cap, hkv, d), rand(b, cap, hkv, d)
    for i, n in enumerate(lengths):
        k[i, n:] = GARBAGE
        v[i, n:] = GARBAGE
    need = [-(-n // page) for n in lengths]
    n_pages = sum(need) + 8
    order = np.random.default_rng(0).permutation(n_pages)
    kp, vp = rand(n_pages + 1, page, hkv, d), rand(n_pages + 1, page, hkv, d)
    kp[n_pages] = GARBAGE
    vp[n_pages] = GARBAGE
    tables = np.full((b, cap // page), n_pages, np.int32)
    j = 0
    for i, n in enumerate(lengths):
        tables[i, :need[i]] = order[j:j + need[i]]
        j += need[i]
        if n % page:
            kp[int(tables[i, need[i] - 1]), n % page:] = GARBAGE
            vp[int(tables[i, need[i] - 1]), n % page:] = GARBAGE
    return dict(q=q, k=k, v=v, kp=kp, vp=vp,
                tables=torch.from_numpy(tables).to(dev),
                lengths=torch.tensor(lengths, dtype=torch.int32,
                                     device=dev), pages_read=sum(need))


def _bound(nbytes: float, flops: float, flop_rate: float):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flop_rate * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def _check(name, got, want, tol):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"{name}: max |err| {err} beyond {tol}")
    return err


def _fd_calls(fd, ref, x, chunk=None):
    """(name, replaces, kernel, plain, library, cap, page) of both
    flash-decode kernels on the inputs ``x``."""
    q, k, v, kp, vp, tables, lengths = (x[n] for n in (
        "q", "k", "v", "kp", "vp", "tables", "lengths"))
    mask = (torch.arange(k.shape[1], device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kt, vt, attn_mask=mask, enable_gqa=True)

    page = kp.shape[1]
    return [
        ("paged_flash_decode", "src/repro/kernels/flash_decode.py:115",
         lambda: fd.paged_flash_decode(q, kp, vp, tables, lengths, chunk),
         lambda: ref.paged_flash_decode_ref(q, kp, vp, tables, lengths),
         None, tables.shape[1] * page, page),
        ("flash_decode", "src/repro/kernels/flash_decode.py:169",
         lambda: fd.flash_decode(q, k, v, lengths, chunk),
         lambda: ref.flash_decode_ref(q, k, v, lengths),
         sdpa, k.shape[1], 1),
    ]


def _fd_case(fd, ref, x, chunk=None, timed=True):
    """Both kernels on ``x`` against their plain versions (and every
    0-length lane exactly 0); with ``timed``, each kernel's row: times,
    bound, plain and library times, and the split plan (C, n_split, the
    blocks launched and the blocks that hold valid positions)."""
    q, lengths = x["q"], x["lengths"]
    lens = lengths.tolist()
    b, hq, d = q.shape
    hkv = x["k"].shape[2]
    esize = q.element_size()
    ctx = sum(lens)
    io = 2 * q.numel() * esize + b * 4
    kv_bytes = 2 * ctx * hkv * d * esize
    tol = KERNEL_TOL if q.dtype == torch.bfloat16 else F32_KERNEL_TOL
    rows = {}
    for name, replaces, kern, plain, library, cap, page in _fd_calls(
            fd, ref, x, chunk):
        got = kern()
        err = _check(f"{name} {tuple(q.shape)} lengths {lens} "
                     f"chunk {chunk}", got, plain(), tol)
        if any((got[i] != 0).any() for i, n in enumerate(lens) if n == 0):
            raise AssertionError(f"{name}: a 0-length lane is not 0")
        if not timed:
            rows[name] = err
            continue
        c, n_split = fd.split_plan(cap, b, hkv, page, d * esize, chunk)
        table_bytes = x["pages_read"] * 4 if page > 1 else 0
        bound, by = _bound(io + kv_bytes + table_bytes, 4 * hq * d * ctx,
                           BF16_FLOP_PER_S)
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(library) if library else None,
            "shape": {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "page": page,
                      "cap": cap, "lengths": lens,
                      "dtype": str(q.dtype).replace("torch.", "")},
            "plan": {"C": c, "n_split": n_split,
                     "blocks": b * hkv * n_split,
                     "active_blocks": hkv * sum(-(-n // c) for n in lens)}}
    return rows


def _ragged_checks(fd, ref, gen):
    """Every instantiation (f32 and bf16 x D in fd.HEAD_DIMS x G in
    GROUPS), paged and dense, on lengths at the chunk edges (0, 1, C-1, C,
    C+1 and one lane over several chunks) with garbage past every length,
    at the planned C and at the largest C that fits; returns the largest
    |err| per dtype."""
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt).replace("torch.", "")
        row = torch.tensor([], dtype=dt).element_size()
        for d in fd.HEAD_DIMS:
            big = max(c for c in fd.CHUNKS
                      if c * d * row <= fd.MAX_TILE_BYTES)
            cap = 4 * big
            planned, _ = fd.split_plan(cap, 6, 2, PAGE, d * row)
            for g in GROUPS:
                for c in sorted({planned, big}):
                    lens = [0, 1, c - 1, c, c + 1, 3 * c + 5]
                    x = _fd_inputs(gen, lens, cap, dt, d, 2 * g, 2)
                    errs = _fd_case(fd, ref, x, c, timed=False)
                    worst[key] = max(worst.get(key, 0.0), *errs.values())
    return worst


def phase_kernels(fd, ref):
    """Both flash-decode kernels at chip_smoke's ragged shape (B=8,
    lengths 0..4096), at the serve's decode shape (B=4, lengths 768-778)
    and at stablelm-3b's (the same lengths, Hq = Hkv = 32, D = 80), timed;
    every instantiation on chunk-edge lengths."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    head = _fd_case(fd, ref, _fd_inputs(gen, LENGTHS, max(LENGTHS)))
    serve = _fd_case(fd, ref, _fd_inputs(gen, SERVE_LENGTHS, SERVE_CAP))
    stablelm = _fd_case(fd, ref, _fd_inputs(
        gen, SERVE_LENGTHS, SERVE_CAP, d=STABLELM_D, hq=STABLELM_HEADS,
        hkv=STABLELM_HEADS))
    ragged = _ragged_checks(fd, ref, gen)
    keys = ("shape", "plan", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "library_ms")
    rows = []
    for name, row in head.items():
        cases = [{k: case[name][k] for k in keys}
                 for case in (head, serve, stablelm)]
        del row["shape"], row["plan"]
        rows.append({**row, "cases": cases})
    print("[kernels] " + json.dumps({"ragged_max_abs_err": ragged,
                                     "kernels": rows}))
    return rows


def _device_ms(fn, iters: int = 10, pattern: str = r"decode_\w+") -> dict:
    """Mean device time of each kernel ``fn`` launches whose name matches
    ``pattern``, by that match, from ``torch.profiler`` over ``iters``
    calls, the L2 flushed before each."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(pattern, e.key)
        if name:
            out[name.group(0)] = e.self_device_time_total / e.count / 1e3
    return out


def phase_sweep(fd, ref, smi):
    """Time both kernels at both timed shapes for every C in fd.CHUNKS,
    with each launch's device time from the profiler."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {"chip_smoke": (LENGTHS, max(LENGTHS)),
              "serve": (SERVE_LENGTHS, SERVE_CAP)}
    out = []
    for label, (lens, cap) in shapes.items():
        x = _fd_inputs(gen, lens, cap)
        for c in sorted(fd.CHUNKS):
            rows = _fd_case(fd, ref, x, c)
            for name, _, kern, *_ in _fd_calls(fd, ref, x, c):
                row = rows[name]
                out.append({"shape": label, "kernel": name, **row["plan"],
                            **{k: row[k] for k in ("ms", "bound_ms",
                                                   "library_ms",
                                                   "max_abs_err")},
                            "device_ms": _device_ms(kern)})
    planned = {label: fd.split_plan(cap, len(lens), HKV, PAGE, D * 2)[0]
               for label, (lens, cap) in shapes.items()}
    print("[sweep] " + json.dumps({"planned_C": planned, "card": smi,
                                   "cases": out}))


def phase_sweep_gemm(sg, ref, smi):
    """Time the decode GEMM at each split count of GEMM_SPLITS (and the
    plan's) at its three bf16 shapes, with the kernel's device time from
    the profiler; the OS chunk may cover all of K here."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16 = torch.bfloat16
    out = []
    for m, n, k in GEMM_SHAPES:
        planned = sg.split_k_plan(m, n, k, bf16)
        plans = {}
        mp = sg.choose_mapping(m, n, k, bf16)
        if mp.dataflow == "OS":
            mp = sg.GemmMapping("OS", mp.block_m, sg.BLOCK_N, -(-k // 16) * 16)
        for split in sorted({*GEMM_SPLITS, planned[1]}):
            plans.setdefault(sg.split_k_plan(m, n, k, bf16, split, mp), split)
        for plan, split in plans.items():
            row = _gemm_case(sg, ref, gen, m, n, k, bf16, split=split,
                             profile=True)
            out.append({"split": split, "planned": plan == planned,
                        **{key: row[key] for key in (
                            "shape", "dataflow", "plan", "ms", "device_ms",
                            "bound_ms", "library_ms", "achieved_tb_per_s",
                            "max_abs_err")}})
    print("[sweep] " + json.dumps({"gemm": out, "card": smi}))


def phase_sweep_wkv(wk, ref, smi):
    """Time WKV6 at rwkv6-7b's prefill width (B=1, H=64, hs=64, float32,
    as the model passes it) for each T of WKV_SWEEP_T on the serial
    design and on the chunked one at every C, with each launch's device
    time from the profiler; print the crossover T (the smallest T from
    which the best chunked C beats the serial design at every longer T)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out, best = [], {}
    for t in WKV_SWEEP_T:
        args = _wkv_inputs(gen, 1, t, torch.float32)
        for chunk in (0, *wk.CHUNKS):
            row = _wkv_case(wk, ref, gen, 1, t, torch.float32, chunk, args,
                            timed=False)

            def kern():
                return wk.wkv6(*args, chunk=chunk)

            row.update(t=t, ms=time_ms(kern),
                       device_ms=_device_ms(kern, pattern=r"wkv6_\w+"),
                       bound_ms=_wkv_bound(1, t, 4)[0])
            out.append(row)
            key = "serial" if chunk == 0 else "chunked"
            if row["ms"] < best.get((t, key), (float("inf"),))[0]:
                best[(t, key)] = (row["ms"], chunk)
    wins = [best[(t, "chunked")][0] < best[(t, "serial")][0]
            for t in WKV_SWEEP_T]
    cross = next((t for i, t in enumerate(WKV_SWEEP_T) if all(wins[i:])),
                 None)
    print("[sweep] " + json.dumps({
        "wkv6": out, "crossover_T": cross,
        "best_C": {t: best[(t, "chunked")][1] for t in WKV_SWEEP_T},
        "planned": {"C": wk.PLANNED_CHUNK, "min_T": wk.CHUNKED_MIN_T},
        "card": smi}))


def _wkv_inputs(gen, b, t, dtype):
    """rwkv6-7b-shaped WKV6 inputs: r/k/v ~ N(0,1), decay in (0.4, 0.9),
    small bonus and state (the distributions of tests/test_kernels.py)."""
    shape = (b, t, WKV_H, WKV_HS)

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda")

    r, k, v = (randn(*shape).to(dtype) for _ in range(3))
    w = (torch.sigmoid(randn(*shape)) * 0.5 + 0.4).to(dtype)
    u = (randn(WKV_H, WKV_HS) * 0.1).to(dtype)
    s0 = randn(b, WKV_H, WKV_HS, WKV_HS) * 0.1
    return r, k, v, w, u, s0


def _wkv_bound(b, t, esize):
    """Inputs read once, y and the state written once; 5 hs^2 flops per
    (b, h, t): y = r.S + v (r.(u*k)), S <- w*S + k v^T."""
    n = b * t * WKV_H * WKV_HS
    nbytes = 5 * n * esize + WKV_H * WKV_HS * esize \
        + 2 * b * WKV_H * WKV_HS * WKV_HS * 4
    return _bound(nbytes, 5 * n * WKV_HS, F32_FLOP_PER_S)


def _wkv_case(wk, ref, gen, b, t, dtype, chunk=None, args=None,
              timed=True):
    """WKV6 at (b, t) against the plain recurrence (and a chunked call
    against the plain rendering of its chunks too); its row: the plan,
    times and bound, with ``timed``."""
    args = args or _wkv_inputs(gen, b, t, dtype)
    plan = wk.chunk_plan(b, t, WKV_H, WKV_HS, dtype, chunk)
    y, s_t = wk.wkv6(*args, chunk=chunk)
    tol = WKV_TOL[dtype]
    name = f"wkv6 {plan.design} C={plan.chunk} B={b} T={t} {dtype}"
    plains = [ref.wkv6_ref(*args)]
    if plan.design == "chunked":
        plains.append(ref.wkv6_chunked_ref(*args, chunk=plan.chunk))
    err = max(max(_check(name + " y", y, yr, tol),
                  _check(name + " state", s_t, sr, tol))
              for yr, sr in plains)
    if not (torch.isfinite(y).all() and torch.isfinite(s_t).all()):
        raise AssertionError(f"{name}: non-finite output")
    plan_row = {"design": plan.design, "C": plan.chunk,
                "blocks": plan.blocks, "chunks": plan.chunks}
    if not timed:
        return {"max_abs_err": err, "plan": plan_row}
    bound, by = _wkv_bound(b, t, args[0].element_size())
    return {"shape": {"B": b, "T": t, "H": WKV_H, "hs": WKV_HS},
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
            "plan": plan_row,
            "ms": time_ms(lambda: wk.wkv6(*args, chunk=chunk)),
            "plain_ms": time_ms(lambda: ref.wkv6_ref(*args), iters=3),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            # dependent steps per (b, h): T serial, or one per chunk
            "serial_steps": plan.chunks or t}


def _repeatable(name, fn):
    """Two calls and two replays of a CUDA graph holding a third give the
    same bits (the split-K tile counters are back at 0 after each call,
    and the partials are summed in split order)."""
    first = fn()
    same = torch.equal(fn(), first)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        out.zero_()
        graph.replay()
        same = same and torch.equal(out, first)
    del graph
    if not same:
        raise AssertionError(f"{name}: outputs differ between calls")
    return True


def _gemm_inputs(gen, m, n, k, dtype, b_cols=None):
    """a (M, K) and b (K, N); with ``b_cols`` b is the first N columns of
    a (K, b_cols) buffer (rows 16-byte aligned, N ragged)."""
    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    b = torch.randn(k, b_cols or n, generator=gen, device="cuda").to(dtype)
    return a, b[:, :n]


def _gemm_case(sg, ref, gen, m, n, k, dtype, b_cols=None, split=None,
               profile=False):
    """The decode GEMM against its plain version (and against the plain
    rendering of its split), bitwise repeatable; its row: the split plan,
    times, bound and achieved TB/s, and with ``profile`` the kernel's
    device time from the profiler."""
    a, b = _gemm_inputs(gen, m, n, k, dtype, b_cols)
    mp = sg.choose_mapping(m, n, k, dtype)
    if split is not None and mp.dataflow == "OS":
        mp = sg.GemmMapping("OS", mp.block_m, sg.BLOCK_N, -(-k // 16) * 16)
    bk, n_split = sg.split_k_plan(m, n, k, dtype, split, mp)
    name = f"decode_gemm {m}x{n}x{k} {dtype} split {split}"

    def kern():
        return sg.snake_decode_gemm(a, b, mp, split)

    got = kern()
    err = max(_check(name, got, ref.decode_gemm_ref(a, b), GEMM_TOL[dtype]),
              _check(name + " (split plain)", got,
                     ref.decode_gemm_split_ref(a, b, bk), GEMM_TOL[dtype]))
    _repeatable(name, kern)
    tiles = -(-n // sg.BLOCK_N) * -(-m // sg.row_tile(dtype))
    row = {"shape": {"M": m, "N": n, "K": k,
                     "b_row_stride": b.stride(0)},
           "dtype": str(dtype).replace("torch.", ""),
           "dataflow": mp.dataflow, "max_abs_err": err,
           "bitwise_repeatable": True,
           "plan": {"bk": bk, "n_split": n_split,
                    "blocks": tiles * n_split}}
    if profile:
        row["device_ms"] = _device_ms(kern, pattern=r"snake_gemm_kernel")
    esize = a.element_size()
    nbytes = (m * k + k * n + m * n) * esize
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    bound, by = _bound(nbytes, 2 * m * n * k, rate)
    ms = time_ms(kern)
    return {**row, "ms": ms,
            "plain_ms": time_ms(lambda: ref.decode_gemm_ref(a, b)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lambda: torch.matmul(a, b)),
            "achieved_tb_per_s": nbytes / ms / 1e9}


def _row(name, source, replaces, head, cases):
    """One kernel's JSON row: the numbers of its main-path case ``head``,
    every case beside them."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            **{k: head[k] for k in keys}, "cases": cases}


def phase_kernels_rwkv(wk, sg, ref):
    """WKV6 and the decode GEMM at rwkv6-7b shapes; returns their rows."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    wkv = [_wkv_case(wk, ref, gen, b, t, dt)
           for b, t in ((4, 1),) + WKV_PREFILLS for dt in (f32, bf16)]
    # decays as the model forms them, exp(-exp(x)) for x in [-8, 5]
    # (exact zeros past x ~ 4.5), on the planned design
    r, k, v, _, u, s0 = _wkv_inputs(gen, 1, 1024, f32)
    x = torch.rand(r.shape, generator=gen, device="cuda") * 13.0 - 8.0
    w = torch.exp(-torch.exp(x))
    extreme = _wkv_case(wk, ref, gen, 1, 1024, f32,
                        args=(r, k, v, w, u, s0), timed=False)
    extreme["zero_decays"] = int((w == 0).sum())
    # state carry (chunked): one sweep over T1 + T2 equals T2 after T1
    r, k, v, w, u, s0 = _wkv_inputs(gen, 1, 1024, f32)
    y, s_full = wk.wkv6(r, k, v, w, u, s0)
    t1 = 400
    y1, s1 = wk.wkv6(r[:, :t1], k[:, :t1], v[:, :t1], w[:, :t1], u, s0)
    y2, s2 = wk.wkv6(r[:, t1:], k[:, t1:], v[:, t1:], w[:, t1:], u, s1)
    # the model's call: the new state written over the old one in place
    s_io = s0.clone()
    y_io, _ = wk.wkv6(r, k, v, w, u, s_io, s_io)
    carry = max(_check("wkv6 carry y", torch.cat([y1, y2], 1), y,
                       WKV_TOL[f32]),
                _check("wkv6 carry state", s2, s_full, WKV_TOL[f32]),
                _check("wkv6 in-place y", y_io, y, WKV_TOL[f32]),
                _check("wkv6 in-place state", s_io, s_full, WKV_TOL[f32]))
    gemm = [_gemm_case(sg, ref, gen, m, n, kk, bf16)
            for m, n, kk in GEMM_SHAPES + [(16, 14336, 4096)]]
    # ragged bf16 (N % 8 != 0, K % 16 != 0): IS on a 16-byte aligned view
    # (cp.async zero-fills past N), OS contiguous (rows off 16 bytes, so
    # element loads)
    gemm.append(_gemm_case(sg, ref, gen, 5, 1001, 333, bf16, b_cols=1024))
    gemm.append(_gemm_case(sg, ref, gen, 7, 1001, 3003, bf16))
    gemm.append(_gemm_case(sg, ref, gen, 13, 257, 129, f32))
    flows = {c["dataflow"] for c in gemm}
    if flows != {"IS", "OS"}:
        raise AssertionError(f"decode GEMM dataflows run: {flows}")
    src = "src/repro_torch/kernels/csrc/"
    serial = [c for c in wkv if c["plan"]["design"] == "serial"]
    chunked = [c for c in wkv if c["plan"]["design"] == "chunked"]
    rows = [_row("wkv6", src + "wkv6.cu", "src/repro/kernels/wkv6.py:49",
                 serial[0], serial),
            _row("wkv6_chunked", src + "wkv6.cu",
                 "src/repro/kernels/wkv6.py:49",
                 next(c for c in chunked if c["shape"]["T"] == 1024
                      and c["dtype"] == "float32"), chunked)]
    for flow, line in (("IS", 90), ("OS", 97)):
        cases = [c for c in gemm if c["dataflow"] == flow]
        rows.append(_row(f"snake_decode_gemm_{flow.lower()}",
                         src + "snake_gemm.cu",
                         f"src/repro/kernels/snake_gemm.py:{line}",
                         cases[0], cases))
    print("[kernels] " + json.dumps({"wkv6_state_carry_max_abs_err": carry,
                                     "wkv6_extreme_decays": extreme,
                                     "kernels": rows}))
    return rows


def _reset(kmods):
    for mod in kmods:
        mod.reset_launches()


def _launches(kmods):
    return {k: v for mod in kmods for k, v in mod.LAUNCHES.items()}


def _watch(eng):
    """Count the engine's decode steps and check their logits stay
    finite, without a host sync per step; keep the last logits."""
    seen = {"steps": 0, "finite": True, "logits": None, "rows": []}
    decode = eng._decode_batch

    def counted(toks):
        seen["rows"] = sorted(eng.active)
        logits = decode(toks)
        seen["steps"] += 1
        seen["finite"] = torch.isfinite(logits).all() & seen["finite"]
        seen["logits"] = logits
        return logits

    eng._decode_batch = counted
    return seen


def _lockstep(entry, params, ecfg_kw, trace):
    """Plain engine and kernel engine ticked together on one trace; the
    kernel run is teacher-forced on the plain run's tokens."""
    from repro_torch.serving.engine import EngineConfig, make_engine
    engines = [make_engine(entry, EngineConfig(use_pallas_decode=kern,
                                               **ecfg_kw), params=params)
               for kern in (False, True)]
    seen = [_watch(e) for e in engines]
    pending = [trace(), trace()]
    n, agree, total, err = len(pending[0]), 0, 0, 0.0
    while len(engines[0].completed) < n:
        for eng, pend in zip(engines, pending):
            while pend and eng.admit(pend[0]):   # all arrived at t=0
                pend.pop(0)
        steps = [s["steps"] for s in seen]
        for eng in engines:
            eng.tick()
        ran = [s["steps"] - x for s, x in zip(seen, steps)]
        if ran[0] != ran[1] or seen[0]["rows"] != seen[1]["rows"]:
            raise AssertionError("engines fell out of lockstep")
        if ran[0]:
            rows = seen[0]["rows"]
            lp, lk = (s["logits"][rows].float() for s in seen)
            err = max(err, (lk - lp).abs().max().item())
            if not torch.allclose(lk, lp, **PARITY_TOL):
                raise AssertionError(f"kernel logits off by {err}")
            agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
            total += len(rows)
        plain = {r.rid: r for r in engines[0].completed}
        plain.update({r.rid: r for r in engines[0].active.values()})
        for slot, req in engines[1].active.items():   # teacher forcing
            req.tokens_out[-1] = plain[req.rid].tokens_out[-1]
            engines[1]._next_tok[slot] = engines[0]._next_tok[slot]
    return agree, total, err


def _streams(eng):
    return {r.rid: (r.tokens_out, r.finish_reason) for r in eng.completed}


def _fused_parity(entry, params, ecfg_kw, trace):
    """The fused paged engine (fuse_steps=8, kernels on) against the
    per-tick paged engine on one trace: the same tokens, bit for bit (the
    two launch the same kernels at the same shapes).  Returns the
    per-tick and the fused engine."""
    from repro_torch.serving.engine import EngineConfig, make_engine
    runs = []
    for fuse in (1, 8):
        eng = make_engine(entry, EngineConfig(use_pallas_decode=True,
                                              fuse_steps=fuse, **ecfg_kw),
                          params=params)
        eng.run_trace(trace())
        runs.append(eng)
    per_tick, fused = (_streams(e) for e in runs)
    if fused != per_tick:
        bad = sorted(rid for rid in per_tick if fused.get(rid) !=
                     per_tick[rid])
        raise AssertionError(f"fused tokens differ from per-tick for "
                             f"requests {bad}")
    n = sum(len(t) for t, _ in per_tick.values())
    what = "shared " if ecfg_kw.get("prefix_sharing") else ""
    print(f"[parity] fused {what}paged engine (fuse_steps 8, graphs "
          f"{sorted(runs[1]._fused_graphs)}) vs per-tick, "
          f"{entry.config.name} 2 layers f32: tokens {n}/{n} identical, "
          f"{runs[1].fused_report()}")
    return runs


def _shared_parity(entry, params, base, sched):
    """Prefix sharing under both decode paths (kernels on, prefill chunks
    of 4): four identical 37-token prompts, the last two extended by 11
    unique tokens.  Request 1 maps all three pages of request 0's prompt
    (the tail page by exact match), recomputes only the last token and
    forks the tail page at its first decode write; requests 2 and 3 map
    the two full pages and prefill 16 tokens in 4 chunks, holding live
    shared pages while the decode batch runs."""
    vocab = entry.config.vocab

    def trace():
        reqs = sched.make_shared_prefix_trace(
            vocab, rate_req_s=1e9, n_requests=4, prefix_len=37, tail_len=0,
            seed=2)
        rng = np.random.default_rng(4)
        for r in reqs[2:]:
            r.prompt = np.concatenate(
                [r.prompt, rng.integers(0, vocab, 11).astype(np.int32)])
        return reqs

    runs = _fused_parity(entry, params, dict(base, paged=True,
                                             prefix_sharing=True,
                                             prefill_chunk=4), trace)
    reports = [e.kv_report() for e in runs]
    for rep in reports:
        # 36 + 32 + 32 prompt tokens skipped; one fork of the tail page
        # (request 1's first write; request 0's page is then its own)
        if (rep["prefill_skipped_tokens"] != 100 or rep["cow_forks"] != 1
                or rep["dedup_ratio_peak"] <= 1.0):
            raise AssertionError(f"sharing counters off: {rep}")
    print("[parity] shared paged engine (per tick, fused): "
          + json.dumps({k: [r[k] for r in reports] for k in (
              "cow_forks", "prefill_skipped_tokens", "dedup_ratio_peak",
              "peak_tokens")}))


def _placed_parity(entry, params, sched):
    """Affinity placement with sharing under the fused tick (kernels on)
    against the same engine unplaced, on a pool small enough to spill
    and then migrate at defrag: the same tokens, at least one page moved,
    and the device table mirror equal to the host tables."""
    from repro_torch.serving.engine import EngineConfig, make_engine
    ecfg = dict(PLACED, max_seq=int(PLACED_LENS.max())
                + PLACED["max_new_tokens"] + 2)
    runs = {}
    for placement in (None, "affinity"):
        eng = make_engine(entry, EngineConfig(placement=placement, **ecfg),
                          params=params)
        metrics = eng.run_trace(sched.make_trace(
            entry.config.vocab, rate_req_s=1e9, n_requests=len(PLACED_LENS),
            prompt_len=0, prompt_lens=PLACED_LENS, seed=2))
        runs[placement] = eng, metrics
    (plain, _), (placed, m) = runs[None], runs["affinity"]
    _same_streams("placed vs unplaced fused, 2 layers f32",
                  _streams(placed), _streams(plain))
    if (m["kv_migrated_pages"] < 1 or m["fused_ticks"] < 1
            or not placed.paged.mirror_consistent()):
        raise AssertionError(f"placed run: no migrate, no fused tick or a "
                             f"stale mirror: {m}")
    n = sum(len(t) for t, _ in _streams(plain).values())
    print(f"[parity] placed fused paged engine (affinity, 2 regions, "
          f"sharing) vs unplaced, {entry.config.name} 2 layers f32: "
          f"tokens {n}/{n} identical, mirror consistent; " + json.dumps(
              {k: m[k] for k in ("kv_migrated_pages", "kv_migration_cost_s",
                                 "preemptions", "defrag_runs",
                                 "fused_ticks", "kv_gather_cost_mean_s",
                                 "kv_region_peak")}))


def phase_parity(registry, sched):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lens = np.array([100, 300, 17, 180])
    base = dict(max_batch=4, max_seq=int(lens.max()) + 18,
                max_new_tokens=16, page_size=PAGE, prefill_chunk=128)
    for arch in ("yi-6b", "rwkv6-7b", "qwen3-30b-a3b", "stablelm-3b",
                 "qwen2-vl-7b"):
        entry = registry.get(arch, num_layers=2, dtype="float32")
        params = entry.module.init(entry.config, device="cuda", seed=1)

        def trace():
            return sched.make_trace(entry.config.vocab, rate_req_s=1e9,
                                    n_requests=len(lens), prompt_len=0,
                                    seed=2, prompt_lens=lens)

        for paged in (True, False):
            agree, total, err = _lockstep(entry, params,
                                          dict(base, paged=paged), trace)
            print(f"[parity] {'paged' if paged else 'dense'} engine, "
                  f"kernels vs plain, {arch} 2 layers f32: max |logit err| "
                  f"{err:.3g} (tol {PARITY_TOL}), token agreement "
                  f"{agree}/{total}")
        if arch in ("yi-6b", "qwen3-30b-a3b"):
            _fused_parity(entry, params, dict(base, paged=True), trace)
        if arch == "yi-6b":
            _shared_parity(entry, params, base, sched)
            _placed_parity(entry, params, sched)
        del params
        _free()


def _serve(entry, params, ecfg, reqs, sched, kmods, kernel, smi):
    """Serve the request trace ``reqs`` after a 1-request warm-up; check
    that every request finished its budget with finite logits and that the
    launch counts are the main path's: ``kernel`` once per layer per
    decode step (the WKV6 kernel also once per layer per prefill, there
    on the chunked design; a fused engine's steps are the bucketed
    ``n_steps`` of each horizon, counted through the graph replays),
    every other kernel never.  A fused engine captures every bucket up
    to its ``fuse_steps`` before the trace.  Returns the counts, the
    metrics and each request's (tokens, finish reason)."""
    from repro_torch.serving.engine import EngineConfig, make_engine
    cfg = entry.config
    new = ecfg["max_new_tokens"]
    fuse = ecfg.get("fuse_steps", 1)
    warm = make_engine(entry, EngineConfig(**ecfg), params=params)
    warm.run_trace(sched.make_trace(cfg.vocab, rate_req_s=1e9, n_requests=1,
                                    prompt_len=130, seed=9))
    eng = make_engine(entry, EngineConfig(**ecfg), params=params)
    capture_s = 0.0
    if fuse > 1:
        t0 = time.perf_counter()
        for n in range(1, fuse.bit_length()):
            eng._fused_fn(1 << n)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
    seen = _watch(eng)
    prefills = []
    prefill = eng._prefill
    eng._prefill = lambda *a: prefills.append(1) or prefill(*a)
    _reset(kmods)
    metrics = eng.run_trace(reqs)
    counts = _launches(kmods)
    done = eng.completed
    if len(done) != len(reqs) or any(
            r.finish_reason != "budget" or len(r.tokens_out) != new
            or not all(0 <= t < cfg.vocab for t in r.tokens_out)
            for r in done):
        got = [(r.rid, len(r.tokens_out), r.finish_reason) for r in done]
        raise AssertionError(f"not every request finished its budget: "
                             f"{got}")
    if not bool(seen["finite"]):
        raise AssertionError("non-finite logits in a decode step")
    horizons = getattr(eng, "fused_horizons", [])
    fused_steps = sum(1 << (k - 1).bit_length() for k in horizons)
    if horizons:
        # host time the fused ticks spent pricing (placement sample and
        # the per-step tick model), a share of the fused host time
        metrics["pricing_host_ms_per_horizon"] = (
            eng.pricing_host_s / len(horizons) * 1e3)
    runs = (seen["steps"] + fused_steps
            + (len(prefills) if kernel == "wkv6" else 0))
    want = {kernel: runs * cfg.num_layers}
    if kernel == "wkv6":
        # every prompt (>= 256 tokens) takes the chunked design, every
        # decode step (T = 1) the serial one
        want["wkv6_chunked"] = len(prefills) * cfg.num_layers
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"launches {counts}, want {want}")
    keep = ("requests", "decoded_tokens", "tokens_per_s", "tbt_mean_s",
            "tbt_p99_s", "ttft_mean_s", "preemptions", "defrag_runs",
            "kv_peak_tokens", "kv_dedup_ratio_peak", "cow_forks",
            "prefill_skipped_tokens", "wall_s")
    if ecfg.get("codesign"):
        keep += ("modeled_tokens_per_s", "reconfigurations",
                 "array_util_mean")
    mode = "paged" if ecfg["paged"] else "dense"
    if ecfg.get("prefix_sharing"):
        mode += " shared"
    if ecfg.get("placement"):
        mode += f" placed ({ecfg['placement']})"
    if ecfg.get("codesign"):
        mode += " priced"
    if fuse > 1:
        mode += f" fused (fuse_steps {fuse})"
    print(f"[serve] {cfg.name} {cfg.num_layers} layers bf16, {mode} engine "
          f"+ {kernel}: prompts {[len(r.prompt) for r in reqs]}, {new} new "
          f"tokens, "
          f"{len(prefills)} whole-prompt prefills, {seen['steps']} per-tick "
          f"decode steps, {len(horizons)} fused horizons of "
          f"{fused_steps} bucketed steps, launches {counts}; "
          f"{json.dumps({k: metrics[k] for k in keep})} on {smi}")
    if fuse > 1:
        print("[serve] fused " + json.dumps({
            "fuse_steps": fuse, "fused_report": eng.fused_report(),
            "horizons": horizons, "buckets": sorted(eng._fused_graphs),
            "capture_s": capture_s,
            "replays": {n: g.replays for n, g in eng._fused_graphs.items()},
            "metrics": {k: v for k, v in metrics.items() if k != "hists"},
            "fused_horizon_hist": metrics["hists"]["fused_horizon"],
            "card": smi}))
    return counts, metrics, _streams(eng)


def _init_full(registry, arch):
    entry = registry.get(arch)
    t0 = time.perf_counter()
    params = entry.module.init(entry.config, device="cuda", seed=0)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    print(f"[serve] {arch} weights: "
          f"{sum(t.numel() for t in leaves) / 1e9:.2f} B parameters, "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} "
          f"GB, init {time.perf_counter() - t0:.1f} s")
    return entry, params


def _free():
    """Release what earlier runs held on the card: the engines (a watched
    engine refers to itself, so only the collector frees it), their
    pools and captured graphs, the cuBLAS workspace kept for each stream
    a capture ran on, then the allocator's cached blocks."""
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _same_streams(label, got, want):
    if got != want:
        bad = sorted(rid for rid in want if got.get(rid) != want[rid])
        raise AssertionError(f"{label}: tokens differ for requests {bad}")


def _fork_cost(entry):
    """One copy-on-write fork at full width: ``PagedCache.fork_page`` on
    a page two slots map, host clock around the call and a synchronise;
    and the device time of its copies alone (every sequence pool's page
    copied in place), replayed from a CUDA graph with the L2 flushed.
    The bound reads and writes each pool's page once."""
    from repro_torch.serving.paged_cache import PagedCache
    pc = PagedCache(entry, max_batch=2, max_seq=2 * PAGE, page_size=PAGE,
                    num_pages=4, share=True, device="cuda")
    prompt = np.arange(PAGE, dtype=np.int32)
    if not (pc.alloc_slot(0, PAGE, tokens=prompt)):
        raise AssertionError("fork setup: no pages")
    pc.commit_prefix(0)
    if not (pc.alloc_slot(1, PAGE, tokens=prompt)
            and pc.alloc.refcount(int(pc.tables[1, 0])) == 2):
        raise AssertionError("fork setup: the page is not shared")
    pools = [t for t, seq in zip(pc.store, pc.is_seq) if seq]
    for pool in pools:
        pool.normal_()
    pc.tables_device()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not pc.fork_page(1, 0):
        raise AssertionError("fork_page found no free page")
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    old, new = int(pc.tables[0, 0]), int(pc.tables[1, 0])
    for pool in pools:
        if not torch.equal(pool[:, new], pool[:, old]):
            raise AssertionError("the forked page differs from its source")
    if not pc.mirror_consistent():
        raise AssertionError("fork left the table mirror stale")

    def copies():
        for pool in pools:
            pool[:, new].copy_(pool[:, old])

    nbytes = 2 * sum(pool[:, old].numel() * pool.element_size()
                     for pool in pools)
    return {"fork_host_ms": host_ms, "fork_device_ms": time_ms(copies),
            "fork_bytes": nbytes,
            "fork_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def _serve_shared(entry, params, base, sched, kmods, smi, launches):
    """The shared-prefix serves at full width, every run fusing up to 16
    steps a tick: the 768 + 128 trace without and with sharing (the same
    tokens; a lower KV peak; dedup > 1; 768 prefill tokens skipped for
    each request admitted while the prefix is resident: on the card 3 x
    768, since the three later requests arrive at 0.43 s while request
    0's seven chunks still run, and are admitted one at a time after its
    commit), then identical 777-token prompts, shared, per tick and fused
    (the same tokens; the ragged tail page forked)."""
    vocab = entry.config.vocab
    runs = launches["paged_flash_decode"]

    def trace(prefix, tail):
        return sched.make_shared_prefix_trace(
            vocab, rate_req_s=4.0, n_requests=4, prefix_len=prefix,
            tail_len=tail, seed=0)

    fused = dict(base, paged=True, fuse_steps=PAGE,
                 max_seq=SHARED_PREFIX + SHARED_TAIL
                 + base["max_new_tokens"] + 2)
    out = {}
    for share in (False, True):
        label = f"yi-6b {SHARED_PREFIX}+{SHARED_TAIL} " + (
            "shared fused" if share else "unshared fused")
        counts, metrics, streams = _serve(
            entry, params, dict(fused, prefix_sharing=share),
            trace(SHARED_PREFIX, SHARED_TAIL), sched, kmods,
            "paged_flash_decode", smi)
        runs[label] = counts["paged_flash_decode"]
        out[share] = metrics, streams
    (plain, plain_t), (shared, shared_t) = out[False], out[True]
    _same_streams("shared vs unshared serve", shared_t, plain_t)
    skipped = shared["prefill_skipped_tokens"]
    if (skipped % SHARED_PREFIX or not 0 < skipped <= 3 * SHARED_PREFIX
            or plain["prefill_skipped_tokens"] != 0
            or not shared["kv_peak_tokens"] < plain["kv_peak_tokens"]
            or not shared["kv_dedup_ratio_peak"] > 1.0):
        raise AssertionError(f"sharing counters off: shared {shared}, "
                             f"unshared {plain}")
    same = {}
    for fuse in (1, PAGE):
        label = (f"yi-6b {IDENTICAL_PROMPT} identical shared "
                 + ("fused" if fuse > 1 else "per tick"))
        counts, metrics, same[fuse] = _serve(
            entry, params, dict(fused, prefix_sharing=True, fuse_steps=fuse),
            trace(IDENTICAL_PROMPT, 0), sched, kmods, "paged_flash_decode",
            smi)
        runs[label] = counts["paged_flash_decode"]
        if metrics["cow_forks"] < 1:
            raise AssertionError(f"{label}: no copy-on-write fork")
    _same_streams("identical prompts, fused vs per tick", same[PAGE],
                  same[1])
    keys = ("ttft_mean_s", "tbt_mean_s", "tokens_per_s", "kv_peak_tokens",
            "kv_dedup_ratio_peak", "prefill_skipped_tokens", "cow_forks")
    print("[serve] shared prefix " + json.dumps({
        "unshared": {k: plain[k] for k in keys},
        "shared": {k: shared[k] for k in keys},
        "tokens_identical": sum(len(t) for t, _ in plain_t.values()),
        **_fork_cost(entry), "card": smi}))


def _policy_kernel_ms(fd):
    """The paged kernel at the serve's decode shape (B=4, lengths
    768-778, bf16) with its block table laid out by each placement
    policy over the same pool (the serve's default map: one region per
    PU of the SNAKE template) and the same K/V contents: the output must
    not change, and neither should the time (a 32 KB page is far larger
    than any HBM burst)."""
    from repro_torch.core.placement import PlacementMap, default_system
    from repro_torch.serving.paged_cache import PageAllocator
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = _fd_inputs(gen, SERVE_LENGTHS, SERVE_CAP)
    q, kp, vp, tables, lengths = (x[n] for n in (
        "q", "kp", "vp", "tables", "lengths"))
    want = fd.paged_flash_decode(q, kp, vp, tables, lengths)
    n_pages = kp.shape[0] - 1
    need = [-(-n // PAGE) for n in SERVE_LENGTHS]
    old = tables.cpu().numpy()
    out = {}
    for policy in ("free-first", "affinity", "interleave"):
        pmap = PlacementMap.from_system(default_system(), n_pages)
        alloc = PageAllocator(n_pages, placement=pmap, policy=policy)
        t = np.full(old.shape, n_pages, np.int32)
        for i, n in enumerate(need):
            free = alloc.region_free()
            # the engine's home choice: the most free region, ties low
            home = (min(free, key=lambda r: (-free[r], r))
                    if alloc.placed else None)
            t[i, :n] = alloc.alloc(n, home=home)
        kp2, vp2 = kp.clone(), vp.clone()
        src = torch.from_numpy(old[old < n_pages]).long().cuda()
        dst = torch.from_numpy(t[old < n_pages]).long().cuda()
        kp2[dst], vp2[dst] = kp[src], vp[src]
        t_dev = torch.from_numpy(t).cuda()
        got = fd.paged_flash_decode(q, kp2, vp2, t_dev, lengths)
        if not torch.equal(got, want):
            raise AssertionError(f"paged kernel under {policy}: output "
                                 f"differs from the shuffled table's")
        out[policy] = {
            "ms": time_ms(lambda: fd.paged_flash_decode(q, kp2, vp2, t_dev,
                                                        lengths)),
            "regions_per_slot": [len({pmap.region_of(int(p))
                                      for p in t[i, :n]})
                                 for i, n in enumerate(need)]}
    return {"pages": n_pages, "regions": pmap.n_regions, **out}


def _serve_placed(entry, params, base, trace, sched, kmods, smi, launches,
                  fused_m, fused):
    """yi-6b at full width on the fused serve of §4 with affinity
    placement and co-design pricing: the unplaced fused run's tokens;
    TBT, TTFT and tokens/s beside that run's (the same process), the
    modeled numbers, the host time of pricing a horizon, and the paged
    kernel timed under two placement policies."""
    counts, m, streams = _serve(
        entry, params, dict(base, paged=True, fuse_steps=PAGE,
                            placement="affinity", codesign=True),
        trace(), sched, kmods, "paged_flash_decode", smi)
    _same_streams("placed priced fused serve vs unplaced fused", streams,
                  fused)
    launches["paged_flash_decode"]["yi-6b paged fused affinity codesign"] \
        = counts["paged_flash_decode"]
    if not (m["modeled_time_s"] > 0 and m["kv_gather_cost_mean_s"] > 0
            and m["placement_policy"] == "affinity"):
        raise AssertionError(f"placed priced serve reports nothing: {m}")
    wall = ("tbt_mean_s", "tbt_p99_s", "ttft_mean_s", "tokens_per_s",
            "fused_host_frac")
    print("[serve] placed priced " + json.dumps({
        "unplaced_fused": {k: fused_m[k] for k in wall},
        "affinity_codesign_fused": {k: m[k] for k in wall},
        "modeled": {k: m[k] for k in (
            "codesign_substrate", "modeled_time_s", "modeled_tokens_per_s",
            "reconfigurations", "substrate_configs", "array_util_mean",
            "kv_gather_cost_mean_s", "kv_gather_concentration",
            "kv_migrated_pages", "kv_migration_cost_s")},
        "pricing_host_ms_per_horizon": m["pricing_host_ms_per_horizon"],
        "fused_ticks": m["fused_ticks"],
        "tokens_identical": sum(len(t) for t, _ in fused.values()),
        "paged_kernel_by_policy": _policy_kernel_ms(kmods[0]),
        "card": smi}))


def _gpu_model_line(entry, params, sched, smi):
    """The paper's GPU model (``core.gpu_model.gpu_decode_step`` at tp=1)
    beside a measured fused step on this card: B=4 lanes of 768-token
    prompts (prefilled whole at admission, so all four decode from the
    first tick), ticks of up to 16 fused steps timed on the host
    clock (each tick fetches its tokens, so it waits for the card) over
    at least 48 steps, in ms per decoded step.  A record, not a target."""
    from repro_torch.core.gpu_model import gpu_decode_step
    from repro_torch.serving.engine import EngineConfig, make_engine
    b, ctx, window = GPU_MODEL_BATCH, GPU_MODEL_CTX, GPU_MODEL_WINDOW
    new = 2 * window + 2 * PAGE
    eng = make_engine(entry, EngineConfig(
        max_batch=b, max_seq=ctx + new + 2, max_new_tokens=new, paged=True,
        page_size=PAGE, use_pallas_decode=True, fuse_steps=PAGE),
        params=params)
    for n in range(1, PAGE.bit_length()):
        eng._fused_fn(1 << n)
    for req in sched.make_trace(entry.config.vocab, rate_req_s=1e9,
                                n_requests=b, prompt_len=ctx, seed=5):
        if not eng.admit(req):
            raise AssertionError("GPU-model run: a request was refused")
    eng.tick()
    torch.cuda.synchronize()
    ctx0 = statistics.mean(eng._active_ctxs())
    steps, t0 = 0, time.perf_counter()
    while steps < window:
        n0 = len(eng.fused_horizons)
        eng.tick()
        steps += eng.fused_horizons[-1] if len(eng.fused_horizons) > n0 \
            else 1
    ms = (time.perf_counter() - t0) * 1e3 / steps
    if len(eng.active) != b:
        raise AssertionError("a lane finished inside the timed window")
    ctx_mid = ctx0 + steps / 2
    spec = entry.config.nmp_spec()
    print("[gpu-model] " + json.dumps({
        "arch": entry.config.name, "batch": b,
        "prompt_ctx": ctx,
        "predicted_ms_prompt_ctx": gpu_decode_step(spec, b, ctx,
                                                   tp=1).time_s * 1e3,
        "predicted_ms_window_ctx": gpu_decode_step(
            spec, b, round(ctx_mid), tp=1).time_s * 1e3,
        "window_ctx_mean": ctx_mid, "measured_fused_ms_per_step": ms,
        "steps": steps, "card": smi}))
    del eng
    _free()


def phase_serve(registry, sched, kmods, smi):
    """Returns each kernel's launches by serve run."""
    lens = np.random.default_rng(0).integers(256, 1025, size=4)
    new = 32
    base = dict(max_batch=4, max_seq=int(lens.max()) + new + 2,
                max_new_tokens=new, page_size=PAGE, prefill_chunk=128,
                use_pallas_decode=True)

    def trace(vocab=None):
        return sched.make_trace(vocab or entry.config.vocab, rate_req_s=4.0,
                                n_requests=len(lens), prompt_len=0, seed=0,
                                prompt_lens=lens)

    launches = {}
    entry, params = _init_full(registry, "yi-6b")
    counts, _, per_tick = _serve(entry, params, dict(base, paged=True),
                                 trace(), sched, kmods, "paged_flash_decode",
                                 smi)
    launches["paged_flash_decode"] = {
        "yi-6b paged": counts["paged_flash_decode"]}
    # 16 = one page: the most the page-edge clamp lets through, so the
    # run uses every bucket 2..16
    counts, fused_m, fused = _serve(entry, params,
                                    dict(base, paged=True, fuse_steps=PAGE),
                                    trace(), sched, kmods,
                                    "paged_flash_decode", smi)
    _same_streams("fused serve vs per tick", fused, per_tick)
    launches["paged_flash_decode"]["yi-6b paged fused"] = \
        counts["paged_flash_decode"]
    _serve_placed(entry, params, base, trace, sched, kmods, smi, launches,
                  fused_m, fused)
    _gpu_model_line(entry, params, sched, smi)
    _serve_shared(entry, params, base, sched, kmods, smi, launches)
    counts, _, dense = _serve(entry, params, dict(base, paged=False),
                              trace(), sched, kmods, "flash_decode", smi)
    launches["flash_decode"] = {"yi-6b dense": counts["flash_decode"]}
    # co-design pricing on the dense engine: the same tokens
    counts, _, priced = _serve(entry, params,
                               dict(base, paged=False, codesign=True),
                               trace(), sched, kmods, "flash_decode", smi)
    _same_streams("priced dense serve vs dense", priced, dense)
    launches["flash_decode"]["yi-6b dense codesign"] = counts["flash_decode"]
    del params
    _free()
    # rwkv6 prefills whole prompts (prefill_chunk is for attention
    # families) and its state holds no pages
    entry, params = _init_full(registry, "rwkv6-7b")
    counts, metrics, _ = _serve(entry, params, dict(base, paged=True),
                                trace(), sched, kmods, "wkv6", smi)
    launches.update(wkv6={"rwkv6-7b paged": counts["wkv6"]},
                    wkv6_chunked={"rwkv6-7b paged": counts["wkv6_chunked"]})
    if metrics["kv_peak_tokens"] != 0:
        raise AssertionError(f"rwkv6 paged KV peak "
                             f"{metrics['kv_peak_tokens']} != 0")
    del params
    _free()
    # stablelm-3b: D = 80 through both flash-decode kernels
    entry, params = _init_full(registry, "stablelm-3b")
    for paged, kernel in ((True, "paged_flash_decode"),
                          (False, "flash_decode")):
        counts, _, _ = _serve(entry, params, dict(base, paged=paged),
                              trace(), sched, kmods, kernel, smi)
        launches[kernel]["stablelm-3b " + ("paged" if paged else "dense")] \
            = counts[kernel]
    del params
    _free()
    _serve_qwen3(registry, sched, kmods, smi, base, trace, launches)
    return launches


def _serve_qwen3(registry, sched, kmods, smi, base, trace, launches):
    """qwen3-30b-a3b at full width and depth, alone on the card: per tick,
    then fusing up to 16 steps a tick; the same tokens, and the weights'
    size and the peak of allocated memory over both runs."""
    held = torch.cuda.memory_allocated()
    if held > 1 << 30:
        raise AssertionError(f"{held / 1e9:.2f} GB still allocated before "
                             f"qwen3-30b-a3b's weights are drawn")
    torch.cuda.reset_peak_memory_stats()
    entry, params = _init_full(registry, "qwen3-30b-a3b")
    weight_gb = sum(t.numel() * t.element_size()
                    for t in _leaves(params)) / 1e9
    runs = launches["paged_flash_decode"]
    streams, keep = {}, {}
    for fuse in (1, PAGE):
        label = "qwen3-30b-a3b paged" + (" fused" if fuse > 1 else "")
        counts, metrics, streams[fuse] = _serve(
            entry, params, dict(base, paged=True, fuse_steps=fuse),
            trace(entry.config.vocab), sched, kmods, "paged_flash_decode",
            smi)
        runs[label] = counts["paged_flash_decode"]
        keep[label] = {k: metrics[k] for k in (
            "tokens_per_s", "tbt_mean_s", "tbt_p99_s", "ttft_mean_s")}
    _same_streams("qwen3-30b-a3b fused serve vs per tick", streams[PAGE],
                  streams[1])
    _gpu_model_line(entry, params, sched, smi)
    print("[serve] qwen3-30b-a3b " + json.dumps({
        "weights_gb": weight_gb,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "held_before_gb": held / 1e9, "runs": keep,
        "tokens_identical": sum(len(t) for t, _ in streams[1].values()),
        "card": smi}))
    del params
    _free()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA GPU")
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import snake_gemm as sg
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import registry
    from repro_torch.serving import scheduler as sched

    t0 = time.perf_counter()
    smi = card()
    phase_build(build, smi)
    if sys.argv[1:] == ["--sweep"]:
        phase_sweep(fd, ref, smi)
        phase_sweep_gemm(sg, ref, smi)
        phase_sweep_wkv(wk, ref, smi)
        return
    if sys.argv[1:]:
        sys.exit(f"chip_smoke: unknown arguments {sys.argv[1:]} (only "
                 f"--sweep)")
    rows = phase_kernels(fd, ref) + phase_kernels_rwkv(wk, sg, ref)
    phase_parity(registry, sched)
    launches = phase_serve(registry, sched, (fd, wk, sg), smi)
    for row in rows:
        # the decode GEMM is on no serving path: every serve run above
        # asserted its counts stayed 0
        by_run = launches.get(row["name"], {})
        row["launches"] = sum(by_run.values())
        row["launches_by_run"] = by_run
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
