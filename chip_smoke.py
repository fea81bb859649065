#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
             with nvcc (one process per source, in parallel); print the
             card's name and power limit.
2. kernels — each kernel against its plain PyTorch version, with its time
             on the card beside the bound:
             * flash decode at full-width yi-6b shapes in bf16 (Hq=32,
               Hkv=4, D=128, page 16, B=8, ragged lengths 0..4096, garbage
               past every length and in the scratch page), rtol = atol =
               2e-2 (the bf16 tolerance of tests/test_kernels.py);
             * WKV6 at rwkv6-7b shapes (H=64, hs=64): decode B=4, T=1 and
               prefill B=1, T=1024, in float32 (tolerance 1e-4, as
               tests/test_kernels.py) and bf16 inputs (2e-2), plus the
               state carry wkv6(T1+T2) == wkv6(T2) . wkv6(T1) and the
               new state written over the old one in place;
             * the decode GEMM at rwkv6-7b's decode products, M=4, bf16:
               (N, K) = (4096, 4096), (14336, 4096) IS, (4096, 14336) OS,
               and a ragged float32 (13, 257, 129) (tests/test_kernels.py
               tolerances).
3. parity  — full-width yi-6b and rwkv6-7b at 2 layers in float32 (TF32
             off): each engine with its kernels against the same engine
             on the plain path, teacher-forced on the plain run's tokens;
             per-step logits within 1e-3.
4. serve   — full-width, full-depth models in bf16 (random weights from a
             seeded generator), 4 requests of 256-1024 prompt tokens and
             32 new tokens each through ``Scheduler.run_trace``: yi-6b on
             the paged engine (chunked prefill 128, paged kernel), then on
             the dense engine (dense kernel); then rwkv6-7b on the paged
             engine with the WKV6 kernel.  Every launch counter is set to
             0 just before each run and read just after it; the decode
             GEMM is not wired into any model (as in the reference), so
             its count on these runs is 0.

The last three lines are the kernels' JSON, the card's name and power
limit as nvidia-smi reports them, and the result JSON.  Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import json
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
HQ, HKV, D, PAGE, BATCH = 32, 4, 128, 16, 8
LENGTHS = [0, 1, 16, 17, 255, 1000, 2048, 4096]
KERNEL_TOL = dict(rtol=2e-2, atol=2e-2)
PARITY_TOL = dict(rtol=1e-3, atol=1e-3)
GARBAGE = 60.0
WKV_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
GEMM_TOL = {torch.float32: dict(rtol=5e-3, atol=1e-3),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
WKV_H, WKV_HS = 64, 64          # rwkv6-7b: d 4096 / head size 64


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


def _kernel_inputs():
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev, bf16 = "cuda", torch.bfloat16
    s = max(LENGTHS)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q = rand(BATCH, HQ, D)
    k, v = rand(BATCH, s, HKV, D), rand(BATCH, s, HKV, D)
    for b, n in enumerate(LENGTHS):
        k[b, n:] = GARBAGE
        v[b, n:] = GARBAGE
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    # pages dealt in a seeded shuffle; entries past each length -> scratch
    need = [-(-n // PAGE) for n in LENGTHS]
    n_pages = sum(need) + 8
    order = np.random.default_rng(0).permutation(n_pages)
    kp, vp = rand(n_pages + 1, PAGE, HKV, D), rand(n_pages + 1, PAGE, HKV, D)
    kp[n_pages] = GARBAGE
    vp[n_pages] = GARBAGE
    tables = np.full((BATCH, s // PAGE), n_pages, np.int32)
    i = 0
    for b, n in enumerate(LENGTHS):
        tables[b, :need[b]] = order[i:i + need[b]]
        i += need[b]
        if n % PAGE:
            kp[int(tables[b, need[b] - 1]), n % PAGE:] = GARBAGE
            vp[int(tables[b, need[b] - 1]), n % PAGE:] = GARBAGE
    tables = torch.from_numpy(tables).to(dev)
    return q, k, v, kp, vp, tables, lengths, sum(need)


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


def phase_kernels(fd, ref):
    q, k, v, kp, vp, tables, lengths, pages_read = _kernel_inputs()
    ctx = sum(LENGTHS)
    io = 2 * q.numel() * q.element_size() + lengths.numel() * 4
    kv_bytes = 2 * ctx * HKV * D * q.element_size()
    flops = 4 * HQ * D * ctx
    mask = (torch.arange(k.shape[1], device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kt, vt, attn_mask=mask, enable_gqa=True)

    specs = [
        ("paged_flash_decode", "src/repro/kernels/flash_decode.py:115",
         lambda: fd.paged_flash_decode(q, kp, vp, tables, lengths),
         lambda: ref.paged_flash_decode_ref(q, kp, vp, tables, lengths),
         None, io + kv_bytes + pages_read * 4),
        ("flash_decode", "src/repro/kernels/flash_decode.py:169",
         lambda: fd.flash_decode(q, k, v, lengths),
         lambda: ref.flash_decode_ref(q, k, v, lengths),
         sdpa, io + kv_bytes),
    ]
    rows = []
    for name, replaces, kern, plain, library, nbytes in specs:
        got = kern()
        err = _check(name, got, plain(), KERNEL_TOL)
        if (got[0] != 0).any():
            raise AssertionError(f"{name}: the 0-length lane is not 0")
        bound, by = _bound(nbytes, flops, BF16_FLOP_PER_S)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(library) if library else None})
    print("[kernels] " + json.dumps({"shapes": {
        "B": BATCH, "Hq": HQ, "Hkv": HKV, "D": D, "page": PAGE,
        "lengths": LENGTHS, "dtype": "bfloat16"}, "kernels": rows}))
    return rows


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


def _wkv_case(wk, ref, gen, b, t, dtype):
    args = _wkv_inputs(gen, b, t, dtype)
    y, s_t = wk.wkv6(*args)
    yr, sr = ref.wkv6_ref(*args)
    tol = WKV_TOL[dtype]
    err = max(_check("wkv6 y", y, yr, tol), _check("wkv6 state", s_t, sr,
                                                    tol))
    esize = args[0].element_size()
    n = b * t * WKV_H * WKV_HS
    nbytes = 5 * n * esize + WKV_H * WKV_HS * esize \
        + 2 * b * WKV_H * WKV_HS * WKV_HS * 4
    # 5 hs^2 flops per (b, h, t): y = r.S + v (r.(u*k)), S <- w*S + k v^T
    bound, by = _bound(nbytes, 5 * n * WKV_HS, F32_FLOP_PER_S)
    return {"shape": {"B": b, "T": t, "H": WKV_H, "hs": WKV_HS},
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
            "ms": time_ms(lambda: wk.wkv6(*args)),
            "plain_ms": time_ms(lambda: ref.wkv6_ref(*args), iters=3),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            # the sweep over T is serial: T dependent steps per (b, h)
            "serial_steps": t}


def _gemm_case(sg, ref, gen, m, n, k, dtype):
    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
    mp = sg.choose_mapping(m, n, k, dtype)
    err = _check(f"decode_gemm {m}x{n}x{k}", sg.snake_decode_gemm(a, b),
                 ref.decode_gemm_ref(a, b), GEMM_TOL[dtype])
    esize = a.element_size()
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    bound, by = _bound((m * k + k * n + m * n) * esize, 2 * m * n * k, rate)
    return {"shape": {"M": m, "N": n, "K": k},
            "dtype": str(dtype).replace("torch.", ""),
            "dataflow": mp.dataflow, "max_abs_err": err,
            "ms": time_ms(lambda: sg.snake_decode_gemm(a, b)),
            "plain_ms": time_ms(lambda: ref.decode_gemm_ref(a, b)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lambda: torch.matmul(a, b))}


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
           for b, t in ((4, 1), (1, 1024)) for dt in (f32, bf16)]
    # state carry: one sweep over T1 + T2 equals T2 after T1
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
    gemm = [_gemm_case(sg, ref, gen, 4, n, kk, bf16)
            for n, kk in ((14336, 4096), (4096, 14336), (4096, 4096))]
    gemm.append(_gemm_case(sg, ref, gen, 13, 257, 129, f32))
    flows = {c["dataflow"] for c in gemm}
    if flows != {"IS", "OS"}:
        raise AssertionError(f"decode GEMM dataflows run: {flows}")
    src = "src/repro_torch/kernels/csrc/"
    rows = [_row("wkv6", src + "wkv6.cu", "src/repro/kernels/wkv6.py:49",
                 wkv[0], wkv)]
    for flow, line in (("IS", 90), ("OS", 97)):
        cases = [c for c in gemm if c["dataflow"] == flow]
        rows.append(_row(f"snake_decode_gemm_{flow.lower()}",
                         src + "snake_gemm.cu",
                         f"src/repro/kernels/snake_gemm.py:{line}",
                         cases[0], cases))
    print("[kernels] " + json.dumps({"wkv6_state_carry_max_abs_err": carry,
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


def phase_parity(registry, make_trace):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lens = np.array([100, 300, 17, 180])
    base = dict(max_batch=4, max_seq=int(lens.max()) + 18,
                max_new_tokens=16, page_size=PAGE, prefill_chunk=128)
    for arch in ("yi-6b", "rwkv6-7b"):
        entry = registry.get(arch, num_layers=2, dtype="float32")
        params = entry.module.init(entry.config, device="cuda", seed=1)

        def trace():
            return make_trace(entry.config.vocab, rate_req_s=1e9,
                              n_requests=len(lens), prompt_len=0, seed=2,
                              prompt_lens=lens)

        for paged in (True, False):
            agree, total, err = _lockstep(entry, params,
                                          dict(base, paged=paged), trace)
            print(f"[parity] {'paged' if paged else 'dense'} engine, "
                  f"kernels vs plain, {arch} 2 layers f32: max |logit err| "
                  f"{err:.3g} (tol {PARITY_TOL}), token agreement "
                  f"{agree}/{total}")
        del params
        torch.cuda.empty_cache()


def _serve(entry, params, ecfg, lens, make_trace, kmods, kernel, smi):
    """Serve the 4-request trace after a 1-request warm-up; check that
    every request finished its budget with finite logits and that the
    launch counts are the main path's: ``kernel`` once per layer per
    decode step (the WKV6 kernel also once per layer per prefill), every
    other kernel never.  Returns ``kernel``'s count."""
    from repro_torch.serving.engine import EngineConfig, make_engine
    cfg = entry.config
    new = ecfg["max_new_tokens"]
    warm = make_engine(entry, EngineConfig(**ecfg), params=params)
    warm.run_trace(make_trace(cfg.vocab, rate_req_s=1e9, n_requests=1,
                              prompt_len=130, seed=9))
    eng = make_engine(entry, EngineConfig(**ecfg), params=params)
    seen = _watch(eng)
    prefills = []
    prefill = eng._prefill
    eng._prefill = lambda *a: prefills.append(1) or prefill(*a)
    reqs = make_trace(cfg.vocab, rate_req_s=4.0, n_requests=len(lens),
                      prompt_len=0, seed=0, prompt_lens=lens)
    _reset(kmods)
    metrics = eng.run_trace(reqs)
    counts = _launches(kmods)
    done = eng.completed
    if len(done) != len(lens) or any(
            r.finish_reason != "budget" or len(r.tokens_out) != new
            for r in done):
        got = [(r.rid, len(r.tokens_out), r.finish_reason) for r in done]
        raise AssertionError(f"not every request finished its budget: "
                             f"{got}")
    if not bool(seen["finite"]):
        raise AssertionError("non-finite logits in a decode step")
    runs = seen["steps"] + (len(prefills) if kernel == "wkv6" else 0)
    want = runs * cfg.num_layers
    others = {k: v for k, v in counts.items() if k != kernel}
    if counts[kernel] != want or any(others.values()):
        raise AssertionError(f"launches {counts}, want {kernel}={want}")
    keep = ("requests", "decoded_tokens", "tokens_per_s", "tbt_mean_s",
            "tbt_p99_s", "ttft_mean_s", "preemptions", "defrag_runs",
            "kv_peak_tokens", "wall_s")
    print(f"[serve] {cfg.name} {cfg.num_layers} layers bf16, "
          f"{'paged' if ecfg['paged'] else 'dense'} engine + {kernel}: "
          f"prompts {lens.tolist()}, {new} new tokens, {len(prefills)} "
          f"whole-prompt prefills, {seen['steps']} decode steps, launches "
          f"{counts}; "
          f"{json.dumps({k: metrics[k] for k in keep})} on {smi}")
    return counts[kernel], metrics


def _init_full(registry, arch):
    entry = registry.get(arch)
    t0 = time.perf_counter()
    params = entry.module.init(entry.config, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"[serve] {arch} weights: "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B "
          f"parameters, init {time.perf_counter() - t0:.1f} s")
    return entry, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_serve(registry, make_trace, kmods, smi):
    lens = np.random.default_rng(0).integers(256, 1025, size=4)
    new = 32
    base = dict(max_batch=4, max_seq=int(lens.max()) + new + 2,
                max_new_tokens=new, page_size=PAGE, prefill_chunk=128,
                use_pallas_decode=True)
    launches = {}
    entry, params = _init_full(registry, "yi-6b")
    for paged, kernel in ((True, "paged_flash_decode"),
                          (False, "flash_decode")):
        launches[kernel], _ = _serve(entry, params, dict(base, paged=paged),
                                     lens, make_trace, kmods, kernel, smi)
    del params
    torch.cuda.empty_cache()
    # rwkv6 prefills whole prompts (prefill_chunk is for attention
    # families) and its state holds no pages
    entry, params = _init_full(registry, "rwkv6-7b")
    launches["wkv6"], metrics = _serve(entry, params, dict(base, paged=True),
                                       lens, make_trace, kmods, "wkv6", smi)
    if metrics["kv_peak_tokens"] != 0:
        raise AssertionError(f"rwkv6 paged KV peak "
                             f"{metrics['kv_peak_tokens']} != 0")
    del params
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA GPU")
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import snake_gemm as sg
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import registry
    from repro_torch.serving.scheduler import make_trace

    t0 = time.perf_counter()
    smi = card()
    phase_build(build, smi)
    rows = phase_kernels(fd, ref) + phase_kernels_rwkv(wk, sg, ref)
    phase_parity(registry, make_trace)
    launches = phase_serve(registry, make_trace, (fd, wk, sg), smi)
    for row in rows:
        # the decode GEMM is on no serving path: every serve run above
        # asserted its counts stayed 0
        row["launches"] = launches.get(row["name"], 0)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
