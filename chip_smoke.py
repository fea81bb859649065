#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
             with nvcc; print the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version at full-width
             yi-6b shapes in bf16 (Hq=32, Hkv=4, D=128, page 16, B=8,
             ragged lengths 0..4096, garbage past every length and in the
             scratch page), rtol = atol = 2e-2 (the bf16 tolerance of
             tests/test_kernels.py); times on the card beside the bound.
3. parity  — full-width yi-6b at 2 layers in float32 (TF32 off): each
             engine with its kernel against the same engine on the plain
             path, teacher-forced on the plain run's tokens; per-step
             logits within 1e-3.
4. serve   — full-width, full-depth yi-6b in bf16 (random weights from a
             seeded generator): 4 requests of 256-1024 prompt tokens and
             32 new tokens through ``Scheduler.run_trace`` on the paged
             engine (chunked prefill 128, paged kernel), then on the
             dense engine (dense kernel).  Every launch counter is set to
             0 just before each run and read just after it.

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
HQ, HKV, D, PAGE, BATCH = 32, 4, 128, 16, 8
LENGTHS = [0, 1, 16, 17, 255, 1000, 2048, 4096]
KERNEL_TOL = dict(rtol=2e-2, atol=2e-2)
PARITY_TOL = dict(rtol=1e-3, atol=1e-3)
GARBAGE = 60.0


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Median time of one call, by CUDA events around each call, with the
    50 MB L2 flushed before it (a decode step finds each layer's KV
    cold)."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), **KERNEL_TOL):
            raise AssertionError(f"{name}: max |err| {err} beyond "
                                 f"{KERNEL_TOL}")
        if (got[0] != 0).any():
            raise AssertionError(f"{name}: the 0-length lane is not 0")
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / BF16_FLOP_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": time_ms(library) if library else None})
    print("[kernels] " + json.dumps({"shapes": {
        "B": BATCH, "Hq": HQ, "Hkv": HKV, "D": D, "page": PAGE,
        "lengths": LENGTHS, "dtype": "bfloat16"}, "kernels": rows}))
    return rows


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
    entry = registry.get("yi-6b", num_layers=2, dtype="float32")
    params = entry.module.init(entry.config, device="cuda", seed=1)
    lens = np.array([100, 300, 17, 180])

    def trace():
        return make_trace(entry.config.vocab, rate_req_s=1e9,
                          n_requests=len(lens), prompt_len=0, seed=2,
                          prompt_lens=lens)

    base = dict(max_batch=4, max_seq=int(lens.max()) + 18,
                max_new_tokens=16, page_size=PAGE, prefill_chunk=128)
    for paged in (True, False):
        agree, total, err = _lockstep(entry, params,
                                      dict(base, paged=paged), trace)
        print(f"[parity] {'paged' if paged else 'dense'} engine, kernel vs "
              f"plain, yi-6b 2 layers f32: max |logit err| {err:.3g} "
              f"(tol {PARITY_TOL}), token agreement {agree}/{total}")
    del params
    torch.cuda.empty_cache()


def phase_serve(registry, make_trace, fd, smi):
    from repro_torch.serving.engine import EngineConfig, make_engine
    entry = registry.get("yi-6b")
    cfg = entry.config
    t0 = time.perf_counter()
    params = entry.module.init(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lens = np.random.default_rng(0).integers(256, 1025, size=4)
    new = 32
    base = dict(max_batch=4, max_seq=int(lens.max()) + new + 2,
                max_new_tokens=new, page_size=PAGE, prefill_chunk=128,
                use_pallas_decode=True)
    launches = {}
    for paged, kernel in ((True, "paged_flash_decode"),
                          (False, "flash_decode")):
        ecfg = dict(base, paged=paged)
        warm = make_engine(entry, EngineConfig(**ecfg), params=params)
        warm.run_trace(make_trace(cfg.vocab, rate_req_s=1e9, n_requests=1,
                                  prompt_len=130, seed=9))
        eng = make_engine(entry, EngineConfig(**ecfg), params=params)
        seen = _watch(eng)
        reqs = make_trace(cfg.vocab, rate_req_s=4.0, n_requests=len(lens),
                          prompt_len=0, seed=0, prompt_lens=lens)
        fd.reset_launches()
        metrics = eng.run_trace(reqs)
        counts = dict(fd.LAUNCHES)
        done = eng.completed
        if len(done) != len(lens) or any(
                r.finish_reason != "budget" or len(r.tokens_out) != new
                for r in done):
            got = [(r.rid, len(r.tokens_out), r.finish_reason) for r in done]
            raise AssertionError(f"not every request finished its budget: "
                                 f"{got}")
        if not bool(seen["finite"]):
            raise AssertionError("non-finite logits in a decode step")
        want = seen["steps"] * cfg.num_layers
        others = {k: v for k, v in counts.items() if k != kernel}
        if counts[kernel] != want or any(others.values()):
            raise AssertionError(f"launches {counts}, want {kernel}={want}")
        launches[kernel] = counts[kernel]
        keep = ("requests", "decoded_tokens", "tokens_per_s",
                "tbt_mean_s", "tbt_p99_s", "ttft_mean_s", "preemptions",
                "defrag_runs", "kv_peak_tokens", "wall_s")
        print(f"[serve] yi-6b 32 layers bf16, {'paged' if paged else 'dense'}"
              f" engine + {kernel}: prompts {lens.tolist()}, {new} new "
              f"tokens, {seen['steps']} decode steps, launches {counts}, "
              f"weights init {init_s:.1f} s; "
              f"{json.dumps({k: metrics[k] for k in keep})} on {smi}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA GPU")
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import registry
    from repro_torch.serving.scheduler import make_trace

    t0 = time.perf_counter()
    smi = card()
    phase_build(build, smi)
    rows = phase_kernels(fd, ref)
    phase_parity(registry, make_trace)
    launches = phase_serve(registry, make_trace, fd, smi)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
