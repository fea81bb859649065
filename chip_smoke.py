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
               (B=4, Hq=Hkv=32, D=80, the serve's lengths) and at
               recurrentgemma-9b's (B=2, Hq=16, Hkv=1, D=256, lengths
               300 and 287: two n8 tiles of heads); the split plan (C,
               n_split, blocks holding valid positions) of each timed
               case; then the reference's five flash-decode test shapes
               (tests/test_kernels.py FD_SHAPES) in f32 and bf16, and
               every instantiation (f32 / bf16 x D 32/64/80/112/128/256
               x G 1/4/6/7/8/16) on lengths at the chunk edges, f32
               within 2e-5;
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
               and at a rank's 32 heads under a model axis of 2, float32,
               (B, T) = (4, 1) serial and (4, 96) chunked (the sharded
               rwkv6 steps' shapes in the dist phase);
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
             consistent.  Then recurrentgemma-9b at 5 layers (one
             (rec, rec, attn) group and a recurrent tail) and
             whisper-small at 2 decoder and 2 encoder layers, full
             width, float32: the dense and paged engines on the card
             against the same engines on the host CPU with the same
             parameters, teacher-forced: logits within 1e-3 and the same
             greedy tokens (neither family runs a kernel of the port).
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
             device time of its in-place page copies).  Then the
             cluster: yi-6b with prefix sharing behind the router, one
             set of weights, on 8 requests of the 768 + 128 prompts in 2
             groups (skew 0.8, 4 req/s): a bare engine (the token
             baseline), 2 replicas under round robin and under prefix
             affinity (per tick), and tiers 1:1 with the decode tier
             fusing up to 16 steps, traced and exported (Perfetto JSON
             and JSONL under build/): every run the bare engine's
             tokens; 8 shipments of 56 pages into the decode tier's
             pools at unmoved addresses; the paged kernel's launches
             per replica ((per-tick steps + bucketed fused steps) x 32,
             summing to the counted launches; 0 on the prefill tier);
             the trace's phases summing to its makespan; then export +
             import pairs of one 896-token slot between CUDA events
             beside the bytes bound.  Then yi-6b on the
             dense engine (dense kernel), without and with co-design
             pricing (the same tokens), and rwkv6-7b on the paged
             engine with the WKV6 kernel (every prefill on the chunked
             design, every decode step on the serial one).  Then
             stablelm-3b (D=80) on the paged and the dense engine;
             recurrentgemma-9b (38 layers, ~21 GB of bf16 weights) and
             whisper-small (1500 zero frames) on the paged and then the
             dense engine, per tick: the same tokens in both, no kernel
             launched, recurrentgemma's paged KV peak 0; and,
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
5. dist    — the distribution layer (``repro_torch.distributed``,
             ``launch.mesh``, ``launch.steps.build_cell``): first the
             flash-decode partial entry (``ops.attention_decode_partial``,
             acc / l / m of one context shard, un-normalised) against
             its plain version (``layers.decode_attention_core``) on
             every shard of yi-6b's decode shape (B=4, Hq=32, Hkv=4,
             D=128, lengths 768-778 over 800 positions) split 2 and 4
             ways (acc / l, l and m each within the tolerance), of a split that leaves shards empty for some lanes
             (acc = l = m = 0 exactly there) and of a ragged one, in
             bf16 (2e-2) and float32 (2e-5), each shard set also
             combined by the log-sum-exp rule against flash_decode_ref
             on the whole cache; the partial timed at the first shard of
             the 2-way and the 4-way split beside its bytes bound.  Then (a) an in-process NCCL group
             of world size 1, mesh (1, 1): full-width, full-depth yi-6b
             in bf16, the prefill step (96-token prompts, B=4, into a
             128-deep cache) and build_cell's serve step with the
             sequence-sharded attention give the unsharded prefill's and
             decode_step's (flash-decode kernel) greedy tokens over 16
             decode steps, bitwise; both steps' median times and the
             partial kernel's launches (16 x 32, counted from 0).  Then
             ranks spawned on the one card (gloo): (b) two, mesh (1, 2),
             yi-6b at full width and depth; (c) four, mesh (2, 2),
             qwen3-30b-a3b at full width (the expert-parallel MoE), each
             against the same model run in this one process under the
             mesh description (the same per-chunk capacities).  In bf16
             (qwen3 at 8 of its 48 layers) the prefill's and first
             step's logits lie within DIST_BF16_REL_TOL (relative L2) of
             the single-process run's, while a wrong shard (wo's row
             halves swapped) lies beyond it; the unsharded run's own
             error against float32 compute of the same weights is
             printed beside them.  In float32 with TF32 off (qwen3 at 6
             layers: past the reference's FSDP residency rule, so each
             rank holds its data shard of the model-axis shards and
             gathers one layer at a time, once in the prefill and once a
             step) the greedy tokens are equal.  Then the recurrent and
             encoder-decoder families: rwkv6-7b and recurrentgemma-9b on
             two ranks, mesh (1, 2), at full width and depth in bf16
             (logits held as above; the wrong-shard control swaps the
             row halves of rwkv6's time-mix ``wo`` and of
             RecurrentGemma's recurrent ``w_out``) and at 8 layers in
             float32 (tokens equal), and whisper-small at full width and
             depth in float32 on four ranks, mesh (2, 2), with frames
             from a seed (tokens equal).  The sharded rwkv6 steps run
             the WKV6 kernel on each rank's 32 heads: (1 prefill + 16
             steps) x layers launches a rank, the prefill's on the
             chunked design, counted from 0 and asserted.  Each rank
             draws the full weights in turn and keeps its shards, and
             reports its launches, peak memory and times.  A failed rank
             fails the phase; times of ranks sharing one card are
             correctness runs and measure no collective bandwidth.
6. train   — the training path (no kernel of the port is on it: the
             reference's kernels have no backward): the train step of
             ``launch.steps`` on the card against the same step on the
             host CPU, reduced yi-6b and qwen3-30b-a3b in float32 (TF32
             off), the same port-initialized parameters on both, 5 steps
             of TokenPipeline batches (global batch 4, seq 64): losses
             within 1e-4 and gradient norms within 1e-3, relative; then
             stablelm-3b at full width and depth in bf16 through
             ``launch.train.train`` (global batch 8, seq 512, 8 steps):
             finite losses, the last below the first; its parameters,
             peak allocated memory, median step time with max/min over
             steps 2-8, tokens/s, the FLOP bound of a step (6 x matmul
             parameters x tokens plus the causal attention, at 989
             TFLOP/s bf16) and the step's share of it, the busy share of
             one profiled step and the step's two halves (gradients,
             update) between CUDA events; then reduced stablelm-3b's
             exact resume (10 steps, against 6 and a resume from the
             checkpoint: final losses within 1e-4).  Then the sharded
             train step (``build_cell``'s train Cell): (a) an in-process
             NCCL group of world size 1, mesh (1, 1), stablelm-3b at
             full width and depth in bf16 (8 x 512, 3 steps) against the
             unsharded step on the same weights, deterministic kernels
             on in both: losses, gradient norms and parameters bitwise,
             both step times; then ranks spawned on the one card (gloo),
             float32 with TF32 off, each held to the same model's train
             step in this process under the mesh description (losses
             within 1e-5, gradient norms within 1e-3, relative, every
             rank): (b) two, mesh (2, 1), stablelm-3b at full width, 12
             of 32 layers, FSDP by the reference's residency rule, 2 x
             12 layer gathers a step, each rank's peak allocated memory;
             (c) four, mesh (2, 2), stablelm-3b at 4 layers with 2
             microbatches (data and tensor parallel, ZeRO-1) and
             qwen3-30b-a3b at full width, 2 layers (the expert-parallel
             MoE's backward: step 0 must route every token as the one
             process does except at a tie, ROUTE_TIE, and after a tie
             broke the other way only step 0 is held); (d) full width:
             rwkv6-7b at 2 layers and whisper-small at 2 + 2 layers on
             four ranks, mesh (2, 2), and recurrentgemma-9b at 5 layers
             on two, mesh (1, 2); each first measures its own float
             noise (one process at twice the microbatches against one
             process) and holds the steps before that noise passes the
             tolerances (TRAIN_NOISE_FLOOR).  Times of ranks sharing one
             card measure no collective bandwidth.  Prints each run's
             time and its ranks' peak memory, and the phase's time.
7. checks  — ``repro_torch.analysis.checks`` on the card: every pass
             with 0 findings (its kernel probes run the four CUDA
             kernels: NaN past every length and in the scratch page, an
             inactive lane on the scratch page, NaN output sentinels,
             ragged WKV6 T and GEMM M / N, each output finite and within
             its dtype's tolerance of the plain version), each
             regression fixture with at least one; the dry run
             (``launch.dryrun.run_cell``) of yi-6b decode_32k and
             stablelm-3b train_4k on the 16x16 mesh, whose records it
             prints; then the count against the card: full-width yi-6b's
             serve step at mesh (1, 1) with the flash-decode partial on
             its path (B = 4, contexts 768-778 in an 800-deep bf16
             cache), counted on meta tensors and again on the card under
             ``FlopCounterMode``: the aten FLOPs equal, the kernels'
             share equal (their formulas, on both), the partial launched
             once a layer, and the counted argument bytes within 1% of
             the growth of ``torch.cuda.memory_allocated()`` when the
             stand-ins are made on the card.  Prints the phase's time.

The last three lines are the kernels' JSON, the card's name and power
limit as nvidia-smi reports them, and the result JSON.  Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import gc
import json
import re
import shutil
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
# dbrx (6), qwen2-vl (7), stablelm (1), recurrentgemma (16: two n8 tiles
# of heads and a group capacity of 16 rows)
GROUPS = (1, 4, 6, 7, 8, 16)
# the reference's flash-decode test shapes (tests/test_kernels.py
# FD_SHAPES): (B, Hq, Hkv, D, S), lengths max(1, S - 13 i); the fourth is
# recurrentgemma-9b's attention (MQA, D = 256, G = 16), also timed
FD_SHAPES = [(2, 8, 2, 64, 512), (1, 32, 4, 128, 2048), (3, 12, 12, 64, 600),
             (2, 16, 1, 256, 300), (1, 128, 128, 64, 256)]
RGEMMA_SHAPE = FD_SHAPES[3]
# the shared-prefix serve: a system prompt of a whole number of pages and
# of 128-token chunks, then an identical prompt with a ragged tail page
SHARED_PREFIX, SHARED_TAIL, IDENTICAL_PROMPT = 768, 128, 777
# the cluster serve: make_grouped_prefix_trace at seed 0, 8 requests in 2
# groups of the shared-prefix prompt (768 + 128 tokens), skew 0.8, 4 req/s
CLUSTER_TRACE = dict(rate_req_s=4.0, n_requests=8, n_groups=2,
                     prefix_len=SHARED_PREFIX, tail_len=SHARED_TAIL,
                     skew=0.8, seed=0)
# the tiered run's decode-tier horizon, and runs of each cluster
# configuration in one process (their spread is reported)
CLUSTER_FUSE_STEPS, CLUSTER_REPEATS = 16, 3
# export + import pairs timed at full width (one 896-token slot each)
SHIP_PAIRS = 6
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
# one rank's heads under a model axis of 2, at the [dist] phase's decode
# batch: a decode step and its 96-token prefill, (B, T)
WKV_SHARD_H, WKV_SHARD_CASES = WKV_H // 2, ((4, 1), (4, 96))
# whole-prompt prefills (B, T): a short prompt, the profiled context and
# PR 12's timed shape
WKV_PREFILLS = ((1, 128), (1, 768), (1, 1024))
WKV_SWEEP_T = (1, 8, 32, 48, 64, 96, 128, 512, 1024)
# rwkv6-7b's decode products at a batch of 4: (M, N, K), IS then OS twice
GEMM_SHAPES = [(4, 14336, 4096), (4, 4096, 14336), (4, 4096, 4096)]
GEMM_SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 17, 18, 24, 32, 48, 64)
# the train phase: card-vs-host parity of the train step (reduced, f32),
# and the full-width run (arch, global batch, seq, steps)
TRAIN_PARITY_STEPS, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 5, 4, 64
TRAIN_PARITY_OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TRAIN_FULL = ("stablelm-3b", 8, 512, 8)
# the sharded train step: (a) an NCCL group of one rank, mesh (1, 1),
# stablelm-3b at full width and depth in bf16 (global batch, seq) against
# the unsharded step bit for bit; then gloo ranks on the one card, in
# float32 with TF32 off, each held to the same model's train step in one
# process under the mesh description: (b) mesh (2, 1), 12 of stablelm's
# 32 layers (1.21 B parameters: 4.8 GB + 8 B x 1.21 B / 2 = 9.7 GB a
# rank by the reference's residency rule, above 8 GiB, so FSDP; 10
# layers would not be), (c)
# mesh (2, 2): stablelm at 4 layers with 2 microbatches (data and tensor
# parallel, ZeRO-1), and qwen3-30b-a3b at full width, 2 layers (the
# expert-parallel MoE's backward); (d) mesh (2, 2), full width: rwkv6-7b
# at 2 layers (the head-sharded time mix through the plain recurrence, as
# the reference trains) and whisper-small at 2 encoder and 2 decoder
# layers; recurrentgemma-9b at 5 (one (rec, rec, attn) group and the
# recurrent tail) on mesh (1, 2): its 3.2 B float32 parameters (the 256k
# vocabulary's table and head are 2.1 B) with their gradients and moments
# come to ~23 GB a rank at (2, 2), past the card for four ranks (my chip
# run 3 of PR 26 ran out of memory there); (arch, layers, mesh, global
# batch, seq, microbatch)
TRAIN_MESH_STEPS = 3
TRAIN_WORLD_ONE = ("stablelm-3b", 8, 512)
TRAIN_MESH_RUNS = [("stablelm-3b", 12, (2, 1), 4, 512, 1),
                   ("stablelm-3b", 4, (2, 2), 8, 256, 2),
                   ("qwen3-30b-a3b", 2, (2, 2), 4, 256, 1),
                   ("rwkv6-7b", 2, (2, 2), 4, 256, 1),
                   ("recurrentgemma-9b", 5, (1, 2), 4, 256, 1),
                   ("whisper-small", 2, (2, 2), 4, 256, 1)]
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-5, 1e-3
# runs whose own float noise is measured first: one process at twice the
# microbatches (the same function, its sums in another order) against
# one process; from the first step where that pair differs beyond the
# tolerances, the ranks' later steps are printed, not held (rwkv6-7b at
# full width: step 2's loss moves 1.73e-5 by the reordering alone, my
# chip run 3 of PR 26)
TRAIN_NOISE_FLOOR = ("rwkv6-7b", "recurrentgemma-9b", "whisper-small")
# a token whose k-th and (k+1)-th router logits lie closer than this
# takes either expert within float32 noise: the sharded step's router
# logits differ from one process's by up to ~5e-6 (partial sums added in
# another order), so such a tie may break the other way under sharding,
# and the two runs diverge from that step on
ROUTE_TIE = 1e-5
# the dist phase: B prompts of DIST_PROMPT tokens into a DIST_SEQ-deep
# cache, then DIST_STEPS greedy decode steps; the kernel check's cases
# (global lengths over a cache of cap positions, split P ways)
DIST_BATCH, DIST_PROMPT, DIST_SEQ, DIST_STEPS = 4, 96, 128, 16
DIST_CASES = [("serve split 2", SERVE_LENGTHS, SERVE_CAP, 2),
              ("serve split 4", SERVE_LENGTHS, SERVE_CAP, 4),
              ("empty shards", [0, 100, 300, 800], 800, 4),
              ("ragged", [1, 17, 255, 999], 1000, 4)]
# the multi-rank runs (arch, layers or 0 for all, dtype, mesh).  bf16
# runs are held by logits, not tokens: a bf16 model's greedy tokens do
# not survive the re-association sharding brings (the reference's own
# bf16 program on a host mesh leaves its unsharded tokens too:
# examples/ref_bf16_shard_drift.py).  qwen3-30b-a3b: 8 of its 48 layers
# in bf16 (5.6 GB a rank, under the reference's FSDP residency rule) and
# 6 in float32 (8.7 GB of model-axis shards a rank cross the rule, which
# 5 would not: FSDP, each rank gathering one layer at a time)
DIST_BF16_REL_TOL = 0.1
DIST_RUNS = [("yi-6b", 0, "bfloat16", (1, 2)),
             ("qwen3-30b-a3b", 8, "bfloat16", (2, 2)),
             ("yi-6b", 0, "float32", (1, 2)),
             ("qwen3-30b-a3b", 6, "float32", (2, 2)),
             # the recurrent families: rwkv6 runs the WKV6 kernel on each
             # rank's 32 heads (its prefill on the chunked design)
             ("rwkv6-7b", 0, "bfloat16", (1, 2)),
             ("recurrentgemma-9b", 0, "bfloat16", (1, 2)),
             ("rwkv6-7b", 8, "float32", (1, 2)),
             ("recurrentgemma-9b", 8, "float32", (1, 2)),
             ("whisper-small", 0, "float32", (2, 2))]
DIST_TIMEOUT_S = 600


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
    tables = np.full((b, -(-cap // page)), n_pages, np.int32)
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


def _reference_shape_checks(fd, ref, gen):
    """Both kernels at the reference's five test shapes (FD_SHAPES) in
    f32 and bf16, lengths max(1, S - 13 i), page 16, against their plain
    versions; returns the largest |err| per dtype."""
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt).replace("torch.", "")
        for b, hq, hkv, d, s in FD_SHAPES:
            lens = [max(1, s - 13 * i) for i in range(b)]
            x = _fd_inputs(gen, lens, s, dt, d, hq, hkv)
            errs = _fd_case(fd, ref, x, timed=False)
            worst[key] = max(worst.get(key, 0.0), *errs.values())
    return worst


def phase_kernels(fd, ref):
    """Both flash-decode kernels at chip_smoke's ragged shape (B=8,
    lengths 0..4096), at the serve's decode shape (B=4, lengths 768-778),
    at stablelm-3b's (the same lengths, Hq = Hkv = 32, D = 80) and at
    recurrentgemma-9b's (B=2, Hq=16, Hkv=1, D=256, lengths 300 and 287),
    timed; the reference's five test shapes and every instantiation on
    chunk-edge lengths."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    head = _fd_case(fd, ref, _fd_inputs(gen, LENGTHS, max(LENGTHS)))
    serve = _fd_case(fd, ref, _fd_inputs(gen, SERVE_LENGTHS, SERVE_CAP))
    stablelm = _fd_case(fd, ref, _fd_inputs(
        gen, SERVE_LENGTHS, SERVE_CAP, d=STABLELM_D, hq=STABLELM_HEADS,
        hkv=STABLELM_HEADS))
    b, hq, hkv, d, s = RGEMMA_SHAPE
    rgemma = _fd_case(fd, ref, _fd_inputs(
        gen, [max(1, s - 13 * i) for i in range(b)], s, d=d, hq=hq,
        hkv=hkv))
    reference = _reference_shape_checks(fd, ref, gen)
    ragged = _ragged_checks(fd, ref, gen)
    keys = ("shape", "plan", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "library_ms")
    rows = []
    for name, row in head.items():
        cases = [{k: case[name][k] for k in keys}
                 for case in (head, serve, stablelm, rgemma)]
        del row["shape"], row["plan"]
        rows.append({**row, "cases": cases})
    print("[kernels] " + json.dumps({"ragged_max_abs_err": ragged,
                                     "fd_shapes_max_abs_err": reference,
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


def _wkv_inputs(gen, b, t, dtype, h=WKV_H):
    """rwkv6-7b-shaped WKV6 inputs (``h`` heads: all 64, or a model
    rank's shard of them): r/k/v ~ N(0,1), decay in (0.4, 0.9), small
    bonus and state (the distributions of tests/test_kernels.py)."""
    shape = (b, t, h, WKV_HS)

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda")

    r, k, v = (randn(*shape).to(dtype) for _ in range(3))
    w = (torch.sigmoid(randn(*shape)) * 0.5 + 0.4).to(dtype)
    u = (randn(h, WKV_HS) * 0.1).to(dtype)
    s0 = randn(b, h, WKV_HS, WKV_HS) * 0.1
    return r, k, v, w, u, s0


def _wkv_bound(b, t, esize, h=WKV_H):
    """Inputs read once, y and the state written once; 5 hs^2 flops per
    (b, h, t): y = r.S + v (r.(u*k)), S <- w*S + k v^T."""
    n = b * t * h * WKV_HS
    nbytes = 5 * n * esize + h * WKV_HS * esize \
        + 2 * b * h * WKV_HS * WKV_HS * 4
    return _bound(nbytes, 5 * n * WKV_HS, F32_FLOP_PER_S)


def _wkv_case(wk, ref, gen, b, t, dtype, chunk=None, args=None,
              timed=True, h=WKV_H):
    """WKV6 at (b, t) on ``h`` heads against the plain recurrence (and a
    chunked call against the plain rendering of its chunks too); its
    row: the plan, times and bound, with ``timed``."""
    args = args or _wkv_inputs(gen, b, t, dtype, h)
    plan = wk.chunk_plan(b, t, h, WKV_HS, dtype, chunk)
    y, s_t = wk.wkv6(*args, chunk=chunk)
    tol = WKV_TOL[dtype]
    name = f"wkv6 {plan.design} C={plan.chunk} B={b} T={t} H={h} {dtype}"
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
    bound, by = _wkv_bound(b, t, args[0].element_size(), h)
    return {"shape": {"B": b, "T": t, "H": h, "hs": WKV_HS},
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
    # a model rank's heads under the 2-way mesh: the sharded serve step's
    # decode and the [dist] phase's 96-token prefill (chunked)
    wkv += [_wkv_case(wk, ref, gen, b, t, f32, h=WKV_SHARD_H)
            for b, t in WKV_SHARD_CASES]
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
    """Count the engine's per-tick decode steps (eager, or a fused
    engine's 1-step graph replays) and check the eager steps' logits stay
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
    graph_step = getattr(eng, "_graph_step", None)
    if graph_step is not None:
        def replayed(*a):
            seen["steps"] += 1
            return graph_step(*a)

        eng._graph_step = replayed
    return seen


def _lockstep(entry, params, ecfg_kw, trace, engines=None):
    """Plain engine and kernel engine (or the two ``engines`` given: the
    reference side, then the tested one) ticked together on one trace;
    the second is teacher-forced on the first's tokens, and their logits
    compared on the host."""
    from repro_torch.serving.engine import EngineConfig, make_engine
    engines = engines or [
        make_engine(entry, EngineConfig(use_pallas_decode=kern, **ecfg_kw),
                    params=params) for kern in (False, True)]
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
            lp, lk = (s["logits"][rows].float().cpu() for s in seen)
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


def _device_parity(registry, sched, arch, over, base, trace_lens):
    """``arch`` at full width with ``over`` cut (depth, f32): the engines
    on the card against the same engines on the host CPU, on the same
    parameters (drawn on the card, copied to the host), teacher-forced
    in lockstep: logits within PARITY_TOL and the same greedy token at
    every step, dense and paged.  These families run no kernel, so this
    holds the card's PyTorch path to the host's."""
    from repro_torch.serving.engine import EngineConfig, make_engine
    entry = registry.get(arch, **over)
    params = entry.module.init(entry.config, device="cuda", seed=1)
    host = _tree_map(params, lambda t: t.cpu())

    def trace():
        return sched.make_trace(entry.config.vocab, rate_req_s=1e9,
                                n_requests=len(trace_lens), prompt_len=0,
                                seed=2, prompt_lens=trace_lens)

    for paged in (True, False):
        kw = dict(base, paged=paged)
        engines = [make_engine(entry, EngineConfig(device=dev, **kw),
                               params=p)
                   for dev, p in (("cpu", host), ("cuda", params))]
        agree, total, err = _lockstep(entry, None, kw, trace, engines)
        if agree != total:
            raise AssertionError(f"{arch} card vs CPU: greedy tokens agree "
                                 f"{agree}/{total}")
        print(f"[parity] {'paged' if paged else 'dense'} engine, card vs "
              f"CPU, {arch} {json.dumps(over)} full width: max |logit "
              f"err| {err:.3g} (tol {PARITY_TOL}), tokens {agree}/{total}")
        del engines
    del params, host
    _free()


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


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
    # the recurrent hybrid at 5 layers (one (rec, rec, attn) group and a
    # recurrent tail: 2 layers would hold no attention layer) and the
    # encoder-decoder at 2 + 2 layers, 1500 frames
    short = dict(base, max_new_tokens=8)
    _device_parity(registry, sched, "recurrentgemma-9b",
                   dict(num_layers=5, dtype="float32"), short, lens)
    _device_parity(registry, sched, "whisper-small",
                   dict(num_layers=2, encoder_layers=2, dtype="float32"),
                   short, lens)


def _serve(entry, params, ecfg, reqs, sched, kmods, kernel, smi):
    """Serve the request trace ``reqs`` after a 1-request warm-up; check
    that every request finished its budget with finite logits and that the
    launch counts are the main path's: ``kernel`` once per layer per
    decode step (the WKV6 kernel also once per layer per prefill, there
    on the chunked design; a fused engine's steps are the bucketed
    ``n_steps`` of each horizon, counted through the graph replays),
    every other kernel never (every kernel never, with ``kernel`` None:
    a family whose path runs no kernel of the port).  A fused engine
    captures every bucket up to its ``fuse_steps`` before the trace.
    Returns the counts, the metrics and each request's (tokens, finish
    reason)."""
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
    want = {kernel: runs * cfg.num_layers} if kernel else {}
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
          f"+ {kernel or 'no kernel'}: prompts "
          f"{[len(r.prompt) for r in reqs]}, {new} new tokens, "
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


def _cluster_run(label, engines, run, kmods, num_layers, launches):
    """Drive ``run()`` (a bare engine's or a router's ``run_trace``) with
    every count set to 0 just before it and read just after; return its
    metrics, each request's (tokens, finish reason) and the paged
    kernel's launches per replica: (per-tick decode steps + bucketed
    fused steps) x layers, whose sum must be the counted launches."""
    seen = [_watch(e) for e in engines]
    _reset(kmods)
    metrics = run()
    counts = _launches(kmods)
    per = [(s["steps"] + sum(1 << (k - 1).bit_length()
                             for k in getattr(e, "fused_horizons", [])))
           * num_layers for e, s in zip(engines, seen)]
    want = {"paged_flash_decode": sum(per)}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"{label}: launches {counts}, per replica "
                             f"{per}")
    if not all(bool(s["finite"]) for s in seen):
        raise AssertionError(f"{label}: non-finite logits in a decode step")
    launches["paged_flash_decode"][label] = sum(per)
    streams = {r.rid: (r.tokens_out, r.finish_reason)
               for e in engines for r in e.completed}
    return metrics, streams, per


def _ship_pair_ms(entry, params, ecfg, prompt):
    """One request's finished prefill shipped between two engines at full
    width, each export + import pair between CUDA events (host work
    included), back and forth; the median, the pages moved and the HBM
    bound of reading them once and writing them once."""
    from repro_torch.serving.engine import EngineConfig, make_engine
    from repro_torch.serving.scheduler import RequestState
    engines = [make_engine(entry, EngineConfig(**ecfg), params=params)
               for _ in range(2)]
    src, dst = engines
    src.role = "prefill"
    if not src.admit(RequestState(0, prompt.copy())):
        raise AssertionError("ship timing: admission refused")
    while src._prefilling is not None:
        src.tick()
    ptrs = [[p.data_ptr() for p in e.paged.store] for e in engines]
    times, pages = [], 0
    for i in range(SHIP_PAIRS):
        a, b = engines[i % 2], engines[1 - i % 2]
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        ship = a.export_slot_pages(0)
        if not b.import_slot_pages(ship):
            raise AssertionError("ship timing: import refused")
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        pages = ship.n_pages
    if [[p.data_ptr() for p in e.paged.store] for e in engines] != ptrs:
        raise AssertionError("ship timing: a pool moved")
    page_bytes = src.paged.bytes_per_page()
    nbytes = 2 * pages * page_bytes
    return {"ship_pair_ms": statistics.median(times),
            "ship_pair_ms_all": times, "pages": pages,
            "page_bytes": page_bytes, "bytes_moved": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "modeled_cost_s": ship.cost_s}


def _serve_cluster(entry, params, base, sched, kmods, smi, launches):
    """Full-width yi-6b behind the router, sharing one set of weights
    (bf16, paged, page 16, chunks of 128, the paged kernel, prefix
    sharing) on the grouped shared-prefix trace: a bare engine (the token
    baseline), 2 replicas under round_robin and under prefix_affinity
    (per tick), then tiers 1:1 with the decode tier fusing up to 16 steps
    (every bucket captured before the run), traced and exported; the four
    runs ``CLUSTER_REPEATS`` times over, with each metric's median and
    spread.  Every run's tokens equal the first baseline's; 8 shipments;
    the paged kernel launched on every decoding replica (in the tiered run
    the decode tier's, through its graph replays); the decode tier's pools
    at the addresses they had before the imports; the trace's phases
    summing to its makespan.  Then export + import pairs timed."""
    from repro_torch.launch.serve import dump_trace
    from repro_torch.obs import Tracer
    from repro_torch.serving.engine import EngineConfig, make_engine
    from repro_torch.serving.router import make_cluster
    cfg = entry.config

    def trace():
        return sched.make_grouped_prefix_trace(cfg.vocab, **CLUSTER_TRACE)

    ecfg = dict(base, paged=True, prefix_sharing=True,
                max_seq=SHARED_PREFIX + SHARED_TAIL
                + base["max_new_tokens"] + 2)
    n = CLUSTER_TRACE["n_requests"]
    keep = ("tokens_per_s", "tbt_mean_s", "tbt_p99_s", "e2e_p99_s",
            "wall_s")
    runs = {k: [] for k in ("bare", "round_robin", "prefix_affinity",
                            "tiers 1:1 fused")}
    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    want, reports = None, []
    for rep in range(CLUSTER_REPEATS):
        tag = f" #{rep + 1}" if rep else ""
        bare = make_engine(entry, EngineConfig(**ecfg), params=params)
        t0 = time.perf_counter()       # the scheduler's origin, to within us
        m, got, per = _cluster_run("yi-6b cluster bare" + tag, [bare],
                                   lambda: bare.run_trace(trace()), kmods,
                                   cfg.num_layers, launches)
        if want is None:
            want = got
            if len(want) != n or any(len(t) != base["max_new_tokens"]
                                     for t, _ in want.values()):
                raise AssertionError(f"bare run: {len(want)} of {n} "
                                     f"requests")
        _same_streams(f"bare{tag} vs bare", got, want)
        # Router.metrics' e2e and aggregate dedup, for one replica
        e2e = [r.finish_s - t0 - r.arrival_s for r in bare.completed]
        runs["bare"].append(dict(
            {k: m[k] for k in keep if k in m}, ttft_mean_s=m["ttft_mean_s"],
            e2e_p99_s=float(np.percentile(e2e, 99)),
            dedup_ratio_agg=(m["kv_logical_peak_pages"]
                             / (m["kv_peak_tokens"] // PAGE)),
            launches_per_replica=per))
        del bare
        _free()
        for policy in ("round_robin", "prefix_affinity"):
            router = make_cluster(entry, EngineConfig(**ecfg), 2,
                                  policy=policy, params=params)
            m, got, per = _cluster_run(f"yi-6b cluster {policy}{tag}",
                                       router.engines,
                                       lambda: router.run_trace(trace()),
                                       kmods, cfg.num_layers, launches)
            _same_streams(f"cluster {policy}{tag} vs bare", got, want)
            if not all(per):
                raise AssertionError(f"{policy}: a replica launched no "
                                     f"paged kernel: {per}")
            runs[policy].append(dict(
                {k: m[k] for k in keep + ("dedup_ratio_agg",)},
                launches_per_replica=per,
                requests_per_replica=[r["requests"]
                                      for r in m["per_replica"]]))
            del router
            _free()
        tiered = make_cluster(
            entry, EngineConfig(**dict(ecfg, fuse_steps=CLUSTER_FUSE_STEPS)),
            2, tiers=(1, 1), params=params)
        dec = tiered.engines[1]
        t0 = time.perf_counter()
        for k in range(1, CLUSTER_FUSE_STEPS.bit_length()):
            dec._fused_fn(1 << k)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        ptrs = [p.data_ptr() for p, seq in zip(dec.paged.store,
                                               dec.paged.is_seq) if seq]
        tracer = Tracer()
        tiered.set_tracer(tracer)
        m, got, per = _cluster_run(f"yi-6b cluster tiers 1:1 fused{tag}",
                                   tiered.engines,
                                   lambda: tiered.run_trace(trace()), kmods,
                                   cfg.num_layers, launches)
        _same_streams(f"tiered 1:1 fused{tag} vs bare", got, want)
        moved = [p.data_ptr() for p, seq in zip(dec.paged.store,
                                                dec.paged.is_seq)
                 if seq] != ptrs
        replays = {n_: g.replays for n_, g in dec._fused_graphs.items()}
        if (m["shipments"] != n or moved or per[0] != 0 or not per[1]
                or not dec.fused_horizons or not sum(replays.values())
                or tiered.engines[0].completed):
            raise AssertionError(f"tiered run: shipments {m['shipments']}, "
                                 f"pools moved {moved}, launches {per}, "
                                 f"replays {replays}")
        path = str(out / f"chip_smoke_cluster{rep + 1}.trace.json")
        rep_ = dump_trace(tracer.events, path, tag="smoke")
        phases = sum(rep_["phases"].values())
        if abs(phases - rep_["makespan_s"]) > 1e-9 * max(
                1.0, rep_["makespan_s"]) or rep_["events"].get("ship") != n:
            raise AssertionError(f"trace report off: {rep_}")
        reports.append(dict(rep_, trace_file=path, prefill_share=(
            rep_["phases"]["prefill_s"] / rep_["makespan_s"])))
        runs["tiers 1:1 fused"].append(dict(
            {k: m[k] for k in keep + ("dedup_ratio_agg", "shipments",
                                      "shipped_pages", "ship_cost_s")},
            launches_per_replica=per, capture_s=capture_s,
            fused_horizons=len(dec.fused_horizons), replays=replays,
            decode_pools_unmoved=not moved))
        del tiered, dec
        _free()
    spread = {name: {k: {"median": statistics.median(r[k] for r in rs),
                         "max_over_min": (max(r[k] for r in rs)
                                          / min(r[k] for r in rs))}
                     for k in keep}
              for name, rs in runs.items()}
    prompt = trace()[0].prompt
    ship = _ship_pair_ms(entry, params, ecfg, prompt)
    print("[serve] cluster " + json.dumps({
        "trace": CLUSTER_TRACE, "repeats": CLUSTER_REPEATS, "runs": runs,
        "spread": spread,
        "tokens_identical": sum(len(t) for t, _ in want.values()),
        "trace_reports": reports, "ship": ship,
        "note": "replicas share one card and tick in turn",
        "card": smi}))
    _free()


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
    _serve_cluster(entry, params, base, sched, kmods, smi, launches)
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
    for arch in ("recurrentgemma-9b", "whisper-small"):
        _serve_no_kernel(registry, arch, sched, kmods, smi, base, trace)
    _serve_qwen3(registry, sched, kmods, smi, base, trace, launches)
    return launches


def _serve_no_kernel(registry, arch, sched, kmods, smi, base, trace):
    """``arch`` at full width and depth on the paged engine, then the
    dense engine, per tick (whole-prompt prefill; whisper fed zero
    frames): every request finishes its budget with finite logits, the
    two engines give the same tokens, no kernel of the port launches (as
    in the reference, these families take none), and recurrentgemma's
    state holds no pages."""
    torch.cuda.reset_peak_memory_stats()
    entry, params = _init_full(registry, arch)
    streams, keep = {}, {}
    for paged in (True, False):
        counts, metrics, streams[paged] = _serve(
            entry, params, dict(base, paged=paged), trace(entry.config.vocab),
            sched, kmods, None, smi)
        keep["paged" if paged else "dense"] = {k: metrics[k] for k in (
            "tokens_per_s", "tbt_mean_s", "tbt_p99_s", "ttft_mean_s",
            "kv_peak_tokens", "wall_s")}
        if paged and arch == "recurrentgemma-9b" \
                and metrics["kv_peak_tokens"] != 0:
            raise AssertionError(f"{arch} paged KV peak "
                                 f"{metrics['kv_peak_tokens']} != 0")
    _same_streams(f"{arch} dense serve vs paged", streams[False],
                  streams[True])
    print(f"[serve] {arch} " + json.dumps({
        "runs": keep,
        "tokens_identical": sum(len(t) for t, _ in streams[True].values()),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": smi}))
    del params
    _free()


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


def _partial_case(fd, ref, gen, lengths, cap, p, dtype):
    """``fd.flash_decode_partial`` on each of the ``p`` context shards of
    one set of inputs against ``ref.flash_decode_partial_ref``; the
    shards combined by the log-sum-exp rule against flash_decode_ref on
    the whole cache; empty lanes exactly 0.  Returns the max |err| and
    the first shard's inputs."""
    x = _fd_inputs(gen, lengths, cap, dtype=dtype)
    q, k, v, glob = x["q"], x["k"], x["v"], x["lengths"]
    tol = KERNEL_TOL if dtype == torch.bfloat16 else F32_KERNEL_TOL
    sl = cap // p
    parts, err, first = [], 0.0, None
    for i in range(p):
        ks, vs = (t[:, i * sl:(i + 1) * sl].contiguous() for t in (k, v))
        local = (glob - i * sl).clamp(0, sl).to(torch.int32)
        got = fd.flash_decode_partial(q, ks, vs, local)
        want = ref.flash_decode_partial_ref(q, ks, vs, local)
        # acc is un-normalised (a sum of up to S/P weighted rows), so it
        # is held as acc / l, the shard's attention output, at the
        # kernel tolerance; l and m as they are
        norm = [a / torch.clamp(l, min=1e-20)[..., None] for a, l, _ in
                (got, want)]
        for name, g, w in (("acc / l", *norm), ("l", got[1], want[1]),
                           ("m", got[2], want[2])):
            err = max(err, _check(f"flash_decode_partial {name} shard {i}"
                                  f"/{p} lengths {local.tolist()}", g, w,
                                  tol))
        empty = local == 0
        if any((t[empty] != 0).any() for t in got):
            raise AssertionError("flash_decode_partial: an empty shard's "
                                 "acc / l / m is not 0")
        parts.append(got)
        first = first or (q, ks, vs, local)
    m_max = torch.stack([m for _, _, m in parts]).amax(0)
    acc = sum(a * torch.exp(m - m_max)[..., None] for a, _, m in parts)
    l_sum = sum(l * torch.exp(m - m_max) for _, l, m in parts)
    out = (acc / torch.clamp(l_sum, min=1e-20)[..., None]).reshape(q.shape)
    err = max(err, _check(f"combined partials lengths {glob.tolist()}",
                          out.to(q.dtype), ref.flash_decode_ref(q, k, v,
                                                                glob), tol))
    return err, first


def _partial_timed(fd, ref, q, ks, vs, local):
    """The partial's time at one shard beside its bound and its plain
    version's time (no PyTorch call computes acc / l / m)."""
    b, hq, d = q.shape
    hkv = ks.shape[2]
    ctx = int(local.sum())
    nbytes = (q.numel() * 2 + 2 * ctx * hkv * d * 2 + b * 4
              + (b * hq * d + 2 * b * hq) * 4)
    bound, by = _bound(nbytes, 4 * hq * d * ctx, BF16_FLOP_PER_S)
    return {"ms": time_ms(lambda: fd.flash_decode_partial(q, ks, vs, local)),
            "plain_ms": time_ms(lambda: ref.flash_decode_partial_ref(
                q, ks, vs, local)),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": {"B": b, "Hq": hq, "Hkv": hkv, "D": d,
                      "shard": ks.shape[1], "lengths": local.tolist(),
                      "dtype": "bfloat16"}}


def _partial_row(fd, ref):
    """The partial entry's checks (every DIST_CASES case in bf16 and
    float32) and its row, timed at the serve shape's first shard split 2
    ways (the two-rank run's shard) and 4 ways."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs, timed = {}, []
    for label, lengths, cap, p in DIST_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            err, first = _partial_case(fd, ref, gen, lengths, cap, p, dtype)
            errs[f"{label} {str(dtype)[6:]}"] = err
            if label.startswith("serve") and dtype == torch.bfloat16:
                timed.append(_partial_timed(fd, ref, *first))
    return {"name": "flash_decode_partial", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:169",
            "launches": None, "max_abs_err": max(errs.values()),
            **{k: timed[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
            "cases": timed, "cases_max_abs_err": errs}


def _greedy(prefill, step, vocab, feed=None):
    """(tokens (B, 1 + DIST_STEPS), prefill seconds, step seconds, the
    prefill's and the first step's logits): the prefill's argmax, then
    DIST_STEPS steps fed their own argmax; the first step is fed
    ``feed`` instead where given."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill()
    tok = logits[:, :vocab].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    toks, times, first = [tok], [], [logits[:, :vocab]]
    if feed is not None:
        tok = feed
    for _ in range(DIST_STEPS):
        t0 = time.perf_counter()
        logits, cache = step(cache, tok)
        tok = logits[:, :vocab].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        toks.append(tok)
        if len(first) == 1:
            first.append(logits[:, :vocab])
    return torch.stack(toks, 1), pre_s, times, first


def _dist_prompts(vocab):
    return torch.from_numpy(np.random.default_rng(7).integers(
        0, vocab, (DIST_BATCH, DIST_PROMPT)).astype(np.int32))


def _dist_inputs(cfg):
    """The prefill's inputs on the card: the prompts, and for the
    encoder-decoder float32 frames from a seed (the frontend stub's
    embeddings, (B, F, d))."""
    inputs = {"tokens": _dist_prompts(cfg.vocab).cuda()}
    if cfg.family == "audio":
        inputs["frames"] = torch.from_numpy(np.random.default_rng(8)
                                            .standard_normal(
            (DIST_BATCH, cfg.encoder_frames, cfg.d_model),
            dtype=np.float32)).cuda()
    return inputs


def _dist_launches():
    """The launch counters the [dist] runs read: the flash-decode partial
    (transformer families) and WKV6 (rwkv6)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import wkv6 as wk
    return fd, wk


def _dist_cells(entry, mesh, tp):
    """The prefill step (the prompt into a DIST_SEQ-deep cache) and
    build_cell's serve cell with the sequence-sharded attention."""
    from repro_torch.launch import steps
    from repro_torch.models.config import ShapeCell
    cell, _ = steps.build_cell(
        entry, mesh, ShapeCell("dist", DIST_SEQ, DIST_BATCH, "decode"),
        seq_sharded_attn=True)
    prefill = steps.make_prefill_step(
        entry, tp, mesh, max_seq=DIST_SEQ,
        shape=ShapeCell("dist", DIST_SEQ, DIST_BATCH, "prefill"))
    return cell, prefill


def _sharded_run(entry, params_l, cell, prefill, mesh, feed=None):
    """The sharded prefill + serve loop on this rank's shards (the first
    step fed the tokens ``feed`` where given): (the tokens gathered,
    prefill s, step s, launches in the run, the first two logits
    gathered, float32 on the host)."""
    from repro_torch.distributed import sharding as S
    rows = cell.in_specs[2] + (None,)
    inputs = {k: S.shard_tensor(v, rows[:1] + (None,) * (v.ndim - 1), mesh)
              for k, v in _dist_inputs(entry.config).items()}
    if feed is not None:
        feed = S.shard_tensor(torch.tensor(feed, dtype=torch.int32,
                                           device="cuda"), rows[:1], mesh)
    kmods = _dist_launches()
    _reset(kmods)
    toks, pre_s, step_s, first = _greedy(
        lambda: cell.run_with(prefill, params_l, inputs),
        lambda cache, tok: cell.step(params_l, cache, tok),
        entry.config.vocab, feed)
    launches = _launches(kmods)
    first = [S.gather_tensor(x, rows, mesh).float().cpu() for x in first]
    return S.gather_tensor(toks, rows, mesh), pre_s, step_s, launches, first


def _unsharded_fns(entry, params, tp, mesh=None):
    """The port's unsharded prefill and decode step on the [dist] inputs,
    under ``mesh`` (a description) where given: the transformer's
    ``prefill`` and ``decode_step`` with the flash-decode kernel; the
    other families' prefill and serve steps (rwkv6 through the WKV6
    kernel)."""
    from repro_torch.distributed import context
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeCell
    mod, cfg = entry.module, entry.config
    inputs = _dist_inputs(cfg)
    if cfg.family in registry.TRANSFORMER_FAMILIES:
        def prefill():
            with context.use_mesh(mesh):
                return mod.prefill(params, cfg, inputs["tokens"], tp=tp,
                                   max_seq=DIST_SEQ)

        def step(cache, tok):
            with context.use_mesh(mesh):
                return mod.decode_step(params, cfg, tok, cache, tp=tp,
                                       attn_fn=ops.attention_decode)
        return prefill, step
    pre = steps.make_prefill_step(
        entry, tp, mesh, max_seq=DIST_SEQ,
        shape=ShapeCell("dist", DIST_SEQ, DIST_BATCH, "prefill"))
    serve = steps.make_serve_step(
        entry, tp, mesh, shape=ShapeCell("dist", DIST_SEQ, DIST_BATCH,
                                         "decode"))
    return (lambda: pre(params, inputs),
            lambda cache, tok: serve(params, cache, tok))


def _unsharded_run(entry, params, tp, mesh=None):
    """:func:`_greedy` over :func:`_unsharded_fns`."""
    return _greedy(*_unsharded_fns(entry, params, tp, mesh),
                   entry.config.vocab)


def _dist_entry(registry, arch, layers, dtype):
    over = {"dtype": dtype}
    if layers:
        over["num_layers"] = layers
    return registry.get(arch, **over)


def _dist_rank(rank, world, port, arch, layers, dtype, shape, feed, out):
    """One spawned rank: gloo over CUDA tensors on the one card, the
    mesh bound; the ranks draw the full parameters from the seed one at
    a time and keep their shards; then the sharded run (its first step
    fed ``feed`` where given).  Writes its result to ``out`` (rank 0
    also the first two logits)."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.models import registry
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = M.bind(M.make_mesh(shape, ("data", "model")), "cuda")
        entry = _dist_entry(registry, arch, layers, dtype)
        tp = mesh.shape["model"]
        cell, prefill = _dist_cells(entry, mesh, tp)
        params_l = None
        for turn in range(world):
            if turn == rank:
                full = entry.module.init(entry.config, tp, device="cuda",
                                         seed=0)
                params_l = S.shard_tree(full, cell.in_specs[0], mesh)
                del full
                torch.cuda.empty_cache()
            dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        toks, pre_s, step_s, launches, first = _sharded_run(
            entry, params_l, cell, prefill, mesh, feed)
        if rank == 0:
            torch.save(first, out.format(rank) + ".pt")
        Path(out.format(rank)).write_text(json.dumps({
            "tokens": toks.tolist(), "prefill_s": pre_s,
            "step_median_s": statistics.median(step_s),
            "launches": launches,
            "fsdp_layer_gathers": cell.fsdp.layer_gathers
            if cell.fsdp is not None else None,
            "held_gb": torch.cuda.memory_allocated() / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn_ranks(label, world, target, args):
    """``world`` ranks of ``target(rank, world, port, *args, out)`` (start
    method spawn), each writing its JSON result to ``out.format(rank)``;
    a rank that raises, or a run past DIST_TIMEOUT_S, fails the phase.
    Returns each rank's result and the results' path pattern."""
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_dist"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = str(out_dir / f"{label}-rank{{}}.json")
    ctx = mp.start_processes(target, args=(world, port, *args, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{label}: ranks still running after "
                                   f"{DIST_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    return [json.loads(Path(out.format(r)).read_text())
            for r in range(world)], out


def _world_one(registry, fd, smi):
    """(a): an in-process NCCL group of world size 1, bf16 yi-6b."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = M.bind(M.make_mesh((1, 1), ("data", "model")), "cuda")
        entry, params = _init_full(registry, "yi-6b")
        base, base_pre, base_steps, _ = _unsharded_run(entry, params, 1)
        cell, prefill = _dist_cells(entry, mesh, 1)
        from repro_torch.distributed import sharding as S
        params_l = S.shard_tree(params, cell.in_specs[0], mesh)
        toks, pre_s, step_s, launches, _ = _sharded_run(
            entry, params_l, cell, prefill, mesh)
    finally:
        dist.destroy_process_group()
    want = entry.config.num_layers * DIST_STEPS
    if not torch.equal(toks.cpu(), base.cpu()):
        raise AssertionError(f"[dist] world size 1: sharded tokens "
                             f"{toks.tolist()} != unsharded "
                             f"{base.tolist()}")
    if launches["flash_decode_partial"] != want:
        raise AssertionError(f"[dist] world size 1: flash_decode_partial "
                             f"launched {launches['flash_decode_partial']} "
                             f"times, want {want}")
    print("[dist] (a) yi-6b bf16 world size 1 (nccl, mesh (1, 1)) "
          + json.dumps({
              "tokens_identical": toks.numel(), "prompt": DIST_PROMPT,
              "cache": DIST_SEQ, "batch": DIST_BATCH,
              "sharded_prefill_ms": pre_s * 1e3,
              "sharded_serve_step_median_ms":
                  statistics.median(step_s) * 1e3,
              "unsharded_prefill_ms": base_pre * 1e3,
              "unsharded_decode_step_median_ms":
                  statistics.median(base_steps) * 1e3,
              "launches": launches, "card": smi}))
    del params, params_l
    _free()
    return launches["flash_decode_partial"]


def _rel_err(got, want):
    return ((got - want).norm() / want.norm()).item()


def _wrong_shard(params, cfg):
    """``params`` with the two row halves of every layer's row-parallel
    output projection swapped, as a rank holding the other's row shard
    would compute them: attention's ``wo``, rwkv6's time-mix ``wo``,
    RecurrentGemma's recurrent ``w_out``."""
    def swap(t, dim):
        h = t.shape[dim] // 2
        return torch.cat([t.narrow(dim, h, h), t.narrow(dim, 0, h)], dim)

    if cfg.family == "ssm":
        return dict(params, blocks=dict(params["blocks"],
                                        wo=swap(params["blocks"]["wo"], 1)))
    if cfg.family == "hybrid":
        out = dict(params)
        for name, dim in (("rec_groups", 2), ("rec_tail", 1)):
            if name in params:
                out[name] = dict(params[name],
                                 w_out=swap(params[name]["w_out"], dim))
        return out
    attn = params["blocks"]["attn"]
    return dict(params, blocks=dict(params["blocks"], attn=dict(
        attn, wo=swap(attn["wo"], 1))))


def _single_process(registry, arch, layers, dtype, shape):
    """The model's unsharded tokens and first two logits in this process
    (the same seed as the ranks' parameters), under ``shape``'s mesh
    description (the MoE caps each data chunk and runs each model rank's
    experts in turn); in bf16 also two prefill logits' relative errors
    against these: the wrong-shard control (:func:`_wrong_shard`) and
    bf16's own noise (the same weights computed in float32)."""
    from repro_torch.launch import mesh as M
    entry = _dist_entry(registry, arch, layers, dtype)
    cfg, tp = entry.config, shape[1]
    mesh = M.make_mesh(shape, ("data", "model"))
    params = entry.module.init(cfg, tp, device="cuda", seed=0)
    toks, _, _, first = _unsharded_run(entry, params, tp, mesh)
    first = [x.float().cpu() for x in first]
    control = {}
    if dtype == "bfloat16":
        from repro_torch.distributed import sharding as S
        entry32 = _dist_entry(registry, arch, layers, "float32")
        for key in ("wrong_shard", "float32_compute"):
            e, p = (entry, _wrong_shard(params, cfg)) \
                if key == "wrong_shard" else \
                (entry32, S.tree_map(lambda t: t.float(), params))
            logits, _ = _unsharded_fns(e, p, tp, mesh)[0]()
            control[key] = _rel_err(first[0],
                                    logits[:, :cfg.vocab].float().cpu())
            del p, logits
    del params
    _free()
    return toks.cpu(), first, control


def _want_launches(cfg, n_layers):
    """Each rank's kernel launches in a [dist] run: the flash-decode
    partial once a layer and step (transformer families), WKV6 once a
    layer in the prefill (on the chunked design: the prompt is past
    wk.CHUNKED_MIN_T) and in each step (rwkv6); none for the others."""
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import registry
    want = {"flash_decode_partial": 0, "wkv6": 0, "wkv6_chunked": 0}
    if cfg.family in registry.TRANSFORMER_FAMILIES:
        want["flash_decode_partial"] = n_layers * DIST_STEPS
    if cfg.family == "ssm":
        want["wkv6"] = n_layers * (1 + DIST_STEPS)
        want["wkv6_chunked"] = n_layers * (DIST_PROMPT >= wk.CHUNKED_MIN_T)
    return want


def _dist_run(registry, arch, layers, dtype, shape, smi):
    """One multi-rank run on the one card against the single-process
    run: float32 tokens equal, bf16 logits within DIST_BF16_REL_TOL
    (and the wrong-shard control beyond it); each rank launched its
    family's kernels (:func:`_want_launches`).  Returns (label, the
    launches summed over the ranks by kernel)."""
    t0 = time.perf_counter()
    world = shape[0] * shape[1]
    cfg = _dist_entry(registry, arch, layers, dtype).config
    n_layers = cfg.num_layers
    label = (f"{arch} {dtype}, {n_layers} layers, {world} ranks, mesh "
             f"({shape[0]}, {shape[1]})")
    base, base_first, control = _single_process(registry, arch, layers,
                                                dtype, shape)
    # bf16: the first step is fed the single-process run's first tokens,
    # so both first steps see the same input even where a prefill argmax
    # flips within bf16's noise
    feed = base[:, 0].tolist() if dtype == "bfloat16" else None
    results, out = _spawn_ranks(f"{arch}-{dtype}-{shape[0]}x{shape[1]}",
                                world, _dist_rank,
                                (arch, layers, dtype, shape, feed))
    first = torch.load(out.format(0) + ".pt")
    want = _want_launches(cfg, n_layers)
    for r, res in enumerate(results):
        gathers = res["fsdp_layer_gathers"]
        if gathers is not None and gathers != n_layers * (1 + DIST_STEPS):
            raise AssertionError(
                f"[dist] {label} rank {r}: FSDP gathered {gathers} layers, "
                f"want one a layer in the prefill and in each step, "
                f"{n_layers * (1 + DIST_STEPS)}")
        got = {k: res["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"[dist] {label} rank {r}: launches "
                                 f"{got}, want {want}")
        if res["tokens"] != results[0]["tokens"]:
            raise AssertionError(f"[dist] {label}: ranks 0 and {r} "
                                 f"gathered different tokens")
    got = torch.tensor(results[0]["tokens"], dtype=base.dtype)
    line = {"tokens_equal": int((got == base).sum()),
            "tokens": base.numel()}
    if dtype == "float32":
        if not torch.equal(got, base):
            raise AssertionError(f"[dist] {label}: tokens {got.tolist()} "
                                 f"!= single-process {base.tolist()}")
    else:
        errs = [_rel_err(g, w) for g, w in zip(first, base_first)]
        line.update(prefill_logits_rel_err=errs[0],
                    step1_logits_rel_err=errs[1],
                    wrong_shard_rel_err=control["wrong_shard"],
                    unsharded_vs_float32_compute_rel_err=control[
                        "float32_compute"], tol=DIST_BF16_REL_TOL)
        if max(errs) > DIST_BF16_REL_TOL:
            raise AssertionError(f"[dist] {label}: logits' relative "
                                 f"errors {errs} beyond "
                                 f"{DIST_BF16_REL_TOL}")
        if control["wrong_shard"] <= DIST_BF16_REL_TOL:
            raise AssertionError(f"[dist] {label}: a wrong shard's "
                                 f"relative error {control['wrong_shard']}"
                                 f" is within {DIST_BF16_REL_TOL}")
    print(f"[dist] {label} on one card (gloo; correctness runs, no "
          f"collective bandwidth) " + json.dumps({
              **line, "launches_per_rank": want,
              "ranks": [{k: v for k, v in res.items()
                         if k != "tokens"} for res in results],
              "run_s": time.perf_counter() - t0, "card": smi}))
    return label, {k: n * world for k, n in want.items()}


def phase_dist(registry, fd, ref, smi):
    """The distribution layer on the card; returns the partial entry's
    kernel row (launches by run) and WKV6's launches by run (the sharded
    rwkv6 runs, by kernel row name)."""
    t0 = time.perf_counter()
    row = _partial_row(fd, ref)
    print("[dist] flash_decode_partial " + json.dumps(
        {**row, "card": smi}))
    launches = {"yi-6b bfloat16, world size 1": _world_one(registry, fd,
                                                            smi)}
    wkv = {"wkv6": {}, "wkv6_chunked": {}}
    torch.backends.cuda.matmul.allow_tf32 = False
    for run in DIST_RUNS:
        label, n = _dist_run(registry, *run, smi)
        if n["flash_decode_partial"]:
            launches[label] = n["flash_decode_partial"]
        for name in wkv:
            if n[name]:
                wkv[name][f"[dist] {label}"] = n[name]
    row["launches_by_run"] = launches
    row["launches"] = sum(launches.values())
    print(f"[dist] phase {time.perf_counter() - t0:.1f} s")
    return row, wkv


def _train_parity(registry, steps_mod, axw, pipeline):
    """The train step on the card against the same step on the host CPU:
    reduced yi-6b and qwen3-30b-a3b in float32 (TF32 off), the same
    port-initialized parameters on both, TRAIN_PARITY_STEPS steps of
    TokenPipeline batches; per-step losses within 1e-4 and gradient
    norms within 1e-3, relative."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch in ("yi-6b", "qwen3-30b-a3b"):
        entry = registry.get(arch, reduced=True)
        ocfg = axw.AdamWConfig(**TRAIN_PARITY_OCFG)
        data = pipeline.TokenPipeline(pipeline.DataConfig(
            vocab=entry.config.vocab, seq_len=TRAIN_PARITY_SEQ,
            global_batch=TRAIN_PARITY_BATCH))
        host = entry.module.init(entry.config, device="cpu", seed=0)
        curves = {}
        for dev in ("cpu", "cuda"):
            # a copy on each side: the step trains its parameters in place
            params = _tree_map(host, lambda t: t.to(dev, copy=True))
            opt = axw.init(params, ocfg)
            step = steps_mod.make_train_step(entry, ocfg)
            curve = []
            for i in range(TRAIN_PARITY_STEPS):
                batch = {k: v for k, v in data.batch_at(i).items()
                         if k != "mask"}
                params, opt, m = step(params, opt, batch)
                curve.append((float(m["loss"]), float(m["grad_norm"])))
            curves[dev] = curve
        for i, ((lc, gc), (lg, gg)) in enumerate(zip(curves["cpu"],
                                                     curves["cuda"])):
            if not (np.isfinite(lg) and abs(lg - lc) <= 1e-4 * abs(lc)
                    and abs(gg - gc) <= 1e-3 * abs(gc)):
                raise AssertionError(
                    f"{arch} train step {i}: card loss {lg} / grad norm "
                    f"{gg} against the host's {lc} / {gc}")
        out[arch] = {"loss_card": [l for l, _ in curves["cuda"]],
                     "loss_cpu": [l for l, _ in curves["cpu"]],
                     "max_loss_rel_err": max(
                         abs(a[0] - b[0]) / abs(b[0])
                         for a, b in zip(curves["cuda"], curves["cpu"])),
                     "max_grad_norm_rel_err": max(
                         abs(a[1] - b[1]) / abs(b[1])
                         for a, b in zip(curves["cuda"], curves["cpu"]))}
    print("[train] parity card vs cpu " + json.dumps(out))


def _train_bound_ms(cfg, params, batch: int, seq: int) -> dict:
    """The step's least time on the card: 6 x the matmul parameters x
    tokens (forward, and backward at twice that) plus the causal
    attention's products (QK^T and PV over the S(S+1)/2 pairs each query
    sees, forward and backward), at the bf16 tensor rate."""
    blocks = _leaves(params["blocks"])
    n_matmul = sum(t.numel() for t in blocks if t.dim() == 3)
    n_matmul += cfg.padded_vocab(1) * cfg.d_model            # the head
    tokens = batch * seq
    attn = 3 * 4 * batch * cfg.num_q_heads * cfg.d_head \
        * seq * (seq + 1) // 2 * cfg.num_layers
    flops = 6 * n_matmul * tokens + attn
    return {"n_matmul": n_matmul, "model_flops": flops,
            "bound_ms": flops / BF16_FLOP_PER_S * 1e3}


def _train_full(registry, steps_mod, train_mod, profile_mod, axw, pipeline,
                smi):
    """stablelm-3b at full width and depth, bf16, through
    ``launch.train.train``: finite losses that fall, and its step time,
    tokens/s, peak memory and share of the FLOP bound; then one step of
    the same trainer's step function under ``torch.profiler`` for the
    card's busy share."""
    arch, batch, seq, steps = TRAIN_FULL
    _free()
    torch.cuda.reset_peak_memory_stats()
    out = train_mod.train(arch, steps=steps, global_batch=batch, seq=seq,
                          ckpt_dir=None, reduced=False, log_every=1,
                          device="cuda")
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{arch} full-width losses {losses}")
    timed = out["step_s"][1:]                 # steps 2-8: warm
    med = statistics.median(timed)
    entry = registry.get(arch)
    params = entry.module.init(entry.config, device="cuda", seed=0)
    n_params = sum(t.numel() for t in _leaves(params))
    bound = _train_bound_ms(entry.config, params, batch, seq)
    # one warm step, then one profiled, of the trainer's step function
    ocfg = axw.AdamWConfig(total_steps=max(steps, 10),
                           warmup_steps=min(20, steps))
    opt = axw.init(params, ocfg)
    step = steps_mod.make_train_step(entry, ocfg)
    data = pipeline.TokenPipeline(pipeline.DataConfig(
        vocab=entry.config.vocab, seq_len=seq, global_batch=batch))
    params, opt, _ = step(params, opt, train_mod.model_batch(
        entry.config, data, 0))
    torch.cuda.synchronize()
    b1 = train_mod.model_batch(entry.config, data, 1)
    prof = profile_mod._profile(lambda: step(params, opt, b1),
                                torch.device("cuda"))
    # the step's two halves between CUDA events: loss and gradients
    # (forward, recompute, backward), then the AdamW update
    b2 = steps_mod._on(train_mod.model_batch(entry.config, data, 2), "cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    _, grads = steps_mod._grads(entry.module, entry.config, params, b2, 1)
    ev[1].record()
    axw.update(axw.tree_unflatten(params, grads), opt, params, ocfg)
    ev[2].record()
    torch.cuda.synchronize()
    del grads
    print(f"[train] {arch} full width " + json.dumps({
        "parameters": n_params, "batch": batch, "seq": seq,
        "dtype": entry.config.dtype, "losses": losses,
        "max_memory_allocated_gb": peak / 1e9,
        "step_ms_median": med * 1e3, "step_ms_max": max(timed) * 1e3,
        "step_ms_min": min(timed) * 1e3, "first_step_ms":
        out["step_s"][0] * 1e3,
        "tokens_per_s": batch * seq / med,
        "matmul_parameters": bound["n_matmul"],
        "model_flops": bound["model_flops"],
        "bound_ms": bound["bound_ms"],
        "share_of_bound": bound["bound_ms"] / (med * 1e3),
        "profiled_step_wall_ms": prof["wall_ms"],
        "profiled_step_device_busy_ms": prof["device_busy_ms"],
        "device_busy_share": prof["device_busy_ms"] / prof["wall_ms"],
        "device_ms_by_kind": prof["device_ms_by_kind"],
        "grads_ms": ev[0].elapsed_time(ev[1]),
        "update_ms": ev[1].elapsed_time(ev[2]),
        "top_device_ops": prof["top"], "card": smi}))
    del params, opt, step
    _free()


def _train_resume(train_mod):
    """Reduced stablelm-3b on the card, as the reference's
    ``test_train_resume_is_exact`` runs it: 10 steps, then 6 and a
    resume from the checkpoint; the final losses within 1e-4."""
    ckpt = Path(__file__).resolve().parent / "build" / "train_resume"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(steps=10, global_batch=2, seq=32, log_every=100, seed=3,
              device="cuda")
    a = train_mod.train("stablelm-3b", ckpt_dir=None, **kw)
    train_mod.train("stablelm-3b", stop_step=6, ckpt_dir=str(ckpt),
                    save_every=6, **kw)
    b = train_mod.train("stablelm-3b", ckpt_dir=str(ckpt), save_every=100,
                        **kw)
    shutil.rmtree(ckpt, ignore_errors=True)
    if b["steps"] != 4 or not abs(b["final_loss"] - a["final_loss"]) \
            <= 1e-4 * abs(a["final_loss"]):
        raise AssertionError(f"resume: {b['steps']} steps to "
                             f"{b['final_loss']} against {a['final_loss']}")
    print("[train] resume " + json.dumps({
        "uninterrupted_final_loss": a["final_loss"],
        "resumed_final_loss": b["final_loss"], "resumed_steps": b["steps"]}))


def _train_curve(step, params, opt, batches):
    """Run ``step`` over ``batches``: (params, opt, [(loss, gradient
    norm)], [seconds a step, ended by reading the loss])."""
    curve, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        curve.append((float(m["loss"]), float(m["grad_norm"])))
        times.append(time.perf_counter() - t0)
    return params, opt, curve, times


def _train_world_one(registry, steps_mod, train_mod, axw, pipeline, smi):
    """(a): the train Cell of mesh (1, 1) on an in-process NCCL group of
    one rank against the unsharded step, stablelm-3b at full width and
    depth in bf16, the same weights and batches: losses, gradient norms
    and parameters bit for bit (deterministic kernels on, in both)."""
    import socket

    import torch.distributed as dist
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.models.config import ShapeCell
    arch, batch, seq = TRAIN_WORLD_ONE
    entry = registry.get(arch)
    cfg = entry.config
    ocfg = axw.AdamWConfig(**TRAIN_PARITY_OCFG)
    data = pipeline.TokenPipeline(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch))
    batches = [train_mod.model_batch(cfg, data, i)
               for i in range(TRAIN_MESH_STEPS)]
    _free()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        params = entry.module.init(cfg, device="cuda", seed=0)
        params, opt, want, base_s = _train_curve(
            steps_mod.make_train_step(entry, ocfg), params,
            axw.init(params, ocfg), batches)
        host = [t.cpu() for t in _leaves(params)]
        del params, opt
        _free()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                f"{port}", rank=0, world_size=1)
        try:
            mesh = M.bind(M.make_mesh((1, 1), ("data", "model")), "cuda")
            cell, _ = steps_mod.build_cell(
                entry, mesh, ShapeCell("train", seq, batch, "train"),
                ocfg=ocfg)
            params, _, _ = cell.shard(
                entry.module.init(cfg, device="cuda", seed=0), None, None)
            opt = S.local_zeros(axw.init(entry.module.init(
                cfg, device="meta"), ocfg), cell.in_specs[1], mesh, "cuda")
            params, opt, got, cell_s = _train_curve(
                cell.step, params, opt,
                [cell.shard(None, None, b)[2] for b in batches])
            same = [torch.equal(a, b.cpu())
                    for a, b in zip(host, _leaves(params))]
        finally:
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    del params, opt, host
    _free()
    if got != want or not all(same):
        raise AssertionError(
            f"[train] (a) {arch} world size 1: the Cell's (loss, gradient "
            f"norm) {got} against the unsharded step's {want}; "
            f"{same.count(False)} of {len(same)} leaves differ")
    print(f"[train] (a) {arch} bf16 world size 1 (nccl, mesh (1, 1)) "
          + json.dumps({
              "batch": batch, "seq": seq, "steps": TRAIN_MESH_STEPS,
              "bitwise": True, "losses": [l for l, _ in got],
              "grad_norms": [g for _, g in got],
              "leaves_equal": len(same),
              "cell_step_ms": [t * 1e3 for t in cell_s],
              "unsharded_step_ms": [t * 1e3 for t in base_s],
              "cell_step_ms_median_warm":
                  statistics.median(cell_s[1:]) * 1e3,
              "unsharded_step_ms_median_warm":
                  statistics.median(base_s[1:]) * 1e3,
              "deterministic_algorithms": True, "card": smi}))


def _train_entry(registry, arch, layers):
    """``arch`` in float32 at ``layers`` layers (the encoder-decoder's
    encoder too)."""
    over = {"dtype": "float32", "num_layers": layers}
    if registry.get_config(arch).family == "audio":
        over["encoder_layers"] = layers
    return registry.get(arch, **over)


def _layer_gathers_per_step(cfg):
    """FSDP layer gathers of one train step: every layer in the forward
    and again where backward recomputes it (RecurrentGemma recomputes
    its (rec, rec, attn) groups, not its recurrent tail)."""
    if cfg.family == "hybrid":
        return cfg.num_layers + 3 * (cfg.num_layers // 3)
    return 2 * (cfg.num_layers + cfg.encoder_layers)


def _train_data(pipeline, cfg, batch, seq):
    return pipeline.TokenPipeline(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch))


def _record_routes():
    """Keep every top-k choice ``layers._route`` makes while autograd
    records, in call order: (the sorted experts, the gap between each
    token's k-th and (k+1)-th router logit), on the host.  Returns the
    list and a function that removes the recording."""
    from repro_torch.models import layers as L
    real, calls = L._route, []

    def route(p, x, cfg):
        weights, experts = real(p, x, cfg)
        if torch.is_grad_enabled():
            top = (x.detach().float() @ p["router"]).topk(cfg.topk + 1,
                                                          -1).values
            calls.append((experts.sort(-1).values.cpu(),
                          (top[:, -2] - top[:, -1]).cpu()))
        return weights, experts

    L._route = route
    return calls, lambda: setattr(L, "_route", real)


def _first_route_changes(single, by_chunk, layers):
    """Per data chunk, the gaps of the tokens routed to other experts at
    the first layer of step 0's forward whose routing differs (a change
    in a later layer follows from the changed hidden states).
    ``single``: one process's calls, chunk by chunk within each layer;
    ``by_chunk[d]``: the calls of the rank holding data chunk d."""
    gaps = []
    for d, calls in enumerate(by_chunk):
        for li in range(layers):
            es, gs = single[li * len(by_chunk) + d]
            diff = (es != calls[li][0]).any(-1)
            if diff.any():
                gaps += gs[diff].tolist()
                break
    return gaps


def _train_rank(rank, world, port, arch, layers, shape, batch, seq,
                microbatch, out):
    """One spawned rank of (b) / (c): gloo over CUDA tensors on the one
    card, the mesh bound; the ranks draw the full float32 parameters in
    turn and keep their shards, make their ZeRO-1 moments in shards, and
    run TRAIN_MESH_STEPS steps of the train Cell on their rows of the
    TokenPipeline batches.  Writes its curve, step times, peak allocated
    memory (the steps alone) and FSDP layer gathers a step."""
    import torch.distributed as dist
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw as axw
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    routes, _ = _record_routes()
    try:
        mesh = M.bind(M.make_mesh(shape, ("data", "model")), "cuda")
        entry = _train_entry(registry, arch, layers)
        cfg, tp = entry.config, shape[1]
        ocfg = axw.AdamWConfig(**TRAIN_PARITY_OCFG)
        cell, _ = steps_mod.build_cell(
            entry, mesh, ShapeCell("train", seq, batch, "train"), ocfg=ocfg,
            microbatch=microbatch)
        params = None
        for turn in range(world):
            if turn == rank:
                params, _, _ = cell.shard(entry.module.init(
                    cfg, tp, device="cuda", seed=0), None, None)
                torch.cuda.empty_cache()
            dist.barrier()
        opt = S.local_zeros(axw.init(entry.module.init(
            cfg, tp, device="meta"), ocfg), cell.in_specs[1], mesh, "cuda")
        data = _train_data(pipeline, cfg, batch, seq)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gathers = []
        curve, times = [], []
        for i in range(TRAIN_MESH_STEPS):
            b = cell.shard(None, None, train_mod.model_batch(cfg, data,
                                                             i))[2]
            g0 = cell.fsdp.layer_gathers if cell.fsdp is not None else 0
            params, opt, c, t = _train_curve(cell.step, params, opt, [b])
            curve += c
            times += t
            if cell.fsdp is not None:
                gathers.append(cell.fsdp.layer_gathers - g0)
        torch.save(routes[:layers], out.format(rank) + ".routes.pt")
        Path(out.format(rank)).write_text(json.dumps({
            "curve": curve, "step_s": times, "fsdp": cell.fsdp is not None,
            "layer_gathers_per_step": gathers,
            "held_gb": held / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _train_single(registry, steps_mod, train_mod, axw, pipeline, arch,
                  layers, shape, batch, seq, microbatch):
    """The same model's train step in this process under ``shape``'s
    mesh description (float32, TF32 off): its (loss, gradient norm)
    curve, step seconds and step 0's forward routing."""
    from repro_torch.launch import mesh as M
    entry = _train_entry(registry, arch, layers)
    cfg, tp = entry.config, shape[1]
    ocfg = axw.AdamWConfig(**TRAIN_PARITY_OCFG)
    data = _train_data(pipeline, cfg, batch, seq)
    params = entry.module.init(cfg, tp, device="cuda", seed=0)
    step = steps_mod.make_train_step(entry, ocfg, tp,
                                     M.make_mesh(shape, ("data", "model")),
                                     microbatch)
    routes, unrecord = _record_routes()
    try:
        # the trained parameters and moments are dropped here, before
        # the ranks need the card
        curve, times = _train_curve(
            step, params, axw.init(params, ocfg),
            [train_mod.model_batch(cfg, data, i)
             for i in range(TRAIN_MESH_STEPS)])[2:]
    finally:
        unrecord()
    del params, step
    _free()
    return curve, times, routes[:layers * shape[0]]


def _train_mesh(registry, steps_mod, train_mod, axw, pipeline, smi, arch,
                layers, shape, batch, seq, microbatch):
    """(b) / (c) / (d): the ranks' curves against the single-process
    run's: losses within TRAIN_LOSS_RTOL and gradient norms within
    TRAIN_GNORM_RTOL, relative, on every rank; under FSDP every layer
    gathered where it runs (:func:`_layer_gathers_per_step`).  An MoE's step 0
    must route every token as one process does, except at a tie
    (ROUTE_TIE); where a tie broke the other way, only step 0 is held
    (the runs diverge from there: the routes differ, and the first
    AdamW step moves a parameter by about the learning rate whatever
    its gradient's size, so gradients that differ in their last bits
    can move it the other way), and the later steps' errors are
    printed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    world = shape[0] * shape[1]
    per_step = _layer_gathers_per_step(_train_entry(registry, arch,
                                                    layers).config)
    label = (f"{arch} float32, {layers} layers, mesh ({shape[0]}, "
             f"{shape[1]}), batch {batch} x {seq}, microbatch {microbatch}")
    want, single_s, routes = _train_single(registry, steps_mod, train_mod,
                                           axw, pipeline, arch, layers,
                                           shape, batch, seq, microbatch)
    results, out = _spawn_ranks(f"train-{arch}-{layers}-{shape[0]}x"
                                f"{shape[1]}", world, _train_rank,
                                (arch, layers, shape, batch, seq,
                                 microbatch))
    ties = []
    if routes:
        ties = _first_route_changes(routes, [
            torch.load(out.format(d * shape[1]) + ".routes.pt")
            for d in range(shape[0])], layers)
        if any(g >= ROUTE_TIE for g in ties):
            raise AssertionError(f"[train] {label}: step 0 routes tokens "
                                 f"to other experts at logit gaps {ties}, "
                                 f"not ties (< {ROUTE_TIE})")
    held = 1 if ties else len(want)
    floor = None
    if arch in TRAIN_NOISE_FLOOR:
        # one process at 2 microbatches: the same function, its
        # gradients summed in another order
        other = _train_single(registry, steps_mod, train_mod, axw,
                              pipeline, arch, layers, shape, batch, seq,
                              2 * microbatch)[0]
        floor = [(abs(lo - lw) / abs(lw), abs(go - gw) / abs(gw))
                 for (lo, go), (lw, gw) in zip(other, want)]
        held = min(held, max(1, next(
            (i for i, (lf, gf) in enumerate(floor)
             if lf > TRAIN_LOSS_RTOL or gf > TRAIN_GNORM_RTOL), held)))
    errs = []
    for r, res in enumerate(results):
        for i, ((lg, gg), (lw, gw)) in enumerate(zip(res["curve"], want)):
            errs.append((abs(lg - lw) / abs(lw), abs(gg - gw) / abs(gw)))
            if i < held and not (errs[-1][0] <= TRAIN_LOSS_RTOL
                                 and errs[-1][1] <= TRAIN_GNORM_RTOL):
                raise AssertionError(
                    f"[train] {label} rank {r}: (loss, gradient norm) "
                    f"{res['curve']} against one process's {want}")
        if res["fsdp"] and any(g != per_step
                               for g in res["layer_gathers_per_step"]):
            raise AssertionError(
                f"[train] {label} rank {r}: FSDP gathered "
                f"{res['layer_gathers_per_step']} layers a step, want "
                f"{per_step}")
    print(f"[train] {label} on one card (gloo; {world} ranks share the "
          f"card: step times are correctness runs and measure no "
          f"collective bandwidth) " + json.dumps({
              "single_process_curve": want,
              "single_process_step_s": single_s,
              "routing_ties_broken_otherwise": ties,
              "one_process_reordered_rel_err_by_step": floor,
              "steps_held": held,
              "loss_rel_err_by_step": [e[0] for e in errs[:len(want)]],
              "grad_norm_rel_err_by_step": [e[1] for e in errs[:len(want)]],
              "max_loss_rel_err": max(e[0] for e in errs),
              "max_grad_norm_rel_err": max(e[1] for e in errs),
              "ranks": results, "run_s": time.perf_counter() - t0,
              "card": smi}))


def phase_train(registry, smi):
    """The training path on the card; no kernel of the port is on it (the
    reference's kernels have no backward, and it trains without them)."""
    from repro_torch.data import pipeline
    from repro_torch.launch import profile_step as profile_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw as axw
    t0 = time.perf_counter()
    _train_parity(registry, steps_mod, axw, pipeline)
    _train_full(registry, steps_mod, train_mod, profile_mod, axw, pipeline,
                smi)
    _train_resume(train_mod)
    _train_world_one(registry, steps_mod, train_mod, axw, pipeline, smi)
    for run in TRAIN_MESH_RUNS:
        _train_mesh(registry, steps_mod, train_mod, axw, pipeline, smi,
                    *run)
    print(f"[train] phase {time.perf_counter() - t0:.1f} s")


CHECKS_DRYRUN = (("yi-6b", "decode_32k"), ("stablelm-3b", "train_4k"))
#: the count check's serve step: yi-6b at full width, mesh (1, 1), B = 4
#: at contexts 768-778 in an 800-deep cache (profile_step's shape)
CHECKS_SERVE = ("yi-6b", 4, 800, (768, 771, 775, 778))
ARG_BYTES_TOL = 0.01


def _count_on_card(registry):
    """yi-6b's serve step counted on meta tensors, then run on the card
    under the same counters: (meta count, card count, argument bytes
    counted, memory growth of the stand-ins made on the card, partial
    launches)."""
    from repro_torch.analysis import roofline
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models.config import ShapeCell

    arch, b, cap, lens = CHECKS_SERVE
    entry = registry.get(arch)
    mesh = M.simulate(M.make_mesh((1, 1), ("data", "model")))
    shape = ShapeCell("serve", cap, b, "decode")
    cell, args = steps.build_cell(entry, mesh, shape, seq_sharded_attn=True)
    local = cell.shard(*args)
    counted = sum(t.numel() * t.element_size() for a in local
                  for _, t in sh.tree_leaves_with_path(a))
    meta = roofline.count_step(cell.step, *local)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = entry.module.init(entry.config, 1, device="cuda", seed=0)
    cache = entry.cache_zeros(b, cap, 1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for leaf in (cache.k, cache.v):
        leaf.normal_(generator=gen)
    cache.lengths.copy_(torch.tensor(lens, dtype=torch.int32))
    tokens = torch.randint(0, entry.config.vocab, (b,), generator=gen,
                           device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    fd.reset_launches()
    card = roofline.count_step(cell.step, params, cache, tokens)
    torch.cuda.synchronize()
    launches = fd.LAUNCHES["flash_decode_partial"]
    finite = bool(torch.isfinite(card.outputs[0]).all())
    card.outputs = None
    del params, cache, tokens
    if not finite:
        raise AssertionError("[checks] the card's serve step gave "
                             "non-finite logits")
    return meta, card, counted, grown, launches


def phase_checks(registry, smi):
    """The port's invariant checks on the card, the dry run's reports and
    the count held against the card."""
    from repro_torch.analysis import checks
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    errs = {}
    findings = checks.run_all("cuda", errs=errs)
    if not errs:
        raise AssertionError("[checks] the kernel probes compared nothing")
    if findings:
        raise AssertionError("[checks] findings on the port:\n"
                             + checks.render_report(findings))
    fixtures = {name: len(checks.run_fixture(name))
                for name in checks.FIXTURE_NAMES}
    if not all(fixtures.values()):
        raise AssertionError(f"[checks] a regression fixture went "
                             f"unflagged: {fixtures}")
    print("[checks] " + json.dumps({"findings": 0, "fixtures": fixtures,
                                    "probe_max_abs_err": errs,
                                    "card": smi}))
    for arch, shape in CHECKS_DRYRUN:
        rec = dryrun.run_cell(arch, shape, "single")
        if rec.get("status") != "OK":
            raise AssertionError(f"[checks] dry run {arch} {shape}: "
                                 f"{rec.get('status')}")
        print("[checks] dryrun " + json.dumps(rec))
    meta, card, counted, grown, launches = _count_on_card(registry)
    row = {"aten_flops": [meta.aten_flops, card.aten_flops],
           "kernel_flops": [meta.kernels.total_flops,
                            card.kernels.total_flops],
           "kernel_calls": [meta.kernels.calls, card.kernels.calls],
           "partial_launches": launches, "argument_bytes": counted,
           "allocated_growth": grown, "card": smi}
    layers = registry.get_config(CHECKS_SERVE[0]).num_layers
    if (meta.aten_flops != card.aten_flops
            or meta.kernels.flops != card.kernels.flops
            or meta.kernels.calls != card.kernels.calls
            or launches != layers
            or abs(grown - counted) > ARG_BYTES_TOL * counted):
        raise AssertionError(f"[checks] the count disagrees with the "
                             f"card: {row}")
    print("[checks] count " + json.dumps(row))
    print(f"[checks] phase {time.perf_counter() - t0:.1f} s")


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
    dist_row, dist_wkv = phase_dist(registry, fd, ref, smi)
    phase_train(registry, smi)
    phase_checks(registry, smi)
    for name, by_run in dist_wkv.items():
        launches.setdefault(name, {}).update(by_run)
    for row in rows:
        # the decode GEMM is on no serving path: every serve run above
        # asserted its counts stayed 0
        by_run = launches.get(row["name"], {})
        row["launches"] = sum(by_run.values())
        row["launches_by_run"] = by_run
    rows.append(dist_row)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
