"""Serving engines of the PyTorch port against ``repro.serving.engine``.

Both packages' engines serve the same trace (``make_trace``, or the
trace maker a case names) on the reference's own reduced yi-6b or
rwkv6-7b weights (bridged), in float32; ``NEW_ARCH_CASES`` run cases of
``CASES`` on reduced qwen3-30b-a3b (MoE), qwen2-vl-7b (M-RoPE, QKV bias)
and stablelm-3b (MHA, layernorm).  Arrivals
are all at t~0 (rate 1e9), so admission depends only on capacity and
both sides schedule identically: token streams, finish reasons,
preemptions and defrag runs must be equal.

Near ties: greedy decode from random weights can meet a step whose top-2
logit gap is within float rounding of a tie.  Where the streams first
differ, the reference's gap at that step must be below 10x the logit
tolerance and the two logit rows must agree within it; the rest of that
stream is conditioned on a different token and is not compared.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import registry as JR  # noqa: E402
from repro.models import rwkv6 as JW  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import tracer as jtracer  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import replica_api as japi  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import tracer as ttracer  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import replica_api as tapi  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

LOGIT_TOL = 1e-5   # float32 both sides, sums in another order: ~6e-7 seen
SKEWED = np.array([9, 17, 5, 30, 12, 24])

# name -> (EngineConfig overrides, trace kwargs); a ``maker`` entry in
# the trace kwargs names the scheduler's trace maker (default make_trace)
SHARED = dict(paged=True, page_size=8, prefix_sharing=True)
CASES = {
    "dense": (dict(), dict(prompt_lens=SKEWED, seed=3)),
    "paged": (dict(paged=True, page_size=8),
              dict(prompt_lens=SKEWED, seed=3)),
    "paged_chunked": (dict(paged=True, page_size=8, prefill_chunk=8),
                      dict(prompt_lens=SKEWED, seed=3)),
    # two 28-token prompts reserve 4 of the 8 pages each; decode past 32
    # tokens must evict the younger one
    "oversubscribed": (dict(paged=True, page_size=8, num_pages=8),
                       dict(prompt_lens=np.array([28, 28, 9, 9, 9]),
                            seed=7)),
    "eos": (dict(paged=True, page_size=8, prefill_chunk=8),
            dict(prompt_lens=SKEWED, seed=5, eos_rate=0.3)),
    # up to 8 decode steps a tick on the device (fused_tick events)
    "fused": (dict(paged=True, page_size=8, fuse_steps=8),
              dict(prompt_lens=SKEWED, seed=3)),
    # prefix sharing: identical 20-token prompts prefilled whole, so the
    # ragged tail page is shared and forked (cow_fork events)
    "shared": (SHARED, dict(maker="make_shared_prefix_trace", n_requests=4,
                            prefix_len=20, tail_len=0, seed=3)),
    # 16 shared + 5 unique tokens in chunks of 8: the compute skip
    "shared_chunked": (dict(SHARED, prefill_chunk=8),
                       dict(maker="make_shared_prefix_trace", n_requests=5,
                            prefix_len=16, tail_len=5, seed=3)),
    # identical 19-token prompts in chunks of 4 under the fused tick:
    # exact-tail recompute, horizon-boundary forks; the budget keeps
    # request 0 resident while the others are admitted
    "shared_fused": (dict(SHARED, prefill_chunk=4, fuse_steps=8,
                          max_new_tokens=16),
                     dict(maker="make_shared_prefix_trace", n_requests=4,
                          prefix_len=19, tail_len=0, seed=3)),
    # stack-aware placement, 2 regions of 6 pages: decode growth spills
    # out of a full home region, preemption relaxes the pool, and the
    # defrag that follows copies the spilled page home (migrate event)
    "placed_affinity": (dict(paged=True, page_size=8, num_pages=12,
                             placement="affinity", placement_regions=2,
                             max_new_tokens=12),
                        dict(prompt_lens=SKEWED, seed=7)),
    "placed_interleave": (dict(paged=True, page_size=8,
                               placement="interleave",
                               placement_regions=4),
                          dict(prompt_lens=SKEWED, seed=3)),
    # shared prompt pages go to the communal region
    "placed_shared_fused": (dict(SHARED, prefill_chunk=4, fuse_steps=8,
                                 max_new_tokens=16, placement="affinity",
                                 placement_regions=4),
                            dict(maker="make_shared_prefix_trace",
                                 n_requests=4, prefix_len=19, tail_len=0,
                                 seed=3)),
    # live co-design pricing per tick (reconfigure events) ...
    "codesign_chunked": (dict(paged=True, page_size=8, prefill_chunk=8,
                              codesign=True),
                         dict(prompt_lens=SKEWED, seed=3)),
    # ... and per fused step, the prefill chunk riding step 0
    "codesign_fused": (dict(paged=True, page_size=8, prefill_chunk=8,
                            fuse_steps=8, codesign=True,
                            placement="affinity", placement_regions=4),
                       dict(prompt_lens=SKEWED, seed=3)),
}
# the port's kernel path (plain on the CPU) against the reference's
# plain path of the same layout
KERNEL_CASES = {"dense_kernel": "dense", "paged_kernel": "paged",
                "shared_kernel": "shared",
                "shared_chunked_kernel": "shared_chunked",
                "shared_fused_kernel": "shared_fused",
                "placed_affinity_kernel": "placed_affinity",
                "codesign_fused_kernel": "codesign_fused"}
# rwkv6 (ssm family): the state is slot-dense and prompts prefill whole
# on both sides, with or without prefill_chunk; use_pallas_decode selects
# the port's WKV6 kernel (plain on the CPU) and is a no-op in the
# reference, which has no kernel to take
RWKV_CASES = {
    "dense": (dict(), dict(prompt_lens=SKEWED, seed=3)),
    "dense_chunked": (dict(prefill_chunk=8),
                      dict(prompt_lens=SKEWED, seed=3)),
    "paged": (dict(paged=True, page_size=8),
              dict(prompt_lens=SKEWED, seed=3)),
    "paged_chunked": (dict(paged=True, page_size=8, prefill_chunk=8),
                      dict(prompt_lens=SKEWED, seed=3)),
    "eos": (dict(paged=True, page_size=8), dict(prompt_lens=SKEWED, seed=5,
                                                eos_rate=0.3)),
}
RWKV_KERNEL = {"dense_kernel": "dense",
               "paged_chunked_kernel": "paged_chunked"}
# recurrentgemma (hybrid: no sequence leaf, a rolling window of 64 at the
# reduced width) and whisper (audio: paged self K/V, slot-dense cross
# K/V): whole-prompt prefill, per-tick decode and no kernel on both
# sides; use_pallas_decode changes nothing
HYBRID_CASES = {
    "dense": (dict(), dict(prompt_lens=SKEWED, seed=3)),
    "paged": (dict(paged=True, page_size=8),
              dict(prompt_lens=SKEWED, seed=3)),
    # a 70-token prompt: prefill keeps its last 64 positions, and every
    # decode step rolls the window
    "window": (dict(paged=True, page_size=8, max_seq=80),
               dict(prompt_lens=np.array([70, 9, 30]), seed=3)),
}
AUDIO_CASES = {
    "dense": (dict(), dict(prompt_lens=SKEWED, seed=3)),
    "paged": (dict(paged=True, page_size=8),
              dict(prompt_lens=SKEWED, seed=3)),
    "shared": CASES["shared"],
}
ARCH_CASES = {"rwkv6-7b": RWKV_CASES, "recurrentgemma-9b": HYBRID_CASES,
              "whisper-small": AUDIO_CASES}


@pytest.fixture(scope="module")
def weights():
    cfg = JR.get("yi-6b", reduced=True).config
    tree = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), cfg))
    return params_from_numpy(tree, TR.get("yi-6b", reduced=True).config,
                             device="cpu")


@pytest.fixture(scope="module")
def rwkv_weights():
    cfg = JR.get("rwkv6-7b", reduced=True).config
    tree = jax.tree.map(np.asarray, JW.init(jax.random.PRNGKey(0), cfg))
    return params_from_numpy(tree, TR.get("rwkv6-7b", reduced=True).config,
                             device="cpu")


def _ecfg(over):
    return dict(dict(max_batch=3, max_seq=48, max_new_tokens=6), **over)


def _trace(sched, trace_kw):
    """The case's trace from the scheduler module ``sched`` of either
    package, all arrivals at t~0."""
    kw = dict(trace_kw)
    maker = kw.pop("maker", "make_trace")
    if maker == "make_trace":
        kw.update(n_requests=len(kw["prompt_lens"]), prompt_len=0)
    return getattr(sched, maker)(512, rate_req_s=1e9, **kw)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _record_logits(eng) -> dict:
    """(rid, token index) -> the logits row each emitted token came
    from, for the engines of both packages (they share hook names)."""
    rec, last = {}, {}

    def wrap_prefill(fn):
        def run(*a):
            out = fn(*a)
            last["logits"] = out[0]
            return out
        return run

    eng._prefill = wrap_prefill(eng._prefill)
    if eng._extend is not None:       # None: the family cannot chunk
        eng._extend = wrap_prefill(eng._extend)
    activate, decode = eng._activate, eng._decode_batch

    def on_activate(slot, req):
        rec[(req.rid, 0)] = _host(last["logits"])[0]
        return activate(slot, req)

    def on_decode(toks):
        logits = decode(toks)
        rows = _host(logits)
        for slot, req in eng.active.items():
            rec[(req.rid, len(req.tokens_out))] = rows[slot]
        return logits

    eng._activate, eng._decode_batch = on_activate, on_decode
    return rec


@functools.lru_cache(maxsize=None)
def _reference(name, arch="yi-6b"):
    over, trace_kw = ARCH_CASES.get(arch, CASES)[name]
    eng = JE.make_engine(JR.get(arch, reduced=True),
                         JE.EngineConfig(**_ecfg(over)))
    eng.set_tracer(jtracer.Tracer())
    rec = _record_logits(eng)
    metrics = eng.run_trace(_trace(jsched, trace_kw))
    return eng, rec, metrics


def _port(over, trace_kw, params, arch="yi-6b"):
    eng = TE.make_engine(TR.get(arch, reduced=True),
                         TE.EngineConfig(device="cpu", **_ecfg(over)),
                         params=params)
    eng.set_tracer(ttracer.Tracer())
    rec = _record_logits(eng)
    metrics = eng.run_trace(_trace(tsched, trace_kw))
    return eng, rec, metrics


def _assert_streams(ref, port):
    (jeng, jrec, _), (teng, trec, _) = ref, port
    jby = {r.rid: r for r in jeng.completed}
    tby = {r.rid: r for r in teng.completed}
    assert jby.keys() == tby.keys()
    for rid, jr in jby.items():
        tr = tby[rid]
        assert tr.finish_reason == jr.finish_reason
        assert len(tr.tokens_out) == len(jr.tokens_out)
        for i, (a, b) in enumerate(zip(jr.tokens_out, tr.tokens_out)):
            if a == b:
                continue
            jrow, trow = jrec[(rid, i)][:512], trec[(rid, i)][:512]
            top2 = np.sort(jrow)[-2:]
            assert top2[1] - top2[0] < 10 * LOGIT_TOL, (
                f"request {rid} token {i}: {b} != {a} without a near tie")
            np.testing.assert_allclose(trow, jrow, rtol=0, atol=LOGIT_TOL)
            break


@pytest.mark.parametrize("name", sorted(CASES) + sorted(KERNEL_CASES))
def test_engine_matches_reference(name, weights):
    ref_name = KERNEL_CASES.get(name, name)
    over, trace_kw = CASES[ref_name]
    if name in KERNEL_CASES:
        over = dict(over, use_pallas_decode=True)
    ref = _reference(ref_name)
    fd.reset_launches()
    port = _port(over, trace_kw, weights)
    _assert_streams(ref, port)
    jm, tm = ref[2], port[2]
    for key in ("requests", "decoded_tokens", "preemptions", "finish_eos",
                "finish_budget", "defrag_runs", "kv_peak_tokens",
                "kv_logical_peak_pages", "kv_mode", "kv_shared_pages",
                "kv_dedup_ratio_peak", "cow_forks",
                "prefill_skipped_tokens") + MODELED_METRICS:
        assert tm[key] == jm[key], key
    if ref_name.startswith("shared"):
        assert tm["kv_dedup_ratio_peak"] > 1.0
        assert (tm["cow_forks"] > 0) == (ref_name != "shared_chunked")
        assert (tm["prefill_skipped_tokens"] > 0) == (
            ref_name != "shared")
    if ref_name == "oversubscribed":
        assert tm["preemptions"] > 0
    if ref_name == "eos":
        assert tm["finish_eos"] > 0
    if ref_name == "paged":
        assert tm["defrag_runs"] > 0
    if ref_name.endswith("fused"):
        assert tm["fused_ticks"] == jm["fused_ticks"] > 0
    # on the CPU the kernel path runs the plain versions: no launches
    assert fd.LAUNCHES == {"flash_decode": 0, "paged_flash_decode": 0,
                           "flash_decode_partial": 0}


def test_metric_keys_match_reference_contract(weights):
    _, _, metrics = _port(*CASES["paged"], weights)
    assert set(metrics) == set(jmetrics.SCHEDULER_METRIC_CONTRACT)
    assert tmetrics.SCHEDULER_METRIC_CONTRACT == \
        jmetrics.SCHEDULER_METRIC_CONTRACT
    assert tmetrics.ROUTER_METRIC_CONTRACT == \
        jmetrics.ROUTER_METRIC_CONTRACT


def test_copied_contracts_match_reference():
    assert ttracer.EVENT_KINDS == jtracer.EVENT_KINDS
    assert (tapi.LoadReport.__dataclass_fields__.keys()
            == japi.LoadReport.__dataclass_fields__.keys())


@pytest.mark.parametrize("maker,kw", [
    ("make_trace", dict(n_requests=5, prompt_len=7, eos_rate=0.4,
                        sessions=np.arange(5))),
    ("make_shared_prefix_trace", dict(n_requests=4, prefix_len=6,
                                      tail_len=3)),
    ("make_grouped_prefix_trace", dict(n_requests=6, n_groups=3,
                                       prefix_len=5, tail_len=2)),
])
def test_same_seed_same_trace(maker, kw):
    a = getattr(jsched, maker)(512, rate_req_s=3.0, seed=11, **kw)
    b = getattr(tsched, maker)(512, rate_req_s=3.0, seed=11, **kw)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.rid, x.arrival_s, x.decode_len, x.session) == \
            (y.rid, y.arrival_s, y.decode_len, y.session)
        np.testing.assert_array_equal(x.prompt, y.prompt)


def test_trace_file_roundtrip(tmp_path):
    reqs = tsched.make_trace(512, rate_req_s=2.0, n_requests=3,
                             prompt_len=4, seed=1)
    path = str(tmp_path / "t.json")
    tsched.save_trace(reqs, path)
    back = jsched.load_trace(path)
    assert [list(r.prompt) for r in back] == [list(r.prompt) for r in reqs]


def test_load_report_and_tracer(weights):
    eng = TE.make_engine(TR.get("yi-6b", reduced=True),
                         TE.EngineConfig(device="cpu", paged=True,
                                         page_size=8, **_ecfg({})),
                         params=weights)
    tracer = ttracer.Tracer()
    eng.set_tracer(tracer)
    rep = eng.load_report()
    assert rep.free_slots == 3 and rep.free_pages == eng.paged.num_pages
    eng.run_trace(_trace(tsched, CASES["paged"][1]))
    kinds = {e.kind for e in tracer.events}
    assert {"arrival", "admit", "prefill_chunk", "decode_step", "finish",
            "gauge"} <= kinds
    assert eng.load_report().queue_depth == 0


@pytest.mark.parametrize("name", sorted(RWKV_CASES) + sorted(RWKV_KERNEL))
def test_rwkv_engine_matches_reference(name, rwkv_weights):
    ref_name = RWKV_KERNEL.get(name, name)
    over, trace_kw = RWKV_CASES[ref_name]
    if name in RWKV_KERNEL:
        over = dict(over, use_pallas_decode=True)
    ref = _reference(ref_name, "rwkv6-7b")
    wk.reset_launches()
    fd.reset_launches()
    port = _port(over, trace_kw, rwkv_weights, "rwkv6-7b")
    _assert_streams(ref, port)
    jm, tm = ref[2], port[2]
    assert set(tm) == set(jmetrics.SCHEDULER_METRIC_CONTRACT)
    for key in ("requests", "decoded_tokens", "preemptions", "finish_eos",
                "finish_budget", "defrag_runs", "kv_peak_tokens",
                "kv_logical_peak_pages", "kv_mode"):
        assert tm[key] == jm[key], key
    if over.get("paged"):
        assert tm["kv_peak_tokens"] == 0 and tm["kv_mode"] == "paged"
    if ref_name == "eos":
        assert tm["finish_eos"] > 0
    # whole-prompt prefill: one recorded prefill logits row per request
    # and no chunk state left behind
    assert port[0]._prefilling is None and not port[0]._chunkable()
    assert wk.LAUNCHES == {"wkv6": 0, "wkv6_chunked": 0}
    assert fd.LAUNCHES == {"flash_decode": 0, "paged_flash_decode": 0,
                           "flash_decode_partial": 0}


def test_rwkv_engine_routes_the_wkv6_kernel(rwkv_weights, monkeypatch):
    """use_pallas_decode hands kernels.ops.wkv6_scan to prefill (one call
    per layer over the whole prompt) and to every decode step (one call
    per layer over T = 1); without it the model runs its plain default."""
    from repro_torch.kernels import ops
    plain, calls = ops.wkv6_scan, []

    def counting(*args):
        calls.append(args[0].shape[1])
        return plain(*args)

    monkeypatch.setattr(ops, "wkv6_scan", counting)
    for kernel in (False, True):
        calls.clear()
        eng = TE.make_engine(
            TR.get("rwkv6-7b", reduced=True),
            TE.EngineConfig(device="cpu", paged=True, page_size=8,
                            prefill_chunk=4, use_pallas_decode=kernel,
                            **_ecfg({})), params=rwkv_weights)
        steps = []
        decode = eng._decode_batch
        eng._decode_batch = lambda toks: steps.append(1) or decode(toks)
        eng.run_trace(_trace(tsched,
                             dict(prompt_lens=np.array([5, 7]), seed=1)))
        n = eng.cfg.num_layers
        if kernel:
            assert sorted(c for c in calls if c > 1) == [5] * n + [7] * n
            assert calls.count(1) == n * len(steps) > 0
        else:
            assert calls == []


def test_rwkv_paged_engine_reports_slots_not_pages(rwkv_weights):
    """A recurrent state holds no pages: load_report counts slots as the
    reference's does, chunked admission keeps the dense buffer path, and
    no grow or defrag event is traced."""
    eng = TE.make_engine(TR.get("rwkv6-7b", reduced=True),
                         TE.EngineConfig(device="cpu", paged=True,
                                         page_size=8, **_ecfg({})),
                         params=rwkv_weights)
    tracer = ttracer.Tracer()
    eng.set_tracer(tracer)
    rep = eng.load_report()
    assert rep.free_pages == rep.min_region_free == rep.free_slots == 3
    req = _trace(tsched, dict(prompt_lens=np.array([6]),
                                         seed=2))[0]
    assert eng._start_chunked(req)
    assert "buf" in eng._prefilling and eng.paged.pages_in_use() == 0
    assert eng.load_report().free_pages == 2
    eng._release(eng._prefilling.pop("slot"))
    eng._prefilling = None
    eng.run_trace(_trace(tsched, RWKV_CASES["paged"][1]))
    kinds = {e.kind for e in tracer.events}
    assert "decode_step" in kinds and not kinds & {"grow", "defrag"}


# Scheduler.metrics that are host arithmetic over the schedule (placement
# and co-design pricing): equal to the reference's as Python floats
MODELED_METRICS = ("kv_migrated_pages", "kv_migration_cost_s",
                   "placement_policy", "kv_gather_cost_mean_s",
                   "kv_gather_concentration", "kv_region_peak",
                   "codesign_substrate", "modeled_time_s",
                   "modeled_tokens_per_s", "reconfigurations",
                   "substrate_configs", "array_util_mean")
# the traced args that hold modeled seconds; every other ``*_s`` arg is
# a wall time
MODELED_ARGS = ("cost_s", "modeled_reconfig_s", "modeled_tokens_per_s")
PRICED_CASES = sorted(n for n in CASES if n.startswith(("placed",
                                                        "codesign")))


def _events(tracer):
    """Each traced event as (kind, slot, rid, args), with the args that
    hold a time (``*_s``: wall or modeled seconds) left out."""
    return [(e.kind, e.slot, e.rid,
             {k: v for k, v in e.args.items() if not k.endswith("_s")})
            for e in tracer.events]


@pytest.mark.parametrize("arch,name",
                         [("yi-6b", n) for n in sorted(CASES)]
                         + [("rwkv6-7b", n) for n in sorted(RWKV_CASES)])
def test_traced_events_match_reference(arch, name, weights, rwkv_weights):
    """Both packages trace the same events in the same order: kinds,
    slots, request ids and every untimed arg (the per-tick gauges of a
    family without pages included)."""
    over, trace_kw = (RWKV_CASES if arch == "rwkv6-7b" else CASES)[name]
    params = rwkv_weights if arch == "rwkv6-7b" else weights
    want = _events(_reference(name, arch)[0].tracer)
    got = _events(_port(over, trace_kw, params, arch)[0].tracer)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"event {i}: port {g} != reference {w}"


# cases of CASES on the MoE, VLM and MHA/layernorm configs: streams,
# finish reasons, scheduler counts and traced events against the
# reference's, on the plain path and on the kernel path (plain on the CPU)
NEW_ARCH_CASES = [("qwen3-30b-a3b", "paged_chunked"),
                  ("qwen3-30b-a3b", "fused"),
                  ("qwen3-30b-a3b", "shared"),
                  ("qwen3-30b-a3b", "shared_fused"),
                  ("qwen2-vl-7b", "paged"),
                  ("stablelm-3b", "paged"),
                  ("stablelm-3b", "dense")]


@functools.lru_cache(maxsize=None)
def _arch_weights(arch):
    entry = JR.get(arch, reduced=True)
    tree = jax.tree.map(np.asarray, entry.module.init(jax.random.PRNGKey(0),
                                                      entry.config))
    return params_from_numpy(tree, TR.get(arch, reduced=True).config,
                             device="cpu")


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("arch,name", NEW_ARCH_CASES)
def test_new_arch_engine_matches_reference(arch, name, kernel):
    over, trace_kw = CASES[name]
    if kernel:
        over = dict(over, use_pallas_decode=True)
    ref = _reference(name, arch)
    fd.reset_launches()
    port = _port(over, trace_kw, _arch_weights(arch), arch)
    _assert_streams(ref, port)
    jm, tm = ref[2], port[2]
    for key in ("requests", "decoded_tokens", "preemptions", "finish_eos",
                "finish_budget", "defrag_runs", "kv_peak_tokens",
                "kv_logical_peak_pages", "kv_mode", "kv_dedup_ratio_peak",
                "cow_forks", "prefill_skipped_tokens", "fused_ticks"):
        assert tm.get(key) == jm.get(key), key
    if name.endswith("fused"):
        assert tm["fused_ticks"] > 0
    if name.startswith("shared"):
        assert tm["cow_forks"] > 0 and tm["kv_dedup_ratio_peak"] > 1.0
    want = _events(ref[0].tracer)
    got = _events(port[0].tracer)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"event {i}: port {g} != reference {w}"
    assert fd.LAUNCHES == {"flash_decode": 0, "paged_flash_decode": 0,
                           "flash_decode_partial": 0}


@pytest.mark.parametrize("name", PRICED_CASES)
def test_modeled_seconds_match_reference(name, weights):
    """The placed and priced cases' modeled numbers equal the
    reference's as floats: the kv_report and codesign_report values and
    the modeled seconds each traced event carries (``_events`` leaves
    them out with the wall times)."""
    over, trace_kw = CASES[name]
    ref = _reference(name)
    port = _port(over, trace_kw, weights)
    jeng, teng = ref[0], port[0]
    jkv, tkv = jeng.kv_report(), teng.kv_report()
    assert tkv == jkv
    assert tkv["shipped_pages"] == 0 and tkv["ship_cost_s"] == 0.0
    assert teng.codesign_report() == jeng.codesign_report()
    want = [{k: e.args[k] for k in MODELED_ARGS if k in e.args}
            for e in jeng.tracer.events]
    got = [{k: e.args[k] for k in MODELED_ARGS if k in e.args}
           for e in teng.tracer.events]
    assert got == want
    kinds = {e.kind for e in jeng.tracer.events}
    if name == "placed_affinity":
        assert jkv["migrated_pages"] > 0 and "migrate" in kinds
        assert any("cost_s" in e.args for e in jeng.tracer.events
                   if e.kind == "defrag")
    if name == "codesign_chunked":
        assert jeng.codesign_report()["reconfigurations"] > 0
        assert "reconfigure" in kinds
    if over.get("placement"):
        assert tkv["gather_cost_mean_s"] > 0.0
    assert teng.load_report().to_dict() == jeng.load_report().to_dict()


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("arch,name",
                         [("recurrentgemma-9b", n) for n in HYBRID_CASES]
                         + [("whisper-small", n) for n in AUDIO_CASES])
def test_hybrid_and_audio_engines_match_reference(arch, name, kernel):
    """Streams, finish reasons, scheduler counts and traced events against
    the reference's.  recurrentgemma holds no pages in the paged engine
    (kv_peak_tokens 0); whisper pages its self K/V (with prefix sharing
    mapping and forking its prompt pages) and keeps the cross K/V per
    slot.  With use_pallas_decode no kernel is handed to either family:
    nothing launches and the steps take no kernel hook."""
    over, trace_kw = ARCH_CASES[arch][name]
    if kernel:
        over = dict(over, use_pallas_decode=True)
    ref = _reference(name, arch)
    fd.reset_launches()
    wk.reset_launches()
    port = _port(over, trace_kw, _arch_weights(arch), arch)
    _assert_streams(ref, port)
    jm, tm = ref[2], port[2]
    assert set(tm) == set(jmetrics.SCHEDULER_METRIC_CONTRACT)
    for key in ("requests", "decoded_tokens", "preemptions", "finish_eos",
                "finish_budget", "defrag_runs", "kv_peak_tokens",
                "kv_logical_peak_pages", "kv_mode", "kv_dedup_ratio_peak",
                "cow_forks", "prefill_skipped_tokens"):
        assert tm[key] == jm[key], key
    teng = port[0]
    assert not teng._chunkable() and teng._prefilling is None
    if over.get("paged"):
        assert teng.paged.has_seq == (arch == "whisper-small")
        if arch == "recurrentgemma-9b":
            assert tm["kv_peak_tokens"] == 0 and tm["kv_mode"] == "paged"
        else:
            assert tm["kv_peak_tokens"] > 0
            # self K/V paged, cross K/V and lengths slot-dense
            assert teng.paged.is_seq == [True, True, False, False, False]
    if name == "shared":
        assert tm["cow_forks"] > 0 and tm["kv_dedup_ratio_peak"] > 1.0
    want = _events(ref[0].tracer)
    got = _events(teng.tracer)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"event {i}: port {g} != reference {w}"
    assert fd.LAUNCHES == {"flash_decode": 0, "paged_flash_decode": 0,
                           "flash_decode_partial": 0}
    assert wk.LAUNCHES == {"wkv6": 0, "wkv6_chunked": 0}
