"""The port's analytic model (``repro_torch.core``) against ``repro.core``.

Both packages evaluate the same public functions on the same inputs:
the paper's models on the SNAKE substrate, two fixed systolic-array
shapes and the MAC tree, at batch {1, 8, 64} and context {128, 4096}.
Results are compared exactly: dataclasses field by field (each side's
enums by value), floats with ``==``.  The checks of
``tests/test_paper_claims.py`` are also re-run against the port's copy.
"""
import dataclasses
import enum
import importlib.util
import pathlib
import types

import numpy as np
import pytest

from repro import core as J
from repro.core import (dataflow as jdf, energy as jen, gpu_model as jgpu,
                        hw as jhw, noc as jnoc, operators as jops,
                        pipeline as jpipe, placement as jpl,
                        schedule as jsch, serving_sim as jss)
from repro.models import registry as JR
from repro_torch import core as T
from repro_torch.core import (dataflow as tdf, energy as ten,
                              gpu_model as tgpu, hw as thw, noc as tnoc,
                              operators as tops, pipeline as tpipe,
                              placement as tpl, schedule as tsch,
                              serving_sim as tss)
from repro_torch.models import registry as TR

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {"ref": types.SimpleNamespace(
            core=J, df=jdf, en=jen, gpu=jgpu, hw=jhw, noc=jnoc, ops=jops,
            pipe=jpipe, pl=jpl, sch=jsch, ss=jss),
        "port": types.SimpleNamespace(
            core=T, df=tdf, en=ten, gpu=tgpu, hw=thw, noc=tnoc, ops=tops,
            pipe=tpipe, pl=tpl, sch=tsch, ss=tss)}
MODELS = sorted(J.PAPER_MODELS)
SYSTEMS = {"snake": lambda hw: hw.snake_system(),
           "sa48x48": lambda hw: hw.fixed_sa_system(48, 48),
           "sa8x288": lambda hw: hw.fixed_sa_system(8, 288),
           "mactree": lambda hw: hw.mactree_system()}
BATCHES = (1, 8, 64)
CTXS = (128, 4096)


def _norm(x):
    """A package-neutral rendering: dataclasses as (class name, fields),
    enums as (class name, value); floats stay floats, so ``==`` on two
    renderings compares every float exactly."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, _norm(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, dict):
        return ("dict", sorted(((_norm(k), _norm(v)) for k, v in x.items()),
                               key=repr))
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    if isinstance(x, range):
        return ("range", x.start, x.stop, x.step)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, tuple(x.ravel().tolist()))
    if isinstance(x, np.generic):
        return x.item()
    return x


def _same(fn):
    """Evaluate ``fn(pkg)`` on both packages and assert equal results."""
    want, got = fn(PKGS["ref"]), fn(PKGS["port"])
    assert _norm(got) == _norm(want)
    return got


def test_public_names_match_reference():
    assert T.__all__ == J.__all__
    for mod in ("df", "en", "gpu", "noc", "ops", "pipe", "pl", "sch",
                "ss"):
        ref, port = getattr(PKGS["ref"], mod), getattr(PKGS["port"], mod)
        assert {n for n in dir(port) if not n.startswith("_")} == \
            {n for n in dir(ref) if not n.startswith("_")}, mod
    # the TPU constants are copied as the reference's model inputs (the
    # planner prices collectives with TPU_V5E_ICI_BW)
    ref_hw = {n for n in dir(jhw) if not n.startswith("_")}
    port_hw = {n for n in dir(thw) if not n.startswith("_")}
    assert port_hw == ref_hw
    for name in ("TPU_V5E_PEAK_FLOPS", "TPU_V5E_HBM_BW", "TPU_V5E_ICI_BW",
                 "TPU_V5E_HBM_GB"):
        assert getattr(thw, name) == getattr(jhw, name)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_systems_and_area_match(system):
    _same(lambda p: SYSTEMS[system](p.hw))
    _same(lambda p: p.en.peak_power_breakdown(SYSTEMS[system](p.hw)))
    _same(lambda p: (SYSTEMS[system](p.hw).ridge_point,
                     SYSTEMS[system](p.hw).peak_flops))


def test_area_model_and_gpu_config_match():
    _same(lambda p: p.hw.area_model())
    _same(lambda p: p.hw.H100)
    _same(lambda p: p.pl.default_system())


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_decode_step_matches(model, system):
    for b in BATCHES:
        for ctx in CTXS:
            for tp in (1, 8):
                rep = _same(lambda p: p.pipe.decode_step(
                    SYSTEMS[system](p.hw), p.ops.PAPER_MODELS[model], b,
                    ctx, tp=tp))
                assert rep.time_s > 0
    _same(lambda p: p.pipe.decode_sweep(
        SYSTEMS[system](p.hw), p.ops.PAPER_MODELS[model], BATCHES, 4096,
        tp=8))
    if system == "snake":
        for mode in ("IS_S", "OS_ST"):
            _same(lambda p: p.pipe.decode_step(
                SYSTEMS[system](p.hw), p.ops.PAPER_MODELS[model], 8, 4096,
                fixed_mode=p.sch.Mode[mode], tp=8))


@pytest.mark.parametrize("model", MODELS)
def test_gpu_decode_step_matches(model):
    for b in BATCHES:
        for ctx in CTXS:
            for tp in (1, 8):
                _same(lambda p: p.gpu.gpu_decode_step(
                    p.ops.PAPER_MODELS[model], b, ctx, tp=tp))


@pytest.mark.parametrize("model", MODELS)
def test_operators_match(model):
    for b in BATCHES:
        for ctx in CTXS:
            _same(lambda p: p.ops.layer_ops(p.ops.PAPER_MODELS[model], b,
                                            ctx))
            _same(lambda p: p.ops.layer_ops_tp(p.ops.PAPER_MODELS[model],
                                               b, ctx, 8))
            _same(lambda p: p.ops.decode_ops(p.ops.PAPER_MODELS[model], b,
                                             ctx))
    _same(lambda p: p.ops.PAPER_MODELS[model])
    _same(lambda p: p.pl.kv_bytes_per_token(p.ops.PAPER_MODELS[model]))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_schedules_match(model, system):
    """The per-operator scheduling search on every operator class."""
    def layer(p, b, ctx):
        return p.ops.layer_ops_tp(p.ops.PAPER_MODELS[model], b, ctx, 8)

    for b in BATCHES:
        for ctx in CTXS:
            def sched(p):
                sys_, lo = SYSTEMS[system](p.hw), layer(p, b, ctx)
                out = [p.sch.schedule_projection(sys_, g)
                       for g in lo.projections]
                out += [p.sch.mode_candidates(sys_, g, True)
                        for g in lo.projections]
                out.append(p.sch.schedule_chain(sys_, lo.projections))
                qk, av = lo.attention
                out.append(p.sch.schedule_attention(sys_, qk, av))
                if lo.experts:
                    out.append(p.sch.schedule_experts(
                        sys_, lo.experts, lo.moe_dispatch_bytes))
                    out.append(p.sch.schedule_experts(
                        sys_, lo.experts, lo.moe_dispatch_bytes,
                        force_df=p.core.Dataflow.IS))
                execs = [e for e in out if isinstance(e, p.sch.OpExec)]
                out.append(p.sch.exec_config(execs))
                out.append(p.sch.shape_profile(execs))
                out.append(p.sch.slice_pack(sys_, b))
                out.append((p.sch.exec_units(sys_), p.sch.unit_bw(sys_)))
                return out

            _same(sched)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_core_gemm_models_match(system):
    """sa_gemm / sa_gemm_best / sa_gemm_auto / mactree_gemm /
    best_logical_shape / core_exec on the projections of one model."""
    def gemms(p):
        return p.ops.layer_ops_tp(p.ops.PAPER_MODELS["LLaMA3-70B"], 8,
                                  4096, 8).projections

    def run(p):
        sys_, out = SYSTEMS[system](p.hw), []
        sub = sys_.substrate
        systolic = isinstance(sub, p.hw.SystolicArrayConfig)
        for g in gemms(p):
            for df in p.core.Dataflow:
                out.append(p.sch.core_exec(sys_, g, df))
                if systolic:
                    out.append(p.df.sa_gemm_best(g, sub, df))
                    out.append(p.df.sa_gemm(g, sub.phys_rows,
                                            sub.phys_cols, df, sub.buffers))
            if systolic:
                out.append(p.df.sa_gemm_auto(g, sub))
                for m in (1, 8, 64, 256):
                    out.append(p.df.best_logical_shape(sub, m))
            else:
                out.append(p.df.mactree_gemm(g, sub))
        out.append(p.df.mean_utilization([e for e in out
                                          if isinstance(e,
                                                        p.df.CoreExec)]))
        return out

    _same(run)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_noc_and_energy_match(system):
    def run(p):
        sys_ = SYSTEMS[system](p.hw)
        out = []
        for nbytes in (0, 4096, 1 << 20):
            out += [p.noc.all_reduce(sys_, nbytes),
                    p.noc.reduce_scatter(sys_, nbytes),
                    p.noc.all_gather(sys_, nbytes),
                    p.noc.all_to_all(sys_, nbytes)]
            for hops in (0, 1, 3):
                out.append(p.noc.page_gather(sys_, nbytes, nbytes // 2,
                                             hops))
                out.append(p.noc.page_ship(sys_, nbytes, 4, hops=hops))
        out.append(p.en.gemm_energy(sys_, 1 << 20, 1 << 16, 1 << 18,
                                    1e-5, noc_bytes=4096,
                                    vector_ops=1000))
        return out

    _same(run)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_placement_map_and_gather_cost_match(system):
    def run(p):
        sys_, out = SYSTEMS[system](p.hw), []
        for n_pages in (8, 64, 1000):
            for frac in (0.0, 0.25):
                for regions in (None, 3):
                    pm = p.pl.PlacementMap.from_system(
                        sys_, n_pages, communal_frac=frac,
                        n_regions=regions)
                    out.append(pm)
                    out.append([pm.region_pages(r) for r in pm.regions()])
                    out.append([pm.region_of(q) for q in range(n_pages)])
        for counts in ({}, {1: 8}, {1: 6, 2: 2}, {0: 2, 1: 2, 2: 2, 3: 2},
                       {p.pl.COMMUNAL: 3, 2: 1}):
            out.append(p.pl.gather_cost(sys_, counts, 4096))
            out.append(p.pl.gather_cost(sys_, counts, 4096, home=0))
        out.append((p.pl.COMMUNAL, p.pl.PLACEMENT_POLICIES))
        return out

    _same(run)


def test_tick_model_sequence_matches():
    """A sequence of nmp_tick_model steps with reconfigurations: every
    decision, the reconfiguration count and the configurations seen."""
    seq = ((1, 0), (32, 0), (1, 256), (64, 0), (32, 0), (8, 128), (1, 0))

    def run(p, system, spec, cost):
        tm = p.ss.nmp_tick_model(SYSTEMS[system](p.hw),
                                 p.ops.PAPER_MODELS[spec], tp=8,
                                 reconfig_cost_s=cost)
        out = [tm.reconfig_cost_s]
        for stream in ("a", "b"):
            for batch, pf in seq:
                out.append(tm.step(batch, [2048 + 7 * i for i in
                                           range(batch)],
                                   prefill_tokens=pf, prefill_ctx=2048,
                                   stream=stream))
        out += [tm.reconfigurations, sorted(map(repr, tm.configs_seen)),
                tm(8, 4096)]
        return out

    for system in ("snake", "sa48x48", "mactree"):
        for spec in ("Qwen3-30B-A3B", "LLaMA3-70B"):
            for cost in (None, 1e-3):
                got = _same(lambda p: run(p, system, spec, cost))
                if system == "snake" and spec == "Qwen3-30B-A3B":
                    assert got[-3] > 0      # reconfigurations


@pytest.mark.parametrize("kw", [
    dict(),
    dict(cache_mode="paged", page_size=64, num_pages=1600),
    dict(cache_mode="paged", prefill_chunk=256, prefill_on_device=True),
    dict(cache_mode="paged", prefix_sharing=True, shared_prefix_len=1024,
         page_size=64, num_pages=1600, placement="affinity", n_regions=8),
    dict(cache_mode="paged", page_size=64, placement="interleave",
         fuse_steps=8),
], ids=["dense", "paged", "chunked", "shared_affinity", "fused"])
def test_simulate_serving_matches(kw):
    def run(p, latency):
        spec = p.ops.PAPER_MODELS["LLaMA3-70B"]
        lat = {"nmp": lambda: p.ss.nmp_latency_model(
                   p.hw.snake_system(), spec, tp=8),
               "gpu": lambda: p.ss.gpu_latency_model(spec, tp=8),
               "tick": lambda: p.ss.nmp_tick_model(
                   p.hw.snake_system(), spec, tp=8)}[latency]()
        over = dict(kw)
        if over.get("placement"):
            over["hw"] = p.hw.snake_system()
        return p.ss.simulate_serving(lat, spec, 2.0, system="SNAKE",
                                     n_requests=12, input_len=1024,
                                     output_len=64, max_batch=8, seed=3,
                                     **over)

    for latency in ("nmp", "gpu", "tick"):
        rep = _same(lambda p: run(p, latency))
        assert rep.completed == 12


def test_simulate_cluster_on_a_trace_matches():
    def run(p, policy, tiers):
        spec = p.ops.PAPER_MODELS["Qwen3-30B-A3B"]
        trace = p.ss.make_cluster_trace(4.0, 16, 512, 32, n_groups=3,
                                        skew=1.0, seed=5)
        lat = p.ss.nmp_latency_model(p.hw.snake_system(), spec, tp=8)
        return trace, p.ss.simulate_cluster(
            lat, spec, 4.0, policy=policy,
            n_replicas=2 if tiers is None else sum(tiers), trace=trace,
            prefix_sharing=True, shared_prefix_len=256, tiers=tiers,
            page_size=16)

    for policy in jss.CLUSTER_POLICIES:
        _same(lambda p: run(p, policy, None))
    _same(lambda p: run(p, "least_loaded", (1, 2)))


def _resolved_ids():
    ids = []
    for arch in TR.ARCH_IDS + TR.EXTRA_ARCH_IDS:
        try:
            TR.get_config(arch)
        except NotImplementedError:
            continue
        ids.append(arch)
    return ids


@pytest.mark.parametrize("arch", _resolved_ids())
def test_nmp_spec_matches(arch):
    want = JR.get_config(arch).nmp_spec()
    got = TR.get_config(arch).nmp_spec()
    assert _norm(got) == _norm(want)
    assert _norm(TR.get(arch, reduced=True).config.nmp_spec()) == \
        _norm(JR.get(arch, reduced=True).config.nmp_spec())


# ---------------------------------------------------------------------------
# The paper-claims checks, re-run on the port's copy
# ---------------------------------------------------------------------------
def _claims_on_port():
    """``tests/test_paper_claims.py`` with every ``repro.core`` import
    pointed at ``repro_torch.core``, loaded as a module of its own."""
    path = ROOT / "tests" / "test_paper_claims.py"
    src = path.read_text().replace("repro.core", "repro_torch.core")
    assert "repro_torch.core" in src and "repro." not in \
        src.replace("repro_torch.core", "")
    name = "_paper_claims_on_port"
    spec = importlib.util.spec_from_loader(name, loader=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


_CLAIMS = _claims_on_port()
ratios = _CLAIMS.ratios
for _name in dir(_CLAIMS):
    if _name.startswith("test_"):
        globals()["test_port_claim_" + _name[len("test_"):]] = \
            getattr(_CLAIMS, _name)
