"""The port's sharding rules, planner and cell specs against the
reference's (``repro.distributed``, ``repro.models.registry`` /
``config``), with no process group.

The reference's rules take a stub mesh carrying only ``shape`` and
``axis_names`` and ``jax.eval_shape`` parameters; the port's take a mesh
description and meta tensors.  Every spec table must agree leaf for
leaf (by path), for every arch id, full and reduced, on the meshes
(1, 1), (2, 4), (16, 16) and (2, 16, 16).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed import planner as JP  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import config as JC  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.distributed import planner as TP  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import config as TC  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

ARCHS = TR.ARCH_IDS + TR.EXTRA_ARCH_IDS
MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
# a reduced cell beside the reference's decode_32k (and its other cells)
SMALL = JC.ShapeCell("small", 64, 4, "decode")


class _StubMesh:
    """What the reference's rules read of a JAX mesh."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def _ref_table(spec_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {JS._path_names(p): tuple(s) for p, s in flat}


def _port_table(spec_tree):
    return dict(TS.tree_leaves_with_path(spec_tree))


def _entries(arch, reduced):
    return JR.get(arch, reduced=reduced), TR.get(arch, reduced=reduced)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_zero1_fsdp_specs_match_reference(arch, reduced):
    je, te = _entries(arch, reduced)
    for shape, axes in MESHES:
        jm, tm = _StubMesh(shape, axes), TM.make_mesh(shape, axes)
        tp = tm.shape["model"]
        jp = jax.eval_shape(lambda: je.module.init(jax.random.PRNGKey(0),
                                                   je.config, tp))
        tparams = te.module.init(te.config, tp, device="meta")
        jspec, tspec = JS.param_pspecs(jp, jm), TS.param_pspecs(tparams, tm)
        want = _ref_table(jspec)
        assert _port_table(tspec) == want, (shape, arch)
        assert _port_table(TS.zero1_pspecs(tspec, tparams, tm)) == \
            _ref_table(JS.zero1_pspecs(jspec, jp, jm)), (shape, arch)
        assert _port_table(TS.fsdp_pspecs(tspec, tparams, tm)) == \
            _ref_table(JS.fsdp_pspecs(jspec, jp, jm)), (shape, arch)
        # the meta tensors stand for the reference's parameters
        shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                  TS.tree_leaves_with_path(tparams)}
        flat, _ = jax.tree_util.tree_flatten_with_path(jp)
        assert shapes == {JS._path_names(p): (
            tuple(v.shape), "torch." + str(v.dtype)) for p, v in flat}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(arch, reduced):
    je, te = _entries(arch, reduced)
    for shape, axes in MESHES:
        jm, tm = _StubMesh(shape, axes), TM.make_mesh(shape, axes)
        tp = tm.shape["model"]
        for cell in (JC.SHAPES["decode_32k"], SMALL):
            jc = JR.cache_specs(je, cell, tp)
            tc = TR.cache_specs(te, TC.ShapeCell(*cell.__dict__.values()),
                                tp)
            assert _port_table(TS.cache_pspecs(tc, tm)) == _ref_table(
                JS.cache_pspecs(jc, jm)), (shape, cell.name)
        for name in JC.SHAPES:
            ji = JR.input_specs(je.config, name, tp)
            ti = TR.input_specs(te.config, name, tp)
            assert _port_table(TS.batch_pspecs(ti, tm)) == _ref_table(
                JS.batch_pspecs(ji, jm)), (shape, name)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_stand_ins_match_reference(arch, reduced):
    je, te = _entries(arch, reduced)
    for tp in (1, 4, 16):
        for name in JC.SHAPES:
            ji = JR.input_specs(je.config, name, tp)
            ti = TR.input_specs(te.config, name, tp)
            assert sorted(ji) == sorted(ti)
            for k in ji:
                assert tuple(ti[k].shape) == ji[k].shape
                assert ti[k].dtype == getattr(torch, str(ji[k].dtype))
                assert ti[k].device.type == "meta"
        for cell in (JC.SHAPES["decode_32k"], SMALL):
            flat, _ = jax.tree_util.tree_flatten_with_path(
                JR.cache_specs(je, cell, tp))
            want = {JS._path_names(p): (v.shape, str(v.dtype))
                    for p, v in flat}
            got = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                   for p, v in TS.tree_leaves_with_path(TR.cache_specs(
                       te, TC.ShapeCell(*cell.__dict__.values()), tp))}
            assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_matches_reference(arch):
    jcfg, tcfg = JR.get_config(arch), TR.get_config(arch)
    assert (tcfg.sub_quadratic, tcfg.is_encdec, tcfg.attention_free) == (
        jcfg.sub_quadratic, jcfg.is_encdec, jcfg.attention_free)
    for name in JC.SHAPES:
        assert TC.shape_applicable(tcfg, name) == \
            JC.shape_applicable(jcfg, name)
    assert {k: tuple(v.__dict__.values()) for k, v in TC.SHAPES.items()} \
        == {k: tuple(v.__dict__.values()) for k, v in JC.SHAPES.items()}


GRID = [(m, n, k, p) for m in (1, 8, 4096) for n in (128, 4096, 14336)
        for k in (4096, 11008) for p in (1, 2, 3, 16)]


@pytest.mark.parametrize("p", [1, 2, 3, 16])
def test_planner_matches_reference(p):
    for m, n, k, _ in [g for g in GRID if g[3] == p]:
        for flags in [dict(), dict(consumer_contracts_n=True),
                      dict(divisible_n=False), dict(divisible_k=False),
                      dict(divisible_n=False, divisible_k=False)]:
            got = TP.plan_projection("x", m, n, k, p, **flags)
            want = JP.plan_projection("x", m, n, k, p, **flags)
            assert got.__dict__ == want.__dict__
            assert got.comm_time_s == want.comm_time_s
        got = TP.plan_ffn("ffn", m, k, n, p)
        want = JP.plan_ffn("ffn", m, k, n, p)
        assert [g.__dict__ for g in got] == [w.__dict__ for w in want]
        assert TP.describe(got) == JP.describe(want)
        assert TP.plan_decode_attention(m, k, 32, 128, p).__dict__ == \
            JP.plan_decode_attention(m, k, 32, 128, p).__dict__


def test_meshes_and_their_descriptions():
    for shape, axes in MESHES:
        m = TM.make_mesh(shape, axes)
        assert m.shape == dict(zip(axes, shape))
        assert m.size == int(np.prod(shape)) and not m.bound
        assert TM.data_axes(m) == tuple(a for a in axes if a != "model")
        assert TM.model_axis(m) == "model"
    assert TM.make_production_mesh().shape == {"data": 16, "model": 16}
    assert TM.make_production_mesh(multi_pod=True).axis_names == (
        "pod", "data", "model")
    with pytest.raises(RuntimeError, match="bind"):
        TM.make_mesh((1, 2), ("data", "model")).coord("model")
    with pytest.raises(ValueError):
        TM.make_mesh((1, 2), ("data",))
