"""Pass 3: engine/sim mirror-drift analysis (pure AST; port of
``repro.analysis.checks.mirror_drift``, over ``repro_torch``).

Extracts the real surfaces — ``EngineConfig`` fields, ``simulate_serving``
keyword parameters, ``Scheduler.metrics`` / ``Router.metrics`` emitted
keys and consumed keys, ``ServingReport`` / ``ClusterReport`` fields, and
the ``kv_report`` / ``codesign_report`` key sets — then diffs each one,
in both directions, against the contract in :mod:`mirror_spec`.

Every check is path-parameterizable so the regression fixtures can point
it at a source file that re-introduces a historical drift.
"""
from __future__ import annotations

import ast
import importlib.util
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .common import Finding
from . import mirror_spec as SPEC

PASS = "mirror-drift"

#: name -> line of first occurrence
Surface = Dict[str, int]


# --- source resolution ----------------------------------------------------
def module_path(dotted: str) -> str:
    spec = importlib.util.find_spec(dotted)
    if spec is None or spec.origin is None:
        raise ImportError(f"cannot locate source for {dotted}")
    return spec.origin


def _rel(path: str) -> str:
    p = Path(path).resolve()
    for parent in p.parents:
        if parent.name == "src":
            return str(p.relative_to(parent.parent))
    return str(p)


_TREES: Dict[str, ast.Module] = {}


def _tree(path: str) -> ast.Module:
    if path not in _TREES:
        _TREES[path] = ast.parse(Path(path).read_text())
    return _TREES[path]


def _find_class(tree: ast.Module, name: str) -> ast.ClassDef:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    raise LookupError(f"class {name} not found")


def _find_func(scope, name: str) -> ast.FunctionDef:
    for node in scope.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    raise LookupError(f"function {name} not found")


# --- surface extraction ---------------------------------------------------
def dataclass_fields(path: str, cls: str) -> Surface:
    """Annotated field names of a (data)class body."""
    out: Surface = {}
    for node in _find_class(_tree(path), cls).body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                          ast.Name):
            out.setdefault(node.target.id, node.lineno)
    return out


def kwonly_params(path: str, func: str) -> Surface:
    f = _find_func(_tree(path), func)
    return {a.arg: a.lineno for a in f.args.kwonlyargs}


def _dict_keys(node: ast.Dict) -> List[Tuple[str, int]]:
    return [(k.value, k.lineno) for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)]


def produced_keys(path: str, cls: Optional[str], func: str,
                  resolve: Optional[Dict[str, Tuple[str, Optional[str],
                                                    str]]] = None
                  ) -> Surface:
    """Keys a dict-returning method can produce.

    Follows the *returned* dict only: ``return {...}`` keys directly, or
    for ``return rep`` the keys of ``rep = {...}`` assignments,
    ``rep["k"] = ...`` subscript stores, and — via ``resolve`` — the keys
    of helper reports merged with ``rep.update(self.x.helper())`` where
    ``resolve`` maps ``helper`` to its own ``(path, cls, func)``.
    Side dicts built for nested structures (e.g. a per-replica
    breakdown) do not leak into the surface.
    """
    scope = _find_class(_tree(path), cls) if cls else _tree(path)
    f = _find_func(scope, func)
    ret_names: Set[str] = set()
    out: Surface = {}
    for node in ast.walk(f):
        if isinstance(node, ast.Return):
            if isinstance(node.value, ast.Dict):
                for k, ln in _dict_keys(node.value):
                    out.setdefault(k, ln)
            elif isinstance(node.value, ast.Name):
                ret_names.add(node.value.id)
    if not ret_names:
        return out
    for node in ast.walk(f):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ret_names
                and isinstance(node.value, ast.Dict)):
            for k, ln in _dict_keys(node.value):
                out.setdefault(k, ln)
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Subscript)
              and isinstance(node.targets[0].value, ast.Name)
              and node.targets[0].value.id in ret_names):
            sl = node.targets[0].slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                out.setdefault(sl.value, node.lineno)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id in ret_names and node.args):
            arg = node.args[0]
            helper = (arg.func.attr if isinstance(arg, ast.Call)
                      and isinstance(arg.func, ast.Attribute) else None)
            if helper == "to_dict" and isinstance(arg.func.value,
                                                  ast.Call) \
                    and isinstance(arg.func.value.func, ast.Attribute):
                # typed report at the dict boundary:
                # rep.update(self.x.helper().to_dict()) — the helper is
                # one call deeper
                helper = arg.func.value.func.attr
            if resolve and helper in resolve:
                out.update(produced_keys(*resolve[helper]))
    return out


def bound_receivers(f: ast.FunctionDef, method_names: Set[str]) -> Set[str]:
    """Local variables bound to ``x.method()`` calls (also through the
    ``getattr(x, "method", dict)()`` idiom)."""
    names: Set[str] = set()
    for node in ast.walk(f):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        fn = node.value.func
        attr = None
        if isinstance(fn, ast.Attribute):
            attr = fn.attr
        elif (isinstance(fn, ast.Call) and isinstance(fn.func, ast.Name)
              and fn.func.id == "getattr" and len(fn.args) >= 2
              and isinstance(fn.args[1], ast.Constant)):
            attr = fn.args[1].value
        if attr in method_names:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def read_keys(path: str, cls: Optional[str], func: str,
              source_methods: Set[str]) -> Surface:
    """String keys the method reads (``m["k"]`` / ``m.get("k")``) off
    variables bound to any of ``source_methods``."""
    scope = _find_class(_tree(path), cls) if cls else _tree(path)
    f = _find_func(scope, func)
    receivers = bound_receivers(f, source_methods)
    out: Surface = {}
    for node in ast.walk(f):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id in receivers
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            out.setdefault(node.slice.value, node.lineno)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "get"
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id in receivers
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            out.setdefault(node.args[0].value, node.lineno)
    return out


# --- contract diffing -----------------------------------------------------
def _two_way(pairs, left: Surface, right: Surface,
             left_only: Dict[str, str], right_only: Dict[str, str],
             *, invariant: str, left_desc: str, right_desc: str,
             left_file: str, right_file: str) -> List[Finding]:
    """Diff two surfaces against a pair list + one-sided allowlists.

    Flags: surface names with neither a mirror nor a declared exemption
    (both directions), and contract entries naming things that no longer
    exist (stale contract)."""
    out: List[Finding] = []
    pair_l = {a for a, _ in pairs}
    pair_r = {b for _, b in pairs}

    def _f(msg, file, line, inv=invariant):
        return Finding(PASS, inv, msg, file=_rel(file), line=line)

    for a, b in pairs:
        if a not in left:
            out.append(_f(f"contract pairs {left_desc} '{a}' <-> "
                          f"{right_desc} '{b}', but '{a}' does not exist",
                          left_file, None, inv="stale-contract"))
        if b not in right:
            out.append(_f(f"contract pairs {left_desc} '{a}' <-> "
                          f"{right_desc} '{b}', but '{b}' does not exist",
                          right_file, None, inv="stale-contract"))
    for name, reason_map, file in ((left_only, left, left_file),
                                   (right_only, right, right_file)):
        for k in name:
            if k not in reason_map:
                out.append(_f(f"contract exempts '{k}' but it no longer "
                              f"exists", file, None, inv="stale-contract"))
    for k, ln in left.items():
        if k not in pair_l and k not in left_only:
            out.append(_f(f"{left_desc} '{k}' has no {right_desc} mirror "
                          f"and no declared exemption", left_file, ln))
    for k, ln in right.items():
        if k not in pair_r and k not in right_only:
            out.append(_f(f"{right_desc} '{k}' has no {left_desc} mirror "
                          f"and no declared exemption", right_file, ln))
    return out


# --- the four checks ------------------------------------------------------
def check_engine_sim_config(engine_path: Optional[str] = None,
                            sim_path: Optional[str] = None
                            ) -> List[Finding]:
    """EngineConfig fields <-> simulate_serving keyword parameters."""
    engine_path = engine_path or module_path("repro_torch.serving.engine")
    sim_path = sim_path or module_path("repro_torch.core.serving_sim")
    return _two_way(
        SPEC.ENGINE_SIM_PAIRS,
        dataclass_fields(engine_path, "EngineConfig"),
        kwonly_params(sim_path, "simulate_serving"),
        SPEC.ENGINE_ONLY_CONFIG, SPEC.SIM_ONLY_PARAMS,
        invariant="config-mirror",
        left_desc="EngineConfig field", right_desc="simulate_serving param",
        left_file=engine_path, right_file=sim_path)


def check_serving_report(sched_path: Optional[str] = None,
                         sim_path: Optional[str] = None) -> List[Finding]:
    """Scheduler.metrics keys <-> ServingReport fields."""
    sched_path = sched_path or module_path("repro_torch.serving.scheduler")
    sim_path = sim_path or module_path("repro_torch.core.serving_sim")
    return _two_way(
        SPEC.SERVING_REPORT_PAIRS,
        dataclass_fields(sim_path, "ServingReport"),
        produced_keys(sched_path, "Scheduler", "metrics"),
        SPEC.SERVING_REPORT_ONLY, SPEC.SCHEDULER_METRICS_ONLY,
        invariant="report-mirror",
        left_desc="ServingReport field", right_desc="Scheduler.metrics key",
        left_file=sim_path, right_file=sched_path)


def check_cluster_report(router_path: Optional[str] = None,
                         sim_path: Optional[str] = None) -> List[Finding]:
    """Router.metrics keys <-> ClusterReport fields."""
    router_path = router_path or module_path("repro_torch.serving.router")
    sim_path = sim_path or module_path("repro_torch.core.serving_sim")
    return _two_way(
        SPEC.CLUSTER_REPORT_PAIRS,
        dataclass_fields(sim_path, "ClusterReport"),
        produced_keys(router_path, "Router", "metrics"),
        SPEC.CLUSTER_REPORT_ONLY, SPEC.ROUTER_METRICS_ONLY,
        invariant="report-mirror",
        left_desc="ClusterReport field", right_desc="Router.metrics key",
        left_file=sim_path, right_file=router_path)


def check_router_aggregation(router_path: Optional[str] = None,
                             router_cls: str = "Router",
                             sched_path: Optional[str] = None
                             ) -> List[Finding]:
    """Router.metrics must consume every scheduler key listed in
    ROUTER_MUST_AGGREGATE (or drop it with a declared reason), and every
    key it does read by name must actually be emitted by
    Scheduler.metrics — the ad-hoc name matching both ways."""
    router_path = router_path or module_path("repro_torch.serving.router")
    sched_path = sched_path or module_path("repro_torch.serving.scheduler")
    emitted = produced_keys(sched_path, "Scheduler", "metrics")
    reads = read_keys(router_path, router_cls, "metrics", {"metrics"})
    scope = _find_class(_tree(router_path), router_cls)
    fline = _find_func(scope, "metrics").lineno
    out: List[Finding] = []
    for k in SPEC.ROUTER_MUST_AGGREGATE:
        if k not in emitted:
            out.append(Finding(PASS, "stale-contract",
                               f"ROUTER_MUST_AGGREGATE lists '{k}' but "
                               f"Scheduler.metrics does not emit it",
                               file=_rel(sched_path)))
        elif k not in reads and k not in SPEC.ROUTER_AGGREGATE_DROPS:
            out.append(Finding(
                PASS, "cluster-aggregation",
                f"Scheduler.metrics emits '{k}' but {router_cls}.metrics "
                f"never aggregates it (and no drop is declared)",
                file=_rel(router_path), line=fline))
    for k, ln in reads.items():
        if k not in emitted:
            out.append(Finding(
                PASS, "phantom-read",
                f"{router_cls}.metrics reads scheduler key '{k}' that "
                f"Scheduler.metrics never emits",
                file=_rel(router_path), line=ln))
    return out


def check_kv_report_reads(sched_path: Optional[str] = None,
                          router_path: Optional[str] = None,
                          engine_path: Optional[str] = None
                          ) -> List[Finding]:
    """Every kv_report / codesign_report key read by Scheduler.metrics or
    Router.metrics must be produced by some engine's report method."""
    sched_path = sched_path or module_path("repro_torch.serving.scheduler")
    router_path = router_path or module_path("repro_torch.serving.router")
    engine_path = engine_path or module_path("repro_torch.serving.engine")
    cache_path = module_path("repro_torch.serving.paged_cache")
    api_path = module_path("repro_torch.serving.replica_api")
    resolve = {"sharing_report": (cache_path, "PagedCache",
                                  "sharing_report"),
               # placement_report returns a typed PlacementReport; its
               # to_dict() is the JSON-boundary key producer
               "placement_report": (api_path, "PlacementReport",
                                    "to_dict")}
    tree = _tree(engine_path)
    kv_produced: Surface = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            try:
                _find_func(node, "kv_report")
            except LookupError:
                continue
            kv_produced.update(produced_keys(engine_path, node.name,
                                             "kv_report", resolve))
    cd_produced: Surface = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            try:
                _find_func(node, "codesign_report")
            except LookupError:
                continue
            cd_produced.update(produced_keys(engine_path, node.name,
                                             "codesign_report"))
    out: List[Finding] = []
    for path, cls in ((sched_path, "Scheduler"), (router_path, "Router")):
        for src, produced, label in ((("kv_report",), kv_produced,
                                      "kv_report"),
                                     (("codesign_report",), cd_produced,
                                      "codesign_report")):
            for k, ln in read_keys(path, cls, "metrics", set(src)).items():
                if k not in produced:
                    out.append(Finding(
                        PASS, "phantom-read",
                        f"{cls}.metrics reads {label} key '{k}' that no "
                        f"engine produces", file=_rel(path), line=ln))
    return out


def check_fused_emit_guard(engine_path: Optional[str] = None,
                           cls: str = "PagedServingEngine",
                           func: str = "_apply_fused") -> List[Finding]:
    """Fused-tick token accounting: every ``req.tokens_out.append`` in the
    fused apply path must sit behind the per-step emit mask.

    The fused scan emits a fixed ``n_steps``-long token sequence per slot
    and a boolean emit mask saying which steps actually ran (the slot may
    finish on eos mid-horizon, or the traced horizon may be shorter than
    the padded scan length).  Appending a token without consulting the
    mask double-counts a finished slot's final token — the token stream
    silently diverges from the per-tick engine.  Statement order decides
    guardedness: an ``if`` whose test mentions the emit mask guards its
    body, and a guarded branch that ends in ``continue``/``break``/
    ``return``/``raise`` guards everything after it in the same body.
    """
    engine_path = engine_path or module_path("repro_torch.serving.engine")
    try:
        scope = _find_class(_tree(engine_path), cls)
        f = _find_func(scope, func)
    except LookupError:
        return [Finding(PASS, "fused-emit-guard",
                        f"{cls}.{func} not found — fused apply path "
                        f"missing or renamed", file=_rel(engine_path))]

    def _is_emit_test(test: ast.expr) -> bool:
        return "emit" in ast.unparse(test)

    def _append_calls(stmts, guarded: bool, out: List[Finding]) -> None:
        shielded = guarded
        for st in stmts:
            if isinstance(st, ast.If) and _is_emit_test(st.test):
                _append_calls(st.body, True, out)
                _append_calls(st.orelse, shielded, out)
                # `if not emit: continue` shields the rest of this body
                if st.body and isinstance(
                        st.body[-1], (ast.Continue, ast.Break,
                                      ast.Return, ast.Raise)):
                    shielded = True
                continue
            if isinstance(st, (ast.For, ast.While)):
                _append_calls(st.body, shielded, out)
                _append_calls(st.orelse, shielded, out)
                continue
            if isinstance(st, ast.If):
                _append_calls(st.body, shielded, out)
                _append_calls(st.orelse, shielded, out)
                continue
            for node in ast.walk(st):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "append"
                        and isinstance(node.func.value, ast.Attribute)
                        and node.func.value.attr == "tokens_out"
                        and not shielded):
                    out.append(Finding(
                        PASS, "fused-emit-guard",
                        f"{func} appends to tokens_out without consulting "
                        f"the per-step emit mask — a finished slot's token "
                        f"is double-counted on fused ticks",
                        file=_rel(engine_path), line=node.lineno))

    out: List[Finding] = []
    _append_calls(f.body, False, out)
    return out


def check_metrics_registered(sched_path: Optional[str] = None,
                             router_path: Optional[str] = None,
                             sched_cls: str = "Scheduler",
                             router_cls: str = "Router") -> List[Finding]:
    """Every key ``Scheduler.metrics`` / ``Router.metrics`` emits must be
    declared in the metric-name contract next to the registry
    (``repro_torch.obs.metrics``), and — for the real modules — every
    declared name must still be emitted.  The drift class: a scheduler
    grows a metric the registry (and its exporters/dashboards) never learn
    about, or a rename leaves a dead name in the contract.

    Fixture paths check the *unregistered* direction only, so a minimal
    fixture class need not re-emit the whole contract.
    """
    out: List[Finding] = []
    for path, dflt_mod, cls, contract, label in (
            (sched_path, "repro_torch.serving.scheduler", sched_cls,
             SPEC.SCHEDULER_METRIC_CONTRACT, "SCHEDULER_METRIC_CONTRACT"),
            (router_path, "repro_torch.serving.router", router_cls,
             SPEC.ROUTER_METRIC_CONTRACT, "ROUTER_METRIC_CONTRACT")):
        is_real = path is None
        if path is None and sched_path is None and router_path is None:
            path = module_path(dflt_mod)
        elif path is None:
            continue                # fixture run: only the given side
        emitted = produced_keys(path, cls, "metrics")
        for k, ln in emitted.items():
            if k not in contract:
                out.append(Finding(
                    PASS, "unregistered-metric",
                    f"{cls}.metrics emits '{k}' but {label} does not "
                    f"declare it — register the metric name in "
                    f"repro_torch.obs.metrics", file=_rel(path), line=ln))
        if is_real:
            for k in contract:
                if k not in emitted:
                    out.append(Finding(
                        PASS, "stale-contract",
                        f"{label} declares '{k}' but {cls}.metrics no "
                        f"longer emits it", file=_rel(path)))
    return out


def check_replica_protocol(impls: Optional[List[Tuple[str, str]]] = None,
                           api_path: Optional[str] = None
                           ) -> List[Finding]:
    """Every declared replica implementation must define the full
    ``replica_api.Replica`` surface, and the typed-report
    dataclasses must carry exactly the field lists the spec pins — the
    drift class where the engine grows a replica method (or a report
    field) the sim mirror and the router test stubs never learn about.
    """
    impls = SPEC.REPLICA_IMPLEMENTATIONS if impls is None else impls
    api_path = api_path or module_path("repro_torch.serving.replica_api")
    # src/repro_torch/serving/engine.py -> repo root is three levels up
    root = Path(module_path("repro_torch.serving.engine")).resolve().parents[3]
    out: List[Finding] = []
    for rel, cls in impls:
        path = root / rel
        if not path.exists():
            out.append(Finding(PASS, "stale-contract",
                               f"REPLICA_IMPLEMENTATIONS lists {rel} but "
                               f"the file does not exist", file=rel))
            continue
        try:
            node = _find_class(_tree(str(path)), cls)
        except LookupError:
            out.append(Finding(PASS, "stale-contract",
                               f"REPLICA_IMPLEMENTATIONS lists class "
                               f"{cls} but {rel} does not define it",
                               file=rel))
            continue
        methods = {n.name for n in node.body
                   if isinstance(n, ast.FunctionDef)}
        for m in SPEC.REPLICA_PROTOCOL_METHODS:
            if m not in methods:
                out.append(Finding(
                    PASS, "replica-protocol",
                    f"{cls} ({rel}) does not define replica-protocol "
                    f"method '{m}' — the router drives all replicas "
                    f"through replica_api.Replica", file=rel,
                    line=node.lineno))
    for cls, spec_fields, label in (
            ("LoadReport", SPEC.LOAD_REPORT_FIELDS,
             "LOAD_REPORT_FIELDS"),
            ("PlacementReport", SPEC.PLACEMENT_REPORT_FIELDS,
             "PLACEMENT_REPORT_FIELDS")):
        fields = dataclass_fields(api_path, cls)
        for f in spec_fields:
            if f not in fields:
                out.append(Finding(
                    PASS, "stale-contract",
                    f"{label} pins '{f}' but {cls} no longer has it",
                    file=_rel(api_path)))
        for f, ln in fields.items():
            if f not in spec_fields:
                out.append(Finding(
                    PASS, "replica-protocol",
                    f"{cls} field '{f}' is not pinned in {label} — "
                    f"register it in mirror_spec so the JSON boundary "
                    f"stays audited", file=_rel(api_path), line=ln))
    return out


def run() -> List[Finding]:
    findings: List[Finding] = []
    findings += check_engine_sim_config()
    findings += check_serving_report()
    findings += check_cluster_report()
    findings += check_router_aggregation()
    findings += check_kv_report_reads()
    findings += check_fused_emit_guard()
    findings += check_metrics_registered()
    findings += check_replica_protocol()
    return findings
