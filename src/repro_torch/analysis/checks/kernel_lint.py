"""Pass 1 — kernel aliasing lint (port of
``repro.analysis.checks.kernel_lint``).

Traces the port's scatter paths to aten graphs (``make_fx`` on fake
tensors: nothing runs) and statically verifies the scratch/bounds
discipline the paged cache depends on:

* **scatter-window-guard** — a write position past the mapped
  block-table window must be *detected* (a comparison against the window
  length on the index dataflow), not silently clipped onto the last live
  page (the clip-aliasing bug).
* **scatter-scratch-route** — detected out-of-window / inactive lanes
  must be routed to the pool's scratch page (a ``where`` whose branch is
  the scratch page index) so no refcount>1 page can be aliased by the
  write.
* **scatter-active-guard** — the token scatter's destination must
  depend on the ``active`` lane mask (the inactive-lane bug wrote
  through stale tables of parked slots).
* **host-side guards** (AST) — the engine routes inactive lanes' table
  rows to scratch before invoking the paged kernel, chunked scatter
  routes shared-prefix blocks to scratch, and the decode step resolves
  copy-on-write *before* any device write.

The reference's Pallas block-mapping lint reads ``pallas_call`` index
maps, which the port's CUDA kernels do not have.  In its place
:func:`lint_flash_decode`, :func:`lint_snake_gemm` and :func:`lint_wkv6`
probe the same invariants on real calls of the ``kernels.ops`` entries
(the plain versions on the CPU, the CUDA kernels on the card): pages
and positions past ``lengths[b]``, and the scratch page, hold NaN;
inactive lanes' tables point at the scratch page; output buffers are
pre-filled with a NaN sentinel (a caller-given state buffer filled, and
on the card a NaN block freed just before the call, which the caching
allocator hands to the next output of its size), so an unwritten block
shows; the tails are ragged (a WKV6 ``T`` that is not a multiple of the
chunk, GEMM ``M`` and ``N`` off the tile, columns past ``N`` NaN).  Each
output must be finite and equal its plain version on the same inputs
with the NaN replaced by zeros.
"""
from __future__ import annotations

import ast
import inspect
from typing import Callable, Dict, List, Optional

import torch

from .common import Finding
from . import graph_utils as GU

PASS = "kernel-aliasing"

# distinctive small-scope dims so guard literals (nblk, scratch page) do
# not collide with unrelated constants in the traced computation
_NBLK = 7
_POOL_PAGES = 13          # scratch page index == 13, page axis size 14


def _loc(fn) -> tuple:
    try:
        target = inspect.unwrap(fn)
        return (inspect.getsourcefile(target),
                inspect.getsourcelines(target)[1])
    except (TypeError, OSError):
        return (None, None)


def _f(invariant: str, message: str, file=None, line=None, detail=None):
    return Finding(PASS, invariant, message, file=file, line=line,
                   detail=detail)


def _has_window_compare(nodes, nblk: int) -> bool:
    """A comparison carrying the window length as *its own* constant
    operand."""
    return any(GU.op_name(n) in GU.CMP_OPS and GU.mentions_literal(n, nblk)
               for n in nodes)


def _routes_to_scratch(nodes, scratch_page: int) -> bool:
    """A ``where`` one of whose branches is the scratch page (a constant
    argument, or one materialised one hop up)."""
    for n in nodes:
        if GU.op_name(n) not in GU.SELECT_OPS:
            continue
        branches = n.args[1:]
        if scratch_page in [a for a in branches
                            if isinstance(a, (int, float))]:
            return True
        if any(isinstance(a, torch.fx.Node)
               and GU.mentions_literal(a, scratch_page)
               and GU.op_name(a) not in GU.SELECT_OPS for a in branches):
            return True
    return False


# ----------------------------------------------------------------------
# scatter-path checks (token scatter, decode_step_paged)
# ----------------------------------------------------------------------
def check_scatter_guards(gm, *, scratch_page: int, nblk: int,
                         active_input: Optional[int], label: str,
                         file=None, line=None) -> List[Finding]:
    """Verify the guard dataflow of every pool scatter in a traced graph:
    a backward slice from each scatter's index operands must hold the
    window comparison, the scratch route and (``active_input``: the
    placeholder index of the lane mask) the active mask."""
    findings: List[Finding] = []
    page_axis = scratch_page + 1
    scatters = GU.find_scatters(gm, page_axis)
    if not scatters:
        return [_f("scatter-missing",
                   f"{label}: traced no write into a {page_axis}-page pool "
                   "(lint target misconfigured?)", file, line)]
    inputs = GU.placeholders(gm)
    where = "the scatter's index dataflow"
    for node in scatters:
        nodes, sources = GU.backward_slice(gm, GU.scatter_index_args(node))
        if not _routes_to_scratch(nodes, scratch_page):
            findings.append(_f(
                "scatter-scratch-route",
                f"{label}: {where} has no select routing to the scratch "
                f"page ({scratch_page}) — an out-of-window or inactive "
                "lane would alias a live (possibly shared) page",
                file, line))
        if not _has_window_compare(nodes, nblk):
            findings.append(_f(
                "scatter-window-guard",
                f"{label}: {where} never compares the block index against "
                f"the table window ({nblk} blocks) — positions past the "
                "window are clipped onto the last live page instead of "
                "detected (the clip-aliasing class)",
                file, line))
        if active_input is not None \
                and inputs[active_input] not in sources:
            findings.append(_f(
                "scatter-active-guard",
                f"{label}: {where} does not depend on the active-lane "
                "mask — inactive slots would write through their "
                "stale block tables (the inactive-lane class)",
                file, line))
    # one finding per invariant and target
    out, seen = [], set()
    for f in findings:
        if f.invariant not in seen:
            seen.add(f.invariant)
            out.append(f)
    return out


def lint_scatter_token(fn: Optional[Callable] = None) -> List[Finding]:
    """``paged_cache._scatter_token`` (or a fixture reintroducing the
    clipped variant)."""
    if fn is None:
        from repro_torch.serving import paged_cache as pc
        fn = pc._scatter_token
    file, line = _loc(fn)
    L, B, D, ps = 1, 2, 8, 4
    pool = torch.zeros((L, _POOL_PAGES + 1, ps, D))
    leaf = torch.zeros((L, B, _NBLK * ps, D))
    tables = torch.zeros((B, _NBLK), dtype=torch.long)
    pos = torch.zeros((B,), dtype=torch.long)
    active = torch.zeros((B,), dtype=torch.bool)
    gm = GU.trace(lambda *a: fn(*a, ps), pool, leaf, tables, pos, active)
    return check_scatter_guards(
        gm, scratch_page=_POOL_PAGES, nblk=_NBLK, active_input=4,
        label="paged_cache._scatter_token", file=file, line=line)


def lint_decode_step_paged(fn: Optional[Callable] = None) -> List[Finding]:
    """``transformer.decode_step_paged``: the page index feeding the
    per-layer KV scatters must carry the window guard + scratch route."""
    from repro_torch.models import registry
    from repro_torch.models import transformer as T

    fn = fn or T.decode_step_paged
    file, line = _loc(fn)
    cfg = registry.get("yi-6b", reduced=True).config
    params = T.init(cfg, 1, device="cpu")
    _, hkv = cfg.padded_heads(1)
    B, ps = 2, 4
    kp = torch.zeros((cfg.num_layers, _POOL_PAGES + 1, ps, hkv, cfg.d_head))
    vp = torch.zeros_like(kp)
    tables = torch.zeros((B, _NBLK), dtype=torch.int32)
    lengths = torch.zeros((B,), dtype=torch.int32)
    toks = torch.zeros((B,), dtype=torch.int32)
    gm = GU.trace(lambda *a: fn(params, cfg, *a), toks, kp, vp, tables,
                  lengths)
    return check_scatter_guards(
        gm, scratch_page=_POOL_PAGES, nblk=_NBLK, active_input=None,
        label="transformer.decode_step_paged", file=file, line=line)


# ----------------------------------------------------------------------
# kernel probes (the CUDA kernels on the card, the plain versions here)
# ----------------------------------------------------------------------
NAN = float("nan")
PROBE_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _sentinel(like_shape, dtype, device) -> None:
    """On the card, a NaN block of the next output's size, freed: the
    caching allocator hands it to that output, so an element the kernel
    does not write stays NaN."""
    if torch.device(device).type == "cuda":
        torch.full(like_shape, NAN, dtype=dtype, device=device)


def _clean(t: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(t, nan=0.0)


def _held(name: str, got, want, dtype, file, line,
          errs: Optional[Dict[str, float]]) -> List[Finding]:
    """``got`` finite and within the dtype's tolerance of ``want``."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        tag = f"{name}[{i}]" if len(got) > 1 else name
        if not bool(torch.isfinite(g).all()):
            out.append(_f("kernel-probe-finite",
                          f"{tag}: non-finite output — a NaN past the "
                          "valid positions, in the scratch page or in an "
                          "unwritten output block reached it", file, line))
            continue
        err = float((g.float() - w.float()).abs().max()) if g.numel() \
            else 0.0
        if errs is not None:
            errs[tag] = max(errs.get(tag, 0.0), err)
        if not torch.allclose(g.float(), w.float(), **PROBE_TOL[dtype]):
            out.append(_f("kernel-probe-value",
                          f"{tag}: max |err| {err:.3g} against its plain "
                          f"version beyond {PROBE_TOL[dtype]}", file, line))
    return out


def _fd_inputs(dtype, device):
    """q, dense K/V with NaN past each length, and the paged pools (page
    16, ``_POOL_PAGES`` pages + a NaN scratch page) whose unmapped pages
    and tail positions hold NaN; lane 0 is inactive (length 0, its table
    all scratch), the others ragged."""
    gen = torch.Generator().manual_seed(0)
    b, hq, hkv, d, page = 4, 8, 2, 64, 16
    lengths = [0, 1, 17, 100]
    s = _NBLK * page

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    q = randn(b, hq, d)
    k, v = randn(b, s, hkv, d), randn(b, s, hkv, d)
    kp = torch.full((_POOL_PAGES + 1, page, hkv, d), NAN)
    vp = kp.clone()
    tables = torch.full((b, _NBLK), _POOL_PAGES, dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        k[i, n:], v[i, n:] = NAN, NAN
        for blk in range(-(-n // page)):
            p = nxt
            nxt += 1
            tables[i, blk] = p
            rows = range(blk * page, min(n, (blk + 1) * page))
            kp[p, :len(rows)] = k[i, rows.start:rows.stop]
            vp[p, :len(rows)] = v[i, rows.start:rows.stop]
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(device=device, dtype=dtype) if t.is_floating_point()
            else t.to(device) for t in (q, k, v, kp, vp, tables, lens)]


def lint_flash_decode(device: str,
                      errs: Optional[Dict[str, float]] = None
                      ) -> List[Finding]:
    """Both flash decodes and the partial entry through
    ``kernels.ops``: NaN past every length and in the scratch page, an
    inactive lane routed to scratch, NaN output sentinels."""
    from repro_torch.kernels import ops, ref

    findings: List[Finding] = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, kp, vp, tables, lens = _fd_inputs(dtype, device)
        tag = str(dtype).replace("torch.", "")
        calls = [
            ("paged_flash_decode", ops.attention_decode_paged,
             ref.paged_flash_decode_ref, (q, kp, vp, tables, lens)),
            ("flash_decode", ops.attention_decode, ref.flash_decode_ref,
             (q, k, v, lens)),
            ("flash_decode_partial", ops.attention_decode_partial,
             ref.flash_decode_partial_ref, (q, k, v, lens))]
        for name, entry, plain, args in calls:
            file, line = _loc(entry)
            _sentinel(q.shape, dtype, device)
            got = entry(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = plain(*[_clean(a) if a.is_floating_point() else a
                           for a in args])
            want = want if isinstance(want, tuple) else (want,)
            held = _held(f"{name} {tag}", got, want, dtype, file, line, errs)
            findings += held
            if not held and name != "flash_decode_partial" and bool(
                    (got[0][0] != 0).any()):
                findings.append(_f(
                    "kernel-probe-inactive",
                    f"{name} {tag}: the inactive lane (length 0, table "
                    "on the scratch page) is not 0", file, line))
    return findings


def lint_snake_gemm(device: str,
                    errs: Optional[Dict[str, float]] = None
                    ) -> List[Finding]:
    """The decode GEMM through ``kernels.ops`` at M and N off the tile,
    b the first N columns of a buffer whose other columns are NaN, a NaN
    output sentinel."""
    from repro_torch.kernels import ops, ref

    findings: List[Finding] = []
    gen = torch.Generator().manual_seed(1)
    file, line = _loc(ops.decode_gemm)
    for dtype in (torch.float32, torch.bfloat16):
        for m, n, k in ((5, 200, 256), (3, 72, 512)):
            a = torch.randn(m, k, generator=gen).to(device=device,
                                                    dtype=dtype)
            wide = torch.full((k, 256), NAN)
            wide[:, :n] = torch.randn(k, n, generator=gen)
            b = wide.to(device=device, dtype=dtype)[:, :n]
            _sentinel((m, n), dtype, device)
            got = ops.decode_gemm(a, b)
            want = ref.decode_gemm_ref(a, b.contiguous())
            findings += _held(f"snake_decode_gemm {m}x{n}x{k} "
                              f"{str(dtype).replace('torch.', '')}",
                              (got,), (want,), dtype, file, line, errs)
    return findings


def lint_wkv6(device: str,
              errs: Optional[Dict[str, float]] = None) -> List[Finding]:
    """WKV6 through ``kernels.ops`` at a ragged T on both designs (37:
    serial; 100: three chunks of 32 and a tail), into a NaN-filled state
    buffer with a NaN sentinel for y."""
    from repro_torch.kernels import ops, ref

    findings: List[Finding] = []
    gen = torch.Generator().manual_seed(2)
    file, line = _loc(ops.wkv6_scan)
    b, h, hs = 2, 4, 64
    for t in (37, 100):
        def randn(*shape):
            return torch.randn(*shape, generator=gen) * 0.5
        r, k, v = randn(b, t, h, hs), randn(b, t, h, hs), randn(b, t, h, hs)
        w = torch.exp(-torch.exp(randn(b, t, h, hs)))
        u = randn(h, hs)
        s0 = randn(b, h, hs, hs)
        args = [x.to(device) for x in (r, k, v, w, u, s0)]
        state = torch.full((b, h, hs, hs), NAN, device=device)
        _sentinel((b, t, h, hs), torch.float32, device)
        got = ops.wkv6_scan(*args, state)
        want = ref.wkv6_ref(*args)
        findings += _held(f"wkv6 T={t}", got, want, torch.float32, file,
                          line, errs)
    return findings


# ----------------------------------------------------------------------
# host-side guard checks (AST)
# ----------------------------------------------------------------------
def _parse(path: str) -> ast.Module:
    with open(path, "r") as fh:
        return ast.parse(fh.read(), filename=path)


def _find_funcs(tree: ast.Module, name: str) -> List[ast.FunctionDef]:
    return [n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef) and n.name == name]


def _has_where_guard(func: ast.FunctionDef, *needles: str) -> bool:
    """A ``*.where(...)`` call whose argument source mentions every
    needle — the host-side scratch-routing idiom."""
    for node in ast.walk(func):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "where"):
            src = " ".join(ast.unparse(a) for a in node.args)
            if all(n in src for n in needles):
                return True
    return False


def _expanded(func: ast.FunctionDef, expr: ast.expr, depth: int = 3) -> str:
    """``expr``'s source followed by the sources of the values that plain
    assignments in ``func`` bind to the names it reads (``depth`` hops)."""
    binds = {}
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            binds.setdefault(node.targets[0].id, node.value)
    parts, frontier, seen = [ast.unparse(expr)], [expr], set()
    for _ in range(depth):
        names = {n.id for e in frontier for n in ast.walk(e)
                 if isinstance(n, ast.Name)} - seen
        seen |= names
        frontier = [binds[n] for n in sorted(names) if n in binds]
        parts += [ast.unparse(e) for e in frontier]
    return " ".join(parts)


def _has_lane_route(func: ast.FunctionDef) -> bool:
    """A ``*.where(cond, ..., ...num_pages...)`` whose condition derives
    from the ``active`` lane mask (through the function's assignments)."""
    for node in ast.walk(func):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "where" and len(node.args) == 3):
            cond = _expanded(func, node.args[0])
            rest = " ".join(ast.unparse(a) for a in node.args[1:])
            if "active" in cond and "num_pages" in rest:
                return True
    return False


def _calls_in_order(func: ast.FunctionDef, first: str, second: str) -> bool:
    """``first(...)`` is invoked at a smaller line than ``second(...)``."""
    lines = {first: None, second: None}
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            name = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else getattr(node.func, "id", ""))
            if name in lines and lines[name] is None:
                lines[name] = node.lineno
    return (lines[first] is not None and lines[second] is not None
            and lines[first] < lines[second])


def check_inactive_lane_ast(path: Optional[str] = None,
                            func_name: str = "_decode_paged_kernel"
                            ) -> List[Finding]:
    """The engine must route *inactive* lanes' block-table rows to the
    scratch page before handing tables to the paged kernel: every lane
    writes its K/V, so an inactive lane with mapped (possibly shared)
    pages would be corrupted (the inactive-lane bug)."""
    if path is None:
        from repro_torch.serving import engine as E
        path = inspect.getsourcefile(E)
    tree = _parse(path)
    funcs = _find_funcs(tree, func_name)
    if not funcs:
        return [_f("host-inactive-lane",
                   f"no function {func_name} found", path)]
    out = []
    for fn in funcs:
        if not _has_lane_route(fn):
            out.append(_f(
                "host-inactive-lane",
                f"{func_name} never routes inactive lanes to the scratch "
                "page (expected a where(active, ..., num_pages) on the "
                "table rows before the kernel call)",
                path, fn.lineno))
    return out


def check_scatter_chunk_ast(path: Optional[str] = None) -> List[Finding]:
    """``PagedCache.scatter_chunk`` must route shared-prefix blocks to the
    scratch page — chunked prefill over a CoW-shared prefix would
    otherwise overwrite pages other slots still read."""
    if path is None:
        from repro_torch.serving import paged_cache as PC
        path = inspect.getsourcefile(PC)
    tree = _parse(path)
    funcs = _find_funcs(tree, "scatter_chunk")
    if not funcs:
        return [_f("host-shared-chunk-route",
                   "no scatter_chunk found", path)]
    out = []
    for fn in funcs:
        if not _has_where_guard(fn, "shared_count", "num_pages"):
            out.append(_f(
                "host-shared-chunk-route",
                "scatter_chunk does not route shared-prefix blocks to "
                "the scratch page (expected where(blk < shared_count, "
                "num_pages, ...))", path, fn.lineno))
    return out


def check_cow_order_ast(path: Optional[str] = None) -> List[Finding]:
    """CoW-before-write: the per-step grow hook must fork shared pages
    (``cow_for_write``) and run *before* the device decode write."""
    if path is None:
        from repro_torch.serving import engine as E
        path = inspect.getsourcefile(E)
    tree = _parse(path)
    out = []
    grows = _find_funcs(tree, "_pre_decode_grow")
    paged_grow = [g for g in grows
                  if any(isinstance(n, ast.Call)
                         and isinstance(n.func, ast.Attribute)
                         and n.func.attr == "cow_for_write"
                         for n in ast.walk(g))]
    if not paged_grow:
        out.append(_f(
            "host-cow-before-write",
            "no _pre_decode_grow variant calls cow_for_write — shared "
            "pages would be written in place", path,
            grows[0].lineno if grows else None))
    steps = [s for s in _find_funcs(tree, "step")
             if _calls_in_order(s, "_pre_decode_grow", "_decode_batch")]
    if not steps:
        out.append(_f(
            "host-cow-before-write",
            "no step() invokes _pre_decode_grow before _decode_batch — "
            "the CoW fork must precede the device write", path))
    return out


# ----------------------------------------------------------------------
def run(device: str, errs: Optional[Dict[str, float]] = None
        ) -> List[Finding]:
    """The pass; the kernel probes run on ``device`` and record their
    largest errors in ``errs``."""
    findings: List[Finding] = []
    findings += lint_scatter_token()
    findings += lint_decode_step_paged()
    findings += lint_flash_decode(device, errs)
    findings += lint_snake_gemm(device, errs)
    findings += lint_wkv6(device, errs)
    findings += check_inactive_lane_ast()
    findings += check_scatter_chunk_ast()
    findings += check_cow_order_ast()
    return findings
