"""Pass 2 — allocator small-scope model checker (port of
``repro.analysis.checks.allocator_model``, over the port's
``PageAllocator``, ``PrefixIndex``, ``PagedCache`` and ``PlacementMap``).

Exhaustive bounded exploration of ``PageAllocator`` + ``PrefixIndex``
op sequences (alloc / free / incref / fork / defrag / migrate /
rebuild) over a small scope — few pages, two regions, shallow depth —
in the small-scope-hypothesis tradition: allocator bugs in this repo's
history (refcount leaks, freeing shared pages, cross-region defrag
moves) all have counterexamples within a handful of operations.

The checker drives the *real* classes next to an independent ledger of
what the refcounts/trie must be, and asserts after every operation:

* **refcount conservation** — the allocator's live map equals the
  ledger exactly; no page is freed while references remain, none leaks.
* **free/used partition** — ``free + used == num_pages`` and every free
  page sits in its own region's free list.
* **no double-free / foreign incref** — ``decref``/``incref`` of an
  unallocated page must raise, and must not mutate state.
* **alloc atomicity** — a failed allocation leaves the allocator
  untouched.
* **region-preserving defrag** — a defrag move never crosses a
  placement region, and rebuild+remap keeps the refcount multiset.
* **trie↔physical consistency** — every page the prefix trie points at
  is live; remap/remove keep the reverse index exact.

Violations are reported as findings whose detail is the **minimal op
trace** (BFS order guarantees minimality) that reproduces them.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .common import Finding

PASS = "allocator-model"


@dataclass
class ModelConfig:
    num_pages: int = 5
    n_regions: int = 2
    communal_pages: int = 1
    policy: str = "affinity"
    page_size: int = 2
    depth: int = 7
    max_refcount: int = 3
    max_findings: int = 3
    max_states: int = 200_000     # safety valve, not expected to bind
    placed: bool = True


def default_defrag_mapping(alloc, placement, movable) -> Dict[int, int]:
    """Region-preserving compaction: each movable page goes to the lowest
    free index *inside its own region* (mirrors ``PagedCache.defrag``)."""
    mapping: Dict[int, int] = {}
    taken = set(alloc.live_pages())
    for old in sorted(movable):
        region = placement.region_of(old) if placement is not None else None
        if placement is not None:
            candidates = [p for p in placement.region_pages(region)
                          if p not in taken and p < old]
        else:
            candidates = [p for p in range(old)
                          if p not in taken]
        if candidates:
            new = min(candidates)
            mapping[old] = new
            taken.discard(old)
            taken.add(new)
    return mapping


@dataclass
class _State:
    alloc: object
    prefix: object
    refs: Dict[int, int]            # ledger: page -> expected refcount
    trie: set                       # ledger: pages published in the trie
    home: Dict[int, int]            # ledger: page -> intended home region
    trace: Tuple[str, ...] = ()

    def clone(self) -> "_State":
        return _State(copy.deepcopy(self.alloc), copy.deepcopy(self.prefix),
                      dict(self.refs), set(self.trie), dict(self.home),
                      self.trace)

    def key(self):
        a = self.alloc
        if getattr(a, "placed", False):
            free = tuple(sorted(
                (r, tuple(v)) for r, v in a._region_lists.items()))
        else:
            free = tuple(a._free)
        return (tuple(sorted(self.refs.items())),
                frozenset(self.trie),
                tuple(sorted(self.home.items())),
                free)


class _Violation(Exception):
    pass


def _tokens_for(page: int, page_size: int) -> np.ndarray:
    return np.arange(page_size, dtype=np.int64) + page * page_size


def check_state(s: _State, cfg: ModelConfig, placement) -> Optional[str]:
    a = s.alloc
    live = {p: a.refcount(p) for p in a.live_pages()}
    if live != s.refs:
        return (f"refcount conservation violated: allocator holds {live}, "
                f"ledger expects {s.refs}")
    if a.free_pages + a.used_pages != cfg.num_pages:
        return (f"free/used partition broken: {a.free_pages} free + "
                f"{a.used_pages} used != {cfg.num_pages}")
    if getattr(a, "placed", False):
        for r, pool in a._region_lists.items():
            for p in pool:
                if placement.region_of(p) != r:
                    return (f"free page {p} filed under region {r} but "
                            f"placed in region {placement.region_of(p)}")
                if p in live:
                    return f"page {p} simultaneously free and live"
    by_page = set(getattr(s.prefix, "_by_page", {}))
    if by_page != s.trie:
        return (f"trie reverse index {sorted(by_page)} diverged from "
                f"ledger {sorted(s.trie)}")
    for p in s.trie:
        if a.refcount(p) <= 0:
            return f"prefix trie points at dead page {p}"
    # exception discipline probed exhaustively at every state: touching
    # an unallocated page must raise and must not mutate
    freed = [p for p in range(cfg.num_pages) if p not in s.refs]
    for p in freed[:2]:
        probe = copy.deepcopy(a)
        for opname, op in (("decref", probe.decref), ("incref", probe.incref)):
            try:
                op(p)
            except ValueError:
                pass
            else:
                return (f"{opname}({p}) of a free page did not raise — "
                        "double-free / foreign-page discipline lost")
        if (probe.free_pages, sorted(probe.live_pages())) != \
                (a.free_pages, sorted(a.live_pages())):
            return f"failed decref/incref of page {p} mutated the allocator"
    return None


def _enabled_ops(s: _State, cfg: ModelConfig, placement):
    """(op_label, apply_fn) pairs applicable in state ``s``.  Each apply
    mutates its (cloned) state and may raise :class:`_Violation`."""
    ops: List[Tuple[str, Callable[[_State], None]]] = []
    regions = (list(range(cfg.n_regions)) if placement is not None
               else [None])

    for r in regions:
        def _alloc(st, r=r):
            a = st.alloc
            before = (a.free_pages, sorted(a.live_pages()))
            got = a.alloc(1, home=r) if r is not None else a.alloc(1)
            if got is None:
                after = (a.free_pages, sorted(a.live_pages()))
                if after != before:
                    raise _Violation(
                        "failed alloc mutated the allocator "
                        f"({before} -> {after})")
                return
            st.refs[got[0]] = 1
            if r is not None:
                st.home[got[0]] = r
        ops.append((f"alloc(1, home={r})", _alloc))
    if placement is not None and cfg.communal_pages:
        def _alloc_communal(st):
            got = st.alloc.alloc(1, home=0, communal=1)
            if got is None:
                return
            st.refs[got[0]] = 1
            st.home[got[0]] = 0
        ops.append(("alloc(1, communal=1)", _alloc_communal))

    for p in sorted(s.refs):
        if s.refs[p] < cfg.max_refcount:
            def _incref(st, p=p):
                st.alloc.incref(p)
                st.refs[p] += 1
            ops.append((f"incref({p})", _incref))

    for p in sorted(s.refs):
        def _decref(st, p=p):
            freed = st.alloc.decref(p)
            st.refs[p] -= 1
            if st.refs[p] == 0:
                del st.refs[p]
                st.home.pop(p, None)
                if not freed:
                    raise _Violation(
                        f"last decref of page {p} did not free it")
                if p in st.trie:
                    st.prefix.remove(p)
                    st.trie.discard(p)
            elif freed:
                raise _Violation(
                    f"page {p} freed while {st.refs[p]} reference(s) "
                    "remain (shared-page free)")
        ops.append((f"decref({p})", _decref))

    for p in sorted(s.refs):
        if p not in s.trie:
            def _register(st, p=p):
                st.prefix.register(_tokens_for(p, cfg.page_size), [p],
                                   cfg.page_size)
                st.trie.add(p)
            ops.append((f"register({p})", _register))

    for p in sorted(s.refs):
        if s.refs[p] >= 2:
            def _fork(st, p=p):
                # copy-on-write at the allocator level: the writer takes
                # a fresh exclusive page and drops its shared reference
                got = st.alloc.alloc(1, home=st.home.get(p))
                if got is None:
                    return
                st.refs[got[0]] = 1
                if p in st.home:
                    st.home[got[0]] = st.home[p]
                st.alloc.decref(p)
                st.refs[p] -= 1
            ops.append((f"fork({p})", _fork))

    if placement is not None:
        def _migrate(st):
            # move every spilled exclusive non-trie page home (mirrors
            # PagedCache.migrate_spilled)
            for p in sorted(st.refs):
                if (st.refs[p] != 1 or p in st.trie
                        or p not in st.home):
                    continue
                if placement.region_of(p) == st.home[p]:
                    continue
                got = st.alloc.alloc_in(st.home[p], 1)
                if got is None:
                    continue
                if placement.region_of(got[0]) != st.home[p]:
                    raise _Violation(
                        f"alloc_in({st.home[p]}) handed out page "
                        f"{got[0]} from region "
                        f"{placement.region_of(got[0])}")
                st.refs[got[0]] = 1
                st.home[got[0]] = st.home[p]
                st.alloc.decref(p)
                del st.refs[p]
                del st.home[p]
        ops.append(("migrate_spilled()", _migrate))

    def _defrag(st, mapping_fn):
        movable = [p for p in st.refs
                   if st.refs[p] == 1 and p not in st.trie]
        mapping = mapping_fn(st.alloc, placement, movable)
        for old, new in mapping.items():
            if placement is not None and \
                    placement.region_of(new) != placement.region_of(old):
                raise _Violation(
                    f"defrag moved page {old} (region "
                    f"{placement.region_of(old)}) to page {new} (region "
                    f"{placement.region_of(new)}) — cross-region move")
        new_refs = {mapping.get(p, p): rc for p, rc in st.refs.items()}
        if len(new_refs) != len(st.refs):
            raise _Violation(
                f"defrag mapping {mapping} collapses distinct live pages")
        st.alloc.rebuild(new_refs)
        st.prefix.remap(mapping)
        st.refs = new_refs
        st.home = {mapping.get(p, p): h for p, h in st.home.items()}
        st.trie = {mapping.get(p, p) for p in st.trie}
    ops.append(("defrag()", _defrag))

    def _rebuild(st):
        st.alloc.rebuild(dict(st.refs))
    ops.append(("rebuild(ledger)", _rebuild))
    return ops


def explore(cfg: Optional[ModelConfig] = None,
            allocator_cls=None,
            defrag_mapping: Optional[Callable] = None,
            log: Optional[Callable[[str], None]] = None) -> List[Finding]:
    """BFS over op sequences up to ``cfg.depth``; returns findings whose
    detail is the minimal counterexample trace."""
    from repro_torch.core.placement import PlacementMap
    from repro_torch.serving import paged_cache as pc

    cfg = cfg or ModelConfig()
    allocator_cls = allocator_cls or pc.PageAllocator
    defrag_mapping = defrag_mapping or default_defrag_mapping
    src_file = None
    try:
        import inspect
        src_file = inspect.getsourcefile(allocator_cls)
    except (TypeError, OSError):
        pass

    placement = None
    if cfg.placed:
        placement = PlacementMap(cfg.num_pages, cfg.n_regions,
                                 communal_pages=cfg.communal_pages)
        root_alloc = allocator_cls(cfg.num_pages, placement=placement,
                                   policy=cfg.policy)
    else:
        root_alloc = allocator_cls(cfg.num_pages)
    root = _State(root_alloc, pc.PrefixIndex(), {}, set(), {})

    findings: List[Finding] = []
    t0 = time.time()
    seen = {root.key()}
    frontier = [root]
    n_states = 1

    def record(trace, msg):
        findings.append(Finding(
            PASS, "allocator-invariant", msg, file=src_file,
            detail="minimal op trace:\n" + "\n".join(
                f"  {i + 1}. {op}" for i, op in enumerate(trace))
            + f"\n  => {msg}"))

    for depth in range(cfg.depth):
        nxt: List[_State] = []
        for s in frontier:
            for label, apply_fn in _enabled_ops(s, cfg, placement):
                if len(findings) >= cfg.max_findings:
                    return findings
                child = s.clone()
                child.trace = s.trace + (label,)
                try:
                    if label == "defrag()":
                        apply_fn(child, defrag_mapping)
                    else:
                        apply_fn(child)
                except _Violation as v:
                    record(child.trace, str(v))
                    continue
                except Exception as e:          # unexpected crash
                    record(child.trace,
                           f"unexpected {type(e).__name__}: {e}")
                    continue
                bad = check_state(child, cfg, placement)
                if bad is not None:
                    record(child.trace, bad)
                    continue
                k = child.key()
                if k not in seen and n_states < cfg.max_states:
                    seen.add(k)
                    nxt.append(child)
                    n_states += 1
        frontier = nxt
        if not frontier:
            break
    if log is not None:
        log(f"allocator-model: explored {n_states} states to depth "
            f"{cfg.depth} in {time.time() - t0:.1f}s")
    return findings


class _Entry:
    """Minimal cache-bearing model stub: one layer, one KV head."""

    def cache_zeros(self, max_batch, max_seq, tp=1, device="cpu"):
        from repro_torch.models.transformer import KVCache
        kv = (1, max_batch, max_seq, 1, 2)
        return KVCache(torch.zeros(kv, device=device),
                       torch.zeros(kv, device=device),
                       torch.zeros((max_batch,), dtype=torch.int32,
                                   device=device))


def check_table_mirror(log: Optional[Callable[[str], None]] = None
                       ) -> List[Finding]:
    """Scripted drive of the real ``PagedCache`` device-table mirror (the
    tables ``_decode_paged_kernel`` routes and the paged flash-decode
    kernel reads).

    The ``(B, nblk)`` device block-table mirror is incrementally
    maintained (per-row refresh on alloc/extend/free, per-entry on
    copy-on-write forks) instead of rebuilt from the host tables every
    tick.  This check runs a short op sequence covering every mutation
    class — shared-prefix mapping, CoW fork, growth, free, defrag — and
    after each op asserts (a) the mirror equals a fresh rebuild
    (``mirror_consistent``) and (b) the hot-path ops kept the mirror
    alive instead of cheating by invalidating it (defrag alone may drop
    it: renumbering rewrites every row anyway).
    """
    import inspect
    from repro_torch.serving.paged_cache import PagedCache

    entry = _Entry()
    cache = PagedCache(entry, max_batch=3, max_seq=8, page_size=2,
                       num_pages=6, share=True, device="cpu")
    src_file = inspect.getsourcefile(PagedCache)
    findings: List[Finding] = []
    t0 = time.time()
    toks = np.arange(4, dtype=np.int64)

    # (label, op, must_keep_mirror_alive)
    script = [
        ("tables_device()", lambda: cache.tables_device(), True),
        ("alloc_slot(0, 4, tokens)",
         lambda: cache.alloc_slot(0, 4, tokens=toks), True),
        ("write_slot(0, cache1, 4)",
         lambda: cache.write_slot(0, entry.cache_zeros(1, 4), 4), True),
        ("alloc_slot(1, 4, tokens)   # maps shared prefix",
         lambda: cache.alloc_slot(1, 4, tokens=toks), True),
        ("cow_for_write(1, 0)        # forks shared page",
         lambda: cache.cow_for_write(1, 0), True),
        ("extend_slot(1, 6)", lambda: cache.extend_slot(1, 6), True),
        ("free_slot(0)", lambda: cache.free_slot(0), True),
        ("defrag()", lambda: cache.defrag(), False),
        ("tables_device()            # rebuild after defrag",
         lambda: cache.tables_device(), True),
        ("alloc_slot(2, 3)", lambda: cache.alloc_slot(2, 3), True),
    ]
    done: List[str] = []
    for label, op, keep_alive in script:
        try:
            op()
        except Exception as e:          # noqa: BLE001 — report, don't crash CI
            findings.append(Finding(
                PASS, "table-mirror",
                f"scripted op {label.split('#')[0].strip()} raised "
                f"{type(e).__name__}: {e}", file=src_file,
                detail="after ops:\n" + "\n".join(
                    f"  {i + 1}. {o}" for i, o in enumerate(done))))
            return findings
        done.append(label)
        if keep_alive and cache._tables_dev is None:
            findings.append(Finding(
                PASS, "table-mirror",
                f"{label.split('#')[0].strip()} dropped the device table "
                f"mirror — hot-path ops must refresh it in place, not "
                f"invalidate it", file=src_file,
                detail="op trace:\n" + "\n".join(
                    f"  {i + 1}. {o}" for i, o in enumerate(done))))
        if not cache.mirror_consistent():
            findings.append(Finding(
                PASS, "table-mirror",
                f"device table mirror diverged from host tables after "
                f"{label.split('#')[0].strip()}", file=src_file,
                detail="op trace:\n" + "\n".join(
                    f"  {i + 1}. {o}" for i, o in enumerate(done))))
    if log is not None:
        log(f"allocator-model: table-mirror script ({len(script)} ops) "
            f"in {time.time() - t0:.1f}s")
    return findings


def check_ship_integrity(cache_cls=None,
                         log: Optional[Callable[[str], None]] = None
                         ) -> List[Finding]:
    """The ship op (tier handoff), driven on two real ``PagedCache`` pools.

    A page shipment must leave BOTH allocators and BOTH prefix tries in
    a state indistinguishable from the request having prefilled on the
    destination: the source frees every exported page, the destination's
    refcount ledger balances, the shipped prefix coverage is
    re-registered in the destination trie (so a follow-up import of the
    same prefix dedups against it), and the device table mirrors stay
    consistent on both sides.
    """
    import inspect
    from repro_torch.serving.paged_cache import PagedCache

    cache_cls = cache_cls or PagedCache
    entry = _Entry()
    kw = dict(max_batch=3, max_seq=8, page_size=2, num_pages=6,
              share=True, device="cpu")
    src = cache_cls(entry, **kw)
    dst = cache_cls(entry, **kw)
    src_file = inspect.getsourcefile(cache_cls)
    findings: List[Finding] = []
    t0 = time.time()

    def bad(msg):
        findings.append(Finding(PASS, "ship-integrity", msg,
                                file=src_file))
        return findings

    toks = np.arange(6, dtype=np.int64)
    src.alloc_slot(0, 6, tokens=toks)
    src.write_slot(0, entry.cache_zeros(1, 6), 6)
    src.commit_prefix(0)
    ship = src.export_slot_pages(0, 6, tokens=toks, hops=1)
    if ship.n_pages != 3:
        return bad(f"export of 6 tokens at page_size=2 shipped "
                   f"{ship.n_pages} pages, expected 3")
    if ship.cost_s <= 0.0 or ship.bytes_on_wire <= 0:
        return bad("shipment is not priced: cost_s="
                   f"{ship.cost_s}, bytes={ship.bytes_on_wire}")
    if src.alloc.used_pages != 0 or src.alloc.free_pages != 6:
        return bad(f"source pool leaked after export: "
                   f"{src.alloc.used_pages} used, "
                   f"{src.alloc.free_pages} free (expected 0/6)")
    if not src.mirror_consistent():
        return bad("source device-table mirror diverged after export")
    if not dst.import_slot_pages(0, ship):
        return bad("import refused with an empty destination pool")
    if dst.alloc.used_pages != 3 or dst.alloc.free_pages != 3:
        return bad(f"destination ledger off after import: "
                   f"{dst.alloc.used_pages} used / "
                   f"{dst.alloc.free_pages} free (expected 3/3)")
    live = {p: dst.alloc.refcount(p) for p in dst.alloc.live_pages()}
    if any(rc != 1 for rc in live.values()):
        return bad(f"imported pages must arrive exclusive (refcount 1), "
                   f"got {live}")
    matched = dst.prefix.match(toks, 2)
    if len(matched) != 3:
        return bad(f"imported prefix coverage not re-registered in the "
                   f"destination trie: match found {len(matched)} of 3 "
                   f"pages — a same-prefix follow-up cannot dedup")
    if not dst.mirror_consistent():
        return bad("destination device-table mirror diverged after "
                   "import")
    # second shipment of the same prefix must dedup against the trie
    src.alloc_slot(0, 6, tokens=toks)
    src.write_slot(0, entry.cache_zeros(1, 6), 6)
    src.commit_prefix(0)
    ship2 = src.export_slot_pages(0, 6, tokens=toks, hops=1)
    if not dst.import_slot_pages(1, ship2):
        return bad("second import refused despite shared-prefix headroom")
    if dst.alloc.shared_pages != 3:
        return bad(f"same-prefix re-import shares "
                   f"{dst.alloc.shared_pages} pages, expected all 3 "
                   f"(trie dedup on import)")
    live = {p: dst.alloc.refcount(p) for p in dst.alloc.live_pages()}
    if sum(live.values()) != 6 or len(live) != 3:
        return bad(f"refcount ledger after dedup import should be 3 "
                   f"pages x refcount 2, got {live}")
    if not dst.mirror_consistent():
        return bad("destination mirror diverged after dedup import")
    dst.free_slot(0)
    dst.free_slot(1)
    if dst.alloc.used_pages != 0 or dst.prefix._by_page:
        return bad("freeing both imported slots leaked pages or trie "
                   f"entries: {dst.alloc.used_pages} used, trie "
                   f"{sorted(dst.prefix._by_page)}")
    if log is not None:
        log(f"allocator-model: ship-integrity script in "
            f"{time.time() - t0:.1f}s")
    return findings


def run(log: Optional[Callable[[str], None]] = None) -> List[Finding]:
    """Both scopes: placed (regions + communal + migration/defrag) and
    the legacy unplaced free-list; plus the scripted device-table-mirror
    and page-shipment drives over the real ``PagedCache``."""
    findings = explore(ModelConfig(), log=log)
    findings += explore(ModelConfig(num_pages=4, placed=False),
                        log=log)
    findings += check_table_mirror(log=log)
    findings += check_ship_integrity(log=log)
    return findings
