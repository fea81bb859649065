"""Paged (block-table) KV cache for the serving engine (port of
``repro.serving.paged_cache``, with refcounted prefix sharing,
copy-on-write, stack-aware placement and cross-pool page shipping).

Sequence-bearing cache leaves live in a pool of fixed-size pages and each
slot owns a block table mapping its logical context positions to pages,
so the KV memory a request holds is proportional to its context.

Layout: a sequence leaf ``(L, B, S, ...)`` becomes a pool
``(L, P+1, page, ...)``; page ``P`` is a scratch page, so writes routed
away from live data (inactive lanes, positions past a slot's window) and
reads of unmapped table entries never touch a live page.  Block tables
are a host ``(max_batch, max_blocks)`` int32 array with an incrementally
maintained device mirror.

With ``share=True`` a page-granular prompt-prefix trie
(:class:`PrefixIndex`) maps the leading prompt pages that are already
resident onto the existing pages (incref) at admission; a decode write
to a page with refcount > 1 first forks it (:meth:`PagedCache.fork_page`).

With a :class:`~repro_torch.core.placement.PlacementMap` the allocator
places pages by channel region of the near-memory substrate (a slot's
home region, a communal region for shared prompt pages), and every page
movement (spilled-page migration, defrag compaction) is priced on that
model through :meth:`PagedCache.transfer_pages`.

:meth:`PagedCache.export_slot_pages` packages a slot's pages as a
:class:`PageShipment` (the prefill tier's handoff) and
:meth:`PagedCache.import_slot_pages` splices one into another pool (the
decode tier's), written in place into that pool's existing pages.

The reference copies and donates its pools through jitted helpers; here
the pools are updated in place with indexed assignment (``index_put_``),
so no second pool is ever materialised.  A captured CUDA graph of the
fused decode holds the pools' addresses, so no operation here (defrag
and the CoW fork included) may ever move them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.gemm import ceil_div
from repro_torch.core.noc import CollectiveCost, page_ship
from repro_torch.core.placement import (COMMUNAL, PLACEMENT_POLICIES,
                                        GatherCost, PlacementMap,
                                        default_system, gather_cost)
from repro_torch.device import resolve
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving.replica_api import PlacementReport


#: every priced page movement goes through ``PagedCache.transfer_pages``
TRANSFER_KINDS = ("migrate", "defrag", "ship")


def num_blocks(n_tokens: int, page_size: int) -> int:
    return ceil_div(n_tokens, page_size)


# ---------------------------------------------------------------------------
# Cross-pool page shipment (prefill -> decode tier handoff)
# ---------------------------------------------------------------------------
@dataclass
class PageShipment:
    """A slot's KV pages packaged for transfer between two pools.

    Built by :meth:`PagedCache.export_slot_pages` (which also releases
    the slot at the source) and consumed by
    :meth:`PagedCache.import_slot_pages`:

    * ``seq_payload`` — per cache leaf, the gathered page block
      ``(L, n_pages, page, ...)`` for sequence leaves (``None`` for
      dense leaves), on the source's device;
    * ``slot_payload`` — per cache leaf, a copy of the slot column for
      dense leaves (recurrent state, lengths; ``None`` for sequence
      leaves);
    * ``tokens`` — the prompt, so the destination consults its own
      prefix trie and re-registers the coverage after import;
    * ``cost_s`` / ``bytes_on_wire`` — the priced cross-stack movement
      (:func:`~repro_torch.core.noc.page_ship`), charged once at export.

    The engine layer annotates ``req`` (the live request) and
    ``next_tok`` (the first decoded token, produced on the prefill tier).
    """

    n_tokens: int
    page_size: int
    n_pages: int
    tokens: Optional[np.ndarray]
    seq_payload: List[Optional[torch.Tensor]]
    slot_payload: List[Optional[torch.Tensor]]
    bytes_on_wire: int = 0
    cost_s: float = 0.0
    # engine-layer annotations (router handoff)
    req: Any = None
    next_tok: int = -1


# ---------------------------------------------------------------------------
# Host-side block allocator
# ---------------------------------------------------------------------------
class PageAllocator:
    """Refcounted free-list page allocator (host side).

    Pages are plain ints ``0..num_pages-1``.  ``alloc`` returns ``None``
    (allocating nothing) when the request cannot be satisfied — admission
    control, not an error.  Freshly allocated pages start at refcount 1;
    prefix sharing ``incref``s them when a second block table maps the same
    page, and ``decref``/``free`` return a page to the free list only when
    the last reference drops — no page is ever freed while its refcount is
    still positive.

    **Placement** (``placement`` + ``policy``): with a
    :class:`~repro_torch.core.placement.PlacementMap` the allocator places
    pages substrate-aware.  ``free-first`` keeps the legacy LIFO layout
    (wherever the free list points); ``affinity`` prefers the caller's
    ``home`` region (or the communal region for ``communal=True`` shared
    prefix pages), spilling to the emptiest other region only when the
    preferred one runs dry; ``interleave`` stripes pages round-robin
    across slot regions.  Placement only changes WHICH free pages are
    picked — success/failure depends solely on the global free count, so
    admission control (and therefore scheduling) is identical across
    policies.
    """

    def __init__(self, num_pages: int,
                 placement: Optional[PlacementMap] = None,
                 policy: str = "free-first"):
        if num_pages <= 0:
            raise ValueError("num_pages must be positive")
        if policy not in PLACEMENT_POLICIES:
            raise ValueError(f"unknown placement policy {policy!r}; "
                             f"choose from {PLACEMENT_POLICIES}")
        if placement is not None and placement.num_pages != num_pages:
            raise ValueError(
                f"placement map covers {placement.num_pages} pages, "
                f"allocator has {num_pages}")
        self.num_pages = num_pages
        self.placement = placement
        self.policy = policy
        self._rr = 0                    # interleave striping cursor
        self._refs: Dict[int, int] = {}
        self._init_free()

    def _init_free(self) -> None:
        if self.placed:
            # persistent per-region free lists (placed mode): descending
            # so pop() hands out each region's lowest index first — the
            # same LIFO invariant as the global list, at O(1) per page
            self._region_lists: Dict[int, List[int]] = {
                r: sorted(self.placement.region_pages(r), reverse=True)
                for r in self.placement.regions()}
            self._free: List[int] = []      # unused in placed mode
        else:
            self._free = list(range(self.num_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        if self.placed:
            return sum(len(v) for v in self._region_lists.values())
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._refs)

    @property
    def shared_pages(self) -> int:
        """Pages currently mapped by more than one block-table entry."""
        return sum(1 for rc in self._refs.values() if rc > 1)

    def live_pages(self) -> List[int]:
        return sorted(self._refs)

    def highest_used(self) -> int:
        """Highest allocated page index (-1 when empty)."""
        return max(self._refs, default=-1)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    # -- placement geometry ------------------------------------------------
    @property
    def placed(self) -> bool:
        """True when allocation actively steers placement (a map under a
        non-legacy policy)."""
        return self.placement is not None and self.policy != "free-first"

    def region_free(self) -> Dict[int, int]:
        """Free pages per region (requires a placement map)."""
        assert self.placement is not None
        if self.placed:
            return {r: len(v) for r, v in self._region_lists.items()}
        out = {r: 0 for r in self.placement.regions()}
        for p in self._free:
            out[self.placement.region_of(p)] += 1
        return out

    def region_used(self) -> Dict[int, int]:
        """Allocated pages per region (requires a placement map)."""
        assert self.placement is not None
        out = {r: 0 for r in self.placement.regions()}
        for p in self._refs:
            out[self.placement.region_of(p)] += 1
        return out

    def _select(self, n: int, home: Optional[int],
                n_communal: int) -> List[int]:
        """Pop ``n`` free pages off the per-region lists under the
        placement policy (caller has checked the global free count).
        The first ``n_communal`` picks prefer the communal region; the
        rest follow the policy.  O(1) per page."""
        pmap = self.placement
        lists = self._region_lists
        picks: List[int] = []

        def take_from(region: int, k: int) -> int:
            pool = lists.get(region, [])
            got = min(k, len(pool))
            for _ in range(got):
                picks.append(pool.pop())
            return got

        # shared (publishable) pages go communal under every placement
        # policy: all slots read them, so no slot channel is favored —
        # overflow falls through to the private-page policy below
        want = n - take_from(COMMUNAL, min(n_communal, n)) \
            if pmap.communal_pages else n
        if self.policy == "interleave":
            ring = list(range(pmap.n_regions))
            while want > 0:
                if not any(lists[r] for r in ring):
                    want -= take_from(COMMUNAL, want)   # only communal left
                    break
                r = ring[self._rr % len(ring)]
                self._rr += 1
                want -= take_from(r, min(1, want)) if lists[r] else 0
            return picks
        # affinity: home region first, then spill to the emptiest-used
        # (most-free) other regions, deterministic ties by region id
        order = [home] if home is not None else []
        order.extend(sorted(
            (r for r in pmap.regions() if r not in order),
            key=lambda r: (r == COMMUNAL, -len(lists[r]), r)))
        for r in order:
            want -= take_from(r, want)
            if want == 0:
                break
        return picks

    def alloc(self, n: int, *, home: Optional[int] = None,
              communal: int = 0) -> Optional[List[int]]:
        """Allocate ``n`` pages; ``home`` steers private pages and the
        first ``communal`` of them prefer the communal region (both
        ignored under the legacy free-first policy).  Atomic: returns
        ``None`` without mutating when fewer than ``n`` pages are free."""
        if n < 0:
            raise ValueError("alloc size must be >= 0")
        if n > self.free_pages:
            return None
        if not self.placed:
            pages = [self._free.pop() for _ in range(n)]
        else:
            pages = self._select(n, home, communal)
            assert len(pages) == n
        for p in pages:
            self._refs[p] = 1
        return pages

    def alloc_in(self, region: int, n: int = 1) -> Optional[List[int]]:
        """Allocate ``n`` pages strictly from ``region`` (placed mode
        only) — the page-migration primitive: unlike :meth:`alloc` it
        never spills, returning ``None`` when the region cannot satisfy
        the request in full.  Atomic."""
        assert self.placed, "alloc_in needs active placement"
        pool = self._region_lists.get(region, [])
        if n < 0:
            raise ValueError("alloc size must be >= 0")
        if len(pool) < n:
            return None
        pages = [pool.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def incref(self, page: int) -> None:
        if page not in self._refs:
            raise ValueError(f"incref of unallocated page {page}")
        self._refs[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; True iff the page was returned to the free
        list (refcount reached zero)."""
        rc = self._refs.get(page)
        if rc is None:
            raise ValueError(f"double free / foreign page {page}")
        if rc == 1:
            del self._refs[page]
            if self.placed:
                self._region_lists[self.placement.region_of(page)] \
                    .append(page)
            else:
                self._free.append(page)
            return True
        self._refs[page] = rc - 1
        return False

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page (frees those reaching zero)."""
        for p in pages:
            self.decref(p)

    def rebuild(self, refcounts: Dict[int, int]) -> None:
        """Reset the allocator to an explicit live set (defrag).

        ``refcounts`` maps live page id -> its refcount.  The free list is
        rebuilt in descending index order, so subsequent allocations hand
        out the lowest free indices first — the same LIFO invariant a
        freshly constructed allocator starts with; in placed mode each
        region's list is rebuilt the same way.
        """
        for p, rc in refcounts.items():
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} out of range")
            if rc <= 0:
                raise ValueError(f"page {p} has non-positive refcount {rc}")
        self._refs = dict(refcounts)
        if self.placed:
            self._region_lists = {
                r: [p for p in sorted(self.placement.region_pages(r),
                                      reverse=True)
                    if p not in self._refs]
                for r in self.placement.regions()}
        else:
            self._free = [p for p in range(self.num_pages - 1, -1, -1)
                          if p not in self._refs]

    def reset(self) -> None:
        self._refs.clear()
        self._rr = 0
        self._init_free()


# ---------------------------------------------------------------------------
# Host-side prompt-prefix trie (page-granular; a copy of the reference's)
# ---------------------------------------------------------------------------
class _TrieNode:
    __slots__ = ("children", "partial")

    def __init__(self):
        # full-page token chunk -> (page id, subtree)
        self.children: Dict[bytes, Tuple[int, "_TrieNode"]] = {}
        # trailing sub-page token chunk -> page id
        self.partial: Dict[bytes, int] = {}


def _chunk_key(tokens: np.ndarray) -> bytes:
    # canonical dtype so int32 prompts and int64 literals key identically
    return np.ascontiguousarray(tokens, dtype=np.int64).tobytes()


class PrefixIndex:
    """Page-granular prompt-prefix trie (host side).

    Each edge keys one full page of prompt tokens (raw token bytes: exact
    matching, no hash collisions) and carries the physical page holding
    that chunk's KV.  A node's ``partial`` table maps a trailing sub-page
    chunk to its page, which lets two requests with *identical* prompts
    share the ragged tail page: the case that exercises copy-on-write,
    since both holders decode-write into that page.

    Entries are registered only after the page contents are written
    (``PagedCache.commit_prefix``) and dropped when the page's last
    reference is released, so a hit always points at live, fully written
    prompt KV.  CoW forks and decode growth pages are never registered.
    """

    def __init__(self):
        self.root = _TrieNode()
        # page -> (owning node, edge key, is_partial) for O(1) removal and
        # defrag renumbering
        self._by_page: Dict[int, Tuple[_TrieNode, bytes, bool]] = {}

    def __len__(self) -> int:
        return len(self._by_page)

    def match(self, tokens: np.ndarray, page_size: int) -> List[int]:
        """Longest shared prefix of ``tokens`` in whole pages, plus the
        ragged tail page when the remainder matches exactly."""
        node, pages = self.root, []
        k = len(tokens) // page_size
        for i in range(k):
            hit = node.children.get(
                _chunk_key(tokens[i * page_size:(i + 1) * page_size]))
            if hit is None:
                return pages
            pages.append(hit[0])
            node = hit[1]
        tail = tokens[k * page_size:]
        if len(tail):
            page = node.partial.get(_chunk_key(tail))
            if page is not None:
                pages.append(page)
        return pages

    def register(self, tokens: np.ndarray, pages: Sequence[int],
                 page_size: int) -> None:
        """Publish ``pages`` (page-chunked KV of ``tokens``) for reuse.
        First writer wins: chunks already present keep their page (the
        caller's duplicate stays private); missing chunks are inserted
        with the caller's page."""
        node = self.root
        k = len(tokens) // page_size
        for i in range(k):
            key = _chunk_key(tokens[i * page_size:(i + 1) * page_size])
            hit = node.children.get(key)
            if hit is None:
                child = _TrieNode()
                node.children[key] = (pages[i], child)
                self._by_page[pages[i]] = (node, key, False)
                node = child
            else:
                node = hit[1]
        tail = tokens[k * page_size:]
        if len(tail) and k < len(pages):
            key = _chunk_key(tail)
            if key not in node.partial:
                node.partial[key] = pages[k]
                self._by_page[pages[k]] = (node, key, True)

    def remove(self, page: int) -> None:
        """Forget a freed page.  Children of a removed full-page edge
        become unreachable, which is safe: any request mapping a child
        chunk also held a reference on this page, so the chain dies
        together."""
        info = self._by_page.pop(page, None)
        if info is None:
            return
        node, key, is_partial = info
        if is_partial:
            node.partial.pop(key, None)
        else:
            node.children.pop(key, None)

    def remap(self, mapping: Dict[int, int]) -> None:
        """Apply a defrag old->new page renumbering in place."""
        by_page = {}
        for old, (node, key, is_partial) in self._by_page.items():
            new = mapping.get(old, old)
            if is_partial:
                node.partial[key] = new
            else:
                node.children[key] = (new, node.children[key][1])
            by_page[new] = (node, key, is_partial)
        self._by_page = by_page


# ---------------------------------------------------------------------------
# Shape probing: which leaves page
# ---------------------------------------------------------------------------
SEQ_AXIS = 2    # engine batch-axis rule: (L, B, S, ...) for seq leaves


def probe_seq_leaves(entry, max_batch: int, tp: int = 1) -> List[bool]:
    """True per cache leaf iff its shape depends on ``max_seq`` (probed on
    the meta device at two ``max_seq`` values)."""
    la = entry.cache_zeros(max_batch, 16, tp, device="meta")
    lb = entry.cache_zeros(max_batch, 32, tp, device="meta")
    out = []
    for a, b in zip(la, lb):
        if a.shape == b.shape:
            out.append(False)
            continue
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                if x != y]
        if diff != [SEQ_AXIS]:
            raise ValueError(
                f"seq leaf with unsupported layout {tuple(a.shape)} vs "
                f"{tuple(b.shape)}: expected the seq axis at {SEQ_AXIS}")
        out.append(True)
    return out


# ---------------------------------------------------------------------------
# Device-side paged cache
# ---------------------------------------------------------------------------
@dataclass
class PagedCache:
    """Page pools + block tables for one engine instance.

    ``store`` lists the cache leaves with every sequence leaf replaced by
    its pool ``(L, P+1, page, ...)``; the ``lengths`` leaf keeps its dense
    slot layout.  ``max_seq`` is rounded up to a whole number of pages.
    ``share`` turns on refcounted prompt-prefix sharing with
    copy-on-write; ``placement`` / ``placement_policy`` steer which
    pages the allocator picks.
    """
    entry: Any
    max_batch: int
    max_seq: int
    page_size: int
    num_pages: int
    tp: int = 1
    share: bool = False
    placement: Optional[PlacementMap] = None
    placement_policy: str = "free-first"
    device: Any = "cuda"

    def __post_init__(self):
        if self.page_size <= 0:
            raise ValueError(f"page_size must be positive, "
                             f"got {self.page_size}")
        self.device = resolve(self.device)
        if self.max_seq % self.page_size:
            self.max_seq = num_blocks(self.max_seq,
                                      self.page_size) * self.page_size
        self.max_blocks = self.max_seq // self.page_size
        self.alloc = PageAllocator(self.num_pages,
                                   placement=self.placement,
                                   policy=self.placement_policy)
        # per-slot home region (affinity placement)
        self.home_region: Dict[int, int] = {}
        self.tables = np.full((self.max_batch, self.max_blocks), -1,
                              np.int32)
        self._tables_dev: Optional[torch.Tensor] = None
        dense = self.entry.cache_zeros(self.max_batch, self.page_size,
                                       self.tp, device=self.device)
        self._cache_type = type(dense)
        self.is_seq = probe_seq_leaves(self.entry, self.max_batch, self.tp)
        store = []
        for leaf, seq in zip(dense, self.is_seq):
            if seq:
                # (L, B, page, ...) -> (L, P+1, page, ...): drop the batch
                # axis, add the page axis (+1 scratch page at index P)
                shape = (leaf.shape[0], self.num_pages + 1,
                         self.page_size) + tuple(leaf.shape[3:])
                store.append(torch.zeros(shape, dtype=leaf.dtype,
                                         device=self.device))
            else:
                store.append(leaf)
        self.store = store
        self.has_seq = any(self.is_seq)
        self.prefix = PrefixIndex() if self.share else None
        # leading table entries mapped onto shared pages at admission:
        # write_slot and scatter_chunk never write them (their KV is
        # already resident and other holders read it)
        self.shared_count = np.zeros((self.max_batch,), np.int64)
        self._pending_prompt: Dict[int, np.ndarray] = {}
        self.cow_forks = 0
        # pages extend_slot mapped for decode growth
        self.grown_pages = 0
        # cross-region home migration (defrag's spilled-page repair pass)
        self.migrated_pages = 0
        self.migration_cost_s = 0.0
        # in-pool compaction moves (defrag) and cross-pool shipments
        # (tier handoff), all priced through transfer_pages
        self.defrag_move_cost_s = 0.0
        self.shipped_pages = 0
        self.ship_cost_s = 0.0
        self._bytes_per_page: Optional[int] = None
        # lifecycle-event sink; the engine rebinds it to its own tracer
        self.tracer = NULL_TRACER

    # -- block-table bookkeeping -------------------------------------------
    def _host_row(self, slot: int) -> np.ndarray:
        """One slot's table row with unmapped entries -> scratch page P."""
        return np.where(self.tables[slot] < 0, self.num_pages,
                        self.tables[slot]).astype(np.int32)

    def tables_device(self) -> torch.Tensor:
        if self._tables_dev is None:
            t = np.where(self.tables < 0, self.num_pages, self.tables)
            self._tables_dev = torch.as_tensor(
                t.astype(np.int32)).to(self.device)
        return self._tables_dev

    def _mirror_row(self, slot: int) -> None:
        """Refresh one slot's row of the device mirror in place (the hot
        ops touch a single row; only defrag rebuilds the whole table)."""
        if self._tables_dev is None:
            return
        self._tables_dev[slot] = torch.as_tensor(
            self._host_row(slot)).to(self.device)

    def _mirror_set(self, slot: int, blk: int, page: int) -> None:
        """Point one mirror entry at a new physical page (CoW fork)."""
        if self._tables_dev is None:
            return
        self._tables_dev[slot, blk] = page

    def mirror_consistent(self) -> bool:
        """True iff the device mirror equals a fresh rebuild of the host
        tables (an unbuilt mirror is trivially consistent)."""
        if self._tables_dev is None:
            return True
        ref = np.where(self.tables < 0, self.num_pages, self.tables)
        return bool(np.array_equal(self._tables_dev.cpu().numpy(), ref))

    def blocks_of(self, slot: int) -> List[int]:
        return [int(p) for p in self.tables[slot] if p >= 0]

    def pages_in_use(self) -> int:
        return self.alloc.used_pages

    def kv_tokens_resident(self) -> int:
        """Capacity (in tokens) of all allocated pages."""
        return self.alloc.used_pages * self.page_size

    def logical_pages(self) -> int:
        """Block-table entries mapped across all slots."""
        return int((self.tables >= 0).sum())

    def fragmentation(self) -> float:
        """Fraction of holes below the high-water page index (0 = the live
        set is compact at the lowest indices).  With a placement map the
        high-water mark is per region: affinity spreads slots across
        regions on purpose, which is placement, not fragmentation."""
        used = self.alloc.used_pages
        if used == 0:
            return 0.0
        if self.placement is None:
            return 1.0 - used / (self.alloc.highest_used() + 1)
        pmap = self.placement
        high: Dict[int, int] = {}       # region -> high-water page
        for p in self.alloc.live_pages():
            r = pmap.region_of(p)
            high[r] = max(high.get(r, p), p)
        span = sum(hw - pmap.region_pages(r).start + 1
                   for r, hw in high.items())
        return 1.0 - used / span if span else 0.0

    def sharing_report(self) -> Dict[str, Any]:
        logical = self.logical_pages()
        physical = self.alloc.used_pages
        return {"logical_pages": logical,
                "physical_pages": physical,
                "shared_pages": self.alloc.shared_pages,
                "dedup_ratio": logical / physical if physical else 1.0,
                "cow_forks": self.cow_forks}

    def prefix_residency(self, tokens: Optional[np.ndarray]) -> int:
        """Leading prompt pages of ``tokens`` already resident in the
        prefix trie (the router's prefix-affinity probe): what admission
        would map, full pages plus an exact-match ragged tail; 0 when
        sharing is off."""
        if (not self.share or not self.has_seq or tokens is None
                or not len(tokens)):
            return 0
        return len(self.prefix.match(np.asarray(tokens), self.page_size))

    def alloc_slot(self, slot: int, n_tokens: int,
                   tokens: Optional[np.ndarray] = None) -> bool:
        """Allocate pages to cover ``n_tokens`` for an empty slot.

        With ``share`` and the prompt ``tokens`` given, the leading pages
        whose token chunks are already resident are mapped onto the
        existing pages (incref) and only the rest is allocated.  The new
        pages reach the trie at ``commit_prefix``, once their KV is
        written.  Atomic: on failure nothing is mapped, incref'd or
        allocated."""
        if not self.has_seq:
            return True
        assert not self.blocks_of(slot), "slot already mapped"
        need = num_blocks(n_tokens, self.page_size)
        shared: List[int] = []
        if self.share and tokens is not None and len(tokens):
            shared = self.prefix.match(np.asarray(tokens), self.page_size)
        home = self._assign_home(slot)
        # full prompt pages are publishable as trie edges, so they go
        # communal (every later holder reads them); the ragged tail and
        # the decode pages are private and go to the home region
        n_communal = 0
        if self.share and tokens is not None:
            n_communal = max(0, len(tokens) // self.page_size
                             - len(shared))
        fresh = self.alloc.alloc(need - len(shared), home=home,
                                 communal=n_communal)
        if fresh is None:
            return False
        for p in shared:
            self.alloc.incref(p)
        pages = shared + fresh
        self.tables[slot, : len(pages)] = pages
        self.shared_count[slot] = len(shared)
        if self.share and tokens is not None:
            self._pending_prompt[slot] = np.asarray(tokens).copy()
        self._mirror_row(slot)
        return True

    def _assign_home(self, slot: int) -> Optional[int]:
        """Pick (and remember) the slot's home region: the slot region
        with the most free pages at admission, ties to the lowest id.
        None without active placement."""
        if not self.alloc.placed:
            return None
        free = self.alloc.region_free()
        home = min((r for r in free if r != COMMUNAL),
                   key=lambda r: (-free[r], r))
        self.home_region[slot] = home
        return home

    def extend_slot(self, slot: int, n_tokens: int) -> bool:
        """Grow a slot's mapping to cover ``n_tokens`` total (on-demand
        decode growth).  Growth pages are private to the slot, so they
        prefer its home region.  No-op if already covered."""
        if not self.has_seq:
            return True
        have = len(self.blocks_of(slot))
        need = num_blocks(n_tokens, self.page_size)
        if need <= have:
            return True
        if need > self.max_blocks:
            return False
        pages = self.alloc.alloc(need - have,
                                 home=self.home_region.get(slot))
        if pages is None:
            return False
        self.tables[slot, have:need] = pages
        self.grown_pages += need - have
        self._mirror_row(slot)
        return True

    def free_slot(self, slot: int) -> None:
        for p in self.blocks_of(slot):
            if self.alloc.decref(p) and self.prefix is not None:
                self.prefix.remove(p)
        self.tables[slot, :] = -1
        self.shared_count[slot] = 0
        self._pending_prompt.pop(slot, None)
        self.home_region.pop(slot, None)
        self._mirror_row(slot)

    # -- copy-on-write -----------------------------------------------------
    def cow_for_write(self, slot: int, pos: int) -> bool:
        """Make the page a write at ``pos`` will hit exclusively owned.

        Forks the page when its refcount is > 1; False only when the fork
        could not allocate a page (the caller preempts and retries).  A
        no-op for unmapped or out-of-window targets (those land in the
        scratch page) and for pages already exclusive.
        """
        if not self.has_seq:
            return True
        blk = pos // self.page_size
        if blk >= self.max_blocks:
            return True
        page = int(self.tables[slot, blk])
        if page < 0 or self.alloc.refcount(page) <= 1:
            return True
        return self.fork_page(slot, blk)

    def fork_page(self, slot: int, blk: int) -> bool:
        """Copy-on-write fork: give ``slot`` a private copy of the page at
        table entry ``blk``; the original page (and its trie entry) stays
        for the other holders.  The copy runs in place on the existing
        pools (a captured CUDA graph holds their addresses)."""
        old = int(self.tables[slot, blk])
        assert old >= 0, "fork of unmapped table entry"
        # the fork is a private copy: it belongs in the slot's home region
        got = self.alloc.alloc(1, home=self.home_region.get(slot))
        if got is None:
            return False
        new = got[0]
        for pool, seq in zip(self.store, self.is_seq):
            if seq:
                pool[:, new].copy_(pool[:, old])
        self.tables[slot, blk] = new
        if blk < self.shared_count[slot]:
            self.shared_count[slot] = blk
        if self.alloc.decref(old) and self.prefix is not None:
            # cow_for_write forks only at refcount > 1, so the old page
            # keeps a holder; kept as the reference keeps it
            self.prefix.remove(old)
        self.cow_forks += 1
        if self.tracer.enabled:
            self.tracer.emit("cow_fork", slot=slot, blk=blk, old_page=old,
                             new_page=new)
        self._mirror_set(slot, blk, new)
        return True

    # -- device ops (all pool writes are in place) ---------------------------
    def _cache(self, leaves) -> Any:
        return self._cache_type(*leaves)

    def gather(self) -> Any:
        """Assemble the dense ``(L, B, max_seq, ...)`` cache view that the
        plain decode path runs ``decode_step`` on."""
        tables = self.tables_device().long()
        return self._cache([_gather_pool(leaf, tables) if seq else leaf
                            for leaf, seq in zip(self.store, self.is_seq)])

    def scatter_token(self, cache: Any, positions: np.ndarray,
                      active: np.ndarray) -> None:
        """Write back one decode step from the dense view ``cache`` that
        ``decode_step`` returned: each slot's new token sits at
        ``positions[b]`` (the pre-step length).  Inactive slots and
        writes past a slot's mapped window land in the scratch page; the
        non-sequence leaves (lengths) are replaced wholesale."""
        tables = self.tables_device().long()
        pos = torch.as_tensor(np.where(active, positions, 0)
                              .astype(np.int64)).to(self.device)
        act = torch.as_tensor(np.asarray(active, bool)).to(self.device)
        new_store = []
        for pool, leaf, seq in zip(self.store, cache, self.is_seq):
            if seq:
                _scatter_token(pool, leaf, tables, pos, act, self.page_size)
                new_store.append(pool)
            else:
                new_store.append(leaf)
        self.store = new_store

    def write_slot(self, slot: int, cache1: Any, n_tokens: int) -> None:
        """Insert a freshly prefilled request (batch-1 cache) into ``slot``:
        sequence leaves are chopped into pages and written to the slot's
        block table, skipping the pages mapped from the prefix trie (their
        KV is resident and other holders read it); the lengths leaf is
        written to the slot column.  The slot's prompt pages are then
        published to the trie."""
        pages = self.blocks_of(slot)
        need = num_blocks(n_tokens, self.page_size)
        skip = int(self.shared_count[slot])
        if self.has_seq:
            assert len(pages) >= need, \
                "write_slot without enough pages mapped"
        idx = torch.as_tensor(pages[skip:need], dtype=torch.long).to(
            self.device)
        for pool, leaf, seq in zip(self.store, cache1, self.is_seq):
            if seq:
                if skip < need:
                    _write_pages(pool, leaf, idx, skip, need,
                                 self.page_size)
            else:
                _set_slot(pool, leaf, slot)
        self.commit_prefix(slot)

    # -- direct chunked prefill (no dense staging buffer) ------------------
    def gather_slot(self, slot: int, pos: int) -> Any:
        """A batch-1 dense cache view of one slot's block-table window for
        an ``extend_step`` chunk at offset ``pos``.  Unmapped entries read
        the scratch page (the causal mask blanks everything past the
        chunk); the lengths leaf is pinned to ``pos``."""
        row = torch.as_tensor(self._host_row(slot)[None, :],
                              dtype=torch.long).to(self.device)
        out = []
        for leaf, seq in zip(self.store, self.is_seq):
            if seq:
                out.append(_gather_pool(leaf, row))
            elif leaf.ndim == 1:
                out.append(torch.full((1,), pos, dtype=leaf.dtype,
                                      device=self.device))
            else:
                out.append(leaf[:, slot: slot + 1])
        return self._cache(out)

    def scatter_chunk(self, slot: int, cache1: Any, pos: int,
                      take: int) -> None:
        """Write one prefill chunk (``take`` tokens at offset ``pos``)
        from the batch-1 view ``extend_step`` returned straight into the
        slot's pages; the lengths leaf goes to the slot column.  Positions
        inside shared-prefix pages go to the scratch page: their KV is
        resident and other holders read it, and this request's recompute
        (the exact-tail case) differs from it in the last bits."""
        ps = self.page_size
        idx = np.arange(pos, pos + take)
        row = self.tables[slot]
        blk = idx // ps
        assert (row[blk] >= 0).all(), "scatter_chunk into unmapped pages"
        dest = np.where(blk < int(self.shared_count[slot]), self.num_pages,
                        row[blk])
        pages = torch.as_tensor(dest.astype(np.int64)).to(self.device)
        offs = torch.as_tensor((idx % ps).astype(np.int64)).to(self.device)
        for pool, leaf, seq in zip(self.store, cache1, self.is_seq):
            if seq:
                pool[:, pages, offs] = leaf[:, 0, pos:pos + take]
            else:
                _set_slot(pool, leaf, slot)

    def commit_prefix(self, slot: int) -> None:
        """Publish the slot's prompt pages now that their KV is written."""
        tokens = self._pending_prompt.pop(slot, None)
        if tokens is None or self.prefix is None:
            return
        covered = num_blocks(len(tokens), self.page_size)
        self.prefix.register(tokens, self.blocks_of(slot)[:covered],
                             self.page_size)

    # -- priced page movement (the one code path) --------------------------
    def transfer_pages(self, n_pages: int, *, sys=None, hops: int = 0,
                       kind: str = "migrate") -> CollectiveCost:
        """Price (and account) the movement of ``n_pages`` physical pages.

        Every page movement in the cache goes through here, costed by
        :func:`~repro_torch.core.noc.page_ship` on ``sys`` (the default
        system when None): spilled-page re-homing (``kind="migrate"``,
        ``hops=0``), defrag compaction moves (``kind="defrag"``,
        ``hops=0``) and cross-stack tier handoffs (``kind="ship"``,
        ``hops>=1``, from :meth:`export_slot_pages`).  Accumulates the
        matching counters and emits the ``migrate`` event; ``defrag``
        emits its own."""
        if kind not in TRANSFER_KINDS:
            raise ValueError(f"unknown transfer kind {kind!r}; "
                             f"choose from {TRANSFER_KINDS}")
        if n_pages <= 0:
            return CollectiveCost(0, 0.0)
        cost = page_ship(sys if sys is not None else default_system(),
                         n_pages * self.bytes_per_page(), n_pages,
                         hops=hops)
        if kind == "migrate":
            self.migrated_pages += n_pages
            self.migration_cost_s += cost.time_s
            if self.tracer.enabled:
                self.tracer.emit("migrate", pages=n_pages,
                                 cost_s=cost.time_s)
        elif kind == "defrag":
            self.defrag_move_cost_s += cost.time_s
        else:
            self.shipped_pages += n_pages
            self.ship_cost_s += cost.time_s
        return cost

    def migrate_spilled(self, sys=None) -> int:
        """Move exclusively owned pages that spilled out of their slot's
        home region back home (placed mode only).

        Under pressure ``alloc`` spills to a foreign region rather than
        fail admission; once the pool relaxes, each spilled page whose
        home region has room again is copied home, priced through
        :meth:`transfer_pages` (``hops=0``).  The copy runs in place on
        the existing pools (a captured CUDA graph holds their
        addresses), and the device table is rebuilt at its next use.
        Shared pages (refcount > 1) and trie-registered pages stay put.
        Returns the number of pages moved.
        """
        if not (self.has_seq and self.alloc.placed):
            return 0
        moved = 0
        for slot, home in sorted(self.home_region.items()):
            for blk in range(self.max_blocks):
                page = int(self.tables[slot, blk])
                if (page < 0 or self.alloc.refcount(page) != 1
                        or self.placement.region_of(page) == home):
                    continue
                if self.prefix is not None \
                        and page in self.prefix._by_page:
                    continue
                got = self.alloc.alloc_in(home, 1)
                if got is None:
                    break                    # home is full again
                new = got[0]
                for pool, seq in zip(self.store, self.is_seq):
                    if seq:
                        pool[:, new].copy_(pool[:, page])
                self.tables[slot, blk] = new
                self.alloc.decref(page)
                moved += 1
        if moved:
            self.transfer_pages(moved, sys=sys, hops=0, kind="migrate")
            self._tables_dev = None
        return moved

    def defrag(self, sys=None) -> Dict[int, int]:
        """Compact live pages to the lowest indices.

        Returns the old->new mapping applied.  Pool data is permuted on
        device, in place (each pool keeps its storage); block tables, the
        prefix trie and the allocator (refcounts preserved) are
        renumbered, so the logical contents (``gather()``) are unchanged.
        The moved pages are priced on ``sys`` through
        :meth:`transfer_pages` (``kind="defrag"``).

        With a placement map, compaction is region-preserving: each
        region's live pages compact to that region's lowest indices and
        never cross regions.  Under an active policy a
        :meth:`migrate_spilled` pass runs first, so a slot squeezed
        during a pressure spike is not left spread across regions.
        """
        if self.alloc.placed:
            self.migrate_spilled(sys)
        live = self.alloc.live_pages()
        if self.placement is None:
            mapping = {old: new for new, old in enumerate(live)}
        else:
            mapping = {}
            for r in self.placement.regions():
                live_r = [p for p in live
                          if self.placement.region_of(p) == r]
                for p, tgt in zip(live_r, self.placement.region_pages(r)):
                    mapping[p] = tgt
            assert all(self.placement.region_of(o)
                       == self.placement.region_of(n)
                       for o, n in mapping.items()), \
                "defrag target crossed a placement region"
        if all(o == n for o, n in mapping.items()):
            return mapping
        perm = np.arange(self.num_pages + 1)
        for old, new in mapping.items():
            perm[new] = old
        perm_dev = torch.as_tensor(perm, dtype=torch.long).to(self.device)
        # permute in place: a captured CUDA graph of the fused decode
        # holds the pools' addresses, so their storage must never move
        for pool, seq in zip(self.store, self.is_seq):
            if seq:
                pool.copy_(pool[:, perm_dev])
        lut = np.full(self.num_pages + 1, -1, np.int32)
        for old, new in mapping.items():
            lut[old] = new
        self.tables = np.where(self.tables < 0, -1,
                               lut[np.maximum(self.tables, 0)]
                               ).astype(np.int32)
        self.alloc.rebuild({mapping[p]: self.alloc.refcount(p)
                            for p in live})
        moved_n = sum(1 for o, n in mapping.items() if o != n)
        cost = self.transfer_pages(moved_n, sys=sys, hops=0,
                                   kind="defrag")
        if self.tracer.enabled:
            self.tracer.emit("defrag", live_pages=len(live),
                             moved=moved_n, cost_s=cost.time_s)
        if self.prefix is not None:
            self.prefix.remap(mapping)
            # every registered page is still allocated after renumbering
            assert all(self.alloc.refcount(p) > 0
                       for p in self.prefix._by_page), \
                "defrag left the prefix trie pointing at a dead page"
        self._tables_dev = None
        return mapping

    # -- cross-pool shipment (prefill -> decode tier) ----------------------
    def export_slot_pages(self, slot: int, n_tokens: int,
                          tokens: Optional[np.ndarray] = None, *,
                          sys=None, hops: int = 1) -> PageShipment:
        """Package ``slot``'s resident state for another pool and release
        the slot here.

        Sequence leaves gather the slot's first ``ceil(n_tokens / page)``
        pages into a contiguous ``(L, n, page, ...)`` block on the device
        (shared-prefix pages included: the destination decides what it
        can dedup against its own trie); dense leaves copy the slot
        column.  The movement is priced once, here, through
        :meth:`transfer_pages` (``kind="ship"``).  The slot is then freed
        as a finished request's would be: shared pages survive under
        their other holders' references."""
        pages = self.blocks_of(slot)
        if self.has_seq:
            need = num_blocks(n_tokens, self.page_size)
            assert len(pages) >= need, \
                "export_slot_pages of an under-mapped slot"
            pages = pages[:need]
        idx = torch.as_tensor(pages, dtype=torch.long).to(self.device)
        seq_payload: List[Optional[torch.Tensor]] = []
        slot_payload: List[Optional[torch.Tensor]] = []
        for pool, seq in zip(self.store, self.is_seq):
            if seq:
                seq_payload.append(pool.index_select(1, idx)
                                   if pages else None)
                slot_payload.append(None)
            else:
                seq_payload.append(None)
                # a copy: the source slot's column is reused in place
                slot_payload.append((pool[slot] if pool.ndim == 1
                                     else pool[:, slot]).clone())
        cost = self.transfer_pages(len(pages), sys=sys, hops=hops,
                                   kind="ship")
        shipment = PageShipment(
            n_tokens=n_tokens, page_size=self.page_size,
            n_pages=len(pages),
            tokens=(np.asarray(tokens).copy()
                    if tokens is not None else None),
            seq_payload=seq_payload, slot_payload=slot_payload,
            bytes_on_wire=cost.bytes_on_wire, cost_s=cost.time_s)
        self.free_slot(slot)
        return shipment

    def import_slot_pages(self, slot: int,
                          shipment: PageShipment) -> bool:
        """Splice a :class:`PageShipment` into an empty ``slot`` here.

        The destination's own prefix trie is consulted first: leading
        prompt pages already resident are mapped (incref) instead of
        re-written, as a local admission would dedup; only the unshared
        tail pages allocate (home region, communal steering for
        publishable full prompt pages) and receive the payload.  The
        coverage is then registered in this trie.  The payload is copied
        into the existing pools in place (``index_copy_`` on the page
        axis; a captured CUDA graph holds the pools' addresses), and the
        dense leaves' slot columns are written into the tensors the next
        step reads.  Atomic: returns ``False`` with nothing mapped,
        incref'd or written when the pool cannot hold the unshared
        pages."""
        if shipment.page_size != self.page_size:
            raise ValueError(
                f"shipment page_size {shipment.page_size} != pool "
                f"page_size {self.page_size} (tiers must agree)")
        if not self.has_seq:
            self._import_dense(slot, shipment)
            return True
        assert not self.blocks_of(slot), "import into a mapped slot"
        need = shipment.n_pages
        tokens = shipment.tokens
        shared: List[int] = []
        if self.share and tokens is not None and len(tokens):
            shared = self.prefix.match(np.asarray(tokens),
                                       self.page_size)[:need]
        home = self._assign_home(slot)
        n_communal = 0
        if self.share and tokens is not None:
            n_communal = max(0, len(tokens) // self.page_size
                             - len(shared))
        fresh = self.alloc.alloc(need - len(shared), home=home,
                                 communal=n_communal)
        if fresh is None:
            self.home_region.pop(slot, None)
            return False
        for p in shared:
            self.alloc.incref(p)
        self.tables[slot, :need] = shared + fresh
        self.shared_count[slot] = len(shared)
        dst_idx = torch.as_tensor(fresh, dtype=torch.long).to(self.device)
        for pool, seq, payload, col in zip(self.store, self.is_seq,
                                           shipment.seq_payload,
                                           shipment.slot_payload):
            if seq:
                if fresh:
                    # the unshared tail of the payload (a view), straight
                    # into the fresh pages
                    pool.index_copy_(1, dst_idx,
                                     payload[:, len(shared):need].to(
                                         pool.device))
            else:
                _set_col(pool, col, slot)
        if self.share and tokens is not None:
            self._pending_prompt[slot] = np.asarray(tokens).copy()
            self.commit_prefix(slot)
        self._mirror_row(slot)
        return True

    def _import_dense(self, slot: int, shipment: PageShipment) -> None:
        """Recurrent families: no pages, only the slot columns (in place,
        into the tensors the next step reads)."""
        for pool, col in zip(self.store, shipment.slot_payload):
            _set_col(pool, col, slot)

    # -- placement scoring -------------------------------------------------
    def bytes_per_page(self) -> int:
        """Bytes one physical page holds across all paged leaves and
        layers (the per-page gather payload); cached, since the pool
        shapes are fixed at construction."""
        if self._bytes_per_page is None:
            self._bytes_per_page = sum(
                int(np.prod([d for i, d in enumerate(pool.shape)
                             if i != 1])) * pool.element_size()
                for pool, seq in zip(self.store, self.is_seq) if seq)
        return self._bytes_per_page

    def slot_region_counts(self, slot: int) -> Dict[int, int]:
        """Region histogram of the slot's mapped pages (requires a
        placement map)."""
        assert self.placement is not None
        counts: Dict[int, int] = {}
        for p in self.blocks_of(slot):
            r = self.placement.region_of(p)
            counts[r] = counts.get(r, 0) + 1
        return counts

    def gather_cost_slot(self, sys, slot: int) -> Optional[GatherCost]:
        """DMA/NoC cost of this slot's block-table gather on ``sys``
        (None when the slot has no pages mapped), scored from the
        majority region."""
        if self.placement is None or not self.blocks_of(slot):
            return None
        counts = self.slot_region_counts(slot)
        return gather_cost(sys, counts, self.bytes_per_page())

    def gather_cost_mean(self, sys, slots: Optional[Sequence[int]] = None
                         ) -> Tuple[float, float]:
        """Mean (gather time, home-channel concentration) over the given
        slots (default: every slot with pages mapped)."""
        if slots is None:
            slots = [s for s in range(self.max_batch) if self.blocks_of(s)]
        costs = [c for c in (self.gather_cost_slot(sys, s) for s in slots)
                 if c is not None]
        if not costs:
            return 0.0, 1.0
        return (float(np.mean([c.time_s for c in costs])),
                float(np.mean([c.concentration for c in costs])))

    def placement_report(self) -> PlacementReport:
        """Per-region pressure snapshot; empty without a placement map
        (``to_dict()`` is then ``{}``)."""
        if self.placement is None:
            return PlacementReport()
        used = self.alloc.region_used()
        free = self.alloc.region_free()
        return PlacementReport(
            placement_policy=self.placement_policy,
            n_regions=self.placement.n_regions,
            communal_pages=self.placement.communal_pages,
            region_used={str(r): used[r] for r in used},
            region_free={str(r): free[r] for r in free})


# ---------------------------------------------------------------------------
# Pool primitives (torch index ops; the reference's jitted helpers)
# ---------------------------------------------------------------------------
def _gather_pool(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool (L, P+1, ps, ...) + tables (B, nblk) -> (L, B, nblk*ps, ...)."""
    g = pool[:, tables]                      # (L, B, nblk, ps, ...)
    l, b, nblk, ps = g.shape[:4]
    return g.reshape((l, b, nblk * ps) + tuple(g.shape[4:]))


def _set_col(pool: torch.Tensor, col: torch.Tensor, slot: int) -> None:
    """Write one slot column in place.  Dense batch-axis rule: rank-1
    leaves batch on axis 0, else 1."""
    if pool.ndim == 1:
        pool[slot] = col
    else:
        pool[:, slot] = col


def _set_slot(pool: torch.Tensor, leaf: torch.Tensor, slot: int) -> None:
    """Write request 0 of the batch-1 ``leaf`` into ``slot``."""
    _set_col(pool, leaf[0] if pool.ndim == 1 else leaf[:, 0], slot)


def _write_pages(pool, leaf, idx, skip: int, need: int,
                 page_size: int) -> None:
    """Chop pages ``skip..need-1`` of ``leaf[:, 0]`` (the ragged tail
    padded with zeros) into ``(L, need - skip, ps, ...)`` and write them
    at ``idx``."""
    span = leaf[:, 0, skip * page_size:need * page_size]
    short = (need - skip) * page_size - span.shape[1]
    if short > 0:
        pad = [0, 0] * (span.ndim - 2) + [0, short]
        span = torch.nn.functional.pad(span, pad)
    pool[:, idx] = span.reshape((span.shape[0], need - skip, page_size)
                                + tuple(span.shape[2:]))


def _scatter_token(pool, leaf, tables, pos, active, page_size: int) -> None:
    """Write leaf[:, b, pos[b]] into the pool page holding pos[b].

    A write whose position falls outside the slot's mapped window (block
    index past the table) goes to the scratch page together with
    inactive slots: clipping the block index alone would alias such a
    write onto the window's last live page and corrupt resident KV.
    """
    b = leaf.shape[1]
    blk = pos // page_size                   # (B,)
    off = pos % page_size
    nblk = tables.shape[1]
    in_window = blk < nblk
    page = torch.gather(tables, 1, blk.clamp(0, nblk - 1)[:, None])[:, 0]
    trash = pool.shape[1] - 1                # scratch page index P
    page = torch.where(active & in_window, page, trash)
    src = pos.clamp(0, leaf.shape[SEQ_AXIS] - 1)
    lanes = torch.arange(b, device=leaf.device)
    pool[:, page, off] = leaf[:, lanes, src]
