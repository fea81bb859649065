"""Paged (block-table) KV cache for the serving engine (port of
``repro.serving.paged_cache``, with refcounted prefix sharing and
copy-on-write; without placement and page shipping).

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

from repro_torch.device import resolve
from repro_torch.obs.tracer import NULL_TRACER


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def num_blocks(n_tokens: int, page_size: int) -> int:
    return ceil_div(n_tokens, page_size)


# ---------------------------------------------------------------------------
# Host-side block allocator
# ---------------------------------------------------------------------------
class PageAllocator:
    """Refcounted free-list page allocator (host side).

    Pages are plain ints ``0..num_pages-1``.  ``alloc`` returns ``None``
    (allocating nothing) when the request cannot be satisfied — admission
    control, not an error.  Freshly allocated pages start at refcount 1;
    ``decref``/``free`` return a page to the free list only when the last
    reference drops.  The free list is LIFO and starts in descending
    order, so the lowest free index is handed out first.
    """

    def __init__(self, num_pages: int):
        if num_pages <= 0:
            raise ValueError("num_pages must be positive")
        self.num_pages = num_pages
        self._refs: Dict[int, int] = {}
        self._free: List[int] = list(range(num_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
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

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages.  Atomic: returns ``None`` without
        mutating when fewer than ``n`` pages are free."""
        if n < 0:
            raise ValueError("alloc size must be >= 0")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
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
        out the lowest free indices first.
        """
        for p, rc in refcounts.items():
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} out of range")
            if rc <= 0:
                raise ValueError(f"page {p} has non-positive refcount {rc}")
        self._refs = dict(refcounts)
        self._free = [p for p in range(self.num_pages - 1, -1, -1)
                      if p not in self._refs]


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
    copy-on-write.
    """
    entry: Any
    max_batch: int
    max_seq: int
    page_size: int
    num_pages: int
    tp: int = 1
    share: bool = False
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
        self.alloc = PageAllocator(self.num_pages)
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
        set is compact at the lowest indices)."""
        used = self.alloc.used_pages
        if used == 0:
            return 0.0
        return 1.0 - used / (self.alloc.highest_used() + 1)

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
        fresh = self.alloc.alloc(need - len(shared))
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

    def extend_slot(self, slot: int, n_tokens: int) -> bool:
        """Grow a slot's mapping to cover ``n_tokens`` total (on-demand
        decode growth).  No-op if already covered."""
        if not self.has_seq:
            return True
        have = len(self.blocks_of(slot))
        need = num_blocks(n_tokens, self.page_size)
        if need <= have:
            return True
        if need > self.max_blocks:
            return False
        pages = self.alloc.alloc(need - have)
        if pages is None:
            return False
        self.tables[slot, have:need] = pages
        self._mirror_row(slot)
        return True

    def free_slot(self, slot: int) -> None:
        for p in self.blocks_of(slot):
            if self.alloc.decref(p) and self.prefix is not None:
                self.prefix.remove(p)
        self.tables[slot, :] = -1
        self.shared_count[slot] = 0
        self._pending_prompt.pop(slot, None)
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
        got = self.alloc.alloc(1)
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

    def defrag(self) -> Dict[int, int]:
        """Compact live pages to the lowest indices.

        Returns the old->new mapping applied.  Pool data is permuted on
        device, in place (each pool keeps its storage); block tables and
        the allocator (refcounts preserved) are
        renumbered, so the logical contents (``gather()``) are unchanged;
        so is the prefix trie.
        The reference also prices the moved pages on its near-memory
        model; that accounting arrives with the placement slice.
        """
        live = self.alloc.live_pages()
        mapping = {old: new for new, old in enumerate(live)}
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
        if self.tracer.enabled:
            self.tracer.emit("defrag", live_pages=len(live),
                             moved=sum(1 for o, n in mapping.items()
                                       if o != n))
        if self.prefix is not None:
            self.prefix.remap(mapping)
            # every registered page is still allocated after renumbering
            assert all(self.alloc.refcount(p) > 0
                       for p in self.prefix._by_page), \
                "defrag left the prefix trie pointing at a dead page"
        self._tables_dev = None
        return mapping


# ---------------------------------------------------------------------------
# Pool primitives (torch index ops; the reference's jitted helpers)
# ---------------------------------------------------------------------------
def _gather_pool(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool (L, P+1, ps, ...) + tables (B, nblk) -> (L, B, nblk*ps, ...)."""
    g = pool[:, tables]                      # (L, B, nblk, ps, ...)
    l, b, nblk, ps = g.shape[:4]
    return g.reshape((l, b, nblk * ps) + tuple(g.shape[4:]))


def _set_slot(pool: torch.Tensor, leaf: torch.Tensor, slot: int) -> None:
    """Dense batch-axis rule: rank-1 leaves batch on axis 0, else 1."""
    if pool.ndim == 1:
        pool[slot] = leaf[0]
    else:
        pool[:, slot] = leaf[:, 0]


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
