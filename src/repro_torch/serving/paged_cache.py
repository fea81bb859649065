"""Paged (block-table) KV cache for the serving engine (port of
``repro.serving.paged_cache``, without prefix sharing and placement).

Sequence-bearing cache leaves live in a pool of fixed-size pages and each
slot owns a block table mapping its logical context positions to pages,
so the KV memory a request holds is proportional to its context.

Layout: a sequence leaf ``(L, B, S, ...)`` becomes a pool
``(L, P+1, page, ...)``; page ``P`` is a scratch page, so writes routed
away from live data (inactive lanes, positions past a slot's window) and
reads of unmapped table entries never touch a live page.  Block tables
are a host ``(max_batch, max_blocks)`` int32 array with an incrementally
maintained device mirror.

The reference copies and donates its pools through jitted helpers; here
the pools are updated in place with indexed assignment (``index_put_``),
so no second pool is ever materialised.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

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
    """
    entry: Any
    max_batch: int
    max_seq: int
    page_size: int
    num_pages: int
    tp: int = 1
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
        """The reference's sharing counters; without prefix sharing no
        page is mapped twice and no fork happens."""
        logical = self.logical_pages()
        physical = self.alloc.used_pages
        return {"logical_pages": logical,
                "physical_pages": physical,
                "shared_pages": self.alloc.shared_pages,
                "dedup_ratio": logical / physical if physical else 1.0,
                "cow_forks": 0}

    def alloc_slot(self, slot: int, n_tokens: int) -> bool:
        """Allocate pages to cover ``n_tokens`` for an empty slot.
        Atomic: on failure nothing is allocated."""
        if not self.has_seq:
            return True
        assert not self.blocks_of(slot), "slot already mapped"
        pages = self.alloc.alloc(num_blocks(n_tokens, self.page_size))
        if pages is None:
            return False
        self.tables[slot, : len(pages)] = pages
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
            self.alloc.decref(p)
        self.tables[slot, :] = -1
        self._mirror_row(slot)

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
        block table; the lengths leaf is written to the slot column."""
        pages = self.blocks_of(slot)
        need = num_blocks(n_tokens, self.page_size)
        if self.has_seq:
            assert len(pages) >= need, \
                "write_slot without enough pages mapped"
        idx = torch.as_tensor(pages[:need], dtype=torch.long).to(
            self.device)
        for pool, leaf, seq in zip(self.store, cache1, self.is_seq):
            if seq:
                if need:
                    _write_pages(pool, leaf, idx, need, self.page_size)
            else:
                _set_slot(pool, leaf, slot)

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
        slot's pages; the lengths leaf goes to the slot column."""
        ps = self.page_size
        idx = np.arange(pos, pos + take)
        row = self.tables[slot]
        blk = idx // ps
        assert (row[blk] >= 0).all(), "scatter_chunk into unmapped pages"
        pages = torch.as_tensor(row[blk].astype(np.int64)).to(self.device)
        offs = torch.as_tensor((idx % ps).astype(np.int64)).to(self.device)
        for pool, leaf, seq in zip(self.store, cache1, self.is_seq):
            if seq:
                pool[:, pages, offs] = leaf[:, 0, pos:pos + take]
            else:
                _set_slot(pool, leaf, slot)

    def defrag(self) -> Dict[int, int]:
        """Compact live pages to the lowest indices.

        Returns the old->new mapping applied.  Pool data is permuted on
        device; block tables and the allocator (refcounts preserved) are
        renumbered, so the logical contents (``gather()``) are unchanged.
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
        self.store = [pool[:, perm_dev] if seq else pool
                      for pool, seq in zip(self.store, self.is_seq)]
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


def _write_pages(pool, leaf, idx, need: int, page_size: int) -> None:
    """Chop ``leaf[:, 0]``'s first ``need`` pages (the ragged tail padded
    with zeros) into ``(L, need, ps, ...)`` and write them at ``idx``."""
    span = leaf[:, 0, :need * page_size]
    short = need * page_size - span.shape[1]
    if short > 0:
        pad = [0, 0] * (span.ndim - 2) + [0, short]
        span = torch.nn.functional.pad(span, pad)
    pool[:, idx] = span.reshape((span.shape[0], need, page_size)
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
