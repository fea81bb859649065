"""Stack-aware page placement: per-channel page regions + gather cost.

The paper's co-design thesis is that decode throughput on a 3D-stacked
NMP substrate is set by how well the serving layer's access pattern
matches the per-channel internal bandwidth layout: each of the 16 PUs
sits under ONE memory channel whose internal bandwidth
(``NMPSystem.dram_bw_per_pu``, ~1.35 TB/s on the Stratum-class template)
dwarfs the PU's NoC injection bandwidth (512 GB/s).  A paged KV gather
whose block table is concentrated in the issuing PU's own channel
streams at channel bandwidth; every page mapped under a *different*
channel must cross the logic-die NoC through the issuing PU's single
injection port and pay a per-segment hop latency.

This module is where that substrate fact meets the serving layer:

* :class:`PlacementMap` partitions the physical page pool into
  per-stack/per-channel *regions* (derived from ``NMPSystem.pus``), plus
  an optional *communal* region at the lowest indices that holds shared
  prefix pages — pages every slot reads, so no slot's home channel is
  favored for them;
* :func:`gather_cost` scores a block table's region histogram against
  the link bandwidths (the DMA model itself is ``core/noc.py``'s
  :func:`~repro_torch.core.noc.page_gather`);
* ``PageAllocator`` (``serving/paged_cache.py``) consumes the map under
  one of three placement policies:

  - ``free-first`` — wherever the free list points (the legacy layout);
  - ``interleave`` — stripe a slot's pages round-robin across regions
    (maximizes aggregate write bandwidth, worst gather concentration);
  - ``affinity``   — co-locate a slot's pages in one home region,
    spilling to the emptiest other region only when home runs dry.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core.hw import FP16_BYTES, NMPSystem
from repro_torch.core.noc import page_gather

#: Region id of the communal (shared-prefix) slice of the pool.
COMMUNAL = -1

#: Placement policies understood by ``PageAllocator`` / ``EngineConfig``.
PLACEMENT_POLICIES = ("free-first", "interleave", "affinity")


@dataclass(frozen=True)
class PlacementMap:
    """Static partition of page ids ``0..num_pages-1`` into regions.

    Layout: pages ``[0, communal_pages)`` form the communal region
    (:data:`COMMUNAL`); the remaining pages split into ``n_regions``
    near-equal contiguous slot regions ``0..n_regions-1`` (earlier
    regions absorb the remainder).  Contiguity is what makes
    region-preserving defrag meaningful: compaction targets stay inside
    the same physical channel.
    """

    num_pages: int
    n_regions: int
    communal_pages: int = 0

    def __post_init__(self):
        if self.num_pages <= 0:
            raise ValueError("num_pages must be positive")
        if not 0 <= self.communal_pages < self.num_pages:
            raise ValueError(
                f"communal_pages={self.communal_pages} must leave slot "
                f"pages in a {self.num_pages}-page pool")
        slot_pages = self.num_pages - self.communal_pages
        if not 1 <= self.n_regions <= slot_pages:
            raise ValueError(
                f"n_regions={self.n_regions} needs 1..{slot_pages} for "
                f"{slot_pages} slot pages")
        base, rem = divmod(slot_pages, self.n_regions)
        bounds = [self.communal_pages]
        for r in range(self.n_regions):
            bounds.append(bounds[-1] + base + (1 if r < rem else 0))
        object.__setattr__(self, "_bounds", tuple(bounds))

    @classmethod
    def from_system(cls, sys: NMPSystem, num_pages: int, *,
                    communal_frac: float = 0.0,
                    n_regions: Optional[int] = None) -> "PlacementMap":
        """Derive the partition from the substrate: one region per PU /
        memory channel, capped so every region holds at least one page.
        ``communal_frac`` of the pool is carved off for shared prefix
        pages (0 when prefix sharing is off)."""
        if not 0.0 <= communal_frac < 1.0:
            raise ValueError(f"communal_frac={communal_frac} not in [0,1)")
        communal = int(num_pages * communal_frac)
        slot_pages = num_pages - communal
        want = n_regions if n_regions is not None else sys.pus
        return cls(num_pages, max(1, min(want, slot_pages)), communal)

    # -- geometry ----------------------------------------------------------
    def regions(self) -> Tuple[int, ...]:
        """All region ids, communal (if present) first."""
        slot = tuple(range(self.n_regions))
        return ((COMMUNAL,) + slot) if self.communal_pages else slot

    def region_of(self, page: int) -> int:
        if not 0 <= page < self.num_pages:
            raise ValueError(f"page {page} out of range")
        if page < self.communal_pages:
            return COMMUNAL
        bounds = self._bounds
        lo, hi = 0, self.n_regions
        while lo + 1 < hi:                  # bisect over region bounds
            mid = (lo + hi) // 2
            if page >= bounds[mid]:
                lo = mid
            else:
                hi = mid
        return lo

    def region_pages(self, region: int) -> range:
        if region == COMMUNAL:
            return range(self.communal_pages)
        if not 0 <= region < self.n_regions:
            raise ValueError(f"region {region} out of range")
        return range(self._bounds[region], self._bounds[region + 1])

    def region_size(self, region: int) -> int:
        return len(self.region_pages(region))


# ---------------------------------------------------------------------------
# Gather cost model
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class GatherCost:
    """DMA cost of one slot's block-table gather, as issued by the PU of
    its ``home`` region."""

    home: int
    bytes_local: int
    bytes_remote: int
    remote_regions: int
    time_s: float
    concentration: float    # fraction of pages in the home region


def gather_cost(sys: NMPSystem, region_counts: Mapping[int, int],
                bytes_per_page: int,
                home: Optional[int] = None) -> GatherCost:
    """Score a block table's region histogram against the substrate.

    ``region_counts`` maps region id -> pages the slot has mapped there.
    ``home`` defaults to the majority *slot* region — the PU the
    scheduler would issue the gather from.  The communal region lives
    under its own channel, remote to every slot home, so it is never
    picked as home while any private pages exist (and its pages always
    count against concentration).

        T = B_local / BW_chan + B_remote / BW_noc + R_remote * L_hop / f

    where ``BW_chan = dram_bw_per_pu`` (per-channel internal bandwidth),
    ``BW_noc = noc_link_bw_bytes`` (the issuing PU's single injection
    port — remote bytes funnel through it serially), and ``R_remote`` is
    the number of distinct remote regions (one NoC segment set-up each).
    """
    counts = {r: int(c) for r, c in region_counts.items() if c > 0}
    total = sum(counts.values())
    if total == 0:
        return GatherCost(home if home is not None else 0, 0, 0, 0,
                          0.0, 1.0)
    if home is None:
        # majority among the slot regions, ties to the lowest id; the
        # communal region is never a home while private pages exist —
        # it lives under its own channel, remote to every slot home
        slot_regions = [r for r in counts if r != COMMUNAL]
        home = (min(slot_regions, key=lambda r: (-counts[r], r))
                if slot_regions else COMMUNAL)
    local = counts.get(home, 0) * bytes_per_page
    remote_regions = [r for r in counts if r != home]
    remote = sum(counts[r] for r in remote_regions) * bytes_per_page
    cost = page_gather(sys, local, remote, len(remote_regions))
    return GatherCost(home, local, remote, len(remote_regions),
                      cost.time_s, counts.get(home, 0) / total)


def kv_bytes_per_token(spec) -> int:
    """fp16 K+V bytes one context token holds across all layers — the
    per-page gather payload is ``page_size`` times this."""
    return 2 * spec.num_layers * spec.num_kv_heads * spec.d_head \
        * FP16_BYTES


@functools.lru_cache(maxsize=1)
def default_system() -> NMPSystem:
    """The SNAKE system template — the substrate the real-JAX engine
    scores placement against when no explicit ``NMPSystem`` is given."""
    from repro_torch.core.hw import snake_system
    return snake_system()
