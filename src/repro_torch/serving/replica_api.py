"""The replica load report (the ``LoadReport`` of
``repro.serving.replica_api``), and the ``PlacementReport`` of
stack-aware placement.

A replica is what a scheduler drives: ``admit(req) -> bool``,
``tick()``, ``busy()``, ``load_report()`` and a ``requeue`` list of
preempted requests.  The reference's ``Replica`` protocol also names the
page-shipping methods of disaggregated serving; it is ported with the
router and tiers slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class LoadReport:
    """Dispatch-time load signals a router reads off a replica.

    Field names mirror the reference's exactly; ``to_dict()`` is the
    JSON/metrics boundary.  ``region_free`` is only populated under
    stack-aware placement (empty tuple otherwise), and
    ``min_region_free`` falls back to ``free_pages``.
    """

    active: int                 # decoding slots
    prefilling: int             # 0/1: a chunked prefill is resident
    queue_depth: int            # active + prefilling + engine requeue
    free_slots: int
    free_pages: int             # page pool headroom (== free_slots dense)
    min_region_free: int        # tightest slot region (free_pages unplaced)
    region_free: Tuple[int, ...] = ()   # per-slot-region free pages

    def to_dict(self) -> Dict[str, Any]:
        d = {"active": self.active, "prefilling": self.prefilling,
             "queue_depth": self.queue_depth,
             "free_slots": self.free_slots,
             "free_pages": self.free_pages,
             "min_region_free": self.min_region_free}
        if self.region_free:
            d["region_free"] = list(self.region_free)
        return d


@dataclass(frozen=True)
class PlacementReport:
    """Stack-aware placement occupancy (``PagedCache.placement_report``).

    ``region_used`` / ``region_free`` map region id (as a string, the
    reference's JSON key shape) to page counts; ``empty`` keeps the
    "no placement configured -> {}" contract at the dict boundary.
    """

    placement_policy: str = ""
    n_regions: int = 0
    communal_pages: int = 0
    region_used: Dict[str, int] = field(default_factory=dict)
    region_free: Dict[str, int] = field(default_factory=dict)

    @property
    def empty(self) -> bool:
        return not self.placement_policy

    def to_dict(self) -> Dict[str, Any]:
        if self.empty:
            return {}
        return {"placement_policy": self.placement_policy,
                "n_regions": self.n_regions,
                "communal_pages": self.communal_pages,
                "region_used": dict(self.region_used),
                "region_free": dict(self.region_free)}
