"""The replica contract (a copy of ``repro.serving.replica_api``): one
interface for every replica the router drives.

Three implementations stay interchangeable behind the :class:`Replica`
protocol: the engines of ``repro_torch.serving.engine``, the analytic
cluster mirror ``repro_torch.core.serving_sim._Replica`` (modeled clock,
no tensors), and the stub replicas of the router's policy tests.

Contract
--------
``admit(req) -> bool``
    Try to start ``req``; ``False`` means no capacity right now, and the
    replica has not changed ``req``.
``tick() -> None``
    One scheduling quantum: at most one prefill chunk plus one decode
    iteration (or one fused horizon).
``busy() -> bool``
    Whether any request is resident (active or mid-prefill).
``load_report() -> LoadReport``
    Dispatch-time load signals (see :class:`LoadReport`).
``requeue``
    List of preempted requests awaiting re-admission; the scheduler
    drains it ahead of fresh arrivals.
``export_slot_pages(rid) -> PageShipment | None``
    Prefill tier: package a finished prefill's KV pages, block-table row
    and prefix coverage for shipment.  ``None``: still mid chunked
    prefill, the caller retries.
``import_slot_pages(shipment) -> bool``
    Decode tier: splice a shipment into the local page pool.  ``False``:
    no capacity, the caller retries or picks another target.

:class:`LoadReport` and :class:`PlacementReport` are the typed reports;
``to_dict()`` is the JSON/metrics boundary.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)


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


#: methods every replica implementation defines (the reference's list)
REPLICA_METHODS = ("admit", "tick", "busy", "load_report",
                   "export_slot_pages", "import_slot_pages")


@runtime_checkable
class Replica(Protocol):
    """Structural type for a routable replica (see module docstring)."""

    requeue: List[Any]

    def admit(self, req: Any) -> bool: ...

    def tick(self) -> None: ...

    def busy(self) -> bool: ...

    def load_report(self) -> LoadReport: ...

    def export_slot_pages(self, rid: int) -> Optional[Any]: ...

    def import_slot_pages(self, shipment: Any) -> bool: ...
