"""Lightweight logic-die NoC model (paper §4.1).

The NoC connects the 16 PUs and is used only for coarse-grained collectives
(all-reduce / all-gather / reduce-scatter) and MoE token dispatch.  We model
ring collectives over the per-PU injection bandwidth (how such lightweight
meshes are actually scheduled), plus a per-stage hop latency.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.hw import NMPSystem


@dataclass(frozen=True)
class CollectiveCost:
    bytes_on_wire: int   # total bytes crossing NoC links
    time_s: float


def all_reduce(sys: NMPSystem, payload_bytes: int) -> CollectiveCost:
    """Ring all-reduce of a payload replicated per PU: 2(P-1)/P bytes/PU."""
    p = sys.pus
    per_pu = 2 * (p - 1) / p * payload_bytes
    t = (per_pu / sys.noc_link_bw_bytes
         + 2 * (p - 1) * sys.noc_latency_cycles / sys.freq_hz)
    return CollectiveCost(int(per_pu * p), t)


def reduce_scatter(sys: NMPSystem, payload_bytes: int) -> CollectiveCost:
    p = sys.pus
    per_pu = (p - 1) / p * payload_bytes
    t = (per_pu / sys.noc_link_bw_bytes
         + (p - 1) * sys.noc_latency_cycles / sys.freq_hz)
    return CollectiveCost(int(per_pu * p), t)


def all_gather(sys: NMPSystem, shard_bytes: int) -> CollectiveCost:
    """Each PU holds `shard_bytes`; result is P * shard_bytes everywhere."""
    p = sys.pus
    per_pu = (p - 1) * shard_bytes
    t = (per_pu / sys.noc_link_bw_bytes
         + (p - 1) * sys.noc_latency_cycles / sys.freq_hz)
    return CollectiveCost(per_pu * p, t)


def all_to_all(sys: NMPSystem, total_bytes: int) -> CollectiveCost:
    """Token dispatch: every PU exchanges (P-1)/P of its 1/P share."""
    p = sys.pus
    per_pu = total_bytes / p * (p - 1) / p
    t = (per_pu / sys.noc_link_bw_bytes
         + (p - 1) * sys.noc_latency_cycles / sys.freq_hz)
    return CollectiveCost(int(per_pu * p), t)


def page_gather(sys: NMPSystem, local_bytes: float, remote_bytes: float,
                remote_segments: int) -> CollectiveCost:
    """Paged KV gather DMA, issued by ONE PU.

    Pages under the issuing PU's own memory channel stream at that
    channel's internal bandwidth (``dram_bw_per_pu``); pages under other
    channels must cross the NoC and all funnel through the issuing PU's
    single injection port (``noc_link_bw_bytes``), serialized, plus one
    per-segment hop latency for each distinct remote channel touched.
    This is the asymmetry stack-aware placement exists to exploit: on
    the Stratum-class template the channel-internal path is ~2.4x the
    injection port, so a block table concentrated in one region beats
    the same table striped across the die.
    """
    if local_bytes < 0 or remote_bytes < 0 or remote_segments < 0:
        raise ValueError("gather byte counts must be non-negative")
    t = (local_bytes / sys.dram_bw_per_pu
         + remote_bytes / sys.noc_link_bw_bytes
         + remote_segments * sys.noc_latency_cycles / sys.freq_hz)
    return CollectiveCost(int(remote_bytes), t)


def page_ship(sys: NMPSystem, payload_bytes: float, segments: int,
              hops: int = 1) -> CollectiveCost:
    """KV pages shipped between stacks: the cross-stack generalization of
    :func:`page_gather` that prices prefill->decode tier handoff.

    The source stack gathers the pages exactly as ``page_gather`` would
    for an all-remote block table (``segments`` distinct page extents
    funneling through one injection port); the payload then crosses
    ``hops`` inter-stack links at the device interconnect bandwidth
    (``xlink_bw_bytes``, one ``xlink_latency_s`` setup per hop) and is
    scattered into the destination pool at that stack's channel-internal
    bandwidth.  ``hops=0`` degrades *exactly* to the intra-stack gather —
    the same primitive prices spilled-page migration and defrag moves
    inside one pool, so there is a single page-movement cost path.
    """
    if hops < 0:
        raise ValueError("hop count must be non-negative")
    base = page_gather(sys, 0, payload_bytes, segments)
    if hops == 0:
        return base
    t = (base.time_s
         + payload_bytes / sys.xlink_bw_bytes
         + hops * sys.xlink_latency_s
         + payload_bytes / sys.dram_bw_per_pu)
    return CollectiveCost(int(payload_bytes), t)
