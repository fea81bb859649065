"""Regression fixtures that re-introduce historical bugs into port-shaped
code (the port's counterparts of ``repro.analysis.checks.fixtures``).

Each module here reproduces one defect class so the checker suite can be
tested against a known-bad input (``python -m repro_torch.analysis.checks
--fixture <name>`` must exit non-zero):

* ``pr2_scatter_clip`` — the clipped token scatter (clip-aliasing)
* ``pr2_inactive_lane`` — table handoff without the inactive-lane
  scratch route (inactive-lane corruption)
* ``pr2_refcount_free`` — an allocator that frees shared pages, and a
  defrag mapping that moves pages across placement regions
* ``pr6_metrics_drift`` — a cluster roll-up that drops a per-replica
  co-design metric (ad-hoc name-matching drift)
* ``pr8_fused_double_count`` — a fused-tick apply without the per-step
  emit guard (a finished lane's token counted twice)
* ``pr9_metrics_unregistered`` — a scheduler metric emitted without a
  contract entry
* ``pr10_ship_trie_drop`` — a shipment import that skips destination
  trie re-registration (silent dedup loss on the decode tier)

Nothing in this package is imported by production code.
"""
