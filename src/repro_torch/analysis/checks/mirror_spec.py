"""The engine <-> analytic-mirror contract, written down (port of
``repro.analysis.checks.mirror_spec``, over ``repro_torch``).

The live serving engine (``repro_torch.serving``) and its analytic
mirror (``repro_torch.core.serving_sim``) grew hand-synchronized across six PRs:
config knobs, metric keys, and report fields correspond by naming
convention only.  This module makes every correspondence explicit so
:mod:`mirror_drift` can diff both code bases against it — adding a field
on one side without either mirroring it or *declaring* why it is
one-sided becomes a checker finding, as does letting a stale entry rot
in this file after a rename.

Three kinds of entry:

* ``*_PAIRS`` — (left name, right name) correspondences.  Both names
  must exist in the extracted surfaces.
* ``*_ONLY`` — one-sided names mapped to the *reason* they have no
  mirror.  Every name must still exist on its own side.
* ``ROUTER_MUST_AGGREGATE`` — scheduler metric keys the cluster router
  is required to consume (the roll-up bug class: per-replica co-design
  metrics silently dropped at the cluster roll-up).
"""
from __future__ import annotations

# The metric-name contracts themselves live next to the registry that
# produces them; re-exported here so the checker has one spec
# module to import
from repro_torch.obs.metrics import (ROUTER_METRIC_CONTRACT,       # noqa: F401
                               SCHEDULER_METRIC_CONTRACT)

# --------------------------------------------------------------------------
# EngineConfig (serving/engine.py)  <->  simulate_serving kwargs
# (core/serving_sim.py)
# --------------------------------------------------------------------------
ENGINE_SIM_PAIRS = [
    ("max_batch", "max_batch"),
    ("max_new_tokens", "output_len"),
    ("paged", "cache_mode"),              # bool <-> "dense"/"paged"
    ("page_size", "page_size"),
    ("num_pages", "num_pages"),
    ("prefill_chunk", "prefill_chunk"),
    ("prefix_sharing", "prefix_sharing"),
    ("placement", "placement"),
    ("placement_regions", "n_regions"),
    ("fuse_steps", "fuse_steps"),
]

ENGINE_ONLY_CONFIG = {
    "max_seq": "sim derives the KV window from input_len + output_len",
    "eos_id": "sim traces carry sampled decode lengths instead of a "
              "token-level stop id",
    "use_pallas_decode": "kernel choice is invisible to the analytic "
                         "latency model",
    "defrag_threshold": "host-side hole-tracking trigger; the sim prices "
                        "migration, not fragmentation",
    "communal_frac": "sim placement carves its communal region internally",
    "codesign": "the sim receives the tick model itself as `latency`",
    "codesign_rows": "fixed-shape baselines are priced by passing a "
                     "different tick model to the sim",
    "codesign_spec": "the sim is always constructed from an explicit spec",
    "codesign_tp": "the sim is always constructed from an explicit spec",
    "codesign_reconfig_cost_s": "priced inside the tick model handed to "
                                "the sim as `latency`",
    "device": "the port's engine places its tensors on a device (the "
              "card, or the CPU when asked); the sim is host numpy",
}

SIM_ONLY_PARAMS = {
    "system": "substrate label; the live engine reads it off the tick model",
    "n_requests": "trace shape — the live engine consumes an explicit trace",
    "input_len": "trace shape — the live engine consumes an explicit trace",
    "seed": "trace shape — the live engine consumes an explicit trace",
    "shared_prefix_len": "trace shape — the live engine consumes an "
                         "explicit trace",
    "prefill_on_device": "sim-only switch for pricing prefill off-device",
    "hw": "NMP system object for gather pricing; the engine wires it "
          "through the paged cache",
    "tracer": "the engine attaches its tracer via set_tracer, not a "
              "config knob",
}

# --------------------------------------------------------------------------
# Scheduler.metrics keys  <->  ServingReport fields
# --------------------------------------------------------------------------
SERVING_REPORT_PAIRS = [
    # (ServingReport field, Scheduler.metrics key)
    ("completed", "requests"),
    ("decoded_tokens", "decoded_tokens"),
    ("tokens_per_s", "tokens_per_s"),
    ("tbt_mean_s", "tbt_mean_s"),
    ("ttft_mean_s", "ttft_mean_s"),
    ("preemptions", "preemptions"),
    ("kv_peak_tokens", "kv_peak_tokens"),
    ("dedup_ratio", "kv_dedup_ratio_peak"),
    ("gather_cost_mean_s", "kv_gather_cost_mean_s"),
    ("gather_concentration", "kv_gather_concentration"),
    ("region_peak_pages", "kv_region_peak"),
    ("reconfigurations", "reconfigurations"),
    ("substrate_configs", "substrate_configs"),
    ("array_util_mean", "array_util_mean"),
    ("fused_ticks", "fused_ticks"),
    ("fused_steps_mean", "fused_steps_mean"),
    ("makespan_s", "modeled_time_s"),     # both are the modeled clock
]

SERVING_REPORT_ONLY = {
    "system": "workload identity, not a runtime metric",
    "model": "workload identity, not a runtime metric",
    "rate_req_s": "workload identity, not a runtime metric",
    "e2e_mean_s": "sim-clock statistic; the live path reports e2e "
                  "percentiles at the cluster level",
    "e2e_p90_s": "sim-clock statistic; the live path reports e2e "
                 "percentiles at the cluster level",
    "kv_util_mean": "per-tick occupancy integral only the sim clock can "
                    "average cheaply",
    "max_decode_stall_s": "sim-clock statistic (worst decode gap)",
}

SCHEDULER_METRICS_ONLY = {
    "wall_s": "wall-clock only exists on the live path",
    "tbt_p99_s": "live-path tail metric; sim reports the mean",
    "tpot_mean_s": "alias of tbt_mean_s kept for benchmark scripts",
    "finish_eos": "live traces finish on sampled eos; sim uses lengths",
    "finish_budget": "live traces finish on sampled eos; sim uses lengths",
    "kv_mode": "echoed config, not a metric",
    "kv_reserved_tokens": "echoed config, not a metric",
    "kv_logical_peak_pages": "folded into dedup_ratio on the sim side",
    "kv_shared_pages": "folded into dedup_ratio on the sim side",
    "cow_forks": "host-allocator detail the sim does not model",
    "defrag_runs": "host-allocator detail the sim does not model",
    "prefill_skipped_tokens": "host-allocator detail the sim does not model",
    "kv_migrated_pages": "sim prices migration inside gather cost",
    "kv_migration_cost_s": "sim prices migration inside gather cost",
    "placement_policy": "echoed config, not a metric",
    "codesign_substrate": "echoed config, not a metric",
    "modeled_tokens_per_s": "derived from decoded_tokens / makespan_s on "
                            "the sim side",
    "fused_host_frac": "wall-clock host/device split only exists on the "
                       "live path",
    "hists": "bucketed distribution summaries from the live metrics "
             "registry; the sim reports scalar statistics",
}

# --------------------------------------------------------------------------
# Router.metrics keys  <->  ClusterReport fields
# --------------------------------------------------------------------------
CLUSTER_REPORT_PAIRS = [
    # (ClusterReport field, Router.metrics key)
    ("policy", "policy"),
    ("replicas", "replicas"),
    ("completed", "requests"),
    ("throughput_tok_s", "tokens_per_s"),
    ("e2e_p50_s", "e2e_p50_s"),
    ("e2e_p99_s", "e2e_p99_s"),
    ("tbt_mean_s", "tbt_mean_s"),
    ("dedup_ratio", "dedup_ratio_agg"),
    ("preemptions", "preemptions"),
    ("reconfigurations", "reconfigurations"),
    ("substrate_configs", "substrate_configs"),
    ("array_util_mean", "array_util_mean"),
    # prefill/decode disaggregation
    ("tiers", "tiers"),
    ("shipments", "shipments"),
    ("shipped_pages", "shipped_pages"),
    ("ship_cost_s", "ship_cost_s"),
]

CLUSTER_REPORT_ONLY = {
    "rate_req_s": "workload identity, not a runtime metric",
    "per_replica_util": "router reports the richer per_replica table",
    "per_replica_completed": "router reports the richer per_replica table",
}

ROUTER_METRICS_ONLY = {
    "wall_s": "wall-clock only exists on the live path",
    "decoded_tokens": "cluster sim reports throughput directly",
    "tbt_p99_s": "live-path tail metric; sim reports the mean",
    "finish_eos": "live traces finish on sampled eos; sim uses lengths",
    "finish_budget": "live traces finish on sampled eos; sim uses lengths",
    "modeled_tokens_per_s": "live cluster only: the sim clock IS the "
                            "modeled clock",
    "per_replica": "live-path breakdown table",
    "hists": "bucketed distribution summaries from the live metrics "
             "registry; the sim reports scalar statistics",
}

# --------------------------------------------------------------------------
# Scheduler metric keys the Router roll-up must consume (or explicitly
# drop here with a reason).  This is the roll-up drift class: Scheduler
# grows a co-design metric, Router's ad-hoc name matching never picks it
# up, and the cluster report silently under-reports.
# --------------------------------------------------------------------------
ROUTER_MUST_AGGREGATE = [
    "reconfigurations",
    "modeled_tokens_per_s",
    "array_util_mean",
    "substrate_configs",
]

ROUTER_AGGREGATE_DROPS: dict = {}

# --------------------------------------------------------------------------
# The replica protocol: methods every routable replica — live
# engine, analytic ``serving_sim._Replica``, router test stubs — must
# define.  The canonical tuple lives next to the Protocol class itself;
# re-exported so the checker has one spec module to import.  The typed
# report field lists pin the LoadReport/PlacementReport dataclasses the
# dict-shaped payloads were replaced with: ``to_dict()`` at the JSON
# boundary must keep emitting exactly these names.
# --------------------------------------------------------------------------
from repro_torch.serving.replica_api import (                       # noqa: F401,E402
    REPLICA_METHODS as REPLICA_PROTOCOL_METHODS)

LOAD_REPORT_FIELDS = (
    "active", "prefilling", "queue_depth", "free_slots", "free_pages",
    "min_region_free", "region_free",
)

PLACEMENT_REPORT_FIELDS = (
    "placement_policy", "n_regions", "communal_pages", "region_used",
    "region_free",
)

#: implementations the replica-protocol pass checks: (path, class name)
REPLICA_IMPLEMENTATIONS = [
    ("src/repro_torch/serving/engine.py", "ServingEngine"),
    ("src/repro_torch/core/serving_sim.py", "_Replica"),
    ("tests/test_torch_router.py", "_StubReplica"),
]
