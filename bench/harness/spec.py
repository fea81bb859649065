"""Resolve a workload of ``BENCHMARK.json`` to its files, by name.

A cell names a configuration and a traffic mix; each metric names its
reader.  Nothing here knows a particular cell: a later cell or metric
is new files and new entries, found the same way.
"""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_spec() -> Dict[str, Any]:
    return load_json(SPEC_FILE)


@dataclass
class Metric:
    name: str
    unit: str

    def reader(self):
        """The metric's reader module (``metrics/<name>.py``)."""
        return importlib.import_module(f"bench.metrics.{self.name}")


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    def metrics(self, trace: bool) -> List[Metric]:
        """The metrics a run reports: end-to-end ones untraced, per-layer
        ones traced."""
        return self.per_layer if trace else self.end_to_end


def _applies(entry: Dict[str, Any], workload: str) -> bool:
    names = entry.get("workloads")
    return names is None or workload in names


def generator(mix: Dict[str, Any]):
    """The generator module a mix names (``traffic/<generator>.py``)."""
    return importlib.import_module(f"bench.traffic.{mix['generator']}")


def reference(config: Dict[str, Any]):
    """The plain reference a configuration names
    (``reference/<reference>.py``)."""
    return importlib.import_module(f"bench.reference.{config['reference']}")


def counts(config: Dict[str, Any]):
    """The counts of the configuration's reference family
    (``count/<reference>.py``)."""
    return importlib.import_module(f"bench.count.{config['reference']}")


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of the device named ``kind`` (None if the
    table lacks it)."""
    return load_json(BENCH_DIR / "peaks.json").get(kind)


def traffic_path(mix: str) -> Path:
    return BENCH_DIR / "traffic" / f"{mix}.json"


def limits_path(workload: str) -> Path:
    return BENCH_DIR / "limits" / f"{workload}.json"


def resolve(workload: str, spec: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``workload`` with its configuration, traffic, limits and
    metrics; raises ``KeyError`` for an unknown name."""
    spec = spec if spec is not None else load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; the workloads are "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    conf_entry = configs[w["config"]]
    config = load_json(ROOT / conf_entry["file"])
    traffic = load_json(traffic_path(w["traffic"]))
    limits = load_json(limits_path(workload))
    cell = Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits)
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            if _applies(m, workload):
                getattr(cell, kind).append(Metric(m["name"], m["unit"]))
    return cell
