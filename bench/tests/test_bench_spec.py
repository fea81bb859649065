"""Every entry of BENCHMARK.json resolves to its files by name, and the
file keeps to the benchmark's contract."""
import importlib
import json
import re

import pytest

from bench.harness import spec

SPEC = spec.load_spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves(workload):
    cell = spec.resolve(workload)
    assert cell.chips == 1
    assert spec.generator(cell.traffic).Stream
    assert spec.reference(cell.config).Reference
    assert spec.counts(cell.config).Shape.of(cell.config)
    from bench.harness import check
    limited = set(check.NUMBERS + check.ROUTE_NUMBERS) - {"route_flip_share"}
    assert cell.limits and set(cell.limits) <= limited
    for name, entry in cell.limits.items():
        assert isinstance(entry["limit"], float)
        # 0 only where a sound run counts exactly 0
        assert entry["limit"] > 0 or (name in check.EXACT
                                      and entry["limit"] == 0)
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader(metric):
    mod = importlib.import_module(f"bench.metrics.{metric}")
    assert callable(mod.read)


@pytest.mark.parametrize("entry", METRICS, ids=lambda m: m["name"])
def test_metric_entry(entry):
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    if "bound" in entry:
        assert 0.01 <= entry["bound"] <= 0.25
        assert entry["source"] in ("host_clock", "device_trace")
    else:
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        e2e = {m["name"]: m for m in SPEC["end_to_end"]}
        moved = e2e[entry["moves"]]
        for w in entry.get("workloads", WORKLOADS):
            assert w in WORKLOADS
            assert w in moved.get("workloads", WORKLOADS)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    cfg = spec.load_json(spec.ROOT / conf["file"])
    assert cfg["name"] == conf["name"]
    assert conf["file"].startswith("bench/")
    for key in conf["reduced"]:
        assert key in cfg["published"] and cfg[key] != cfg["published"][key]
    for key in cfg["published"]:
        assert key in conf["reduced"]
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "configs")
                                        .glob("*.json")), ids=lambda p: p.stem)
def test_every_config_file_states_its_port_and_deployment(path):
    cfg = spec.load_json(path)
    assert cfg["name"] == path.stem
    from bench.harness import cell
    assert cell.arch_config(cfg).family == cfg["port"]["family"]
    for key in ("source", "deployment", "departures", "engine",
                "pool_reckoning", "kv_bytes_per_token", "reference"):
        assert cfg[key]


def test_names_unique_and_legal():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "configs")
                                        .glob("*.json")), ids=lambda p: p.stem)
def test_reference_lists_moe_layers_exactly_when_the_port_has_experts(path):
    cfg = spec.load_json(path)
    from bench.harness import cell
    moe = spec.reference(cfg).moe_layers(cfg)
    assert bool(moe) == bool(cell.arch_config(cfg).num_experts)
    assert list(moe) == sorted(set(moe))
    assert all(0 <= i < cfg["num_hidden_layers"] for i in moe)


@pytest.mark.parametrize("config, over, match", [
    ("qwen3-30b-a3b", {"mlp_only_layers": [0]}, "dense layers"),
    ("qwen3-30b-a3b", {"decoder_sparse_step": 2}, "dense layers"),
    ("yi-6b", {"port": {"arch": "qwen3-30b-a3b", "family": "moe"}},
     "experts"),
], ids=["mlp_only_layers", "decoder_sparse_step", "dense_file_moe_port"])
def test_a_stack_the_reference_cannot_write_out_is_refused_at_setup(
        config, over, match, monkeypatch):
    """A run refuses, before any weights are made, a file whose dense
    layers the transformer reference would write out as MoE, and a file
    whose reference routes where the port does not, or the reverse."""
    from bench.harness import weights
    from bench.tests import tiny
    monkeypatch.setattr(weights, "make", lambda *a: pytest.fail("weights"))
    with pytest.raises(ValueError, match=match):
        tiny.run(tiny.cell(config, **over))
