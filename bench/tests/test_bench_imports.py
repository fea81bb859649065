"""Nothing the benchmark runs loads JAX, Flax or the JAX package, and the
reference loads nothing of the program.  Each check runs in a fresh
interpreter and compares every loaded module's top-level name whole."""
import json
import subprocess
import sys

import pytest

from bench.harness import spec

ROOT = str(spec.ROOT)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_PROBE = r"""
import importlib, json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
for m in {mods!r}:
    importlib.import_module(m)
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(mods, extra=""):
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=ROOT, mods=mods,
                                             extra=extra)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "PYTHONNOUSERSITE": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _bench_modules():
    s = spec.load_spec()
    mods = ["bench.run", "bench.harness.cell", "bench.harness.check",
            "bench.harness.trace", "bench.harness.window",
            "bench.harness.weights", "bench.calibrate"]
    mods += [f"bench.metrics.{m['name']}"
             for m in s["end_to_end"] + s["per_layer"]]
    for w in s["workloads"]:
        cell = spec.resolve(w["name"], s)
        mods += [f"bench.traffic.{cell.traffic['generator']}",
                 f"bench.reference.{cell.config['reference']}",
                 f"bench.count.{cell.config['reference']}"]
    return sorted(set(mods))


def test_harness_loads_no_jax():
    # what a run imports of the program, on top of the harness itself
    extra = ("import repro_torch.serving.engine, "
             "repro_torch.serving.scheduler, repro_torch.models.registry")
    names = _top_names(_bench_modules(), extra)
    assert "repro_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


@pytest.mark.parametrize("mod", ["bench.reference.transformer"])
def test_reference_loads_nothing_of_the_program(mod):
    names = _top_names([mod])
    assert not names & (FORBIDDEN | {"repro_torch"})


def test_forbidden_names_compare_whole():
    from bench import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.models",
                                  "jaxtyping", "flax_like"]) == []
    assert run.forbidden_modules(["repro.models", "jaxlib.xla_client",
                                  "flax", "jax"]) == ["flax", "jax",
                                                      "jaxlib", "repro"]
