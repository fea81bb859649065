"""On the card: a cell at its own size reads the program under its limit
and the float8 control over it.  Skips without a card.

    python -m pytest -q -m cuda bench/tests/test_bench_card.py
"""
import io
import json
import time

import pytest

from bench.harness import spec

WORKLOADS = [w["name"] for w in spec.load_spec()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cell runs at its own size)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_program_passes(card, workload):
    from bench.harness import cell as cell_run
    cell = spec.resolve(workload)
    log = io.StringIO()
    res = cell_run.run(cell, 2 ** 31 + 4242, 30.0, False, card,
                       time.perf_counter(), log=log, control=True)
    info = json.loads(log.getvalue().splitlines()[0][len("info "):])
    assert res["correct"]
    assert any(info["control"][name] > lim["limit"]
               for name, lim in cell.limits.items()
               if name in info["control"])
