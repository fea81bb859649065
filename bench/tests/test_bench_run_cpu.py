"""A whole run of each cell, cut to a size the CPU holds, through the same
harness (only the look for a card is skipped), and the reference held
to the program where both compute in float32."""
import json

import pytest
import torch

from bench.tests import tiny



@pytest.mark.parametrize("case", tiny.CASES, ids=lambda c: ".".join(c))
@pytest.mark.parametrize("trace", [False, True])
def test_run_result_line(case, trace):
    c = tiny.cell(*case)
    res, info, lines = tiny.run(c, trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "check"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    reported = set(res["metrics"])
    want = {m.name for m in c.metrics(trace)}
    assert reported <= want
    if not trace:
        assert {"output_tokens_per_s", "setup_s"} <= reported
    else:      # the device's metrics need the card's trace
        assert {"chunk_tick_share", "decode_batch_mean"} <= reported
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert [ln.split()[1] for ln in lines[-len(c.limits):]] == list(c.limits)
    assert list(res["check"]) == list(c.limits)
    assert info["chunks_sound"] and info["requests_compared"] >= 1
    json.dumps(res)


def test_same_seed_same_tokens():
    c = tiny.cell()
    _, a, _ = tiny.run(c, seed=5)
    _, b, _ = tiny.run(c, seed=5)
    assert a["gap_per_request"][0] == b["gap_per_request"][0]


def test_reference_equals_program_in_float32():
    """With float32 weights the reference gives the served tokens exactly,
    capacity drops included (factor 0.25, 64-token chunks); the MoE's
    reference follows the program's recorded routes, which are its own
    and drop what its capacity rule drops."""
    for config, over in (("yi-6b", {}),
                         ("qwen3-30b-a3b", {"capacity_factor": 0.25})):
        c = tiny.cell(config, torch_dtype="float32", **over)
        if over:
            c.config["engine"]["prefill_chunk"] = 64
            c.traffic["prompt_len"].update(median=80, min=40, max=120)
        res, info, _ = tiny.run(c)
        assert info["max_logit_gap"] == 0.0
        assert info["disagree_share"] == 0.0
        if over:
            assert info["route_fault"] is None
            assert info["route_slack_max"] == 0.0
            assert info["route_flip_share"] == 0.0
            assert info["prefill_drop_mismatches"] == 0
            assert info["decode_drop_mismatches"] == 0
            assert info["decode_steps_recounted"] > 0


def test_capacity_rule_is_followed():
    """Without the capacity rule the reference departs from the program
    where it drops pairs."""
    from bench.reference.transformer import Reference
    c = tiny.cell("qwen3-30b-a3b", torch_dtype="float32",
                  capacity_factor=0.25)
    from bench.harness import weights
    params = weights.make(c.config, 3, "cpu")
    seq = torch.randint(0, 512, (120,), generator=torch.Generator()
                        .manual_seed(0))
    ref = Reference(c.config, params, prefill_chunk=64)
    e = ref._route(torch.randn(64, 128), {"moe": {
        "router": params["blocks"]["moe"]["router"][0]}})[1]
    assert not ref._kept(e, 64).all()
    with_cap = ref.logits([seq], [100])[0]
    ref.factor = 0.0
    dropless = ref.logits([seq], [100])[0]
    assert not torch.allclose(with_cap, dropless)
