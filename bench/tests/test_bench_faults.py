"""The faults the check has to catch, each planted under a whole run of
each cell at the CPU size: a token altered where it is produced, a
decode step that leaves its state unchanged, an RMSNorm that drops its
scale, and the control (the reference in a lower precision).  An MoE,
whose reference follows the program's recorded routing, has four more:
a router that reads the previous layer's weights, expert ids shifted by
one, a pair dropped without the record saying so, and drops the
capacity rule does not make, in every call or in decode steps alone."""
import pytest
import torch

from bench.harness import check
from bench.tests import tiny



def _token_altered(monkeypatch):
    from repro_torch.models import layers as L
    orig = L.unembed

    def unembed(p, h, vocab=None):
        out = orig(p, h, vocab)
        row = out.reshape(-1, out.shape[-1])[0]
        i = int(row.argmax())
        row[(i + 1) % row.numel()] = row[i] + 1.0
        return out
    monkeypatch.setattr(L, "unembed", unembed)


def _state_unchanged(monkeypatch):
    from repro_torch.models import transformer as T
    orig = T.decode_step_paged

    def step(params, cfg, tokens, k_pool, v_pool, *a, **kw):
        k0, v0 = k_pool.clone(), v_pool.clone()
        out = orig(params, cfg, tokens, k_pool, v_pool, *a, **kw)
        k_pool.copy_(k0)
        v_pool.copy_(v0)
        return out
    monkeypatch.setattr(T, "decode_step_paged", step)


def _norm_scale_ignored(monkeypatch):
    from repro_torch.models import layers as L
    orig = L.apply_norm

    def apply_norm(kind, p, x, *a, **kw):
        p = dict(p, scale=torch.ones_like(p["scale"]))
        return orig(kind, p, x, *a, **kw)
    monkeypatch.setattr(L, "apply_norm", apply_norm)


def _router_of_previous_layer(monkeypatch):
    from repro_torch.models import transformer as T
    orig = T.layer_params

    def layer_params(params, li):
        lp = orig(params, li)
        n = params["blocks"]["moe"]["router"].shape[0]
        prev = orig(params, (li - 1) % n)["moe"]["router"]
        return dict(lp, moe=dict(lp["moe"], router=prev))
    monkeypatch.setattr(T, "layer_params", layer_params)


def _experts_shifted(monkeypatch):
    from repro_torch.models import layers as L
    orig = L._route

    def route(p, x, cfg):
        w, e = orig(p, x, cfg)
        return w, (e + 1) % cfg.num_experts
    monkeypatch.setattr(L, "_route", route)


def _pair_dropped_unrecorded(monkeypatch):
    from repro_torch.models import layers as L
    orig = L._moe_partial

    def partial(p, x, weights, *a, **kw):
        weights = weights.clone()
        weights[:, -1] = 0.0         # every token's last pair adds nothing
        return orig(p, x, weights, *a, **kw)
    monkeypatch.setattr(L, "_moe_partial", partial)


def _capacity_below_rule(monkeypatch):
    from repro_torch.models import layers as L
    monkeypatch.setattr(L, "moe_capacity", lambda *a, **kw: 1)


def _capacity_below_rule_in_decode(monkeypatch):
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    step, cap, inside = T.decode_step_paged, L.moe_capacity, []

    def decode_step_paged(*a, **kw):
        inside.append(True)
        try:
            return step(*a, **kw)
        finally:
            inside.pop()

    def moe_capacity(*a, **kw):
        return 1 if inside else cap(*a, **kw)
    monkeypatch.setattr(T, "decode_step_paged", decode_step_paged)
    monkeypatch.setattr(L, "moe_capacity", moe_capacity)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _norm_scale_ignored],
                         ids=["token_altered", "state_unchanged",
                              "norm_scale_ignored"])
@pytest.mark.parametrize("case", tiny.CASES, ids=lambda c: ".".join(c))
def test_fault_is_not_correct(monkeypatch, fault, case):
    c = tiny.cell(*case)
    fault(monkeypatch)
    res, info, _ = tiny.run(c)
    assert not res["correct"], info
    assert res["failed"] >= 1


@pytest.mark.parametrize("fault", [_router_of_previous_layer,
                                   _experts_shifted,
                                   _pair_dropped_unrecorded,
                                   _capacity_below_rule,
                                   _capacity_below_rule_in_decode],
                         ids=["router_of_previous_layer", "experts_shifted",
                              "pair_dropped_unrecorded",
                              "capacity_below_rule",
                              "capacity_below_rule_in_decode"])
def test_routing_fault_is_not_correct(monkeypatch, fault):
    c = tiny.cell("qwen3-30b-a3b", "decode_saturated")
    fault(monkeypatch)
    res, info, _ = tiny.run(c)
    assert not res["correct"], info
    assert res["failed"] >= 1


@pytest.mark.parametrize("case", tiny.CASES, ids=lambda c: ".".join(c))
def test_control_reads_far_above_the_program(case):
    """The control at the CPU size, on three seeds: on each number the
    cell compares that the control reads, its smallest reading at least
    three times the program's largest, the cell run as its configuration
    states (bf16, control float8).  An MoE's control follows the
    program's recorded routing for its gaps, as its reference does, and
    reads its route numbers from its own routing (``route_slack_max``;
    the counts held at 0 are the capacity rule's, not a precision's)."""
    c = tiny.cell(*case)
    runs = [tiny.run(c, seed=seed, control=True)[1] for seed in (11, 12, 13)]
    names = [n for n in c.limits if n in check.NUMBERS
             or (n in check.ROUTE_NUMBERS and n not in check.EXACT)]
    assert names
    if "num_experts" in c.config:
        assert "route_slack_max" in names
    for name in names:
        prog = [i[name] for i in runs]
        ctl = [i["control"][name] for i in runs]
        assert min(ctl) >= 3 * max(prog), (name, prog, ctl)
