"""The faults the check has to catch, each planted under a whole run of
each cell at the CPU size: a token altered where it is produced, a
decode step that leaves its state unchanged, an RMSNorm that drops its
scale, and the control (the reference in a lower precision)."""
import pytest
import torch

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


@pytest.mark.parametrize("case", [c for c in tiny.CASES
                                  if c[0] == "yi-6b"],
                         ids=lambda c: ".".join(c))
def test_control_reads_far_above_the_program(case):
    """The control at the CPU size, on three seeds: on each number the
    cell compares, its smallest reading at least three times the
    program's largest, the cell run as its configuration states (bf16,
    control float8).  Dense cells only: at these widths a bf16 MoE's
    routing flips as often under the program's rounding as under
    float8."""
    c = tiny.cell(*case)
    runs = [tiny.run(c, seed=seed, control=True)[1] for seed in (11, 12, 13)]
    for name in c.limits:
        prog = [i[name] for i in runs]
        ctl = [i["control"][name] for i in runs]
        assert min(ctl) >= 3 * max(prog), (name, prog, ctl)
