"""The routing record (``harness/routes.py``) at the reduced qwen3 size:
what it writes for a prompt chunk and for decode lanes against the
program's own routes and an independent count of the capacity rule; the
ring of whole decode steps and its recount against the rule; the
program's outputs bitwise unchanged under it; a dense cell without it;
a stack whose first layer's FFN is dense, recorded over its MoE layers
alone; and on the card, the same record from the fused graphs as from
the eager per-tick step."""
import numpy as np
import pytest
import torch

from bench.harness import cell as cell_run
from bench.harness import check, routes, weights
from bench.reference.transformer import Reference, moe_layers
from bench.tests import tiny


def _engine(device="cpu", fuse_steps=None, max_prompt=None, **over):
    from repro_torch.models import registry
    from repro_torch.serving.engine import make_engine
    c = tiny.cell("qwen3-30b-a3b", torch_dtype="float32", **over)
    cfg = c.config
    if max_prompt is not None:
        c.traffic["prompt_len"]["max"] = max_prompt
    if fuse_steps is not None:
        cfg["engine"]["fuse_steps"] = fuse_steps
    arch = cell_run.arch_config(cfg)
    ecfg = cell_run.engine_config(cfg, c.traffic, device)
    eng = make_engine(registry.from_config(arch), ecfg,
                      params=weights.make(cfg, 7, device))
    return cfg, arch, eng


def _spy_routes(monkeypatch):
    """Every ``layers._route`` result, in call order."""
    from repro_torch.models import layers as L
    seen, orig = [], L._route

    def route(p, x, cfg):
        seen.append(orig(p, x, cfg)[1].clone())
        return orig(p, x, cfg)
    monkeypatch.setattr(L, "_route", route)
    return seen


def _ranks(e: torch.Tensor) -> torch.Tensor:
    """Each pair's rank within its expert, in token-major order."""
    flat, seen = e.reshape(-1).tolist(), {}
    out = []
    for x in flat:
        out.append(seen.get(x, 0))
        seen[x] = out[-1] + 1
    return torch.tensor(out).view(e.shape)


def _code(e, dropped):
    return torch.where(dropped, -1 - e, e).to(routes.ID_DTYPE)


def test_chunk_record_is_the_route_and_its_capacity(monkeypatch):
    """Two 64-token chunks of one prompt in slot 2: each layer's rows are
    the program's experts, dropped where the capacity rule (the
    reference's count, factor 0.25) drops them; other slots untouched."""
    cfg, arch, eng = _engine(max_prompt=128, capacity_factor=0.25)
    seen = _spy_routes(monkeypatch)
    tap = routes.Tap(eng, len(moe_layers(cfg)), arch.topk)
    ref = Reference(cfg, {}, prefill_chunk=64)
    try:
        cache = eng.entry.cache_zeros(1, eng.ecfg.max_seq, 1, device="cpu")
        toks = torch.randint(0, arch.vocab, (1, 128),
                             generator=torch.Generator().manual_seed(1))
        for pos in (0, 64):
            eng._prefilling = {"slot": 2, "pos": pos}
            _, cache = eng._extend(eng.params, toks[:, pos:pos + 64], cache)
    finally:
        eng._prefilling = None
        tap.remove()
    assert tap.fault is None
    assert len(seen) == 2 * arch.num_layers
    s = tap.rows_per_slot
    drops = 0
    for i, e in enumerate(seen):
        pos, li = 64 * (i // arch.num_layers), i % arch.num_layers
        keep = ref._kept(e, 64)
        drops += int((~keep).sum())
        rows = tap.buf[2 * s + pos:2 * s + pos + 64, li]
        assert torch.equal(rows, _code(e, ~keep)), (pos, li)
    assert drops > 0
    assert not tap.buf[:2 * s].any() and not tap.buf[3 * s:].any()
    assert (tap.row_step == -1).all()          # no decode step wrote
    assert not tap.decode_steps()[0].shape[0]


def test_decode_record_is_the_route_and_its_capacity(monkeypatch):
    """Two decode steps over four lanes, two of them outside the batch
    (tables on the scratch page), at a capacity of 1: the lanes' rows
    ``(slot, length)`` hold the experts, dropped past rank 1, and the
    step that wrote them; the idle lanes write only the scratch row;
    the ring holds both steps, every lane of each."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg, arch, eng = _engine()
    monkeypatch.setattr(L, "moe_capacity", lambda *a, **kw: 1)
    seen = _spy_routes(monkeypatch)
    tap = routes.Tap(eng, len(moe_layers(cfg)), arch.topk)
    paged = eng.paged
    kp, vp = [t for t, q in zip(paged.store, paged.is_seq) if q]
    scratch = kp.shape[1] - 1
    tables = torch.full((4, paged.max_blocks), scratch, dtype=torch.int32)
    tables[0, :2], tables[2, :2] = torch.tensor([0, 1]), torch.tensor([2, 3])
    lengths = torch.tensor([7, 0, 12, 0], dtype=torch.int32)
    try:
        for toks in ([1, 2, 3, 4], [5, 6, 7, 8]):
            T.decode_step_paged(eng.params, eng.cfg, torch.tensor(toks),
                                kp, vp, tables, lengths)
    finally:
        tap.remove()
    assert tap.fault is None and len(seen) == 2 * arch.num_layers
    s = tap.rows_per_slot
    ring, ring_steps = tap.decode_steps()
    assert ring.shape == (2, 4, arch.num_layers, arch.topk)
    assert ring_steps[1] == ring_steps[0] + 1
    drops = 0
    for i, e in enumerate(seen):
        step, li = divmod(i, arch.num_layers)
        dropped = _ranks(e) >= 1
        drops += int(dropped.sum())
        code = _code(e, dropped)
        assert torch.equal(ring[step, :, li], code)
        if step == 1:
            assert torch.equal(tap.buf[7, li], code[0])
            assert torch.equal(tap.buf[2 * s + 12, li], code[2])
    assert drops > 0
    assert tap.row_step[7] == tap.row_step[2 * s + 12] == ring_steps[1]
    written = tap.buf[:-1].reshape(-1, arch.num_layers * arch.topk)
    assert set(written.any(-1).nonzero()[:, 0].tolist()) <= {7, 2 * s + 12}
    assert tap.buf[-1].any()            # the idle lanes' scratch row


def test_decode_steps_held_to_the_capacity_rule():
    """The reference's recount of whole decode steps (64 lanes of top 2
    of 8 experts, C = 16) against an independent count: drops by the
    rule read 0; a drop the rule does not make, or a smaller C, reads
    each pair it changes.  A sampled row that differs from its step's
    lane in the ring is a recording fault."""
    cfg = tiny.cell("qwen3-30b-a3b", capacity_factor=0.25).config
    ref = Reference(cfg, {}, prefill_chunk=16)
    g = torch.Generator().manual_seed(5)
    steps, lanes, layers, k = 6, 64, 2, 2
    # lane-skewed draws, so some experts pass 16 pairs a step
    pick = torch.multinomial(torch.tensor([6.0, 3, 2, 1, 1, 1, 1, 1]),
                             steps * lanes * layers * k, replacement=True,
                             generator=g)
    e = torch.stack([torch.randperm(8, generator=g)[:k] for _ in
                     range(steps * lanes * layers)])
    e = torch.where(torch.rand(e.shape, generator=g) < 0.5,
                    e, pick.view(-1, k) % 8)
    e[:, 1] = torch.where(e[:, 1] == e[:, 0], (e[:, 0] + 1) % 8, e[:, 1])
    e = e.view(steps, lanes, layers, k)
    rank = torch.stack([torch.stack([_ranks(e[s_, :, li])
                                     for li in range(layers)], 1)
                        for s_ in range(steps)])
    ring = _code(e, rank >= 16)
    assert (rank >= 16).any()
    assert ref.decode_drop_mismatches(ring) == 0
    bad = ring.clone()
    i = (rank < 16).nonzero()[0].tolist()
    bad[tuple(i)] = -1 - bad[tuple(i)]
    assert ref.decode_drop_mismatches(bad) == 1
    small = _code(e, rank >= 8)
    want = int(((rank >= 8) & (rank < 16)).sum())
    assert want > 0 and ref.decode_drop_mismatches(small) == want
    # the records of two sampled requests, slots 3 and 10
    ring_steps = torch.arange(100, 100 + steps)
    rec = [ring[[0, 2, 5], 3], ring[[1, 4], 10]]
    st = [torch.tensor([100, 102, 105]), torch.tensor([101, 104])]
    got, fault = check.decode_record(ref, ring, ring_steps, rec, st,
                                     [3, 10])
    assert fault is None and got["decode_drop_mismatches"] == 0
    assert got["decode_rows_in_ring"] == 5
    rec[1] = rec[1].clone()
    rec[1][0, 0, 0] += 1
    # a prompt row (-1) and a step gone from the ring are not linked
    st[0] = torch.tensor([-1, 102, 99])
    got, fault = check.decode_record(ref, ring, ring_steps, rec, st,
                                     [3, 10])
    assert got["decode_rows_in_ring"] == 3 and fault.startswith("1 ")


def _chunk_then_step(eng, arch, lengths):
    """One 16-token prompt chunk in slot 1, then one decode step of four
    lanes of ``lengths``, each lane on pages of its own: their logits."""
    from repro_torch.models import transformer as T
    paged = eng.paged
    kp, vp = [t for t, q in zip(paged.store, paged.is_seq) if q]
    tables = torch.arange(4 * paged.max_blocks, dtype=torch.int32).view(
        4, -1) % (kp.shape[1] - 1)
    toks = torch.randint(0, arch.vocab, (1, 16),
                         generator=torch.Generator().manual_seed(2))
    eng._prefilling = {"slot": 1, "pos": 0}
    try:
        cache = eng.entry.cache_zeros(1, eng.ecfg.max_seq, 1, device="cpu")
        chunk, _ = eng._extend(eng.params, toks, cache)
    finally:
        eng._prefilling = None
    step, _ = T.decode_step_paged(
        eng.params, eng.cfg, torch.tensor([1, 2, 3, 4]), kp, vp, tables,
        torch.as_tensor(lengths, dtype=torch.int32))
    return chunk, step


def _unchanged_under_the_record(eng, arch, n_moe: int):
    """Assert that a prompt chunk's and a decode step's logits are the
    same, bit for bit, with a record of ``n_moe`` MoE layers and
    without, on the same inputs; the tap."""
    lengths = [3, 9, 0, 20]
    plain = _chunk_then_step(eng, arch, lengths)
    tap = routes.Tap(eng, n_moe, arch.topk)
    try:
        tapped = _chunk_then_step(eng, arch, lengths)
    finally:
        tap.remove()
    assert tap.buf.any()
    for a, b in zip(plain, tapped):
        assert torch.equal(a, b)
    return tap


def test_outputs_bitwise_unchanged_under_the_record():
    """A prompt chunk's and a decode step's logits, with the record and
    without, on the same inputs."""
    cfg, arch, eng = _engine()
    _unchanged_under_the_record(eng, arch, len(moe_layers(cfg)))


def _dense_first_layer(monkeypatch, eng) -> None:
    """Make ``eng`` the stand-in of a stack whose first layer's FFN is
    dense: layer 0's MoE call computes the gated FFN of its expert 0's
    weights and routes nothing; every other layer's call is the
    program's."""
    from repro_torch.models import layers as L
    first = eng.params["blocks"]["moe"]["router"][0].data_ptr()
    orig = L.apply_moe

    def apply_moe(p, x, cfg):
        if p["router"].data_ptr() != first:
            return orig(p, x, cfg)
        ffn = {k: p[k][0] for k in ("w_up", "w_gate", "w_down")}
        return L.apply_ffn(ffn, x, cfg.act).to(x.dtype)
    monkeypatch.setattr(L, "apply_moe", apply_moe)


def test_dense_first_layer_recorded_over_its_moe_layers(monkeypatch):
    """A 3-layer stand-in whose first layer's FFN is dense, recorded
    with ``n_moe = L - 1`` at a capacity of 1: a prompt chunk's rows and
    a decode step's lanes hold at ordinal ``j`` the experts of layer
    ``j + 1`` (the stand-in's own ``_route`` calls, in order), dropped
    past rank 1; no fault."""
    from repro_torch.models import layers as L
    _, arch, eng = _engine(num_hidden_layers=3)
    _dense_first_layer(monkeypatch, eng)
    monkeypatch.setattr(L, "moe_capacity", lambda *a, **kw: 1)
    seen = _spy_routes(monkeypatch)
    n, k = arch.num_layers - 1, arch.topk
    tap = routes.Tap(eng, n, k)
    # lane 1's row (slot 1, position 20) lies past the chunk's 16 rows
    lengths = [3, 20, 0, 9]
    try:
        _chunk_then_step(eng, arch, lengths)
    finally:
        tap.remove()
    assert tap.fault is None and len(seen) == 2 * n
    s = tap.rows_per_slot
    chunk = tap.buf[s:s + 16]
    ring, _ = tap.decode_steps()
    assert chunk.shape == (16, n, k) and ring.shape == (1, 4, n, k)
    drops = 0
    for j in range(n):
        e, d = seen[j], seen[n + j]
        drops += int((_ranks(e) >= 1).sum() + (_ranks(d) >= 1).sum())
        assert torch.equal(chunk[:, j], _code(e, _ranks(e) >= 1)), j
        assert torch.equal(ring[0, :, j], _code(d, _ranks(d) >= 1)), j
        for lane, at in enumerate(lengths):
            assert torch.equal(tap.buf[lane * s + at, j], ring[0, lane, j])
    assert drops > 0


def test_dense_first_layer_held_to_every_layer_faults(monkeypatch):
    """The same stand-in recorded as if every layer routed
    (``n_moe = L``): the prompt chunk and the decode step each route
    through L - 1 MoE layers, and the record says so."""
    _, arch, eng = _engine(num_hidden_layers=3)
    _dense_first_layer(monkeypatch, eng)
    tap = routes.Tap(eng, arch.num_layers, arch.topk)
    try:
        _chunk_then_step(eng, arch, [3, 20, 0, 9])
    finally:
        tap.remove()
    assert tap.fault == "2 MoE layers recorded in a call of 3"


def test_outputs_bitwise_unchanged_under_the_record_of_a_dense_first_layer(
        monkeypatch):
    """The stand-in's chunk and step logits, with its record of L - 1
    MoE layers and without, on the same inputs; the record sound."""
    _, arch, eng = _engine(num_hidden_layers=3)
    _dense_first_layer(monkeypatch, eng)
    tap = _unchanged_under_the_record(eng, arch, arch.num_layers - 1)
    assert tap.fault is None


def test_record_removed_after_each_run_and_absent_for_dense():
    """A run puts back every function it wrapped; a dense cell records
    nothing and prints no route number."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    before = (L._route, L.moe_capacity, L._local_ranks,
              T.decode_step_paged)
    _, moe, _ = tiny.run(tiny.cell("qwen3-30b-a3b"), ticks=10)
    assert moe["route_fault"] is None and moe["route_slack_max"] >= 0
    _, dense, _ = tiny.run(tiny.cell("yi-6b"), ticks=10)
    assert (L._route, L.moe_capacity, L._local_ranks,
            T.decode_step_paged) == before
    assert "route_fault" not in dense and "route_slack_max" not in dense


def test_record_spans_each_served_sequence():
    """A retired request's record has a row for every position the
    reference scores (prompt and served tokens but the last), each row
    a set of distinct experts."""
    cfg, arch, eng = _engine()
    from repro_torch.serving.scheduler import make_trace
    reqs = make_trace(
        arch.vocab, rate_req_s=1e9, n_requests=5, prompt_len=0,
        prompt_lens=np.array([9, 30, 17, 40, 5]), seed=3)
    tap = routes.Tap(eng, len(moe_layers(cfg)), arch.topk)
    try:
        eng.run_trace(reqs)
    finally:
        tap.remove()
    assert tap.fault is None
    assert sorted(tap.routes) == sorted(r.rid for r in eng.completed)
    for r in eng.completed:
        rec = tap.routes[r.rid]
        assert rec.shape == (len(r.prompt) + len(r.tokens_out) - 1,
                             arch.num_layers, arch.topk)
        e = rec.long()
        e = torch.where(e < 0, -1 - e, e)
        assert (e.sort(-1).values.diff(dim=-1) > 0).all()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the fused decode's CUDA graphs)")
    return "cuda"


@pytest.mark.cuda
def test_cuda_graph_record_equals_eager(card):
    """The same trace through the fused engine (the 1-step graph and the
    bucketed horizons, replayed) and the eager per-tick engine: every
    retired request's record is the same, bit for bit; each engine's
    ring of decode steps keeps the capacity rule, and every retired row
    whose step is in it equals the step's lane there."""
    got = []
    for fuse in (4, 1):
        cfg, arch, eng = _engine(card, fuse_steps=fuse)
        from repro_torch.serving.scheduler import make_trace
        reqs = make_trace(
            arch.vocab, rate_req_s=1e9, n_requests=6, prompt_len=0,
            prompt_lens=np.array([9, 17, 5, 30, 12, 24]), seed=3)
        tap = routes.Tap(eng, len(moe_layers(cfg)), arch.topk)
        try:
            eng.run_trace(reqs)
        finally:
            tap.remove()
        assert tap.fault is None
        rids = sorted(tap.routes)
        held, fault = check.decode_record(
            Reference(cfg, {}, prefill_chunk=eng.ecfg.prefill_chunk),
            *tap.decode_steps(), [tap.routes[i] for i in rids],
            [tap.steps[i] for i in rids], [tap.slots[i] for i in rids])
        assert fault is None and held["decode_drop_mismatches"] == 0
        assert held["decode_rows_in_ring"] > 0
        got.append(({r.rid: list(r.tokens_out) for r in eng.completed},
                    {k: v.cpu() for k, v in tap.routes.items()}))
        if fuse > 1:
            assert eng._fused_graphs and eng._fused_graphs[1].replays > 0
            assert any(g.replays for k, g in eng._fused_graphs.items()
                       if k > 1)
    (tok_f, rec_f), (tok_e, rec_e) = got
    assert tok_f == tok_e and sorted(rec_f) == sorted(rec_e)
    for rid in rec_f:
        assert torch.equal(rec_f[rid], rec_e[rid]), rid
