"""RecurrentGemma: RG-LRU recurrent blocks and local sliding-window
attention, interleaved 2:1 as (rec, rec, attn) (port of
``repro.models.rglru``).

The RG-LRU recurrence  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
is a data-gated linear recurrence: prefill runs it over the whole prompt
with a log-depth doubling scan (``_lru_seq``; the reference uses
``lax.associative_scan``), decode keeps O(1) state per layer.

Layer schedule: ``num_layers // 3`` groups of (rec, rec, attn) and a
recurrent tail of the rest (38 = 12 * 3 + 2), walked by Python loops
over the reference's stacked tree (``rec_groups`` with leading
``(G, 2)``, ``attn_groups`` with ``(G,)``, ``rec_tail``).  Local
attention keeps a ``window``-sized rolling KV cache whose slots carry
their absolute positions (-1 = empty).  ``decode_step`` writes the new
state into the ``RGState`` tensors it was given, in place.

Under a bound mesh whose "model" axis has P > 1 ranks, each rank holds
the shards of ``distributed.sharding.param_pspecs`` and the state's
shards of ``cache_pspecs``.  A recurrent block runs W/P channels: its
input projections are column-parallel, the conv and the recurrence are
per channel (its ``lru_h`` and ``conv`` state W-sharded), the gates'
``(W, W)`` weights hold row shards, so their partial products are summed
over "model" before this rank's W/P columns are taken, and ``w_out`` is
row-parallel.  The attention block gathers q, k and v
(``layers.qkv_project``) and its ``wo`` is row-parallel.  The rolling
window is held sharded over its slots: decode gathers it, rolls,
attends, and keeps this rank's slots (a roll moves a slot from rank r+1
to rank r); prefill keeps its slots of the window.  Under FSDP each
layer is gathered where it runs, inside the recomputed group.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.distributed import collectives as C
from repro_torch.distributed import context
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]
C_LRU = 8.0


def _pattern_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(#groups, #tail-rec-layers) with group = (rec, rec, attn)."""
    groups = cfg.num_layers // 3
    return groups, cfg.num_layers - groups * 3


class RGState(NamedTuple):
    lru_h: torch.Tensor      # (Lr, B, W) recurrent hidden (float32)
    conv: torch.Tensor       # (Lr, B, conv_width-1, W) conv lookback
    k_cache: torch.Tensor    # (La, B, window, Hkv, D)
    v_cache: torch.Tensor
    pos_cache: torch.Tensor  # (La, B, window) absolute positions, -1 empty
    lengths: torch.Tensor    # (B,) int32

    @staticmethod
    def zeros(cfg: ArchConfig, batch: int, device="cuda",
              width: Optional[int] = None,
              slots: Optional[int] = None) -> "RGState":
        """The empty state; ``width`` / ``slots`` give one model rank's
        shard of the recurrent width and of the window."""
        groups, tail = _pattern_counts(cfg)
        lr, la = groups * 2 + tail, groups
        w = width or cfg.lru_width or cfg.d_model
        win = slots or cfg.window
        _, hkv = cfg.padded_heads(1)
        dt = L._dtype(cfg.dtype)
        dev = resolve(device)
        kv = (la, batch, win, hkv, cfg.d_head)
        return RGState(
            torch.zeros((lr, batch, w), dtype=torch.float32, device=dev),
            torch.zeros((lr, batch, cfg.conv_width - 1, w), dtype=dt,
                        device=dev),
            torch.zeros(kv, dtype=dt, device=dev),
            torch.zeros(kv, dtype=dt, device=dev),
            torch.full((la, batch, win), -1, dtype=torch.int32,
                       device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_rec_layer(gen, cfg: ArchConfig, dtype, dev, lead) -> Params:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    scale_o = 0.02 / math.sqrt(2 * cfg.num_layers)
    lam = torch.empty((*lead, w), dtype=torch.float32, device=dev)
    if dev.type != "meta":
        lam.uniform_(0.9, 0.999, generator=gen)

    def dense(d_in, d_out, scale=0.02):
        return L.dense_init(gen, (*lead, d_in, d_out), dtype, scale=scale,
                            device=dev)

    def zeros(dt):
        return torch.zeros((*lead, w), dtype=dt, device=dev)

    return {
        "ln": L.init_norm(cfg.norm, d, device=dev, lead=lead),
        "w_in_x": dense(d, w),
        "w_in_gate": dense(d, w),
        "conv_w": L.dense_init(gen, (*lead, cfg.conv_width, w), dtype,
                               device=dev),
        "conv_b": zeros(dtype),
        "lru": {"lam": lam, "w_a": dense(w, w), "b_a": zeros(torch.float32),
                "w_i": dense(w, w), "b_i": zeros(torch.float32)},
        "w_out": dense(w, d, scale_o),
        "mlp": L.init_ffn(gen, d, cfg.d_ff, cfg.gated_ffn, dtype,
                          cfg.num_layers, device=dev, lead=lead),
        "ln_mlp": L.init_norm(cfg.norm, d, device=dev, lead=lead),
    }


def init(cfg: ArchConfig, tp: int = 1, *, device="cuda",
         seed: int = 0) -> Params:
    """Random parameters with the reference's tree, shapes, dtypes and
    distributions, drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (``"meta"`` gives an undrawn shape template)."""
    dev = resolve(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    dtype = L._dtype(cfg.dtype)
    hq, hkv = cfg.padded_heads(tp)
    groups, tail = _pattern_counts(cfg)
    d = cfg.d_model
    attn = {
        "ln": L.init_norm(cfg.norm, d, device=dev, lead=(groups,)),
        "attn": L.init_attention(gen, cfg, dtype, hq, hkv, device=dev,
                                 lead=(groups,)),
        "ln_mlp": L.init_norm(cfg.norm, d, device=dev, lead=(groups,)),
        "mlp": L.init_ffn(gen, d, cfg.d_ff, cfg.gated_ffn, dtype,
                          cfg.num_layers, device=dev, lead=(groups,)),
    }
    p = {"embed": L.init_embed(gen, cfg.padded_vocab(tp), d, dtype,
                               cfg.tie_embeddings, device=dev),
         "rec_groups": _init_rec_layer(gen, cfg, dtype, dev, (groups, 2)),
         "attn_groups": attn,
         "ln_f": L.init_norm(cfg.norm, d, device=dev)}
    if tail:
        p["rec_tail"] = _init_rec_layer(gen, cfg, dtype, dev, (tail,))
    return p


def layer_stacks(cfg: ArchConfig):
    """The stacked layer subtrees and their leading layer dims (what the
    FSDP gatherer walks)."""
    groups, tail = _pattern_counts(cfg)
    out = {"rec_groups": (groups, 2), "attn_groups": (groups,)}
    if tail:
        out["rec_tail"] = (tail,)
    return out


def _take(tree: Params, *idx) -> Params:
    """One layer's slice of a stacked tree (views, no copy)."""
    return {k: _take(v, *idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


def _stack(params: Params, name: str) -> list:
    """This rank's per-layer pieces of the stack ``name`` (each leaf
    unbound once, see ``layers.unstack``; the groups' two recurrent
    layers flattened in order); under FSDP the gatherer's pieces, which
    :func:`_full` gathers where the layer runs."""
    if name not in params:
        return []
    fs = context.fsdp()
    if fs is not None:
        return fs.pieces(params[name], name)
    if name == "rec_groups":
        return [lp for gp in L.unstack(params[name]) for lp in L.unstack(gp)]
    return L.unstack(params[name])


def _full(lp: Params, name: str, i: int) -> Params:
    """Layer ``i`` of the stack ``name`` from :func:`_stack`'s piece,
    gathered over the data axes under FSDP."""
    fs = context.fsdp()
    return lp if fs is None else fs.layer(lp, i, name)


def _rec_layers(params: Params):
    """The recurrent layers in state order, each with its stack and
    index: the groups' two layers each, then the tail."""
    return ([(lp, "rec_groups", i)
             for i, lp in enumerate(_stack(params, "rec_groups"))]
            + [(lp, "rec_tail", i)
               for i, lp in enumerate(_stack(params, "rec_tail"))])


def _width(cfg: ArchConfig) -> int:
    return cfg.lru_width or cfg.d_model


def _local_width(cfg: ArchConfig) -> int:
    """This rank's recurrent channels: W, or W/P where a model axis of P
    ranks cuts them."""
    return _width(cfg) // L.model_parts(_width(cfg))


def _own_slots(t: torch.Tensor, parts: int) -> torch.Tensor:
    """This rank's slots (dim 1) of a whole window ``t``."""
    if parts == 1:
        return t
    n = t.shape[1] // parts
    return t.narrow(1, L._require_model_mesh().coord("model") * n, n)


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------
def _lru_gates(lp: Params, x: torch.Tensor):
    """x: (..., W) -> (a, gated input), both float32 whatever x's dtype
    (the reference computes the gates in float32 on purpose).  Where
    ``w_a`` / ``w_i`` hold a row shard (x this rank's W/P channels),
    their partial products are summed over "model" in one reduction and
    this rank's W/P columns taken."""
    xf = x.float()
    if lp["w_a"].shape[-2] < lp["w_a"].shape[-1]:
        mesh = L._require_model_mesh()
        za, zi = C.all_reduce(torch.cat(
            [xf @ lp["w_a"].float(), xf @ lp["w_i"].float()], -1), mesh,
            "model").chunk(2, -1)
        za, zi = (C.split(z, mesh, "model", z.ndim - 1) for z in (za, zi))
    else:
        za, zi = xf @ lp["w_a"].float(), xf @ lp["w_i"].float()
    r = torch.sigmoid(za + lp["b_a"])
    i = torch.sigmoid(zi + lp["b_i"])
    log_a = -C_LRU * F.softplus(lp["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated


def _lru_seq(lp: Params, x: torch.Tensor, h0: torch.Tensor):
    """The recurrence over the sequence.  x: (B, S, W); h0: (B, W) ->
    (h (B, S, W), h_S (B, W)), float32.

    A log-depth doubling scan (Hillis-Steele) of the associative pairs
    (a, b) with (a_l, b_l) . (a_r, b_r) = (a_l a_r, a_r b_l + b_r): after
    the pass of span ``n`` each position holds the combination of the
    ``2n`` pairs ending there.  The same function as the reference's
    ``lax.associative_scan``, summed in another order.
    """
    a, b = _lru_gates(lp, x)                              # (B, S, W)
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    s = x.shape[1]
    n = 1
    while n < s:
        b = torch.cat([b[:, :n], a[:, n:] * b[:, :-n] + b[:, n:]], dim=1)
        a = torch.cat([a[:, :n], a[:, :-n] * a[:, n:]], dim=1)
        n *= 2
    return b, b[:, -1]


def _lru_step(lp: Params, x_t: torch.Tensor, h: torch.Tensor):
    a, b = _lru_gates(lp, x_t)                            # (B, W)
    return a * h + b


def _conv1d_seq(lp: Params, x: torch.Tensor, lookback: torch.Tensor):
    """Causal temporal conv of width cw.  x: (B, S, W); lookback: (B,
    cw-1, W).  The cw products are summed one at a time in x's dtype, in
    the reference's order."""
    cw = lp["conv_w"].shape[0]
    s = x.shape[1]
    xx = torch.cat([lookback.to(x.dtype), x], dim=1)
    out = sum(xx[:, i:i + s] * lp["conv_w"][i][None, None, :]
              for i in range(cw))
    new_lookback = xx[:, xx.shape[1] - (cw - 1):] if cw > 1 else lookback
    return out + lp["conv_b"], new_lookback


def _rec_block_seq(cfg: ArchConfig, lp: Params, x: torch.Tensor,
                   h0: torch.Tensor, conv0: torch.Tensor):
    """x: (B, S, d) -> (x, h_S, conv lookback)."""
    h = L.apply_norm(cfg.norm, lp["ln"], x)
    gate, xx = _rec_in(cfg, lp, h)
    xx, conv = _conv1d_seq(lp, xx, conv0)
    y, h_last = _lru_seq(lp["lru"], xx, h0)
    x = x + _rec_out(cfg, lp, y.to(gate.dtype) * gate)
    m = L.apply_norm(cfg.norm, lp["ln_mlp"], x)
    return x + L.apply_ffn(lp["mlp"], m, cfg.act, d_ff=cfg.d_ff), h_last, \
        conv


def _rec_in(cfg: ArchConfig, lp: Params, h: torch.Tensor):
    """The recurrent block's gate and input branches (this rank's W/P
    channels of each where the projections are column shards)."""
    w = _width(cfg)
    gate = L._act("gelu", L.column_input(h, lp["w_in_gate"], w)
                  @ lp["w_in_gate"])              # jax.nn.gelu: tanh form
    return gate, L.column_input(h, lp["w_in_x"], w) @ lp["w_in_x"]


def _rec_out(cfg: ArchConfig, lp: Params, y: torch.Tensor) -> torch.Tensor:
    """``y @ w_out``, row-parallel where ``y`` is this rank's channels."""
    if lp["w_out"].shape[-2] < _width(cfg):
        return L.row_reduce(y, lp["w_out"])
    return y @ lp["w_out"]


def _attn_block_seq(cfg: ArchConfig, lp: Params, x: torch.Tensor,
                    positions: torch.Tensor, hq: int, hkv: int):
    h = L.apply_norm(cfg.norm, lp["ln"], x)
    q, k, v = L.qkv_project(lp["attn"], h, hq, hkv, cfg.d_head)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    attn = L.blocked_attention(q, k, v, causal=True, window=cfg.window)
    b, s = x.shape[:2]
    x = x + L.row_parallel(attn.reshape(b, s, hq * cfg.d_head),
                           lp["attn"]["wo"])
    m = L.apply_norm(cfg.norm, lp["ln_mlp"], x)
    return x + L.apply_ffn(lp["mlp"], m, cfg.act, d_ff=cfg.d_ff), k, v


def _layers_seq(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                tp: int, remat: bool = False):
    """Every layer over the whole sequence from a zero state: the
    final-normed hidden states, each attention layer's (k, v) and each
    recurrent layer's (h_S, conv lookback), in state order.  ``remat``
    recomputes each (rec, rec, attn) group in backward (the reference's
    per-group ``jax.checkpoint``; the tail is not checkpointed)."""
    hq, hkv = cfg.padded_heads(tp)
    groups, _ = _pattern_counts(cfg)
    x = L.embed(params["embed"], tokens, cfg.d_model)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    w = _local_width(cfg)
    h0 = torch.zeros((b, w), dtype=torch.float32, device=x.device)
    conv0 = torch.zeros((b, cfg.conv_width - 1, w), dtype=x.dtype,
                        device=x.device)
    rec = _rec_layers(params)
    attn = _stack(params, "attn_groups")

    def group(x, g):
        x, h1, c1 = _rec_block_seq(cfg, _full(*rec[2 * g]), x, h0, conv0)
        x, h2, c2 = _rec_block_seq(cfg, _full(*rec[2 * g + 1]), x, h0,
                                   conv0)
        x, k, v = _attn_block_seq(cfg, _full(attn[g], "attn_groups", g), x,
                                  positions, hq, hkv)
        return x, k, v, h1, c1, h2, c2

    kvs, states = [], []
    for g in range(groups):
        x, k, v, h1, c1, h2, c2 = L.remat(group, x, g) if remat \
            else group(x, g)
        kvs.append((k, v))
        states += [(h1, c1), (h2, c2)]
    for layer in rec[2 * groups:]:
        x, h_last, conv = _rec_block_seq(cfg, _full(*layer), x, h0, conv0)
        states.append((h_last, conv))
    return L.apply_norm(cfg.norm, params["ln_f"], x), kvs, states


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def forward_seq(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                tp: int = 1, remat: bool = True):
    """tokens (B, S) -> (hidden (B, S, d), (k, v) stacked over the
    attention layers)."""
    x, kvs, _ = _layers_seq(params, cfg, tokens, tp, remat)
    if not kvs:
        return x, None
    return x, (torch.stack([k for k, _ in kvs]),
               torch.stack([v for _, v in kvs]))


def loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
         tp: int = 1) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels``, optional ``mask``)."""
    h, _ = forward_seq(params, cfg, batch["tokens"], tp=tp)
    return L.lm_loss_chunked(params["embed"], h, batch["labels"],
                             batch.get("mask"), vocab=cfg.padded_vocab(tp))


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            tp: int = 1, max_seq: Optional[int] = None):
    """Process the prompt from a zero state; returns (last_logits,
    RGState) with the final recurrent states and each attention layer's
    last ``window`` keys and values (this rank's slots of them where the
    window is sharded).  ``max_seq`` is accepted for the engine's
    protocol: the state does not grow with the context."""
    x, kvs, states = _layers_seq(params, cfg, tokens, tp)
    b, s = tokens.shape
    win = cfg.window
    parts = L.model_parts(win)
    state = RGState.zeros(cfg, b, device=x.device,
                          width=_local_width(cfg),
                          slots=win // parts)
    for j, (h_last, conv) in enumerate(states):
        state.lru_h[j] = h_last
        state.conv[j] = conv
    pos = torch.arange(s, device=x.device)
    for g, (k, v) in enumerate(kvs):
        if s >= win:                          # keep the last `win`
            kw, vw, pw = k[:, s - win:], v[:, s - win:], pos[s - win:]
        else:
            # left-pad: the newest entry sits at the end, so the decode
            # roll evicts the padding first, then the true oldest token
            pad = (0, 0, 0, 0, win - s, 0)
            kw = torch.nn.functional.pad(k, pad)
            vw = torch.nn.functional.pad(v, pad)
            pw = torch.nn.functional.pad(pos, (win - s, 0), value=-1)
        state.k_cache[g] = _own_slots(kw, parts)
        state.v_cache[g] = _own_slots(vw, parts)
        state.pos_cache[g] = _own_slots(pw[None].expand(b, win), parts)
    logits = L.unembed(params["embed"], x[:, -1], cfg.padded_vocab(tp))
    return logits, state._replace(lengths=torch.full(
        (b,), s, dtype=torch.int32, device=x.device))


def _rec_block_step(cfg: ArchConfig, lp: Params, x: torch.Tensor,
                    h0: torch.Tensor, conv0: torch.Tensor):
    """Single-token recurrent block.  x: (B, d) -> (x, (h, lookback))."""
    h = L.apply_norm(cfg.norm, lp["ln"], x)
    gate, xx = _rec_in(cfg, lp, h)                        # (B, W)
    hist = torch.cat([conv0.to(xx.dtype), xx[:, None]], dim=1)
    cw = lp["conv_w"].shape[0]
    y = sum(hist[:, i] * lp["conv_w"][i][None, :] for i in range(cw))
    y = y + lp["conv_b"]
    hstate = _lru_step(lp["lru"], y, h0)
    x = x + _rec_out(cfg, lp, hstate.to(gate.dtype) * gate)
    m = L.apply_norm(cfg.norm, lp["ln_mlp"], x)
    return x + L.apply_ffn(lp["mlp"], m, cfg.act, d_ff=cfg.d_ff), \
        (hstate, hist[:, 1:])


def _attn_block_step(cfg: ArchConfig, lp: Params, x: torch.Tensor,
                     kc: torch.Tensor, vc: torch.Tensor, pc: torch.Tensor,
                     pos: torch.Tensor, hq: int, hkv: int):
    """Single-token local attention over the rolling window: every lane's
    window rolls left by one and takes the new entry at the end (lanes
    outside the decode batch too); slots are masked by ``pos >= 0``.
    A window held in slot shards is gathered, rolled, and this rank's
    slots of the rolled window returned."""
    b = x.shape[0]
    h = L.apply_norm(cfg.norm, lp["ln"], x[:, None])
    q, k, v = L.qkv_project(lp["attn"], h, hq, hkv, cfg.d_head)
    posb = pos[:, None]
    q = L.apply_rope(q, posb, cfg.rope_theta)
    k = L.apply_rope(k, posb, cfg.rope_theta)
    parts = cfg.window // kc.shape[1]
    if parts > 1:
        mesh = L._require_model_mesh()
        kc, vc, pc = (C.all_gather(t, mesh, "model", 1)
                      for t in (kc, vc, pc))
    kc = torch.cat([kc[:, 1:], k], dim=1)
    vc = torch.cat([vc[:, 1:], v], dim=1)
    pc = torch.cat([pc[:, 1:], posb.to(pc.dtype)], dim=1)
    acc, l, _ = L.decode_attention_core(q[:, 0], kc, vc, pc >= 0)
    out = (acc / torch.clamp(l, min=1e-20)[..., None]).reshape(
        b, hq * cfg.d_head)
    x = x + L.row_parallel(out.to(x.dtype), lp["attn"]["wo"])
    m = L.apply_norm(cfg.norm, lp["ln_mlp"], x)
    return (x + L.apply_ffn(lp["mlp"], m, cfg.act, d_ff=cfg.d_ff),
            *(_own_slots(t, parts) for t in (kc, vc, pc)))


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                state: RGState, tp: int = 1):
    """One decode iteration: tokens (B,) -> logits (B, V); the recurrent
    states and rolling windows are written into ``state`` in place."""
    hq, hkv = cfg.padded_heads(tp)
    groups, _ = _pattern_counts(cfg)
    x = L.embed(params["embed"], tokens, cfg.d_model)     # (B, d)
    pos = state.lengths
    attn = _stack(params, "attn_groups")
    for j, layer in enumerate(_rec_layers(params)):
        x, (hn, cn) = _rec_block_step(cfg, _full(*layer), x,
                                      state.lru_h[j], state.conv[j])
        state.lru_h[j] = hn
        state.conv[j] = cn
        if j < 2 * groups and j % 2:        # a group's attention layer
            g = j // 2
            x, kc, vc, pc = _attn_block_step(
                cfg, _full(attn[g], "attn_groups", g), x, state.k_cache[g],
                state.v_cache[g], state.pos_cache[g], pos, hq, hkv)
            state.k_cache[g] = kc
            state.v_cache[g] = vc
            state.pos_cache[g] = pc
    x = L.apply_norm(cfg.norm, params["ln_f"], x)
    logits = L.unembed(params["embed"], x, cfg.padded_vocab(tp))
    return logits, state._replace(lengths=state.lengths + 1)
