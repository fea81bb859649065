"""RWKV6 "Finch" — attention-free SSM with data-dependent decay (port of
``repro.models.rwkv6``).

Per layer: time-mix (token-shift ddlerp -> r/k/v/g/w projections -> WKV6
linear-attention recurrence with per-channel data-dependent decay + bonus)
and channel-mix (token-shift gated FFN).  Decode state is O(d_model) per
layer plus one (hs x hs) float32 matrix per head.

Recurrence (head size hs, per head):
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Where the reference scans every layer token by token, these functions
run each layer over the whole sequence at once: the norms, token shift
and projections are (B*T, d) products, and the recurrence is one call of
``wkv_fn`` over T (``kernels.ref.wkv6_ref`` by default; the engine and
the prefill and serve steps pass the WKV6 kernel).  Decode is the same
with T = 1.  The new state is written into the ``RWKVState`` tensors
that were passed in, in place; ``loss`` runs the same layers from a zero
state and writes nothing.

Under a bound mesh whose "model" axis has P > 1 ranks (the heads
dividing by P), each rank holds the shards of
``distributed.sharding.param_pspecs`` and runs H/P heads: r, k, v and g
are column-parallel, the recurrence runs on this rank's heads (the WKV6
kernel at H/P heads on the card) from its head shard of the ``wkv``
state, the per-channel leaves the heads consume (the decay's ``w0`` and
the columns of its LoRA ``b``, the group norm) are cut to this rank's
d/P columns by ``collectives.split`` (whose backward gathers, so every
rank keeps a replicated leaf's whole gradient), and ``wo`` is
row-parallel.  The channel mix follows the reference's rule order, which
makes ``cm/wv`` column-parallel over its output: relu(xk @ cm/wk)^2
(d_ff/P columns) is gathered to d_ff, and its product with this rank's
d/P columns of ``cm/wv`` is gathered to d.  The token-shift states are
held d-sharded: each layer gathers the previous token and keeps this
rank's slice of the last.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.distributed import collectives as C
from repro_torch.distributed import context
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import layer_params

Params = Dict[str, Any]


class RWKVState(NamedTuple):
    tm_x: torch.Tensor     # (L, B, d)   last token for time-mix shift
    cm_x: torch.Tensor     # (L, B, d)   last token for channel-mix shift
    wkv: torch.Tensor      # (L, B, H, hs, hs) recurrence state (float32)
    lengths: torch.Tensor  # (B,) int32

    @staticmethod
    def zeros(cfg: ArchConfig, batch: int, device="cuda",
              parts: int = 1) -> "RWKVState":
        """Zeros of the whole state, or of one model rank's shard of it
        when its widths and heads are cut ``parts`` ways."""
        heads = cfg.d_model // cfg.rwkv_head_size // parts
        hs = cfg.rwkv_head_size
        dt = L._dtype(cfg.dtype)
        dev = resolve(device)
        x_shape = (cfg.num_layers, batch, cfg.d_model // parts)
        return RWKVState(
            torch.zeros(x_shape, dtype=dt, device=dev),
            torch.zeros(x_shape, dtype=dt, device=dev),
            torch.zeros((cfg.num_layers, batch, heads, hs, hs),
                        dtype=torch.float32, device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _uniform_mix(gen, shape, dtype, device) -> torch.Tensor:
    """U[0.25, 0.75) mixing coefficients, drawn in float32 (as the
    reference) and cast to ``dtype``."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    if x.device.type != "meta":
        x.uniform_(0.0, 1.0, generator=gen)
    return (x * 0.5 + 0.25).to(dtype)


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
    d, nl, hs = cfg.d_model, cfg.num_layers, cfg.rwkv_head_size
    lead = (nl,)
    lora = max(32, d // 64)
    scale_o = 0.02 / math.sqrt(2 * nl)
    u = torch.empty((nl, d // hs, hs), dtype=torch.float32, device=dev)
    if dev.type != "meta":
        u.normal_(0.0, 0.1, generator=gen)

    def dense(d_in, d_out, scale=0.02):
        return L.dense_init(gen, (*lead, d_in, d_out), dtype, scale=scale,
                            device=dev)

    def norm():
        return L.init_norm("layernorm", d, device=dev, lead=lead)

    blocks = {
        "ln1": norm(),
        "ln2": norm(),
        "mix": {"mu": _uniform_mix(gen, (*lead, 5, d), dtype, dev)},
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
        "wg": dense(d, d), "wo": dense(d, d, scale_o),
        "w_decay": {
            "w0": torch.full((*lead, d), -6.0, dtype=torch.float32,
                             device=dev),
            "a": dense(d, lora),
            "b": dense(lora, d),
        },
        "u_bonus": u,
        "gn": {"scale": torch.ones((*lead, d), device=dev),
               "bias": torch.zeros((*lead, d), device=dev)},
        "cm": {
            "ln": norm(),
            "mu": _uniform_mix(gen, (*lead, 2, d), dtype, dev),
            "wk": dense(d, cfg.d_ff),
            "wv": dense(cfg.d_ff, d, scale_o),
            "wr": dense(d, d),
        },
    }
    return {"embed": L.init_embed(gen, cfg.padded_vocab(tp), d, dtype,
                                  cfg.tie_embeddings, device=dev),
            "blocks": blocks,
            "ln_f": L.init_norm("layernorm", d, device=dev)}


def layer_stacks(cfg: ArchConfig):
    """The stacked layer subtree and its leading layer dim (what the FSDP
    gatherer walks)."""
    return {"blocks": (cfg.num_layers,)}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def model_parts(cfg: ArchConfig) -> int:
    """The model ranks this rank's heads and state are a 1/P shard of:
    P under a bound mesh whose "model" axis of P > 1 ranks divides the
    heads (the sharding rules then cut the projections' columns, the
    bonus and the state), else 1."""
    heads = cfg.d_model // cfg.rwkv_head_size
    parts = L.model_parts(heads)
    if parts == 1 and L.model_parts(cfg.d_model) > 1:
        raise ValueError(f"{cfg.name}: a model axis of "
                         f"{L.model_parts(cfg.d_model)} ranks splits its "
                         f"{heads} heads of size {cfg.rwkv_head_size}")
    return parts


def _cols(t: torch.Tensor, parts: int) -> torch.Tensor:
    """This rank's slice of the last dim of ``t`` (replicated over
    "model") when the heads are cut ``parts`` ways; its backward gathers
    the slices' gradients."""
    if parts == 1:
        return t
    return C.split(t, L._require_model_mesh(), "model", t.ndim - 1)


def _group_norm(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    n, d = x.shape
    xg = x.reshape(n, heads, d // heads).float()
    mu = xg.mean(-1, keepdim=True)
    var = xg.var(-1, keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + 1e-5)
    return xg.reshape(n, d) * p["scale"] + p["bias"]


def _shifted(prev: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Token shift: each position's previous token, ``prev`` (B, d) at
    position 0.  h: (B, T, d)."""
    return torch.cat([prev[:, None], h[:, :-1]], dim=1)


def _time_mix(cfg: ArchConfig, lp: Params, h: torch.Tensor,
              prev: torch.Tensor, wkv0: torch.Tensor, wkv_fn,
              state_out: Optional[torch.Tensor]):
    """The time-mix block over a whole sequence.  h, prev: (B, T, d);
    the recurrence starts from ``wkv0`` and its final state is written
    into ``state_out`` when one is given (serving passes the layer's own
    state, advancing it in place).  Under a model axis cutting the heads
    P ways, this rank's H/P heads run and ``wo``'s partials are summed."""
    b, t, d = h.shape
    hs = cfg.rwkv_head_size
    parts = model_parts(cfg)
    dl = d // parts
    heads = dl // hs
    mu = lp["mix"]["mu"]                                  # (5, d)
    xr, xk, xv, xg, xw = prev + (h - prev) * mu[:, None, None, :]
    r, k, v = ((L.column_input(x, lp[name], d) @ lp[name]).reshape(
        b, t, heads, hs).float().contiguous()
        for x, name in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(L.column_input(xg, lp["wg"], d) @ lp["wg"])
    wd = lp["w_decay"]
    wb = _cols(wd["b"], parts)
    lora = torch.tanh(xw @ wd["a"])
    w = _cols(wd["w0"], parts) + (L.column_input(lora, wb, d) @ wb).float()
    w = torch.exp(-torch.exp(w)).reshape(b, t, heads, hs)  # decay in (0,1)
    y, _ = wkv_fn(r, k, v, w.contiguous(), lp["u_bonus"], wkv0, state_out)
    gn = {n: _cols(x, parts) for n, x in lp["gn"].items()}
    y = _group_norm(gn, y.reshape(b * t, dl), heads).reshape(b, t, dl)
    y = y.to(g.dtype) * g
    return L.row_reduce(y, lp["wo"]) if parts > 1 else y @ lp["wo"]


def _channel_mix(cfg: ArchConfig, lp: Params, h: torch.Tensor,
                 prev: torch.Tensor) -> torch.Tensor:
    d = cfg.d_model
    mu = lp["mu"]
    xk = prev + (h - prev) * mu[0]
    xr = prev + (h - prev) * mu[1]
    k = torch.square(torch.relu(L.column_input(xk, lp["wk"], cfg.d_ff)
                                @ lp["wk"]))
    k = L.column_input(L.gather_cols(k, cfg.d_ff), lp["wv"], d)
    k = L.gather_cols(k @ lp["wv"], d)
    return torch.sigmoid(xr @ lp["wr"]) * k


def _block(cfg: ArchConfig, lp: Params, x: torch.Tensor, tm0: torch.Tensor,
           cm0: torch.Tensor, wkv0: torch.Tensor, wkv_fn,
           state_out: Optional[torch.Tensor] = None):
    """One layer over x (B, T, d) from the shift inputs ``tm0`` / ``cm0``
    (B, d) and recurrence state ``wkv0``; returns (x, the time-mix and
    channel-mix inputs of the last token)."""
    h = L.apply_norm("layernorm", lp["ln1"], x)
    x1 = x + _time_mix(cfg, lp, h, _shifted(tm0, h), wkv0, wkv_fn,
                       state_out)
    h2 = L.apply_norm("layernorm", lp["cm"]["ln"], x1)
    x = x1 + _channel_mix(cfg, lp["cm"], h2, _shifted(cm0, h2))
    return x, h[:, -1], h2[:, -1]


def _layers(params: Params, cfg: ArchConfig, x: torch.Tensor,
            state: RWKVState, wkv_fn) -> torch.Tensor:
    """Every layer over x (B, T, d), updating ``state`` in place; returns
    the final-normed hidden states.  A d-sharded shift state is gathered
    for the layer and keeps this rank's slice of the last token."""
    wkv_fn = wkv_fn or ref.wkv6_ref
    d, parts = cfg.d_model, model_parts(cfg)
    for li in range(cfg.num_layers):
        wkv = state.wkv[li]             # advanced in place by wkv_fn
        x, tm, cm = _block(
            cfg, layer_params(params, li), x,
            L.gather_cols(state.tm_x[li], d),
            L.gather_cols(state.cm_x[li], d), wkv, wkv_fn, wkv)
        state.tm_x[li] = _cols(tm, parts)
        state.cm_x[li] = _cols(cm, parts)
    return L.apply_norm("layernorm", params["ln_f"], x)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def forward_seq(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                state: Optional[RWKVState] = None, tp: int = 1,
                wkv_fn=None):
    """tokens (B, S) -> (hidden (B, S, d), state advanced by S).

    ``wkv_fn(r, k, v, w, u, state0, state_out) -> (y, state_T)`` runs
    the recurrence and writes ``state_T`` into ``state_out`` (here the
    layer's own state, ``state0``); the default is the plain
    ``kernels.ref.wkv6_ref``."""
    x = L.embed(params["embed"], tokens, cfg.d_model)
    if state is None:
        state = RWKVState.zeros(cfg, x.shape[0], device=x.device,
                                parts=model_parts(cfg))
    h = _layers(params, cfg, x, state, wkv_fn)
    return h, state._replace(lengths=state.lengths + tokens.shape[1])


def loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
         tp: int = 1) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels``, optional ``mask``).

    The layers run from a zero state and write nothing: each layer's
    activations are recomputed in backward (the reference's per-layer
    ``jax.checkpoint``), and a recomputed layer must see the state it
    saw the first time.  The recurrence is the plain ``wkv6_ref``, as
    the reference trains through its ``lax.scan`` (the kernel has no
    backward).  Under FSDP each layer is gathered inside the recomputed
    block."""
    x = L.embed(params["embed"], batch["tokens"], cfg.d_model)
    b, _, d = x.shape
    hs = cfg.rwkv_head_size
    shift0 = x.new_zeros((b, d))
    wkv0 = torch.zeros((b, d // hs // model_parts(cfg), hs, hs),
                       dtype=torch.float32, device=x.device)
    fs = context.fsdp()

    def layer(x, lp, li):
        if fs is not None:          # FSDP: gathered here, so recomputed
            lp = fs.layer(lp, li)
        return _block(cfg, lp, x, shift0, shift0, wkv0, ref.wkv6_ref)[0]

    layers = fs.pieces(params["blocks"]) if fs is not None \
        else L.unstack(params["blocks"])
    for li, lp in enumerate(layers):
        x = L.remat(layer, x, lp, li)
    h = L.apply_norm("layernorm", params["ln_f"], x)
    return L.lm_loss_chunked(params["embed"], h, batch["labels"],
                             batch.get("mask"), vocab=cfg.padded_vocab(tp))


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            tp: int = 1, max_seq: Optional[int] = None, wkv_fn=None):
    """Process the prompt from a zero state; returns (last_logits,
    RWKVState).  ``max_seq`` is accepted for the engine's protocol: the
    state does not grow with the context."""
    h, state = forward_seq(params, cfg, tokens, tp=tp, wkv_fn=wkv_fn)
    return L.unembed(params["embed"], h[:, -1], cfg.padded_vocab(tp)), state


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                state: RWKVState, tp: int = 1, wkv_fn=None):
    """One decode iteration: tokens (B,) -> logits (B, V), state advanced
    by one token (in place)."""
    x = L.embed(params["embed"], tokens, cfg.d_model)[:, None]  # (B, 1, d)
    h = _layers(params, cfg, x, state, wkv_fn)
    logits = L.unembed(params["embed"], h[:, 0], cfg.padded_vocab(tp))
    return logits, state._replace(lengths=state.lengths + 1)
