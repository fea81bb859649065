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
``wkv_fn`` over T (``kernels.ref.wkv6_ref`` by default; the engine passes
the WKV6 kernel).  Decode is the same with T = 1.  The new state is
written into the ``RWKVState`` tensors that were passed in, in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
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
    def zeros(cfg: ArchConfig, batch: int, device="cuda") -> "RWKVState":
        heads = cfg.d_model // cfg.rwkv_head_size
        hs = cfg.rwkv_head_size
        dt = L._dtype(cfg.dtype)
        dev = resolve(device)
        x_shape = (cfg.num_layers, batch, cfg.d_model)
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


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
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
              prev: torch.Tensor, wkv: torch.Tensor, wkv_fn):
    """The time-mix block over a whole sequence.  h, prev: (B, T, d);
    the layer's recurrence state ``wkv`` is advanced in place."""
    b, t, d = h.shape
    hs = cfg.rwkv_head_size
    heads = d // hs
    mu = lp["mix"]["mu"]                                  # (5, d)
    xr, xk, xv, xg, xw = prev + (h - prev) * mu[:, None, None, :]
    r, k, v = ((x @ lp[name]).reshape(b, t, heads, hs).float()
               for x, name in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(xg @ lp["wg"])
    wd = lp["w_decay"]
    w = wd["w0"] + (torch.tanh(xw @ wd["a"]) @ wd["b"]).float()
    w = torch.exp(-torch.exp(w)).reshape(b, t, heads, hs)  # decay in (0,1)
    y, _ = wkv_fn(r, k, v, w, lp["u_bonus"], wkv, wkv)
    y = _group_norm(lp["gn"], y.reshape(b * t, d), heads).reshape(b, t, d)
    return (y.to(g.dtype) * g) @ lp["wo"]


def _channel_mix(lp: Params, h: torch.Tensor,
                 prev: torch.Tensor) -> torch.Tensor:
    mu = lp["mu"]
    xk = prev + (h - prev) * mu[0]
    xr = prev + (h - prev) * mu[1]
    k = torch.square(torch.relu(xk @ lp["wk"])) @ lp["wv"]
    return torch.sigmoid(xr @ lp["wr"]) * k


def _layers(params: Params, cfg: ArchConfig, x: torch.Tensor,
            state: RWKVState, wkv_fn) -> torch.Tensor:
    """Every layer over x (B, T, d), updating ``state`` in place; returns
    the final-normed hidden states."""
    wkv_fn = wkv_fn or ref.wkv6_ref
    for li in range(cfg.num_layers):
        lp = layer_params(params, li)
        h = L.apply_norm("layernorm", lp["ln1"], x)
        x1 = x + _time_mix(cfg, lp, h, _shifted(state.tm_x[li], h),
                           state.wkv[li], wkv_fn)
        h2 = L.apply_norm("layernorm", lp["cm"]["ln"], x1)
        x = x1 + _channel_mix(lp["cm"], h2, _shifted(state.cm_x[li], h2))
        state.tm_x[li] = h[:, -1]
        state.cm_x[li] = h2[:, -1]
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
    x = L.embed(params["embed"], tokens)
    if state is None:
        state = RWKVState.zeros(cfg, x.shape[0], device=x.device)
    h = _layers(params, cfg, x, state, wkv_fn)
    return h, state._replace(lengths=state.lengths + tokens.shape[1])


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            tp: int = 1, max_seq: Optional[int] = None, wkv_fn=None):
    """Process the prompt from a zero state; returns (last_logits,
    RWKVState).  ``max_seq`` is accepted for the engine's protocol: the
    state does not grow with the context."""
    h, state = forward_seq(params, cfg, tokens, tp=tp, wkv_fn=wkv_fn)
    return L.unembed(params["embed"], h[:, -1]), state


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                state: RWKVState, tp: int = 1, wkv_fn=None):
    """One decode iteration: tokens (B,) -> logits (B, V), state advanced
    by one token (in place)."""
    x = L.embed(params["embed"], tokens)[:, None]           # (B, 1, d)
    h = _layers(params, cfg, x, state, wkv_fn)
    logits = L.unembed(params["embed"], h[:, 0])
    return logits, state._replace(lengths=state.lengths + 1)
