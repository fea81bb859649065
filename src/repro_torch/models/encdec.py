"""Whisper-style encoder-decoder backbone, the audio family (port of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: ``frames`` are
precomputed frame embeddings (B, frames, d_model) fed straight into the
encoder.  Decoder: causal self-attention (cached) + cross-attention to
the encoder output (K/V computed once at prefill) + GELU FFN, pre-
LayerNorm throughout.

Types follow JAX's promotion, which ``torch.matmul`` does not do: a
float32 operand and bf16 weights multiply in float32 (:func:`_mm`).  So
with float32 frames, as the engine passes them, the whole encoder and
the cross K/V run in float32 whatever the weights' dtype; the prefill's
``cross_k`` / ``cross_v`` come back in float32 and take the cache's
dtype when the engine inserts them.  ``decode_step`` writes the new
self-attention K/V into the cache tensors it was given, in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import layer_params

Params = Dict[str, Any]


class EncDecCache(NamedTuple):
    self_k: torch.Tensor     # (Ld, B, S, H, D)
    self_v: torch.Tensor
    cross_k: torch.Tensor    # (Ld, B, F, H, D)
    cross_v: torch.Tensor
    lengths: torch.Tensor    # (B,) int32

    @staticmethod
    def zeros(cfg: ArchConfig, batch: int, max_seq: int, tp: int = 1,
              device="cuda") -> "EncDecCache":
        _, hkv = cfg.padded_heads(tp)
        dt = L._dtype(cfg.dtype)
        dev = resolve(device)
        seq = (cfg.num_layers, batch, max_seq, hkv, cfg.d_head)
        cross = (cfg.num_layers, batch, cfg.encoder_frames, hkv, cfg.d_head)
        return EncDecCache(
            torch.zeros(seq, dtype=dt, device=dev),
            torch.zeros(seq, dtype=dt, device=dev),
            torch.zeros(cross, dtype=dt, device=dev),
            torch.zeros(cross, dtype=dt, device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev))


def _sinusoid(length: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype (JAX's rule: f32 @ bf16 is f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _promoted(tree: Params, dtype: torch.dtype) -> Params:
    """A layer's weights in the dtype they promote to against an
    activation of ``dtype`` (no copy where nothing changes)."""
    return {k: _promoted(v, dtype) if isinstance(v, dict)
            else v.to(torch.promote_types(v.dtype, dtype))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_stack(gen, cfg: ArchConfig, dtype, dev, n: int, hq: int, hkv: int,
                cross: bool) -> Params:
    lead = (n,)

    def norm():
        return L.init_norm("layernorm", cfg.d_model, device=dev, lead=lead)

    def attn():
        return L.init_attention(gen, cfg, dtype, hq, hkv, device=dev,
                                lead=lead)

    p = {"ln1": norm(), ("self_attn" if cross else "attn"): attn()}
    if cross:
        p["ln_x"] = norm()
        p["cross_attn"] = attn()
    p["ln2"] = norm()
    p["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, False, dtype,
                          cfg.num_layers, device=dev, lead=lead)
    return p


def init(cfg: ArchConfig, tp: int = 1, *, device="cuda",
         seed: int = 0) -> Params:
    """Random parameters with the reference's tree, shapes, dtypes and
    distributions (tied embeddings, a learned decoder position table),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (``"meta"`` gives an undrawn shape template)."""
    dev = resolve(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    dtype = L._dtype(cfg.dtype)
    hq, hkv = cfg.padded_heads(tp)
    return {"embed": L.init_embed(gen, cfg.padded_vocab(tp), cfg.d_model,
                                  dtype, tie=True, device=dev),
            "pos_dec": L.dense_init(gen, (cfg.max_seq, cfg.d_model), dtype,
                                    scale=0.01, device=dev),
            "enc": _init_stack(gen, cfg, dtype, dev, cfg.encoder_layers, hq,
                               hkv, cross=False),
            "dec": _init_stack(gen, cfg, dtype, dev, cfg.num_layers, hq,
                               hkv, cross=True),
            "ln_enc": L.init_norm("layernorm", cfg.d_model, device=dev),
            "ln_f": L.init_norm("layernorm", cfg.d_model, device=dev)}


def _layer(params: Params, stack: str, li: int) -> Params:
    return layer_params({"blocks": params[stack]}, li)


# ---------------------------------------------------------------------------
# Encoder / decoder
# ---------------------------------------------------------------------------
def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor,
           tp: int = 1, remat: bool = False) -> torch.Tensor:
    """frames: (B, F, d_model) precomputed embeddings (frontend stub) ->
    (B, F, d_model) in the dtype the frames promote to with the
    weights.  ``remat`` recomputes each layer in backward (the
    reference's per-layer ``jax.checkpoint``)."""
    hq, hkv = cfg.padded_heads(tp)
    b, f, d = frames.shape
    x = frames + _sinusoid(f, d, frames.device)[None].to(frames.dtype)
    x = x.to(torch.promote_types(x.dtype, L._dtype(cfg.dtype)))

    def block(x, lp):
        lp = _promoted(lp, x.dtype)
        h = L.apply_norm("layernorm", lp["ln1"], x)
        q, k, v = L.qkv_project(lp["attn"], h, hq, hkv, cfg.d_head)
        a = L.blocked_attention(q, k, v, causal=False, q_block=min(512, f),
                                kv_block=min(512, f))
        x = x + a.reshape(b, f, hq * cfg.d_head) @ lp["attn"]["wo"]
        h = L.apply_norm("layernorm", lp["ln2"], x)
        return x + L.apply_ffn(lp["ffn"], h, "gelu")

    for lp in L.unstack(params["enc"]):
        x = L.remat(block, x, lp) if remat else block(x, lp)
    return L.apply_norm("layernorm", params["ln_enc"], x)


def _decoder_seq(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor, tp: int, collect_cache: bool = False,
                 remat: bool = False):
    """The decoder over the whole sequence; returns (final-normed hidden,
    (self_k, self_v, cross_k, cross_v) stacked over layers | None).
    ``remat`` recomputes each layer in backward."""
    hq, hkv = cfg.padded_heads(tp)
    dh = cfg.d_head
    b, s = tokens.shape
    f = enc_out.shape[1]
    x = L.embed(params["embed"], tokens) + \
        params["pos_dec"][None, :s].to(L._dtype(cfg.dtype))

    def block(x, lp):
        sa, xa = lp["self_attn"], lp["cross_attn"]
        h = L.apply_norm("layernorm", lp["ln1"], x)
        q, k, v = L.qkv_project(sa, h, hq, hkv, dh)
        a = L.blocked_attention(q, k, v, causal=True, q_block=min(512, s),
                                kv_block=min(512, s))
        x = x + a.reshape(b, s, hq * dh) @ sa["wo"]
        h = L.apply_norm("layernorm", lp["ln_x"], x)
        qx = (h @ xa["wq"]).reshape(b, s, hq, dh)
        kx = _mm(enc_out, xa["wk"]).reshape(b, f, hkv, dh)
        vx = _mm(enc_out, xa["wv"]).reshape(b, f, hkv, dh)
        ax = L.blocked_attention(qx, kx, vx, causal=False,
                                 q_block=min(512, s), kv_block=min(512, f))
        x = x + ax.reshape(b, s, hq * dh) @ xa["wo"]
        h = L.apply_norm("layernorm", lp["ln2"], x)
        return x + L.apply_ffn(lp["ffn"], h, "gelu"), (k, v, kx, vx)

    caches = []
    for lp in L.unstack(params["dec"]):
        x, kv = L.remat(block, x, lp) if remat else block(x, lp)
        if collect_cache:
            caches.append(kv)
    out = None
    if collect_cache:
        out = tuple(torch.stack(leaf) for leaf in zip(*caches))
    return L.apply_norm("layernorm", params["ln_f"], x), out


def loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
         tp: int = 1) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``frames``,
    ``tokens``, ``labels``, optional ``mask``), the encoder and the
    decoder both recomputed per layer in backward."""
    enc_out = encode(params, cfg, batch["frames"], tp=tp, remat=True)
    h, _ = _decoder_seq(params, cfg, batch["tokens"], enc_out, tp,
                        remat=True)
    return L.lm_loss_chunked(params["embed"], h, batch["labels"],
                             batch.get("mask"))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            frames: torch.Tensor, tp: int = 1,
            max_seq: Optional[int] = None):
    """Encode ``frames``, run the decoder over the prompt; returns
    (last_logits, EncDecCache) with the self K/V padded to ``max_seq``
    and the cross K/V in the encoder's dtype."""
    enc_out = encode(params, cfg, frames, tp=tp)
    h, (k, v, kx, vx) = _decoder_seq(params, cfg, tokens, enc_out, tp,
                                     collect_cache=True)
    b, s = tokens.shape
    if max_seq is not None and max_seq > s:
        pad = (0, 0, 0, 0, 0, max_seq - s)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return (L.unembed(params["embed"], h[:, -1]),
            EncDecCache(k, v, kx, vx, lengths))


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: EncDecCache, tp: int = 1):
    """One decode iteration: tokens (B,) -> logits (B, V), the new self
    K/V written into ``cache`` in place.

    Out-of-range indices behave as in the reference, without an index
    past a tensor's end (which a CUDA kernel would assert on): a lane
    whose length is past the position table reads NaN for its position
    embedding (``jnp.take``'s fill), and its K/V write lands at position
    S-1 (``dynamic_update_slice`` clamps).  Only a stale lane, one not in
    the decode batch, can get there; its output is discarded.
    """
    hq, hkv = cfg.padded_heads(tp)
    dh = cfg.d_head
    dt = L._dtype(cfg.dtype)
    b = tokens.shape[0]
    rows = params["pos_dec"].shape[0]
    idx = cache.lengths.long()
    pe = params["pos_dec"][idx.clamp(0, rows - 1)].to(dt)
    pe = torch.where((idx < rows)[:, None], pe, math.nan)
    x = L.embed(params["embed"], tokens) + pe
    f = cache.cross_k.shape[2]
    cross_valid = torch.ones((b, f), dtype=torch.bool, device=x.device)
    widx = idx.clamp(0, cache.self_k.shape[2] - 1)
    lanes = torch.arange(b, device=x.device)
    for li in range(cfg.num_layers):
        lp = _layer(params, "dec", li)
        sa, xa = lp["self_attn"], lp["cross_attn"]
        kc, vc = cache.self_k[li], cache.self_v[li]
        h = L.apply_norm("layernorm", lp["ln1"], x[:, None])
        q, k, v = L.qkv_project(sa, h, hq, hkv, dh)
        kc[lanes, widx] = k[:, 0]
        vc[lanes, widx] = v[:, 0]
        a = L.decode_attention(q[:, 0], kc, vc, cache.lengths + 1)
        x = x + a.reshape(b, hq * dh) @ sa["wo"]
        h = L.apply_norm("layernorm", lp["ln_x"], x[:, None])
        qx = (h @ xa["wq"]).reshape(b, 1, hq, dh)
        acc, l, _ = L.decode_attention_core(qx[:, 0], cache.cross_k[li],
                                            cache.cross_v[li], cross_valid)
        ax = (acc / torch.clamp(l, min=1e-20)[..., None]).reshape(
            b, hq * dh)
        x = x + ax.to(x.dtype) @ xa["wo"]
        h = L.apply_norm("layernorm", lp["ln2"], x)
        x = x + L.apply_ffn(lp["ffn"], h, "gelu")
    x = L.apply_norm("layernorm", params["ln_f"], x)
    logits = L.unembed(params["embed"], x)
    return logits, cache._replace(lengths=cache.lengths + 1)
