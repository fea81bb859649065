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

Under a bound mesh whose "model" axis has P > 1 ranks, each rank holds
the shards of ``distributed.sharding.param_pspecs`` (the tied table
d-sharded) and of ``cache_pspecs``: the self K/V sharded over its
context S, the cross K/V over its frames F.  Self and cross attention
gather q, k and v (``layers.qkv_project``; the cross K/V's column shards
are gathered before F is cut to this rank's slice for the cache), each
``wo`` and the FFN's down projection are row-parallel.  Decode writes
the new self K/V on the rank whose S slice holds its position, and
attends over each cache shard with ``layers.decode_attention_core``,
the shards' partials combined by log-sum-exp over "model"
(``distributed.seq_attention.combine_partials``).  Under FSDP each
layer of ``enc`` and ``dec`` is gathered where it runs, inside the
recomputed block.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.device import resolve
from repro_torch.distributed import context
from repro_torch.distributed.seq_attention import combine_partials
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import _seq_mesh

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


def layer_stacks(cfg: ArchConfig):
    """The stacked layer subtrees and their leading layer dims (what the
    FSDP gatherer walks)."""
    return {"enc": (cfg.encoder_layers,), "dec": (cfg.num_layers,)}


def _layers(params: Params, stack: str) -> list:
    """This rank's per-layer pieces of the stack (each leaf unbound once,
    or the FSDP gatherer's pieces)."""
    fs = context.fsdp()
    return fs.pieces(params[stack], stack) if fs is not None \
        else L.unstack(params[stack])


def _full(lp: Params, stack: str, li: int) -> Params:
    fs = context.fsdp()
    return lp if fs is None else fs.layer(lp, li, stack)




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

    def block(x, lp, li):
        lp = _promoted(_full(lp, "enc", li), x.dtype)
        h = L.apply_norm("layernorm", lp["ln1"], x)
        q, k, v = L.qkv_project(lp["attn"], h, hq, hkv, cfg.d_head)
        a = L.blocked_attention(q, k, v, causal=False, q_block=min(512, f),
                                kv_block=min(512, f))
        x = x + L.row_parallel(a.reshape(b, f, hq * cfg.d_head),
                               lp["attn"]["wo"])
        h = L.apply_norm("layernorm", lp["ln2"], x)
        return x + L.apply_ffn(lp["ffn"], h, "gelu", d_ff=cfg.d_ff)

    for li, lp in enumerate(_layers(params, "enc")):
        x = L.remat(block, x, lp, li) if remat else block(x, lp, li)
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
    x = L.embed(params["embed"], tokens, cfg.d_model) + \
        params["pos_dec"][None, :s].to(L._dtype(cfg.dtype))

    def block(x, lp, li):
        lp = _full(lp, "dec", li)
        sa, xa = lp["self_attn"], lp["cross_attn"]
        h = L.apply_norm("layernorm", lp["ln1"], x)
        q, k, v = L.qkv_project(sa, h, hq, hkv, dh)
        a = L.blocked_attention(q, k, v, causal=True, q_block=min(512, s),
                                kv_block=min(512, s))
        x = x + L.row_parallel(a.reshape(b, s, hq * dh), sa["wo"])
        h = L.apply_norm("layernorm", lp["ln_x"], x)
        qx = _cross_q(xa, h, hq, dh)
        kx, vx = (L.gather_cols(_mm(L.column_input(enc_out, xa[n],
                                                   hkv * dh), xa[n]),
                                hkv * dh).reshape(b, f, hkv, dh)
                  for n in ("wk", "wv"))
        ax = L.blocked_attention(qx, kx, vx, causal=False,
                                 q_block=min(512, s), kv_block=min(512, f))
        x = x + L.row_parallel(ax.reshape(b, s, hq * dh), xa["wo"])
        h = L.apply_norm("layernorm", lp["ln2"], x)
        return (x + L.apply_ffn(lp["ffn"], h, "gelu", d_ff=cfg.d_ff),
                (k, v, kx, vx))

    caches = []
    for li, lp in enumerate(_layers(params, "dec")):
        x, kv = L.remat(block, x, lp, li) if remat else block(x, lp, li)
        if collect_cache:
            caches.append(kv)
    out = None
    if collect_cache:
        out = tuple(torch.stack(leaf) for leaf in zip(*caches))
    return L.apply_norm("layernorm", params["ln_f"], x), out


def _cross_q(xa: Params, h: torch.Tensor, hq: int, dh: int) -> torch.Tensor:
    """The cross attention's queries (B, S, Hq, D) of full heads."""
    q = L.column_input(h, xa["wq"], hq * dh) @ xa["wq"]
    return L.gather_cols(q, hq * dh).reshape(*h.shape[:2], hq, dh)


def loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
         tp: int = 1) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``frames``,
    ``tokens``, ``labels``, optional ``mask``), the encoder and the
    decoder both recomputed per layer in backward."""
    enc_out = encode(params, cfg, batch["frames"], tp=tp, remat=True)
    h, _ = _decoder_seq(params, cfg, batch["tokens"], enc_out, tp,
                        remat=True)
    return L.lm_loss_chunked(params["embed"], h, batch["labels"],
                             batch.get("mask"), vocab=cfg.padded_vocab(tp))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            frames: torch.Tensor, tp: int = 1,
            max_seq: Optional[int] = None):
    """Encode ``frames``, run the decoder over the prompt; returns
    (last_logits, EncDecCache) with the self K/V padded to ``max_seq``
    and the cross K/V in the encoder's dtype (this rank's S and F slices
    of them where the cache is sharded)."""
    enc_out = encode(params, cfg, frames, tp=tp)
    h, (k, v, kx, vx) = _decoder_seq(params, cfg, tokens, enc_out, tp,
                                     collect_cache=True)
    b, s = tokens.shape
    if max_seq is not None and max_seq > s:
        pad = (0, 0, 0, 0, 0, max_seq - s)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    parts = L.model_parts(cfg.encoder_frames)
    if parts > 1:
        if kx.shape[2] != cfg.encoder_frames:
            raise ValueError(f"a cross cache sharded over its frames takes "
                             f"the config's {cfg.encoder_frames} frames, "
                             f"got {kx.shape[2]}")
        n = kx.shape[2] // parts
        i = L._require_model_mesh().coord("model")
        kx, vx = (t[:, :, i * n:(i + 1) * n].clone() for t in (kx, vx))
    mesh = _seq_mesh()
    if mesh is not None:
        n = k.shape[2] // mesh.shape["model"]
        i = mesh.coord("model")
        k, v = (t[:, :, i * n:(i + 1) * n].clone() for t in (k, v))
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
    the decode batch, can get there; its output is discarded.  On a
    cache held in context shards the rank holding that position writes
    it.
    """
    hq, hkv = cfg.padded_heads(tp)
    dh = cfg.d_head
    dt = L._dtype(cfg.dtype)
    b = tokens.shape[0]
    rows = params["pos_dec"].shape[0]
    idx = cache.lengths.long()
    pe = params["pos_dec"][idx.clamp(0, rows - 1)].to(dt)
    pe = torch.where((idx < rows)[:, None], pe, math.nan)
    x = L.embed(params["embed"], tokens, cfg.d_model) + pe
    f = cache.cross_k.shape[2]
    cross_valid = torch.ones((b, f), dtype=torch.bool, device=x.device)
    cross_mesh = L._model_mesh() \
        if L.model_parts(cfg.encoder_frames) > 1 else None
    s = cache.self_k.shape[2]
    mesh = _seq_mesh()
    start, s_full = 0, s
    if mesh is not None:
        start, s_full = mesh.coord("model") * s, s * mesh.shape["model"]
    widx = idx.clamp(0, s_full - 1) - start
    own = ((widx >= 0) & (widx < s))[:, None, None]
    widx = widx.clamp(0, s - 1)
    valid = (start + torch.arange(s, device=x.device))[None, :] \
        < (cache.lengths + 1).to(x.device)[:, None]
    lanes = torch.arange(b, device=x.device)
    for li, lp in enumerate(_layers(params, "dec")):
        lp = _full(lp, "dec", li)
        sa, xa = lp["self_attn"], lp["cross_attn"]
        kc, vc = cache.self_k[li], cache.self_v[li]
        h = L.apply_norm("layernorm", lp["ln1"], x[:, None])
        q, k, v = L.qkv_project(sa, h, hq, hkv, dh)
        k, v = k[:, 0], v[:, 0]
        if mesh is not None:
            k = torch.where(own, k, kc[lanes, widx])
            v = torch.where(own, v, vc[lanes, widx])
        kc[lanes, widx] = k
        vc[lanes, widx] = v
        a = _attend(q[:, 0], kc, vc, valid, mesh)
        x = x + L.row_parallel(a.reshape(b, hq * dh).to(x.dtype), sa["wo"])
        h = L.apply_norm("layernorm", lp["ln_x"], x[:, None])
        qx = _cross_q(xa, h, hq, dh)
        ax = _attend(qx[:, 0], cache.cross_k[li], cache.cross_v[li],
                     cross_valid, cross_mesh)
        x = x + L.row_parallel(ax.reshape(b, hq * dh).to(x.dtype),
                               xa["wo"])
        h = L.apply_norm("layernorm", lp["ln2"], x)
        x = x + L.apply_ffn(lp["ffn"], h, "gelu", d_ff=cfg.d_ff)
    x = L.apply_norm("layernorm", params["ln_f"], x)
    logits = L.unembed(params["embed"], x)
    return logits, cache._replace(lengths=cache.lengths + 1)


def _attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
            valid: torch.Tensor, mesh) -> torch.Tensor:
    """Decode attention (B, Hq, D) float32 of q over a cache (B, S, H, D)
    whose positions ``valid`` marks; on a cache held in shards over
    "model" (``mesh``) the shards' partials are combined."""
    acc, l, m = L.decode_attention_core(q, kc, vc, valid)
    if mesh is not None:
        acc, l = combine_partials(acc, l, m, mesh, "model")
    b, hkv, g, d = acc.shape
    return (acc / torch.clamp(l, min=1e-20)[..., None]).reshape(
        b, hkv * g, d)
