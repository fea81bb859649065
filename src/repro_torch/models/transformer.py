"""Decoder-only transformer LM: the dense, MoE and VLM-text families
(port of ``repro.models.transformer``).

``init`` builds the reference's stacked-parameter tree (layer dim
leading; ``moe`` in place of ``ffn`` when the config has experts) as
torch tensors; ``loss`` is the training objective (autograd through
``forward_seq`` with per-block recomputation); ``prefill`` / ``extend_step`` /
``decode_step`` / ``decode_step_paged`` walk the layers in a Python loop,
and ``decode_fused_paged`` loops ``decode_step_paged`` over a horizon.
Where the reference threads caches and pools through ``lax`` loops and
returns fresh arrays, these functions write the new K/V into the tensors
they were given, in place, and return them.  The VLM family takes
precomputed patch embeddings (``embeds``, the frontend stub) and
(B, S, 3) M-RoPE positions; text positions are the one stream repeated.

Under a bound mesh (``distributed.context.use_mesh``, set by the steps
of ``launch.steps``) ``loss``, ``prefill`` and ``decode_step`` run this
rank's part of the reference's sharded program (``loss`` under
autograd, its collectives differentiable; under FSDP each layer's data
shards are gathered where the layer runs, inside the recomputed block):
the parameters are the shards of ``distributed.sharding.param_pspecs``
(heads and vocab padded for the model size ``tp``), the batch is this
rank's data shard, and with
``seq_sharded`` each rank holds its context shard of the KV cache: the
new K/V position is written by the rank whose shard holds it, and the
attention either combines the shards' partials (the sequence-sharded
``attn_fn``) or gathers the shards first, as GSPMD would.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import resolve
from repro_torch.distributed import collectives as C
from repro_torch.distributed import context
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]


class KVCache(NamedTuple):
    k: torch.Tensor          # (L, B, S, Hkv, D)
    v: torch.Tensor
    lengths: torch.Tensor    # (B,) int32 valid prefix per request

    @staticmethod
    def zeros(cfg: ArchConfig, batch: int, max_seq: int, tp: int = 1,
              dtype=None, device="cuda") -> "KVCache":
        _, hkv = cfg.padded_heads(tp)
        dt = dtype or L._dtype(cfg.dtype)
        dev = resolve(device)
        shape = (cfg.num_layers, batch, max_seq, hkv, cfg.d_head)
        return KVCache(torch.zeros(shape, dtype=dt, device=dev),
                       torch.zeros(shape, dtype=dt, device=dev),
                       torch.zeros((batch,), dtype=torch.int32,
                                   device=dev))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init(cfg: ArchConfig, tp: int = 1, *, device="cuda",
         seed: int = 0) -> Params:
    """Random parameters with the reference's shapes, dtypes and
    distributions, drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (``"meta"`` gives an undrawn shape template)."""
    dev = resolve(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    dtype = L._dtype(cfg.dtype)
    hq, hkv = cfg.padded_heads(tp)
    lead = (cfg.num_layers,)
    blocks = {
        "ln1": L.init_norm(cfg.norm, cfg.d_model, device=dev, lead=lead),
        "attn": L.init_attention(gen, cfg, dtype, hq, hkv, device=dev,
                                 lead=lead),
        "ln2": L.init_norm(cfg.norm, cfg.d_model, device=dev, lead=lead),
    }
    if cfg.num_experts:
        blocks["moe"] = L.init_moe(gen, cfg, dtype, device=dev, lead=lead)
    else:
        blocks["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.gated_ffn,
                                   dtype, cfg.num_layers, device=dev,
                                   lead=lead)
    return {
        "embed": L.init_embed(gen, cfg.padded_vocab(tp), cfg.d_model, dtype,
                              cfg.tie_embeddings, device=dev),
        "blocks": blocks,
        "ln_f": L.init_norm(cfg.norm, cfg.d_model, device=dev),
    }


def layer_stacks(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """The stacked layer subtrees and their leading layer dims (what the
    FSDP gatherer walks)."""
    return {"blocks": (cfg.num_layers,)}


def layer_params(params: Params, li: int) -> Params:
    """Layer ``li``'s slice of the stacked block tree (views, no copy);
    under FSDP (``context.fsdp``) gathered over the data axes."""
    fs = context.fsdp()
    if fs is not None:
        return fs.layer(fs.local(params["blocks"], li), li)

    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[li]
                for k, v in tree.items()}
    return take(params["blocks"])


def _mrope(cfg: ArchConfig, positions: torch.Tensor) -> torch.Tensor:
    """(B, S) positions as the (B, S, 3) streams of M-RoPE (all three
    the same) when the config uses it; unchanged otherwise."""
    if cfg.mrope:
        return positions[..., None].expand(*positions.shape, 3)
    return positions


def _positions(cfg: ArchConfig, start, n: int, batch: int,
               device) -> torch.Tensor:
    pos = start + torch.arange(n, device=device)
    return _mrope(cfg, pos[None, :].expand(batch, n))


def _attn_ffn_tail(cfg: ArchConfig, lp: Params, x: torch.Tensor,
                   attn: torch.Tensor) -> torch.Tensor:
    """Residual + output projection, then the FFN (or MoE) sub-block."""
    x = x + L.row_parallel(attn.reshape(*attn.shape[:-2], -1),
                           lp["attn"]["wo"])
    h = L.apply_norm(cfg.norm, lp["ln2"], x)
    if cfg.num_experts:
        y = L.apply_moe(lp["moe"], h.reshape(-1, cfg.d_model), cfg)
        return x + y.reshape(h.shape)
    return x + L.apply_ffn(lp["ffn"], h, cfg.act, d_ff=cfg.d_ff)


def _qkv_rope(cfg: ArchConfig, lp: Params, x: torch.Tensor,
              positions: torch.Tensor, hq: int, hkv: int):
    h = L.apply_norm(cfg.norm, lp["ln1"], x)
    q, k, v = L.qkv_project(lp["attn"], h, hq, hkv, cfg.d_head)
    sections = cfg.mrope_sections if cfg.mrope else None
    return (L.apply_rope(q, positions, cfg.rope_theta, sections),
            L.apply_rope(k, positions, cfg.rope_theta, sections), v)


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------
def forward_seq(params: Params, cfg: ArchConfig,
                tokens: Optional[torch.Tensor],
                positions: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None, tp: int = 1,
                collect_cache: bool = False, remat: bool = True):
    """Full-sequence forward over ``tokens`` or precomputed ``embeds``
    (B, S, d).  Returns (hidden, (k_stack, v_stack) | None).

    ``remat`` recomputes each block's activations in backward instead of
    saving them (the reference's per-block ``jax.checkpoint``); it only
    acts while autograd records, and serving passes ``remat=False`` as
    the reference's ``prefill`` does."""
    hq, hkv = cfg.padded_heads(tp)
    x = embeds if embeds is not None else L.embed(params["embed"],
                                                   tokens, cfg.d_model)
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(cfg, 0, s, b, x.device)

    fs = context.fsdp()

    def block(x, lp, li):
        if fs is not None:          # FSDP: gathered here, so recomputed
            lp = fs.layer(lp, li)
        q, k, v = _qkv_rope(cfg, lp, x, positions, hq, hkv)
        attn = L.blocked_attention(q, k, v, causal=True)
        return _attn_ffn_tail(cfg, lp, x, attn), k, v

    ks, vs = [], []
    layers = fs.pieces(params["blocks"]) if fs is not None \
        else L.unstack(params["blocks"])
    for li, lp in enumerate(layers):
        x, k, v = L.remat(block, x, lp, li) if remat else block(x, lp, li)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = L.apply_norm(cfg.norm, params["ln_f"], x)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, kv


def loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
         tp: int = 1) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens`` or the
    VLM's ``embeds``, ``labels``, optional ``mask`` and
    ``positions``)."""
    h, _ = forward_seq(params, cfg, batch.get("tokens"),
                       positions=batch.get("positions"),
                       embeds=batch.get("embeds"), tp=tp)
    return L.lm_loss_chunked(params["embed"], h, batch["labels"],
                             batch.get("mask"), vocab=cfg.padded_vocab(tp))


def prefill(params: Params, cfg: ArchConfig,
            tokens: Optional[torch.Tensor], tp: int = 1,
            embeds: Optional[torch.Tensor] = None,
            max_seq: Optional[int] = None, chunk: Optional[int] = None):
    """Process the prompt (``tokens``, or the VLM's ``embeds``); returns
    (last_logits, KVCache).

    ``chunk`` enables Sarathi-style chunked prefill: the prompt is
    processed ``chunk`` tokens at a time against the growing cache.  An
    ``embeds`` prompt is always processed whole, as in the reference.
    """
    first = tokens if tokens is not None else embeds
    b, s = first.shape[:2]
    if chunk is not None and s > chunk and s % chunk == 0 \
            and embeds is None:
        return _prefill_chunked(params, cfg, tokens, tp, max_seq, chunk)
    h, (k, v) = forward_seq(params, cfg, tokens, embeds=embeds, tp=tp,
                            collect_cache=True, remat=False)
    if max_seq is not None and max_seq > s:
        pad = (0, 0, 0, 0, 0, max_seq - s)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    lengths = torch.full((b,), s, dtype=torch.int32, device=first.device)
    logits = L.unembed(params["embed"], h[:, -1], cfg.padded_vocab(tp))
    return logits, _seq_shard(KVCache(k, v, lengths))


def _seq_mesh():
    """The bound mesh when the step holds context shards of the cache
    over a "model" axis of more than one rank, else None."""
    mesh = L._model_mesh()
    return mesh if mesh is not None and context.seq_sharded() else None


def _seq_shard(cache: KVCache) -> KVCache:
    """This rank's context shard of a full-context cache, when the step
    holds the cache sequence-sharded (the reference's ``cache_pspecs``)."""
    mesh = _seq_mesh()
    if mesh is None:
        return cache
    s = cache.k.shape[2] // mesh.shape["model"]
    i = mesh.coord("model")
    return KVCache(cache.k[:, :, i * s:(i + 1) * s].clone(),
                   cache.v[:, :, i * s:(i + 1) * s].clone(), cache.lengths)


def _prefill_chunked(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                     tp: int, max_seq: Optional[int], chunk: int):
    b, s = tokens.shape
    total = max(max_seq or s, s)
    cache = KVCache.zeros(cfg, b, total, tp, device=tokens.device)
    logits = None
    for c0 in range(0, s, chunk):
        logits, cache = extend_step(params, cfg, tokens[:, c0:c0 + chunk],
                                    cache, tp=tp, offset=c0)
    return logits, _seq_shard(cache)


def extend_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: KVCache, tp: int = 1,
                offset: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
    """Process a multi-token chunk against an existing cache.

    One Sarathi prefill chunk: the chunk's K/V is written into
    ``cache.k`` / ``cache.v`` in place at ``offset`` (default
    ``cache.lengths[0]``, which must be uniform across the batch) and
    ``lengths`` advances by the chunk length.  Returns the logits of the
    chunk's last token.
    """
    hq, hkv = cfg.padded_heads(tp)
    b, c = tokens.shape
    if offset is None:
        offset = int(cache.lengths[0])
    x = L.embed(params["embed"], tokens, cfg.d_model)     # (B, C, d)
    positions = _positions(cfg, offset, c, b, x.device)
    for li in range(cfg.num_layers):
        lp = layer_params(params, li)
        q, k, v = _qkv_rope(cfg, lp, x, positions, hq, hkv)
        kc, vc = cache.k[li], cache.v[li]
        kc[:, offset:offset + c] = k
        vc[:, offset:offset + c] = v
        # the causal mask (q_offset) blanks everything past the current
        # position, including stale/zero future cache slots
        attn = L.blocked_attention(q, kc, vc, causal=True, q_offset=offset)
        x = _attn_ffn_tail(cfg, lp, x, attn)
    h_last = L.apply_norm(cfg.norm, params["ln_f"], x[:, -1])
    logits = L.unembed(params["embed"], h_last, cfg.padded_vocab(tp))
    return logits, KVCache(cache.k, cache.v, cache.lengths + c)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def decode_step_paged(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      tables: torch.Tensor, lengths: torch.Tensor,
                      tp: int = 1, attn_fn=None):
    """One decode iteration reading/writing KV through a block table.

    k_pool/v_pool: (L, P+1, page, Hkv, D) page pools (page P is scratch);
    tables: (B, nblk) page ids with unmapped entries pointing at the
    scratch page; lengths: (B,).  Every lane writes its new K/V, in place,
    into the page holding position ``lengths[b]`` (the engine routes
    inactive lanes' tables to scratch).

    ``attn_fn(q, k_pool_l, v_pool_l, tables, lengths) -> (B, Hq, D)``
    defaults to the gather reference; the engine passes the paged
    flash-decode kernel.
    """
    hq, hkv = cfg.padded_heads(tp)
    attn_fn = attn_fn or L.paged_decode_attention
    ps = k_pool.shape[2]
    nblk = tables.shape[1]
    x = L.embed(params["embed"], tokens, cfg.d_model)    # (B, d)
    positions = _mrope(cfg, lengths[:, None])            # (B, 1[, 3])
    blk = lengths.long() // ps
    # a position past the mapped window must write to the scratch page P,
    # not alias (via clipping) onto the window's last live page
    in_window = blk < nblk
    blk = blk.clamp(0, nblk - 1)
    page = torch.gather(tables.long(), 1, blk[:, None])[:, 0]
    page = torch.where(in_window, page, k_pool.shape[1] - 1)
    off = lengths.long() % ps
    for li in range(cfg.num_layers):
        lp = layer_params(params, li)
        kc, vc = k_pool[li], v_pool[li]
        q, k, v = _qkv_rope(cfg, lp, x[:, None, :], positions, hq, hkv)
        kc[page, off] = k[:, 0]
        vc[page, off] = v[:, 0]
        attn = attn_fn(q[:, 0], kc, vc, tables, lengths + 1)
        x = _attn_ffn_tail(cfg, lp, x, attn)
    x = L.apply_norm(cfg.norm, params["ln_f"], x)
    logits = L.unembed(params["embed"], x, cfg.padded_vocab(tp))
    return logits, (k_pool, v_pool, lengths + 1)


def decode_fused_paged(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                       k_pool: torch.Tensor, v_pool: torch.Tensor,
                       tables: torch.Tensor, lengths: torch.Tensor,
                       alive: torch.Tensor, k_active: torch.Tensor,
                       n_steps: int, tp: int = 1, attn_fn=None,
                       eos_id: int = -1):
    """Fuse ``n_steps`` paged decode iterations, with greedy argmax,
    token feedback, per-lane length advance and eos freezing all on the
    device (the reference's ``lax.scan``; here a Python loop that the
    engine captures into one CUDA graph per ``n_steps``).

    ``k_active`` (a 0-d int32 tensor) is the actual horizon: steps at
    index >= ``k_active`` leave every lane frozen, so a bucketed
    ``n_steps`` emits exactly the tokens of an exact-length loop.
    ``alive`` is a (B,) bool tensor.  Nothing is read back to the host,
    so the loop can be captured.

    A frozen lane (inactive, eos'd, or index >= ``k_active``) still runs
    the step: its K/V write lands at its frozen length, one past its
    valid context, on a page it owns (or the scratch page, for inactive
    lanes whose table rows the caller routed there), but it emits
    nothing: ``emitted[j, b]`` marks the steps whose ``tokens_out[j, b]``
    is real.

    Returns ``(tokens_out (n_steps, B), emitted (n_steps, B), k_pool,
    v_pool, lengths)``; the pools are written in place.
    """
    toks, ln, al = tokens, lengths, alive
    tok_seq, emit_seq = [], []
    for idx in range(n_steps):
        logits, _ = decode_step_paged(params, cfg, toks, k_pool, v_pool,
                                      tables, ln, tp=tp, attn_fn=attn_fn)
        nxt = logits[:, :cfg.vocab].argmax(-1).to(toks.dtype)
        run = al & (k_active > idx)
        toks = torch.where(run, nxt, toks)
        ln = torch.where(run, ln + 1, ln)
        if eos_id >= 0:
            al = al & ~(run & (nxt == eos_id))
        tok_seq.append(toks)
        emit_seq.append(run)
    return (torch.stack(tok_seq), torch.stack(emit_seq), k_pool, v_pool,
            ln)


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: KVCache, tp: int = 1,
                attn_fn=None) -> Tuple[torch.Tensor, KVCache]:
    """One decode iteration: tokens (B,) -> logits (B, V), updated cache.

    ``attn_fn(q, k_cache, v_cache, lengths) -> (B, Hq, D)`` defaults to
    the plain reference; the engine passes the flash-decode kernel.
    """
    hq, hkv = cfg.padded_heads(tp)
    attn_fn = attn_fn or L.decode_attention
    x = L.embed(params["embed"], tokens, cfg.d_model)    # (B, d)
    b = x.shape[0]
    positions = _mrope(cfg, cache.lengths[:, None])      # (B, 1[, 3])
    s = cache.k.shape[2]
    mesh = _seq_mesh()
    sharded_attn = getattr(attn_fn, "seq_sharded", False)
    start, s_full = 0, s
    if mesh is not None:
        start, s_full = mesh.coord("model") * s, s * mesh.shape["model"]
    elif sharded_attn and L._model_mesh() is not None:
        raise ValueError("the sequence-sharded attention needs the cache "
                         "held in context shards (its S divisible by the "
                         "model axis)")
    # the reference's dynamic_update_slice clamps the start index, so a
    # stale (finished) lane past the window rewrites position S-1; on a
    # sharded cache the rank holding that position writes it
    idx = cache.lengths.long().clamp(0, s_full - 1) - start
    own = ((idx >= 0) & (idx < s))[:, None, None]
    idx = idx.clamp(0, s - 1)
    lanes = torch.arange(b, device=x.device)
    for li in range(cfg.num_layers):
        lp = layer_params(params, li)
        kc, vc = cache.k[li], cache.v[li]
        q, k, v = _qkv_rope(cfg, lp, x[:, None, :], positions, hq, hkv)
        k, v = k[:, 0], v[:, 0]
        if mesh is not None:
            k = torch.where(own, k, kc[lanes, idx])
            v = torch.where(own, v, vc[lanes, idx])
        kc[lanes, idx] = k
        vc[lanes, idx] = v
        if mesh is not None and not sharded_attn:
            kc = C.all_gather(kc, mesh, "model", 1)
            vc = C.all_gather(vc, mesh, "model", 1)
        attn = attn_fn(q[:, 0], kc, vc, cache.lengths + 1)
        x = _attn_ffn_tail(cfg, lp, x, attn)
    x = L.apply_norm(cfg.norm, params["ln_f"], x)
    logits = L.unembed(params["embed"], x, cfg.padded_vocab(tp))
    return logits, KVCache(cache.k, cache.v, cache.lengths + 1)
