"""Model components for the transformer families (port of
``repro.models.layers``).

Plain functions on tensors over a parameter dict, with the reference's
layouts: weights are ``(d_in, d_out)`` so ``x @ W`` matches the JAX
code, expert weights ``(E, d_in, d_out)``, caches are ``(B, S, Hkv, D)``
and page pools ``(P+1, page, Hkv, D)`` with scratch page ``P``.  Norms,
rope and attention compute in float32 and cast back, as the reference
does.  The MoE layer is the reference's single-device dispatch (one
chunk; the expert-parallel ``shard_map`` form arrives with the
distribution slice).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(kind: str, d: int, dtype=torch.float32, device=None,
              lead=()) -> Params:
    p = {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=dtype, device=device)
    return p


def apply_norm(kind: str, p: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if kind == "layernorm":
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE + M-RoPE)
# ---------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    # a Python-scalar base: no host-to-device copy, so a decode step can
    # be captured in a CUDA graph
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) absolute token positions, or
    (B, S, 3) for M-RoPE (Qwen2-VL), where frequency ``i`` of the D/2
    takes the position stream of the section holding it
    (``mrope_sections`` consecutive widths, cut to D/2)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    if positions.ndim == 3:                               # M-RoPE
        if mrope_sections is None or sum(mrope_sections) < d // 2:
            raise ValueError(f"M-RoPE positions need sections covering "
                             f"D/2 = {d // 2}, got {mrope_sections}")
        # section id of each frequency, built on the device from Python
        # bounds (no host-to-device copy, so a step stays capturable)
        freq = torch.arange(d // 2, device=x.device)
        sec = (freq >= mrope_sections[0]).long() + (
            freq >= mrope_sections[0] + mrope_sections[1]).long()
        pos = positions.float().index_select(-1, sec)     # (B, S, D/2)
        ang = pos * inv
    else:
        ang = positions.float()[..., None] * inv          # (B, S, D/2)
    cos = torch.cos(ang)[..., None, :]                    # (B, S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / attention initialisation
# ---------------------------------------------------------------------------
def dense_init(gen, shape, dtype, scale: float = 0.02,
               device=None) -> torch.Tensor:
    """N(0, scale^2) weights in ``dtype``, the distribution of the
    reference's ``dense_init`` (drawn from a ``torch.Generator``, so the
    values differ; tests bridge the reference's own parameters).  A meta
    tensor is returned undrawn (shape templates)."""
    w = torch.empty(shape, dtype=dtype, device=device)
    if w.device.type != "meta":
        w.normal_(0.0, scale, generator=gen)
    return w


def init_attention(gen, cfg, dtype, hq: int, hkv: int, device=None,
                   lead=()) -> Params:
    d, dh = cfg.d_model, cfg.d_head
    p = {
        "wq": dense_init(gen, (*lead, d, hq * dh), dtype, device=device),
        "wk": dense_init(gen, (*lead, d, hkv * dh), dtype, device=device),
        "wv": dense_init(gen, (*lead, d, hkv * dh), dtype, device=device),
        "wo": dense_init(gen, (*lead, hq * dh, d), dtype,
                         scale=0.02 / math.sqrt(2 * cfg.num_layers),
                         device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((*lead, width * dh), dtype=dtype,
                                  device=device)
    return p


def qkv_project(p: Params, x: torch.Tensor, hq: int, hkv: int, dh: int):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, hq, dh), k.reshape(b, s, hkv, dh),
            v.reshape(b, s, hkv, dh))


# ---------------------------------------------------------------------------
# Blocked causal attention (prefill)
# ---------------------------------------------------------------------------
def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_block: int = 512,
                      kv_block: int = 512, q_offset: int = 0
                      ) -> torch.Tensor:
    """Online-softmax attention walked in (q_block, kv_block) tiles.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq = G * Hkv.
    ``q_offset`` is the absolute position of q[0] relative to k[0]
    (prefill continuation).  The tiles and the fully-masked-row guards
    are the reference's; kv tiles lying wholly past the causal frontier
    are skipped, which leaves the result unchanged (they add exactly 0).
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qb = min(q_block, sq)
    kb = min(kv_block, skv)
    scale = 1.0 / math.sqrt(d)
    qr = q.reshape(b, sq, hkv, g, d)
    outs = []
    for q0 in range(0, sq, qb):
        qblk = qr[:, q0:q0 + qb].float() * scale          # (B,qb,Hkv,G,D)
        n_q = qblk.shape[1]
        q_pos = q_offset + q0 + torch.arange(n_q, device=q.device)
        m = torch.full((b, n_q, hkv, g), -math.inf, device=q.device)
        l = torch.zeros((b, n_q, hkv, g), device=q.device)
        acc = torch.zeros((b, n_q, hkv, g, d), device=q.device)
        for k0 in range(0, skv, kb):
            if causal and k0 > q_offset + q0 + n_q - 1:
                break
            kblk = k[:, k0:k0 + kb].float()               # (B,kb,Hkv,D)
            vblk = v[:, k0:k0 + kb].float()
            s_ = torch.einsum("bqhgd,bkhd->bqhgk", qblk, kblk)
            k_pos = k0 + torch.arange(kblk.shape[1], device=q.device)
            mask = torch.ones((n_q, kblk.shape[1]), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
            mask = mask[None, :, None, None, :]
            s_ = torch.where(mask, s_, -math.inf)
            m_new = torch.maximum(m, s_.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p_ = torch.where(mask, torch.exp(s_ - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                               0.0)
            l = l * corr + p_.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p_, vblk)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
    out = torch.cat(outs, dim=1)
    return out.reshape(b, sq, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention against a KV cache
# ---------------------------------------------------------------------------
def decode_attention_core(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, valid: torch.Tensor):
    """Partial-softmax attention over one cache shard.

    q: (B, Hq, D); k/v_cache: (B, S, Hkv, D); valid: (B, S) bool.
    Returns (acc, l, m): the un-normalised output and softmax statistics
    that let shards be combined exactly.  As in the reference, q and the
    probabilities are rounded to the cache dtype before their products,
    which are summed in float32.
    """
    b, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qr = q.reshape(b, hkv, g, d).float() * scale
    s_ = torch.einsum("bhgd,bshd->bhgs", qr.to(k_cache.dtype).float(),
                      k_cache.float())
    vmask = valid[:, None, None, :]
    s_ = torch.where(vmask, s_, -math.inf)
    m = s_.amax(-1)                                       # (B,Hkv,G)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(vmask, torch.exp(s_ - m_safe[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return acc, l, m_safe


def decode_attention(q, k_cache, v_cache, lengths):
    """q: (B,Hq,D); caches (B,S,Hkv,D); lengths: (B,) valid prefixes."""
    s = k_cache.shape[1]
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    acc, l, _ = decode_attention_core(q, k_cache, v_cache, valid)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    b, hkv, g, d = out.shape
    return out.reshape(b, hkv * g, d).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, tables, lengths):
    """Decode attention through a block table, by gathering the slots'
    pages into a contiguous view.

    q: (B, Hq, D); pools: (P+1, page, Hkv, D) with page P a scratch page;
    tables: (B, nblk) page ids (unmapped entries point at the scratch
    page); lengths: (B,).  The paged flash-decode kernel computes the
    same function without materialising the gather.
    """
    b = q.shape[0]
    nblk = tables.shape[1]
    ps = k_pool.shape[1]
    idx = tables.long()
    k = k_pool[idx].reshape(b, nblk * ps, *k_pool.shape[2:])
    v = v_pool[idx].reshape(b, nblk * ps, *v_pool.shape[2:])
    return decode_attention(q, k, v, lengths)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
def init_ffn(gen, d_model: int, d_ff: int, gated: bool, dtype,
             num_layers: int = 24, device=None, lead=()) -> Params:
    p = {"w_up": dense_init(gen, (*lead, d_model, d_ff), dtype,
                            device=device),
         "w_down": dense_init(gen, (*lead, d_ff, d_model), dtype,
                              scale=0.02 / math.sqrt(2 * num_layers),
                              device=device)}
    if gated:
        p["w_gate"] = dense_init(gen, (*lead, d_model, d_ff), dtype,
                                 device=device)
    return p


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if name == "silu" else F.gelu(x, approximate="tanh")


def apply_ffn(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(act, x @ p["w_gate"]) * h
    else:
        h = _act(act, h)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE: capacity-grouped dispatch (sort-based ranks, dense (E, C, d) slots)
# ---------------------------------------------------------------------------
def init_moe(gen, cfg, dtype, device=None, lead=()) -> Params:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    p = {
        "router": dense_init(gen, (*lead, d, e), torch.float32,
                             device=device),
        "w_up": dense_init(gen, (*lead, e, d, f), dtype, device=device),
        "w_gate": dense_init(gen, (*lead, e, d, f), dtype, device=device),
        "w_down": dense_init(gen, (*lead, e, f, d), dtype,
                             scale=0.02 / math.sqrt(2 * cfg.num_layers),
                             device=device),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_ffn(gen, d, f * cfg.num_shared_experts,
                               cfg.gated_ffn, dtype, cfg.num_layers,
                               device=device, lead=lead)
    return p


def moe_capacity(tokens: int, num_experts: int, topk: int,
                 factor: float) -> int:
    c = max(1, int(math.ceil(tokens * topk / num_experts * factor)))
    return -(-c // 16) * 16   # a multiple of 16, as the reference's


def _local_ranks(flat_e: torch.Tensor, n: int, e: int) -> torch.Tensor:
    """Rank of each (token, k) pair within its expert group (stable:
    pairs of one expert are ranked in flat order)."""
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(
        sorted_e, torch.arange(e, device=flat_e.device,
                               dtype=sorted_e.dtype))
    rank_sorted = torch.arange(n, device=flat_e.device) - first[sorted_e]
    return torch.zeros((n,), dtype=torch.int32,
                       device=flat_e.device).scatter_(
        0, order, rank_sorted.to(torch.int32))


def apply_moe(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (T, d_model) flattened tokens -> (T, d_model).

    The reference's single-device dispatch: float32 router logits,
    softmax, top-k with the weights renormalised; each (token, k) pair
    ranked within its expert and written to slot ``(expert, rank)`` of a
    dense ``(E, C, d)`` buffer, pairs at rank >= C dropped; three batched
    products over every expert; each pair's output gathered back (0 for
    a dropped pair), scaled by its weight in the activation dtype and
    summed over k; the shared expert's FFN added last.

    Where the reference drops out-of-range ranks inside its scatter and
    gather, here they are routed to one extra trash row (discarded on
    the way in, zero on the way out): no index is ever out of range, and
    nothing reads back to the host or takes a data-dependent shape, so
    a decode step holding this layer can be captured in a CUDA graph.
    """
    t, d = x.shape
    e, k = cfg.num_experts, cfg.topk
    c = moe_capacity(t, e, k, cfg.capacity_factor)
    logits = x.float() @ p["router"]                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, k, dim=-1)       # (T, K)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                    min=1e-9)
    flat_e = experts.reshape(-1)
    rank = _local_ranks(flat_e, t * k, e)                 # (T*K,)
    slot = torch.where(rank < c, flat_e * c + rank, e * c)
    token_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    ge = x.new_zeros((e * c + 1, d))
    ge[slot] = x[token_idx]
    ge = ge[:e * c].view(e, c, d)
    up = torch.bmm(ge, p["w_up"])
    gate = torch.bmm(ge, p["w_gate"])
    h = _act(cfg.act, gate) * up
    out_e = torch.bmm(h, p["w_down"])                     # (E, C, d)
    out = torch.cat([out_e.reshape(e * c, d), out_e.new_zeros((1, d))])
    y = out[slot] * weights.reshape(-1)[:, None].to(out.dtype)
    y = y.reshape(t, k, d).sum(dim=1)                     # (T, d)
    if "shared" in p:
        y = y + apply_ffn(p["shared"], x, cfg.act)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------
def init_embed(gen, vocab: int, d_model: int, dtype, tie: bool,
               device=None) -> Params:
    p = {"table": dense_init(gen, (vocab, d_model), dtype, device=device)}
    if not tie:
        p["head"] = dense_init(gen, (d_model, vocab), dtype, device=device)
    return p


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def unembed(p: Params, h: torch.Tensor) -> torch.Tensor:
    w = p.get("head")
    if w is None:
        w = p["table"].T
    return h @ w
