"""Model components for the transformer families (port of
``repro.models.layers``).

Plain functions on tensors over a parameter dict, with the reference's
layouts: weights are ``(d_in, d_out)`` so ``x @ W`` matches the JAX
code, expert weights ``(E, d_in, d_out)``, caches are ``(B, S, Hkv, D)``
and page pools ``(P+1, page, Hkv, D)`` with scratch page ``P``.  Norms,
rope and attention compute in float32 and cast back, as the reference
does.  The MoE layer is the reference's chunk-local capacity dispatch:
one chunk per data shard of an active mesh (``_data_chunks``), and the
expert-parallel form (``_apply_moe_ep``: local experts, a local trash
row, one ``all_reduce`` over "model") where the reference takes its
``shard_map``.  ``lm_loss_chunked``, ``unstack`` and ``remat`` are the
training helpers: the chunked loss, one unbind of every stacked leaf per
forward, and per-block recomputation in backward.

Under a bound mesh (``distributed.context``) whose "model" axis has more
than one rank, the parameters a layer is handed are this rank's shards
(``distributed.sharding.param_pspecs``), and the layers carry out the
planner's chains with explicit collectives: a column-parallel product is
gathered to full width where its consumer needs it (``qkv_project``,
``embed``, ``unembed``), a row-parallel product is summed over "model"
(``row_parallel``; the FFN's up/gate -> down chain needs no gather).
Whether a weight is sharded is read from its shape against the global
width the caller names.  The collectives are autograd's
(``distributed.collectives``): every activation outside a sharded
product is replicated over "model", the replicated input of a
column-parallel product goes through ``copy_to`` (its gradient summed
over "model"), and so does the MoE's routing weights where a rank holds
some of the experts; a replicated leaf (a norm, the router) gets the
same gradient on every model rank.  ``lm_loss_chunked`` takes a
vocab-parallel head's log-sum-exp over the ranks' columns, and under
data parallelism the masked mean over the global batch.  The
reference's ``seq_constraint``, ``_moe_constraint`` and
``_embed_constraint`` are left out: they only tell GSPMD where to place
data and never change a value, and here each rank holds exactly its
shards already.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as C
from repro_torch.distributed import context
from repro_torch.launch.mesh import data_axes

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Tensor parallelism over a bound mesh's "model" axis
# ---------------------------------------------------------------------------
def _model_mesh():
    """The active mesh when it is bound and its "model" axis has more
    than one rank, else None."""
    mesh = context.current_mesh()
    if mesh is None or not mesh.bound or "model" not in mesh.axis_names \
            or mesh.shape["model"] == 1:
        return None
    return mesh


def model_parts(n: int) -> int:
    """P where a bound mesh's "model" axis of P > 1 ranks divides ``n``
    (the sharding rules then cut a dim of size ``n`` over it), else 1."""
    mesh = _model_mesh()
    if mesh is None or n % mesh.shape["model"]:
        return 1
    return mesh.shape["model"]


def gather_cols(y: torch.Tensor, width: int) -> torch.Tensor:
    """A column-parallel output (last dim ``width / P`` on each rank)
    gathered to ``width``; unchanged when already full."""
    if y.shape[-1] >= width:
        return y
    return C.all_gather(y, _require_model_mesh(), "model", y.ndim - 1)


def row_reduce(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The row-parallel product of this rank's input slice ``x`` (last
    dim K/P) and rows ``w`` (K/P, N), summed over "model": the partial
    is kept in float32 and rounded once, after the sum.  On the card a
    16-bit product reads ``w`` as it is and writes its float32
    accumulator (``out_dtype``); the host, and a product autograd
    records, widen both operands."""
    if w.is_cuda and w.dtype in (torch.bfloat16, torch.float16) \
            and not torch.is_grad_enabled():
        y = torch.mm(x.reshape(-1, x.shape[-1]).to(w.dtype), w,
                     out_dtype=torch.float32).reshape(*x.shape[:-1],
                                                      w.shape[-1])
    else:
        y = torch.matmul(x.float(), w.float())
    return C.all_reduce(y, _require_model_mesh(), "model").to(x.dtype)


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a full ``x`` and a weight whose rows (K) may be
    sharded over "model" (then this rank's slice of x is used and the
    partials are summed)."""
    k = w.shape[-2]
    if k == x.shape[-1]:
        return x @ w
    mesh = _require_model_mesh()
    return row_reduce(C.split(x, mesh, "model", x.ndim - 1), w)


def column_input(x: torch.Tensor, w: torch.Tensor,
                 width: int) -> torch.Tensor:
    """``x`` as the input of ``x @ w``: where ``w``'s columns are a shard
    (fewer than ``width``), its gradient is summed over "model"."""
    if w.shape[-1] >= width:
        return x
    return C.copy_to(x, _require_model_mesh(), "model")


def _require_model_mesh():
    mesh = _model_mesh()
    if mesh is None:
        raise ValueError("a sharded weight needs a bound mesh with a "
                         "'model' axis of more than one rank")
    return mesh


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------
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
    """q, k, v of full heads; column-parallel shards (and their bias
    shards) are gathered, so a shard that splits a head is fine."""
    b, s, _ = x.shape
    q = column_input(x, p["wq"], hq * dh) @ p["wq"]
    k = column_input(x, p["wk"], hkv * dh) @ p["wk"]
    v = column_input(x, p["wv"], hkv * dh) @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = (gather_cols(t, h * dh) for t, h in ((q, hq), (k, hkv),
                                                   (v, hkv)))
    return (q.reshape(b, s, hq, dh), k.reshape(b, s, hkv, dh),
            v.reshape(b, s, hkv, dh))


# ---------------------------------------------------------------------------
# Blocked causal attention (training / prefill)
# ---------------------------------------------------------------------------
def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_block: int = 512, kv_block: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention walked in (q_block, kv_block) tiles.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq = G * Hkv.
    ``window`` > 0 restricts each query to the last ``window`` positions
    (``k_pos > q_pos - window``, RecurrentGemma's local attention).
    ``q_offset`` is the absolute position of q[0] relative to k[0]
    (prefill continuation).  The tiles and the fully-masked-row guards
    are the reference's; kv tiles lying wholly past the causal frontier
    or wholly before every query's window are skipped, which leaves the
    result unchanged (they add exactly 0).
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
        first_q = q_offset + q0
        q_pos = first_q + torch.arange(n_q, device=q.device)
        m = torch.full((b, n_q, hkv, g), -math.inf, device=q.device)
        l = torch.zeros((b, n_q, hkv, g), device=q.device)
        acc = torch.zeros((b, n_q, hkv, g, d), device=q.device)
        for k0 in range(0, skv, kb):
            if causal and k0 > first_q + n_q - 1:
                break
            n_k = min(kb, skv - k0)
            if window and k0 + n_k - 1 <= first_q - window:
                continue
            kblk = k[:, k0:k0 + kb].float()               # (B,kb,Hkv,D)
            vblk = v[:, k0:k0 + kb].float()
            s_ = torch.einsum("bqhgd,bkhd->bqhgk", qblk, kblk)
            k_pos = k0 + torch.arange(n_k, device=q.device)
            mask = torch.ones((n_q, n_k), dtype=torch.bool, device=q.device)
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
            if window:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
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


def apply_ffn(p: Params, x: torch.Tensor, act: str,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """``d_ff`` (the global hidden width) marks a model-sharded FFN: up
    and gate column-parallel chained into down row-parallel, one
    ``all_reduce`` for the whole FFN."""
    sharded = d_ff is not None and p["w_down"].shape[-2] < d_ff
    if sharded:
        x = C.copy_to(x, _require_model_mesh(), "model")
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(act, x @ p["w_gate"]) * h
    else:
        h = _act(act, h)
    if sharded:
        return row_reduce(h, p["w_down"])
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


def _data_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def _data_chunks(t: int) -> int:
    """Number of data shards to chunk the MoE dispatch over (1 off-mesh)."""
    mesh = context.current_mesh()
    if mesh is None:
        return 1
    dsize = _data_size(mesh)
    return dsize if dsize > 1 and t % dsize == 0 else 1


def _moe_partial(p: Params, x: torch.Tensor, weights: torch.Tensor,
                 experts: torch.Tensor, cfg, nx: int, lo: int, n_local: int,
                 f32_sum: bool) -> torch.Tensor:
    """The routed output of experts ``[lo, lo + n_local)`` for ``x``
    (T, d) cut into ``nx`` chunks, each ranking and capping its own
    (token, k) pairs at ``C = moe_capacity(T / nx)``.  ``p``'s expert
    weights hold exactly those experts.  A pair routed elsewhere or past
    capacity goes to one trash row (discarded on the way in, zero on the
    way out).  ``f32_sum``: the pairs' outputs are weighted and summed
    over k in float32 (the reference's ``local_moe``) and the float32
    sum is returned; otherwise in the activation dtype (its chunked
    dispatch)."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.topk
    tl = t // nx
    c = moe_capacity(tl, e, k, cfg.capacity_factor)
    dev = x.device
    flat_e = experts.reshape(nx, tl * k)
    # the unsharded step (one chunk, every expert) skips the expert-range
    # mask and the chunk offsets, which would change no slot there
    keyed, eloc, ok = flat_e, flat_e, None
    if n_local < e:
        eloc = flat_e - lo
        ok = (eloc >= 0) & (eloc < n_local)
    if nx > 1:
        chunk = torch.arange(nx, device=dev)[:, None]
        keyed, eloc = flat_e + chunk * e, eloc + chunk * n_local
    # ranks within (chunk, expert): chunk-major flat order is kept
    rank = _local_ranks(keyed.reshape(-1), t * k, nx * e).reshape(nx,
                                                                  tl * k)
    ok = rank < c if ok is None else ok & (rank < c)
    trash = nx * n_local * c
    slot = torch.where(ok, eloc * c + rank, trash).reshape(-1)
    token_idx = torch.arange(t, device=dev).repeat_interleave(k)
    ge = x.new_zeros((trash + 1, d))
    ge[slot] = x[token_idx]
    ge = ge[:trash].view(nx, n_local, c, d).transpose(0, 1).reshape(
        n_local, nx * c, d)
    up = torch.bmm(ge, p["w_up"])
    gate = torch.bmm(ge, p["w_gate"])
    h = _act(cfg.act, gate) * up
    out_e = torch.bmm(h, p["w_down"])                     # (El, X*C, d)
    out_e = out_e.view(n_local, nx, c, d).transpose(0, 1).reshape(trash, d)
    out = torch.cat([out_e, out_e.new_zeros((1, d))])[slot]
    if f32_sum:
        w = torch.where(ok.reshape(-1), weights.reshape(-1), 0.0)
        return (out.float() * w[:, None]).reshape(t, k, d).sum(dim=1)
    y = out * weights.reshape(-1)[:, None].to(out.dtype)
    return y.reshape(t, k, d).sum(dim=1)                  # (T, d)


def apply_moe(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (T, d_model) flattened tokens -> (T, d_model).

    The reference's chunk-local, sort-based capacity dispatch: float32
    router logits, softmax, top-k with the weights renormalised; the
    tokens are cut into one chunk per data shard of the active mesh
    (one chunk off-mesh), and each chunk ranks its own (token, k) pairs
    within their experts and writes them to slot ``(expert, rank)`` of a
    dense ``(E, C, d)`` buffer, pairs at rank >= C dropped; three
    batched products over the experts; each pair's output gathered back
    (0 for a dropped pair), scaled by its weight and summed over k; the
    shared expert's FFN added last.

    Where the reference drops out-of-range ranks inside its scatter and
    gather, here they are routed to one extra trash row: no index is
    ever out of range, and nothing reads back to the host or takes a
    data-dependent shape, so a decode step holding this layer can be
    captured in a CUDA graph.

    Under a mesh, the reference's condition (a "model" axis that divides
    the experts, more than one data chunk, no shared expert) selects the
    expert-parallel form (:func:`_apply_moe_ep`).  A bound mesh's
    rank holds its E/P experts whenever the sharding rules split them,
    and then sums its partial over "model".  When the step holds each
    data shard's rows locally (``context.batch_local``), ``x`` is this
    rank's chunk.
    """
    mesh = context.current_mesh()
    t, d = x.shape
    local = mesh is not None and context.batch_local()
    n_chunks = _data_chunks(t * _data_size(mesh) if local else t)
    nx = 1 if local else n_chunks
    if (mesh is not None and "model" in mesh.axis_names
            and cfg.num_experts % mesh.shape["model"] == 0
            and n_chunks > 1 and "shared" not in p):
        return _apply_moe_ep(p, x, cfg, mesh, nx).to(x.dtype)
    weights, experts = _route(p, x, cfg)
    e_local = p["w_up"].shape[-3]
    if e_local < cfg.num_experts:       # this rank's experts of a split
        mm = _require_model_mesh()
        y = _moe_partial(p, C.copy_to(x, mm, "model"),
                         C.copy_to(weights, mm, "model"), experts, cfg, nx,
                         mm.coord("model") * e_local, e_local, False)
        y = C.all_reduce(y.float(), mm, "model").to(y.dtype)
    else:
        y = _moe_partial(p, x, weights, experts, cfg, nx, 0,
                         cfg.num_experts, False)
    if "shared" in p:
        f = cfg.d_ff_expert * cfg.num_shared_experts
        y = y + apply_ffn(p["shared"], x, cfg.act, d_ff=f)
    return y.to(x.dtype)


def _route(p: Params, x: torch.Tensor, cfg):
    logits = x.float() @ p["router"]                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, cfg.topk, dim=-1)  # (T, K)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                    min=1e-9)
    return weights, experts


def _apply_moe_ep(p: Params, x: torch.Tensor, cfg, mesh,
                  nx: int) -> torch.Tensor:
    """Expert-parallel MoE (the reference's ``_apply_moe_shardmap``):
    each of the ``nx`` chunks held here is routed on its own; each model
    rank ranks the chunk's pairs over all experts, keeps the pairs of
    its E/P experts below capacity (the rest go to its trash row),
    weights and sums them over k in float32, and the ranks' float32
    partials are summed with one ``all_reduce`` over "model", then
    rounded (in backward, the gradients of the tokens and routing weights
    they used are summed over "model").  On a mesh that is a description
    only, this process runs
    every model rank's part in turn (full expert weights) and sums them
    in rank order: the same program, and the same products chunk by
    chunk, in one process."""
    tp = mesh.shape["model"]
    el = cfg.num_experts // tp
    ranks = [mesh.coord("model")] if mesh.bound else range(tp)
    tl = x.shape[0] // nx
    outs = []
    for i in range(nx):
        xc = x[i * tl:(i + 1) * tl]
        weights, experts = _route(p, xc, cfg)
        if mesh.bound:      # this rank's experts' gradients are partial
            xc = C.copy_to(xc, mesh, "model")
            weights = C.copy_to(weights, mesh, "model")
        y = None
        for r in ranks:
            local = p if p["w_up"].shape[-3] == el else \
                _expert_slice(p, r, el)
            part = _moe_partial(local, xc, weights, experts, cfg, 1,
                                r * el, el, True)
            y = part if y is None else y + part
        outs.append(y)
    y = torch.cat(outs) if nx > 1 else outs[0]
    return C.all_reduce(y, mesh, "model") if mesh.bound else y


def _expert_slice(p: Params, r: int, el: int) -> Params:
    return {n: p[n][r * el:(r + 1) * el]
            for n in ("w_up", "w_gate", "w_down")}


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------
def init_embed(gen, vocab: int, d_model: int, dtype, tie: bool,
               device=None) -> Params:
    p = {"table": dense_init(gen, (vocab, d_model), dtype, device=device)}
    if not tie:
        p["head"] = dense_init(gen, (d_model, vocab), dtype, device=device)
    return p


def embed(p: Params, tokens: torch.Tensor,
          d_model: Optional[int] = None) -> torch.Tensor:
    """``d_model`` (the global width) marks a d-sharded table, whose
    lookups are gathered over "model"."""
    out = p["table"][tokens.long()]
    return gather_cols(out, d_model) if d_model else out


def unembed(p: Params, h: torch.Tensor,
            vocab: Optional[int] = None) -> torch.Tensor:
    """``vocab`` (the global, padded vocab) marks a vocab-sharded head,
    whose logits are gathered over "model"; a tied d-sharded table is a
    row-parallel product."""
    w = p.get("head")
    if w is None:
        return row_parallel(h, p["table"].T)
    if vocab:
        return gather_cols(column_input(h, w, vocab) @ w, vocab)
    return h @ w


# ---------------------------------------------------------------------------
# Training helpers
# ---------------------------------------------------------------------------
def unstack(tree: Params) -> list:
    """A stacked tree (leading layer axis on every leaf) as one dict of
    views per layer.  Each leaf is unbound once, so a backward pass
    stacks the layers' gradients into the leaf's in one copy, where a
    per-layer ``select`` would add a full-size gradient per layer."""
    def unbind(t):
        return {k: unbind(v) for k, v in t.items()} \
            if isinstance(t, dict) else t.unbind(0)

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} \
            if isinstance(t, dict) else t[i]

    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    parts = unbind(tree)
    return [take(parts, i) for i in range(first.shape[0])]


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in backward instead of
    saved (the reference's ``jax.checkpoint``) when autograd records.
    The recomputation runs under the forward's distribution context
    (autograd's backward of CUDA tensors runs in a thread of its own)."""
    if torch.is_grad_enabled():
        state = context.snapshot()

        def under_forward_context(*xs):
            with context.restored(state):
                return fn(*xs)
        return checkpoint(under_forward_context, *args, use_reentrant=False)
    return fn(*args)


def _ce_sums(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = (lse - gold) * mask
    return ce.sum(), mask.sum()


def _chunk_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor):
    return _ce_sums(h.float() @ w, labels, mask)


def _chunk_ce_tied_parallel(h: torch.Tensor, w: torch.Tensor,
                            labels: torch.Tensor, mask: torch.Tensor):
    """``_chunk_ce`` with ``h`` this rank's slice of the hidden width and
    ``w`` its rows (d/P, V) of a tied table: the full logits are the
    row-parallel product summed over "model"."""
    logits = C.all_reduce(h.float() @ w, _require_model_mesh(), "model")
    return _ce_sums(logits, labels, mask)


def _chunk_ce_vocab_parallel(h: torch.Tensor, w: torch.Tensor,
                             labels: torch.Tensor, mask: torch.Tensor):
    """``_chunk_ce`` over this rank's vocabulary columns ``w`` (d, V/P):
    the log-sum-exp by an ``all_reduce`` MAX (a stabiliser, not
    differentiated) and SUM over "model", the gold logit from the rank
    whose columns hold the label."""
    mesh = _require_model_mesh()
    logits = C.copy_to(h.float(), mesh, "model") @ w      # (B, c, V/P)
    vl = logits.shape[-1]
    m = C.all_reduce(logits.detach().amax(-1), mesh, "model", "max")
    se = torch.exp(logits - m[..., None]).sum(-1)
    lse = torch.log(C.all_reduce(se, mesh, "model")) + m
    local = labels - mesh.coord("model") * vl
    own = (local >= 0) & (local < vl)
    gold = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    gold = C.all_reduce(torch.where(own, gold, 0.0), mesh, "model")
    ce = (lse - gold) * mask
    return ce.sum(), mask.sum()


def lm_loss_chunked(p_embed: Params, h: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    chunk: int = 512, vocab: Optional[int] = None
                    ) -> torch.Tensor:
    """Mean masked cross-entropy over the head without materializing
    (B, S, V) logits: the sequence is walked in chunks whose float32
    (B, chunk, V) logits are recomputed in backward.

    ``vocab`` (the global, padded vocabulary) marks a head whose columns
    may be a shard over "model" (vocab-parallel cross-entropy); a tied,
    d-sharded table gives full logits by a row-parallel product.  When
    the step holds its data shard of the batch (``context.batch_local``)
    the sums of the masked losses and of the mask are taken over the
    data axes, so every rank returns the global batch's mean."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the loss "
                         f"chunk {chunk}")
    w = p_embed.get("head")
    ce_fn = _chunk_ce
    if w is None:
        w = p_embed["table"].T
        if w.shape[0] < h.shape[-1]:          # d-sharded tied table
            h = C.split(h, _require_model_mesh(), "model", h.ndim - 1)
            ce_fn = _chunk_ce_tied_parallel
    elif vocab and w.shape[-1] < vocab:
        ce_fn = _chunk_ce_vocab_parallel
    w = w.float()
    labels = labels.long()
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        part = slice(c0, c0 + chunk)
        ce, n = remat(ce_fn, h[:, part], w, labels[:, part],
                      mask[:, part].float())
        tot = tot + ce
        cnt = cnt + n
    mesh = context.current_mesh()
    if mesh is not None and mesh.bound and context.batch_local():
        daxes = data_axes(mesh)
        tot = C.all_reduce(tot, mesh, daxes)
        cnt = C.all_reduce(cnt.detach(), mesh, daxes)
    return tot / torch.clamp(cnt, min=1.0)
