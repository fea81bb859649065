"""Plain PyTorch versions of the port's kernels (the allclose ground
truth; port of ``repro.kernels.ref``).

Each computes in float32 and returns its input's dtype.  The attention
versions follow the kernels' guards rather than the reference oracle's:
a lane whose length is 0 returns zeros (the kernels divide by
``max(l, 1e-20)``), where a plain softmax over an all-masked row would
give NaN.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def decode_gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K), b: (K, N) -> (M, N) in a's dtype, f32 accumulation."""
    return (a.float() @ b.float()).to(a.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D); k/v: (B, S, Hkv, D); lengths: (B,) -> (B, Hq, D).

    GQA decode attention over each request's valid prefix
    ``[0, lengths[b])``, float32 softmax.
    """
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qr = q.reshape(b, hkv, g, d).float() * scale
    scores = torch.einsum("bhgd,bshd->bhgs", qr, k.float())
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, -math.inf)
    m = scores.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    out = out / torch.clamp(l, min=1e-20)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_flash_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D); pools: (P+1, page, Hkv, D); tables: (B, nblk) page
    ids (unmapped -> scratch page P); lengths: (B,) -> (B, Hq, D)."""
    b = q.shape[0]
    nblk = tables.shape[1]
    ps = k_pool.shape[1]
    idx = tables.long()
    k = k_pool[idx].reshape(b, nblk * ps, *k_pool.shape[2:])
    v = v_pool[idx].reshape(b, nblk * ps, *v_pool.shape[2:])
    return flash_decode_ref(q, k, v, lengths)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
             state_out: Optional[torch.Tensor] = None):
    """RWKV6 recurrence, one step at a time in float32.

    r/k/v/w: (B, T, H, hs); u: (H, hs); state0: (B, H, hs, hs).
    Returns (y: (B, T, H, hs) in r's dtype, state_T float32):
        y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(w_t) S_{t-1} + k_t v_t^T
    ``state_T`` is copied into ``state_out`` when it is given (it may be
    ``state0``).
    """
    dtype = r.dtype
    r, k, v, w = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = state0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + uf * kv))
        s = w[:, t, :, :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else torch.empty_like(r)
    if state_out is not None:
        s = state_out.copy_(s)
    return y.to(dtype), s
