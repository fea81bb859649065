"""Plain PyTorch versions of the flash-decode kernels (the allclose
ground truth; port of the attention oracles in ``repro.kernels.ref``).

Both compute in float32 and return q's dtype.  They follow the kernels'
guards rather than the reference oracle's: a lane whose length is 0
returns zeros (the kernels divide by ``max(l, 1e-20)``), where a plain
softmax over an all-masked row would give NaN.
"""
from __future__ import annotations

import math

import torch


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
