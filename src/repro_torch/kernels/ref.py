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
import torch.nn.functional as F

NEG = -1e30            # the kernels' masked score and an empty chunk's m


def decode_gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K), b: (K, N) -> (M, N) in a's dtype, f32 accumulation."""
    return (a.float() @ b.float()).to(a.dtype)


def decode_gemm_split_ref(a: torch.Tensor, b: torch.Tensor,
                          bk: int) -> torch.Tensor:
    """The split-K kernel's function: the float32 product of each chunk
    of ``bk`` rows of K, summed in split order, in a's dtype (the same
    function as :func:`decode_gemm_ref`)."""
    af, bf = a.float(), b.float()
    out = af[:, :0] @ bf[:0]
    for k0 in range(0, a.shape[1], bk):
        out = out + af[:, k0:k0 + bk] @ bf[k0:k0 + bk]
    return out.to(a.dtype)


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
    return flash_decode_ref(q, *_gather_pages(k_pool, v_pool, tables),
                            lengths)


def _gather_pages(k_pool: torch.Tensor, v_pool: torch.Tensor,
                  tables: torch.Tensor):
    """Each request's pages in table order: (B, nblk * page, Hkv, D)."""
    b, nblk = tables.shape
    idx = tables.long()
    return tuple(p[idx].reshape(b, nblk * p.shape[1], *p.shape[2:])
                 for p in (k_pool, v_pool))


def decode_partials_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, chunk: int):
    """First pass of the split-context kernels: for each (request, kv
    head, chunk of ``chunk`` positions) the un-normalised ``acc`` and the
    chunk's softmax max ``m`` and sum ``l`` over its valid positions.

    q: (B, Hq, D); k/v: (B, S, Hkv, D); lengths: (B,), clamped to [0, S].
    Returns acc (B, Hkv, n_split, G, D), m and l (B, Hkv, n_split, G), all
    float32, with ``n_split = max(1, ceil(S / chunk))``; a chunk that
    starts at or past its length has ``l = 0`` and ``m = NEG``.
    """
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    n = max(1, -(-s // chunk))
    pad = (0, 0, 0, 0, 0, n * chunk - s)
    kc = F.pad(k.float(), pad).reshape(b, n, chunk, hkv, d)
    vc = F.pad(v.float(), pad).reshape(b, n, chunk, hkv, d)
    qr = q.reshape(b, hkv, g, d).float() * (1.0 / math.sqrt(d))
    lens = lengths.to(q.device).long().clamp(0, s)
    pos = torch.arange(n * chunk, device=q.device).reshape(n, chunk)
    valid = (pos[None] < lens[:, None, None])[:, None, :, None, :]
    scores = torch.einsum("bhgd,bnchd->bhngc", qr, kc)
    scores = torch.where(valid, scores, -math.inf)
    m = scores.amax(-1)
    m = torch.where(torch.isfinite(m), m, NEG)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    acc = torch.einsum("bhngc,bnchd->bhngd", p, vc)
    return acc, m, p.sum(-1)


def combine_partials_ref(acc: torch.Tensor, m: torch.Tensor,
                         l: torch.Tensor, lengths: torch.Tensor, chunk: int,
                         cap: int, dtype: torch.dtype) -> torch.Tensor:
    """Second pass: out = sum_i e_i acc_i / max(sum_i e_i l_i, 1e-20) over
    the ``ceil(len / chunk)`` partials of each (request, head), with
    ``e_i = exp(m_i - max_i m_i)``; a 0-length lane reads none and gives
    0.  Returns (B, Hq, D) in ``dtype``."""
    b, hkv, n, g, d = acc.shape
    lens = lengths.to(acc.device).long().clamp(0, cap)
    read = (torch.arange(n, device=acc.device)[None, :] * chunk
            < lens[:, None])[:, None, :, None]
    mmax = torch.where(read, m, NEG).amax(2, keepdim=True)
    e = torch.where(read, torch.exp(m - mmax), 0.0)
    out = (acc * e[..., None]).sum(2) / torch.clamp(
        (l * e).sum(2), min=1e-20)[..., None]
    return out.reshape(b, hkv * g, d).to(dtype)


def flash_decode_split_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           chunk: int) -> torch.Tensor:
    """The split-context kernel's two passes over contiguous caches:
    :func:`decode_partials_ref`, then :func:`combine_partials_ref`."""
    acc, m, l = decode_partials_ref(q, k, v, lengths, chunk)
    return combine_partials_ref(acc, m, l, lengths, chunk, k.shape[1],
                                q.dtype)


def paged_flash_decode_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 chunk: int) -> torch.Tensor:
    """The same two passes through a block table (positions, and so the
    chunks, are those of the gathered ``nblk * page`` context)."""
    return flash_decode_split_ref(
        q, *_gather_pages(k_pool, v_pool, tables), lengths, chunk)


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
