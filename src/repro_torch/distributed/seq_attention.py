"""Sequence-sharded decode attention (port of
``repro.distributed.seq_attention``; paper IS-S, §5).

The KV cache shards its context dimension S over the "model" axis; each
rank computes the partial attention (un-normalised accumulator and
softmax statistics) over its S/P cached positions through the
flash-decode partial kernel (``kernels.ops.attention_decode_partial``;
its plain version on CPU tensors), then the ranks combine EXACTLY:
``all_reduce(MAX)`` of m, each rank rescales by exp(m - m_max), and
``all_reduce(SUM)`` of the rescaled accumulator and of l.  This moves
(B, Hq, D)-sized statistics instead of the (B, S, Hkv, D) cache.

The batch is sharded over the data axes as in the reference's
``in_specs``: a rank is handed its own rows (q, its cache shard and the
rows' global lengths) and returns its rows of the output.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops


def combine_partials(acc: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
                     mesh, axis: str = "model"):
    """The shards' partials (``layers.decode_attention_core``'s acc, l
    and m) combined exactly over ``axis``: every rank rescales its own to
    the global max and the rescaled acc and l are summed; returns the
    combined (acc, l)."""
    m_max = C.all_reduce(m, mesh, axis, "max")
    scale = torch.exp(m - m_max)
    return (C.all_reduce(acc * scale[..., None], mesh, axis),
            C.all_reduce(l * scale, mesh, axis))


def make_seq_sharded_attn(mesh, axis: str = "model"):
    """``attn(q, k_shard, v_shard, lengths) -> (B, Hq, D)`` for a bound
    ``mesh``: q (B, Hq, D) this rank's rows, replicated over ``axis``;
    k/v (B, S/P, Hkv, D) this rank's context shard (positions
    ``[i * S/P, (i + 1) * S/P)`` on coordinate ``i`` of ``axis``);
    lengths (B,) the rows' global valid lengths."""

    def attn(q, k_shard, v_shard, lengths):
        s_local = k_shard.shape[1]
        start = mesh.coord(axis) * s_local
        local = (lengths.to(torch.int32) - start).clamp(0, s_local)
        acc, l, m = ops.attention_decode_partial(
            q, k_shard, v_shard, local.to(torch.int32).contiguous())
        acc, l = combine_partials(acc, l, m, mesh, axis)
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        b, hkv, g, d = out.shape
        return out.reshape(b, hkv * g, d).to(q.dtype)

    attn.seq_sharded = True
    return attn
