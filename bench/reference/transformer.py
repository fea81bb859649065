"""Plain PyTorch forward of a decoder-only transformer (Llama-style dense,
or MoE with top-k routing), for holding served tokens to.

It reads a configuration file's sizes and the parameter tree the
benchmark made, and nothing of the program: every layer is written out
here from the published description, in float32 (TF32 off), one layer at
a time over all the sequences, the layer's weights widened as it runs:

    x = embed[token]
    per layer:  h = rmsnorm(x);  q, k, v = h Wq, h Wk, h Wv
                q, k = rope(q), rope(k)   (rotate-half, theta)
                x = x + softmax(q k^T / sqrt(D) + causal) v Wo
                h = rmsnorm(x);  x = x + ffn(h)
    ffn:        dense  (silu(h Wgate) * h Wup) Wdown
                MoE    softmax(h Wrouter) -> top-k, weights renormalised,
                       sum of the k experts' gated FFNs, each weighted
    logits = rmsnorm(x) Whead

The configuration's capacity rule (``capacity_factor``) is followed where
the served work fixes it: a prompt is taken in chunks of the engine's
``prefill_chunk`` tokens, and within a chunk the (token, expert) pairs of
each expert, in token-major order, past ``C = ceil(T k / E x factor)``
rounded up to a multiple of 16 add nothing.  A decode position is one
token of a batch whose other lanes the reference does not know; alone it
never reaches capacity, so it is computed dropless.

Given ``routes`` (the program's record of each sequence's routing:
``(positions, n_moe, k)`` expert ids, ``-1 - e`` for a pair the program
dropped; ``bench/harness/routes.py``), the MoE layer follows it instead:
the recorded set, weighted by the reference's own float32 router
probabilities renormalised over that set, a recorded drop adding
nothing.  The record's layer axis counts MoE layers, not layers: where
:func:`moe_layers` gives ``(i_0 < i_1 < ...)``, layer ``i_j`` reads
``routes[:, j]``.  This forward writes out every layer of an MoE as
MoE, so there ``j`` is the layer.  The record is then checked against
the reference's own scores and rule, into ``self.routing``:
``route_slack_max``, the most by which
a chosen expert's router logit lies below the reference's own k-th
best, over every position and layer; ``prefill_drop_mismatches``, the
prompt pairs whose recorded drop disagrees with the capacity rule
applied to the recorded set chunk by chunk; ``dropped_share_decode``,
the share of decode pairs recorded dropped; and ``route_flip_share``,
the share of (position, layer) whose set differs from the reference's
own top k.  A decode step's drops depend on its other lanes, so they
are held to the rule over whole recorded steps, every lane of each
(:meth:`Reference.decode_drop_mismatches`).

``record=True`` keeps the reference's own routing as such a record, in
``self.recorded``: the control's, handed to the float32 reference as
``routes``, reads how far a lower precision's own routing strays.

``precision="fp8"`` is the control of a bf16 configuration: every bf16
product (projections, experts, head; not the float32 router) takes its
input rounded to float8 e4m3 with one scale a row and its weight with
one scale an output column.

The module also states the model it writes out, for the harness:
``layout`` gives the parameter tree the benchmark makes for it,
``assumes`` what the forward takes for granted of the model, which the
harness holds the program's own configuration to, and ``moe_layers`` the
layers whose FFN routes, which the routing record counts.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bench.count.transformer import Shape

FP8_MAX = 448.0
#: std of the RMSNorm scales about 1, so a norm that drops its scale, or
#: takes another layer's, moves the logits
NORM_STD = 0.1


def layout(cfg: Dict) -> Tuple[List, List, List]:
    """(matrices, float32 matrices, norm scales): ``(path, shape, std)``
    entries of the parameter tree, in the port's layout (the layer dim
    leading every block leaf, weights ``(d_in, d_out)``, experts
    ``(E, d_in, d_out)``).  ``std`` is ``init_std``, and
    ``init_std / sqrt(2 layers)`` for the products that write the
    residual stream (``wo``, ``w_down``); a norm scale is
    ``1 + NORM_STD * N(0, 1)``."""
    s = Shape.of(cfg)
    std = float(cfg.get("init_std", 0.02))
    out_std = std / math.sqrt(2 * s.layers)
    n = s.layers
    mats = [(("embed", "table"), (s.vocab, s.d), std)]
    if not s.tied:
        mats.append((("embed", "head"), (s.d, s.vocab), std))
    mats += [
        (("blocks", "attn", "wq"), (n, s.d, s.hq * s.dh), std),
        (("blocks", "attn", "wk"), (n, s.d, s.hkv * s.dh), std),
        (("blocks", "attn", "wv"), (n, s.d, s.hkv * s.dh), std),
        (("blocks", "attn", "wo"), (n, s.hq * s.dh, s.d), out_std),
    ]
    f32 = []
    if s.moe:
        e, f = s.experts, s.ff_expert
        mats += [(("blocks", "moe", "w_up"), (n, e, s.d, f), std),
                 (("blocks", "moe", "w_gate"), (n, e, s.d, f), std),
                 (("blocks", "moe", "w_down"), (n, e, f, s.d), out_std)]
        f32.append((("blocks", "moe", "router"), (n, s.d, e), std))
    else:
        mats += [(("blocks", "ffn", "w_up"), (n, s.d, s.ff), std),
                 (("blocks", "ffn", "w_gate"), (n, s.d, s.ff), std),
                 (("blocks", "ffn", "w_down"), (n, s.ff, s.d), out_std)]
    norms = [(("blocks", "ln1", "scale"), (n, s.d), NORM_STD),
             (("blocks", "ln2", "scale"), (n, s.d), NORM_STD),
             (("ln_f", "scale"), (s.d,), NORM_STD)]
    return mats, f32, norms


def assumes(cfg: Dict) -> Dict:
    """What this forward takes for granted of the model, by the names of
    the port's configuration fields."""
    return {"family": cfg["port"]["family"], "act": cfg["hidden_act"],
            "norm": "rmsnorm", "qkv_bias": bool(cfg["attention_bias"]),
            "gated_ffn": True, "mrope": False}


def moe_layers(cfg: Dict) -> Tuple[int, ...]:
    """The indices, in stack order, of the layers whose FFN routes:
    every layer of an MoE file, none of a dense one.  The forward writes
    out one kind of FFN a stack, as the port does, so a file whose
    Qwen3-MoE keys state a dense layer raises ``ValueError``."""
    if not cfg.get("num_experts"):
        return ()
    dense = list(cfg.get("mlp_only_layers") or [])
    step = int(cfg.get("decoder_sparse_step", 1))
    if dense or step != 1:
        raise ValueError(
            f"{cfg['name']}: dense layers in an MoE stack (mlp_only_layers "
            f"{dense}, decoder_sparse_step {step}); this reference writes "
            f"out every layer of an MoE as MoE")
    return tuple(range(int(cfg["num_hidden_layers"])))


def _qdq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    def __init__(self, cfg: Dict, params: Dict, precision: str = "fp32",
                 prefill_chunk: int = 512):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.cfg = cfg
        self.p = params
        self.precision = precision
        self.chunk = int(prefill_chunk)
        self.d = int(cfg["hidden_size"])
        self.hq = int(cfg["num_attention_heads"])
        self.hkv = int(cfg["num_key_value_heads"])
        self.dh = int(cfg.get("head_dim") or self.d // self.hq)
        self.layers = int(cfg["num_hidden_layers"])
        self.vocab = int(cfg["vocab_size"])
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.experts = int(cfg.get("num_experts") or 0)
        self.topk = int(cfg.get("num_experts_per_tok") or 0)
        self.factor = float(cfg.get("capacity_factor") or 0.0)
        #: layer -> its ordinal among the MoE layers (a record's layer axis)
        self.moe = {li: j for j, li in enumerate(moe_layers(cfg))}
        self.recorded = None

    # -- pieces ---------------------------------------------------------------
    def _lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.precision == "fp8":
            return _qdq(x, -1) @ _qdq(w, 0)
        return x @ w

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                               + self.eps) * scale.float()

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        half = self.dh // 2
        inv = 1.0 / self.theta ** (torch.arange(0, self.dh, 2,
                                                device=x.device,
                                                dtype=torch.float32)
                                   / self.dh)
        ang = pos.float()[:, None] * inv[None, :]          # (S, D/2)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def _attention(self, q, k, v) -> torch.Tensor:
        """q (S, Hq, D), k/v (S, Hkv, D) -> (S, Hq * D), causal."""
        s = q.shape[0]
        g = self.hq // self.hkv
        mask = torch.ones((s, s), dtype=torch.bool,
                          device=q.device).triu(1)
        out = torch.empty((s, self.hq, self.dh), device=q.device)
        for h in range(self.hkv):
            qh = q[:, h * g:(h + 1) * g].transpose(0, 1)   # (G, S, D)
            sc = qh @ k[:, h].T / math.sqrt(self.dh)       # (G, S, S)
            sc.masked_fill_(mask, -math.inf)
            out[:, h * g:(h + 1) * g] = (torch.softmax(sc, -1)
                                         @ v[:, h]).transpose(0, 1)
        return out.reshape(s, self.hq * self.dh)

    def _ffn(self, h: torch.Tensor, lp: Dict) -> torch.Tensor:
        f = lp["ffn"]
        gate = torch.nn.functional.silu(self._lin(h, f["w_gate"]))
        return self._lin(gate * self._lin(h, f["w_up"]), f["w_down"])

    def _cap(self, t: int) -> int:
        """The capacity rule's ``C`` for a call of ``t`` tokens."""
        cap = max(1, math.ceil(t * self.topk / self.experts * self.factor))
        return -(-cap // 16) * 16

    def _ranks(self, experts: torch.Tensor) -> torch.Tensor:
        """(..., T, k) -> each pair's rank within its expert among the
        ``T k`` pairs of its call, in token-major order."""
        t, k = experts.shape[-2:]
        flat = experts.reshape(-1, t * k).long()
        key = (flat + self.experts * torch.arange(
            flat.shape[0], device=flat.device)[:, None]).reshape(-1)
        order = torch.argsort(key, stable=True)
        sorted_k = key[order]
        first = torch.searchsorted(sorted_k, sorted_k, right=False)
        rank = torch.empty_like(key)
        rank[order] = torch.arange(key.numel(), device=key.device) - first
        return rank.view(experts.shape)

    def _kept(self, experts: torch.Tensor, n_prompt: int) -> torch.Tensor:
        """(S, k) bool: pairs the capacity rule keeps."""
        keep = torch.ones_like(experts, dtype=torch.bool)
        for c0 in range(0, n_prompt, self.chunk):
            t = min(self.chunk, n_prompt - c0)
            keep[c0:c0 + t] = self._ranks(experts[c0:c0 + t]) < self._cap(t)
        return keep

    def decode_drop_mismatches(self, steps: torch.Tensor,
                               block: int = 64) -> int:
        """Pairs of whole decode steps ``steps`` (steps, lanes, n_moe, k)
        of recorded ids whose recorded drop disagrees with the capacity
        rule recounted over the step's lanes, MoE layer by MoE layer."""
        bad = 0
        for s0 in range(0, steps.shape[0], block):
            codes = steps[s0:s0 + block].long().transpose(1, 2)
            dropped = codes < 0
            e = torch.where(dropped, -1 - codes, codes)
            keep = self._ranks(e) < self._cap(codes.shape[2])
            bad += int((dropped == keep).sum())
        return bad

    def _route(self, h: torch.Tensor, lp: Dict):
        probs = torch.softmax(h @ lp["moe"]["router"].float(), -1)
        w, e = torch.topk(probs, self.topk, dim=-1)
        return w / w.sum(-1, keepdim=True).clamp(min=1e-9), e

    def _own_routing(self, h: torch.Tensor, lp: Dict, n_prompts,
                     lens) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weights, experts) by the reference's own router, the pairs
        past capacity in a prompt chunk weighted 0."""
        w, e = self._route(h, lp)
        keep = torch.ones_like(e, dtype=torch.bool)
        if self.factor:
            keep = torch.cat([self._kept(e_i, n) for e_i, n in
                              zip(e.split(lens), n_prompts)])
            w = torch.where(keep, w, 0.0)
        if self.recorded is not None:
            code = torch.where(keep, e, -1 - e).to(torch.int16)
            for r, c in zip(self.recorded, code.split(lens)):
                r.append(c)
        return w, e

    def _forced_routing(self, h: torch.Tensor, lp: Dict, n_prompts, lens,
                        codes: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weights, experts) of the recorded sets ``codes`` (N, k), and
        the record checked against the reference's scores and rule."""
        e, dropped = (torch.where(codes < 0, -1 - codes, codes),
                      codes < 0)
        logits = h @ lp["moe"]["router"].float()
        w = torch.softmax(logits, -1).gather(1, e)
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
        w = torch.where(dropped, 0.0, w)
        own = torch.topk(logits, self.topk, dim=-1)
        slack = (own.values[:, -1] - logits.gather(1, e).min(-1).values
                 ).clamp(min=0.0)
        flip = (own.indices.sort(-1).values != e.sort(-1).values).any(-1)
        st = self.routing
        for i, (s_i, e_i, d_i, n) in enumerate(zip(
                slack.split(lens), e.split(lens), dropped.split(lens),
                n_prompts)):
            keep = (self._kept(e_i, n) if self.factor
                    else torch.ones_like(d_i))
            st["slack"][i] = max(st["slack"][i], float(s_i.max()))
            st["mismatch"][i] += int((d_i[:n] == keep[:n]).sum())
            st["decode_dropped"][i] += int(d_i[n:].sum())
            st["decode_pairs"][i] += d_i[n:].numel()
        st["flips"] += int(flip.sum())
        st["rows"] += flip.numel()
        return w, e

    def _moe(self, h: torch.Tensor, lp: Dict, w: torch.Tensor,
             e: torch.Tensor) -> torch.Tensor:
        m = lp["moe"]
        out = torch.zeros_like(h)
        for ex in torch.unique(e).tolist():
            tok, slot = (e == ex).nonzero(as_tuple=True)
            x = h[tok]
            y = self._lin(torch.nn.functional.silu(
                self._lin(x, m["w_gate"][ex])) * self._lin(x, m["w_up"][ex]),
                m["w_down"][ex])
            out.index_add_(0, tok, y * w[tok, slot][:, None])
        return out

    # -- forward --------------------------------------------------------------
    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor], n_prompts: Sequence[int],
               routes: Optional[Sequence[torch.Tensor]] = None,
               record: bool = False) -> List[torch.Tensor]:
        """For each token sequence (a prompt, then served tokens), the
        float32 logits at positions ``n_prompt - 1`` onward: row ``i``
        scores the token at position ``n_prompt + i``.  ``routes``, one
        record a sequence, makes an MoE follow the program's routing and
        fills ``self.routing``; ``record`` keeps an MoE's own routing in
        ``self.recorded``."""
        self.recorded = [] if record else None
        if record:
            if routes is not None or not self.experts:
                raise ValueError("only an MoE's own routing is recorded")
            self.recorded = [[] for _ in seqs]
        if routes is not None:
            if not self.experts:
                raise ValueError("routes are an MoE's")
            for r, t in zip(routes, seqs):
                if tuple(r.shape) != (t.numel(), len(self.moe), self.topk):
                    raise ValueError(f"a record of shape {tuple(r.shape)} "
                                     f"for {t.numel()} positions")
        n = len(seqs)
        self.routing = {"slack": [0.0] * n, "mismatch": [0] * n,
                        "decode_dropped": [0] * n, "decode_pairs": [0] * n,
                        "flips": 0, "rows": 0}
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            out = self._logits(seqs, n_prompts, routes)
            if record:
                self.recorded = [torch.stack(r, 1) for r in self.recorded]
            return out
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32

    def _logits(self, seqs, n_prompts, routes):
        p = self.p
        table = p["embed"]["table"]
        xs = [table[t.long()].float() for t in seqs]
        pos = [torch.arange(t.numel(), device=t.device) for t in seqs]
        for li in range(self.layers):
            lp = {k: ({n: v[li] for n, v in sub.items()}
                      if isinstance(sub, dict) else sub[li])
                  for k, sub in p["blocks"].items()}
            a = lp["attn"]
            for i, x in enumerate(xs):
                h = self._norm(x, lp["ln1"]["scale"])
                s = x.shape[0]
                q = self._lin(h, a["wq"]).view(s, self.hq, self.dh)
                k = self._lin(h, a["wk"]).view(s, self.hkv, self.dh)
                v = self._lin(h, a["wv"]).view(s, self.hkv, self.dh)
                q, k = self._rope(q, pos[i]), self._rope(k, pos[i])
                xs[i] = x + self._lin(self._attention(q, k, v), a["wo"])
            # the FFN / MoE of every sequence's positions at once
            h = torch.cat([self._norm(x, lp["ln2"]["scale"]) for x in xs])
            lens = [x.shape[0] for x in xs]
            j = self.moe.get(li)
            if j is None:
                y = self._ffn(h, lp)
            elif routes is not None:
                codes = torch.cat([r[:, j] for r in routes]).long()
                y = self._moe(h, lp, *self._forced_routing(
                    h, lp, n_prompts, lens, codes))
            else:
                y = self._moe(h, lp, *self._own_routing(h, lp, n_prompts,
                                                        lens))
            xs = [x + y_i for x, y_i in zip(xs, y.split(lens))]
        head = p["embed"].get("head")
        if head is None:
            head = p["embed"]["table"].T
        out = []
        for x, n in zip(xs, n_prompts):
            h = self._norm(x[n - 1:], p["ln_f"]["scale"])
            out.append(self._lin(h, head)[:, :self.vocab])
        return out
