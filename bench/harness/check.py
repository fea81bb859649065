"""Decide ``correct``: hold served greedy tokens to the plain reference.

Once the window has closed, a sample of the requests that finished in
it, drawn from the seed with the longest of them always in it, is run
through the reference (``reference/<name>.py``) once: each prompt with
its served tokens.  At every served position the reference's float32
logits give the gap by which the served token's logit lies below the
reference's best.  Four numbers are read: the widest gap over the sample
(``max_logit_gap``), the mean and the 99th percentile over its served
positions (``mean_logit_gap``, ``p99_logit_gap``), and the share of
served tokens that are not the reference's best (``disagree_share``); a
cell compares those its limits file (``limits/<workload>.json``) gives
a limit.

The control reads, at the same positions, the gap of the token that a
lower precision (``precision="fp8"``) puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

TARGET_TOKENS = 1024
MAX_REQUESTS = 8
NUMBERS = ("max_logit_gap", "mean_logit_gap", "p99_logit_gap",
           "disagree_share")


def sample(done: Sequence, seed: int) -> List:
    """The longest finished request, then others in an order drawn from
    the seed, until ``TARGET_TOKENS`` served tokens or ``MAX_REQUESTS``."""
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens_out), -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 7])
    order = rng.permutation(len(rest)) if rest else []
    out, n = [longest], len(longest.tokens_out)
    for i in order:
        if n >= TARGET_TOKENS or len(out) >= MAX_REQUESTS:
            break
        out.append(rest[i])
        n += len(rest[i].tokens_out)
    return out


def sequences(reqs: Sequence, device) -> Tuple[List[torch.Tensor], List[int],
                                               List[torch.Tensor]]:
    """(prompt + served tokens but the last, prompt length, served)."""
    seqs, n_prompt, served = [], [], []
    for r in reqs:
        out = np.asarray(r.tokens_out, np.int64)
        toks = np.concatenate([np.asarray(r.prompt, np.int64), out[:-1]])
        seqs.append(torch.as_tensor(toks, device=device))
        n_prompt.append(len(r.prompt))
        served.append(torch.as_tensor(out, device=device))
    return seqs, n_prompt, served


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: reference best minus the reference's logit of
    ``tokens``."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, tokens[:, None].long())[:, 0]


def numbers(g: torch.Tensor, best: torch.Tensor,
            tokens: torch.Tensor) -> Dict[str, float]:
    """The numbers read from the gaps ``g`` of ``tokens`` at positions
    whose reference best is ``best``."""
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "p99_logit_gap": float(torch.quantile(g, 0.99)),
            "disagree_share": float((best != tokens).float().mean())}


def served_gap(ref, reqs: Sequence, device) -> Dict[str, float]:
    seqs, n_prompt, served = sequences(reqs, device)
    rows = ref.logits(seqs, n_prompt)
    g = [gaps(r, s) for r, s in zip(rows, served)]
    out = numbers(torch.cat(g), torch.cat([r.argmax(-1) for r in rows]),
                  torch.cat(served))
    out.update(per_request=[float(x.max()) for x in g],
               tokens=int(sum(x.numel() for x in g)))
    return out


def control_gap(ref, ctl, reqs: Sequence, device) -> Dict[str, float]:
    """The gap of the token the control puts first, at every served
    position of the same prompts and tokens."""
    seqs, n_prompt, _ = sequences(reqs, device)
    rows = ref.logits(seqs, n_prompt)
    picks = [c.argmax(-1) for c in ctl.logits(seqs, n_prompt)]
    g = torch.cat([gaps(r, c) for r, c in zip(rows, picks)])
    return numbers(g, torch.cat([r.argmax(-1) for r in rows]),
                   torch.cat(picks))
