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

An MoE's run hands the reference the program's own routing of each
sampled request (``harness/routes.py``): the reference follows it, and
checks it (``ROUTE_NUMBERS``): the most by which a chosen expert's
router logit lies below the reference's own k-th best
(``route_slack_max``), the prompt pairs whose recorded drop disagrees
with the capacity rule (``prefill_drop_mismatches``), the share of
decode pairs recorded dropped (``dropped_share_decode``, printed) and
the share of (position, layer) whose set is not the reference's own
(``route_flip_share``, printed, never limited: rounding flips sets).
The run's last decode steps, every lane of each, are held to the
capacity rule as well (``decode_drop_mismatches``, :func:`decode_record`).

The control reads, at the same positions and under the same routing,
the gap of the token that a lower precision (``precision="fp8"``) puts
first; an MoE's control also routes by itself once, and that routing,
handed to the reference in the program's place, gives the control's
route numbers (``control_routing``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

TARGET_TOKENS = 1024
MAX_REQUESTS = 8
NUMBERS = ("max_logit_gap", "mean_logit_gap", "p99_logit_gap",
           "disagree_share")
ROUTE_NUMBERS = ("route_slack_max", "prefill_drop_mismatches",
                 "decode_drop_mismatches", "dropped_share_decode",
                 "route_flip_share")
#: numbers whose limit may be 0: counts that a sound run reads as 0
EXACT = ("prefill_drop_mismatches", "decode_drop_mismatches")


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


def route_numbers(routing: Dict) -> Dict:
    """The route numbers of a reference's ``routing`` record, each also
    per request (``per_request``)."""
    per = {"route_slack_max": list(routing["slack"]),
           "prefill_drop_mismatches": list(routing["mismatch"]),
           "dropped_share_decode": [d / max(1, n) for d, n in zip(
               routing["decode_dropped"], routing["decode_pairs"])]}
    out = {"route_slack_max": max(per["route_slack_max"]),
           "prefill_drop_mismatches": sum(per["prefill_drop_mismatches"]),
           "dropped_share_decode": (sum(routing["decode_dropped"])
                                    / max(1, sum(routing["decode_pairs"]))),
           "route_flip_share": routing["flips"] / max(1, routing["rows"])}
    out["per_request"] = per
    return out


def decode_record(ref, ring: torch.Tensor, ring_steps: torch.Tensor,
                  routes: Sequence[torch.Tensor],
                  steps: Sequence[torch.Tensor],
                  slots: Sequence[int]) -> Tuple[Dict, Optional[str]]:
    """The decode steps of the tap's ring (``ring`` (steps, lanes, n_moe,
    k), ``ring_steps`` their ascending step numbers) held to the capacity
    rule, and the sampled records (``routes``, each row's decode step
    ``steps``, the request's slot ``slots``) held to the ring: (numbers,
    a recording fault or None).  The layer axis counts MoE layers: its
    ``j`` is the j-th layer of ``ref``'s ``moe_layers``, as in the
    record (``harness/routes.py``)."""
    if not ring.shape[0]:
        return {}, "no decode step recorded"
    out = {"decode_drop_mismatches": ref.decode_drop_mismatches(ring),
           "decode_steps_recounted": int(ring.shape[0])}
    linked = off = 0
    for rec, st, slot in zip(routes, steps, slots):
        at = torch.searchsorted(ring_steps, st).clamp(
            max=ring_steps.numel() - 1)
        held = (st >= 0) & (ring_steps[at] == st)
        lane = ring[at[held], slot]
        linked += int(held.sum())
        off += int((rec[held] != lane).flatten(1).any(-1).sum())
    out["decode_rows_in_ring"] = linked
    fault = (f"{off} sampled decode rows differ from their step's lane"
             if off else None)
    return out, fault


def served_gap(ref, reqs: Sequence, device,
               routes: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[Dict, List[torch.Tensor]]:
    """The numbers of the served tokens of ``reqs`` against the
    reference (following ``routes`` where given), and the reference's
    logits, one tensor a request."""
    seqs, n_prompt, served = sequences(reqs, device)
    rows = ref.logits(seqs, n_prompt, routes)
    g = [gaps(r, s) for r, s in zip(rows, served)]
    out = numbers(torch.cat(g), torch.cat([r.argmax(-1) for r in rows]),
                  torch.cat(served))
    per = {"max_logit_gap": [float(x.max()) for x in g]}
    if routes is not None:
        got = route_numbers(ref.routing)
        per.update(got.pop("per_request"))
        out.update(got)
    out.update(per_request=per, tokens=int(sum(x.numel() for x in g)))
    return out, rows


def control_gap(ctl, reqs: Sequence, device, rows: List[torch.Tensor],
                routes: Optional[Sequence[torch.Tensor]] = None
                ) -> Dict[str, float]:
    """The gap of the token the control puts first, at every served
    position of the same prompts and tokens, against the reference's
    logits ``rows`` (under the same ``routes``)."""
    seqs, n_prompt, _ = sequences(reqs, device)
    picks = [c.argmax(-1) for c in ctl.logits(seqs, n_prompt, routes)]
    g = torch.cat([gaps(r, c) for r, c in zip(rows, picks)])
    return numbers(g, torch.cat([r.argmax(-1) for r in rows]),
                   torch.cat(picks))


def control_routing(ref, ctl, reqs: Sequence, device) -> Dict:
    """The route numbers of the control's own routing, held to the
    reference as the program's is: the control routes each sequence by
    itself, and the float32 reference follows and checks that record."""
    seqs, n_prompt, _ = sequences(reqs, device)
    ctl.logits(seqs, n_prompt, record=True)
    ref.logits(seqs, n_prompt, ctl.recorded)
    out = route_numbers(ref.routing)
    out.pop("per_request")
    return out
