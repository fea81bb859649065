"""Record the experts the program's MoE layer chose, on the timed path.

An MoE's served tokens are held to the reference under the program's
own routing (``reference/transformer.py``, ``routes=``): the reference
takes, in every layer and at every position, the set of experts the
program chose and the pairs its capacity rule dropped, checks that set
against its own float32 router scores, and computes the layer with it.
Without that, bf16 rounding flips one expert of the eight at nearly
every served position somewhere in 48 layers, and the flips, not the
precision of the products, make the gap.

:class:`Tap` wraps, for the length of one run, the functions of the
program through which routing passes, and leaves their results as they
were:

* ``layers._route``: the (tokens, k) expert ids of each MoE call;
* ``layers.moe_capacity`` and ``layers._local_ranks``: the capacity
  ``C`` the call used and each pair's rank within its expert; a pair at
  rank ``>= C`` is one the call dropped;
* ``transformer.decode_step_paged``: which (slot, position) each decode
  lane is, from the lane's length and block table, on the device;
* the engine's ``_extend`` (one prefill chunk): the slot and the
  chunk's first position, from the engine's prefill state;
* the engine's ``_finish``: at retirement the slot's rows ``[0, len)``
  are copied, on the device, into the request's record.

Each call of the MoE layer writes its ids into one device buffer of
rows ``(slot, position)`` by ``(j, k)``, as ``e`` for a kept pair
and ``-1 - e`` for a dropped one, and each row the decode step that
wrote it (``-1`` for a prompt chunk's row).  A decode step's pairs are
ranked over all of the step's lanes, most of which a sample of requests
does not hold, so every decode step also writes all its lanes' ids into
a ring of the last ``RING`` steps (:meth:`Tap.decode_steps`): the
capacity rule is recounted over whole steps there, and a sampled row
whose step is still in the ring is held to that step's lane.

The layer axis of the buffer, the ring and every record counts MoE
layers, not layers: ``j`` is the j-th MoE call of a model call, the
j-th of the layers the configuration's reference names
(``moe_layers(cfg)``, ``(i_0 < i_1 < ...)``), and the reference reads
``routes[:, j]`` at layer ``i_j``.  A layer whose FFN is dense calls
none of the wrapped MoE functions and writes nothing; a model call that
records another number of MoE calls than ``n_moe`` is a fault.  Where
every layer routes, ``j`` is the layer.

Row indices, the step counter and the ring's index are device tensors, so
the writes are captured into the fused-decode graphs and stay right on
every replay; a lane outside the decode batch (its table routed to the
scratch page) writes the one scratch row.  A lane frozen inside a
horizon rewrites the row of its next position; the step that computes
that position for real comes later and writes it last.  Nothing is
read back to the host on the timed path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

#: dtype of a record's ids (``-1 - e`` for a dropped pair)
ID_DTYPE = torch.int16
#: decode steps the ring keeps, the last ones before the check
RING = 1024


@dataclass
class _Call:
    rows: torch.Tensor              # (tokens,) rows of the buffer
    ring: Optional[torch.Tensor] = None   # (1,) ring index of a decode step
    layer: int = 0                  # MoE calls so far: the next ``j``
    experts: Optional[torch.Tensor] = None
    cap: Optional[int] = None


class Tap:
    """The routing record of one engine (see the module's doc)."""

    def __init__(self, eng, n_moe: int, topk: int):
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        self.n_moe = n_moe
        ecfg = eng.ecfg
        self.rows_per_slot = int(ecfg.max_seq) + 1
        n = int(ecfg.max_batch) * self.rows_per_slot
        dev = eng.device
        self.scratch_row = n
        self.buf = torch.zeros((n + 1, n_moe, topk), dtype=ID_DTYPE,
                               device=dev)
        self.slot_base = (torch.arange(int(ecfg.max_batch), device=dev)
                          * self.rows_per_slot)
        #: the decode step that wrote each row (-1: a prompt chunk)
        self.row_step = torch.full((n + 1,), -1, dtype=torch.int64,
                                   device=dev)
        #: decode steps so far; the ring of the last ``RING`` steps' lanes
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.ring = torch.zeros((RING, int(ecfg.max_batch), n_moe, topk),
                                dtype=ID_DTYPE, device=dev)
        self.ring_step = torch.full((RING,), -1, dtype=torch.int64,
                                    device=dev)
        #: rid -> (len, n_moe, k) ids of a retired request
        self.routes: Dict[int, torch.Tensor] = {}
        #: rid -> (len,) the decode step of each row; rid -> its slot
        self.steps: Dict[int, torch.Tensor] = {}
        self.slots: Dict[int, int] = {}
        #: what went wrong in recording (None while sound)
        self.fault: Optional[str] = None
        self._call: Optional[_Call] = None
        self._saved = []
        self._eng = eng
        self._patch(L, "_route", self._route)
        self._patch(L, "moe_capacity", self._capacity)
        self._patch(L, "_local_ranks", self._ranks)
        self._patch(T, "decode_step_paged", self._decode)
        self._patch(eng, "_extend", self._extend)
        self._patch(eng, "_finish", self._finish)

    # -- installing -----------------------------------------------------
    def _patch(self, owner, name: str, make):
        orig = getattr(owner, name)
        # an engine's method is wrapped on the instance, and the instance
        # may already hold the attribute (``_extend``) or not (``_finish``)
        own = name in vars(owner)
        self._saved.append((owner, name, orig, own))
        setattr(owner, name, make(orig))

    def remove(self) -> None:
        """Put back every function the tap wrapped."""
        for owner, name, orig, own in reversed(self._saved):
            if own:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
        self._saved = []
        self._eng = None

    def decode_steps(self):
        """(steps, lanes, n_moe, k) ids of every decode step still in
        the ring, in the order of the steps, on the device."""
        held = (self.ring_step >= 0).nonzero()[:, 0]
        order = held[self.ring_step[held].argsort()]
        return self.ring[order], self.ring_step[order]

    # -- one model call -------------------------------------------------
    def _enter(self, rows: torch.Tensor, ring=None):
        if self._call is not None:
            self.fault = "a model call inside another"
        self._call = _Call(rows, ring)

    def _leave(self) -> None:
        call, self._call = self._call, None
        if call is not None and call.layer != self.n_moe:
            self.fault = (f"{call.layer} MoE layers recorded in a call of "
                          f"{self.n_moe}")

    def _decode(self, orig):
        def decode_step_paged(params, cfg, tokens, k_pool, v_pool, tables,
                              lengths, *a, **kw):
            b = tokens.shape[0]
            rows = self.slot_base[:b] + lengths.long().clamp(
                0, self.rows_per_slot - 1)
            # a lane outside the batch reads and writes the scratch page
            idle = tables[:, 0] == k_pool.shape[1] - 1
            rows = torch.where(idle, self.scratch_row, rows)
            self.step.add_(1)
            at = (self.step % RING).view(1)
            self.ring_step.index_copy_(0, at, self.step.view(1))
            self.row_step.index_put_((rows,), self.step)
            self._enter(rows, at)
            try:
                out = orig(params, cfg, tokens, k_pool, v_pool, tables,
                           lengths, *a, **kw)
            finally:
                self._leave()
            # the step's lanes, written MoE layer by MoE layer into the ring
            self.buf[rows] = self.ring[at][0]
            return out
        return decode_step_paged

    def _extend(self, orig):
        def extend(params, tokens, cache):
            st = self._eng._prefilling
            base = st["slot"] * self.rows_per_slot + st["pos"]
            rows = base + torch.arange(tokens.shape[1], device=tokens.device)
            self.row_step[rows] = -1
            self._enter(rows)
            try:
                return orig(params, tokens, cache)
            finally:
                self._leave()
        return extend

    def _finish(self, orig):
        def finish(slot, req, now, hit_eos):
            orig(slot, req, now, hit_eos)
            n = len(req.prompt) + len(req.tokens_out) - 1
            at = slot * self.rows_per_slot
            self.routes[req.rid] = self.buf[at:at + n].clone()
            self.steps[req.rid] = self.row_step[at:at + n].clone()
            self.slots[req.rid] = slot
        return finish

    # -- inside the MoE layer -------------------------------------------
    def _route(self, orig):
        def route(p, x, cfg):
            weights, experts = orig(p, x, cfg)
            if self._call is not None:
                self._call.experts = experts
            return weights, experts
        return route

    def _capacity(self, orig):
        def moe_capacity(*a, **kw):
            c = orig(*a, **kw)
            if self._call is not None:
                self._call.cap = c
            return c
        return moe_capacity

    def _ranks(self, orig):
        def local_ranks(flat_e, n, e):
            rank = orig(flat_e, n, e)
            call = self._call
            if call is None:
                return rank
            ex = call.experts
            if ex is None or call.cap is None or ex.numel() != rank.numel():
                self.fault = "an MoE call whose ranks do not follow its route"
                return rank
            dropped = rank.view(ex.shape) >= call.cap
            code = torch.where(dropped, -1 - ex, ex).to(ID_DTYPE)
            if call.ring is None:
                self.buf[call.rows, call.layer] = code
            else:
                self.ring[call.ring, :, call.layer] = code
            call.layer += 1
            call.experts = call.cap = None
            return rank
        return local_ranks
