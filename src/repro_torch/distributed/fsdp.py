"""FSDP: parameters sharded over the data axes too
(``sharding.fsdp_pspecs``), gathered one layer at a time where the model
uses the layer.

A model's layers are stacked in subtrees with leading layer dims (each
family's ``layer_stacks``: ``blocks`` ``(L,)``; RecurrentGemma's
``rec_groups`` ``(G, 2)``, ``attn_groups`` ``(G,)`` and ``rec_tail``;
the encoder-decoder's ``enc`` and ``dec``).  The rule shards each leaf's
first still-replicated divisible dim, so a stacked leaf is cut along one
of its layer dims when that dim divides over the data axes (each rank
then holds a slice of the layers whole, and a layer is broadcast by the
rank holding it) and along an inner dim otherwise (each rank holds a
slice of every layer, gathered along that dim).  The gatherer reads
which from the spec.  In backward a layer's gradient is summed over the
data ranks onto the shard it came from (``collectives.broadcast`` /
``gather_shards``), so a sharded leaf's gradient comes out summed over
the data axes already.

The model code asks for a layer inside the block that ``layers.remat``
recomputes, so the recomputation gathers it again and nothing gathered
is saved for backward; serving gathers it inside the layer loop.  The
leaves outside the stacks (embeddings, final norms, a position table)
are gathered whole once per step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import data_axes


class LayerGather:
    """The FSDP gathers of one step on a bound ``mesh`` for a model whose
    parameters are held by ``specs`` (the parameter spec tree) and whose
    layers are stacked in the subtrees ``stacks`` names, each with its
    leading layer dims (``{"blocks": (L,)}`` for the transformer and
    rwkv6; RecurrentGemma's ``rec_groups`` lead with ``(G, 2)``).  A
    layer is its stack's name and its flat index over those dims, in
    row-major order.  ``layer_gathers`` counts the layers gathered (each
    forward, and each recomputation, of a layer is one)."""

    def __init__(self, mesh, specs: Any, stacks: Dict[str, Tuple[int, ...]]):
        self.mesh = mesh
        self.specs = specs
        self.stacks = {k: tuple(v) for k, v in stacks.items() if k in specs}
        self.layer_gathers = 0

    @staticmethod
    def needed(mesh, specs: Any) -> bool:
        """Whether any leaf of ``specs`` is cut over data axes of more than
        one rank (else there is nothing to gather)."""
        if mesh is None or not mesh.bound:
            return False
        daxes = data_axes(mesh)
        for _, spec in sh.tree_leaves_with_path(specs):
            d = _data_dim(spec, daxes)
            if d is not None and mesh.axis_size(sh._names(spec[d])) > 1:
                return True
        return False

    def _cut(self, spec) -> Tuple[Optional[int], Tuple[str, ...]]:
        d = _data_dim(spec, data_axes(self.mesh))
        return d, (sh._names(spec[d]) if d is not None else ())

    def _held(self, spec, stack: str, li: int):
        """Where this rank holds layer ``li`` of a leaf cut by ``spec``:
        (its index into the leaf's local lead dims, the coordinate of the
        rank that owns the layer where a lead dim is cut, else None)."""
        lead = self.stacks[stack]
        idx = tuple(int(i) for i in np.unravel_index(li, lead))
        d, axes = self._cut(spec)
        if d is None or d >= len(lead):
            return idx, None
        per = lead[d] // self.mesh.axis_size(axes)
        return idx[:d] + (idx[d] % per,) + idx[d + 1:], idx[d] // per

    def gather_top(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """``params`` with every leaf outside the layer stacks gathered
        whole."""
        def whole(t, spec):
            d, axes = self._cut(spec)
            return t if d is None else C.gather_shards(t, self.mesh, axes, d)
        return {k: v if k in self.stacks else sh.tree_map(whole, v,
                                                          self.specs[k])
                for k, v in params.items()}

    def pieces(self, tree: Dict[str, Any], stack: str = "blocks"
               ) -> List[Any]:
        """Per layer, this rank's pieces of the stack ``tree`` (each leaf
        unbound once): the held layer's slot where a layer dim is cut
        (every rank passes one, so every rank takes part in the gather's
        backward), else the layer's slice."""
        lead = self.stacks[stack]
        n = math.prod(lead)

        def unbind(t, spec):
            local = t.shape[:len(lead)]
            parts = t.reshape(-1, *t.shape[len(lead):]).unbind(0) \
                if n else ()
            return [parts[int(np.ravel_multi_index(
                self._held(spec, stack, li)[0], local))] for li in range(n)]
        per_leaf = sh.tree_map(unbind, tree, self.specs[stack])
        return [sh.tree_map(lambda ps: ps[li], per_leaf) for li in range(n)]

    def local(self, tree: Dict[str, Any], li: int,
              stack: str = "blocks") -> Any:
        """Layer ``li``'s pieces of the stack ``tree`` on this rank
        (views)."""
        return sh.tree_map(lambda t, spec: t[self._held(spec, stack, li)[0]],
                           tree, self.specs[stack])

    def layer(self, pieces: Any, li: int, stack: str = "blocks") -> Any:
        """Layer ``li``'s full (over the data axes) parameters from this
        rank's ``pieces`` of it."""
        self.layer_gathers += 1
        nlead = len(self.stacks[stack])

        def full(t, spec):
            d, axes = self._cut(spec)
            if d is None:
                return t
            owner = self._held(spec, stack, li)[1]
            if owner is not None:
                return C.broadcast(t, self.mesh, axes, owner)
            return C.gather_shards(t, self.mesh, axes, d - nlead)
        return sh.tree_map(full, pieces, self.specs[stack])


def _data_dim(spec, daxes) -> Optional[int]:
    for d, e in enumerate(spec):
        if any(a in daxes for a in sh._names(e)):
            return d
    return None
