"""FSDP: parameters sharded over the data axes too
(``sharding.fsdp_pspecs``), gathered one layer at a time where the model
uses the layer.

The rule shards each leaf's first still-replicated divisible dim, so a
stacked block leaf ``(L, ...)`` is cut along its layer axis when L
divides over the data axes (each rank then holds L/n whole layers, and
layer ``li`` is broadcast by the rank holding it) and along an inner
dim otherwise (each rank holds a slice of every layer, gathered along
that dim).  The gatherer reads which from the spec.  In backward a
layer's gradient is summed over the data ranks onto the shard it came
from (``collectives.broadcast`` / ``gather_shards``), so a sharded
leaf's gradient comes out summed over the data axes already.

The model code asks for layer ``li`` inside the block that ``layers.remat``
recomputes, so the recomputation gathers it again and nothing gathered
is saved for backward; serving gathers it inside the layer loop.  The
leaves outside the blocks (embeddings, final norm) are gathered whole
once per step.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import data_axes


class LayerGather:
    """The FSDP gathers of one step on a bound ``mesh`` for a model of
    ``n_layers`` layers whose parameters are held by ``specs`` (the
    parameter spec tree).  ``layer_gathers`` counts the layers gathered
    (each forward, and each recomputation, of a layer is one)."""

    def __init__(self, mesh, specs: Any, n_layers: int):
        self.mesh = mesh
        self.specs = specs
        self.n_layers = n_layers
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

    def gather_top(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """``params`` with every leaf outside ``blocks`` gathered whole."""
        def whole(t, spec):
            d, axes = self._cut(spec)
            return t if d is None else C.gather_shards(t, self.mesh, axes, d)
        return {k: v if k == "blocks" else sh.tree_map(whole, v,
                                                       self.specs[k])
                for k, v in params.items()}

    def pieces(self, blocks: Dict[str, Any]) -> List[Any]:
        """Per layer, this rank's pieces of the stacked ``blocks`` (each
        leaf unbound once): the held layer's slot where the layer axis is
        cut (every rank passes one, so every rank takes part in the
        gather's backward), else the layer's slice."""
        def unbind(t, spec):
            parts = t.unbind(0)
            d, _ = self._cut(spec)
            per = t.shape[0]
            return [parts[li % per] if d == 0 else parts[li]
                    for li in range(self.n_layers)]
        per_leaf = sh.tree_map(unbind, blocks, self.specs["blocks"])
        return [sh.tree_map(lambda ps: ps[li], per_leaf)
                for li in range(self.n_layers)]

    def local(self, blocks: Dict[str, Any], li: int) -> Any:
        """Layer ``li``'s pieces of ``blocks`` on this rank (views)."""
        def take(t, spec):
            d, _ = self._cut(spec)
            return t[li % t.shape[0]] if d == 0 else t[li]
        return sh.tree_map(take, blocks, self.specs["blocks"])

    def layer(self, pieces: Any, li: int) -> Any:
        """Layer ``li``'s full (over the data axes) parameters from this
        rank's ``pieces`` of it."""
        self.layer_gathers += 1

        def full(t, spec):
            d, axes = self._cut(spec)
            if d is None:
                return t
            if d == 0:
                per = self.n_layers // self.mesh.axis_size(axes)
                return C.broadcast(t, self.mesh, axes, li // per)
            return C.gather_shards(t, self.mesh, axes, d - 1)
        return sh.tree_map(full, pieces, self.specs["blocks"])


def _data_dim(spec, daxes) -> Optional[int]:
    for d, e in enumerate(spec):
        if any(a in daxes for a in sh._names(e)):
            return d
    return None
