"""Sharding rules: parameter, ZeRO-1 / FSDP, batch and cache specs (port
of ``repro.distributed.sharding``), and the functions that cut a full
tensor to this rank's shard and gather it back.

A spec is a tuple with one entry per dimension, each ``None``
(replicated), an axis name, or a tuple of axis names: the entries of
the reference's ``PartitionSpec``, one for one.  The rules are the
reference's, pattern-based on the leaf's path, with divisibility checked
against the mesh: any non-divisible dim degrades to replication rather
than failing.  They read only ``mesh.shape`` / ``mesh.axis_names``, so
a mesh description (``launch.mesh.make_mesh``) is enough; cutting and
gathering need a bound mesh.

Sequence-sharded decode caches implement the paper's IS-S on the
attention context dimension: KV caches shard S over "model", batch over
("pod", "data").  In place of the reference's ``to_named``,
:func:`shard_tree` / :func:`gather_tree` move a tree between its full
form and this rank's shards.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import data_axes

Spec = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# trees: nested dicts and NamedTuples of tensors (a spec tuple is a leaf)
# ---------------------------------------------------------------------------
def _is_container(x) -> bool:
    return isinstance(x, dict) or (isinstance(x, tuple)
                                   and hasattr(x, "_fields"))


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over ``tree``; ``rest`` trees
    share its structure (their leaves may be spec tuples)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (str(k),))
                for k, v in tree.items()}
    if _is_container(tree):
        return type(tree)(*(tree_map_with_path(
            fn, v, *(getattr(r, f) for r in rest), path=path + (f,))
            for f, v in zip(tree._fields, tree)))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def tree_leaves_with_path(tree: Any) -> list:
    out = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _names(e) -> Tuple[str, ...]:
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def _div(shape, dim, mesh, axis) -> bool:
    return shape[dim] % int(np.prod([mesh.shape[a] for a in
                                     (axis if isinstance(axis, tuple)
                                      else (axis,))])) == 0


def _spec(shape, mesh, *dims) -> Spec:
    """A spec, dropping non-divisible entries to None."""
    return tuple(None if ax is None or not _div(shape, d, mesh, ax) else ax
                 for d, ax in enumerate(dims))


def _rep(nd: int) -> Spec:
    return (None,) * nd


def _dp(mesh):
    daxes = data_axes(mesh)
    return daxes if len(daxes) > 1 else (daxes[0] if daxes else None)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------
def param_pspecs(params: Any, mesh) -> Any:
    """Spec tree matching ``params`` (works on meta tensors)."""

    def rule(names, leaf) -> Spec:
        last = names[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        pre = (None,) * (nd - 2)  # stacked layer/group leading dims

        def tail2(a, b):
            return _spec(shape, mesh, *pre, a, b)

        # ---- embeddings -----------------------------------------------------
        if last == "table":
            # d-sharded (not vocab-sharded): the token-id gather stays local
            return _spec(shape, mesh, None, "model")
        if last == "head":
            return _spec(shape, mesh, None, "model")
        if last == "pos_dec":
            return _rep(nd)
        # ---- attention -------------------------------------------------------
        if last in ("wq", "wk", "wv"):
            return tail2(None, "model")       # column-parallel (OS-S)
        if last == "wo":
            return tail2("model", None)       # row-parallel (IS-S)
        if last in ("bq", "bk", "bv"):
            return _spec(shape, mesh, *((None,) * (nd - 1)), "model")
        # ---- MoE -------------------------------------------------------------
        if "moe" in names:
            if last == "router":
                return _rep(nd)
            if last in ("w_up", "w_gate", "w_down") and "shared" not in names:
                # (L, E, d, f): expert-parallel over model
                return _spec(shape, mesh, *([None] * (nd - 3)), "model",
                             None, None)
        # ---- FFN / channel-mix ------------------------------------------------
        if last in ("w_up", "w_gate", "w_in_x", "w_in_gate"):
            return tail2(None, "model")
        if last == "w_down":
            return tail2("model", None)
        if last == "w_out":
            return tail2("model", None)
        # ---- rwkv6 time/channel mix -------------------------------------------
        if "cm" in names and last == "wk":
            return tail2(None, "model")
        if "cm" in names and last == "wv":
            return tail2("model", None)
        if last in ("wr", "wg"):
            return tail2(None, "model") if "cm" not in names else _rep(nd)
        if last == "u_bonus":
            return _spec(shape, mesh, *pre, "model", None)
        # ---- rglru ----------------------------------------------------------
        if last in ("conv_w",):
            return _spec(shape, mesh, *pre, None, "model")
        if last in ("conv_b",):
            return _spec(shape, mesh, *((None,) * (nd - 1)), "model")
        if last in ("w_a", "w_i"):
            return tail2("model", None)
        if last in ("lam", "b_a", "b_i"):
            return _spec(shape, mesh, *((None,) * (nd - 1)), "model")
        # ---- norms, biases, scalars ------------------------------------------
        return _rep(nd)

    return tree_map_with_path(rule, params)


def zero1_pspecs(param_specs: Any, params: Any, mesh) -> Any:
    """Optimizer-state specs: the param spec + shard the first
    still-replicated divisible dim over the data axes (ZeRO-1)."""
    daxes = data_axes(mesh)
    if not daxes:
        return param_specs

    def rule(leaf, spec: Spec) -> Spec:
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        if any(a in daxes for e in entries for a in _names(e)):
            return tuple(entries)       # already data-sharded (FSDP)
        for d, e in enumerate(entries):
            if e is None and _div(leaf.shape, d, mesh, daxes):
                entries[d] = daxes if len(daxes) > 1 else daxes[0]
                break
        return tuple(entries)

    return tree_map(rule, params, param_specs)


def fsdp_pspecs(param_specs: Any, params: Any, mesh) -> Any:
    """FSDP / ZeRO-3 parameter sharding: the ZeRO-1 rule applied to the
    parameters themselves (the first still-replicated divisible dim
    shards over the data axes); a step gathers them back before use."""
    return zero1_pspecs(param_specs, params, mesh)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------
def batch_pspecs(batch: Any, mesh) -> Any:
    daxes = data_axes(mesh)
    dp = _dp(mesh)

    def rule(_, leaf) -> Spec:
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        entries = [None] * len(shape)
        if _div(shape, 0, mesh, daxes):
            entries[0] = dp
        return tuple(entries)

    return tree_map_with_path(rule, batch)


def cache_pspecs(cache: Any, mesh) -> Any:
    """KV caches: (L, B, S, Hkv, D) -> batch over data axes, SEQUENCE over
    "model" (paper IS-S on the context dim).  Recurrent states: batch over
    data, width/heads over model.  Non-divisible dims degrade to None."""
    daxes = data_axes(mesh)
    dp = _dp(mesh)

    def rule(names, leaf) -> Spec:
        shape = tuple(leaf.shape)
        nd = len(shape)
        last = names[-1] if names else ""
        if nd == 1:      # lengths
            return _spec(shape, mesh, dp)
        if last in ("k", "v", "self_k", "self_v", "cross_k", "cross_v",
                    "k_cache", "v_cache"):
            # (L, B, S, H, D)
            return _spec(shape, mesh, None, dp, "model", None, None)
        if last == "pos_cache":
            return _spec(shape, mesh, None, dp, "model")
        if last == "wkv":       # (L, B, H, hs, hs)
            return _spec(shape, mesh, None, dp, "model", None, None)
        if last in ("tm_x", "cm_x", "lru_h"):   # (L, B, d)
            return _spec(shape, mesh, None, dp, "model")
        if last == "conv":      # (L, B, cw-1, W)
            return _spec(shape, mesh, None, dp, None, "model")
        entries = [None] * nd
        if nd >= 2 and _div(shape, 1, mesh, daxes):
            entries[1] = dp
        return tuple(entries)

    return tree_map_with_path(rule, cache)


# ---------------------------------------------------------------------------
# Full tensor <-> this rank's shard
# ---------------------------------------------------------------------------
def shard_tensor(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a copy when any dim
    is cut, so the full tensor can be freed)."""
    out = full
    for d, e in enumerate(spec):
        n = mesh.axis_size(_names(e)) if e is not None else 1
        if n > 1:
            part = out.shape[d] // n
            out = out.narrow(d, mesh.coord(_names(e)) * part, part)
    return out.clone() if out is not full else out


def gather_tensor(local: torch.Tensor, spec: Spec, mesh,
                  axes: Optional[Tuple[str, ...]] = None) -> torch.Tensor:
    """``local`` gathered back along every dim of ``spec`` (only the
    entries naming one of ``axes``, when given)."""
    out = local
    for d, e in enumerate(spec):
        names = _names(e)
        if names and (axes is None or any(a in axes for a in names)):
            out = C.all_gather(out, mesh, names, d)
    return out


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    return tree_map(lambda t, s: shard_tensor(t, s, mesh), tree, specs)


def gather_tree(tree: Any, specs: Any, mesh, axes=None) -> Any:
    return tree_map(lambda t, s: gather_tensor(t, s, mesh, axes), tree,
                    specs)
