"""AdamW with global-norm clipping, cosine schedule, and optional int8
error-feedback gradient compression (port of ``repro.optim.adamw``).

States are trees of tensors (nested dicts, as the parameters), held in a
NamedTuple so a checkpoint names them ``opt/step``, ``opt/mu/...``,
``opt/nu/...`` (and ``opt/ef/...`` with compression) as the reference's
do.  The schedule, the bias corrections and the learning rate are
float32 tensors on the parameters' device, computed as JAX computes
them, and every leaf is updated in float32 and cast back to its dtype.

:func:`update` writes the new parameters and moments into the tensors
it was given, in place, walking each leaf in slices of at most
``_SLICE`` elements along its first (layer) axis: a full-width stacked
leaf in float32 would otherwise be a multi-GB temporary.  The slices
are independent elementwise updates, so slicing changes no value.

Under a mesh (ZeRO-1, driven by ``launch.steps``) every tree handed to
:func:`update` holds this rank's slices of the leaves, and ``axes``
names, leaf by leaf, the mesh axes a slice is cut over: the global norm
sums each leaf's squares over its axes (so an element counts once, and a
leaf replicated over an axis is not counted once per rank), and the
compression's per-leaf scale takes its ``max|x|`` over them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import collectives as C

#: most elements of one leaf updated at a time (64 MB of float32)
_SLICE = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any              # first moment, same tree as params
    nu: Any              # second moment
    ef: Any = None       # error-feedback residual (compression only)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    state_dtype: torch.dtype = torch.float32
    compress_grads: bool = False     # int8 error-feedback compression


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts with the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in sorted-key order, the order ``jax.tree.leaves`` walks a
    dict in (so sums over leaves run in the reference's order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (in the order of
    :func:`tree_leaves`)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def _slices(*leaves: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching views of ``leaves`` (one shape) in slices of the first
    axis of at most ``_SLICE`` elements each (a 0-d leaf whole)."""
    x = leaves[0]
    if x.dim() == 0 or x.numel() <= _SLICE:
        yield leaves
        return
    rows = max(1, _SLICE // max(1, x[0].numel()))
    yield from zip(*(t.split(rows) for t in leaves))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device (a divisor kept as a tensor
    divides exactly, as XLA does, where a Python scalar may be turned
    into a multiplication by its reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def init(params, cfg: AdamWConfig) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    ef = tree_map(zeros, params) if cfg.compress_grads else None
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params), ef)


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``; ``step`` is a
    0-d int32 tensor, the result float32."""
    warm = torch.clamp((step + 1).float()
                       / _f32(max(1, cfg.warmup_steps), step), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps).float()
        / _f32(max(1, cfg.total_steps - cfg.warmup_steps), step), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _over_axes(values: List[torch.Tensor], axes: List[Tuple[str, ...]],
               mesh, op: str) -> List[torch.Tensor]:
    """Each 0-d ``values[i]`` reduced (``op``) over the mesh axes
    ``axes[i]``: one collective per distinct set of axes."""
    out = list(values)
    for key in sorted(set(axes)):
        idx = [i for i, a in enumerate(axes) if a == key]
        if key and mesh.axis_size(key) > 1:
            red = C.all_reduce(torch.stack([values[i] for i in idx]), mesh,
                               key, op)
            for j, i in enumerate(idx):
                out[i] = red[j]
    return out


def global_norm(tree, mesh=None, axes=None) -> torch.Tensor:
    """The L2 norm of every leaf's elements, the leaves summed in tree
    order; under a mesh each leaf's sum of squares is first summed over
    its ``axes`` (a tree like ``tree``)."""
    sqs = [sum(torch.sum(torch.square(s.float())) for (s,) in _slices(leaf))
           for leaf in tree_leaves(tree)]
    if mesh is not None:
        sqs = _over_axes(sqs, tree_leaves(axes), mesh, "sum")
    total = 0
    for sq in sqs:
        total = total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), norm


# ---------------------------------------------------------------------------
# int8 error-feedback compression (cross-pod gradient-reduction payload)
# ---------------------------------------------------------------------------
def compress_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``x`` and their scale, ``max|x| / 127`` over the
    whole leaf (``amax``, where ``x`` is one shard of it)."""
    amax = x.abs().max() if amax is None else amax
    scale = amax / _f32(127.0, x) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _ef_one(g: torch.Tensor, e: torch.Tensor, mesh=None, axes=()):
    gf = g.float() + e
    amax = None
    if mesh is not None and axes:
        amax = C.all_reduce(gf.abs().max(), mesh, axes, "max")
    q, s = compress_int8(gf, amax)
    deq = decompress_int8(q, s)
    return deq.to(g.dtype), gf - deq


def ef_compress_grads(grads, ef, mesh=None, axes=None):
    """Error feedback: the residual of the previous step is added before
    quantization; the new residual is what quantization lost.  Each leaf
    is quantized whole (one scale per leaf; under a mesh the max over
    the leaf's shards), so this holds one leaf's float32 temporaries at
    a time."""
    if mesh is None:
        pairs = tree_map(_ef_one, grads, ef)
    else:
        pairs = tree_map(lambda g, e, a: _ef_one(g, e, mesh, a), grads, ef,
                         axes)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)


def _update_slice(p, g, m, v, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """The reference's ``upd`` on matching slices, written in place."""
    gf = g.float()
    mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
    vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
    mh = mf / bc1
    vh = vf / bc2
    delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
    p.copy_((p.float() - lr * delta).to(p.dtype))
    m.copy_(mf)
    v.copy_(vf)


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig, mesh=None,
           axes=None) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """Clip, optionally compress, and apply one AdamW step.

    ``params`` and the moments of ``state`` are updated in place and
    returned; ``grads`` are only read (with compression the compressed
    gradients are new tensors).  Under a bound ``mesh`` every tree holds
    this rank's slices and ``axes`` (a tree of axis-name tuples) says
    what each leaf's slice is cut over.  Returns ``(params, new_state,
    {"grad_norm", "lr"})``.
    """
    norm = global_norm(grads, mesh, axes)
    scale = _clip_scale(norm, cfg.clip_norm)
    ef = state.ef
    if cfg.compress_grads:
        grads, ef = ef_compress_grads(
            tree_map(lambda g: _clipped(g, scale), grads), ef, mesh, axes)
        scale = None                    # already applied
    step = state.step + 1
    lr = schedule(state.step, cfg)
    bc1 = 1 - _f32(cfg.b1, step) ** step.float()
    bc2 = 1 - _f32(cfg.b2, step) ** step.float()

    def leaf(p, g, m, v):
        for ps, gs, ms, vs in _slices(p, g, m, v):
            if scale is not None:
                gs = _clipped(gs, scale)
            _update_slice(ps, gs, ms, vs, lr, bc1, bc2, cfg)

    tree_map(leaf, params, grads, state.mu, state.nu)
    return params, AdamWState(step, state.mu, state.nu, ef), \
        {"grad_norm": norm, "lr": lr}
