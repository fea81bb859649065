"""Step-function builders: the train, prefill and serve steps and their
sharding (port of ``repro.launch.steps``).

The train step: gradients come from ``torch.autograd`` through the
model's ``loss``, then ``optim.adamw.update`` writes the new parameters
and moments in place.  Nothing is written before every gradient exists,
so a step that raises leaves the parameters and the optimizer state as
they were (the trainer retries it).  It carries no sharding: its mesh
form (data-parallel gradients, ZeRO-1 moments, FSDP) is ROADMAP queue 1,
item 10.

The prefill and serve steps run under a mesh.  ``assemble_shardings``
gives a cell's argument stand-ins (meta tensors) and the reference's
spec tables for them, and ``build_cell`` returns a :class:`Cell` that,
on a bound mesh, cuts full arguments to this rank's shards by those
specs and runs the step with explicit collectives.  With a mesh of more
than one rank, the transformer families (dense, MoE, VLM text) run
sharded; the others wait for ROADMAP queue 1, item 11.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import context
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.seq_attention import make_seq_sharded_attn
from repro_torch.launch.mesh import data_axes
from repro_torch.models import registry
from repro_torch.models.config import ShapeCell
from repro_torch.optim import adamw as axw


def _on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v, device=device)
            for k, v in batch.items()}


def _grads(mod, cfg, params, batch, tp: int):
    """(loss, gradients in ``tree_leaves`` order).  The parameters are
    taken as fresh leaves over the same storage, so the caller's tensors
    never require grad; a leaf the loss does not reach (the VLM's
    embedding table) gets zeros, as ``jax.grad`` gives."""
    view = axw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = mod.loss(view, cfg, batch, tp=tp)
    grads = torch.autograd.grad(loss, axw.tree_leaves(view),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), list(grads)


def make_train_step(entry: registry.ArchEntry, ocfg: axw.AdamWConfig,
                    tp: int = 1, microbatch: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds numpy arrays or tensors and goes to the
    parameters' device.  ``microbatch`` > 1 accumulates float32
    gradients over that many slices of the batch (the loss too), then
    divides, as the reference's scan does."""
    cfg, mod = entry.config, entry.module

    def train_step(params, opt_state: axw.AdamWState, batch):
        dev = axw.tree_leaves(params)[0].device
        batch = _on(batch, dev)
        if microbatch > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatch:
                raise ValueError(f"batch of {rows} does not split into "
                                 f"{microbatch} microbatches")
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            gsum = None
            for i in range(microbatch):
                mb = {k: v.chunk(microbatch)[i] for k, v in batch.items()}
                l, g = _grads(mod, cfg, params, mb, tp)
                gsum = [x.float() for x in g] if gsum is None else \
                    [a + b.float() for a, b in zip(gsum, g)]
                lsum = lsum + l
            loss = lsum / microbatch
            grads = [g / microbatch for g in gsum]
        else:
            loss, grads = _grads(mod, cfg, params, batch, tp)
        params, opt_state, metrics = axw.update(
            axw.tree_unflatten(params, grads), opt_state, params, ocfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Prefill / serve steps
# ---------------------------------------------------------------------------
def _check_family(cfg, mesh) -> None:
    if mesh is not None and mesh.size > 1 \
            and cfg.family not in registry.TRANSFORMER_FAMILIES:
        raise ValueError(
            f"{cfg.name} ({cfg.family}) under a mesh of {mesh.size} ranks: "
            f"the sharded steps of the rwkv6, rglru and encoder-decoder "
            f"families are ROADMAP queue 1, item 11 (their cache specs are "
            f"ported)")


def _held(mesh, batch: int, seq: int) -> Dict[str, bool]:
    """How a step holds its activations under ``mesh``: each rank its
    data shard of a batch of ``batch`` rows (the batch spec cuts it),
    and its context shard of a ``seq``-deep cache (the cache spec cuts
    S over "model")."""
    if mesh is None:
        return {}
    dsize = math.prod(mesh.shape[a] for a in data_axes(mesh))
    model = mesh.shape.get("model", 1)
    return {"local_batch": dsize > 1 and batch % dsize == 0,
            "local_seq": "model" in mesh.axis_names and seq % model == 0}


def _need_shape(mesh, shape):
    if mesh is not None and mesh.size > 1 and shape is None:
        raise ValueError("a step under a mesh of more than one rank needs "
                         "the cell's ShapeCell (global batch and context)")


def make_prefill_step(entry: registry.ArchEntry, tp: int, mesh=None,
                      max_seq: Optional[int] = None,
                      chunk: Optional[int] = None, *,
                      shape: Optional[ShapeCell] = None) -> Callable:
    """``prefill_step(params, inputs) -> (last logits, cache)``.

    ``chunk``: Sarathi-style chunked prefill for the transformer
    families.  Under a mesh of more than one rank, ``shape`` gives the
    global batch, ``params`` are this rank's shards, ``inputs`` its
    rows, and the cache comes back in this rank's context shard."""
    cfg, mod = entry.config, entry.module
    _check_family(cfg, mesh)
    _need_shape(mesh, shape)
    held = _held(mesh, shape.global_batch if shape else 0,
                 max_seq or (shape.seq_len if shape else 0))

    def prefill_step(params, inputs: Dict[str, Any]):
        with context.use_mesh(mesh, **held):
            if cfg.family == "audio":
                return mod.prefill(params, cfg, inputs["tokens"],
                                   frames=inputs["frames"], tp=tp,
                                   max_seq=max_seq)
            if cfg.family == "vlm":
                return mod.prefill(params, cfg, None,
                                   embeds=inputs["embeds"], tp=tp,
                                   max_seq=max_seq)
            if cfg.family in ("ssm", "hybrid"):
                return mod.prefill(params, cfg, inputs["tokens"], tp=tp)
            return mod.prefill(params, cfg, inputs["tokens"], tp=tp,
                               max_seq=max_seq, chunk=chunk)

    return prefill_step


def make_serve_step(entry: registry.ArchEntry, tp: int, mesh=None,
                    seq_sharded_attn: bool = False, *,
                    shape: Optional[ShapeCell] = None) -> Callable:
    """``serve_step(params, cache, tokens) -> (logits, cache)``, one
    decode iteration; under a mesh as :func:`make_prefill_step` (the
    cache is this rank's shard).  ``seq_sharded_attn`` combines the
    context shards' partials (``distributed.seq_attention``); without
    it a sharded cache is gathered before the attention."""
    cfg, mod = entry.config, entry.module
    _check_family(cfg, mesh)
    _need_shape(mesh, shape)
    held = _held(mesh, shape.global_batch if shape else 0,
                 shape.seq_len if shape else 0)
    attn_fn = None
    if seq_sharded_attn and mesh is not None \
            and cfg.family in registry.TRANSFORMER_FAMILIES:
        attn_fn = make_seq_sharded_attn(mesh)

    def serve_step(params, cache, tokens):
        with context.use_mesh(mesh, **held):
            if attn_fn is not None:
                return mod.decode_step(params, cfg, tokens, cache, tp=tp,
                                       attn_fn=attn_fn)
            return mod.decode_step(params, cfg, tokens, cache, tp=tp)

    return serve_step


# ---------------------------------------------------------------------------
# Sharding assembly
# ---------------------------------------------------------------------------
#: The reference's FSDP residency rule: parameters (plus, to train, the
#: ZeRO-1 float32 moments) above this many bytes per rank are sharded
#: over the data axes too.  It is the reference's threshold, kept so the
#: spec tables agree; it describes no card of this port.
FSDP_RESIDENCY_BYTES = 8 * 2**30


def assemble_shardings(entry: registry.ArchEntry, mesh, kind: str,
                       shape: ShapeCell,
                       ocfg: Optional[axw.AdamWConfig] = None,
                       fsdp: bool = True):
    """``(args, in_specs, out_specs)`` for one cell: the step's arguments
    as meta tensors and the spec trees of its arguments and outputs
    (``()`` is replicated).

    ``fsdp``: additionally shard the parameters over the data axes when
    the residency rule (:data:`FSDP_RESIDENCY_BYTES`) asks for it."""
    cfg = entry.config
    tp = mesh.shape["model"]
    params_sds = entry.module.init(cfg, tp, device="meta")
    leaves = [t for _, t in sh.tree_leaves_with_path(params_sds)]
    pspec = sh.param_pspecs(params_sds, mesh)
    if fsdp:
        pbytes = sum(t.numel() * t.element_size() for t in leaves) / tp
        if kind == "train":
            dsize = int(np.prod([mesh.shape[a] for a in data_axes(mesh)])
                        ) or 1
            n_par = sum(t.numel() for t in leaves)
            resid = pbytes + 8.0 * n_par / tp / dsize   # f32 mu+nu, ZeRO-1
        else:
            resid = pbytes
        fsdp = resid > FSDP_RESIDENCY_BYTES
    if fsdp:
        pspec = sh.fsdp_pspecs(pspec, params_sds, mesh)
    rep = ()
    inputs_sds = registry.input_specs(cfg, shape, tp)
    bspec = sh.batch_pspecs(inputs_sds, mesh)

    if kind == "train":
        ocfg = ocfg or axw.AdamWConfig()
        opt_sds = axw.init(params_sds, ocfg)
        z1 = sh.zero1_pspecs(pspec, params_sds, mesh)
        ospec = axw.AdamWState(rep, z1, z1,
                               z1 if ocfg.compress_grads else None)
        return ((params_sds, opt_sds, inputs_sds), (pspec, ospec, bspec),
                (pspec, ospec, rep))

    cache_sds = registry.cache_specs(entry, shape, tp)
    cspec = sh.cache_pspecs(cache_sds, mesh)
    if kind == "prefill":
        # last-token logits replicated; cache sharded
        return (params_sds, inputs_sds), (pspec, bspec), (rep, cspec)

    # decode
    tok_sds = inputs_sds["tokens"]
    tspec = bspec["tokens"]
    logits_spec = rep
    daxes = data_axes(mesh)
    if daxes and shape.global_batch % int(
            np.prod([mesh.shape[a] for a in daxes])) == 0:
        logits_spec = (daxes if len(daxes) > 1 else daxes[0], None)
    return ((params_sds, cache_sds, tok_sds), (pspec, cspec, tspec),
            (logits_spec, cspec))


def _reshard(t: torch.Tensor, held, want, mesh) -> torch.Tensor:
    """``t`` held by ``held`` gathered where ``want`` does not cut."""
    held = tuple(held) + (None,) * (t.ndim - len(held))
    want = tuple(want) + (None,) * (t.ndim - len(want))
    for d, (h, w) in enumerate(zip(held, want)):
        extra = tuple(a for a in sh._names(h) if a not in sh._names(w))
        if extra:
            t = sh.gather_tensor(t, (None,) * d + (extra,), mesh)
    return t


@dataclass
class Cell:
    """One (arch x shape x mesh) step on a bound mesh.

    ``cell(*full_args)`` cuts full arguments to this rank's shards by
    ``in_specs`` and runs the step; ``cell.step(*local_args)`` runs it on
    shards already cut (``cell.shard``), so a decode loop keeps its cache
    sharded.  Outputs are held as ``out_specs`` say; ``cell.gather``
    gathers them to full tensors."""
    kind: str
    mesh: Any
    fn: Callable
    args: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    out_specs: Tuple[Any, ...]
    held_specs: Tuple[Any, ...]

    def shard(self, *full_args):
        return tuple(sh.shard_tree(a, s, self.mesh)
                     for a, s in zip(full_args, self.in_specs))

    def step(self, *local_args):
        params, *rest = local_args
        # FSDP shards: gather the data axes back (the reference's layer
        # scan re-gathers them at each use)
        params = sh.gather_tree(params, self.in_specs[0], self.mesh,
                                axes=data_axes(self.mesh))
        out = self.fn(params, *rest)
        return tuple(sh.tree_map(
            lambda t, h, w: _reshard(t, h, w, self.mesh), o, hs, ws)
            for o, hs, ws in zip(out, self.held_specs, self.out_specs))

    def gather(self, outputs):
        return tuple(sh.gather_tree(o, s, self.mesh)
                     for o, s in zip(outputs, self.out_specs))

    def __call__(self, *full_args):
        return self.step(*self.shard(*full_args))


def build_cell(entry: registry.ArchEntry, mesh, shape: ShapeCell,
               seq_sharded_attn: bool = False,
               prefill_chunk: Optional[int] = None):
    """``(cell, args)``: the :class:`Cell` of one (arch x shape) on
    ``mesh`` (bound, to run it) and its argument stand-ins."""
    tp = mesh.shape["model"]
    kind = shape.kind
    if kind == "train":
        raise ValueError("the sharded train step (data-parallel gradients, "
                         "ZeRO-1 moments, FSDP) is ROADMAP queue 1, item "
                         "10; make_train_step runs one rank")
    args, in_specs, out_specs = assemble_shardings(entry, mesh, kind, shape)
    if kind == "prefill":
        fn = make_prefill_step(entry, tp, mesh, max_seq=shape.seq_len,
                               chunk=prefill_chunk, shape=shape)
        rows = next(iter(in_specs[1].values()))[:1]
    else:
        fn = make_serve_step(entry, tp, mesh,
                             seq_sharded_attn=seq_sharded_attn, shape=shape)
        rows = in_specs[2][:1]
    # the step returns this rank's rows of the logits
    held = (rows + (None,), out_specs[1])
    return Cell(kind, mesh, fn, args, in_specs, out_specs, held), args
