"""Step-function builders: the train, prefill and serve steps and their
sharding (port of ``repro.launch.steps``).

The train step: gradients come from ``torch.autograd`` through the
model's ``loss``, then ``optim.adamw.update`` writes the new parameters
and moments in place.  Nothing is written before every gradient exists,
so a step that raises on one rank leaves the parameters and the
optimizer state as they were (the trainer retries it).

Under a bound mesh the train step runs this rank's part of the
reference's GSPMD program (every family): its parameters
are the shards of ``assemble_shardings``' spec tables, its batch rows
its data shard, the model's collectives are autograd's
(``distributed.collectives``), and the loss is the global batch's mean,
so the gradients summed over the data axes are the global mean's.  Then
ZeRO-1: each rank keeps the moments of its ``zero1_pspecs`` slice,
updates its slice of each parameter and gathers the parameters back over
the data axes.  Where the residency rule shards the parameters over the
data axes too (FSDP), each layer is gathered where it runs
(``distributed.fsdp``), its gradient comes back summed onto its shard,
and such a leaf stays sharded through the update.

The prefill and serve steps run under a mesh too.  ``assemble_shardings``
gives a cell's argument stand-ins (meta tensors) and the reference's
spec tables for them, and ``build_cell`` returns a :class:`Cell` that,
on a bound mesh, cuts full arguments to this rank's shards by those
specs and runs the step with explicit collectives.  Every family runs
sharded: the transformer families (dense, MoE, VLM text), rwkv6 (its
prefill and serve steps run the WKV6 kernel on each rank's heads, as
the engine does), RecurrentGemma and the encoder-decoder.  Under a mesh
that is a description only, a step runs the whole sharded program in
one process (the MoE caps each data chunk's pairs, and runs each model
rank's experts in turn).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed import context
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.fsdp import LayerGather
from repro_torch.distributed.seq_attention import make_seq_sharded_attn
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import data_axes
from repro_torch.models import registry
from repro_torch.models.config import ShapeCell
from repro_torch.optim import adamw as axw


def _on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v, device=device)
            for k, v in batch.items()}


def _grads(mod, cfg, params, batch, tp: int, fs=None):
    """(loss, gradients in ``tree_leaves`` order).  The parameters are
    taken as fresh leaves over the same storage, so the caller's tensors
    never require grad; a leaf the loss does not reach (the VLM's
    embedding table) gets zeros, as ``jax.grad`` gives.  Under FSDP
    (``fs``) the leaves outside the layer stacks are gathered here, the
    layers inside the model."""
    view = axw.tree_map(lambda p: p.detach().requires_grad_(), params)
    full = fs.gather_top(view) if fs is not None else view
    loss = mod.loss(full, cfg, batch, tp=tp)
    grads = torch.autograd.grad(loss, axw.tree_leaves(view),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), list(grads)


def _accumulate(mod, cfg, params, batch, tp: int, microbatch: int, fs):
    """(loss, gradients): ``microbatch`` > 1 accumulates float32
    gradients over that many slices of ``batch`` (the loss too), then
    divides, as the reference's scan does."""
    if microbatch == 1:
        return _grads(mod, cfg, params, batch, tp, fs)
    rows = next(iter(batch.values())).shape[0]
    if rows % microbatch:
        raise ValueError(f"batch of {rows} does not split into "
                         f"{microbatch} microbatches")
    dev = next(iter(batch.values())).device
    lsum = torch.zeros((), dtype=torch.float32, device=dev)
    gsum = None
    for i in range(microbatch):
        mb = {k: v.chunk(microbatch)[i] for k, v in batch.items()}
        l, g = _grads(mod, cfg, params, mb, tp, fs)
        gsum = [x.float() for x in g] if gsum is None else \
            [a + b.float() for a, b in zip(gsum, g)]
        lsum = lsum + l
    return lsum / microbatch, [g / microbatch for g in gsum]


def microbatch_rows(global_batch: int, dsize: int,
                    microbatch: int) -> torch.Tensor:
    """The order of the global batch's rows whose contiguous data shards
    are each rank's rows of every microbatch: microbatch ``i`` is rows
    ``[i B/m, (i+1) B/m)`` of the global batch, cut over the ``dsize``
    data ranks, so rank ``j`` holds rows ``i B/m + j B/(m d) + r`` for
    each ``i`` in turn (as the reference's reshape of its data-sharded
    batch gives each data chunk of a microbatch)."""
    if global_batch % (microbatch * dsize):
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"split into {microbatch} microbatches over "
                         f"{dsize} data ranks")
    per = global_batch // (microbatch * dsize)
    return torch.tensor([i * global_batch // microbatch + j * per + r
                         for j in range(dsize) for i in range(microbatch)
                         for r in range(per)])


class _Zero1:
    """The ZeRO-1 bookkeeping of one sharded train step, leaf by leaf in
    ``tree_leaves`` order: the dim its optimizer slice cuts over the data
    axes beyond the parameter's own spec (``None``: the parameter is held
    as its slice already, by FSDP, or no dim divides), the mesh axes that
    slice is cut over (the global norm's and the compression scale's
    reductions), and whether the parameter is FSDP-sharded (its gradient
    comes out of backward summed over the data axes)."""

    def __init__(self, mesh, pspec, zspec):
        self.mesh = mesh
        self.daxes = data_axes(mesh)
        self.dsize = mesh.axis_size(self.daxes) if self.daxes else 1
        self.zdim, self.axes, self.fsdp = [], [], []
        for ps, zs in zip(axw.tree_leaves(pspec), axw.tree_leaves(zspec)):
            named = {a for e in zs for a in sh._names(e)}
            held = {a for e in ps for a in sh._names(e)}
            self.fsdp.append(any(a in self.daxes for a in held))
            self.zdim.append(next(
                (d for d, (p, z) in enumerate(zip(ps, zs)) if z != p
                 and self.dsize > 1), None))
            self.axes.append(tuple(a for a in mesh.axis_names
                                   if a in named))

    def _slice(self, t: torch.Tensor, d) -> torch.Tensor:
        if d is None:
            return t
        part = t.shape[d] // self.dsize
        return t.narrow(d, self.mesh.coord(self.daxes) * part, part)

    def gradients(self, grads):
        """This rank's ZeRO-1 slices of the global gradients: a leaf's
        local gradient summed over the data axes (FSDP leaves come so
        from backward), then cut.  ``grads`` is emptied as it goes, so
        each leaf's whole gradient is freed once its slice is cut."""
        out = []
        for i, (d, f) in enumerate(zip(self.zdim, self.fsdp)):
            g, grads[i] = grads[i], None
            if not f and self.dsize > 1:
                g = C.all_reduce(g, self.mesh, self.daxes)
            out.append(g if d is None else self._slice(g, d).clone())
        return out

    def views(self, params):
        """This rank's slices of its parameter shards (views)."""
        return [self._slice(p, d) for p, d in zip(params, self.zdim)]

    def gather(self, params, views) -> None:
        """Each parameter shard written from the data ranks' updated
        slices."""
        for p, v, d in zip(params, views, self.zdim):
            if d is not None:
                p.copy_(C.all_gather(v, self.mesh, self.daxes, d))


def make_train_step(entry: registry.ArchEntry, ocfg: axw.AdamWConfig,
                    tp: int = 1, mesh=None, microbatch: int = 1, *,
                    shape: Optional[ShapeCell] = None,
                    fsdp: Optional[bool] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds numpy arrays or tensors and goes to the
    parameters' device.  ``microbatch`` > 1 accumulates float32
    gradients over that many slices of the batch (the loss too), then
    divides, as the reference's scan does.

    Under a bound ``mesh``, ``shape`` gives the global batch; ``params``
    are this rank's shards (``assemble_shardings``' spec), ``opt_state``
    its ZeRO-1 slices and ``batch`` its rows (with ``microbatch`` > 1
    in the order of :func:`microbatch_rows`); ``fsdp`` as
    :func:`assemble_shardings` takes it.  The step's FSDP gatherer, if
    any, is ``train_step.fsdp``."""
    cfg, mod = entry.config, entry.module
    sharded = mesh is not None and mesh.bound
    zero1, fs, held = None, None, {}
    if sharded:
        if shape is None:
            raise ValueError("the train step on a bound mesh needs the "
                             "cell's ShapeCell (its global batch)")
        _, (pspec, ospec, _), _ = assemble_shardings(entry, mesh, "train",
                                                     shape, ocfg, fsdp)
        zero1 = _Zero1(mesh, pspec, ospec.mu)
        if shape.global_batch % (zero1.dsize * microbatch):
            raise ValueError(f"a global batch of {shape.global_batch} rows "
                             f"does not split over {zero1.dsize} data "
                             f"ranks and {microbatch} microbatches")
        held = {"local_batch": zero1.dsize > 1}
        if LayerGather.needed(mesh, pspec):
            fs = LayerGather(mesh, pspec, mod.layer_stacks(cfg))

    def train_step(params, opt_state: axw.AdamWState, batch):
        dev = axw.tree_leaves(params)[0].device
        batch = _on(batch, dev)
        with context.use_mesh(mesh, **held), context.use_fsdp(fs):
            loss, grads = _accumulate(mod, cfg, params, batch, tp,
                                      microbatch, fs)
        if zero1 is None:
            params, opt_state, metrics = axw.update(
                axw.tree_unflatten(params, grads), opt_state, params, ocfg)
        else:
            leaves = axw.tree_leaves(params)
            views = zero1.views(leaves)
            _, opt_state, metrics = axw.update(
                axw.tree_unflatten(params, zero1.gradients(grads)),
                opt_state, axw.tree_unflatten(params, views), ocfg,
                mesh=mesh, axes=axw.tree_unflatten(params, zero1.axes))
            zero1.gather(leaves, views)
        metrics["loss"] = loss
        return params, opt_state, metrics

    train_step.fsdp = fs
    return train_step


# ---------------------------------------------------------------------------
# Prefill / serve steps
# ---------------------------------------------------------------------------
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
    families.  rwkv6 runs its recurrence through the WKV6 kernel
    (``kernels.ops.wkv6_scan``: the kernel on CUDA tensors, its plain
    version on the CPU), as the engine does.  Under a mesh of more than
    one rank, ``shape`` gives the global batch, ``params`` are this
    rank's shards, ``inputs`` its rows, and the cache comes back in this
    rank's shards of it."""
    cfg, mod = entry.config, entry.module
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
            if cfg.family == "ssm":
                return mod.prefill(params, cfg, inputs["tokens"], tp=tp,
                                   wkv_fn=kops.wkv6_scan)
            if cfg.family == "hybrid":
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
    it a sharded cache is gathered before the attention.  rwkv6 steps
    through the WKV6 kernel, as :func:`make_prefill_step`."""
    cfg, mod = entry.config, entry.module
    _need_shape(mesh, shape)
    held = _held(mesh, shape.global_batch if shape else 0,
                 shape.seq_len if shape else 0)
    kw = {}
    if seq_sharded_attn and mesh is not None \
            and cfg.family in registry.TRANSFORMER_FAMILIES:
        kw = {"attn_fn": make_seq_sharded_attn(mesh)}
    elif cfg.family == "ssm":
        kw = {"wkv_fn": kops.wkv6_scan}

    def serve_step(params, cache, tokens):
        with context.use_mesh(mesh, **held):
            return mod.decode_step(params, cfg, tokens, cache, tp=tp, **kw)

    return serve_step


# ---------------------------------------------------------------------------
# Sharding assembly
# ---------------------------------------------------------------------------
#: The reference's FSDP residency rule: parameters (plus, to train, the
#: ZeRO-1 float32 moments) above this many bytes per rank are sharded
#: over the data axes too.  It is the reference's threshold, kept so the
#: spec tables agree; it describes no card of this port.
FSDP_RESIDENCY_BYTES = 8 * 2**30


def fsdp_by_rule(params_sds, mesh, kind: str) -> bool:
    """Whether the residency rule (:data:`FSDP_RESIDENCY_BYTES`) shards
    parameters like ``params_sds`` over the data axes of ``mesh`` for a
    ``kind`` cell."""
    leaves = [t for _, t in sh.tree_leaves_with_path(params_sds)]
    tp = mesh.shape["model"]
    pbytes = sum(t.numel() * t.element_size() for t in leaves) / tp
    if kind == "train":
        dsize = int(np.prod([mesh.shape[a] for a in data_axes(mesh)])) or 1
        n_par = sum(t.numel() for t in leaves)
        resid = pbytes + 8.0 * n_par / tp / dsize   # f32 mu+nu, ZeRO-1
    else:
        resid = pbytes
    return resid > FSDP_RESIDENCY_BYTES


def assemble_shardings(entry: registry.ArchEntry, mesh, kind: str,
                       shape: ShapeCell,
                       ocfg: Optional[axw.AdamWConfig] = None,
                       fsdp: Optional[bool] = None):
    """``(args, in_specs, out_specs)`` for one cell: the step's arguments
    as meta tensors and the spec trees of its arguments and outputs
    (``()`` is replicated).

    ``fsdp``: additionally shard the parameters over the data axes, when
    the residency rule asks for it (:func:`fsdp_by_rule`; ``None``) or
    as told (``True`` / ``False``)."""
    cfg = entry.config
    tp = mesh.shape["model"]
    params_sds = entry.module.init(cfg, tp, device="meta")
    pspec = sh.param_pspecs(params_sds, mesh)
    if fsdp is None:
        fsdp = fsdp_by_rule(params_sds, mesh, kind)
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
    sharded and a train loop its parameters and moments.  Outputs are
    held as ``out_specs`` say; ``cell.gather`` gathers them to full
    tensors.  Under FSDP, ``fsdp`` is the step's layer gatherer: the
    leaves outside the layer stacks are gathered whole at the start of a
    step and each layer where it runs (``layer_gathers`` counts them)."""
    kind: str
    mesh: Any
    fn: Callable
    args: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    out_specs: Tuple[Any, ...]
    held_specs: Tuple[Any, ...]
    fsdp: Optional[LayerGather] = None
    microbatch: int = 1

    def shard(self, *full_args):
        """This rank's shards of full arguments (a ``None`` argument stays
        ``None``).  A train batch is cut by rows, in the order of
        :func:`microbatch_rows` with ``microbatch`` > 1."""
        specs = self.in_specs
        if self.kind == "train" and full_args[2] is not None:
            params, opt, batch = full_args
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
            if self.microbatch > 1:
                dsize = self.mesh.axis_size(data_axes(self.mesh))
                rows = next(iter(batch.values())).shape[0]
                order = microbatch_rows(rows, dsize, self.microbatch)
                batch = {k: v[order.to(v.device)] for k, v in batch.items()}
            row = next(iter(specs[2].values()))[:1]
            specs = specs[:2] + ({k: specs[2].get(k, row) for k in batch},)
            full_args = (params, opt, batch)
        return tuple(sh.shard_tree(a, s, self.mesh)
                     for a, s in zip(full_args, specs))

    def run_with(self, fn: Callable, params, *rest):
        """``fn(params, *rest)`` on this cell's parameter shards under its
        FSDP gathers (another step on the same shards, such as a prefill
        into the serve cell's cache)."""
        with context.use_fsdp(self.fsdp):
            if self.fsdp is not None:
                params = self.fsdp.gather_top(params)
            return fn(params, *rest)

    def step(self, *local_args):
        if self.kind == "train":
            return self.fn(*local_args)
        out = self.run_with(self.fn, *local_args)
        return tuple(sh.tree_map(
            lambda t, h, w: _reshard(t, h, w, self.mesh), o, hs, ws)
            for o, hs, ws in zip(out, self.held_specs, self.out_specs))

    def gather(self, outputs):
        return tuple(o if s == () else sh.gather_tree(o, s, self.mesh)
                     for o, s in zip(outputs, self.out_specs))

    def __call__(self, *full_args):
        return self.step(*self.shard(*full_args))


def build_cell(entry: registry.ArchEntry, mesh, shape: ShapeCell,
               seq_sharded_attn: bool = False,
               ocfg: Optional[axw.AdamWConfig] = None, microbatch: int = 1,
               prefill_chunk: Optional[int] = None,
               fsdp: Optional[bool] = None):
    """``(cell, args)``: the :class:`Cell` of one (arch x shape) on
    ``mesh`` (bound, to run it) and its argument stand-ins; ``fsdp`` as
    :func:`assemble_shardings` takes it."""
    tp = mesh.shape["model"]
    kind = shape.kind
    args, in_specs, out_specs = assemble_shardings(entry, mesh, kind, shape,
                                                   ocfg, fsdp)
    if kind == "train":
        fn = make_train_step(entry, ocfg or axw.AdamWConfig(), tp, mesh,
                             microbatch, shape=shape, fsdp=fsdp)
        return Cell(kind, mesh, fn, args, in_specs, out_specs, out_specs,
                    fn.fsdp, microbatch), args
    if kind == "prefill":
        fn = make_prefill_step(entry, tp, mesh, max_seq=shape.seq_len,
                               chunk=prefill_chunk, shape=shape)
        rows = next(iter(in_specs[1].values()))[:1]
    else:
        fn = make_serve_step(entry, tp, mesh,
                             seq_sharded_attn=seq_sharded_attn, shape=shape)
        rows = in_specs[2][:1]
    fs = LayerGather(mesh, in_specs[0],
                     entry.module.layer_stacks(entry.config)) \
        if LayerGather.needed(mesh, in_specs[0]) else None
    # the step returns this rank's rows of the logits
    held = (rows + (None,), out_specs[1])
    return Cell(kind, mesh, fn, args, in_specs, out_specs, held, fs), args
