"""The train step (port of ``repro.launch.steps.make_train_step``).

One card has no mesh, so the step carries no sharding: gradients come
from ``torch.autograd`` through the model's ``loss``, then
``optim.adamw.update`` writes the new parameters and moments in place.
Nothing is written before every gradient exists, so a step that raises
leaves the parameters and the optimizer state as they were (the trainer
retries it).  The prefill / serve steps and the sharding assembly of the
reference wait for the distribution slice (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.models import registry
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
