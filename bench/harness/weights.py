"""Random weights from the seed, made on the device in a few large calls.

The configuration's reference (``reference/<name>.py``) gives the tree's
layout: for each leaf its path, shape and std.  Every leaf of one dtype
is a view of one buffer filled by one ``normal_`` call from a generator
on the device, then scaled in place: the matrices in the configuration's
dtype, then the float32 matrices (an MoE's router: the port routes in
float32), then the float32 norm scales, which are drawn about 1.

The same tensors go to the engine and to the plain reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from bench.harness import spec

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def _put(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _fill(entries, dtype, gen, device, tree, mean: float = 0.0) -> None:
    total = sum(math.prod(shape) for _, shape, _ in entries)
    if not total:
        return
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(0.0, 1.0, generator=gen)
    at = 0
    for path, shape, std in entries:
        size = math.prod(shape)
        view = buf[at:at + size].view(shape)
        view.mul_(std).add_(mean)
        _put(tree, path, view)
        at += size


def make(cfg: Dict, seed: int, device) -> Dict:
    """The parameter tree of ``cfg`` for ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    mats, f32, norms = spec.reference(cfg).layout(cfg)
    tree: Dict = {}
    _fill(mats, DTYPES[cfg["torch_dtype"]], gen, device, tree)
    _fill(f32, torch.float32, gen, device, tree)
    _fill(norms, torch.float32, gen, device, tree, mean=1.0)
    return tree
