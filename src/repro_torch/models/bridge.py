"""Parameter bridge: the reference's parameter tree as port parameters.

A reference model's ``init`` (``repro.models.transformer``,
``repro.models.rwkv6``, ``repro.models.rglru`` or
``repro.models.encdec``) returns a nested dict of arrays with the layer
dims leading (``(G, 2, ...)`` for RecurrentGemma's grouped recurrent
layers); converted leaf by leaf with ``np.asarray`` it is exactly the
tree the port's module of the same family builds, so the two packages
can be compared on identical weights.  This module takes numpy arrays
only and never touches JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models import registry
from repro_torch.models.config import ArchConfig


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16: reinterpret
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                      device="cuda", tp: int = 1) -> Dict[str, Any]:
    """Convert a reference parameter tree (numpy leaves) for ``cfg``.

    Raises ``ValueError`` when the tree's keys, shapes or dtypes differ
    from what the port builds for ``cfg``.
    """
    dev = resolve(device)
    template = registry.from_config(cfg).module.init(cfg, tp,
                                                     device="meta")

    def conv(t, ref, path):
        if isinstance(ref, dict):
            got = sorted(t) if isinstance(t, dict) else type(t).__name__
            if got != sorted(ref):
                raise ValueError(f"{path or 'params'}: keys {got} != "
                                 f"expected {sorted(ref)}")
            return {k: conv(t[k], ref[k], f"{path}/{k}") for k in ref}
        out = _to_tensor(t, dev)
        if tuple(out.shape) != tuple(ref.shape) or out.dtype != ref.dtype:
            raise ValueError(
                f"{path}: got {tuple(out.shape)} {out.dtype}, expected "
                f"{tuple(ref.shape)} {ref.dtype}")
        return out

    return conv(tree, template, "")
