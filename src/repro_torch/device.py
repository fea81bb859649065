"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA on a host without
    it raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev
