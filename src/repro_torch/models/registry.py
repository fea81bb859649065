"""Architecture registry: ``--arch <id>`` resolution (port of
``repro.models.registry``).

The port serves the transformer families (dense, MoE, and the VLM text
backbone with M-RoPE) and the RWKV6 (``ssm``) family.  Asking for an
architecture whose family has not been ported (the recurrent hybrid and
the encoder-decoder) raises ``NotImplementedError`` naming the slice
that brings it.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any

from repro_torch.models import rwkv6, transformer
from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "dbrx-132b", "kimi-k2-1t-a32b", "rwkv6-7b", "stablelm-3b", "yi-6b",
    "granite-3-8b", "qwen1.5-110b", "recurrentgemma-9b", "qwen2-vl-7b",
    "whisper-small",
]

# the paper's own Table 1 models, selectable in the reference beyond the
# assigned sweep
EXTRA_ARCH_IDS = ["opt-66b", "llama3-70b", "mixtral-8x22b", "qwen3-30b-a3b"]

# configs ported so far (module name under repro_torch.configs)
_CONFIG_MODULES = {
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "rwkv6-7b": "rwkv6_7b",
    "stablelm-3b": "stablelm_3b",
    "yi-6b": "yi_6b",
    "granite-3-8b": "granite_3_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "opt-66b": "opt_66b",
    "llama3-70b": "llama3_70b",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen3-30b-a3b": "qwen3_30b_a3b",
}

#: families served by the transformer module (the engines key their
#: chunked prefill and flash-decode paths off this set too)
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
# the slice (ROADMAP queue 1) that brings what is still to port
_RECURRENT_SLICE = "recurrent and encoder-decoder families (queue 1, item 7)"
_PENDING_FAMILIES = {"hybrid": _RECURRENT_SLICE, "audio": _RECURRENT_SLICE}


@dataclass(frozen=True)
class ArchEntry:
    config: ArchConfig
    module: Any     # model module implementing the protocol

    def cache_zeros(self, batch: int, max_seq: int, tp: int = 1,
                    device="cuda"):
        if self.config.family == "ssm":
            return rwkv6.RWKVState.zeros(self.config, batch, device=device)
        return transformer.KVCache.zeros(self.config, batch, max_seq, tp,
                                         device=device)


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIG_MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: the port has configs for "
            f"{sorted(_CONFIG_MODULES)}; the others arrive with: "
            f"{_RECURRENT_SLICE}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_CONFIG_MODULES[name]}")
    return mod.CONFIG


def from_config(cfg: ArchConfig) -> ArchEntry:
    if cfg.family == "ssm":
        return ArchEntry(config=cfg, module=rwkv6)
    if cfg.family not in TRANSFORMER_FAMILIES:
        slice_ = _PENDING_FAMILIES.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; it "
            f"arrives with: {slice_}")
    if cfg.window:
        raise NotImplementedError(
            f"{cfg.name}: windowed attention is not ported yet; it arrives "
            f"with: {_RECURRENT_SLICE}")
    return ArchEntry(config=cfg, module=transformer)


def get(name: str, reduced: bool = False, **over) -> ArchEntry:
    cfg = get_config(name)
    if reduced:
        cfg = cfg.reduced(**over)
    elif over:
        cfg = dataclasses.replace(cfg, **over)
    return from_config(cfg)
