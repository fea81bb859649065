"""Architecture registry: ``--arch <id>`` resolution (port of
``repro.models.registry``).

Every reference id resolves, to the module of its family: the
transformer (dense, MoE, and the VLM text backbone with M-RoPE), RWKV6
(``ssm``), RecurrentGemma (``hybrid``) and the Whisper encoder-decoder
(``audio``).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any

from repro_torch.models import encdec, rglru, rwkv6, transformer
from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "dbrx-132b", "kimi-k2-1t-a32b", "rwkv6-7b", "stablelm-3b", "yi-6b",
    "granite-3-8b", "qwen1.5-110b", "recurrentgemma-9b", "qwen2-vl-7b",
    "whisper-small",
]

# the paper's own Table 1 models, selectable in the reference beyond the
# assigned sweep
EXTRA_ARCH_IDS = ["opt-66b", "llama3-70b", "mixtral-8x22b", "qwen3-30b-a3b"]

# module name under repro_torch.configs
_CONFIG_MODULES = {
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "rwkv6-7b": "rwkv6_7b",
    "stablelm-3b": "stablelm_3b",
    "yi-6b": "yi_6b",
    "granite-3-8b": "granite_3_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-small": "whisper_small",
    "opt-66b": "opt_66b",
    "llama3-70b": "llama3_70b",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen3-30b-a3b": "qwen3_30b_a3b",
}

#: families served by the transformer module (the engines key their
#: chunked prefill and flash-decode paths off this set too)
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")


@dataclass(frozen=True)
class ArchEntry:
    config: ArchConfig
    module: Any     # model module implementing the protocol

    def cache_zeros(self, batch: int, max_seq: int, tp: int = 1,
                    device="cuda"):
        cfg = self.config
        if cfg.family == "ssm":
            return rwkv6.RWKVState.zeros(cfg, batch, device=device)
        if cfg.family == "hybrid":
            return rglru.RGState.zeros(cfg, batch, device=device)
        if cfg.family == "audio":
            return encdec.EncDecCache.zeros(cfg, batch, max_seq, tp,
                                            device=device)
        return transformer.KVCache.zeros(cfg, batch, max_seq, tp,
                                         device=device)


def _module_for(cfg: ArchConfig):
    return {"ssm": rwkv6, "hybrid": rglru, "audio": encdec}.get(
        cfg.family, transformer)


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIG_MODULES:
        raise KeyError(f"unknown arch {name!r}; the ids are "
                       f"{sorted(_CONFIG_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_CONFIG_MODULES[name]}")
    return mod.CONFIG


def from_config(cfg: ArchConfig) -> ArchEntry:
    return ArchEntry(config=cfg, module=_module_for(cfg))


def get(name: str, reduced: bool = False, **over) -> ArchEntry:
    cfg = get_config(name)
    if reduced:
        cfg = cfg.reduced(**over)
    elif over:
        cfg = dataclasses.replace(cfg, **over)
    return from_config(cfg)
