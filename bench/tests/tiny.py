"""Cells of the benchmark at a size the CPU runs in seconds: the real
configuration files with their widths cut, and the real mixes with
their lengths cut, through the same harness."""
from __future__ import annotations

import copy
import io
import json
import time
from typing import Dict, Optional

import torch

from bench.harness import cell as cell_run
from bench.harness import spec

SMALL = {"hidden_size": 128, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 32, "num_hidden_layers": 2,
         "intermediate_size": 256, "vocab_size": 512}
SMALL_MOE = {"num_experts": 8, "num_experts_per_tok": 2,
             "moe_intermediate_size": 64}
ENGINE = {"max_batch": 4, "page_size": 8, "prefill_chunk": 16,
          "fuse_steps": 4, "kv_pool_bytes": 1 << 30}
MIX = {"min_waiting": 4, "pool": 64,
       "prompt_len": {"median": 20, "sigma": 0.5, "min": 4, "max": 40},
       "output_len": {"median": 12, "sigma": 0.5, "min": 4, "max": 24}}


CELL = "yi6b.decode_saturated"       # the metrics and limits of a cell
MOE_CELL = "qwen3moe.decode_saturated"   # the limits of an MoE's cell
#: every configuration and mix the harness keeps files for
CASES = [("yi-6b", "decode_saturated"), ("qwen3-30b-a3b", "decode_saturated"),
         ("yi-6b", "prefill_saturated")]


def cell(config: str = "yi-6b", mix: str = "decode_saturated",
         limit: Optional[float] = None, **over) -> spec.Cell:
    """Configuration file ``config`` under mix ``mix``, cut to the CPU
    size, with the metrics of ``CELL`` and the limits of ``CELL`` (of
    ``MOE_CELL`` for an MoE); ``over`` replaces configuration keys
    (``init_std`` by default 0.1, so the logits spread as at the
    published widths)."""
    c = spec.resolve(CELL)
    c.config = spec.load_json(spec.BENCH_DIR / "configs" / f"{config}.json")
    c.traffic = spec.load_json(spec.traffic_path(mix))
    cfg: Dict = copy.deepcopy(c.config)
    cfg.update(SMALL)
    if cfg.get("num_experts"):
        cfg.update(SMALL_MOE)
        c.limits = spec.resolve(MOE_CELL).limits
    cfg["init_std"] = 0.1
    cfg["engine"] = dict(cfg["engine"], **ENGINE)
    cfg.update(over)
    c.config = cfg
    mix = copy.deepcopy(c.traffic)
    mix.update(copy.deepcopy(MIX))
    if mix["open_when_active"] != "full":
        mix["open_when_active"] = 3
    c.traffic = mix
    if limit is not None:
        c.limits = {"max_logit_gap": {"limit": limit}}
    return c


def run(c: spec.Cell, seed: int = 2 ** 31 + 99, trace: bool = False,
        control: bool = False, ticks: int = 40):
    """One run of ``c`` on the CPU with a window of ``ticks`` ticks, on
    one host thread (the test workers share the host's cores):
    (result, info line, stderr lines)."""
    log = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = cell_run.run(c, seed, 0.0, trace, "cpu", time.perf_counter(),
                           log=log, control=control, window_ticks=ticks)
    finally:
        torch.set_num_threads(threads)
    lines = log.getvalue().splitlines()
    return res, json.loads(lines[0][len("info "):]), lines
