"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``;
numpy only, so the batches are bitwise the reference's).

Every (step, data_shard) pair maps to a unique, reproducible batch of
tokens via a counter-based PRNG, so any host in a multi-host job can
produce exactly its shard without coordination: restarts and elastic
re-sharding replay identically (the property the resume test pins).  A
Zipf-ish marginal over the vocab makes losses behave like text rather
than uniform noise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.2


def _zipf_cdf(vocab: int, alpha: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, vocab + 1, dtype=np.float64), alpha)
    return np.cumsum(w / w.sum())


class TokenPipeline:
    """Shard-deterministic synthetic token stream."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split into {num_shards} shards")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self._cdf = _zipf_cdf(cfg.vocab, cfg.zipf_alpha)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for `step` on this shard: a pure function of (cfg, step,
        shard)."""
        ss = np.random.SeedSequence(
            [self.cfg.seed, step, self.shard, self.num_shards])
        rng = np.random.default_rng(ss)
        u = rng.random((self.local_batch, self.cfg.seq_len + 1))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        toks = np.clip(toks, 0, self.cfg.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "mask": np.ones((self.local_batch, self.cfg.seq_len),
                                np.float32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
