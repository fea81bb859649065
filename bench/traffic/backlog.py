"""A closed backlog: an offline batch job that keeps a server at capacity.

The mix file gives the prompt and output length distributions and the
backlog depth::

    {"generator": "backlog", "min_waiting": 32, "pool": 1024, "strata": 16,
     "prompt_len": {"median": 256, "sigma": 0.7, "min": 32, "max": 1024},
     "output_len": {"median": 512, "sigma": 0.7, "min": 64, "max": 2048},
     "open_when_active": "full"}

Lengths are lognormal (log-space ``sigma``, centred by its ``median`` or
by its ``mean``, ``median = mean exp(-sigma^2 / 2)``), clipped to
``[min, max]``.  Every seed gets the same ``pool`` lengths, the
stratified quantiles ``(i + 0.5) / pool`` of the distribution, in an
order drawn from the seed: a seed changes which request comes when and
the prompt token ids, never the amount of work.  The order is balanced:
the sorted pool is cut into ``strata`` runs of consecutive quantiles,
and each block of ``strata`` requests in the stream takes one length of
every run, so any stretch of the stream holds nearly the same lengths
whatever the seed.  Prompt and output lengths are ordered apart.  The
stream repeats the pool, each pass in a fresh order, so it never runs
dry.

Every request is due at once (arrival 0); the harness keeps at least
``min_waiting`` of them queued ahead of the server.  The window opens
once ``open_when_active`` requests hold a slot (``"full"``: every slot).
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, Iterator, List, Tuple

import numpy as np

Request = Tuple[int, np.ndarray, int]     # (rid, prompt ids, output len)


def lengths(dist: Dict[str, float], n: int) -> np.ndarray:
    """The ``n`` stratified quantiles of a clipped lognormal, ascending."""
    nd = NormalDist()
    sigma = float(dist["sigma"])
    mu = (math.log(dist["median"]) if "median" in dist
          else math.log(dist["mean"]) - sigma * sigma / 2)
    q = [math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    out = np.rint(np.asarray(q)).astype(np.int64)
    return np.clip(out, int(dist["min"]), int(dist["max"]))


def balanced(sorted_lens: np.ndarray, strata: int,
             rng: np.random.Generator) -> np.ndarray:
    """``sorted_lens`` in blocks of ``strata``, one of each stratum a
    block, both the assignment and the order within a block drawn from
    ``rng``."""
    n = len(sorted_lens)
    blocks = n // strata
    if blocks * strata != n:
        raise ValueError(f"pool {n} is not a multiple of strata {strata}")
    table = sorted_lens.reshape(strata, blocks)       # stratum x block
    cols = np.stack([row[rng.permutation(blocks)] for row in table])
    out = [cols[rng.permutation(strata), b] for b in range(blocks)]
    return np.concatenate(out)


def max_context(params: Dict) -> int:
    """Longest prompt plus longest output the mix can send."""
    return int(params["prompt_len"]["max"]) + int(params["output_len"]["max"])


def max_output(params: Dict) -> int:
    return int(params["output_len"]["max"])


class Stream:
    """Requests in the order of ``seed``, with prompts of ids in
    ``[0, vocab)``."""

    def __init__(self, params: Dict, vocab: int, seed: int):
        self.params = params
        self.vocab = int(vocab)
        self.pool = int(params["pool"])
        self.strata = int(params.get("strata", 1))
        self.prompt_lens = lengths(params["prompt_len"], self.pool)
        self.output_lens = lengths(params["output_len"], self.pool)
        self.seed = int(seed)
        self._it = self._requests()

    def _requests(self) -> Iterator[Request]:
        rid = 0
        for rep in range(1 << 30):
            rng = np.random.default_rng([self.seed, rep])
            prompts = balanced(self.prompt_lens, self.strata, rng)
            outputs = balanced(self.output_lens, self.strata, rng)
            for i in range(self.pool):
                prompt = rng.integers(0, self.vocab, size=int(prompts[i]),
                                      dtype=np.int64).astype(np.int32)
                yield rid, prompt, int(outputs[i])
                rid += 1

    def take(self, n: int) -> List[Request]:
        return [next(self._it) for _ in range(n)]
