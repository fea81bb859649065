"""One fused-decode horizon bucket: a CUDA graph on the card.

The reference compiles one jit of ``decode_fused_paged`` per bucketed
horizon (``serving/engine.py::_fused_fn``).  The port captures each
bucket once into a CUDA graph and replays it, so the host issues one
graph launch per horizon instead of ~75 launches per layer per step.

A graph holds raw device addresses, so everything it reads or writes
lives at a fixed address: the parameters (never reallocated), the page
pools (``PagedCache.defrag`` permutes them in place; every call checks
the cache's current pools against the captured addresses) and the
static input buffers here, which each call
fills with two copies: the tick's tokens, lengths, ``alive`` mask and
horizon packed into one int32 row, and the block tables.  Capture-time
state is baked in: the TF32 switches and ``eos_id`` must be what they
will be at every replay.

Launch counts: a kernel wrapper counts a launch on the host, which
happens at capture and never at replay.  So the warm-up and capture
leave every count as they found it, the capture's own counts are kept
per graph, and each replay adds them.  ``reset_launches`` clears the
counts, never these records.

On the CPU the same body runs eagerly: no graph, no static buffers.
On CUDA there is no eager fallback: a failed capture or replay raises.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import LAUNCH_COUNTS

Body = Callable[[torch.Tensor, torch.Tensor],
                Tuple[torch.Tensor, torch.Tensor]]

#: eager runs of the body on a side stream before capture (PyTorch's
#: recipe: lazy library set-up and one-time kernel attributes happen
#: here, outside the capture)
WARMUP_RUNS = 2


class FusedGraph:
    """``body(packed, tables) -> (out (2, n_steps, B) int32, lengths)``
    for one bucket, captured on CUDA, run eagerly on the CPU.

    ``packed`` is the (3B + 1,) int32 row ``[tokens | lengths | alive |
    k_active]``; ``out`` stacks ``tokens_out`` over ``emitted``.  On CUDA
    the graph is captured at construction, on inputs whose lanes are all
    inactive (``alive`` 0), so the warm-up only writes the scratch page.
    ``pools`` are the tensors the body writes in place; every call is
    given the cache's current ones and raises unless they are still at
    the same addresses.  ``pool`` is the CUDA graph memory pool the
    capture allocates from.
    """

    def __init__(self, body: Body, n_steps: int, batch: int, nblk: int,
                 device: torch.device, pools: Sequence[torch.Tensor],
                 pool=None):
        self.body = body
        self.n_steps = n_steps
        self.device = device
        self._ptrs = [p.data_ptr() for p in pools]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: (counts dict, kernel name, launches) added on every replay
        self.launches: List[Tuple[Dict[str, int], str, int]] = []
        self.replays = 0
        if device.type == "cuda":
            self._capture(batch, nblk, pool)

    def _snapshot(self) -> List[Dict[str, int]]:
        return [dict(c) for c in LAUNCH_COUNTS]

    def _restore(self, snap: List[Dict[str, int]]) -> None:
        for c, s in zip(LAUNCH_COUNTS, snap):
            c.update(s)

    def _capture(self, batch: int, nblk: int, pool) -> None:
        dev = self.device
        self._host = torch.zeros(3 * batch + 1, dtype=torch.int32,
                                 pin_memory=True)
        self._packed = torch.zeros(3 * batch + 1, dtype=torch.int32,
                                   device=dev)
        self._tables = torch.zeros((batch, nblk), dtype=torch.int32,
                                   device=dev)
        before = self._snapshot()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.body(self._packed, self._tables)
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = self._snapshot()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self._out, self._lengths = self.body(self._packed, self._tables)
        self.launches = [(c, name, c[name] - w[name])
                         for c, w in zip(LAUNCH_COUNTS, warm) for name in c
                         if c[name] != w[name]]
        self._restore(before)

    def __call__(self, packed: np.ndarray, tables: torch.Tensor,
                 pools: Sequence[torch.Tensor]
                 ) -> Tuple[np.ndarray, torch.Tensor]:
        """Run the bucket on this tick's inputs; returns ``out`` on the
        host (the horizon's one fetch) and the lengths on the device."""
        out, lengths = self.launch(packed, tables, pools)
        return out.cpu().numpy(), lengths

    def launch(self, packed: np.ndarray, tables: torch.Tensor,
               pools: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Queue the bucket on this tick's inputs (on the CPU: run it);
        returns ``out`` and the lengths on the device, unfetched."""
        moved = [i for i, (p, ptr) in enumerate(zip(pools, self._ptrs))
                 if p.data_ptr() != ptr]
        if moved:
            raise RuntimeError(f"page pools {moved} moved since the "
                               f"{self.n_steps}-step loop was built")
        if self.graph is None:
            return self.body(torch.from_numpy(packed), tables)
        self._host.numpy()[:] = packed
        self._packed.copy_(self._host, non_blocking=True)
        self._tables.copy_(tables)
        self.graph.replay()
        self.replays += 1
        for c, name, n in self.launches:
            c[name] += n
        return self._out, self._lengths
