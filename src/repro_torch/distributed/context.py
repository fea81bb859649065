"""Distribution context: the active mesh for model-internal sharding
hooks (port of ``repro.distributed.context``).

Model code stays pure; when a mesh is active, layers route to their
distributed forms (expert-parallel MoE, tensor-parallel projections).
The port's steps also say how their activations are held:
``batch_local`` when each rank holds its data shard of the batch (the
reference's batch spec shards it), ``seq_sharded`` when each rank holds
its context shard of the KV cache (the cache spec shards S over
"model").
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


def batch_local() -> bool:
    return getattr(_state, "batch_local", False)


def seq_sharded() -> bool:
    return getattr(_state, "seq_sharded", False)


@contextlib.contextmanager
def use_mesh(mesh, *, local_batch: bool = False, local_seq: bool = False):
    prev = (current_mesh(), batch_local(), seq_sharded())
    _state.mesh, _state.batch_local, _state.seq_sharded = (
        mesh, local_batch, local_seq)
    try:
        yield mesh
    finally:
        _state.mesh, _state.batch_local, _state.seq_sharded = prev
