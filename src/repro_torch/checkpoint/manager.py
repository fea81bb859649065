"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``).

The reference's on-disk format, so each package restores the other's
checkpoints:
* step-tagged directories ``step_%010d`` written ATOMICALLY (write to
  ``.tmp-<step>``, fsync the manifest, then ``os.rename``: a crash
  mid-save never corrupts the latest checkpoint);
* a JSON manifest of each leaf's file, shape and dtype, and one ``.npy``
  per leaf, keyed by its path in the tree: dict keys and NamedTuple
  field names joined by ``/`` (``params/embed/table``, ``opt/mu/...``,
  ``opt/step``), a ``None`` leaf (``opt/ef`` without compression)
  holding nothing;
* a bfloat16 leaf is stored as raw 16-bit ``|V2`` items with
  ``"bfloat16"`` in the manifest (what ``np.save`` of an ``ml_dtypes``
  array writes) and read back through a 16-bit integer view, so neither
  side needs ``ml_dtypes``;
* ``restore_latest`` + retention GC + an async (background-thread) mode
  that copies the tree to host memory before the thread starts, so the
  training loop never blocks on I/O and may go on updating its tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve


def _flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` of a tree of dicts and NamedTuples, with the
    reference's keys, dicts in sorted-key order as ``jax.tree_util``
    walks them."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten_with_paths(v, join(k)))
    return flat


def _rebuild(like, flat: Dict[str, Any], prefix: str = ""):
    """``like``'s structure with each leaf taken from ``flat``."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, join(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, flat, join(k))
                            for k, v in zip(like._fields, like)))
    return flat[prefix]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(the array ``np.save`` writes, the manifest's dtype name)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)   # never the live storage
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        host = {k: _to_host(v) for k, v in _flatten_with_paths(tree).items()}
        if self.async_save:
            self.wait()  # one in flight at a time
            self._thread = threading.Thread(
                target=self._save_sync, args=(step, host, extra))
            self._thread.start()
        else:
            self._save_sync(step, host, extra)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _save_sync(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
                   extra: Optional[dict]):
        tmp = os.path.join(self.dir, f".tmp-{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for key, (arr, dtype) in host.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {"file": fname,
                                       "shape": list(arr.shape),
                                       "dtype": dtype}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                out.append(int(d[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any,
                device="cuda") -> Tuple[Any, dict]:
        """Restore into the structure of ``like`` (each leaf in the dtype
        of ``like``'s leaf) on ``device``; returns (tree, extra)."""
        dev = resolve(device)
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        restored = {}
        for key, leaf in _flatten_with_paths(like).items():
            info = manifest["leaves"][key]
            arr = np.load(os.path.join(d, info["file"]))
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"{key}: {arr.shape} vs {tuple(leaf.shape)}")
            restored[key] = _from_file(arr, info["dtype"]).to(
                device=dev, dtype=leaf.dtype)
        return _rebuild(like, restored), manifest["extra"]

    def restore_latest(self, like: Any, device="cuda"):
        step = self.latest_step()
        if step is None:
            return None, None, None
        tree, extra = self.restore(step, like, device)
        return step, tree, extra
