"""Atomic, asynchronous checkpointing, in the reference's on-disk format.

Port of ``repro/checkpoint/manager.py``:

* Each checkpoint is a directory ``step_<k>/`` holding one ``.npy`` per
  tree leaf (``params__layers__0__attn__q.npy`` for the leaf at
  ``params/layers/0/attn/q``) plus ``manifest.json`` (each leaf's file,
  shape and dtype, the step, extra state). A checkpoint only "exists" once
  its directory is renamed into place (atomic commit: torn writes are never
  visible).
* ``save_async`` snapshots to host memory synchronously and writes on a
  background thread. The snapshot is a copy (``to("cpu", copy=True)``): on
  the CPU, ``t.cpu()`` returns the same storage, so a snapshot of a tensor
  later updated in place would be torn.
* numpy has no bf16 and the card's host has no ``ml_dtypes``: a bf16 leaf is
  stored as fp32 with its dtype recorded, as the reference does, and cast
  back through torch on restore (bf16 -> fp32 -> bf16 is exact).
* ``keep`` rotates old checkpoints; the latest complete one wins on restore.

A tree is a nested dict (or list) of tensors (``lm.Model.tree()`` for a
model). Leaves are stored whole, so a restore may target any device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..optim.optimizers import tree_map


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(``a/b/0/c`` path, leaf) pairs in :func:`tree_map` order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [kv for k, v in items
            for kv in _flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k))]


def _host_copy(leaf) -> torch.Tensor:
    """A CPU copy of a leaf that nothing else writes."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """What lands on disk: numpy's own dtypes as they are, anything numpy
    cannot hold (bf16, fp8) upcast to fp32."""
    try:
        return t.numpy()
    except TypeError:
        return t.float().numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, params, opt_state, extra: Optional[Dict] = None):
        self.wait()
        self._save_sync(step, self._snapshot(params), self._snapshot(opt_state), extra or {})

    def save_async(self, step: int, params, opt_state, extra: Optional[Dict] = None):
        """Snapshot to host now; write in the background."""
        self.wait()
        p_host = self._snapshot(params)
        o_host = self._snapshot(opt_state)
        self._thread = threading.Thread(
            target=self._save_sync, args=(step, p_host, o_host, extra or {}), daemon=True
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _snapshot(tree):
        return tree_map(_host_copy, tree)

    def _save_sync(self, step, params, opt_state, extra):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": {}, "time": time.time()}
        for name, tree in (("params", params), ("opt", opt_state)):
            flat = _flatten_with_paths(tree)
            manifest[f"{name}_treedef"] = [key for key, _ in flat]
            for key, leaf in flat:
                fn = f"{name}__{key.replace('/', '__')}.npy"
                np.save(os.path.join(tmp, fn), _to_numpy(leaf))
                manifest["leaves"][f"{name}/{key}"] = {
                    "file": fn,
                    "shape": list(leaf.shape),
                    "dtype": str(leaf.dtype).removeprefix("torch."),
                }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                os.path.join(self.dir, d, "manifest.json")
            ):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, params_like, opt_like, step: Optional[int] = None):
        """Restore onto trees shaped like (params_like, opt_like): each leaf in
        its saved dtype, on the like leaf's device. Returns (params,
        opt_state, step, extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        def load_tree(name, like):
            leaves = iter(_flatten_with_paths(like))

            def load(leaf):
                key, _ = next(leaves)
                meta = manifest["leaves"][f"{name}/{key}"]
                t = torch.from_numpy(np.load(os.path.join(d, meta["file"])))
                if list(t.shape) != list(leaf.shape):
                    raise ValueError(f"shape mismatch for {key}: {tuple(t.shape)} vs "
                                     f"{tuple(leaf.shape)}")
                return t.to(leaf.device, getattr(torch, meta["dtype"]))

            return tree_map(load, like)

        params = load_tree("params", params_like)
        opt = load_tree("opt", opt_like)
        return params, opt, step, manifest.get("extra", {})
