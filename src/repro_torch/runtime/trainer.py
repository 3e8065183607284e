"""Fault-tolerant training driver, on one device or a DeviceMesh.

Port of ``repro/runtime/trainer.py``:

* **Checkpoint/restart** — periodic (async) checkpoints; on (re)start the
  driver restores the latest complete checkpoint and, because the data
  pipeline is a pure function of step (``data/pipeline.py``), replays
  exactly the remaining batches. ``run()`` survives injected step failures.
* **Failure detection** — a pluggable ``failure_hook(step)`` raising
  ``WorkerFailure`` stands in for the real heartbeat/health service; the
  driver treats it like a lost worker: wait for the checkpoint in flight,
  roll back to the newest complete one, rebuild the step, continue.
* **Straggler mitigation** — per-step wall-time EWMA; steps slower than
  ``straggler_factor`` x the EWMA are recorded in ``straggler_steps``. A
  step's time runs up to a synchronize of the device (the reference's
  ``block_until_ready``).

* **Sharding** — with a ``mesh`` the step is the bundle of
  ``launch.steps.make_train_step`` and parameters and optimizer state are
  DTensors laid out by its placements; every rank runs the loop, rank 0
  writes the checkpoints (of the gathered tensors) and every rank reads
  them. ``reshard(new_mesh, ...)`` moves the state onto another mesh
  (elastic scale up/down), as the reference's does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from .. import device as devmod, optim
from ..checkpoint.manager import CheckpointManager
from ..launch import sharding as shd, steps as st
from ..models import api, lm
from ..models.config import ArchConfig, ShapeConfig
from ..optim.optimizers import tree_map


class WorkerFailure(RuntimeError):
    """Raised by the failure hook to simulate a lost worker/preemption."""


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_steps: int = 200
    straggler_factor: float = 3.0
    max_restarts: int = 5
    async_checkpoint: bool = True
    lr: float = 3e-4
    warmup: int = 2000


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        shape: ShapeConfig,
        data,
        tcfg: TrainerConfig,
        failure_hook: Optional[Callable[[int], None]] = None,
        optimizer: Optional[str] = None,
        device=None,
        mesh=None,
    ):
        self.cfg, self.shape, self.data, self.tcfg = cfg, shape, data, tcfg
        self.mesh = mesh
        self.device = devmod.resolve(device if mesh is None else mesh.device_type)
        self.failure_hook = failure_hook
        self.optimizer = optimizer or st.pick_optimizer(cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.metrics: List[Dict[str, Any]] = []
        self.straggler_steps: List[int] = []
        self._build()

    # -- construction -------------------------------------------------------
    def _build(self):
        made = st.make_train_step(
            self.cfg, self.shape, self.mesh, optimizer=self.optimizer,
            lr=self.tcfg.lr, warmup=self.tcfg.warmup,
            total_steps=max(self.tcfg.max_steps, self.tcfg.warmup + 1))
        self.bundle = None if self.mesh is None else made
        self.step_fn = made if self.mesh is None else made.fn

    def _place(self, params: lm.Model, opt_state):
        """(params, opt_state) laid out by the bundle's placements (as they
        are without a mesh)."""
        if self.bundle is None:
            return params, opt_state
        ppl, opl = self.bundle.in_placements[:2]
        tree = shd.place_tree(params.tree(), ppl, self.mesh)
        opt = {k: v if k == "step" else shd.place_tree(v, opl[k], self.mesh)
               for k, v in opt_state.items()}
        return lm.Model(tree, self.cfg), opt

    def _fresh(self, seed: int):
        """Seeded params and a fresh optimizer state, as plain tensors."""
        params = api.init_params(self.cfg, torch.Generator(self.device).manual_seed(seed))
        return params, optim.make_optimizer(self.optimizer).init(params.tree())

    def init_state(self, seed: int = 0):
        return self._place(*self._fresh(seed))

    # -- elastic ------------------------------------------------------------
    def reshard(self, new_mesh, params: lm.Model, opt_state):
        """Move to a different mesh (elastic scale up/down): rebuild the
        step for ``new_mesh`` and lay params and optimizer state out by its
        placements."""
        tree, opt = _gathered(params.tree()), _gathered(opt_state)
        self.mesh = new_mesh
        self._build()
        return self._place(lm.Model(tree, self.cfg), opt)

    def _save(self, step: int, params: lm.Model, opt_state):
        tree, opt = params.tree(), opt_state
        if self.mesh is not None:
            tree, opt = _gathered(tree), _gathered(opt)   # collectives: every rank
            if dist.get_rank() != 0:
                return
        save = self.ckpt.save_async if self.tcfg.async_checkpoint else self.ckpt.save
        save(step, tree, opt, extra={"data": {"step": step}})

    def _sync_checkpoints(self):
        """Wait for this process's checkpoint writes; with a mesh of more
        than one rank, for rank 0's too (every rank then sees the same
        newest checkpoint)."""
        self.ckpt.wait()
        if self.mesh is not None and self.mesh.size() > 1:
            dist.barrier()

    # -- main loop ----------------------------------------------------------
    def run(self, seed: int = 0):
        restarts = 0
        while True:
            try:
                return self._run_once(seed)
            except WorkerFailure as e:
                restarts += 1
                if restarts > self.tcfg.max_restarts:
                    raise RuntimeError(f"exceeded max restarts: {e}") from e
                self.metrics.append({"event": "restart", "cause": str(e)})
                # quiesce in-flight async checkpoint writes before restoring,
                # or the restart can race the newest checkpoint's commit and
                # silently resume from an older step
                self._sync_checkpoints()
                self._build()   # a fresh step (new workers)

    def _run_once(self, seed: int):
        # restore or init; a fresh init gives the restore its shapes, dtypes
        # and device
        self._sync_checkpoints()
        params, opt_state = self._fresh(seed)
        start = 0
        if self.ckpt.latest_step() is not None:
            tree, opt_state, step0, _extra = self.ckpt.restore(params.tree(), opt_state)
            params = lm.Model(tree, self.cfg)
            start = step0 + 1
        params, opt_state = self._place(params, opt_state)

        ewma = None
        for step in range(start, self.tcfg.max_steps):
            t0 = time.time()   # whole-iteration time: data + step + sync
            if self.failure_hook is not None:
                self.failure_hook(step)      # may raise WorkerFailure
            batch = st.batch_to(self.data.batch_at(step), self.device)
            params, opt_state, metrics = self.step_fn(params, opt_state, batch, step)
            devmod.synchronize(self.device)
            dt = time.time() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > self.tcfg.straggler_factor * ewma and step > start + 3:
                self.straggler_steps.append(step)
            self.metrics.append(
                {"step": step, "loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"]), "dt": dt}
            )
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == self.tcfg.max_steps:
                self._save(step, params, opt_state)
        self._sync_checkpoints()
        return params, opt_state


def _gathered(tree):
    """``tree`` with each DTensor leaf gathered whole (a collective: every
    rank of its mesh calls it)."""
    return tree_map(shd.gather, tree)
