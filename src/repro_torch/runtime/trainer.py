"""Fault-tolerant training driver, on one device.

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

The reference's ``reshard`` (elastic re-lowering onto a new mesh) has no
counterpart on one card and is not ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import device as devmod, optim
from ..checkpoint.manager import CheckpointManager
from ..launch import steps as st
from ..models import api, lm
from ..models.config import ArchConfig, ShapeConfig


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
    ):
        self.cfg, self.shape, self.data, self.tcfg = cfg, shape, data, tcfg
        self.device = devmod.resolve(device)
        self.failure_hook = failure_hook
        self.optimizer = optimizer or st.pick_optimizer(cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.metrics: List[Dict[str, Any]] = []
        self.straggler_steps: List[int] = []
        self._build()

    # -- construction -------------------------------------------------------
    def _build(self):
        self.step_fn = st.make_train_step(
            self.cfg, self.shape, optimizer=self.optimizer,
            lr=self.tcfg.lr, warmup=self.tcfg.warmup,
            total_steps=max(self.tcfg.max_steps, self.tcfg.warmup + 1))

    def init_state(self, seed: int = 0):
        params = api.init_params(self.cfg, torch.Generator(self.device).manual_seed(seed))
        return params, optim.make_optimizer(self.optimizer).init(params.tree())

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
                self.ckpt.wait()
                self._build()   # a fresh step (new workers)

    def _run_once(self, seed: int):
        # restore or init; a fresh init gives the restore its shapes, dtypes
        # and device
        params, opt_state = self.init_state(seed)
        start = 0
        if self.ckpt.latest_step() is not None:
            tree, opt_state, step0, _extra = self.ckpt.restore(params.tree(), opt_state)
            params = lm.Model(tree, self.cfg)
            start = step0 + 1

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
                save = self.ckpt.save_async if self.tcfg.async_checkpoint else self.ckpt.save
                save(step, params.tree(), opt_state, extra={"data": {"step": step}})
        self.ckpt.wait()
        return params, opt_state
