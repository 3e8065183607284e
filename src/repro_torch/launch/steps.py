"""The training step: value-and-grad of ``api.loss_fn``, then the update.

Port of ``repro/launch/steps.py::make_train_step`` for one device: gradient
accumulation over microbatches in fp32, ``clip_by_global_norm(1.0)``, the
cosine schedule and the optimizer update, returning the metrics
``{loss, grad_norm, lr}``. The reference's step returns shardings and
abstract inputs for ``jax.jit`` (``StepBundle``); here the step is a plain
function, and there is no mesh. ``make_serve_step`` and the dry-run's
abstract specs are not ported (ROADMAP.md): serving is ``launch/serve.py``.

A step takes the model (``lm.Model``) and returns a new one on the updated
tensors, as the reference returns new params: nothing the caller holds is
written in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import optim
from ..models import api, lm
from ..models.config import ArchConfig, ShapeConfig
from ..optim.optimizers import tree_leaves, tree_map


def pick_optimizer(cfg: ArchConfig) -> str:
    """671B-class models can't hold fp32 Adam state: use the factored
    optimizer."""
    return "adafactor" if cfg.n_params() > 100e9 else "adamw"


def default_microbatches(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Gradient-accumulation factor: large-activation cells (MoE / huge
    models at 1M-token batches) split the batch so per-layer residuals fit."""
    tokens = shape.global_batch * shape.seq_len
    if cfg.n_params() > 100e9 or (cfg.n_experts and tokens > 262_144):
        return min(16, max(1, shape.global_batch // 16))
    return 1


def batch_to(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch (``data.pipeline``) as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def value_and_grad(cfg: ArchConfig, model: lm.Model, batch):
    """(loss, gradient tree mirroring ``model.tree()``). Raises if a
    parameter gets no gradient: a path that leaves autograd (a kernel
    without a backward) would otherwise train those weights as zero."""
    tree = model.tree()
    leaves = tree_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    loss = api.loss_fn(cfg, model, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    names = [n for n, _ in model.named_parameters()]
    missing = [n for n, g in zip(names, grads) if g is None]
    if missing:
        raise RuntimeError(f"no gradient reaches {len(missing)} parameter(s): {missing[:8]}")
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), tree)


def make_train_step(
    cfg: ArchConfig,
    shape: ShapeConfig,
    optimizer: Optional[str] = None,
    lr: float = 3e-4,
    warmup: int = 2000,
    total_steps: int = 100_000,
    microbatches: Optional[int] = None,
) -> Callable:
    """``train_step(model, opt_state, batch, step) -> (model, opt_state,
    metrics)``; ``batch`` holds tensors on the model's device."""
    opt = optim.make_optimizer(optimizer or pick_optimizer(cfg))
    mb = microbatches if microbatches is not None else default_microbatches(cfg, shape)

    def train_step(model: lm.Model, opt_state, batch, step):
        if mb > 1:
            # gradient accumulation over microbatches; grads in f32
            gsum, lsum = None, 0.0
            for i in range(mb):
                micro = {k: v.chunk(mb)[i] for k, v in batch.items()}
                lv, g = value_and_grad(cfg, model, micro)
                g32 = tree_map(lambda a: a.float(), g)
                gsum = g32 if gsum is None else tree_map(torch.add, gsum, g32)
                lsum = lsum + lv
            grads = tree_map(lambda g: g / mb, gsum)
            lvalue = lsum / mb
        else:
            lvalue, grads = value_and_grad(cfg, model, batch)
        grads, gnorm = optim.clip_by_global_norm(grads, 1.0)
        lr_t = optim.cosine_schedule(step, lr, warmup, total_steps)
        new_tree, new_opt = opt.update(model.tree(), grads, opt_state, lr_t)
        metrics = {"loss": lvalue, "grad_norm": gnorm, "lr": lr_t}
        return lm.Model(new_tree, cfg, requires_grad=True), new_opt, metrics

    return train_step
