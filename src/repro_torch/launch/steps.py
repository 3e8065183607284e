"""Train and serve steps, one-device or sharded over a DeviceMesh.

Port of ``repro/launch/steps.py``. ``make_train_step(cfg, shape, mesh)``
and ``make_serve_step(cfg, shape, mesh, kind)`` return a
:class:`StepBundle`: the step function, the DTensor placements of its
inputs and outputs (the reference's ``in_shardings``/``out_shardings``,
from the same rules: ``launch/sharding.py``), meta-device stand-ins for its
arguments (nothing allocated) and the arguments it may donate.

The bundle's ``fn`` plays the part of the reference's ``jax.jit(fn,
in_shardings, out_shardings)``: it puts each argument on the mesh by its
placements (a plain tensor is distributed, a DTensor redistributed when its
placements differ), runs the step on DTensors under the mesh hints
(``models.layers.mesh_hints``), and lays its outputs out by their
placements. Sharding propagation over DTensor ops does what GSPMD does in
the reference; a plain tensor an op meets (a position ramp, a mask) counts
as replicated, the same on every rank. The mesh needs an initialised
process group (``launch/mesh.py``); there is no fallback to one device.

``make_train_step(cfg, shape)`` without a mesh is the one-device step the
trainer and ``launch/train.py`` use: a plain function on plain tensors.

Either step takes the model (``lm.Model``) and returns a new one on the
updated tensors, as the reference returns new params: nothing the caller
holds is written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from .. import optim
from ..models import api, layers as mlayers, lm
from ..models.config import ArchConfig, ShapeConfig
from ..optim.optimizers import tree_leaves, tree_map
from . import sharding as shd
from .mesh import axis_sizes


def pick_optimizer(cfg: ArchConfig) -> str:
    """671B-class models can't hold fp32 Adam state: use the factored
    optimizer."""
    return "adafactor" if cfg.n_params() > 100e9 else "adamw"


@dataclasses.dataclass
class StepBundle:
    fn: Any                      # (params/opt/batch...) -> ..., on the mesh
    in_placements: Any           # a placements tuple per argument leaf
    out_placements: Any
    abstract_args: Tuple         # meta tensors matching fn's signature
    donate_argnums: Tuple = ()
    in_specs: Any = None         # the specs the placements come from
    out_specs: Any = None


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta: ``api.init_params`` makes its
    tensors where the generator lives, so with this one it allocates
    nothing."""

    @property
    def device(self):
        return torch.device("meta")


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16) -> lm.Model:
    """The model's parameters as meta tensors (shapes and dtypes only)."""
    return api.init_params(cfg, _MetaGenerator(), dtype)


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
    without a backward) would otherwise train those weights as zero.

    A DTensor gradient comes back laid out as its parameter (a partial sum
    over the batch's shards reduced and scattered, as FSDP does), so the
    optimizer's elementwise update sees each element's whole gradient:
    left partial, its terms would be reduced after the update's division,
    and where they cancel, their rounding would move the parameter."""
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
    it = iter(g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor) else g
              for g, p in zip(grads, leaves))
    return loss.detach(), tree_map(lambda _: next(it), tree)


def _structure(tree):
    """``tree``'s nesting with its leaves left out."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _opt_specs(opt_abs, pspecs):
    """Optimizer state sharding: `m` mirrors params (ZeRO); `v` mirrors
    params for AdamW, or is replicated for Adafactor's factored row/col
    stats (O(m+n) per matrix; the port keeps Adafactor's `v` in the
    reference's stacked layout, so it mirrors nothing and replicates)."""
    out = {}
    for k, sub in opt_abs.items():
        if k == "step":
            out[k] = shd.Spec()
        elif _structure(sub) == _structure(pspecs):
            out[k] = pspecs
        else:
            out[k] = tree_map(lambda t: shd.Spec(*([None] * t.dim())), sub)
    return out


def _dict_specs(batch_abs, bspecs):
    return {k: bspecs.get(k, shd.Spec(*([None] * v.dim()))) for k, v in batch_abs.items()}


def _placed_model(model: lm.Model, pl, mesh) -> lm.Model:
    """``model`` with every parameter laid out by ``pl`` (the model itself
    when they all are already)."""
    tree = model.tree()
    # (a placements tuple is a node to tree_leaves: match along the tree)
    ok = tree_map(lambda t, p: isinstance(t, DTensor) and tuple(t.placements) == p, tree, pl)
    if all(tree_leaves(ok)):
        return model
    return lm.Model(shd.place_tree(tree, pl, mesh), model.cfg,
                    requires_grad=any(p.requires_grad for p in model.parameters()))


def _placed_opt(opt_state, pl, mesh):
    """The optimizer state on the mesh; ``step`` stays the host counter."""
    return {k: v if k == "step" else shd.place_tree(v, pl[k], mesh) for k, v in opt_state.items()}


def _step_fn(cfg: ArchConfig, opt, mb: int, lr: float, warmup: int, total_steps: int):
    """The step on whatever tensors it is given (plain or DTensors)."""

    def train_step(model: lm.Model, opt_state, batch, step):
        if mb > 1:
            # gradient accumulation over microbatches (the reference's
            # lax.scan, steps.py:94); grads in f32
            def accumulate(carry, i):
                gsum, lsum = carry
                lv, g = value_and_grad(cfg, model, {k: v.chunk(mb)[i] for k, v in batch.items()})
                g32 = tree_map(lambda a: a.float(), g)
                return (g32 if gsum is None else tree_map(torch.add, gsum, g32), lsum + lv), None

            (gsum, lsum), _ = mlayers.scan(accumulate, (None, 0.0), mb)
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


def make_train_step(
    cfg: ArchConfig,
    shape: ShapeConfig,
    mesh=None,
    optimizer: Optional[str] = None,
    lr: float = 3e-4,
    warmup: int = 2000,
    total_steps: int = 100_000,
    microbatches: Optional[int] = None,
):
    """With a mesh, a :class:`StepBundle` whose ``fn(model, opt_state,
    batch, step) -> (model, opt_state, metrics)`` runs on the mesh
    (metrics as plain tensors, the same on every rank). Without one, that
    step function itself, on one device: ``batch`` holds tensors on the
    model's device."""
    opt = optim.make_optimizer(optimizer or pick_optimizer(cfg))
    mb = microbatches if microbatches is not None else default_microbatches(cfg, shape)
    step_fn = _step_fn(cfg, opt, mb, lr, warmup, total_steps)
    if mesh is None:
        return step_fn

    params_abs = abstract_params(cfg)
    opt_abs = opt.init(params_abs.tree())
    pspecs = shd.param_specs(params_abs, mesh)
    ospecs = _opt_specs(opt_abs, pspecs)
    batch_abs = api.train_input_specs(cfg, shape)
    bspecs = _dict_specs(batch_abs, shd.batch_specs(cfg, mesh))
    in_specs = (pspecs, ospecs, bspecs, shd.Spec())
    out_specs = (pspecs, ospecs, shd.Spec())
    to_pl = lambda tree: shd.to_placements_tree(tree, mesh)
    ppl, opl, bpl = to_pl(pspecs), to_pl(ospecs), to_pl(bspecs)

    def train_step(model, opt_state, batch, step):
        model = _placed_model(model, ppl, mesh)
        opt_state = _placed_opt(opt_state, opl, mesh)
        batch = shd.place_tree(batch, bpl, mesh)
        with implicit_replication(), mlayers.mesh_hints(mesh):
            new_model, new_opt, metrics = step_fn(model, opt_state, batch, step)
        return (_placed_model(new_model, ppl, mesh), _placed_opt(new_opt, opl, mesh),
                {k: shd.gather(v).detach() for k, v in metrics.items()})

    return StepBundle(
        fn=train_step,
        in_placements=(ppl, opl, bpl, to_pl(shd.Spec())),
        out_placements=(ppl, opl, to_pl(shd.Spec())),
        abstract_args=(params_abs, opt_abs, batch_abs, torch.empty((), dtype=torch.int32,
                                                                   device="meta")),
        donate_argnums=(0, 1),
        in_specs=in_specs,
        out_specs=out_specs,
    )


def make_serve_step(cfg: ArchConfig, shape: ShapeConfig, mesh, kind: str) -> StepBundle:
    """kind: 'decode' (one token vs deep cache) or 'prefill'.

    decode: ``fn(model, cache, tokens (B, 1), pos) -> (logits, cache)``;
    prefill: ``fn(model, {"tokens" or "frames": ...}, cache) -> (logits,
    cache)``. The cache comes back as DTensors laid out by its specs (the
    argument's own tensors when they were on the mesh already: a step
    writes the cache in place, as the one-device path does); logits come
    back as a DTensor."""
    params_abs = abstract_params(cfg)
    pspecs = shd.param_specs(params_abs, mesh)
    ppl = shd.to_placements_tree(pspecs, mesh)
    B, S = shape.global_batch, shape.seq_len
    sizes = axis_sizes(mesh)
    dp_ax, dp_total = shd.dp_entry(mesh), shd.dp_total(mesh)
    vocab_ax = "model" if cfg.vocab % sizes["model"] == 0 else None
    cache_abs = api.init_cache(cfg, B, S, device="meta")
    cspecs = shd.cache_specs(cfg, cache_abs, mesh, B)
    cpl = shd.to_placements_tree(cspecs, mesh)
    to_pl = lambda s: shd.to_placements(s, mesh)

    def run(fn, model, cache, *args):
        model = _placed_model(model, ppl, mesh)
        cache = shd.place_tree(cache, cpl, mesh)
        with torch.no_grad(), implicit_replication(), mlayers.mesh_hints(mesh):
            logits, cache = fn(model, cache, *args)
        return logits, cache

    if kind == "decode":
        tok_spec = shd.Spec(dp_ax, None) if B % dp_total == 0 else shd.Spec(None, None)
        logit_spec = shd.Spec(tok_spec[0], None, vocab_ax)
        tok_abs = torch.empty((B, 1), dtype=torch.int32, device="meta")
        pos_abs = torch.empty((), dtype=torch.int32, device="meta")

        def serve_step(model, cache, tokens, pos):
            tokens = shd.place(tokens, to_pl(tok_spec), mesh)
            logits, cache = run(lambda m, c: api.decode_step(cfg, m, c, tokens, int(pos)),
                                model, cache)
            return shd.place(logits, to_pl(logit_spec), mesh), cache

        in_specs = (pspecs, cspecs, tok_spec, shd.Spec())
        out_specs = (logit_spec, cspecs)
        return StepBundle(serve_step, (ppl, cpl, to_pl(tok_spec), to_pl(shd.Spec())),
                          (to_pl(logit_spec), cpl), (params_abs, cache_abs, tok_abs, pos_abs),
                          donate_argnums=(1,), in_specs=in_specs, out_specs=out_specs)
    if kind != "prefill":
        raise ValueError(f"kind must be 'prefill' or 'decode', got {kind!r}")

    inp_abs = api.prefill_input_specs(cfg, shape)
    bspec = shd.Spec(dp_ax, None) if B % dp_total == 0 else shd.Spec(None, dp_ax)
    inp_specs = {k: bspec if k == "tokens" else shd.Spec(bspec[0], None, None)
                 for k in inp_abs}
    logit_spec = shd.Spec(None if B % dp_total else dp_ax, None, vocab_ax)

    def prefill_step(model, inputs, cache):
        inputs = {k: shd.place(v, to_pl(inp_specs[k]), mesh) for k, v in inputs.items()}
        arg = inputs.get("tokens", inputs.get("frames"))
        logits, cache = run(lambda m, c: api.prefill(cfg, m, arg, c), model, cache)
        return shd.place(logits, to_pl(logit_spec), mesh), cache

    in_specs = (pspecs, inp_specs, cspecs)
    out_specs = (logit_spec, cspecs)
    return StepBundle(prefill_step,
                      (ppl, {k: to_pl(s) for k, s in inp_specs.items()}, cpl),
                      (to_pl(logit_spec), cpl), (params_abs, inp_abs, cache_abs),
                      donate_argnums=(2,), in_specs=in_specs, out_specs=out_specs)
