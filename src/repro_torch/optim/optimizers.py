"""Optimizers: AdamW (fp32 state) and Adafactor (factored second moment).

Port of ``repro/optim/optimizers.py``, in its functional form: an update
takes the parameters, gradients and state and returns new tensors; nothing
is written in place, so a checkpoint snapshot of the old tensors stays
whole. A tree is a nested dict of tensors with a list per layer stack
(``lm.Model.tree()``; the reference stacks those layers into ``(L, ...)``
leaves). State trees mirror the parameter tree, apart from Adafactor's
``v``, which mirrors the reference's stacked layout; ``state["step"]`` is a
0-d int32 tensor on the CPU, so the bias corrections never wait for the
device.

Adafactor exists because the 671B config cannot hold Adam's 2x fp32 state:
factored v (row/col statistics, O(m+n) per matrix) + bf16 momentum cuts
optimizer bytes from 8x to ~2x params.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List

import torch
from torch.distributed.tensor import DTensor, Replicate


def tree_map(f: Callable, tree, *rest):
    """``f`` over the leaves of ``tree`` (dicts and lists are nodes), with the
    subtrees of ``rest`` at the same paths: a leaf of ``tree`` may face a
    whole subtree in ``rest`` (Adafactor's per-leaf ``{"vr", "vc"}``)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return f(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in the order :func:`tree_map` visits them."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def _field(out, like, i: int):
    """Field ``i`` of the tuples at ``like``'s leaf paths in ``out``."""
    return tree_map(lambda _, o: o[i], like, out)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the fp32
    global norm before scaling)."""
    gn = torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_frac`` of ``base_lr``; a 0-d
    fp32 tensor on ``step``'s device (the CPU for an int)."""
    step = torch.as_tensor(step).float()
    warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params):
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(f32, params), "v": tree_map(f32, params), "step": _step0()}


@torch.no_grad()
def adamw_update(params, grads, state, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    step = state["step"] + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(), state["v"], grads)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, m_, v_):
        u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps) + wd * p.float()
        return (p.float() - lr * u).to(p.dtype)

    return tree_map(upd, params, m, v), {"m": m, "v": v, "step": step}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, bf16 momentum)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _stacked(tree, join=torch.stack):
    """``tree`` with each list (a layer stack: one like subtree per layer)
    turned into one subtree of ``(L, ...)`` leaves, ``join`` of the layers'
    leaves: the reference's layout, whose stacked leaves Adafactor factors
    and RMS-clips whole (a per-layer vector stacks into an (L, d) matrix)."""
    if isinstance(tree, dict):
        return {k: _stacked(v, join) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tree_map(lambda *xs: join(xs), *(_stacked(v, join) for v in tree))
    return tree


def _unstacked(tree, like):
    """The inverse of :func:`_stacked`: ``tree``'s ``(L, ...)`` leaves split
    back into ``like``'s lists."""
    if isinstance(like, dict):
        return {k: _unstacked(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unstacked(tree_map(lambda t: t[i], tree), v)
                          for i, v in enumerate(like))
    return tree


def adafactor_init(params):
    """``m`` mirrors ``params``; ``v`` mirrors their stacked layout
    (:func:`_stacked`), as the reference's does."""
    def init_v(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": z(p.shape[:-1]),                       # row stats
                    "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    shapes = _stacked(params, join=lambda xs: xs[0].expand(len(xs), *xs[0].shape))
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device),
                      params),
        "v": tree_map(init_v, shapes),
        "step": _step0(),
    }


def _reduced(t):
    """A DTensor's pending sums or means (a mean over a sharded dim)
    reduced, its shards kept; a plain tensor as it is. Left pending, the
    factored statistics make the update's elementwise ops reduce them onto
    the layer dim of the stacked leaf, and unstacking it then gathers every
    layer."""
    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


@torch.no_grad()
def adafactor_update(params, grads, state, lr, b1=0.9, decay=0.99, eps=1e-30, wd=0.0):
    """One step over the stacked layout (:func:`_stacked`), so that each
    layer stack is factored and clipped whole, as in the reference."""
    step = state["step"] + 1

    def upd(p, g, m, v):
        g32 = g.float()
        g2 = g32.square() + eps
        if _factored(p.shape):
            vr = _reduced(decay * v["vr"] + (1 - decay) * g2.mean(dim=-1))
            vc = _reduced(decay * v["vc"] + (1 - decay) * g2.mean(dim=-2))
            denom = vr[..., None] / vr.mean(dim=-1, keepdim=True)[..., None] * vc[..., None, :]
            u = g32 * torch.rsqrt(denom + eps)
            new_v = {"vr": vr, "vc": vc}
        else:
            vv = decay * v["v"] + (1 - decay) * g2
            u = g32 * torch.rsqrt(vv + eps)
            new_v = {"v": vv}
        # update clipping (Adafactor's RMS-1 rule)
        rms = torch.sqrt(u.square().mean() + 1e-12)
        u = u / torch.clamp(rms, min=1.0)
        new_m = (b1 * m.float() + (1 - b1) * u).to(torch.bfloat16)
        new_p = (p.float() - lr * (new_m.float() + wd * p.float())).to(p.dtype)
        return new_p, new_m, new_v

    sp = _stacked(params)
    out = tree_map(upd, sp, _stacked(grads), _stacked(state["m"]), state["v"])
    return _unstacked(_field(out, sp, 0), params), {
        "m": _unstacked(_field(out, sp, 1), params), "v": _field(out, sp, 2), "step": step}


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable


def make_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return Optimizer("adamw", adamw_init, adamw_update)
    if name == "adafactor":
        return Optimizer("adafactor", adafactor_init, adafactor_update)
    raise ValueError(name)
