"""Sharding rules: map every parameter / optimizer / batch / cache leaf to a
:class:`Spec` for the mesh, and a spec to DTensor placements.

Port of ``repro/launch/sharding.py``, rule for rule. Strategy:

* TP over 'model': attention heads, FFN hidden, vocab, MoE experts (EP),
  Mamba inner channels.
* FSDP over 'data' (+'pod'): the remaining large axis of every weight.
* DP over 'pod'+'data' for the batch.
* decode caches: batch over 'data' when batch >= mesh data size, else
  sequence over 'data' (long_500k SP); kv-heads/inner dim over 'model'.

Rules are path-regex -> spec-template. The reference's trees hold each
layer stack as one ``(L, ...)`` leaf; the port holds one tensor per layer
(``api.STACKED``: a list per stack). A per-layer leaf gets the spec of the
stacked leaf it belongs to, with the layer axis's entry dropped (that entry
is always None: the rules never shard the layer axis). The rules read only
the mesh's axis names and sizes, so they take a DeviceMesh (a fake process
group's will do) and allocate nothing.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from ..models.config import ArchConfig
from ..models.api import STACKED
from ..optim.optimizers import tree_map
from .mesh import axis_sizes


class Spec:
    """One entry per tensor dimension: None (replicated), a mesh axis name,
    or a tuple of axis names (the dimension split over their product). The
    counterpart of jax's ``PartitionSpec``; it is not a tuple, so the
    tree functions (``optim.optimizers.tree_map``) take it for a leaf."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts: Tuple = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        if isinstance(other, Spec):
            return self.parts == other.parts
        return isinstance(other, tuple) and self.parts == other

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"Spec{self.parts!r}"


def dp_entry(mesh) -> Any:
    """The spec entry of the data-parallel axes: "data", or ("pod", "data")."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return axes if len(axes) > 1 else axes[0]


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


# (regex over "/"-joined path, spec builder given dp)
# Specs are written for the *unstacked* leaf; a leading layer axis (detected
# by ndim mismatch) gets None prepended automatically.
_RULES = [
    # embeddings / heads
    (r"(^|/)embed$", lambda dp: ("model", dp)),
    (r"(^|/)tok_embed$", lambda dp: ("model", dp)),
    (r"(^|/)lm_head$", lambda dp: (dp, "model")),
    # attention (GQA)
    (r"/attn/q$|/self_attn/q$|/cross_attn/q$", lambda dp: (dp, "model")),
    (r"/attn/k$|/self_attn/k$|/cross_attn/k$", lambda dp: (dp, "model")),
    (r"/attn/v$|/self_attn/v$|/cross_attn/v$", lambda dp: (dp, "model")),
    (r"/attn/o$|/self_attn/o$|/cross_attn/o$", lambda dp: ("model", dp)),
    # attention (MLA)
    (r"/attn/q_down$", lambda dp: (dp, "model")),
    (r"/attn/q_up$", lambda dp: (dp, "model")),
    (r"/attn/kv_down$", lambda dp: (dp, None)),
    (r"/attn/kv_up$", lambda dp: (dp, "model")),
    (r"/attn/q_norm$|/attn/kv_norm$", lambda dp: (None,)),
    # MLPs
    (r"/mlp/w_gate$|/mlp/w_up$", lambda dp: (dp, "model")),
    (r"/mlp/w_down$", lambda dp: ("model", dp)),
    # MoE
    (r"/moe/router$", lambda dp: (dp, None)),
    (r"/moe/w_gate$|/moe/w_up$", lambda dp: ("model", dp, None)),
    (r"/moe/w_down$", lambda dp: ("model", None, dp)),
    (r"/moe/shared/w_gate$|/moe/shared/w_up$", lambda dp: (dp, "model")),
    (r"/moe/shared/w_down$", lambda dp: ("model", dp)),
    # Mamba
    (r"/ssm/in_proj$", lambda dp: (dp, "model")),
    (r"/ssm/conv_w$", lambda dp: (None, "model")),
    (r"/ssm/conv_b$", lambda dp: ("model",)),
    (r"/ssm/x_proj$", lambda dp: ("model", None)),
    (r"/ssm/dt_proj$", lambda dp: (None, "model")),
    # per-channel scalars (A_log, dt_bias, D) are tiny: replicate — their
    # stacked ranks differ between mamba1/mamba2 so axis-mapping is ambiguous
    (r"/ssm/dt_bias$|/ssm/A_log$|/ssm/D$", lambda dp: (None,)),
    (r"/ssm/norm_g$", lambda dp: ("model",)),
    (r"/ssm/out_proj$", lambda dp: ("model", dp)),
    # MTP
    (r"/mtp/proj$", lambda dp: (dp, "model")),
    # norms & everything 1-D per-feature
    (r"ln|norm", lambda dp: (None,)),
]


def _spec_for(path: str, ndim: int, dp) -> Spec:
    for pat, builder in _RULES:
        if re.search(pat, path):
            parts = list(builder(dp))
            # mamba2 A_log/dt_bias/D are (H,) not (di,N): adjust rank
            if len(parts) > ndim:
                parts = parts[:ndim] if ndim > 0 else []
            while len(parts) < ndim:
                parts.insert(0, None)      # stacked layer axis etc.
            return Spec(*parts)
    # default: replicate
    return Spec(*([None] * ndim))


def _divisible(shape, spec: Spec, sizes: Dict[str, int]) -> Spec:
    """``spec`` with each axis entry that does not divide its dimension
    dropped (uneven sharding is legal but wasteful)."""
    parts = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        total = math.prod(sizes[a] for a in _axes(ax))
        parts.append(ax if ax is not None and dim % total == 0 else None)
    return Spec(*parts)


def _leaf_specs(tree, fn, path=""):
    """``fn(path, leaf, layers)`` over ``tree``: the path has the reference's
    keys ("layers/attn/q": no layer index) and ``layers`` is the depth of the
    stack the leaf belongs to (0 outside one)."""
    def walk(t, p, layers):
        if isinstance(t, dict):
            return {k: walk(v, f"{p}/{k}" if p else k, layers) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, p, len(t)) for v in t)
        return fn(p, t, layers)
    return walk(tree, path, 0)


def param_specs(params, mesh) -> Any:
    """A spec per leaf of ``params`` (a model or its ``tree()``): the
    stacked reference leaf's spec, its layer entry dropped for a per-layer
    leaf."""
    tree = params.tree() if hasattr(params, "tree") else params
    dp, sizes = dp_entry(mesh), axis_sizes(mesh)

    def leaf_spec(path, leaf, layers):
        shape = ((layers,) if layers else ()) + tuple(leaf.shape)
        spec = _divisible(shape, _spec_for(path, len(shape), dp), sizes)
        if layers:
            if spec[0] is not None:
                raise ValueError(f"{path}: a rule shards the layer axis ({spec})")
            spec = Spec(*spec.parts[1:])
        return spec

    for key in tree:
        if key not in STACKED and isinstance(tree[key], (list, tuple)):
            raise ValueError(f"{key}: a layer list outside {STACKED}")
    return _leaf_specs(tree, leaf_spec)


def batch_specs(cfg: ArchConfig, mesh) -> Dict[str, Spec]:
    dp = dp_entry(mesh)
    out = {"tokens": Spec(dp, None)}
    if cfg.family == "audio":
        out["frames"] = Spec(dp, None, None)
    return out


def dp_total(mesh) -> int:
    """The number of devices the data-parallel axes span."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(dp_entry(mesh)))


def cache_specs(cfg: ArchConfig, cache_shapes, mesh, batch: int) -> Any:
    """cache_shapes: a cache tree (``api.init_cache``; meta tensors do)."""
    dp = dp_entry(mesh)
    sizes = axis_sizes(mesh)
    batch_sharded = batch % dp_total(mesh) == 0

    def leaf_spec(p, leaf, _layers):
        shape = tuple(leaf.shape)
        nd = len(shape)
        parts = [None] * nd
        if "attn_k" in p or "attn_v" in p or p in ("k", "v") or p.endswith("/k") \
                or p.endswith("/v") or "xk" in p or "xv" in p:
            # (L_or_ng, B, S, KV, hd)
            if batch_sharded:
                parts[-4] = dp
            else:
                parts[-3] = dp         # SP: shard the sequence (long_500k)
            if shape[-2] % sizes["model"] == 0:
                parts[-2] = "model"
            elif shape[-1] % sizes["model"] == 0:
                parts[-1] = "model"
        elif "c_kv" in p or "k_rope" in p:
            # (L, B, S, r)
            if batch_sharded:
                parts[1] = dp
            else:
                parts[2] = dp
            if shape[-1] % sizes["model"] == 0:
                parts[-1] = "model"
        elif "/conv" in p or p.endswith("conv"):
            # (L, B, K-1, ch)
            if batch_sharded:
                parts[1] = dp
            if shape[-1] % sizes["model"] == 0:
                parts[-1] = "model"
        elif p.endswith("/h") or p == "h":
            # mamba1 (L,B,di,N) / mamba2 (L,B,H,P,N)
            if batch_sharded:
                parts[1] = dp
            if shape[2] % sizes["model"] == 0:
                parts[2] = "model"
        return Spec(*parts)

    return _leaf_specs(cache_shapes, leaf_spec)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


def to_placements(spec: Spec, mesh) -> Tuple:
    """One placement per mesh dimension: ``Shard(d)`` where tensor dim d is
    split over that mesh axis (over ("pod", "data") a dim is ``Shard(d)`` on
    both), else ``Replicate()``."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {a!r} shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def to_placements_tree(spec_tree, mesh):
    return tree_map(lambda s: to_placements(s, mesh), spec_tree)


def place(t: torch.Tensor, placements: Tuple, mesh) -> DTensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor with
    ``placements``; a DTensor is redistributed instead (and returned as it
    is when it has them already). A meta tensor (shapes only: the dry-run)
    becomes a DTensor over an empty meta shard of this rank's local shape;
    nothing is copied."""
    placements = tuple(placements)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == placements else t.redistribute(mesh, placements)
    if t.device.type == "meta":
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, placements)
        return DTensor.from_local(t.new_empty(local), mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t.to(mesh.device_type), mesh, placements)


def place_tree(tree, placements_tree, mesh):
    return tree_map(lambda t, p: place(t, p, mesh), tree, placements_tree)


def distribute(model, mesh):
    """``model`` (an ``lm.Model``) with every parameter put on ``mesh`` as a
    DTensor laid out by :func:`param_specs`; a new model, the argument is
    left as it was."""
    from ..models import lm

    pl = to_placements_tree(param_specs(model, mesh), mesh)
    return lm.Model(place_tree(model.tree(), pl, mesh), model.cfg,
                    requires_grad=any(p.requires_grad for p in model.parameters()))


def gather(t):
    """A DTensor's whole value as a plain tensor (a plain tensor as is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t
