"""Model facade: family dispatch, smoke batches, and the reference's weights.

Port of ``repro/models/api.py``. The ``*_input_specs`` functions return
meta-device tensors (shape and dtype, nothing allocated), the stand-ins of
the reference's ``ShapeDtypeStruct``s. :func:`params_from_numpy` is new:
it turns the reference's parameter pytree into the port's model, so tests
run both packages on identical weights.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .. import device as devmod
from . import lm, whisper
from .config import ArchConfig, ShapeConfig

AUDIO_ENC_FRAMES = 1500   # whisper 30s @ 50Hz (backbone-level stub length)

#: parameters the reference keeps in fp32 whatever the model's dtype
FP32_PARAMS = frozenset({"router", "dt_bias", "A_log", "D"})
#: the reference's stacked (L, ...) layer trees
STACKED = ("layers", "enc_layers", "dec_layers")


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> lm.Model:
    """Seeded weights on ``gen``'s device."""
    if cfg.family == "audio":
        return whisper.init_params(cfg, gen, dtype)
    return lm.init_params(cfg, gen, dtype)


def loss_fn(cfg: ArchConfig, params, batch, remat: bool = True):
    if cfg.family == "audio":
        return whisper.loss_fn(cfg, params, batch, remat)
    return lm.loss_fn(cfg, params, batch, remat)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    if cfg.family == "audio":
        return whisper.init_cache(cfg, batch, max_len, AUDIO_ENC_FRAMES, dtype, device)
    return lm.init_cache(cfg, batch, max_len, dtype, device)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    if cfg.family == "audio":
        return whisper.decode_step(cfg, params, cache, tokens, pos)
    return lm.decode_step(cfg, params, cache, tokens, pos)


def prefill(cfg: ArchConfig, params, tokens_or_frames, cache):
    if cfg.family == "audio":
        return whisper.prefill(cfg, params, tokens_or_frames, cache)
    return lm.prefill(cfg, params, tokens_or_frames, cache)


def forward(cfg: ArchConfig, params, tokens, **kw):
    if cfg.family == "audio":
        raise ValueError("audio family uses loss_fn/encode/decode_train")
    return lm.forward(cfg, params, tokens, **kw)


# ---------------------------------------------------------------------------
# input specs (meta stand-ins) and smoke batches
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return {
            "frames": _meta((B, AUDIO_ENC_FRAMES, cfg.d_model), torch.bfloat16),
            "tokens": _meta((B, S + 1), torch.int32),
        }
    return {"tokens": _meta((B, S + 1), torch.int32)}


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Specs for serve_step: one new token against a seq_len-deep cache."""
    B, S = shape.global_batch, shape.seq_len
    return {
        "tokens": _meta((B, 1), torch.int32),
        "pos": _meta((), torch.int32),
        "cache": init_cache(cfg, B, S, device="meta"),
    }


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return {"frames": _meta((B, AUDIO_ENC_FRAMES, cfg.d_model), torch.bfloat16)}
    return {"tokens": _meta((B, S), torch.int32)}


def cell_is_supported(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Which (arch x shape) cells run."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("long_500k skipped: full-attention arch (O(S) KV cache / quadratic "
                       "prefill); run for SSM/hybrid only")
    return True, ""


def make_train_batch(cfg: ArchConfig, batch: int, seq: int, rng: np.random.Generator,
                     device=None) -> Dict[str, torch.Tensor]:
    dev = devmod.resolve(device)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq + 1))).to(dev)}
    if cfg.family == "audio":
        out["frames"] = torch.from_numpy(
            rng.standard_normal((batch, 16, cfg.d_model))).to(dev, torch.bfloat16)
    return out


def params_from_numpy(cfg: ArchConfig, params: Dict[str, Any], device=None,
                      dtype=None) -> lm.Model:
    """The reference's parameter pytree, with numpy arrays for leaves, as
    the port's model: each stacked ``(L, ...)`` layer tree becomes one
    module per layer. ``dtype`` casts the floating weights (None keeps the
    arrays' own), except those the reference keeps in fp32 at any dtype."""
    dev = devmod.resolve(device)

    def tensor(name, a):
        t = torch.from_numpy(np.array(a)).to(dev)
        if dtype is not None and t.is_floating_point() and name not in FP32_PARAMS:
            t = t.to(dtype)
        return t

    def convert(tree):
        return {k: convert(v) if isinstance(v, dict) else tensor(k, v) for k, v in tree.items()}

    def unstack(tree, i):
        return {k: unstack(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    def depth(tree):
        leaf = next(iter(tree.values()))
        return depth(leaf) if isinstance(leaf, dict) else leaf.shape[0]

    tree = convert(params)
    for key in STACKED:
        if key in tree:
            tree[key] = [unstack(tree[key], i) for i in range(depth(tree[key]))]
    return lm.Model(tree, cfg)
