"""The six DL applications of Section 4.2, as compiler-IR programs.

Each builder returns ``(expr, params)`` where ``expr`` is the IR program over
a Var for the input (named "x", plus weight Vars) and ``params`` maps weight
names to initialized arrays. Sizes are scaled so the accelerator ILAs can
co-simulate them end-to-end (the paper likewise "selected applications with
reasonable size for human inspection"), but the *structures* match:

  efficientnet  — conv stages with sigmoid (swish-family) gating + SE-ish mix
  lstm_wlm      — LSTM + linear logit head (the word-language-model)
  mobilenet_v2  — pointwise conv / depthwise (host-resident) / residuals
  resmlp        — patchify + MLP-mixer-style token/channel linear layers
  resnet20      — conv/relu blocks with identity residuals + linear head
  transformer   — MHA (per-head attention intrinsics) + FFN + layernorm

``dw_conv2d`` (grouped/depthwise) is intentionally *unsupported* by every
accelerator mapping — the paper kept grouped convolutions on the host
(Appendix A) — so MobileNet exhibits the same partial-offload shape.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from . import ir


def _init(rng, *shape, scale=None):
    scale = scale or (1.0 / np.sqrt(np.prod(shape[-1:])))
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _linear(x, params, rng, name, din, dout):
    w = ir.Var(f"{name}_w", (dout, din))
    b = ir.Var(f"{name}_b", (dout,))
    params[f"{name}_w"] = _init(rng, dout, din)
    params[f"{name}_b"] = np.zeros((dout,), np.float32)
    return ir.bias_add(ir.dense(x, w), b)


def _dense_only(x, params, rng, name, din, dout):
    w = ir.Var(f"{name}_w", (dout, din))
    params[f"{name}_w"] = _init(rng, dout, din)
    return ir.dense(x, w)


def _conv(x, params, rng, name, cin, cout, k=3, strides=(1, 1), padding=(0, 0)):
    w = ir.Var(f"{name}_w", (k, k, cin, cout))
    params[f"{name}_w"] = _init(rng, k, k, cin, cout, scale=1.0 / np.sqrt(k * k * cin))
    return ir.conv2d(x, w, strides, padding)


def _layernorm(x, params, rng, name, d):
    g = ir.Var(f"{name}_g", (d,))
    b = ir.Var(f"{name}_b", (d,))
    params[f"{name}_g"] = np.ones((d,), np.float32)
    params[f"{name}_b"] = np.zeros((d,), np.float32)
    return ir.call("layer_norm", x, g, b, eps=1e-5)


# ---------------------------------------------------------------------------


def build_efficientnet(seed=0, img=12, cin=8, width=16, blocks=3, n_classes=10):
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    x = ir.Var("x", (1, img, img, cin))
    h = _conv(x, params, rng, "stem", cin, width, k=3)
    size = img - 2
    c = width
    for i in range(blocks):
        y = _conv(h, params, rng, f"b{i}_conv", c, c, k=3, padding=(1, 1))
        y = ir.call("sigmoid", y)       # swish-family gating
        y = ir.call("mul", y, h)
        h = ir.call("add", y, h)        # residual
    h = ir.reshape(h, (size * size, c))
    h = _linear(h, params, rng, "head_mid", c, c)
    h = ir.call("relu", h)
    h = ir.call("reduce_mean", h, axis=0)
    h = ir.reshape(h, (1, c))
    logits = _linear(h, params, rng, "head", c, n_classes)
    return logits, params


def build_lstm_wlm(seed=0, vocab=32, embed=32, hidden=32, T=16):
    """Embedded tokens come in as x:(T, 1, embed); LSTM -> linear logits."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    x = ir.Var("x", (T, 1, embed))
    wi = ir.Var("lstm_wi", (4 * hidden, embed))
    wh = ir.Var("lstm_wh", (4 * hidden, hidden))
    b = ir.Var("lstm_b", (4 * hidden,))
    params["lstm_wi"] = _init(rng, 4 * hidden, embed)
    params["lstm_wh"] = _init(rng, 4 * hidden, hidden)
    params["lstm_b"] = np.zeros((4 * hidden,), np.float32)
    h = ir.call("lstm", x, wi, wh, b)                 # (T, 1, H)
    h = ir.reshape(h, (T, hidden))
    logits = _linear(h, params, rng, "logits", hidden, vocab)
    return logits, params


def build_mobilenet_v2(seed=0, img=12, cin=8, width=16, blocks=3, n_classes=10):
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    x = ir.Var("x", (1, img, img, cin))
    h = _conv(x, params, rng, "stem", cin, width, k=1)
    c = width
    for i in range(blocks):
        # expand (pointwise) -> depthwise (host) -> project (pointwise)
        e = _conv(h, params, rng, f"b{i}_exp", c, 2 * c, k=1)
        e = ir.call("relu", e)
        e = _dwconv(e, params, rng, f"b{i}_dw", 2 * c)
        e = ir.call("relu", e)
        p = _conv(e, params, rng, f"b{i}_proj", 2 * c, c, k=1)
        h = ir.call("add", p, h)
    h = ir.reshape(h, (img * img, c))
    h = ir.call("reduce_mean", h, axis=0)
    h = ir.reshape(h, (1, c))
    # final classifier is a bias-less dense (the paper's flexible-matching
    # finding: offloaded to FlexASR only via the dense+0 rewrite)
    logits = _dense_only(h, params, rng, "head", c, n_classes)
    return logits, params


def _dwconv(x, params, rng, name, c):
    """Depthwise conv: stays a host op (no accelerator mapping)."""
    w = ir.Var(f"{name}_w", (3, 3, c, 1))
    params[f"{name}_w"] = _init(rng, 3, 3, c, 1, scale=1.0 / 3.0)
    return ir.call("dw_conv2d", x, w, strides=(1, 1), padding=(1, 1))


def build_resmlp(seed=0, n_patch=16, d=64, layers=4, n_classes=10):
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    x = ir.Var("x", (n_patch, d))       # patch embeddings (host patchify stub)
    h = x
    for i in range(layers):
        # token-mixing linear across patches
        t = ir.call("transpose", h, axes=(1, 0))
        t = _linear(t, params, rng, f"l{i}_tok", n_patch, n_patch)
        t = ir.call("transpose", t, axes=(1, 0))
        h = ir.call("add", h, t)
        # channel-mixing MLP
        m = _layernorm(h, params, rng, f"l{i}_ln", d)
        m = _linear(m, params, rng, f"l{i}_fc1", d, 2 * d)
        m = ir.call("relu", m)
        m = _linear(m, params, rng, f"l{i}_fc2", 2 * d, d)
        h = ir.call("add", h, m)
    h = ir.call("reduce_mean", h, axis=0)
    h = ir.reshape(h, (1, d))
    logits = _linear(h, params, rng, "head", d, n_classes)
    return logits, params


def build_resnet20(seed=0, img=12, cin=8, width=16, blocks=3, n_classes=10):
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    x = ir.Var("x", (1, img, img, cin))
    h = _conv(x, params, rng, "stem", cin, width, k=3, padding=(1, 1))
    h = ir.call("relu", h)
    c = width
    for i in range(blocks):
        y = _conv(h, params, rng, f"b{i}_c1", c, c, k=3, padding=(1, 1))
        y = ir.call("relu", y)
        y = _conv(y, params, rng, f"b{i}_c2", c, c, k=3, padding=(1, 1))
        h = ir.call("relu", ir.call("add", y, h))     # identity mapping
    h = ir.reshape(h, (img * img, c))
    h = ir.call("reduce_mean", h, axis=0)
    h = ir.reshape(h, (1, c))
    logits = _linear(h, params, rng, "head", c, n_classes)
    return logits, params


def build_transformer(seed=0, T=16, d=64, heads=2, layers=2, n_classes=32):
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    x = ir.Var("x", (T, d))
    h = x
    dh = d // heads
    for i in range(layers):
        hn = _layernorm(h, params, rng, f"l{i}_ln1", d)
        # per-head QKV projections + attention intrinsic + output proj
        head_outs = []
        for j in range(heads):
            q = _dense_only(hn, params, rng, f"l{i}h{j}_q", d, dh)
            k = _dense_only(hn, params, rng, f"l{i}h{j}_k", d, dh)
            v = _dense_only(hn, params, rng, f"l{i}h{j}_v", d, dh)
            head_outs.append(ir.call("attention", q, k, v))
        cat = ir.call("concat", *head_outs, axis=1)
        o = _linear(cat, params, rng, f"l{i}_o", d, d)
        h = ir.call("add", h, o)
        hn2 = _layernorm(h, params, rng, f"l{i}_ln2", d)
        f = _linear(hn2, params, rng, f"l{i}_fc1", d, 2 * d)
        f = ir.call("relu", f)
        f = _linear(f, params, rng, f"l{i}_fc2", 2 * d, d)
        h = ir.call("add", h, f)
    logits = _linear(h, params, rng, "logits", d, n_classes)
    return logits, params


APPLICATIONS = {
    "EfficientNet": (build_efficientnet, "MxNet"),
    "LSTM-WLM": (build_lstm_wlm, "PyTorch"),
    "MobileNet-V2": (build_mobilenet_v2, "PyTorch"),
    "ResMLP": (build_resmlp, "PyTorch"),
    "ResNet-20": (build_resnet20, "MxNet"),
    "Transformer": (build_transformer, "PyTorch"),
}
