"""Compiler IR for the D2A flow.

A small, pure (side-effect-free) tensor IR in the spirit of Relay/Glenside:
immutable expression trees with shape inference and a reference interpreter
(the "IR interpreter" used as the validation oracle in the paper, Section
4.4). Expressions are hashable so they can be hash-consed into the e-graph.

The expression, shape and registry layers are the reference's; the
interpreter evaluates with PyTorch on an explicit device, keeps the
reference's NHWC/HWIO convolution layout at its interface, and casts every
bound variable and constant to float32 (as ``jnp.asarray`` does). It is
differentiable and ``torch.func.vmap``-able, which is how the co-simulation
apps train and label their tasks.

Op vocabulary (the subset the paper's mappings and rewrites need):

  dense(x, w)              -- x:(M,K) @ w:(N,K)^T -> (M,N)   (Relay nn.dense)
  bias_add(x, b)           -- broadcast add over last axis
  add / sub / mul / maximum
  relu / sigmoid / tanh / negative
  reshape(x; shape)        -- static target shape
  transpose(x; axes)
  conv2d(x, w; strides, padding)  -- NHWC x, HWIO w (HLSCNN layout)
  im2col(x; kh, kw, sh, sw)       -- NHWC -> (N*OH*OW, KH*KW*C) patches
  windows(x; wh, ww, sh, sw)      -- 2D sliding windows (Glenside `windows`)
  reduce_max(x; axis) / reduce_mean(x; axis) / reduce_sum(x; axis)
  layer_norm(x, g, b; eps)
  softmax(x; axis)
  zeros(; shape) / ones(; shape)
  concat(xs...; axis)
  split_time(x; t)         -- helper for LSTM unrolling patterns
  lstm_cell(x, h, c, wi, wh, b)   -- one LSTM time step (fused gates)
  lstm(x, wi, wh, b)       -- full LSTM over time (the coarse FlexASR op)
  attention(q, k, v)       -- scaled dot-product attention (FlexASR op)

Accelerator ops (targets of IR-accelerator rewrites; opaque to IR rewrites):

  fasr_linear / fasr_lstm / fasr_maxpool / fasr_meanpool / fasr_layernorm /
  fasr_attention / fasr_store / fasr_load
  hlscnn_conv2d
  vta_gemm / vta_add / vta_relu

The vocabulary above is the *bundled* set. Plugin accelerator targets extend
it at registration time through :func:`register_accel_op`, which attaches a
shape rule and an ideal (fp32 oracle) evaluation rule for each new intrinsic
— shape inference, the interpreter, the e-graph shape analysis and
``accelerator_calls`` all consult the extension table, so a new backend never
needs to edit this module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve

# --------------------------------------------------------------------------
# Accelerator-op extension registry (the plugin-target hook)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AccelOpSpec:
    """How the IR layer understands one plugin accelerator intrinsic.

    ``shape(attrs, child_shapes) -> shape`` and ``ideal(attrs, args) -> array``
    may be None for the bundled vocabulary (whose rules are built in below);
    ``counts`` is False for pass-through data-movement markers (store/load)
    that must not be tallied as accelerator invocations.
    """

    target: str
    shape: Optional[Callable] = None
    ideal: Optional[Callable] = None
    counts: bool = True


_ACCEL_EXT: Dict[str, AccelOpSpec] = {}


def register_accel_op(
    op: str,
    target: str,
    shape_fn: Optional[Callable] = None,
    eval_fn: Optional[Callable] = None,
    counts: bool = True,
) -> Optional[AccelOpSpec]:
    """Register an accelerator intrinsic op for ``target``.

    Makes the op a member of :data:`ACCEL_OPS` (cost model + Executor
    dispatch), attributes it to ``target`` in :func:`accelerator_calls`, and
    — when ``shape_fn``/``eval_fn`` are given — teaches shape inference and
    the ideal interpreter its semantics. Returns the spec this registration
    displaced (None for a first registration), so a transient re-registration
    — the fault campaign's mutant swap — can restore it exactly.
    """
    prev = _ACCEL_EXT.get(op)
    _ACCEL_EXT[op] = AccelOpSpec(target, shape_fn, eval_fn, counts)
    ACCEL_OPS.add(op)
    return prev


def unregister_accel_op(op: str) -> Optional[AccelOpSpec]:
    """Inverse of :func:`register_accel_op` (synthetic-target and mutant
    cleanup). Returns the removed spec (None if ``op`` was unknown) so the
    caller can later :func:`restore_accel_op` it, leaving the extension
    table bit-identical."""
    spec = _ACCEL_EXT.pop(op, None)
    if spec is not None:
        ACCEL_OPS.discard(op)
    return spec


def restore_accel_op(op: str, spec: Optional[AccelOpSpec]) -> None:
    """Reinstate the exact spec object a register/unregister displaced
    (``spec=None`` removes the op). With :func:`unregister_accel_op`'s
    return value this makes transient registrations — fault-campaign mutant
    swaps, synthetic test targets — leave the table bit-identical."""
    if spec is None:
        unregister_accel_op(op)
    else:
        _ACCEL_EXT[op] = spec
        ACCEL_OPS.add(op)


def accel_op_shape_fn(op: str) -> Optional[Callable]:
    spec = _ACCEL_EXT.get(op)
    return spec.shape if spec is not None else None


def accel_op_target(op: str) -> Optional[str]:
    """The target an intrinsic op invokes, or None for non-invoking ops."""
    spec = _ACCEL_EXT.get(op)
    if spec is not None:
        return spec.target if spec.counts else None
    return _BUILTIN_TRIGGER.get(op)


# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Expr:
    """Base class; all exprs are immutable and hashable."""


@dataclasses.dataclass(frozen=True)
class Var(Expr):
    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"

    def __repr__(self):
        return f"%{self.name}"


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    """Scalar/small constant embedded in the program (by value)."""

    value: float

    def __repr__(self):
        return f"{self.value}"


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    op: str
    args: Tuple[Expr, ...]
    attrs: Tuple[Tuple[str, Any], ...] = ()

    def attr(self, key, default=None):
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    def __repr__(self):
        a = " ".join(repr(x) for x in self.args)
        if self.attrs:
            kv = " ".join(f":{k} {v}" for k, v in self.attrs)
            return f"({self.op} {a} {kv})"
        return f"({self.op} {a})"


def call(op: str, *args: Expr, **attrs) -> Call:
    return Call(op, tuple(args), tuple(sorted(attrs.items())))


# Sugar constructors -------------------------------------------------------

def dense(x, w):
    return call("dense", x, w)


def bias_add(x, b):
    return call("bias_add", x, b)


def add(a, b):
    return call("add", a, b)


def mul(a, b):
    return call("mul", a, b)


def reshape(x, shape):
    return call("reshape", x, shape=tuple(shape))


def conv2d(x, w, strides=(1, 1), padding=(0, 0)):
    return call("conv2d", x, w, strides=tuple(strides), padding=tuple(padding))


# --------------------------------------------------------------------------
# Shape inference
# --------------------------------------------------------------------------


class ShapeError(Exception):
    pass


def _conv_out(h, k, s, p):
    return (h + 2 * p - k) // s + 1


def infer_shape(e: Expr, env: Optional[Dict[str, Tuple[int, ...]]] = None) -> Tuple[int, ...]:
    """Infer the output shape of ``e``. ``env`` overrides Var shapes."""
    memo: Dict[Expr, Tuple[int, ...]] = {}

    def rec(x: Expr) -> Tuple[int, ...]:
        if x in memo:
            return memo[x]
        s = _infer(x, rec, env)
        memo[x] = s
        return s

    return rec(e)


def check_expr(
    e: Expr, env: Optional[Dict[str, Tuple[int, ...]]] = None
) -> Tuple[int, ...]:
    """Pre-codegen static checker: validate shapes and dtypes of every
    sub-expression *before* any planner or simulator touches the program.

    Walks ``e`` in postorder, shape-checking each node (so the error names
    the innermost inconsistent call, with its operand shapes, instead of
    whatever downstream planner trips first) and verifying that every
    accelerator call targets a registered op and consumes float32 operands
    (the command-stream payload dtype). Returns the program's output shape;
    raises :class:`ShapeError` with per-node context on violation.
    """
    memo: Dict[Expr, Tuple[int, ...]] = {}

    def rec(x: Expr) -> Tuple[int, ...]:
        if x in memo:
            return memo[x]
        s = _infer(x, rec, env)
        memo[x] = s
        return s

    for x in postorder(e):
        if isinstance(x, Var) and x.dtype != "float32":
            raise ShapeError(
                f"check: var %{x.name} has dtype {x.dtype!r}; the IR "
                "carries float32 tensors only"
            )
        if not isinstance(x, Call):
            continue
        if x.op in ACCEL_OPS and accel_op_target(x.op) is None \
                and x.op not in ("fasr_store", "fasr_load"):
            raise ShapeError(
                f"check: accelerator op {x.op!r} has no registered target"
            )
        try:
            shape = rec(x)
        except ShapeError as err:
            arg_shapes = [rec(a) for a in x.args]
            raise ShapeError(
                f"check: {x.op}{tuple(arg_shapes)} "
                f"attrs={dict(x.attrs)}: {err}"
            ) from err
        if any(int(d) <= 0 for d in shape):
            raise ShapeError(
                f"check: {x.op} infers non-positive dimension in {shape}"
            )
    return rec(e)


def _infer(x: Expr, rec, env) -> Tuple[int, ...]:
    if isinstance(x, Var):
        if env and x.name in env:
            return tuple(env[x.name])
        return x.shape
    if isinstance(x, Const):
        return ()
    assert isinstance(x, Call)
    op, args = x.op, x.args
    if op in ("add", "sub", "mul", "maximum"):
        a, b = rec(args[0]), rec(args[1])
        return tuple(np.broadcast_shapes(a, b))
    if op in ("relu", "sigmoid", "tanh", "negative", "softmax"):
        return rec(args[0])
    if op == "dense":
        a, w = rec(args[0]), rec(args[1])
        if a[-1] != w[-1]:
            raise ShapeError(f"dense {a} x {w}")
        return a[:-1] + (w[0],)
    if op == "bias_add":
        return rec(args[0])
    if op == "reshape":
        tgt = tuple(x.attr("shape"))
        src = rec(args[0])
        if int(np.prod(tgt)) != int(np.prod(src)):
            raise ShapeError(f"reshape {src} -> {tgt}")
        return tgt
    if op == "transpose":
        src = rec(args[0])
        axes = x.attr("axes")
        return tuple(src[a] for a in axes)
    if op == "conv2d":
        n, h, w_, c = rec(args[0])
        kh, kw, ci, co = rec(args[1])
        (sh, sw), (ph, pw) = x.attr("strides"), x.attr("padding")
        if ci != c:
            raise ShapeError(f"conv2d channels {c} vs {ci}")
        return (n, _conv_out(h, kh, sh, ph), _conv_out(w_, kw, sw, pw), co)
    if op == "dw_conv2d":
        n, h, w_, c = rec(args[0])
        kh, kw, ci, _ = rec(args[1])
        (sh, sw), (ph, pw) = x.attr("strides"), x.attr("padding")
        return (n, _conv_out(h, kh, sh, ph), _conv_out(w_, kw, sw, pw), c)
    if op == "pad2d":
        n, h, w_, c = rec(args[0])
        ph, pw = x.attr("pad")
        return (n, h + 2 * ph, w_ + 2 * pw, c)
    if op == "im2col":
        n, h, w_, c = rec(args[0])
        kh, kw = x.attr("kh"), x.attr("kw")
        sh, sw = x.attr("sh"), x.attr("sw")
        oh, ow = _conv_out(h, kh, sh, 0), _conv_out(w_, kw, sw, 0)
        return (n * oh * ow, kh * kw * c)
    if op == "windows":
        h, w_ = rec(args[0])
        wh, ww = x.attr("wh"), x.attr("ww")
        sh, sw = x.attr("sh"), x.attr("sw")
        return (_conv_out(h, wh, sh, 0), _conv_out(w_, ww, sw, 0), wh, ww)
    if op in ("reduce_max", "reduce_mean", "reduce_sum"):
        src = rec(args[0])
        ax = x.attr("axis")
        axes = (ax,) if isinstance(ax, int) else tuple(ax)
        axes = tuple(a % len(src) for a in axes)
        return tuple(s for i, s in enumerate(src) if i not in axes)
    if op == "layer_norm":
        return rec(args[0])
    if op == "zeros" or op == "ones":
        return tuple(x.attr("shape"))
    if op == "concat":
        shapes = [rec(a) for a in args]
        ax = x.attr("axis")
        out = list(shapes[0])
        out[ax] = sum(s[ax] for s in shapes)
        return tuple(out)
    if op == "lstm_cell":
        xs, hs = rec(args[0]), rec(args[1])
        return hs
    if op == "lstm":
        xs = rec(args[0])  # (T, B, I)
        wh = rec(args[2])  # (4H, H)
        return (xs[0], xs[1], wh[1])
    if op == "attention":
        q, k, v = rec(args[0]), rec(args[1]), rec(args[2])
        return q[:-1] + (v[-1],)
    if op == "flatten_window":
        # (OH, OW, WH, WW) -> (OH*OW, WH*WW)
        oh, ow, wh, ww = rec(args[0])
        return (oh * ow, wh * ww)
    # ---- accelerator ops: shapes follow their IR equivalents -------------
    if op == "fasr_linear":
        return _infer(call("bias_add", call("dense", args[0], args[1]), args[2]), rec, env)
    if op == "fasr_lstm":
        return _infer(call("lstm", *args), rec, env)
    if op in ("fasr_maxpool",):
        t = rec(args[0])  # (T, B) rows pooled pairwise over axis 0
        return (t[0] // 2,) + t[1:]
    if op in ("fasr_meanpool",):
        t = rec(args[0])
        return (t[0] // 2,) + t[1:]
    if op == "fasr_layernorm":
        return rec(args[0])
    if op == "fasr_attention":
        return _infer(call("attention", *args), rec, env)
    if op in ("fasr_store", "fasr_load", "vta_store", "vta_load"):
        return rec(args[0])
    if op == "hlscnn_conv2d":
        return _infer(
            call("conv2d", args[0], args[1], strides=x.attr("strides"), padding=x.attr("padding")),
            rec,
            env,
        )
    if op == "vta_gemm":
        return _infer(call("dense", args[0], args[1]), rec, env)
    if op in ("vta_add",):
        a, b = rec(args[0]), rec(args[1])
        return tuple(np.broadcast_shapes(a, b))
    if op in ("vta_relu",):
        return rec(args[0])
    spec = _ACCEL_EXT.get(op)
    if spec is not None and spec.shape is not None:
        return tuple(spec.shape(dict(x.attrs), [rec(a) for a in args]))
    raise ShapeError(f"unknown op {op}")


# --------------------------------------------------------------------------
# --------------------------------------------------------------------------
# Reference interpreter (the "IR interpreter" oracle of Section 4.4)
# --------------------------------------------------------------------------


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _lstm_cell(x, h, c, wi, wh, b):
    """Fused-gate LSTM cell: gates = x@wi^T + h@wh^T + b, order i,f,g,o."""
    gates = x @ wi.mT + h @ wh.mT + b
    hdim = h.shape[-1]
    i = _sigmoid(gates[..., 0 * hdim : 1 * hdim])
    f = _sigmoid(gates[..., 1 * hdim : 2 * hdim])
    g = torch.tanh(gates[..., 2 * hdim : 3 * hdim])
    o = _sigmoid(gates[..., 3 * hdim : 4 * hdim])
    c2 = f * c + i * g
    h2 = o * torch.tanh(c2)
    return h2, c2


def _lstm(xs, wi, wh, b):
    T, B, _ = xs.shape
    H = wh.shape[1]
    h = xs.new_zeros((B, H))
    c = xs.new_zeros((B, H))
    outs = []
    for t in range(T):
        h, c = _lstm_cell(xs[t], h, c, wi, wh, b)
        outs.append(h)
    return torch.stack(outs)


def _windows2d(x, wh, ww, sh, sw):
    H, W = x.shape
    oh, ow = (H - wh) // sh + 1, (W - ww) // sw + 1
    ar = lambda n: torch.arange(n, device=x.device)
    idx_h = ar(oh)[:, None, None, None] * sh + ar(wh)[None, None, :, None]
    idx_w = ar(ow)[None, :, None, None] * sw + ar(ww)[None, None, None, :]
    return x[idx_h, idx_w]  # (OH, OW, WH, WW)


def _im2col(x, kh, kw, sh, sw):
    N, H, W, C = x.shape
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    cols = []
    for i in range(kh):
        for j in range(kw):
            cols.append(x[:, i : i + oh * sh : sh, j : j + ow * sw : sw, :])
    # (N, OH, OW, KH*KW, C) -> (N*OH*OW, KH*KW*C)
    patches = torch.stack(cols, dim=3)
    return patches.reshape(N * oh * ow, kh * kw * C)


def _conv2d(x, w, strides, padding, groups=1):
    """NHWC x, HWIO w -> NHWC (the reference layout), via NCHW/OIHW."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
        stride=tuple(strides), padding=tuple(padding), groups=groups,
    )
    return y.permute(0, 2, 3, 1)


def _attention(q, k, v):
    d = q.shape[-1]
    s = (q @ k.transpose(-1, -2)) / torch.sqrt(torch.tensor(float(d), device=q.device))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return p @ v


def _fasr_pool(x, kind):
    """FlexASR temporal pooling: pairwise reduce over axis 0 (window (2,1))."""
    T = x.shape[0]
    pairs = x[: T - T % 2].reshape(T // 2, 2, *x.shape[1:])
    if kind == "max":
        return torch.amax(pairs, dim=1)
    return torch.mean(pairs, dim=1)


def _axes(ax):
    return tuple(ax) if isinstance(ax, (tuple, list)) else ax


def as_tensor(v, device: torch.device) -> torch.Tensor:
    """An environment value as a tensor on ``device``; floating values
    become float32 (the reference's ``jnp.asarray`` default)."""
    if isinstance(v, torch.Tensor):
        t = v
    else:
        a = np.asarray(v)
        t = torch.as_tensor(a if a.flags.writeable else a.copy())
    if t.is_floating_point():
        return t.to(device=device, dtype=torch.float32)
    return t.to(device=device)


# Accelerator ops interpreted with *ideal* (fp32) semantics here; the
# bit-accurate custom-numerics execution lives in repro_torch.accel.* and is
# compared against this oracle by the validation layer.
def interpret(
    e: Expr, env: Dict[str, Any], accel_exact: bool = True, device: DeviceLike = None
) -> Any:
    """Evaluate expression ``e`` with variable bindings ``env`` on
    ``device`` (``None`` -> CUDA).

    accel_exact: interpret accelerator ops with exact fp32 semantics
    (abstract-datatype view, as in the paper's VT2 proofs). The numerics-
    accurate path is provided by repro_torch.core.codegen via the ILA
    simulators.
    """
    dev = resolve(device)
    memo: Dict[Expr, Any] = {}

    def rec(x: Expr):
        if x in memo:
            return memo[x]
        v = _eval(x, rec, env, dev)
        memo[x] = v
        return v

    return rec(e)


def _eval(x: Expr, rec, env, device: torch.device):
    if isinstance(x, Var):
        if x.name not in env:
            raise KeyError(f"unbound var %{x.name}")
        return as_tensor(env[x.name], device)
    if isinstance(x, Const):
        return torch.tensor(x.value, dtype=torch.float32, device=device)
    assert isinstance(x, Call)
    op = x.op
    a = [as_tensor(rec(arg), device) for arg in x.args]
    if op == "add" or op == "vta_add":
        return a[0] + a[1]
    if op == "sub":
        return a[0] - a[1]
    if op == "mul":
        return a[0] * a[1]
    if op == "maximum":
        return torch.maximum(a[0], a[1])
    if op == "relu" or op == "vta_relu":
        return torch.clamp(a[0], min=0)
    if op == "sigmoid":
        return _sigmoid(a[0])
    if op == "tanh":
        return torch.tanh(a[0])
    if op == "negative":
        return -a[0]
    if op == "softmax":
        ax = x.attr("axis", -1)
        e_ = torch.exp(a[0] - torch.amax(a[0], dim=ax, keepdim=True))
        return e_ / torch.sum(e_, dim=ax, keepdim=True)
    if op == "dense" or op == "vta_gemm":
        return a[0] @ a[1].mT
    if op == "bias_add":
        return a[0] + a[1]
    if op == "reshape":
        return a[0].reshape(x.attr("shape"))
    if op == "transpose":
        return a[0].permute(x.attr("axes"))
    if op == "conv2d" or op == "hlscnn_conv2d":
        return _conv2d(a[0], a[1], x.attr("strides"), x.attr("padding"))
    if op == "pad2d":
        ph, pw = x.attr("pad")
        return F.pad(a[0], (0, 0, pw, pw, ph, ph))
    if op == "dw_conv2d":
        # w: (kh, kw, C, 1) -> depthwise HWIO (kh, kw, 1, C), C groups
        c = a[0].shape[-1]
        w = a[1].permute(0, 1, 3, 2)
        return _conv2d(a[0], w, x.attr("strides"), x.attr("padding"), groups=c)
    if op == "im2col":
        return _im2col(a[0], x.attr("kh"), x.attr("kw"), x.attr("sh"), x.attr("sw"))
    if op == "windows":
        return _windows2d(a[0], x.attr("wh"), x.attr("ww"), x.attr("sh"), x.attr("sw"))
    if op == "flatten_window":
        oh, ow, wh, ww = a[0].shape
        return a[0].reshape(oh * ow, wh * ww)
    if op == "reduce_max":
        return torch.amax(a[0], dim=_axes(x.attr("axis")))
    if op == "reduce_mean":
        return torch.mean(a[0], dim=_axes(x.attr("axis")))
    if op == "reduce_sum":
        return torch.sum(a[0], dim=_axes(x.attr("axis")))
    if op == "layer_norm" or op == "fasr_layernorm":
        eps = x.attr("eps", 1e-5)
        xx = a[0]
        mu = torch.mean(xx, dim=-1, keepdim=True)
        var = torch.var(xx, dim=-1, keepdim=True, correction=0)
        return (xx - mu) / torch.sqrt(var + eps) * a[1] + a[2]
    if op == "zeros":
        return torch.zeros(x.attr("shape"), device=device)
    if op == "ones":
        return torch.ones(x.attr("shape"), device=device)
    if op == "concat":
        return torch.cat(a, dim=x.attr("axis"))
    if op == "lstm_cell":
        return _lstm_cell(*a)[0]
    if op == "lstm" or op == "fasr_lstm":
        return _lstm(*a)
    if op == "attention" or op == "fasr_attention":
        return _attention(*a)
    if op == "fasr_linear":
        return a[0] @ a[1].mT + a[2]
    if op in ("fasr_store", "fasr_load", "vta_store", "vta_load"):
        return a[0]
    if op == "fasr_maxpool":
        return _fasr_pool(a[0], "max")
    if op == "fasr_meanpool":
        return _fasr_pool(a[0], "mean")
    spec = _ACCEL_EXT.get(op)
    if spec is not None and spec.ideal is not None:
        return spec.ideal(dict(x.attrs), a)
    raise ShapeError(f"interpret: unknown op {op}")


# --------------------------------------------------------------------------
# Traversal helpers
# --------------------------------------------------------------------------


def postorder(e: Expr):
    seen = set()
    out = []

    def rec(x):
        if id(x) in seen:
            return
        seen.add(id(x))
        if isinstance(x, Call):
            for a in x.args:
                rec(a)
        out.append(x)

    rec(e)
    return out


def count_ops(e: Expr, pred: Callable[[Call], bool] = lambda c: True) -> int:
    return sum(1 for x in postorder(e) if isinstance(x, Call) and pred(x))


def accelerator_calls(e: Expr) -> Dict[str, int]:
    """Count accelerator invocations by backend (Table 1 statistic).

    Keys cover every target known to the registry (bundled + plugins), so a
    target that received zero offloads still reports an explicit 0.
    """
    targets = set(_BUILTIN_TRIGGER.values())
    targets.update(s.target for s in _ACCEL_EXT.values())
    out: Dict[str, int] = {t: 0 for t in sorted(targets)}
    for x in postorder(e):
        if isinstance(x, Call):
            t = accel_op_target(x.op)
            if t is not None:
                out[t] += 1
    return out


# Bundled intrinsic -> target attribution (pass-through fasr_store/fasr_load
# deliberately absent: data movement is not an invocation).
_BUILTIN_TRIGGER: Dict[str, str] = {
    "fasr_linear": "flexasr",
    "fasr_lstm": "flexasr",
    "fasr_maxpool": "flexasr",
    "fasr_meanpool": "flexasr",
    "fasr_layernorm": "flexasr",
    "fasr_attention": "flexasr",
    "hlscnn_conv2d": "hlscnn",
    "vta_gemm": "vta",
    "vta_add": "vta",
    "vta_relu": "vta",
}

#: Mutable: plugin targets extend this via :func:`register_accel_op`.
ACCEL_OPS = set(_BUILTIN_TRIGGER) | {"fasr_store", "fasr_load"}
