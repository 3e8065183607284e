"""Rewrite rules for flexible matching (Section 2.2 + Section 5.1 + Fig. 7).

Two families, exactly as in the paper:

* **Compiler-IR rewrites** — accelerator-independent equivalences that expose
  more match sites: linear-layer canonicalization, add commutativity,
  dense -> dense+0 bias introduction, conv2d -> im2col -> GEMM (the paper's
  "emergent effect" that lets VTA run convolutions), and the 2D-maxpool
  decomposition into FlexASR temporal (2,1)/(2,1) poolings of Figure 7.

* **IR-accelerator rewrites** — each replaces a compiler-IR pattern by the
  corresponding accelerator intrinsic (which codegen later lowers to an ILA
  command stream). These are *owned by the targets*: every registered
  ``AcceleratorTarget`` declares its own (pattern + capacity guard + data-
  transfer cancellations, cf. Section 5.1), and this module enumerates the
  registry. Adding an accelerator adds rewrites without editing this file.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from .egraph import (
    P, V, Rewrite, add_op as _add_op,
    shape_of as _shape,
)


# --------------------------------------------------------------------------
# Compiler-IR rewrites
# --------------------------------------------------------------------------


def _linear_reshape_guard(eg, cid, s):
    """(add (reshape (dense a b) s) c): c must be a vector broadcastable over
    the reshaped dense output (the condition "when %c is a vector, for
    certain shapes %s" of Section 2.2.2)."""
    a = _shape(eg, s["a"])
    b = _shape(eg, s["b"])
    d = a[:-1] + (b[0],)
    c = _shape(eg, s["c"])
    tgt = tuple(s["shape"])
    if len(c) != 1 or c[0] != d[-1]:
        return False
    return tgt[-1] == d[-1] and int(np.prod(tgt)) == int(np.prod(d))


def _linear_reshape_applier(eg, cid, s):
    # -> (reshape (bias_add (dense a b) c) s)
    d = _add_op(eg, "dense", [s["a"], s["b"]])
    ba = _add_op(eg, "bias_add", [d, s["c"]])
    return _add_op(eg, "reshape", [ba], shape=tuple(s["shape"]))


def _dense_zero_applier(eg, cid, s):
    dshape = _shape(eg, cid)
    z = _add_op(eg, "zeros", [], shape=(dshape[-1],))
    d = _add_op(eg, "dense", [s["a"], s["b"]])
    return _add_op(eg, "bias_add", [d, z])


def _im2col_guard(eg, cid, s):
    return tuple(s["padding"]) == (0, 0)


def _hoist_pad_applier(eg, cid, s):
    padded = _add_op(eg, "pad2d", [s["x"]], pad=tuple(s["padding"]))
    return _add_op(
        eg, "conv2d", [padded, s["w"]], strides=tuple(s["strides"]), padding=(0, 0)
    )


def _im2col_applier(eg, cid, s):
    """conv2d(x, w) -> reshape(dense(im2col(x), wmat), out_shape).

    w is HWIO; wmat = reshape(transpose(w, OHWI), (CO, KH*KW*CI)).
    """
    xs = _shape(eg, s["x"])
    ws = _shape(eg, s["w"])
    n, h, wdim, c = xs
    kh, kw, ci, co = ws
    sh, sw = s["strides"]
    oh, ow = (h - kh) // sh + 1, (wdim - kw) // sw + 1
    patches = _add_op(eg, "im2col", [s["x"]], kh=kh, kw=kw, sh=sh, sw=sw)
    wt = _add_op(eg, "transpose", [s["w"]], axes=(3, 0, 1, 2))
    wmat = _add_op(eg, "reshape", [wt], shape=(co, kh * kw * ci))
    d = _add_op(eg, "dense", [patches, wmat])
    return _add_op(eg, "reshape", [d], shape=(n, oh, ow, co))


def _maxpool_decomp_guard(eg, cid, s):
    wh, ww = s["wh"], s["ww"]
    k = wh * ww
    # decomposable when the window has a power-of-two element count > 1
    return k > 1 and (k & (k - 1)) == 0


def _pool_decomp_applier(kind):
    """Figure 7: 2D pooling (wh,ww)/(sh,sw) == reshape of log2(wh*ww)
    pairwise-row poolings of the transposed flattened window matrix."""

    red = "reduce_max" if kind == "max" else "reduce_mean"

    def applier(eg, cid, s):
        wh, ww, sh, sw = s["wh"], s["ww"], s["sh"], s["sw"]
        tsh = _shape(eg, s["T"])
        hh, wwdim = tsh
        oh, ow = (hh - wh) // sh + 1, (wwdim - ww) // sw + 1
        k = int(math.log2(wh * ww))
        wins = _add_op(eg, "windows", [s["T"]], wh=wh, ww=ww, sh=sh, sw=sw)
        flat = _add_op(eg, "flatten_window", [wins])          # (OH*OW, WH*WW)
        cur = _add_op(eg, "transpose", [flat], axes=(1, 0))   # (WH*WW, OH*OW)
        for _ in range(k):
            w2 = _add_op(eg, "windows", [cur], wh=2, ww=1, sh=2, sw=1)
            cur = _add_op(eg, red, [w2], axis=(2, 3))
        return _add_op(eg, "reshape", [cur], shape=(oh, ow))

    return applier


def compiler_ir_rewrites() -> List[Rewrite]:
    return [
        Rewrite(
            "add-comm",
            P("add", V("a"), V("b")),
            P("add", V("b"), V("a")),
        ),
        Rewrite(
            "linear-reshape",
            P("add", P("reshape", P("dense", V("a"), V("b")), attr_binds=("shape",)), V("c")),
            guard=_linear_reshape_guard,
            applier=_linear_reshape_applier,
        ),
        Rewrite(
            "dense-zero-bias",
            P("dense", V("a"), V("b")),
            applier=_dense_zero_applier,
        ),
        Rewrite(
            # host-side padding (Appendix A: "our implementation pads on the
            # host before invoking the accelerator")
            "conv2d-hoist-pad",
            P("conv2d", V("x"), V("w"), attr_binds=("strides", "padding")),
            guard=lambda eg, cid, s: tuple(s["padding"]) != (0, 0),
            applier=_hoist_pad_applier,
        ),
        Rewrite(
            "conv2d-im2col",
            P(
                "conv2d",
                V("x"),
                V("w"),
                attr_binds=("strides", "padding"),
            ),
            guard=_im2col_guard,
            applier=_im2col_applier,
        ),
        Rewrite(
            "maxpool-decompose",
            P(
                "reduce_max",
                P("windows", V("T"), attr_binds=("wh", "ww", "sh", "sw")),
                attrs=(("axis", (2, 3)),),
            ),
            guard=_maxpool_decomp_guard,
            applier=_pool_decomp_applier("max"),
        ),
        # reshape(x, shape(x)) -> x
        Rewrite(
            "reshape-noop",
            P("reshape", V("x"), attr_binds=("shape",)),
            guard=lambda eg, cid, s: tuple(s["shape"]) == _shape(eg, s["x"]),
            applier=lambda eg, cid, s: eg.find(s["x"]),
        ),
    ]


# --------------------------------------------------------------------------
# IR-accelerator rewrites: registry-driven
# --------------------------------------------------------------------------
#
# Each registered AcceleratorTarget owns its IR -> intrinsic rewrites
# (pattern + capacity guard, attributed to the target for saturation
# statistics). This module only enumerates the registry — adding an
# accelerator never touches this file.

from .. import accel as _accel  # noqa: F401  (registers the bundled targets)
from .ila import TARGETS


def accelerator_rewrites(
    targets: Optional[Sequence[str]] = None,
    exclude: Sequence[str] = (),
) -> List[Rewrite]:
    """The IR-accelerator rewrites of every selected target (None = all
    registered, in registration order). ``exclude`` drops named targets —
    how a ``SelectionPolicy.forbid`` keeps a vetoed target's intrinsics out
    of the e-graph entirely rather than merely pricing them to infinity."""
    skip = set(exclude)
    out: List[Rewrite] = []
    for t in TARGETS.all(targets):
        if t.name not in skip:
            out += t.rewrites()
    return out


def all_rewrites(
    targets: Optional[Sequence[str]] = None,
    flexible: bool = True,
    exclude: Sequence[str] = (),
) -> List[Rewrite]:
    """flexible=False == the paper's *exact matching* baseline (only the
    IR-accelerator rewrites); flexible=True adds the compiler-IR rewrites."""
    out = accelerator_rewrites(targets, exclude)
    if flexible:
        out = compiler_ir_rewrites() + out
    return out
