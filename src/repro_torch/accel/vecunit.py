"""VecUnit: a small element-wise vector accelerator — the plugin-API proof.

A deliberately simple fourth backend (in the spirit of the paper's claim
that ILA + mappings are all a new prototype accelerator needs): a 16-lane
element-wise vector unit computing in **int16 block fixed point** — values
are quantized to a signed 16-bit grid whose power-of-two scale is configured
per invocation by the driver (``CFG_NUM``), the way FlexASR's driver sizes
AdaptivFloat exponent windows. Supported functions:

  EW_MUL      out = a * b          (element-wise product; swish/SE gating)
  EW_SIGMOID  out = sigmoid(a)

Architectural state: three row buffers (operands a/b, output) of
``MAX_ROWS x MAX_COLS`` values stored as V-lane words, plus geometry/mode/
scale registers. Instruction set (MMIO-style, one V-lane word per command):

  WR_A / WR_B   store one V-lane row into the operand buffers
  CFG           mode, n_rows, n_cols
  CFG_NUM       scale exponents (a, b, out)
  EW_START      run the configured element-wise function

Everything the compiler, executor and validation layers need is declared
through :mod:`repro_torch.accel.target` and registered at the bottom of this
file — no ``repro_torch/core`` module mentions this backend.

The grid scale 2^e is built exactly (``numerics.exp2_int``). The reference
uses ``jnp.exp2``, which on the CPU backend is off by an ulp for the
exponents the driver picks here (about -13 to -15), and its sigmoid rounds
differently from PyTorch's; the port is therefore held to the reference at
each intrinsic's ``tol``, not bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import ir
from ..core.egraph import P, V as PV, Rewrite, shape_of
from ..core.ila import (
    ILA, BulkWrite, CompiledFragment, DataStream, PackedStream, bcast, branch,
    payload, register, write_block,
)
from . import numerics
from .target import (
    AcceleratorTarget, CostModel, Intrinsic, SimJob, VT2Case, register_target,
)

V = 16              # interface lanes
MAX_COLS = 64       # row width in values (4 V-lane words)
MAX_ROWS = 64       # rows per invocation (driver chunks larger tensors)
QMAX = 2 ** 15 - 1  # int16 symmetric grid

WR_A = 0x10
WR_B = 0x11
CFG = 0x20
CFG_NUM = 0x21
EW_START = 0x30

MODE_MUL = 1
MODE_SIGMOID = 2

_WORDS = MAX_ROWS * MAX_COLS // V

vecunit = ILA("vecunit", vwidth=V)

TARGET = AcceleratorTarget(
    "vecunit",
    vecunit,
    display_name="VecUnit",
    capabilities={
        "max_rows": MAX_ROWS, "max_cols": MAX_COLS, "numerics": "int16-blockfp",
    },
    doc="element-wise vector unit (mul / sigmoid) in int16 block fixed point",
    # the abstract fragments are the *identical* fp32 expressions on both
    # sides — the VT2 bound is bit-exact
    vt2_tol=0.0,
)
FRAGMENTS = TARGET.fragments
# unary ops (sigmoid) legitimately run with vec_b at its reset value, and
# sigmoid inputs are squashed well inside the block-scaled wrap point
TARGET.declare_lint(input_range=(-4.0, 4.0), reset_valid=("vec_b",))

vecunit.state("vec_a", lambda d: torch.zeros((_WORDS, V), device=d))
vecunit.state("vec_b", lambda d: torch.zeros((_WORDS, V), device=d))
vecunit.state("vec_out", lambda d: torch.zeros((_WORDS, V), device=d))
for reg in ("mode", "n_rows", "n_cols", "exp_a", "exp_b", "exp_o"):
    vecunit.state(reg, lambda d: 0.0)


def _dev(st) -> torch.device:
    return st["vec_a"].device


def _wr(buf):
    def update(st, addr, data):
        st[buf] = write_block(st[buf], payload(data, _dev(st)).unsqueeze(-2), (addr, 0))
        return st

    return update


vecunit.instruction("wr_a", WR_A)(_wr("vec_a"))
vecunit.instruction("wr_b", WR_B)(_wr("vec_b"))


def _cfg(names):
    def update(st, addr, data):
        for i, n in enumerate(names):
            st[n] = register(data, i)
        return st

    return update


vecunit.instruction("cfg", CFG)(_cfg(["mode", "n_rows", "n_cols"]))
vecunit.instruction("cfg_num", CFG_NUM)(_cfg(["exp_a", "exp_b", "exp_o"]))


def _q16(x, exp, dev):
    """int16 block fixed point: round onto the 2^exp grid, saturate. ``exp``
    is a number or a per-stream tensor shaped to broadcast against x."""
    scale = numerics.exp2_int(torch.as_tensor(exp, dtype=torch.float32, device=dev))
    return torch.clamp(torch.round(x / scale), -QMAX, QMAX) * scale


def _mask1(n, size, dev):
    """(1 or B, size) mask of the first ``n`` positions."""
    ar = torch.arange(size, device=dev)
    if isinstance(n, torch.Tensor):
        return (ar[None, :] < n[:, None]).float()
    return (ar < n).float()[None, :]


_EW_FNS = [
    lambda ab: ab[0] * ab[1],
    lambda ab: 1.0 / (1.0 + torch.exp(-ab[0])),
]


@vecunit.instruction("ew_start", EW_START, "run the configured element-wise fn")
def _ew_start(st, addr, data):
    dev = _dev(st)
    A = vecunit.lift(st, "vec_a").reshape(-1, MAX_ROWS, MAX_COLS)
    B = vecunit.lift(st, "vec_b").reshape(-1, MAX_ROWS, MAX_COLS)
    mask = _mask1(st["n_rows"], MAX_ROWS, dev)[:, :, None] \
        * _mask1(st["n_cols"], MAX_COLS, dev)[:, None, :]
    Aq = _q16(A, bcast(st["exp_a"], 2), dev) * mask
    Bq = _q16(B, bcast(st["exp_b"], 2), dev) * mask
    mode = st["mode"]
    sel = (mode.to(torch.int64) if isinstance(mode, torch.Tensor) else int(mode)) - 1
    Y = branch(sel, _EW_FNS, (Aq, Bq))
    Y = _q16(Y, bcast(st["exp_o"], 2), dev) * mask
    out = Y.reshape(-1, _WORDS, V)
    nb = vecunit.batch_size(st)
    if nb is None:
        st["vec_out"] = out[0]
    else:
        st["vec_out"] = out if out.shape[0] == nb else out.expand(nb, _WORDS, V)
    return st


# --------------------------------------------------------------------------
# Driver-side fragment builder (setup/data split; setup is empty — the whole
# invocation is a data stream, like VTA's vector-ALU fragments)
# --------------------------------------------------------------------------


def _exp_of(x: np.ndarray) -> float:
    """Driver-chosen power-of-two scale: amax representable on the grid."""
    amax = float(np.abs(x).max()) if x.size else 0.0
    if amax <= 0.0:
        return 0.0
    return float(np.ceil(np.log2(amax / QMAX)))


def _rows_of(x2: np.ndarray) -> np.ndarray:
    """(R, C) block -> V-lane word rows, zero-padded to the buffer layout."""
    R = x2.shape[0]
    buf = np.zeros((R, MAX_COLS), np.float32)
    buf[:, : x2.shape[1]] = x2
    return buf.reshape(R * (MAX_COLS // V), V)


def ew_fragment(kind: str, cache: bool = True) -> CompiledFragment:
    """No stationary operand: the setup stream is empty; the fragment exists
    to cache/batch same-kind invocations through one compiled runner."""
    assert kind in ("mul", "sigmoid")
    key = ("veu_ew", kind)

    def build():
        mode = MODE_MUL if kind == "mul" else MODE_SIGMOID
        return CompiledFragment(vecunit, key, PackedStream.empty(V), meta={"mode": mode})

    return FRAGMENTS.get(key, build) if cache else build()


def _tail(entries) -> PackedStream:
    n = len(entries)
    ops = np.array([e[0] for e in entries], np.int32)
    addrs = np.zeros((n,), np.int32)
    data = np.zeros((n, V), np.float32)
    for i, (_, vals) in enumerate(entries):
        vals = np.asarray(vals, np.float32)
        data[i, : len(vals)] = vals
    return PackedStream(ops, addrs, data)


def pack_ew_data(
    frag: CompiledFragment, a2: np.ndarray, b2: Optional[np.ndarray] = None
) -> DataStream:
    """Data stream for one (R, C) chunk: operand rows + geometry/scale
    config + trigger. The driver sizes the output scale from the ideal fp32
    result, as the FlexASR driver sizes AF exponent windows."""
    a2 = np.asarray(a2, np.float32)
    R, C = a2.shape
    assert R <= MAX_ROWS and C <= MAX_COLS
    ea = _exp_of(a2)
    bulk = [BulkWrite("vec_a", 0, _rows_of(a2), WR_A)]
    if frag.meta["mode"] == MODE_MUL:
        b2 = np.asarray(b2, np.float32)
        assert b2.shape == a2.shape
        eb = _exp_of(b2)
        eo = _exp_of(a2 * b2)
        bulk.append(BulkWrite("vec_b", 0, _rows_of(b2), WR_B))
    else:
        eb = 0.0
        eo = float(np.ceil(np.log2(1.0 / QMAX)))   # sigmoid range (0, 1)
    tail = _tail(
        [
            (CFG, (frag.meta["mode"], R, C)),
            (CFG_NUM, (ea, eb, eo)),
            (EW_START, ()),
        ]
    )
    return DataStream(bulk, tail)


def read_full(st) -> torch.Tensor:
    """Batch-polymorphic fixed-shape read of the whole output block."""
    out = st["vec_out"]
    return out.reshape(tuple(out.shape[:-2]) + (MAX_ROWS, MAX_COLS))


def build_ew_fragment(kind: str, a: np.ndarray, b: Optional[np.ndarray] = None):
    """One-shot builder (eager parity / VT cases): commands + read-out."""
    a2 = np.asarray(a, np.float32).reshape(-1, a.shape[-1]) if np.ndim(a) > 1 \
        else np.asarray(a, np.float32).reshape(1, -1)
    b2 = None if b is None else np.asarray(b, np.float32).reshape(a2.shape)
    R, C = a2.shape
    frag = ew_fragment(kind)
    cmds = frag.full_commands(pack_ew_data(frag, a2, b2))
    return cmds, lambda st: read_full(st)[..., :R, :C]


# --------------------------------------------------------------------------
# IR -> intrinsic rewrites + planner
# --------------------------------------------------------------------------


def _same_shape_guard(eg, cid, s):
    # element-wise only: no broadcasting semantics on the device
    return shape_of(eg, s["a"]) == shape_of(eg, s["b"])


def _rewrites():
    return [
        Rewrite(
            "veu-mul",
            P("mul", PV("a"), PV("b")),
            P("veu_mul", PV("a"), PV("b")),
            guard=_same_shape_guard,
        ),
        Rewrite(
            "veu-sigmoid",
            P("sigmoid", PV("x")),
            P("veu_sigmoid", PV("x")),
        ),
    ]


def plan_ew(ctx, x, args, kind):
    """Flatten the (arbitrary-rank) tensor into MAX_COLS-wide rows and chunk
    by MAX_ROWS — element-wise ops are fully driver-chunkable. Operands are
    host-broadcast first (the rewrite guard only admits equal shapes, but
    the intrinsic's declared semantics allow broadcasting)."""
    shape = np.broadcast_shapes(*[np.shape(t) for t in args])
    args = [np.broadcast_to(np.asarray(t, np.float32), shape) for t in args]
    a = args[0]
    ideal = a * args[1] if kind == "mul" else 1.0 / (1.0 + np.exp(-a))
    n = a.size
    R_total = max(1, -(-n // MAX_COLS))
    padded = [np.zeros((R_total * MAX_COLS,), np.float32) for _ in args]
    for buf, t in zip(padded, args):
        buf[:n] = np.asarray(t, np.float32).ravel()
    blocks = [buf.reshape(R_total, MAX_COLS) for buf in padded]
    frag = ew_fragment(kind)
    jobs = []
    for r0 in range(0, R_total, MAX_ROWS):
        chunk = [blk[r0 : r0 + MAX_ROWS] for blk in blocks]
        jobs.append(
            SimJob(frag, pack_ew_data(frag, *chunk), read_full,
                   (slice(0, chunk[0].shape[0]), slice(0, MAX_COLS)))
        )

    def assemble(outs):
        out = np.concatenate(outs, axis=0).ravel()[:n].reshape(a.shape)
        ctx.record(f"veu_{kind}", "vecunit", out, ideal, ctx.ncmds(jobs))
        return out.astype(np.float32)

    return jobs, assemble


# --------------------------------------------------------------------------
# IR semantics (shape + ideal oracle) and validation declarations
# --------------------------------------------------------------------------


def _shape_mul(attrs, child_shapes):
    return tuple(np.broadcast_shapes(child_shapes[0], child_shapes[1]))


def _shape_unary(attrs, child_shapes):
    return tuple(child_shapes[0])


def _ideal_mul(attrs, args):
    return args[0] * args[1]


def _ideal_sigmoid(attrs, args):
    return 1.0 / (1.0 + torch.exp(-args[0]))


def _sample_mul(r):
    if int(r.integers(2)):
        shape = (1, int(r.integers(2, 7)), int(r.integers(2, 7)), int(r.integers(1, 9)))
    else:
        shape = (int(r.integers(1, 30)), int(r.integers(1, 30)))
    return [
        r.standard_normal(shape).astype(np.float32),
        r.standard_normal(shape).astype(np.float32),
    ], {}


def _sample_sigmoid(r):
    shape = (int(r.integers(1, 30)), int(r.integers(1, 30)))
    return [(r.standard_normal(shape) * 2).astype(np.float32)], {}


def _vt2(dim_t, dim_d):
    a = ir.Var("a", (dim_t, dim_d))
    b = ir.Var("b", (dim_t, dim_d))
    return [
        VT2Case("ew-mul", ir.call("mul", a, b), ir.call("veu_mul", a, b),
                {"a": (dim_t, dim_d), "b": (dim_t, dim_d)}),
        VT2Case("ew-sigmoid", ir.call("sigmoid", a), ir.call("veu_sigmoid", a),
                {"a": (dim_t, dim_d)}),
    ]


def _mapping_cases(rng):
    """Table-2 cases: each ``case(device=None)`` returns (reference,
    simulated) as host arrays for one random input."""

    def mul_case(device=None):
        a = rng.standard_normal((16, 48)).astype(np.float32)
        b = rng.standard_normal((16, 48)).astype(np.float32)
        cmds, rd = build_ew_fragment("mul", a, b)
        return a * b, rd(vecunit.simulate(cmds, device=device)).cpu().numpy()

    def sigmoid_case(device=None):
        a = (rng.standard_normal((16, 48)) * 2).astype(np.float32)
        cmds, rd = build_ew_fragment("sigmoid", a)
        return 1.0 / (1.0 + np.exp(-a)), rd(vecunit.simulate(cmds, device=device)).cpu().numpy()

    return [("EwMul", mul_case), ("Sigmoid", sigmoid_case)]


# Cost model: operand row streams + config tail per chunk; the 16-lane ALU
# retires V elements per cycle (sigmoid takes a few iterations per element).
COSTS = CostModel("vecunit", cycles_per_command=1.0)


def _cost_ew(n_operands):
    def cost(attrs, shapes):
        n = int(np.prod(np.broadcast_shapes(*shapes))) if shapes else 1
        rows = max(1, -(-n // MAX_COLS))
        chunks = -(-rows // MAX_ROWS)
        words = rows * (MAX_COLS // V)
        lanes = 1.0 if n_operands == 2 else 4.0   # sigmoid iterates per element
        return n_operands * words + 3 * chunks, 4 * (n_operands + 1) * n, lanes * n / V

    return cost


COSTS.op("veu_mul")(_cost_ew(2))
COSTS.op("veu_sigmoid")(_cost_ew(1))


TARGET.add_intrinsic(Intrinsic(
    "veu_mul", planner=lambda ctx, x, a: plan_ew(ctx, x, a, "mul"),
    shape=_shape_mul, ideal=_ideal_mul, sample=_sample_mul, tol=1e-3,
    doc="element-wise product in int16 block fixed point"))
TARGET.add_intrinsic(Intrinsic(
    "veu_sigmoid", planner=lambda ctx, x, a: plan_ew(ctx, x, a, "sigmoid"),
    shape=_shape_unary, ideal=_ideal_sigmoid, sample=_sample_sigmoid, tol=1e-3,
    doc="element-wise logistic sigmoid"))
TARGET.add_rewrites(_rewrites)
TARGET.add_cost_model(COSTS)
TARGET.add_vt2_cases(_vt2)
TARGET.add_mapping_cases(_mapping_cases)
register_target(TARGET)
