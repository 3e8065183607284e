"""FlexASR accelerator ILA (Tambe et al., ISSCC'21) — PyTorch model.

FlexASR is a speech/NLP accelerator with coarse-grained operations (linear
layer, LSTM, temporal max/mean pooling, layer norm, attention) computing in
the **AdaptivFloat** custom numeric. Its software/hardware interface is MMIO:
the driver writes 128-bit words to configure, load data, and trigger
functions (Figure 1 of the paper). The ILA lifts each MMIO command to an
instruction over architectural state (Figure 6).

Architectural state (sizes are the model's parameters, like the real device's
SRAM sizing):

  gb_large   (GB_ROWS, V)  global buffer, V=16 lanes (128b words of fp8 AF)
  pe_w       (MAX_OUT, MAX_IN)   PE weight memory        (linear / LSTM Wi)
  pe_wh      (MAX_4H, MAX_H)     recurrent weight memory (LSTM Wh)
  pe_b       (MAX_OUT,)          bias memory
  h_state/c_state (MAX_H,)       LSTM hidden/cell state
  + configuration registers (dims, base addresses, activation mode,
    AdaptivFloat exponent biases, function select)

Instruction set (opcode == decoded MMIO address range):

  WRITE_V      store one V-lane row into gb_large[addr]
  WRITE_W      store one V-lane row slice into pe_w
  WRITE_WH     store one V-lane row slice into pe_wh
  WRITE_B      store one V-lane slice into pe_b
  PE_CFG_RNN_LAYER_SIZING   num_in / num_out
  PE_CFG_MNGR               is_bias, base addresses
  PE_CFG_ACT_MNGR           activation function select
  GB_CFG_MMNGR              gb base_in / base_out
  GB_CFG_GB_CONTROL         mode (linear/lstm/maxpool/meanpool/layernorm/attn),
                            num_timestep
  CFG_NUMERICS              AdaptivFloat exponent biases (wgt/act/out)
  FN_START                  trigger the configured function
  (read-out is host-side: slice gb_large from final state, like MMIO reads)

Semantics of FN_START in AdaptivFloat: operands are quantized to the AF
lattice with the configured exponent biases, MACs accumulate in fp32 (the
PEs accumulate wide), and results are re-quantized to AF before being stored
back to the global buffer.

The FN_START functions are written once for a state with or without a
leading batch axis (see ``repro_torch.core.ila``): each lifts what it reads
to a batch of 1 or B, computes in batched form, and stores results back at
the state's own batch size.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..core import ir
from ..core.egraph import P, V as PV, Rewrite, shape_of
from ..core.ila import (
    ILA, BulkWrite, Command, CompiledFragment, DataStream, FusedRunner,
    PackedStream, bcast, branch, fingerprint,
    fused_pad_streams, payload, read_block, register, write_block,
)
from ..device import DeviceLike, resolve
from . import numerics
from .numerics import AdaptivFloatSpec
from .target import (
    AcceleratorTarget, CostModel, Intrinsic, SimJob, VT2Case, register_target,
)

V = 16            # interface lanes (128-bit MMIO word of 8-bit AF values)
GB_ROWS = 4096    # global buffer rows
MAX_IN = 128
MAX_OUT = 256     # also holds LSTM's 4H gate rows
MAX_H = 64
MAX_TS = 128
AF = AdaptivFloatSpec(n_bits=8, n_exp=3)

# opcodes (the "MMIO address map")
WRITE_V = 0x10
WRITE_W = 0x11
WRITE_WH = 0x12
WRITE_B = 0x13
PE_CFG_RNN_LAYER_SIZING = 0x20
PE_CFG_MNGR = 0x21
PE_CFG_ACT_MNGR = 0x22
GB_CFG_MMNGR = 0x23
GB_CFG_GB_CONTROL = 0x24
CFG_NUMERICS = 0x25
FN_START = 0x30

MODE_LINEAR = 1
MODE_LSTM = 2
MODE_MAXPOOL = 3
MODE_MEANPOOL = 4
MODE_LAYERNORM = 5
MODE_ATTENTION = 6

ACT_NONE = 0
ACT_RELU = 1
ACT_SIGMOID = 2
ACT_TANH = 3

flexasr = ILA("flexasr", vwidth=V)

TARGET = AcceleratorTarget(
    "flexasr",
    flexasr,
    display_name="FlexASR",
    capabilities={
        "max_in": MAX_IN, "max_out": MAX_OUT, "max_h": MAX_H, "max_ts": MAX_TS,
        "numerics": "adaptivfloat8",
    },
    doc="speech/NLP accelerator: linear/LSTM/pooling/layernorm/attention in AdaptivFloat",
    # VT2 fragments share the same fp32 compute paths; a hair of slack for
    # the maxpool case's different-but-exact windowing route
    vt2_tol=1e-6,
)
FRAGMENTS = TARGET.fragments
# AdaptivFloat renormalizes per tensor, but the write datapath's wrap point
# for unit-scale activation data sits at |x| ~ 4.5 (numerics.BLOCK_SCALED_SAT);
# application residual streams reach +/-6 — the static range pass reports the
# reachable-wrap boundary the sat_wrap campaign fault exploits. h_state /
# c_state are recurrent by design: carried across fragments (LSTM), the
# stale_state fault surface.
TARGET.declare_lint(
    input_range=(-6.0, 6.0), carried_state=("h_state", "c_state"),
)

GB_TOTAL = GB_ROWS + MAX_TS * (MAX_IN // V)
flexasr.state("gb_large", lambda d: torch.zeros((GB_TOTAL, V), device=d))
flexasr.state("pe_w", lambda d: torch.zeros((MAX_OUT, MAX_IN), device=d))
flexasr.state("pe_wh", lambda d: torch.zeros((MAX_OUT, MAX_H), device=d))
flexasr.state("pe_b", lambda d: torch.zeros((MAX_OUT,), device=d))
flexasr.state("h_state", lambda d: torch.zeros((MAX_H,), device=d))
flexasr.state("c_state", lambda d: torch.zeros((MAX_H,), device=d))
for reg in (
    "num_in", "num_out", "num_ts", "is_bias", "act_mode", "base_in",
    "base_out", "base_aux", "mode", "exp_bias_w", "exp_bias_a", "exp_bias_o",
    "num_aux",
):
    flexasr.state(reg, lambda d: 0.0)


def _dev(st) -> torch.device:
    return st["gb_large"].device


@flexasr.instruction("write_v", WRITE_V, "store one V-lane row into gb_large")
def _write_v(st, addr, data):
    row = payload(data, _dev(st)).unsqueeze(-2)
    st["gb_large"] = write_block(st["gb_large"], row, (addr, 0))
    return st


@flexasr.instruction("write_w", WRITE_W, "store one V-lane slice into pe weight row")
def _write_w(st, addr, data):
    # addr encodes row * (MAX_IN//V) + col_block
    row = addr // (MAX_IN // V)
    col = (addr % (MAX_IN // V)) * V
    blk = payload(data, _dev(st)).unsqueeze(-2)
    st["pe_w"] = write_block(st["pe_w"], blk, (row, col))
    return st


@flexasr.instruction("write_wh", WRITE_WH, "store one V-lane slice into recurrent weight row")
def _write_wh(st, addr, data):
    row = addr // (MAX_H // V)
    col = (addr % (MAX_H // V)) * V
    blk = payload(data, _dev(st)).unsqueeze(-2)
    st["pe_wh"] = write_block(st["pe_wh"], blk, (row, col))
    return st


@flexasr.instruction("write_b", WRITE_B, "store one V-lane slice of bias")
def _write_b(st, addr, data):
    st["pe_b"] = write_block(st["pe_b"], payload(data, _dev(st)), (addr * V,))
    return st


def _cfg(names):
    def update(st, addr, data):
        for i, n in enumerate(names):
            st[n] = register(data, i)
        return st

    return update


flexasr.instruction("pe_cfg_rnn_layer_sizing", PE_CFG_RNN_LAYER_SIZING)(
    _cfg(["num_in", "num_out"])
)
flexasr.instruction("pe_cfg_mngr", PE_CFG_MNGR)(_cfg(["is_bias"]))
flexasr.instruction("pe_cfg_act_mngr", PE_CFG_ACT_MNGR)(_cfg(["act_mode"]))
flexasr.instruction("gb_cfg_mmngr", GB_CFG_MMNGR)(_cfg(["base_in", "base_out", "base_aux", "num_aux"]))
flexasr.instruction("gb_cfg_gb_control", GB_CFG_GB_CONTROL)(_cfg(["mode", "num_ts"]))
flexasr.instruction("cfg_numerics", CFG_NUMERICS)(
    _cfg(["exp_bias_w", "exp_bias_a", "exp_bias_o"])
)


# -- FN_START: the coarse compute, in AdaptivFloat ---------------------------


def _afq(x, bias):
    return numerics.af_quantize(x, AF, exp_bias=bias)


def _idx(r):
    """A register used as an index (``astype(int32)``: truncation)."""
    return r.to(torch.int64) if isinstance(r, torch.Tensor) else int(r)


def _num(r, nd: int, dev):
    """A register as a divisor/operand tensor broadcasting against
    ``(B, *nd dims)`` (a device tensor even when host-known, so division
    is a true elementwise division on every device)."""
    if isinstance(r, torch.Tensor):
        return bcast(r, nd)
    return torch.full((), r, dtype=torch.float32, device=dev)


def _fit(st, t):
    """A batched-form result at the state's own batch size: the natural
    shape for an unbatched state, else ``B`` rows."""
    B = flexasr.batch_size(st)
    if B is None:
        return t[0]
    return t if t.shape[0] == B else t.expand((B,) + tuple(t.shape[1:]))


def _gb_matrix(st, base):
    """The (MAX_TS, MAX_IN) tensor stored as MAX_TS*(MAX_IN//V) rows of
    gb_large at ``base``, as (1 or B, MAX_TS, MAX_IN)."""
    rows = read_block(st["gb_large"], (_idx(base), 0), (MAX_TS * (MAX_IN // V), V))
    return rows.reshape(-1, MAX_TS, MAX_IN)


def _store(st, Y):
    """Write a (1 or B, MAX_TS, MAX_IN) result to gb_large at base_out."""
    rows = _fit(st, Y.reshape(-1, MAX_TS * (MAX_IN // V), V))
    st["gb_large"] = write_block(st["gb_large"], rows, (_idx(st["base_out"]), 0))


_ACTS = [
    lambda v: v,
    lambda v: torch.clamp(v, min=0.0),
    lambda v: 1.0 / (1.0 + numerics.exp_f32(-v)),
    lambda v: torch.tanh(v),
]


def _act(y, mode):
    return branch(mode, _ACTS, y)


def _mask1(n, size, dev):
    """(1 or B, size) mask of the first ``n`` positions."""
    ar = torch.arange(size, device=dev)
    if isinstance(n, torch.Tensor):
        return (ar[None, :] < n.to(torch.int64)[:, None]).float()
    return (ar < int(n)).float()[None, :]


def _fn_linear(st):
    dev = _dev(st)
    X = _gb_matrix(st, st["base_in"])                           # (B, MAX_TS, MAX_IN)
    m_in = _mask1(st["num_in"], MAX_IN, dev)
    m_out = _mask1(st["num_out"], MAX_OUT, dev)
    m_ts = _mask1(st["num_ts"], MAX_TS, dev)
    Wq = _afq(flexasr.lift(st, "pe_w"), bcast(st["exp_bias_w"], 2)) \
        * m_out[:, :, None] * m_in[:, None, :]
    Xq = _afq(X, bcast(st["exp_bias_a"], 2)) * m_ts[:, :, None] * m_in[:, None, :]
    b = flexasr.lift(st, "pe_b")[:, :MAX_OUT] * m_out * bcast(st["is_bias"], 1)
    Y = Xq @ Wq.mT + b[:, None, :]
    Y = _act(Y, st["act_mode"])
    Y = _afq(Y, bcast(st["exp_bias_o"], 2)) * m_ts[:, :, None] * m_out[:, None, :]
    # store back to gb at base_out, MAX_IN-wide rows (num_out <= MAX_IN lanes used)
    _store(st, Y[:, :, :MAX_IN])
    return st


def _fn_lstm(st):
    dev = _dev(st)
    X = _gb_matrix(st, st["base_in"])                           # (B, MAX_TS, MAX_IN)
    m_in = _mask1(st["num_in"], MAX_IN, dev)
    H = MAX_H
    m_h = _mask1(st["num_out"], H, dev)
    bw, ba, bo = (st[k] for k in ("exp_bias_w", "exp_bias_a", "exp_bias_o"))
    Wi = _afq(flexasr.lift(st, "pe_w"), bcast(bw, 2)) * m_in[:, None, :]    # (B, 4H, MAX_IN)
    Wh = _afq(flexasr.lift(st, "pe_wh"), bcast(bw, 2)) * m_h[:, None, :]    # (B, 4H, H)
    b = flexasr.lift(st, "pe_b") * bcast(st["is_bias"], 1)
    h, c = flexasr.lift(st, "h_state"), flexasr.lift(st, "c_state")
    hs = []
    for t in range(MAX_TS):
        xq = _afq(X[:, t], bcast(ba, 1)) * m_in
        gates = (Wi[:, : 4 * H] @ xq[:, :, None])[..., 0] \
            + (Wh[:, : 4 * H] @ h[:, :, None])[..., 0] + b[:, : 4 * H]
        i = torch.sigmoid(gates[:, 0 * H : 1 * H])
        f = torch.sigmoid(gates[:, 1 * H : 2 * H])
        g = torch.tanh(gates[:, 2 * H : 3 * H])
        o = torch.sigmoid(gates[:, 3 * H : 4 * H])
        c = _afq(f * c + i * g, bcast(bo, 1)) * m_h
        h = _afq(o * torch.tanh(c), bcast(bo, 1)) * m_h
        hs.append(h)
    m_ts = _mask1(st["num_ts"], MAX_TS, dev)
    hs = torch.stack(hs, dim=1) * m_ts[:, :, None]
    out = torch.zeros((hs.shape[0], MAX_TS, MAX_IN), device=dev)
    out[:, :, :H] = hs
    st["h_state"], st["c_state"] = _fit(st, h), _fit(st, c)
    _store(st, out)
    return st


def _fn_pool(st, kind):
    dev = _dev(st)
    X = _gb_matrix(st, st["base_in"])            # rows = timesteps
    # temporal pooling: pairwise over timestep axis (window (2,1) stride (2,1))
    pairs = X.reshape(-1, MAX_TS // 2, 2, MAX_IN)
    Y = torch.amax(pairs, dim=2) if kind == "max" else torch.mean(pairs, dim=2)
    Y = _afq(Y, bcast(st["exp_bias_o"], 2))
    n_ts = st["num_ts"]
    half = torch.ceil(n_ts / 2) if isinstance(n_ts, torch.Tensor) else math.ceil(n_ts / 2)
    m_ts = _mask1(half, MAX_TS // 2, dev)
    m_in = _mask1(st["num_in"], MAX_IN, dev)
    Y = Y * m_ts[:, :, None] * m_in[:, None, :]
    out = torch.zeros((Y.shape[0], MAX_TS, MAX_IN), device=dev)
    out[:, : MAX_TS // 2] = Y
    _store(st, out)
    return st


def _fn_layernorm(st):
    dev = _dev(st)
    X = _gb_matrix(st, st["base_in"])
    m_in = _mask1(st["num_in"], MAX_IN, dev)[:, None, :]
    n = _num(st["num_in"], 2, dev)
    Xq = _afq(X, bcast(st["exp_bias_a"], 2)) * m_in
    mu = torch.sum(Xq, dim=-1, keepdim=True) / n
    var = torch.sum(((Xq - mu) * m_in) ** 2, dim=-1, keepdim=True) / n
    gamma = flexasr.lift(st, "pe_w")[:, 0, :MAX_IN]
    beta = flexasr.lift(st, "pe_b")[:, :MAX_IN]
    Y = ((Xq - mu) / torch.sqrt(var + 1e-5) * gamma[:, None, :] + beta[:, None, :]) * m_in
    Y = _afq(Y, bcast(st["exp_bias_o"], 2)) * m_in
    m_ts = _mask1(st["num_ts"], MAX_TS, dev)
    _store(st, Y * m_ts[:, :, None])
    return st


def _fn_attention(st):
    dev = _dev(st)
    # Q at base_in (num_ts rows), K at base_aux, V at base_aux + MAX block
    Q = _gb_matrix(st, st["base_in"])            # (B, MAX_TS, MAX_IN)
    K = _gb_matrix(st, st["base_aux"])
    Vv = _gb_matrix(st, st["base_aux"] + MAX_TS * (MAX_IN // V))
    m_in = _mask1(st["num_in"], MAX_IN, dev)[:, None, :]
    m_q = _mask1(st["num_ts"], MAX_TS, dev)[:, :, None]
    m_k = _mask1(st["num_aux"], MAX_TS, dev)
    ba = bcast(st["exp_bias_a"], 2)
    Qq = _afq(Q, ba) * m_q * m_in
    Kq = _afq(K, ba) * m_k[:, :, None] * m_in
    Vq = _afq(Vv, ba) * m_k[:, :, None] * m_in
    scores = (Qq @ Kq.mT) / torch.sqrt(_num(st["num_in"], 2, dev))
    scores = torch.where(m_k[:, None, :] > 0, scores, -torch.inf)
    # softmax in the PE's fp accumulation, then AF re-quantized
    p = torch.softmax(scores, dim=-1)
    p = _afq(p, 0.0 - (2 ** AF.n_exp - 1))   # probs in [0,1]: bias pins max exp at 0
    Y = (p @ Vq) * m_q * m_in
    Y = _afq(Y, bcast(st["exp_bias_o"], 2)) * m_q * m_in
    _store(st, Y)
    return st


_FNS = [
    _fn_linear,
    _fn_lstm,
    lambda s: _fn_pool(s, "max"),
    lambda s: _fn_pool(s, "mean"),
    _fn_layernorm,
    _fn_attention,
]


@flexasr.instruction("fn_start", FN_START, "trigger the configured function")
def _fn_start(st, addr, data):
    # the reference's FN_START is a lax.switch, whose six branches XLA
    # compiles as one computation even in its eager tier: compiled forms
    # (numerics.tier's default)
    mode = st["mode"]
    if not isinstance(mode, torch.Tensor):
        return branch(int(mode) - 1, _FNS, st)
    # per-stream modes: each selected function on its own copy of the state
    B = int(mode.shape[0])
    return branch(
        mode.to(torch.int64) - 1, [lambda f=f: f(flexasr.own(st)) for f in _FNS],
        merge=lambda parts: flexasr.merge_rows(parts, B),
    )


# --------------------------------------------------------------------------
# Driver-side fragment builders (the IR-accelerator mappings, Figure 5)
#
# Each builder is split into a *setup* stream (weight/config load, built and
# simulated once per parameter set, cached as post-setup architectural state)
# and a *data* stream (activation rows + FN_START, re-packed per sample).
# ``build_*_fragment`` keeps the original one-shot API: setup + data
# concatenated into a single eager-simulable command list.
# --------------------------------------------------------------------------


def _rows_of(x: np.ndarray) -> np.ndarray:
    """Marshal a (T, D) tensor into V-lane rows padded to (MAX_TS, MAX_IN)."""
    T, D = x.shape
    buf = np.zeros((MAX_TS, MAX_IN), np.float32)
    buf[:T, :D] = np.asarray(x, np.float32)
    return buf.reshape(MAX_TS * (MAX_IN // V), V)


def _matrix_bulk(base: int, x: np.ndarray) -> BulkWrite:
    """(T, D) tensor -> bulk WRITE_V run: T*(MAX_IN//V) rows at ``base``."""
    n = x.shape[0] * (MAX_IN // V)
    return BulkWrite("gb_large", base, _rows_of(x)[:n], WRITE_V)


def _tail(entries) -> PackedStream:
    """Pack [(opcode, values), ...] config/trigger commands into a stream."""
    n = len(entries)
    ops = np.array([e[0] for e in entries], np.int32)
    addrs = np.zeros((n,), np.int32)
    data = np.zeros((n, V), np.float32)
    for i, (_, vals) in enumerate(entries):
        vals = np.asarray(vals, np.float32)
        data[i, : len(vals)] = vals
    return PackedStream(ops, addrs, data)


def _write_weight_cmds(w: np.ndarray) -> List[Command]:
    O, I = w.shape
    cmds = []
    for r in range(O):
        for cb in range((I + V - 1) // V):
            seg = np.zeros((V,), np.float32)
            seg[: min(V, I - cb * V)] = w[r, cb * V : cb * V + min(V, I - cb * V)]
            cmds.append(Command(WRITE_W, r * (MAX_IN // V) + cb, tuple(seg)))
    return cmds


def _write_wh_cmds(w: np.ndarray) -> List[Command]:
    O, H = w.shape
    cmds = []
    for r in range(O):
        for cb in range((H + V - 1) // V):
            seg = np.zeros((V,), np.float32)
            seg[: min(V, H - cb * V)] = w[r, cb * V : cb * V + min(V, H - cb * V)]
            cmds.append(Command(WRITE_WH, r * (MAX_H // V) + cb, tuple(seg)))
    return cmds


def _write_bias_cmds(b: np.ndarray) -> List[Command]:
    n = len(b)
    cmds = []
    for blk in range((n + V - 1) // V):
        seg = np.zeros((V,), np.float32)
        seg[: min(V, n - blk * V)] = b[blk * V : blk * V + min(V, n - blk * V)]
        cmds.append(Command(WRITE_B, blk, tuple(seg)))
    return cmds


def _exp_biases(*tensors):
    """Per-tensor AF exponent biases, computed on the host CPU (planners
    run on the pack worker and touch no device)."""
    return numerics.af_exp_biases(
        [torch.from_numpy(np.asarray(t, np.float32)) for t in tensors], AF).tolist()


def _read_matrix(st, base: int, T: int, D: int) -> torch.Tensor:
    rows = read_block(st["gb_large"], (base, 0), (MAX_TS * (MAX_IN // V), V))
    return rows.reshape(rows.shape[:-2] + (MAX_TS, MAX_IN))[..., :T, :D]


BASE_IN = 0
BASE_OUT = MAX_TS * (MAX_IN // V)
BASE_AUX = 2 * MAX_TS * (MAX_IN // V)


def read_full(st) -> torch.Tensor:
    """Fixed-shape output read (batch-polymorphic): the whole (MAX_TS,
    MAX_IN) output block, per stream for a batched state; callers slice the
    valid [:T, :D] window host-side."""
    return _read_matrix(st, BASE_OUT, MAX_TS, MAX_IN)


def _setup_stream(weight_cmds: List[Command], cfg) -> PackedStream:
    return PackedStream.concat([PackedStream.from_commands(weight_cmds, V), _tail(cfg)])


# -- LinearLayer -------------------------------------------------------------


def linear_fragment(w, b, act: int = ACT_NONE, cache: bool = True) -> CompiledFragment:
    """Setup half of the LinearLayer mapping: weights + bias resident in PE
    memory, sizing/activation configured. Cached per parameter set."""
    w, b = np.asarray(w, np.float32), np.asarray(b, np.float32)
    O, I = w.shape
    assert I <= MAX_IN and O <= MAX_OUT and O <= MAX_IN

    key = ("fasr_linear", I, O, int(act), fingerprint(w, b))

    def build():
        (bw,) = _exp_biases(w)
        setup = _setup_stream(
            _write_weight_cmds(w) + _write_bias_cmds(b),
            [
                (PE_CFG_RNN_LAYER_SIZING, (I, O)),
                (PE_CFG_MNGR, (1.0,)),
                (PE_CFG_ACT_MNGR, (float(act),)),
                (GB_CFG_MMNGR, (BASE_IN, BASE_OUT, 0, 0)),
            ],
        )
        return CompiledFragment(
            flexasr, key, setup, meta={"w": w, "b": b, "bw": bw, "I": I, "O": O}
        )

    return FRAGMENTS.get(key, build) if cache else build()


def pack_linear_data(frag: CompiledFragment, x) -> DataStream:
    """Data half: activation rows + per-sample AF exponent windows + trigger.
    The driver sizes the output window from the ideal fp32 result, exactly
    as the one-shot builder did."""
    x = np.asarray(x, np.float32)
    T = x.shape[0]
    assert T <= MAX_TS and x.shape[1] == frag.meta["I"]
    ideal = x @ frag.meta["w"].T + frag.meta["b"]
    ba, bo = _exp_biases(x, ideal)
    tail = _tail(
        [
            (GB_CFG_GB_CONTROL, (MODE_LINEAR, T)),
            (CFG_NUMERICS, (frag.meta["bw"], ba, bo)),
            (FN_START, ()),
        ]
    )
    return DataStream([_matrix_bulk(BASE_IN, x)], tail)


def build_linear_fragment(x, w, b, act: int = ACT_NONE):
    """nn.dense + bias_add -> FlexASR LinearLayer fragment (Figure 5)."""
    x = np.asarray(x, np.float32)
    T, O = x.shape[0], np.asarray(w).shape[0]
    frag = linear_fragment(w, b, act)
    cmds = frag.full_commands(pack_linear_data(frag, x))
    return cmds, lambda st: _read_matrix(st, BASE_OUT, T, O)


# -- LSTM --------------------------------------------------------------------


def lstm_fragment(wi, wh, b, cache: bool = True) -> CompiledFragment:
    wi, wh, b = (np.asarray(t, np.float32) for t in (wi, wh, b))
    I, H = wi.shape[1], wh.shape[1]
    assert I <= MAX_IN and 4 * H <= MAX_OUT and H <= MAX_H

    key = ("fasr_lstm", I, H, fingerprint(wi, wh, b))

    def build():
        (bw,) = _exp_biases(np.concatenate([wi.ravel(), wh.ravel()]))
        bo = 0.0 - (2 ** AF.n_exp - 1)  # h,c in (-1,1): top exponent 0
        # PE gate memory layout: gate g occupies rows [g*MAX_H, g*MAX_H + H)
        wi_p = np.zeros((4 * MAX_H, wi.shape[1]), np.float32)
        wh_p = np.zeros((4 * MAX_H, wh.shape[1]), np.float32)
        b_p = np.zeros((4 * MAX_H,), np.float32)
        for g in range(4):
            wi_p[g * MAX_H : g * MAX_H + H] = wi[g * H : (g + 1) * H]
            wh_p[g * MAX_H : g * MAX_H + H] = wh[g * H : (g + 1) * H]
            b_p[g * MAX_H : g * MAX_H + H] = b[g * H : (g + 1) * H]
        setup = _setup_stream(
            _write_weight_cmds(wi_p) + _write_wh_cmds(wh_p) + _write_bias_cmds(b_p),
            [
                (PE_CFG_RNN_LAYER_SIZING, (I, H)),
                (PE_CFG_MNGR, (1.0,)),
                (GB_CFG_MMNGR, (BASE_IN, BASE_OUT, 0, 0)),
            ],
        )
        return CompiledFragment(
            flexasr, key, setup,
            meta={"bw": bw, "bo": bo, "I": I, "H": H,
                  "wi_p": wi_p, "wh_p": wh_p, "b_p": b_p},
        )

    return FRAGMENTS.get(key, build) if cache else build()


def pack_lstm_data(frag: CompiledFragment, x) -> DataStream:
    x = np.asarray(x, np.float32)
    T = x.shape[0]
    assert T <= MAX_TS and x.shape[1] == frag.meta["I"]
    (ba,) = _exp_biases(x)
    tail = _tail(
        [
            (GB_CFG_GB_CONTROL, (MODE_LSTM, T)),
            (CFG_NUMERICS, (frag.meta["bw"], ba, frag.meta["bo"])),
            (FN_START, ()),
        ]
    )
    return DataStream([_matrix_bulk(BASE_IN, x)], tail)


def build_lstm_fragment(x, wi, wh, b):
    """Unrolled-LSTM IR fragment -> ONE FlexASR LSTM invocation (the
    paper's 566-ops-to-1-instruction granularity bridge)."""
    x = np.asarray(x, np.float32)
    T, H = x.shape[0], np.asarray(wh).shape[1]
    frag = lstm_fragment(wi, wh, b)
    cmds = frag.full_commands(pack_lstm_data(frag, x))
    return cmds, lambda st: _read_matrix(st, BASE_OUT, T, H)


# -- temporal pooling --------------------------------------------------------


def pool_fragment(D: int, kind: str = "max", cache: bool = True) -> CompiledFragment:
    assert D <= MAX_IN
    key = ("fasr_pool", D, kind)

    def build():
        setup = _tail(
            [
                (PE_CFG_RNN_LAYER_SIZING, (D, D)),
                (GB_CFG_MMNGR, (BASE_IN, BASE_OUT, 0, 0)),
            ]
        )
        mode = MODE_MAXPOOL if kind == "max" else MODE_MEANPOOL
        return CompiledFragment(flexasr, key, setup, meta={"mode": mode, "D": D})

    return FRAGMENTS.get(key, build) if cache else build()


def pack_pool_data(frag: CompiledFragment, x) -> DataStream:
    x = np.asarray(x, np.float32)
    T = x.shape[0]
    assert T <= MAX_TS and x.shape[1] == frag.meta["D"]
    (bo,) = _exp_biases(x)
    tail = _tail(
        [
            (GB_CFG_GB_CONTROL, (frag.meta["mode"], T)),
            (CFG_NUMERICS, (0.0, 0.0, bo)),
            (FN_START, ()),
        ]
    )
    return DataStream([_matrix_bulk(BASE_IN, x)], tail)


def build_pool_fragment(x, kind="max"):
    x = np.asarray(x, np.float32)
    T, D = x.shape
    frag = pool_fragment(D, kind)
    cmds = frag.full_commands(pack_pool_data(frag, x))
    return cmds, lambda st: _read_matrix(st, BASE_OUT, T // 2, D)


# -- layer norm --------------------------------------------------------------


def layernorm_fragment(gamma, beta, cache: bool = True) -> CompiledFragment:
    gamma, beta = np.asarray(gamma, np.float32), np.asarray(beta, np.float32)
    D = gamma.shape[0]
    assert D <= MAX_IN
    key = ("fasr_layernorm", D, fingerprint(gamma, beta))

    def build():
        setup = _setup_stream(
            _write_weight_cmds(gamma[None, :]) + _write_bias_cmds(beta),
            [
                (PE_CFG_RNN_LAYER_SIZING, (D, D)),
                (GB_CFG_MMNGR, (BASE_IN, BASE_OUT, 0, 0)),
            ],
        )
        return CompiledFragment(
            flexasr, key, setup, meta={"gamma": gamma, "beta": beta, "D": D}
        )

    return FRAGMENTS.get(key, build) if cache else build()


def pack_layernorm_data(frag: CompiledFragment, x) -> DataStream:
    x = np.asarray(x, np.float32)
    T = x.shape[0]
    assert T <= MAX_TS and x.shape[1] == frag.meta["D"]
    # the driver sizes the output exponent window from the ideal result
    mu = x.mean(-1, keepdims=True)
    va = x.var(-1, keepdims=True)
    ideal = (x - mu) / np.sqrt(va + 1e-5) * frag.meta["gamma"] + frag.meta["beta"]
    ba, bo = _exp_biases(x, ideal)
    tail = _tail(
        [
            (GB_CFG_GB_CONTROL, (MODE_LAYERNORM, T)),
            (CFG_NUMERICS, (0.0, ba, bo)),
            (FN_START, ()),
        ]
    )
    return DataStream([_matrix_bulk(BASE_IN, x)], tail)


def build_layernorm_fragment(x, gamma, beta):
    x = np.asarray(x, np.float32)
    T, D = x.shape
    frag = layernorm_fragment(gamma, beta)
    cmds = frag.full_commands(pack_layernorm_data(frag, x))
    return cmds, lambda st: _read_matrix(st, BASE_OUT, T, D)


# -- attention ---------------------------------------------------------------


def attention_fragment(D: int, cache: bool = True) -> CompiledFragment:
    assert D <= MAX_IN
    key = ("fasr_attention", D)

    def build():
        setup = _tail([(PE_CFG_RNN_LAYER_SIZING, (D, D))])
        return CompiledFragment(flexasr, key, setup, meta={"D": D})

    return FRAGMENTS.get(key, build) if cache else build()


def pack_attention_data(frag: CompiledFragment, q, k, v) -> DataStream:
    q, k, v = (np.asarray(t, np.float32) for t in (q, k, v))
    Tq, D = q.shape
    Tk = k.shape[0]
    assert Tq <= MAX_TS and Tk <= MAX_TS and D == frag.meta["D"]
    s = (q @ k.T) / np.sqrt(q.shape[1])
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    ba, bo = _exp_biases(np.concatenate([q.ravel(), k.ravel(), v.ravel()]), p @ v)
    tail = _tail(
        [
            (GB_CFG_MMNGR, (BASE_IN, BASE_OUT, BASE_AUX, Tk)),
            (GB_CFG_GB_CONTROL, (MODE_ATTENTION, Tq)),
            (CFG_NUMERICS, (0.0, ba, bo)),
            (FN_START, ()),
        ]
    )
    return DataStream(
        [
            _matrix_bulk(BASE_IN, q),
            _matrix_bulk(BASE_AUX, k),
            _matrix_bulk(BASE_AUX + MAX_TS * (MAX_IN // V), v),
        ],
        tail,
    )


def build_attention_fragment(q, k, v):
    q = np.asarray(q, np.float32)
    Tq, D = q.shape
    frag = attention_fragment(D)
    cmds = frag.full_commands(pack_attention_data(frag, q, k, v))
    return cmds, lambda st: _read_matrix(st, BASE_OUT, Tq, D)


# --------------------------------------------------------------------------
# IR -> intrinsic rewrites (instruction selection; guards = device capacity)
# --------------------------------------------------------------------------


def _linear_guard(eg, cid, s):
    b = shape_of(eg, s["b"])
    return len(shape_of(eg, s["c"])) == 1 and b[1] <= MAX_IN and b[0] <= MAX_IN


def _lstm_guard(eg, cid, s):
    wi = shape_of(eg, s["wi"])
    wh = shape_of(eg, s["wh"])
    return wi[1] <= MAX_IN and wh[1] <= MAX_H


def _attn_guard(eg, cid, s):
    q = shape_of(eg, s["q"])
    k = shape_of(eg, s["k"])
    # KV length is not driver-chunkable, hence the MAX_TS guard
    return q[-1] <= MAX_IN and q[-2] <= MAX_TS and k[-2] <= MAX_TS


def _rewrites():
    return [
        Rewrite(
            "fasr-linear",
            P("bias_add", P("dense", PV("a"), PV("b")), PV("c")),
            P("fasr_linear", PV("a"), PV("b"), PV("c")),
            guard=_linear_guard,
        ),
        Rewrite(
            "fasr-lstm",
            P("lstm", PV("x"), PV("wi"), PV("wh"), PV("b")),
            P("fasr_lstm", PV("x"), PV("wi"), PV("wh"), PV("b")),
            guard=_lstm_guard,
        ),
        Rewrite(
            "fasr-attention",
            P("attention", PV("q"), PV("k"), PV("v")),
            P("fasr_attention", PV("q"), PV("k"), PV("v")),
            guard=_attn_guard,
        ),
        Rewrite(
            "fasr-layernorm",
            P("layer_norm", PV("x"), PV("g"), PV("b"), attr_binds=("eps",)),
            P("fasr_layernorm", PV("x"), PV("g"), PV("b"), attr_binds=("eps",)),
            guard=lambda eg, cid, s: shape_of(eg, s["x"])[-1] <= MAX_IN,
        ),
        Rewrite(
            "fasr-maxpool",
            P(
                "reduce_max",
                P("windows", PV("T"), attrs=(("wh", 2), ("ww", 1), ("sh", 2), ("sw", 1))),
                attrs=(("axis", (2, 3)),),
            ),
            # no width guard: pooling is elementwise across features, so the
            # driver chunks wide matrices column-wise (plan_pool)
            P("fasr_load", P("fasr_maxpool", P("fasr_store", PV("T")))),
        ),
        Rewrite(
            "fasr-meanpool",
            P(
                "reduce_mean",
                P("windows", PV("T"), attrs=(("wh", 2), ("ww", 1), ("sh", 2), ("sw", 1))),
                attrs=(("axis", (2, 3)),),
            ),
            P("fasr_load", P("fasr_meanpool", P("fasr_store", PV("T")))),
        ),
        # Section 5.1: cancel redundant accelerator<->host round trips
        Rewrite(
            "fasr-store-load-cancel",
            P("fasr_store", P("fasr_load", PV("x"))),
            PV("x"),
        ),
    ]


# --------------------------------------------------------------------------
# Intrinsic planners (op -> SimJobs; driver chunking lives here)
#
# Planners are the *pack* stage of the pipelined Executor: they run in a
# pack worker thread and must stay host-only (numpy, and CPU torch for the
# exponent biases; no device work). The fp32 references recorded for the
# rel-err stats are therefore computed with numpy mirrors of the IR oracle —
# diagnostics only, never fed into the simulated numerics.
# --------------------------------------------------------------------------


def _np_sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _ideal_lstm(xs: np.ndarray, wi: np.ndarray, wh: np.ndarray, b: np.ndarray) -> np.ndarray:
    """numpy mirror of ``ir._lstm`` (fused i,f,g,o gates) for plan-time
    stats: far cheaper than per-sample device dispatch on the pack
    worker's hot path."""
    T, B, _ = xs.shape
    H = wh.shape[1]
    h = np.zeros((B, H), np.float32)
    c = np.zeros((B, H), np.float32)
    outs = np.empty((T, B, H), np.float32)
    for t in range(T):
        gates = xs[t] @ wi.T + h @ wh.T + b
        i = _np_sigmoid(gates[:, 0 * H : 1 * H])
        f = _np_sigmoid(gates[:, 1 * H : 2 * H])
        g = np.tanh(gates[:, 2 * H : 3 * H])
        o = _np_sigmoid(gates[:, 3 * H : 4 * H])
        c = f * c + i * g
        h = o * np.tanh(c)
        outs[t] = h
    return outs


def _ideal_attention(q: np.ndarray, k: np.ndarray, v: np.ndarray) -> np.ndarray:
    """numpy mirror of ``ir._attention`` for plan-time stats."""
    s = (q @ np.swapaxes(k, -1, -2)) / np.sqrt(np.float32(q.shape[-1]))
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return p @ v


def kernel_linear(ctx, x, args):
    """Deployment fast path: the af_gemm CUDA kernel (same AF lattice) on
    the Executor's device; its plain version on the CPU."""
    from ..kernels import ops as kops

    a, w, b = args
    orig_shape = a.shape
    a2 = a.reshape(-1, a.shape[-1])
    ideal_full = a2 @ w.T + b
    t = [payload(np.asarray(v, np.float32), ctx.device) for v in (a2, w, b)]
    out = kops.af_linear(*t).cpu().numpy()
    ctx.record("fasr_linear", "flexasr-kernel", out, ideal_full, 0)
    return out.reshape(orig_shape[:-1] + (w.shape[0],))


def plan_linear(ctx, x, args):
    a, w, b = args
    orig_shape = a.shape
    a2 = a.reshape(-1, a.shape[-1])
    O = w.shape[0]
    ideal_full = a2 @ w.T + b
    frag = linear_fragment(w, b)
    jobs = [
        SimJob(frag, pack_linear_data(frag, chunk), read_full,
               (slice(0, chunk.shape[0]), slice(0, O)))
        for chunk in ctx.chunk_rows(a2, MAX_TS)
    ]

    def assemble(outs):
        out = np.concatenate(outs, axis=0)
        ctx.record("fasr_linear", "flexasr", out, ideal_full, ctx.ncmds(jobs))
        return out.reshape(orig_shape[:-1] + (O,))

    return jobs, assemble


def plan_lstm(ctx, x, args):
    xs, wi, wh, b = args
    T, B, I = xs.shape
    H = wh.shape[1]
    ideal = _ideal_lstm(xs, wi, wh, b)
    frag = lstm_fragment(wi, wh, b)
    jobs = [
        SimJob(frag, pack_lstm_data(frag, xs[:, bi]), read_full,
               (slice(0, T), slice(0, H)))
        for bi in range(B)
    ]

    def assemble(outs):
        out = np.stack(outs, axis=1)
        ctx.record("fasr_lstm", "flexasr", out, ideal, ctx.ncmds(jobs))
        return out

    return jobs, assemble


def plan_pool(ctx, x, args, kind):
    (a,) = args
    T = a.shape[0]
    pairs = a[: T - T % 2].reshape(T // 2, 2, *a.shape[1:])
    ideal = pairs.max(1) if kind == "max" else pairs.mean(1)
    jobs, layout = [], []
    for chunk in ctx.chunk_rows(a, MAX_TS):
        # pooling is elementwise across features: chunk wide matrices
        # column-wise to fit the device's MAX_IN lanes
        cols = []
        for c0 in range(0, chunk.shape[1], MAX_IN):
            piece = chunk[:, c0 : c0 + MAX_IN]
            frag = pool_fragment(piece.shape[1], kind)
            jobs.append(
                SimJob(frag, pack_pool_data(frag, piece), read_full,
                       (slice(0, piece.shape[0] // 2), slice(0, piece.shape[1])))
            )
            cols.append(len(jobs) - 1)
        layout.append(cols)

    def assemble(outs):
        rows = [np.concatenate([outs[i] for i in cols], axis=1) for cols in layout]
        out = np.concatenate(rows, axis=0)
        ctx.record(f"fasr_{kind}pool", "flexasr", out, ideal, ctx.ncmds(jobs))
        return out

    return jobs, assemble


def plan_layernorm(ctx, x, args):
    a, g, b = args
    orig = a.shape
    a2 = a.reshape(-1, a.shape[-1])
    mu = a2.mean(-1, keepdims=True)
    va = a2.var(-1, keepdims=True)
    ideal = (a2 - mu) / np.sqrt(va + 1e-5) * g + b
    frag = layernorm_fragment(g, b)
    D = a2.shape[1]
    jobs = [
        SimJob(frag, pack_layernorm_data(frag, chunk), read_full,
               (slice(0, chunk.shape[0]), slice(0, D)))
        for chunk in ctx.chunk_rows(a2, MAX_TS)
    ]

    def assemble(outs):
        out = np.concatenate(outs, axis=0).reshape(orig)
        ctx.record("fasr_layernorm", "flexasr", out, ideal, ctx.ncmds(jobs))
        return out

    return jobs, assemble


def plan_attention(ctx, x, args):
    q, k, v = args
    ideal = _ideal_attention(q, k, v)
    D = q.shape[-1]
    frag = attention_fragment(D)
    if q.ndim == 2:
        jobs = [
            SimJob(frag, pack_attention_data(frag, q, k, v), read_full,
                   (slice(0, q.shape[0]), slice(0, v.shape[-1])))
        ]

        def assemble(outs):
            ctx.record("fasr_attention", "flexasr", outs[0], ideal, ctx.ncmds(jobs))
            return outs[0]

        return jobs, assemble
    # batch of heads: one invocation per (batch) slice, batched in sim
    q2 = q.reshape(-1, q.shape[-2], q.shape[-1])
    k2 = k.reshape(-1, k.shape[-2], k.shape[-1])
    v2 = v.reshape(-1, v.shape[-2], v.shape[-1])
    jobs = [
        SimJob(frag, pack_attention_data(frag, q2[i], k2[i], v2[i]), read_full,
               (slice(0, q2.shape[1]), slice(0, v2.shape[2])))
        for i in range(q2.shape[0])
    ]

    def assemble(outs):
        out = np.stack(outs).reshape(q.shape[:-1] + (v.shape[-1],))
        ctx.record("fasr_attention", "flexasr", out, ideal, ctx.ncmds(jobs))
        return out

    return jobs, assemble


# --------------------------------------------------------------------------
# Cost model: analytic commands / bytes / cycles from operand shapes
# --------------------------------------------------------------------------
#
# Commands mirror the fragment builders above (setup weight load + per-row
# data stream over V lanes, config/trigger tails per MAX_TS chunk); compute
# cycles assume the PE array retires V MACs per cycle. CostModel.calibrate
# trims the command predictions against what the planners actually emit.

COSTS = CostModel("flexasr", cycles_per_command=1.0)


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def _nrows(shape) -> int:
    return int(np.prod(shape[:-1])) if len(shape) > 1 else 1


@COSTS.op("fasr_linear")
def _cost_linear(attrs, shapes):
    a, w = shapes[0], shapes[1]
    rows, I, O = _nrows(a), a[-1], w[0]
    setup = O * _cdiv(I, V) + _cdiv(O, V) + 4
    data = rows * _cdiv(I, V) + 5 * _cdiv(rows, MAX_TS)
    return setup + data, 4 * (rows * I + O * I + O + rows * O), rows * O * I / V


@COSTS.op("fasr_lstm")
def _cost_lstm(attrs, shapes):
    (T, B, I), wi, wh = shapes[0], shapes[1], shapes[2]
    gates, H = wi[0], wh[1]
    setup = gates * _cdiv(I, V) + gates * _cdiv(H, V) + _cdiv(gates, V) + 4
    data = B * (T * _cdiv(I, V) + 5)
    moved = 4 * (T * B * I + gates * (I + H + 1) + T * B * H)
    return setup + data, moved, T * B * gates * (I + H) / V


def _cost_pool(attrs, shapes):
    T = shapes[0][0]
    D = int(np.prod(shapes[0][1:])) if len(shapes[0]) > 1 else 1
    chunks = _cdiv(T, MAX_TS) * _cdiv(D, MAX_IN)
    return T * _cdiv(D, V) + 5 * chunks, 4 * T * D * 3 // 2, T * D / V


COSTS.op("fasr_maxpool")(_cost_pool)
COSTS.op("fasr_meanpool")(_cost_pool)


@COSTS.op("fasr_layernorm")
def _cost_layernorm(attrs, shapes):
    rows, D = _nrows(shapes[0]), shapes[0][-1]
    setup = 2 * _cdiv(D, V) + 4
    data = rows * _cdiv(D, V) + 5 * _cdiv(rows, MAX_TS)
    return setup + data, 4 * (2 * rows * D + 2 * D), 3 * rows * D / V


@COSTS.op("fasr_attention")
def _cost_attention(attrs, shapes):
    q, k, v = shapes
    heads = int(np.prod(q[:-2])) if len(q) > 2 else 1
    Tq, D, Tk = q[-2], q[-1], k[-2]
    cmds = heads * ((Tq + 2 * Tk) * _cdiv(D, V) + 6)
    moved = 4 * heads * (Tq * D + 2 * Tk * D + Tq * v[-1])
    return cmds, moved, heads * Tq * Tk * (2 * D + 1) / V


def _cost_transfer(attrs, shapes):
    n = int(np.prod(shapes[0])) if shapes and shapes[0] else 1
    # pure data-movement marker: no interface commands of its own; one
    # V-word per cycle across the interface
    return 0, 4 * n, max(1.0, n / V)


COSTS.op("fasr_store")(_cost_transfer)
COSTS.op("fasr_load")(_cost_transfer)


# --------------------------------------------------------------------------
# Validation declarations (conformance samples, VT2 cases, VT3, Table 2)
# --------------------------------------------------------------------------


def _sample_linear(r):
    T, I, O = int(r.integers(1, 12)), int(r.integers(1, 33)), int(r.integers(1, 25))
    return [
        r.standard_normal((T, I)).astype(np.float32),
        (r.standard_normal((O, I)) * 0.1).astype(np.float32),
        (r.standard_normal((O,)) * 0.1).astype(np.float32),
    ], {}


def _sample_lstm(r):
    T, I, H = int(r.integers(2, 7)), int(r.integers(1, 17)), int(r.integers(1, 9))
    return [
        (r.standard_normal((T, 1, I)) * 0.5).astype(np.float32),
        (r.standard_normal((4 * H, I)) * 0.2).astype(np.float32),
        (r.standard_normal((4 * H, H)) * 0.2).astype(np.float32),
        (r.standard_normal((4 * H,)) * 0.1).astype(np.float32),
    ], {}


def _sample_pool(r):
    T, D = 2 * int(r.integers(1, 9)), int(r.integers(1, 49))
    return [r.standard_normal((T, D)).astype(np.float32)], {}


def _sample_layernorm(r):
    T, D = int(r.integers(1, 9)), int(r.integers(2, 49))
    return [
        r.standard_normal((T, D)).astype(np.float32),
        r.standard_normal((D,)).astype(np.float32),
        (r.standard_normal((D,)) * 0.1).astype(np.float32),
    ], {"eps": 1e-5}


def _sample_attention(r):
    Tq, Tk, D = int(r.integers(1, 9)), int(r.integers(1, 13)), int(r.integers(2, 33))
    return [
        r.standard_normal((Tq, D)).astype(np.float32),
        r.standard_normal((Tk, D)).astype(np.float32),
        r.standard_normal((Tk, D)).astype(np.float32),
    ], {}


def _vt2(dim_t, dim_d):
    a = ir.Var("a", (dim_t, dim_d))
    w = ir.Var("w", (dim_d, dim_d))
    c = ir.Var("c", (dim_d,))
    T = ir.Var("T", (dim_t, dim_d))
    g = ir.Var("g", (dim_d,))
    be = ir.Var("be", (dim_d,))
    return [
        VT2Case(
            "linear",
            ir.bias_add(ir.dense(a, w), c),
            ir.call("fasr_linear", a, w, c),
            {"a": (dim_t, dim_d), "w": (dim_d, dim_d), "c": (dim_d,)},
        ),
        VT2Case(
            "maxpool",
            ir.call("reduce_max", ir.call("windows", T, wh=2, ww=1, sh=2, sw=1), axis=(2, 3)),
            ir.call("fasr_load", ir.call("fasr_maxpool", ir.call("fasr_store", T))),
            {"T": (dim_t, dim_d)},
        ),
        VT2Case(
            "layernorm",
            ir.call("layer_norm", a, g, be, eps=1e-5),
            ir.call("fasr_layernorm", a, g, be, eps=1e-5),
            {"a": (dim_t, dim_d), "g": (dim_d,), "be": (dim_d,)},
        ),
    ]


def _vt3_linear(n: int = 3, seed: int = 0, device: DeviceLike = None):
    """FlexASR ILA LinearLayer vs the af_gemm kernel on ``device``: both
    project onto the same AdaptivFloat lattice, so they must agree
    bit-for-bit."""
    from ..kernels import ops as kops

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(n):
        x = rng.standard_normal((16, 64)).astype(np.float32)
        w = (rng.standard_normal((32, 64)) * 0.1).astype(np.float32)
        b = (rng.standard_normal((32,)) * 0.1).astype(np.float32)
        cmds, rd = build_linear_fragment(x, w, b)
        ila_out = rd(flexasr.simulate(cmds, device=dev)).cpu().numpy()
        t = [torch.from_numpy(a).to(dev) for a in (x, w, b)]
        kern_out = kops.af_linear(*t).cpu().numpy()
        worst = max(worst, float(np.abs(ila_out - kern_out).max()))
    return worst <= 1e-6, worst


def _mapping_cases(rng):
    """Table-2 cases: each ``case(device=None)`` returns (reference,
    simulated) as host arrays for one random input. The cases draw from the
    shared ``rng`` in the reference's order, so both packages see the same
    inputs."""

    def sim(cmds, rd, device):
        return rd(flexasr.simulate(cmds, device=resolve(device))).cpu().numpy()

    def linear_case(device: DeviceLike = None):
        x = rng.standard_normal((16, 64)).astype(np.float32)
        w = (rng.standard_normal((64, 64)) * 0.1).astype(np.float32)
        b = (rng.standard_normal((64,)) * 0.1).astype(np.float32)
        cmds, rd = build_linear_fragment(x, w, b)
        return x @ w.T + b, sim(cmds, rd, device)

    def lstm_case(device: DeviceLike = None):
        x = (rng.standard_normal((16, 32)) * 0.5).astype(np.float32)
        wi = (rng.standard_normal((64, 32)) * 0.3).astype(np.float32)
        wh = (rng.standard_normal((64, 16)) * 0.3).astype(np.float32)
        b = (rng.standard_normal((64,)) * 0.1).astype(np.float32)
        cmds, rd = build_lstm_fragment(x, wi, wh, b)
        dev = resolve(device)
        t = [torch.from_numpy(v).to(dev) for v in (x[:, None], wi, wh, b)]
        ref = ir._lstm(*t)[:, 0].cpu().numpy()
        return ref, sim(cmds, rd, dev)

    def ln_case(device: DeviceLike = None):
        x = rng.standard_normal((16, 64)).astype(np.float32)
        g = rng.standard_normal((64,)).astype(np.float32)
        be = (rng.standard_normal((64,)) * 0.1).astype(np.float32)
        cmds, rd = build_layernorm_fragment(x, g, be)
        mu = x.mean(-1, keepdims=True)
        va = x.var(-1, keepdims=True)
        return (x - mu) / np.sqrt(va + 1e-5) * g + be, sim(cmds, rd, device)

    def maxpool_case(device: DeviceLike = None):
        # device-representable inputs (written into the AF8 buffer), as the
        # paper's 0.00% row implies
        with numerics.tier("eager"):   # the reference quantizes op by op here
            x = numerics.af_quantize(
                torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32)), AF
            ).numpy()
        cmds, rd = build_pool_fragment(x, "max")
        return x.reshape(8, 2, 64).max(1), sim(cmds, rd, device)

    def meanpool_case(device: DeviceLike = None):
        x = rng.standard_normal((16, 64)).astype(np.float32)
        cmds, rd = build_pool_fragment(x, "mean")
        return x.reshape(8, 2, 64).mean(1), sim(cmds, rd, device)

    def attn_case(device: DeviceLike = None):
        q = rng.standard_normal((8, 64)).astype(np.float32)
        k = rng.standard_normal((16, 64)).astype(np.float32)
        v = rng.standard_normal((16, 64)).astype(np.float32)
        cmds, rd = build_attention_fragment(q, k, v)
        dev = resolve(device)
        ref = ir._attention(*(torch.from_numpy(a).to(dev) for a in (q, k, v)))
        return ref.cpu().numpy(), sim(cmds, rd, dev)

    return [
        ("LinearLayer", linear_case),
        ("LSTM", lstm_case),
        ("LayerNorm", ln_case),
        ("MaxPool", maxpool_case),
        ("MeanPool", meanpool_case),
        ("Attention", attn_case),
    ]


# --------------------------------------------------------------------------
# Fused fast-path runners (engine="fused")
#
# For the two hot shapes (LinearLayer, LSTM) the compiled tier's round trip
# through architectural state computes a pure function of (activations,
# exponent windows) with weights frozen at fragment-build time — so a
# FusedRunner stacks the whole batch into dense arrays host-side and runs
# one batched computation. The compiled tier stays the oracle. A linear
# without an activation is exactly af_gemm, so its runner is one af_gemm
# call per group on every device (the wrapper launches the CUDA kernel on
# card tensors and runs its plain version on CPU tensors). Linears with an
# activation, and the LSTM, run plain PyTorch that replicates _fn_linear /
# _fn_lstm arithmetic step for step (bit-exact for linear; the LSTM hoists
# the input projection out of the recurrence, which reassociates fp32 sums,
# so it is tolerance-parity).
# --------------------------------------------------------------------------


def _fused_stack(datas: List[DataStream]):
    """Prepare half (pure numpy, pack-worker safe): stack linear/LSTM data
    streams into dense batch arrays — the (B, MAX_TS, MAX_IN) activation
    block exactly as the bulk writes land it in gb_large, plus per-sample
    ``num_ts`` and the CFG_NUMERICS act/out exponent windows from the tail."""
    datas = fused_pad_streams(datas)
    B = len(datas)
    xs = np.zeros((B, MAX_TS, MAX_IN), np.float32)
    num_ts = np.zeros((B,), np.float32)
    ba = np.zeros((B,), np.float32)
    bo = np.zeros((B,), np.float32)
    for i, d in enumerate(datas):
        (blk,) = d.bulk
        assert blk.buf == "gb_large" and blk.base == BASE_IN
        assert int(d.tail.ops[1]) == CFG_NUMERICS
        rows = np.asarray(blk.rows, np.float32)
        xs[i].reshape(MAX_TS * (MAX_IN // V), V)[: rows.shape[0]] = rows
        num_ts[i] = d.tail.data[0, 1]
        ba[i] = d.tail.data[1, 1]
        bo[i] = d.tail.data[1, 2]
    return xs, num_ts, ba, bo


def _fused_dispatch(batch, device: torch.device):
    """Dispatch half: copy the stacked payloads to the device and run the
    batched computation (returns without waiting for the device)."""

    def dispatch(prepared):
        xs, num_ts, ba, bo = (payload(a, device) for a in prepared)
        return batch(xs, num_ts, ba, bo)

    return dispatch


def _fused_linear(frag: CompiledFragment, device: torch.device) -> FusedRunner:
    meta, act = frag.meta, int(frag.key[3])
    I, O, bw = meta["I"], meta["O"], meta["bw"]
    # pe_w / pe_b exactly as the setup stream leaves them (zero padding)
    wp = np.zeros((MAX_OUT, MAX_IN), np.float32)
    wp[:O, :I] = meta["w"]
    bp = np.zeros((MAX_OUT,), np.float32)
    bp[:O] = meta["b"]
    m_in = payload((np.arange(MAX_IN) < I).astype(np.float32), device)
    m_out = payload((np.arange(MAX_OUT) < O).astype(np.float32), device)
    wp_t, bp_t = payload(wp, device), payload(bp, device)

    if act == ACT_NONE:
        from ..kernels.af_gemm import af_gemm

        lowering = "kernel"

        def batch(x, n_ts, ba, bo):
            # activation rows/cols beyond (T, I) are zero, and AFq(0) == 0,
            # so the input masks are implicit; Y's bias rows past T are
            # cleared by the post-mask, exactly as _fn_linear's m_ts does
            y = af_gemm(x, wp_t, bp_t, ba, bw, bo, spec=AF)
            m_ts = _mask1(n_ts, MAX_TS, device)
            return (y * m_ts[:, :, None] * m_out[None, None, :])[:, :, :MAX_IN]
    else:
        lowering = "plain"
        with numerics.tier("eager"):   # the reference quantizes it outside jit
            Wq = _afq(wp_t, bw) * m_out[:, None] * m_in[None, :]
        bvec = bp_t * m_out
        act_fn = _ACTS[act]

        def batch(x, n_ts, ba, bo):
            m_ts = _mask1(n_ts, MAX_TS, device)
            Xq = _afq(x, bcast(ba, 2)) * m_ts[:, :, None] * m_in[None, None, :]
            Y = act_fn(Xq @ Wq.mT + bvec[None, None, :])
            Y = _afq(Y, bcast(bo, 2)) * m_ts[:, :, None] * m_out[None, None, :]
            return Y[:, :, :MAX_IN]

    return FusedRunner(f"flexasr-linear-{lowering}", _fused_stack,
                       _fused_dispatch(batch, device), read=read_full, lowering=lowering)


def _fused_lstm(frag: CompiledFragment, device: torch.device) -> FusedRunner:
    meta = frag.meta
    I, H, bw = meta["I"], meta["H"], meta["bw"]
    wip = np.zeros((MAX_OUT, MAX_IN), np.float32)
    wip[:, :I] = meta["wi_p"]
    whp = np.zeros((MAX_OUT, MAX_H), np.float32)
    whp[:, :H] = meta["wh_p"]
    bvec = payload(meta["b_p"], device)
    m_in = payload((np.arange(MAX_IN) < I).astype(np.float32), device)
    m_h = payload((np.arange(MAX_H) < H).astype(np.float32), device)
    with numerics.tier("eager"):   # the reference quantizes them outside jit
        Wi = _afq(payload(wip, device), bw) * m_in[None, :]
        Wh = _afq(payload(whp, device), bw) * m_h[None, :]

    def batch(x, n_ts, ba, bo):
        B = x.shape[0]
        Xq = _afq(x, bcast(ba, 2)) * m_in
        Gx = Xq @ Wi.mT  # (B, MAX_TS, 4H) input projection hoisted off the recurrence
        h = torch.zeros((B, MAX_H), device=device)
        c = torch.zeros((B, MAX_H), device=device)
        bo1 = bcast(bo, 1)
        hs = []
        for t in range(MAX_TS):
            gates = Gx[:, t] + h @ Wh.mT + bvec
            i = torch.sigmoid(gates[:, 0 * MAX_H : 1 * MAX_H])
            f = torch.sigmoid(gates[:, 1 * MAX_H : 2 * MAX_H])
            g = torch.tanh(gates[:, 2 * MAX_H : 3 * MAX_H])
            o = torch.sigmoid(gates[:, 3 * MAX_H : 4 * MAX_H])
            c = _afq(f * c + i * g, bo1) * m_h
            h = _afq(o * torch.tanh(c), bo1) * m_h
            hs.append(h)
        hs = torch.stack(hs, dim=1) * _mask1(n_ts, MAX_TS, device)[:, :, None]
        out = torch.zeros((B, MAX_TS, MAX_IN), device=device)
        out[:, :, :MAX_H] = hs
        return out

    return FusedRunner("flexasr-lstm-plain", _fused_stack,
                       _fused_dispatch(batch, device), read=read_full, lowering="plain")


def _fused_factory(frag: CompiledFragment, device: torch.device):
    """``declare_fused`` hook: runners for the hot data-stream shapes."""
    if frag.key[0] == "fasr_linear":
        return _fused_linear(frag, device)
    if frag.key[0] == "fasr_lstm":
        return _fused_lstm(frag, device)
    return None


# --------------------------------------------------------------------------
# Registration: everything the core needs, through the public API
# --------------------------------------------------------------------------

TARGET.add_intrinsic(Intrinsic(
    "fasr_linear", planner=plan_linear, kernel=kernel_linear,
    sample=_sample_linear, tol=0.08,
    doc="bias_add(dense(x,w),b) -> FlexASR LinearLayer"))
TARGET.add_intrinsic(Intrinsic(
    "fasr_lstm", planner=plan_lstm, sample=_sample_lstm, tol=0.20,
    doc="unrolled LSTM -> one FlexASR LSTM instruction"))
TARGET.add_intrinsic(Intrinsic(
    "fasr_maxpool", planner=lambda ctx, x, a: plan_pool(ctx, x, a, "max"),
    sample=_sample_pool, tol=0.05, doc="temporal max pooling"))
TARGET.add_intrinsic(Intrinsic(
    "fasr_meanpool", planner=lambda ctx, x, a: plan_pool(ctx, x, a, "mean"),
    sample=_sample_pool, tol=0.05, doc="temporal mean pooling"))
TARGET.add_intrinsic(Intrinsic(
    "fasr_layernorm", planner=plan_layernorm, sample=_sample_layernorm,
    tol=0.10, doc="layer normalization"))
TARGET.add_intrinsic(Intrinsic(
    "fasr_attention", planner=plan_attention, sample=_sample_attention,
    tol=0.15, doc="scaled dot-product attention"))
TARGET.add_intrinsic(Intrinsic(
    "fasr_store", passthrough=True, doc="HBM -> accelerator transfer marker"))
TARGET.add_intrinsic(Intrinsic(
    "fasr_load", passthrough=True, doc="accelerator -> HBM transfer marker"))
TARGET.declare_fused(_fused_factory)
TARGET.add_rewrites(_rewrites)
TARGET.add_cost_model(COSTS)
TARGET.add_vt2_cases(_vt2)
TARGET.add_vt3_check("linear_ila_vs_af_gemm_kernel", _vt3_linear)
TARGET.add_mapping_cases(_mapping_cases)
register_target(TARGET)
