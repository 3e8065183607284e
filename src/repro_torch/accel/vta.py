"""VTA accelerator ILA (Moreau et al., IEEE Micro'19) — PyTorch model.

Unlike FlexASR/HLSCNN, VTA is a *fine-grained programmable* accelerator with
an actual ISA: a processor-like design around a 16x16 int8 GEMM core with an
int32 accumulator register file, plus a vector ALU. "Operators" are sequences
of VTA instructions (Appendix A). We model the compute-relevant subset:

  LOAD_INP  dram -> inp SRAM   (int8 tile, 16x16)
  LOAD_WGT  dram -> wgt SRAM   (int8 tile, 16x16)
  LOAD_ACC  dram -> acc RF     (int32 tile — bias preload)
  GEMM      acc[d] += inp[i] @ wgt[w]^T   (int8 x int8 -> int32)
  ALU       acc[d] = op(acc[d], acc[s] | imm)   op in {add, max, shr, min}
  STORE     acc RF -> out dram (int8 narrowing with shift-based requant)

The ILA's "DRAM" is a host-visible array in the architectural state (the
paper models DMA through the accelerator interface the same way). GEMM
matches the real device: int8 operands, int32 accumulate, requantization via
arithmetic shift in the ALU — which makes the GEMM mapping *exact* for
integer inputs (Table 2 row 1: 0.00% error).

State is float32, as in the reference: integer values stay exact while
|acc| < 2^24, and every matrix product runs in full float32 (TF32 is off on
the card, see ``repro_torch.device``).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core import ir
from ..core.egraph import P, V as PV, Rewrite
from ..core.ila import (
    ILA, BulkWrite, Command, CompiledFragment, DataStream, PackedStream,
    branch, fingerprint, payload, read_block, write_block,
)
from ..device import DeviceLike, resolve
from . import numerics
from .target import (
    AcceleratorTarget, CostModel, Intrinsic, SimJob, VT2Case, register_target,
)

T = 16               # tile side (the 16x16 GEMM core)
N_INP = 64           # inp SRAM tiles
N_WGT = 64
N_ACC = 64
DRAM_TILES = 256     # host-visible scratch

LOAD_INP = 0x10
LOAD_WGT = 0x11
LOAD_ACC = 0x12
GEMM = 0x20
ALU = 0x21
STORE = 0x30
WR_DRAM = 0x40       # host writes a 16-value row into DRAM scratch

ALU_ADD = 0
ALU_MAX = 1
ALU_SHR = 2
ALU_MIN = 3

vta = ILA("vta", vwidth=T)

TARGET = AcceleratorTarget(
    "vta",
    vta,
    display_name="VTA",
    capabilities={
        "tile": T, "n_inp": N_INP, "n_wgt": N_WGT, "n_acc": N_ACC,
        "numerics": "int8xint8->int32",
    },
    doc="fine-grained programmable accelerator: 16x16 int8 GEMM core + vector ALU",
    # dense and vta_gemm interpret through the same fp32 matmul: bit-exact
    vt2_tol=0.0,
)
FRAGMENTS = TARGET.fragments
# dram rows carry pre-quantized int8-grid operands: |x| <= 127, inside the
# +/-128 fixed-range saturation point — wrap statically unreachable
TARGET.declare_lint(input_range=(-127.0, 127.0))

vta.state("dram", lambda d: torch.zeros((DRAM_TILES * T, T), device=d))
vta.state("inp_sram", lambda d: torch.zeros((N_INP, T, T), device=d))
vta.state("wgt_sram", lambda d: torch.zeros((N_WGT, T, T), device=d))
vta.state("acc_rf", lambda d: torch.zeros((N_ACC, T, T), device=d))


def _dev(st) -> torch.device:
    return st["dram"].device


def _field(data, i: int):
    """Payload lane ``i`` as an index (``astype(int32)``: truncation): an
    int for a host row, a ``(B,)`` LongTensor for a batched one."""
    if isinstance(data, torch.Tensor):
        return data[:, i].to(torch.int64)
    return int(data[i])


def _flag(data, i: int):
    """Payload lane ``i`` as a value: a float, or a ``(B, 1, 1)`` tensor."""
    if isinstance(data, torch.Tensor):
        return data[:, i].reshape(-1, 1, 1)
    return float(data[i])


def _rd_tile(buf: torch.Tensor, idx) -> torch.Tensor:
    """Tile ``idx`` of a (n, T, T) buffer: (T, T), or (B, T, T) per stream."""
    return read_block(buf, (idx, 0, 0), (1, T, T)).squeeze(-3)


def _wr_tile(buf: torch.Tensor, idx, tile: torch.Tensor) -> torch.Tensor:
    return write_block(buf, tile.unsqueeze(-3), (idx, 0, 0))


@vta.instruction("wr_dram", WR_DRAM)
def _wr_dram(st, addr, data):
    st["dram"] = write_block(st["dram"], payload(data, _dev(st)).unsqueeze(-2), (addr, 0))
    return st


def _load(buf):
    def update(st, addr, data):
        # data = (sram_idx, dram_tile)
        sram_idx = _field(data, 0)
        tile = read_block(st["dram"], (_field(data, 1) * T, 0), (T, T))
        if buf != "acc_rf":
            tile = torch.clamp(torch.round(tile), -128, 127)  # int8 semantics
        st[buf] = _wr_tile(st[buf], sram_idx, tile)
        return st

    return update


vta.instruction("load_inp", LOAD_INP)(_load("inp_sram"))
vta.instruction("load_wgt", LOAD_WGT)(_load("wgt_sram"))
vta.instruction("load_acc", LOAD_ACC)(_load("acc_rf"))


@vta.instruction("gemm", GEMM, "acc[d] += inp[i] @ wgt[w]^T (int8 -> int32)")
def _gemm(st, addr, data):
    d, i, w = _field(data, 0), _field(data, 1), _field(data, 2)
    inp = _rd_tile(st["inp_sram"], i)
    wgt = _rd_tile(st["wgt_sram"], w)
    acc = _rd_tile(st["acc_rf"], d)
    # int8 x int8 -> int32 exact in fp32 (|acc| < 2^24 for our tile counts)
    acc = acc + inp @ wgt.mT
    st["acc_rf"] = _wr_tile(st["acc_rf"], d, acc)
    return st


_ALU_OPS = [
    lambda ab: ab[0] + ab[1],
    lambda ab: torch.maximum(ab[0], ab[1]),
    # arithmetic >>: the reference's floor(a / jnp.exp2(b)) (b an integer), in
    # a lax.switch, so compiled in every tier (numerics.tier's default)
    lambda ab: torch.floor(numerics.div_exp2(ab[0], ab[1])),
    lambda ab: torch.minimum(ab[0], ab[1]),
]


@vta.instruction("alu", ALU, "acc[d] = op(acc[d], acc[s] or imm)")
def _alu(st, addr, data):
    op = _field(data, 0)
    d, s = _field(data, 1), _field(data, 2)
    use_imm, imm = _flag(data, 3), _flag(data, 4)
    a = _rd_tile(st["acc_rf"], d)
    if isinstance(use_imm, torch.Tensor):
        b = torch.where(use_imm > 0, imm, _rd_tile(st["acc_rf"], s))
    elif use_imm > 0:
        b = torch.full_like(a, imm)
    else:
        b = _rd_tile(st["acc_rf"], s)
    out = branch(op, _ALU_OPS, (a, b))
    st["acc_rf"] = _wr_tile(st["acc_rf"], d, out)
    return st


@vta.instruction("store", STORE, "acc[s] -> dram tile (optional int8 narrowing)")
def _store(st, addr, data):
    s, dram_tile = _field(data, 0), _field(data, 1)
    narrow = _flag(data, 2)
    acc = _rd_tile(st["acc_rf"], s)
    if isinstance(narrow, torch.Tensor):
        out = torch.where(narrow > 0, torch.clamp(acc, -128, 127), acc)
    else:
        out = torch.clamp(acc, -128, 127) if narrow > 0 else acc
    st["dram"] = write_block(st["dram"], out, (dram_tile * T, 0))
    return st


# ---------------------------------------------------------------------------
# Driver-side fragment builders — "operators are sequences of instructions".
#
# Split for the fragment-compiler fast path: the *setup* stream stages the
# stationary operand (weight tiles -> wgt SRAM) and zeroes the accumulators;
# the *data* stream DMAs the moving operand, issues the GEMM/ALU micro-ops,
# and stores results. DRAM scratch layout is fixed per fragment so data
# streams for every invocation hit the same addresses:
#
#   [0, nt*kt)                 weight tiles          (setup)
#   nt*kt                      always-zero tile      (setup; acc preload)
#   (nt*kt+1, +mt*kt)          input tiles           (data, bulk write)
#   (nt*kt+1+mt*kt, +mt*nt)    output tiles          (data, STORE)
# ---------------------------------------------------------------------------


def _tiles(m: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Pad (R, C) to tile multiples; return (tiles[rt, ct, T, T], rt, ct)."""
    r, c = m.shape
    rt, ct = (r + T - 1) // T, (c + T - 1) // T
    p = np.zeros((rt * T, ct * T), np.float32)
    p[:r, :c] = m
    return p.reshape(rt, T, ct, T).transpose(0, 2, 1, 3), rt, ct


def _write_dram_tile(cmds, tile_idx: int, tile: np.ndarray):
    for r in range(T):
        cmds.append(Command(WR_DRAM, tile_idx * T + r, tuple(tile[r])))


def _tile_rows(tiles: np.ndarray) -> np.ndarray:
    """(n, T, T) tile stack -> (n*T, T) contiguous DRAM rows."""
    return np.ascontiguousarray(tiles).reshape(-1, T)


def _cmd_stream(entries) -> PackedStream:
    """[(opcode, values), ...] -> PackedStream (addr unused by these ops)."""
    n = len(entries)
    ops = np.array([e[0] for e in entries], np.int32)
    addrs = np.zeros((n,), np.int32)
    data = np.zeros((n, T), np.float32)
    for i, (_, vals) in enumerate(entries):
        vals = np.asarray(vals, np.float32)
        data[i, : len(vals)] = vals
    return PackedStream(ops, addrs, data)


def gemm_fragment(b_int8: np.ndarray, mt: int, cache: bool = True) -> CompiledFragment:
    """Setup half of the GEMM mapping: weight tiles resident in wgt SRAM and
    ``mt * nt`` accumulators zeroed, for data chunks of up to ``mt`` row
    tiles. Cached per (weight chunk, layout)."""
    b_t, nt, kt = _tiles(np.asarray(b_int8, np.float32))
    assert mt * kt <= N_INP and nt * kt <= N_WGT and mt * nt <= N_ACC
    inp_base = nt * kt + 1
    out_base = inp_base + mt * kt
    assert (out_base + mt * nt) <= DRAM_TILES
    key = ("vta_gemm", mt, nt, kt, fingerprint(b_int8))

    def build():
        cmds: List[Command] = []
        for n in range(nt):
            for k in range(kt):
                _write_dram_tile(cmds, n * kt + k, b_t[n, k])
                cmds.append(Command(LOAD_WGT, 0, (n * kt + k, n * kt + k)))
        # zero accumulators: preload every acc tile from an always-zero tile
        zero_tile = nt * kt
        _write_dram_tile(cmds, zero_tile, np.zeros((T, T), np.float32))
        for m in range(mt):
            for n in range(nt):
                cmds.append(Command(LOAD_ACC, 0, (m * nt + n, zero_tile)))
        setup = PackedStream.from_commands(cmds, T)
        meta = {
            "mt": mt, "nt": nt, "kt": kt, "inp_base": inp_base,
            "out_base": out_base, "N": int(np.asarray(b_int8).shape[0]),
        }
        return CompiledFragment(vta, key, setup, meta=meta)

    return FRAGMENTS.get(key, build) if cache else build()


def pack_gemm_data(frag: CompiledFragment, a_int8: np.ndarray, requant_shift: int = 0) -> DataStream:
    """Data half: input tiles + GEMM/requant/STORE micro-ops for one chunk
    of up to ``mt`` row tiles."""
    m = frag.meta
    a_t, mt_c, kt = _tiles(np.asarray(a_int8, np.float32))
    assert kt == m["kt"] and mt_c <= m["mt"]
    nt, inp_base, out_base = m["nt"], m["inp_base"], m["out_base"]
    bulk = BulkWrite(
        "dram", inp_base * T, _tile_rows(a_t.reshape(mt_c * kt, T, T)), WR_DRAM
    )
    entries = []
    for i in range(mt_c):
        for k in range(kt):
            entries.append((LOAD_INP, (i * kt + k, inp_base + i * kt + k)))
    for mi in range(mt_c):
        for n in range(nt):
            for k in range(kt):
                entries.append((GEMM, (mi * nt + n, mi * kt + k, n * kt + k)))
    if requant_shift > 0:
        for mi in range(mt_c):
            for n in range(nt):
                entries.append((ALU, (ALU_SHR, mi * nt + n, 0, 1.0, float(requant_shift))))
    narrow = 1.0 if requant_shift > 0 else 0.0
    for mi in range(mt_c):
        for n in range(nt):
            entries.append((STORE, (mi * nt + n, out_base + mi * nt + n, narrow)))
    return DataStream([bulk], _cmd_stream(entries))


def _read_region(st, out_base: int, rt: int, ct: int) -> torch.Tensor:
    """The (rt*T, ct*T) matrix stored tile by tile at DRAM tile ``out_base``
    (per stream for a batched state)."""
    dram = st["dram"]
    lead = tuple(dram.shape[:-2])
    region = dram[..., out_base * T : (out_base + rt * ct) * T, :]
    tiles = region.reshape(lead + (rt, ct, T, T)).transpose(-3, -2)
    return tiles.reshape(lead + (rt * T, ct * T))


def read_gemm_full(frag: CompiledFragment):
    """Batch-polymorphic fixed-shape read of the whole output region:
    (mt*T, nt*T); callers slice the valid [:M, :N] window."""
    m = frag.meta
    mt, nt, out_base = m["mt"], m["nt"], m["out_base"]

    def read(st):
        return _read_region(st, out_base, mt, nt)

    return read


def build_gemm_fragment(a_int8: np.ndarray, b_int8: np.ndarray, requant_shift: int = 0):
    """dense(a, b) (int8) -> VTA instruction sequence.

    a:(M,K) b:(N,K); returns int32 accum (or int8 after shift/narrow if
    requant_shift > 0). Tiled over the 16x16 GEMM core.
    """
    a = np.asarray(a_int8)
    mt = (a.shape[0] + T - 1) // T
    frag = gemm_fragment(b_int8, mt)
    cmds = frag.full_commands(pack_gemm_data(frag, a_int8, requant_shift))
    M, N = a.shape[0], np.asarray(b_int8).shape[0]
    read = read_gemm_full(frag)

    def read_out(st):
        return read(st)[..., :M, :N]

    return cmds, read_out


def alu_fragment(rt: int, ct: int, kind: str, cache: bool = True) -> CompiledFragment:
    """Vector-ALU ops have no stationary operand: the setup stream is empty
    and the whole invocation is a data stream. Cached per tile layout only
    (the fragment then exists to batch same-layout invocations).

    DRAM layout (``n = rt * ct`` tiles): a tiles [0, n), b tiles [n, 2n)
    (add only), outputs after the operand region.
    """
    n = rt * ct
    assert kind in ("add", "relu")
    n_ops = 2 * n if kind == "add" else n
    assert n_ops <= N_ACC and (n_ops + n) <= DRAM_TILES
    key = ("vta_alu", kind, rt, ct)

    def build():
        meta = {"rt": rt, "ct": ct, "kind": kind, "out_base": n_ops}
        return CompiledFragment(vta, key, PackedStream.empty(T), meta=meta)

    return FRAGMENTS.get(key, build) if cache else build()


def pack_alu_data(frag: CompiledFragment, a_int: np.ndarray, b_int=None) -> DataStream:
    m = frag.meta
    rt, ct, kind, out_base = m["rt"], m["ct"], m["kind"], m["out_base"]
    n = rt * ct
    a_t, rt2, ct2 = _tiles(np.asarray(a_int, np.float32))
    assert (rt2, ct2) == (rt, ct)
    bulk = [BulkWrite("dram", 0, _tile_rows(a_t.reshape(n, T, T)), WR_DRAM)]
    entries = [(LOAD_ACC, (i, i)) for i in range(n)]
    if kind == "add":
        b_t, _, _ = _tiles(np.asarray(b_int, np.float32))
        bulk.append(BulkWrite("dram", n * T, _tile_rows(b_t.reshape(n, T, T)), WR_DRAM))
        entries += [(LOAD_ACC, (n + i, n + i)) for i in range(n)]
        entries += [(ALU, (ALU_ADD, i, n + i, 0.0, 0.0)) for i in range(n)]
    else:
        entries += [(ALU, (ALU_MAX, i, 0, 1.0, 0.0)) for i in range(n)]
    entries += [(STORE, (i, out_base + i)) for i in range(n)]
    return DataStream(bulk, _cmd_stream(entries))


def read_alu_full(frag: CompiledFragment):
    """Batch-polymorphic read of the whole (rt*T, ct*T) output; slice [:R, :C]."""
    m = frag.meta
    rt, ct, out_base = m["rt"], m["ct"], m["out_base"]

    def read(st):
        return _read_region(st, out_base, rt, ct)

    return read


def _build_alu_fragment(kind, a_int, b_int=None):
    a = np.asarray(a_int)
    rt, ct = (a.shape[0] + T - 1) // T, (a.shape[1] + T - 1) // T
    frag = alu_fragment(rt, ct, kind)
    cmds = frag.full_commands(pack_alu_data(frag, a_int, b_int))
    R, C = a.shape
    read = read_alu_full(frag)

    def read_out(st):
        return read(st)[..., :R, :C]

    return cmds, read_out


def build_add_fragment(a_int: np.ndarray, b_int: np.ndarray):
    """elementwise add on the vector ALU (acc RF resident)."""
    return _build_alu_fragment("add", a_int, b_int)


def build_relu_fragment(a_int: np.ndarray):
    return _build_alu_fragment("relu", a_int)


# --------------------------------------------------------------------------
# Target declaration: rewrites, planners, validation cases, registration
# --------------------------------------------------------------------------


def _rewrites():
    return [
        Rewrite("vta-gemm", P("dense", PV("a"), PV("b")), P("vta_gemm", PV("a"), PV("b"))),
        Rewrite("vta-add", P("add", PV("a"), PV("b")), P("vta_add", PV("a"), PV("b"))),
        Rewrite("vta-relu", P("relu", PV("x")), P("vta_relu", PV("x"))),
    ]


def _int8_operands(a, b):
    """The driver's symmetric int8 scaling onto ±127 (host numpy, float64
    scales, exactly as the reference computes them)."""
    sa = np.abs(a).max() / 127.0 if np.abs(a).max() > 0 else 1.0
    sb = np.abs(b).max() / 127.0 if np.abs(b).max() > 0 else 1.0
    a8 = np.clip(np.round(a / sa), -127, 127)
    b8 = np.clip(np.round(b / sb), -127, 127)
    return a8, b8, sa, sb


def kernel_gemm(ctx, x, args):
    """Deployment fast path: the int8_gemm CUDA kernel on the Executor's
    device; its plain version on the CPU."""
    from ..kernels import ops as kops

    a, b = args
    ideal = a @ b.T
    a8, b8, sa, sb = _int8_operands(a, b)
    t8 = [torch.from_numpy(np.ascontiguousarray(v, np.int8)).to(ctx.device) for v in (a8, b8)]
    out32 = kops.int8_gemm(*t8).cpu().numpy().astype(np.float64)
    out = out32 * sa * sb
    ctx.record("vta_gemm", "vta-kernel", out, ideal, 0)
    return out.astype(np.float32)


def plan_gemm(ctx, x, args):
    a, b = args
    ideal = a @ b.T
    a8, b8, sa, sb = _int8_operands(a, b)
    # tile rows so SRAM limits hold: mt*kt <= N_INP etc.
    kt = (a8.shape[1] + T - 1) // T
    max_m = max(1, (N_INP // kt)) * T
    max_n = max(1, (N_WGT // kt)) * T
    mt_layout = (min(max_m, a8.shape[0]) + T - 1) // T
    jobs, layout = [], []
    for mi in range(0, a8.shape[0], max_m):
        a_chunk = a8[mi : mi + max_m]
        row = []
        for nj in range(0, b8.shape[0], max_n):
            b_chunk = b8[nj : nj + max_n]
            frag = gemm_fragment(b_chunk, mt_layout)
            jobs.append(
                SimJob(frag, pack_gemm_data(frag, a_chunk), read_gemm_full(frag),
                       (slice(0, a_chunk.shape[0]), slice(0, b_chunk.shape[0])))
            )
            row.append(len(jobs) - 1)
        layout.append(row)

    def assemble(outs):
        out32 = np.concatenate(
            [np.concatenate([outs[i] for i in row], axis=1) for row in layout],
            axis=0,
        ).astype(np.float64)
        out = out32 * sa * sb
        ctx.record("vta_gemm", "vta", out, ideal, ctx.ncmds(jobs))
        return out.astype(np.float32)

    return jobs, assemble


def plan_add(ctx, x, args):
    a, b = args
    # elementwise adds stay in the accumulator's wide fixed point; the
    # driver scales both operands onto a shared int grid
    s = max(np.abs(a).max(), np.abs(b).max(), 1e-9) / (2 ** 20)
    ai = np.round(np.broadcast_to(a, np.broadcast_shapes(a.shape, b.shape)) / s)
    bi = np.round(np.broadcast_to(b, ai.shape) / s)
    a2 = ai.reshape(-1, ai.shape[-1]) if ai.ndim > 1 else ai.reshape(1, -1)
    b2 = bi.reshape(a2.shape)
    ct = (a2.shape[1] + T - 1) // T
    max_r = max(1, (N_ACC // 2) // ct) * T
    jobs = []
    for ri in range(0, a2.shape[0], max_r):
        ac, bc = a2[ri : ri + max_r], b2[ri : ri + max_r]
        rt = (ac.shape[0] + T - 1) // T
        frag = alu_fragment(rt, ct, "add")
        jobs.append(
            SimJob(frag, pack_alu_data(frag, ac, bc), read_alu_full(frag),
                   (slice(0, ac.shape[0]), slice(0, ac.shape[1])))
        )

    def assemble(outs):
        out = (np.concatenate(outs, axis=0) * s).reshape(ai.shape).astype(np.float32)
        ctx.record("vta_add", "vta", out, np.asarray(a) + np.asarray(b),
                   ctx.ncmds(jobs))
        return out

    return jobs, assemble


def plan_relu(ctx, x, args):
    (a,) = args
    s = max(np.abs(a).max(), 1e-9) / (2 ** 20)
    ai = np.round(a / s)
    a2 = ai.reshape(-1, ai.shape[-1]) if ai.ndim > 1 else ai.reshape(1, -1)
    ct = (a2.shape[1] + T - 1) // T
    max_r = max(1, (N_ACC // 2) // ct) * T
    jobs = []
    for ri in range(0, a2.shape[0], max_r):
        ac = a2[ri : ri + max_r]
        rt = (ac.shape[0] + T - 1) // T
        frag = alu_fragment(rt, ct, "relu")
        jobs.append(
            SimJob(frag, pack_alu_data(frag, ac), read_alu_full(frag),
                   (slice(0, ac.shape[0]), slice(0, ac.shape[1])))
        )

    def assemble(outs):
        out = (np.concatenate(outs, axis=0) * s).reshape(a.shape).astype(np.float32)
        ctx.record("vta_relu", "vta", out, np.maximum(a, 0), ctx.ncmds(jobs))
        return out

    return jobs, assemble


def _sample_gemm(r):
    M, K, N = int(r.integers(1, 21)), int(r.integers(1, 41)), int(r.integers(1, 21))
    return [
        r.integers(-120, 120, (M, K)).astype(np.float32),
        r.integers(-120, 120, (N, K)).astype(np.float32),
    ], {}


def _sample_add(r):
    R, C = int(r.integers(1, 21)), int(r.integers(1, 25))
    return [
        r.standard_normal((R, C)).astype(np.float32),
        r.standard_normal((R, C)).astype(np.float32),
    ], {}


def _sample_relu(r):
    R, C = int(r.integers(1, 21)), int(r.integers(1, 25))
    return [r.standard_normal((R, C)).astype(np.float32)], {}


def _vt2(dim_t, dim_d):
    a = ir.Var("a", (dim_t, dim_d))
    w = ir.Var("w", (dim_d, dim_d))
    return [
        VT2Case(
            "vta-gemm",
            ir.dense(a, w),
            ir.call("vta_gemm", a, w),
            {"a": (dim_t, dim_d), "w": (dim_d, dim_d)},
        ),
    ]


def _vt3_gemm(n: int = 3, seed: int = 0, device: DeviceLike = None):
    """VTA ILA GEMM vs the int8_gemm kernel on ``device``: exact equality."""
    from ..kernels import ops as kops

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(n):
        a = rng.integers(-100, 100, (24, 48)).astype(np.float32)
        b = rng.integers(-100, 100, (20, 48)).astype(np.float32)
        cmds, rd = build_gemm_fragment(a, b)
        ila_out = rd(vta.simulate(cmds, device=dev)).cpu().numpy()
        t8 = [torch.from_numpy(v.astype(np.int8)).to(dev) for v in (a, b)]
        kern_out = kops.int8_gemm(*t8).cpu().numpy().astype(np.float32)
        worst = max(worst, float(np.abs(ila_out - kern_out).max()))
    return worst == 0.0, worst


def _mapping_cases(rng):
    """Table-2 cases: each ``case(device=None)`` returns (reference,
    simulated) as host arrays for one random input."""

    def gemm_case(device: DeviceLike = None):
        a = rng.integers(-100, 100, (16, 64)).astype(np.float32)
        b = rng.integers(-100, 100, (16, 64)).astype(np.float32)
        cmds, rd = build_gemm_fragment(a, b)
        out = rd(vta.simulate(cmds, device=resolve(device)))
        return a @ b.T, out.cpu().numpy()

    return [("GEMM", gemm_case)]


COSTS = CostModel("vta", cycles_per_command=1.0)


def _numel(shapes):
    return int(np.prod(np.broadcast_shapes(*shapes))) if shapes else 1


@COSTS.op("vta_gemm")
def _cost_gemm(attrs, shapes):
    (m, k), (n, _) = shapes[0], shapes[1]
    setup = -(-n * k // T) + 4          # weight tiles resident in wgt SRAM
    data = m * -(-k // T) + 4           # activation tile stream + launch
    moved = 4 * (m * k + n * k + m * n)
    return setup + data, moved, m * n * k / (T * T)


def _cost_alu(attrs, shapes):
    n = _numel(shapes)
    ops = len(shapes)                   # one tile stream per operand
    return ops * -(-n // T) + 4, 4 * (ops + 1) * n, n / T


COSTS.op("vta_add")(_cost_alu)
COSTS.op("vta_relu")(_cost_alu)


TARGET.add_intrinsic(Intrinsic(
    "vta_gemm", planner=plan_gemm, kernel=kernel_gemm, sample=_sample_gemm,
    tol=0.02, doc="tiled int8 GEMM on the 16x16 core"))
TARGET.add_intrinsic(Intrinsic(
    "vta_add", planner=plan_add, sample=_sample_add, tol=1e-4,
    doc="vector ALU elementwise add"))
TARGET.add_intrinsic(Intrinsic(
    "vta_relu", planner=plan_relu, sample=_sample_relu, tol=1e-4,
    doc="vector ALU relu (max with 0)"))
TARGET.add_rewrites(_rewrites)
TARGET.add_cost_model(COSTS)
TARGET.add_vt2_cases(_vt2)
TARGET.add_vt3_check("gemm_ila_vs_int8_gemm_kernel", _vt3_gemm)
TARGET.add_mapping_cases(_mapping_cases)
register_target(TARGET)
