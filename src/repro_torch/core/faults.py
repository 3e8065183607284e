"""Semantic fault injection into ILA instruction definitions.

The paper's headline result is that *application-level* validation through
the ILA caught an accelerator flaw that implementation-level checks missed.
This module turns that one-off case study into a repeatable experiment: a
library of **fault models** — each a small, hardware-plausible corruption of
one ILA instruction's state-update semantics — applied by cloning a
registered :class:`~repro_torch.accel.target.AcceleratorTarget` into an ephemeral
**mutant** target. The campaign driver (:mod:`.campaign`) then measures
which validation tier first detects each mutant.

Design constraints, and how they are met:

* **Zero per-fault core edits.** A fault is data: a map from ILA instruction
  names to update-function wrappers. Mutants are ordinary
  ``AcceleratorTarget`` objects built by :func:`make_mutant`; they flow
  through the registry, the Executor, the scheduler and the validation
  runners exactly like the golden target. Applicability is decided by
  introspecting the target's ILA (instruction names, architectural-state
  register names), so a plugin backend following the bundled naming idioms
  picks up the library automatically.

* **Same name, mutated silicon.** A mutant keeps the golden target's
  registry name and intrinsic op set — it *is* that accelerator, with a bug
  — and is swapped in under :func:`swapped_in`, which replaces the golden
  registration in place (registry order preserved) and restores the exact
  prior objects on exit. A full campaign leaves ``TARGETS`` and the IR
  accel-op extension table bit-identical (see the leak-check test).

* **Warm golden caches are shared.** Mutant planners delegate to the golden
  planners — all host-side packing (fragment streams, exponent windows,
  ideal references) comes out of the golden target's warm caches — and only
  *rebind* each SimJob's fragment to a mutant-side ``CompiledFragment`` in
  the mutant's private cache, where the setup stream re-simulates under the
  mutated ILA. Thousands of mutant co-sim runs pay mutant-side simulation
  only, never repeat packing.

* **Faults hold on every engine.** Two injection mechanisms:

  - **ILA-update wrappers** (``wrappers``) mutate an instruction's
    state-update function — hardware faults. Trigger- and config-level
    wrappers keep the compiled fast path (the data runners unroll the tail
    through the *mutant* ILA's update table). A wrapper sees the port's
    register forms: a Python float when the host knows the register, a
    ``(B,)`` tensor when a batch's rows differ, and an address that is an
    ``int`` or a ``(B,)`` tensor; each wrapper keeps that form. A wrapper on a bulk row-write
    instruction invalidates the fragment compiler's slice-update lowering;
    such faults set ``mutates_bulk`` and the mutant planner converts each
    ``DataStream`` to its full ``PackedStream`` so the stream-scan tier
    (real instruction dispatch) executes them.
  - **Payload transforms** (``payload``) corrupt the command payloads of
    selected opcodes host-side, vectorized over whole streams — interface/
    DMA-path faults (wrong rounding in the write datapath, wraparound past
    the representable top). Every engine consumes the same transformed
    streams (eager/jit via ``full_commands``, compiled/pipelined via the
    rebound fragments), so semantics agree bit-for-bit, and the bulk
    slice-update lowering stays valid — payload mutants run at full
    fragment-compiler speed, which is what makes application-tier
    evaluation of *subtle* faults affordable.
  - **Stream transforms** (``stream``) rewrite whole command streams
    host-side — ``fn(ops, addrs, data) -> (ops, addrs, data)`` — modelling
    *protocol*-level faults that corrupt the command interface rather than
    any one instruction's datapath: a decoder that aliases two opcodes, a
    command queue that delivers config payloads one transaction late.
    They ride the same rebinding path as payload transforms (and may be
    combined with one), with one restriction enforced at transform time:
    bulk operand runs must come back with opcodes and addresses untouched,
    so the fragment compiler's slice-update lowering stays valid. Tail and
    setup streams may be rewritten freely.

Fault classes (``FAULT_CLASSES``): ``identity`` (control: must be bit-exact
and produce zero detections), ``trunc_width`` (sizing register off by one,
one variant per sizing register), ``sat_wrap`` (saturation replaced by
two's-complement-style wraparound), ``round_floor`` (round-to-nearest
replaced by truncation on operand writes), ``addr_swap`` (adjacent operand
rows land at swapped addresses), ``drop_cfg`` (a setup/config command is
silently dropped, one variant per droppable config), ``stale_state``
(persistent state leaks into an invocation instead of the driver-assumed
reset value, one variant per persistent register), and the multi-instruction
protocol faults ``decode_alias`` (the command decoder confuses an adjacent
opcode pair) and ``cmd_reorder`` (a config opcode's payloads are delivered
one transaction late).

``DIAGNOSTIC_FAULT_CLASSES`` (never enumerated by default — selected only
by explicit name) exercise the campaign runner itself rather than the
accelerator semantics: ``crash_inject`` raises during co-simulation and
``hang_inject`` stalls it, proving crash isolation and per-mutant timeouts
end-to-end.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..accel import numerics as numerics_mod
from ..accel.target import AcceleratorTarget, Intrinsic, SimJob
from . import ir
from .ila import (
    ILA, NOP_OPCODE, TARGETS, CompiledFragment, DataStream, PackedStream,
)

Wrapper = Callable[[Callable], Callable]


@dataclasses.dataclass
class FaultInstance:
    """One concrete applicable mutation of one target.

    ``wrappers`` maps ILA instruction names to update-function wrappers
    (``wrap(orig_update) -> new_update``); ``payload`` is a vectorized
    host-side payload transform ``fn(ops, data) -> data``; ``stream`` is a
    whole-stream protocol transform ``fn(ops, addrs, data) -> (ops, addrs,
    data)`` (see module docstring for when each mechanism applies — when
    both host-side transforms are present, ``stream`` runs first).
    ``instruction`` names the mutated instruction (or instruction pair) for
    reporting. ``mutates_bulk`` marks wrappers on bulk row-write
    instructions, which invalidates the fragment compiler's slice-update
    lowering (see module docstring)."""

    fault: str
    target: str
    instruction: str
    note: str
    wrappers: Dict[str, Wrapper] = dataclasses.field(default_factory=dict)
    payload: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None
    stream: Optional[Callable[[np.ndarray, np.ndarray, np.ndarray],
                              Tuple[np.ndarray, np.ndarray, np.ndarray]]] = None
    mutates_bulk: bool = False

    @property
    def key(self) -> str:
        return f"{self.target}:{self.fault}@{self.instruction}"

    def host_xform(self):
        """The combined host-side stream corruption, or None. Signature
        ``fn(ops, addrs, data) -> (ops, addrs, data)``; the protocol
        transform runs before the payload transform (a reordered command's
        payload still goes through the corrupted write datapath)."""
        if self.payload is None and self.stream is None:
            return None

        def fn(ops, addrs, data):
            if self.stream is not None:
                ops, addrs, data = self.stream(ops, addrs, data)
            if self.payload is not None:
                data = self.payload(ops, data)
            return ops, addrs, data

        return fn

    def covers(self, target: AcceleratorTarget) -> Tuple[str, ...]:
        """Intrinsic ops this mutation can corrupt. An ILA-level fault
        underlies every co-simulated (planner-backed) intrinsic of the
        target; the identity fault trivially covers pass-through markers
        too (they never touch the ILA, so only the no-op applies)."""
        if self.fault == "identity":
            return tuple(target.intrinsics)
        return tuple(
            op for op, i in target.intrinsics.items() if i.planner is not None
        )


class FaultModel:
    """A fault class: a name plus a generator of applicable instances."""

    def __init__(self, name: str, description: str,
                 variants: Callable[[AcceleratorTarget], List[FaultInstance]]):
        self.name = name
        self.description = description
        self._variants = variants

    def variants(self, target: AcceleratorTarget) -> List[FaultInstance]:
        """Applicable instances for ``target`` ([] when the target's ILA
        exposes none of the idioms this fault corrupts)."""
        return self._variants(target)


# ---------------------------------------------------------------------------
# ILA-introspection helpers: the naming idioms the bundled backends share
# ---------------------------------------------------------------------------

#: compute-trigger instruction names (the 0x30 "start" command of each ILA)
_TRIGGERS = ("fn_start", "conv_start", "ew_start")
#: primary operand row-write instructions (bulk data path)
_DATA_WRITERS = ("write_v", "wr_act", "wr_a", "wr_dram")
#: config instructions whose silent loss is a classic driver/setup fault,
#: most-preferred first (numerics/datatype config, then operand staging)
_DROPPABLE_CFGS = ("cfg_numerics", "cfg_dtype", "cfg_num", "load_acc",
                   "pe_cfg_act_mngr")
#: sizing registers a truncation-width fault decrements (state-reg names)
_WIDTH_REGS = ("num_in", "num_out", "in_c", "n_cols")
#: persistent cross-invocation state a stale-leak fault pollutes
_STALE_REGS = ("h_state", "c_state")


def _instr(ila: ILA, names: Sequence[str]) -> Optional[str]:
    have = {i.name for i in ila.instructions}
    for n in names:
        if n in have:
            return n
    return None


def _instrs(ila: ILA, names: Sequence[str]) -> List[str]:
    """All instructions from the idiom list present in this ILA, in idiom
    order — per-instruction fault variants enumerate over these."""
    have = {i.name for i in ila.instructions}
    return [n for n in names if n in have]


def _opcode(ila: ILA, name: str) -> int:
    for i in ila.instructions:
        if i.name == name:
            return i.opcode
    raise KeyError(name)


def _payload_on(opcode: int, fn: Callable[[np.ndarray], np.ndarray]):
    """Vectorized payload transform applying ``fn`` to rows of ``opcode``
    commands only (config/trigger payloads pass through untouched)."""

    def xform(ops: np.ndarray, data: np.ndarray) -> np.ndarray:
        if data.size == 0:
            return data
        mask = (np.asarray(ops) == opcode)[:, None]
        return np.where(mask, fn(np.asarray(data, np.float32)), data).astype(
            np.float32
        )

    return xform


def _state_regs(ila: ILA, names: Sequence[str]) -> List[str]:
    return [n for n in names if n in ila._state_init]


def _minus_one(r):
    """A sizing register one smaller, floored at 0 (a host float or a
    ``(B,)`` tensor, in its own form)."""
    if isinstance(r, torch.Tensor):
        return torch.clamp(r - 1.0, min=0.0)
    return max(float(r) - 1.0, 0.0)


# ---------------------------------------------------------------------------
# The mutators
# ---------------------------------------------------------------------------


def _identity_variants(t: AcceleratorTarget) -> List[FaultInstance]:
    return [FaultInstance("identity", t.name, "-",
                          "no-op control mutant: must be bit-exact")]


def _trunc_width_variants(t: AcceleratorTarget) -> List[FaultInstance]:
    trig = _instr(t.ila, _TRIGGERS)
    regs = _state_regs(t.ila, _WIDTH_REGS)
    if trig is None or not regs:
        return []

    out = []
    for reg in regs:

        def wrap(orig, reg=reg):
            def update(st, addr, data):
                narrowed = dict(st)
                narrowed[reg] = _minus_one(narrowed[reg])
                out = dict(orig(narrowed, addr, data))
                out[reg] = st[reg]  # transient: config readback is unchanged
                return out

            return update

        out.append(FaultInstance(
            "trunc_width", t.name,
            trig if len(regs) == 1 else f"{trig}/{reg}",
            f"compute reads sizing register {reg!r} one too small "
            "(last operand lane silently dropped)",
            wrappers={trig: wrap},
        ))
    return out


def _sat_wrap_variants(t: AcceleratorTarget) -> List[FaultInstance]:
    """Saturation -> wraparound in the operand write datapath: payload
    values beyond the representable top wrap two's-complement style
    instead of clamping. The threshold comes from the numerics declaration;
    block-scaled numerics (AdaptivFloat, blockfp) size their window from
    the tensor, so the overflow point is the payload's own top-of-range —
    modelled as wrapping the top quantization bin's worth of magnitude."""
    numerics = str(t.capabilities.get("numerics", ""))
    writer = _instr(t.ila, _DATA_WRITERS)
    if writer is None:
        return []
    # fixed-range interfaces (hlscnn 16-bit fixed / 8 frac, vta's int8-grid
    # dram rows) saturate at +/-128; block-scaled numerics size their window
    # from the tensor, so the overflow point sits in the far tail of
    # unit-scale data — small validation draws almost never reach it, but
    # application tensors (heavier-tailed residual-stream activations,
    # orders of magnitude more values) do: the classic rare-overflow fault
    # that only application-level validation sees
    vmax = numerics_mod.saturation_point(numerics)

    def fn(rows, vmax=vmax):
        return np.mod(rows + vmax, 2.0 * vmax) - vmax

    return [FaultInstance(
        "sat_wrap", t.name, writer,
        f"operand writes wrap past +/-{vmax:g} instead of saturating",
        payload=_payload_on(_opcode(t.ila, writer), fn),
    )]


def _round_floor_variants(t: AcceleratorTarget) -> List[FaultInstance]:
    """Wrong rounding mode in the operand write datapath: payloads land on
    the storage grid rounded toward -inf instead of to-nearest — a small
    *systematic* bias per value, well inside every per-op tolerance,
    engineered to accumulate across a full application."""
    numerics = str(t.capabilities.get("numerics", ""))
    writer = _instr(t.ila, _DATA_WRITERS)
    grid = numerics_mod.rounding_grid(numerics)
    if writer is None or grid is None:
        # integer-interface targets (VTA) carry pre-quantized integer
        # payloads: a rounding-mode fault has nothing to corrupt
        return []

    def fn(rows, grid=grid):
        return np.floor(rows / grid) * grid

    return [FaultInstance(
        "round_floor", t.name, writer,
        f"operand writes truncate toward -inf on a {grid:g} grid "
        "(systematic half-step bias)",
        payload=_payload_on(_opcode(t.ila, writer), fn),
    )]


def _addr_swap_variants(t: AcceleratorTarget) -> List[FaultInstance]:
    writer = _instr(t.ila, _DATA_WRITERS)
    if writer is None:
        return []

    def wrap(orig):
        def update(st, addr, data):
            if isinstance(addr, torch.Tensor):
                return orig(st, addr.to(torch.int64) ^ 1, data)
            return orig(st, int(addr) ^ 1, data)

        return update

    return [FaultInstance(
        "addr_swap", t.name, writer,
        "adjacent operand rows land at swapped addresses (addr ^ 1)",
        wrappers={writer: wrap}, mutates_bulk=True,
    )]


def _drop_cfg_variants(t: AcceleratorTarget) -> List[FaultInstance]:
    out = []
    for cfg in _instrs(t.ila, _DROPPABLE_CFGS):

        def wrap(orig):
            def update(st, addr, data):
                return st  # the command is silently swallowed

            return update

        out.append(FaultInstance(
            "drop_cfg", t.name, cfg,
            f"setup command {cfg!r} is silently dropped "
            "(configuration stays at reset values)",
            wrappers={cfg: wrap},
        ))
    return out


def _stale_state_variants(t: AcceleratorTarget) -> List[FaultInstance]:
    trig = _instr(t.ila, _TRIGGERS)
    regs = _state_regs(t.ila, _STALE_REGS)
    if trig is None or not regs:
        return []

    out = []
    for reg in regs:

        def wrap(orig, reg=reg):
            def update(st, addr, data):
                polluted = dict(st)
                v = polluted[reg]
                polluted[reg] = (torch.full_like(v, 0.25)
                                 if isinstance(v, torch.Tensor) else 0.25)
                return orig(polluted, addr, data)

            return update

        out.append(FaultInstance(
            "stale_state", t.name,
            trig if len(regs) == 1 else f"{trig}/{reg}",
            f"persistent state {reg!r} holds a previous invocation's "
            "residue instead of the driver-assumed reset value",
            wrappers={trig: wrap},
        ))
    return out


def _decode_alias_variants(t: AcceleratorTarget) -> List[FaultInstance]:
    """Decoder confusion between an adjacent opcode pair (a <-> a^1): the
    classic single-bit decode fault. Operand row-writers are excluded (a
    bulk-path opcode swap would break the slice-update lowering — that
    regime is ``addr_swap``'s); at most two pairs per target keep the
    matrix bounded."""
    excluded = {
        i.opcode for i in t.ila.instructions
        if i.opcode == NOP_OPCODE or i.name.startswith(("write", "wr_"))
    }
    by_op = {i.opcode: i for i in t.ila.instructions}
    out: List[FaultInstance] = []
    for ins in sorted(t.ila.instructions, key=lambda i: i.opcode):
        a, b = ins.opcode, ins.opcode ^ 1
        if a > b or a in excluded or b in excluded or b not in by_op:
            continue
        other = by_op[b]

        def xform(ops, addrs, data, a=a, b=b):
            o = np.asarray(ops)
            swapped = np.where(o == a, b, np.where(o == b, a, o))
            return swapped.astype(np.int32), np.asarray(addrs), data

        out.append(FaultInstance(
            "decode_alias", t.name, f"{ins.name}~{other.name}",
            f"command decoder aliases opcodes {a:#x}<->{b:#x} "
            f"({ins.name!r} and {other.name!r} execute each other's "
            "payloads)",
            stream=xform,
        ))
        if len(out) >= 2:
            break
    return out


def _cmd_reorder_variants(t: AcceleratorTarget) -> List[FaultInstance]:
    """Command-queue reordering: every payload of one config opcode is
    delivered one transaction late — invocation k applies invocation k-1's
    config, and the first sees reset values. A protocol fault invisible to
    single-fragment checks when consecutive invocations share a config."""
    out: List[FaultInstance] = []
    for cfg in _instrs(t.ila, _DROPPABLE_CFGS):
        opcode = _opcode(t.ila, cfg)

        def xform(ops, addrs, data, opcode=opcode):
            o = np.asarray(ops)
            rows = np.flatnonzero(o == opcode)
            if rows.size == 0:
                return ops, addrs, data
            d = np.array(data, np.float32, copy=True)
            delayed = d[rows[:-1]].copy()
            d[rows[0]] = 0.0
            if rows.size > 1:
                d[rows[1:]] = delayed
            return o, np.asarray(addrs), d

        out.append(FaultInstance(
            "cmd_reorder", t.name, cfg,
            f"the command queue delivers {cfg!r} payloads one transaction "
            "late (the first lands on reset values)",
            stream=xform,
        ))
    return out


def _crash_inject_variants(t: AcceleratorTarget) -> List[FaultInstance]:
    writer = _instr(t.ila, _DATA_WRITERS)
    if writer is None:
        return []

    def xform(ops, data):
        raise RuntimeError(
            "crash_inject: deliberate diagnostic crash during co-simulation"
        )

    return [FaultInstance(
        "crash_inject", t.name, writer,
        "diagnostic: raises mid-co-simulation (exercises campaign crash "
        "isolation; never part of the default library)",
        payload=xform,
    )]


def _hang_inject_variants(t: AcceleratorTarget) -> List[FaultInstance]:
    writer = _instr(t.ila, _DATA_WRITERS)
    if writer is None:
        return []

    def xform(ops, data):
        time.sleep(float(os.environ.get("REPRO_HANG_SECONDS", "3600")))
        return data

    return [FaultInstance(
        "hang_inject", t.name, writer,
        "diagnostic: stalls mid-co-simulation (exercises per-mutant "
        "timeouts; never part of the default library)",
        payload=xform,
    )]


FAULT_CLASSES: Dict[str, FaultModel] = {
    m.name: m
    for m in (
        FaultModel("identity", "no-op control mutant", _identity_variants),
        FaultModel("trunc_width", "truncation-width off-by-one",
                   _trunc_width_variants),
        FaultModel("sat_wrap", "saturation becomes wraparound",
                   _sat_wrap_variants),
        FaultModel("round_floor", "round-to-nearest becomes floor",
                   _round_floor_variants),
        FaultModel("addr_swap", "swapped operand address",
                   _addr_swap_variants),
        FaultModel("drop_cfg", "dropped setup/config command",
                   _drop_cfg_variants),
        FaultModel("stale_state", "stale accumulator/state leak",
                   _stale_state_variants),
        FaultModel("decode_alias", "decoder aliases an opcode pair",
                   _decode_alias_variants),
        FaultModel("cmd_reorder", "config payloads delivered one late",
                   _cmd_reorder_variants),
    )
}

#: runner-diagnostic faults: selectable only by explicit name, never part
#: of default enumeration — they stress the campaign engine, not the ILA
DIAGNOSTIC_FAULT_CLASSES: Dict[str, FaultModel] = {
    m.name: m
    for m in (
        FaultModel("crash_inject", "raises during co-simulation",
                   _crash_inject_variants),
        FaultModel("hang_inject", "stalls during co-simulation",
                   _hang_inject_variants),
    )
}


def fault_instances(
    target: AcceleratorTarget, faults: Optional[Sequence[str]] = None
) -> List[FaultInstance]:
    """Applicable fault instances for ``target``, in library order.
    ``faults`` selects fault classes by name (None = the full default
    library; diagnostic classes must be named explicitly)."""
    library = dict(FAULT_CLASSES)
    library.update(DIAGNOSTIC_FAULT_CLASSES)
    names = list(FAULT_CLASSES) if faults is None else list(faults)
    out: List[FaultInstance] = []
    for n in names:
        if n not in library:
            raise KeyError(
                f"unknown fault class {n!r}; available: {list(library)}"
            )
        out.extend(library[n].variants(target))
    return out


# ---------------------------------------------------------------------------
# Mutant construction
# ---------------------------------------------------------------------------


def clone_ila(ila: ILA, wrappers: Optional[Dict[str, Wrapper]] = None) -> ILA:
    """Clone an ILA model, wrapping selected instruction updates. The clone
    shares state initializers and update callables with the source but owns
    its data-runner caches (a mutated instruction set must never reuse the
    golden ILA's data runners, which unroll the golden update table)."""
    wrappers = wrappers or {}
    m = ILA(ila.name, vwidth=ila.vwidth)
    for k, f in ila._state_init.items():
        m.state(k, f)
    for ins in ila.instructions:
        if ins.opcode == NOP_OPCODE:
            continue  # auto-registered by ILA.__init__
        upd = ins.update
        w = wrappers.get(ins.name)
        if w is not None:
            upd = w(upd)
        m.instruction(ins.name, ins.opcode, ins.doc)(upd)
    unknown = set(wrappers) - {i.name for i in ila.instructions}
    if unknown:
        raise KeyError(f"fault wraps unknown instructions {sorted(unknown)}")
    return m


def _xform_stream(ps: PackedStream, fn) -> PackedStream:
    ops, addrs, data = fn(np.asarray(ps.ops), np.asarray(ps.addrs),
                          np.asarray(ps.data, np.float32))
    return PackedStream(np.asarray(ops, np.int32),
                        np.asarray(addrs, np.int32),
                        np.asarray(data, np.float32))


def _xform_data(ds: DataStream, fn) -> DataStream:
    bulk = []
    for b in ds.bulk:
        n = b.rows.shape[0]
        ops = np.full((n,), b.opcode, np.int32)
        addrs = np.arange(b.base, b.base + n, dtype=np.int32)
        o2, a2, rows = fn(ops, addrs, np.asarray(b.rows, np.float32))
        if not (np.array_equal(np.asarray(o2), ops)
                and np.array_equal(np.asarray(a2), addrs)):
            raise ValueError(
                "stream transform rewrote a bulk operand run's opcodes or "
                "addresses — that breaks the fragment compiler's "
                "slice-update lowering; protocol faults may only touch "
                "tail/setup commands (bulk semantics faults belong to "
                "mutates_bulk wrapper faults)"
            )
        bulk.append(dataclasses.replace(b, rows=np.asarray(rows, np.float32)))
    return DataStream(bulk, _xform_stream(ds.tail, fn))


def _mutant_planner(planner: Callable, mutant: AcceleratorTarget,
                    inst: FaultInstance) -> Callable:
    """Delegate to the golden planner (warm golden-side packing caches),
    then rebind every SimJob onto the mutant: the fragment resolves through
    the mutant's private cache — setup streams re-simulate under the
    mutant's ILA (payload faults corrupt them host-side first), exactly
    like a second physical device loading its own weights. Payload faults
    transform the per-invocation streams in place (the bulk fast path stays
    valid); bulk-mutating wrapper faults force the full-stream scan tier."""

    hx = inst.host_xform()

    def plan(ctx, x, args):
        jobs, assemble = planner(ctx, x, args)
        rebound = []
        for j in jobs:
            frag = mutant.fragments.get(
                j.frag.key,
                lambda f=j.frag: CompiledFragment(
                    mutant.ila, f.key,
                    (_xform_stream(f.setup, hx)
                     if hx is not None and len(f.setup)
                     else f.setup),
                    dict(f.meta),
                ),
            )
            data = j.data
            if hx is not None:
                data = (_xform_data(data, hx)
                        if isinstance(data, DataStream)
                        else _xform_stream(data, hx))
            elif inst.mutates_bulk and isinstance(data, DataStream):
                data = data.to_stream()
            rebound.append(SimJob(frag, data, j.read, j.window))
        return rebound, assemble

    return plan


def make_mutant(target: AcceleratorTarget, inst: FaultInstance) -> AcceleratorTarget:
    """Clone ``target`` into an ephemeral mutant carrying ``inst``.

    The mutant keeps the golden name and intrinsic op set (swap it in with
    :func:`swapped_in`), shares the golden cost model / rewrites / declared
    validation cases, and owns a private fragment cache bound to its ILA.
    Wrapper faults (and the identity control, which exercises the clone
    machinery) get a cloned ILA with fresh data-runner caches; host-side
    faults (payload and/or stream transforms without wrappers) corrupt
    command streams before simulation and share the golden ILA — and
    therefore its warm data runners.

    The mutant declares no fused runner: the fused engine's runners compute
    FN_START and CONV_START from a fragment's golden build-time meta, not
    from the instruction updates, so a mutant that took them would run
    golden semantics and every wrapper fault would read as an escape. Its
    fragments therefore run on the compiled tier under every engine.
    It also drops VT3 checks (bound to the golden module-level ILA)."""
    host_only = (
        (inst.payload is not None or inst.stream is not None)
        and not inst.wrappers
    )
    m = AcceleratorTarget(
        target.name,
        target.ila if host_only else clone_ila(target.ila, inst.wrappers),
        display_name=f"{target.display_name}[{inst.fault}]",
        capabilities=target.capabilities,
        doc=f"fault mutant of {target.name}: {inst.note}",
        vt2_tol=target.vt2_tol,
    )
    m.fault = inst
    m.cost_model = target.cost_model
    m._rewrite_fns = list(target._rewrite_fns)
    m._vt2_fns = list(target._vt2_fns)
    m._mapping_fns = list(target._mapping_fns)
    for op, intr in target.intrinsics.items():
        planner = intr.planner
        if planner is not None:
            planner = _mutant_planner(planner, m, inst)
        m.add_intrinsic(dataclasses.replace(intr, planner=planner))
    return m


@contextlib.contextmanager
def swapped_in(mutant: AcceleratorTarget):
    """Swap ``mutant`` in for the like-named golden registration.

    Replaces the target in the registry *in place* (order preserved) and
    re-points the IR accel-op extension specs at the mutant's intrinsics;
    on exit the exact prior target and spec objects are reinstated, so any
    number of swaps leaves the process-wide registries bit-identical. The
    registry swap runs first — it validates the mutant (known name, same
    op set) before anything is mutated — and the spec re-registration is
    covered by the restoring ``finally``, so a failure at any point leaves
    both registries untouched."""
    golden = TARGETS.replace(mutant)
    displaced_specs: Dict[str, Any] = {}
    try:
        for op, intr in mutant.intrinsics.items():
            displaced_specs[op] = ir.register_accel_op(
                op, mutant.name, intr.shape, intr.ideal, not intr.passthrough
            )
        yield golden
    finally:
        # every restoration step runs even if an earlier one fails — a
        # single bad spec must not leak the registry swap or the remaining
        # specs; the first failure is re-raised once everything possible
        # has been restored
        restore_err: Optional[BaseException] = None
        try:
            TARGETS.replace(golden)
        except BaseException as e:  # pragma: no cover - defensive
            restore_err = e
        for op, spec in displaced_specs.items():
            try:
                ir.restore_accel_op(op, spec)
            except BaseException as e:  # pragma: no cover - defensive
                restore_err = restore_err or e
        if restore_err is not None:  # pragma: no cover - defensive
            raise restore_err
