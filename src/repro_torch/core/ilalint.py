"""Static verification of ILA models and their command streams.

The ILA is a *formal* software/hardware interface — every instruction is a
state-update function, and every planner emits concrete command streams.
That formality buys analyses that need **zero simulated commands**: this
module derives each ``Instruction.update``'s read/write footprint over
architectural state and runs three passes over every registered
:class:`~repro_torch.accel.target.AcceleratorTarget`:

1. **Decode soundness** — the bundled ILAs decode by opcode equality, so
   completeness and disjointness reduce to set checks over the registered
   instruction list versus the opcodes planners actually emit: overlapping
   claims (one opcode, two instructions — the ``decode_alias`` fault
   surface, and the shadowed instruction is unreachable), claims on the
   reserved NOP opcode, and emitted opcodes no instruction decodes.

2. **State dataflow / hazards** — per-instruction read/write sets, then a
   linear walk over planner-emitted :class:`~.ila.PackedStream` probes flags
   reads of never-written state (uninitialized configuration), reports
   carried cross-fragment state (the ``stale_state`` surface) and the
   write-then-read pairs that make a stream order-sensitive (the
   ``cmd_reorder`` sensitivity predicate).

3. **Numeric range analysis** — an interval domain propagated from each
   target's *declared* operand range (``AcceleratorTarget.lint``) through
   its numerics family (:mod:`repro_torch.accel.numerics`): where the
   interval crosses the family's saturation point, wrap/saturation is
   statically reachable ("wrap reachable for \\|x\\| > 4.5") — the
   ``sat_wrap`` escape as a report instead of an application-accuracy
   collapse — and :func:`boundary_inputs` turns the reported boundary into
   targeted operands for the co-simulation tiers.

Instruction effects
-------------------

The JAX reference reads the footprint off a jaxpr: a state leaf is *read*
if its input variable feeds any equation, *written* if its output is not
the input passed straight through. A partial write into a buffer reads it
(``dynamic_update_slice`` consumes the buffer); a register that is
overwritten whole is not read. This module keeps that definition and gets
it by running the update once under a ``TorchDispatchMode`` that labels
every state tensor with its key and records which labels each aten op
consumes:

* the port's updates branch in Python on *host* registers, so a run at one
  register value would see one branch only. The trace therefore runs the
  update on a batched state: every register is a ``(B,)`` tensor holding
  ``0 .. B-1``, the address a ``(B,)`` tensor and the payload a ``(B, V)``
  tensor, which sends every ``branch`` down its masked path over all
  selected functions (FlexASR's FN_START runs all six, as the reference's
  ``lax.switch`` jaxpr reads all six);
* the simulator's own bookkeeping — ``ILA.own``'s clones,
  ``expand_batch``'s broadcasts and ``merge_rows``' per-row ``where`` of
  two copies of the same entry — forwards a label without reading it, so
  a state entry every branch passes through stays a pass-through;
* an in-place write into a labeled tensor reads it and clears its label
  (the version counter moved), so the entry counts as written.

The trace runs on CPU tensors whatever the lint's device is (it runs
instruction updates on a batch of 8, nothing else): effects are a property
of the model, not of the card.

Severity model: ``error`` and ``warn`` are *findings* (golden targets must
have none — the false-positive budget); ``note`` records true facts about
fault surfaces (order sensitivity, carried state, reachable wrap) that are
properties of the design, not defects.

The same machinery gives the fault campaign its tier 0:
:func:`analyze_mutation` compares golden probe streams against a mutant's
host-side stream transform and classifies the difference — opcode/address
rewrites (decode violation), config-payload divergence whose registers are
read downstream (order sensitivity), or bulk-operand corruption (numeric;
deliberately deferred to the simulation tiers).
"""
from __future__ import annotations

import dataclasses
import weakref
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from . import ir
from .ila import ILA, NOP_OPCODE, TARGETS, DataStream, PackedStream

SEVERITIES = ("note", "warn", "error")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis result.

    severity  "error" | "warn" (findings) | "note" (fault-surface facts).
    pass_name "decode" | "hazard" | "range".
    subject   the instruction / register / stream the result is about.
    """

    severity: str
    pass_name: str
    target: str
    subject: str
    message: str

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"[{self.severity:5s}] {self.target}/{self.pass_name} "
                f"{self.subject}: {self.message}")


def severity_at_least(f: Finding, floor: str) -> bool:
    return SEVERITIES.index(f.severity) >= SEVERITIES.index(floor)


# ---------------------------------------------------------------------------
# Instruction effects from a labeled trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InstrEffect:
    """Read/write footprint of one instruction over architectural state."""

    name: str
    opcode: int
    reads: frozenset            # state keys consumed by any op
    writes: frozenset           # state keys whose output differs from input
    scalar_writes: frozenset    # writes to ndim-0 registers (configuration)
    buffer_writes: frozenset    # writes to tensor-shaped state
    reads_data: bool            # consumes the command payload
    reads_addr: bool            # consumes the command address

    @property
    def is_config_writer(self) -> bool:
        """Writes configuration registers and nothing else."""
        return bool(self.scalar_writes) and not self.buffer_writes

    @property
    def is_bulk_writer(self) -> bool:
        return bool(self.buffer_writes)


_aten = torch.ops.aten
#: simulator bookkeeping: the output is the input entry, not a use of it
_FORWARD = {_aten.clone, _aten.alias, _aten.detach, _aten.expand, _aten.unsqueeze}

#: batch of the traced state: registers hold 0 .. B-1, which reaches every
#: branch of the bundled updates (FlexASR's six FN_START modes need 1..6)
TRACE_BATCH = 8


class _Tracer(TorchDispatchMode):
    """Labels tensors with the state key they hold and records the labels
    every non-forwarding aten op consumes. A label is valid while the
    tensor's version counter has not moved (no in-place write since)."""

    def __init__(self):
        super().__init__()
        self._labels: Dict[int, Tuple[torch.Tensor, str, int]] = {}
        self.reads: set = set()

    def label(self, t: torch.Tensor, name: str) -> None:
        self._labels[id(t)] = (t, name, t._version)

    def label_of(self, t) -> Optional[str]:
        if not isinstance(t, torch.Tensor):
            return None
        e = self._labels.get(id(t))
        if e is None or e[0] is not t or e[2] != t._version:
            return None
        return e[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        labels = [self.label_of(t) for t in tree_leaves((args, kwargs))]
        packet = func.overloadpacket
        mutates = any(a.alias_info is not None and a.alias_info.is_write
                      for a in func._schema.arguments)
        out = func(*args, **kwargs)
        if packet in _FORWARD and not mutates:
            if labels[0] is not None and isinstance(out, torch.Tensor):
                self.label(out, labels[0])
            return out
        if packet is _aten.where and len(labels) == 3 and labels[1] is not None \
                and labels[1] == labels[2]:
            # per-row merge of two copies of one entry: a pass-through
            self.reads.update(x for x in labels[:1] if x is not None)
            self.label(out, labels[1])
            return out
        self.reads.update(x for x in labels if x is not None)
        return out


# effect extraction is pure per (ILA, instruction set); cache per instance
_EFFECTS_CACHE: "weakref.WeakKeyDictionary[ILA, List[InstrEffect]]" = (
    weakref.WeakKeyDictionary()
)


def _trace_effect(ila: ILA, ins) -> InstrEffect:
    B = TRACE_BATCH
    reset = ila.init_state("cpu")
    keys = sorted(reset)
    scalar_keys = {k for k, v in reset.items() if not isinstance(v, torch.Tensor)}
    tr = _Tracer()
    ramp = torch.arange(B, dtype=torch.float32)
    st = {k: (ramp.clone() if k in scalar_keys else v) for k, v in reset.items()}
    addr = torch.arange(B, dtype=torch.int64)
    data = ramp[:, None].repeat(1, ila.vwidth)
    for k in keys:
        tr.label(st[k], k)
    tr.label(addr, "\0addr")
    tr.label(data, "\0data")
    with torch.no_grad(), tr:
        out = ins.update(dict(st), addr, data)
        writes = frozenset(k for k in keys if tr.label_of(out[k]) != k)
    reads = frozenset(k for k in keys if k in tr.reads)
    scalar = frozenset(k for k in writes if k in scalar_keys)
    return InstrEffect(
        name=ins.name,
        opcode=ins.opcode,
        reads=reads,
        writes=writes,
        scalar_writes=scalar,
        buffer_writes=writes - scalar,
        reads_data="\0data" in tr.reads,
        reads_addr="\0addr" in tr.reads,
    )


def effects(ila: ILA) -> List[InstrEffect]:
    """Per-instruction effects for every registered instruction, in
    registration order (duplicate opcodes kept — the decode pass needs
    them). Cached per ILA instance."""
    cached = _EFFECTS_CACHE.get(ila)
    if cached is not None:
        return cached
    out = [_trace_effect(ila, ins) for ins in ila.instructions]
    _EFFECTS_CACHE[ila] = out
    return out


def effects_by_opcode(ila: ILA) -> Dict[int, InstrEffect]:
    """Decode view of :func:`effects`: later registrations win, exactly
    like the ILA's opcode dispatch table."""
    return {e.opcode: e for e in effects(ila)}


# ---------------------------------------------------------------------------
# Probe streams: what the planners actually emit (zero simulation)
# ---------------------------------------------------------------------------


def probe_streams(
    target, seed: int = 0, samples: int = 1
) -> List[Tuple[str, PackedStream]]:
    """Concrete command streams for every planner-backed intrinsic: sampled
    operands run through the planner only — fragment setup plus data
    streams are packed host-side; ``CompiledFragment.setup_state`` stays
    lazy, so **nothing is simulated**. Sampling is crc32-seeded per
    (target, op) so probes are identical across processes (and equal to
    the reference's)."""
    out: List[Tuple[str, PackedStream]] = []
    for op, intr in target.intrinsics.items():
        if intr.planner is None or intr.sample is None:
            continue
        rng = np.random.default_rng(
            zlib.crc32(f"{target.name}:{op}:{seed}".encode())
        )
        ctx = _null_plan_context(intr)
        for _ in range(samples):
            args, attrs = intr.sample(rng)
            vs = tuple(ir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
            x = ir.call(op, *vs, **attrs)
            jobs, _ = intr.planner(ctx, x, [np.asarray(a) for a in args])
            for j in jobs:
                data = (
                    j.data.to_stream()
                    if isinstance(j.data, DataStream)
                    else j.data
                )
                out.append((op, PackedStream.concat([j.frag.setup, data])))
    return out


def _null_plan_context(intr):
    from ..accel.target import PlanContext

    return PlanContext(record=lambda *a, **kw: None, options=dict(intr.options))


# ---------------------------------------------------------------------------
# Pass 1: decode soundness
# ---------------------------------------------------------------------------


def decode_pass(
    target, probes: Sequence[Tuple[str, PackedStream]]
) -> List[Finding]:
    ila = target.ila
    out: List[Finding] = []
    claimed: Dict[int, str] = {}
    for ins in ila.instructions:
        if ins.opcode in claimed:
            out.append(Finding(
                "error", "decode", target.name, ins.name,
                f"opcode {ins.opcode:#x} already decodes to "
                f"{claimed[ins.opcode]!r}; the earlier instruction is "
                f"shadowed and unreachable (decode_alias surface)",
            ))
        else:
            claimed[ins.opcode] = ins.name
        if ins.opcode == NOP_OPCODE and ins.name != "nop":
            out.append(Finding(
                "error", "decode", target.name, ins.name,
                f"claims the reserved NOP opcode {NOP_OPCODE:#x}",
            ))

    emitted: set = set()
    for op, stream in probes:
        for o in np.unique(stream.ops):
            emitted.add(int(o))
            if int(o) not in claimed:
                out.append(Finding(
                    "error", "decode", target.name, op,
                    f"planner emits opcode {int(o):#x} that no "
                    f"instruction decodes",
                ))
    uncovered = sorted(
        ins.name for ins in ila.instructions
        if ins.opcode not in emitted and ins.name != "nop"
    )
    if uncovered and probes:
        out.append(Finding(
            "note", "decode", target.name, ",".join(uncovered),
            "never emitted by the sampled probe streams "
            "(unreachable from the bundled planners)",
        ))
    return out


# ---------------------------------------------------------------------------
# Pass 2: state dataflow / hazards over probe streams
# ---------------------------------------------------------------------------


def _scalar_keys(ila: ILA) -> set:
    return {k for k, v in ila.init_state("meta").items() if not isinstance(v, torch.Tensor)}


def hazard_pass(
    target, probes: Sequence[Tuple[str, PackedStream]]
) -> List[Finding]:
    ila = target.ila
    decl = target.lint
    by_op = effects_by_opcode(ila)
    scalar_keys = _scalar_keys(ila)
    exempt = set(decl.reset_valid) | set(decl.carried_state)

    uninit: Dict[Tuple[str, str], str] = {}   # (reader, reg) -> op
    carried: set = set()
    for op, stream in probes:
        written: set = set()
        for o in stream.ops:
            e = by_op.get(int(o))
            if e is None:
                continue  # decode pass reports undecodable opcodes
            for r in sorted(e.reads):
                if r in written:
                    continue
                if r in decl.carried_state:
                    carried.add(r)
                elif r in e.writes:
                    continue  # read-modify-write of reset state (accumulate)
                elif r not in exempt:
                    uninit.setdefault((e.name, r), op)
            written |= e.writes

    out: List[Finding] = []
    for (reader, reg), op in sorted(uninit.items()):
        out.append(Finding(
            "warn", "hazard", target.name, f"{reader}/{reg}",
            f"reads {reg!r} before any command in the {op} stream writes "
            f"it (uninitialized state; declare it reset_valid or "
            f"carried_state if intentional)",
        ))
    if carried:
        out.append(Finding(
            "note", "hazard", target.name, ",".join(sorted(carried)),
            "carried across fragment boundaries by declaration "
            "(stale_state fault surface)",
        ))
    # write-then-read over configuration registers: the reorder surface
    sensitive = _order_sensitive_regs(by_op, probes, scalar_keys)
    if sensitive:
        out.append(Finding(
            "note", "hazard", target.name, ",".join(sorted(sensitive)),
            "configuration written then read within one stream — command "
            "order is semantically significant (cmd_reorder surface)",
        ))
    return out


def _order_sensitive_regs(
    by_op, probes: Sequence[Tuple[str, PackedStream]], scalar_keys
) -> set:
    """Scalar registers with a write at position i and a read at j > i in
    some probe stream: reordering the write past the read changes the
    architectural result."""
    sensitive: set = set()
    for _, stream in probes:
        pending: set = set()
        for o in stream.ops:
            e = by_op.get(int(o))
            if e is None:
                continue
            sensitive |= pending & e.reads
            pending |= e.scalar_writes & scalar_keys
    return sensitive


# ---------------------------------------------------------------------------
# Pass 3: numeric range analysis (interval domain)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed interval [lo, hi] — the abstract numeric domain."""

    lo: float
    hi: float

    @property
    def mag(self) -> float:
        return max(abs(self.lo), abs(self.hi))

    def __add__(self, o: "Interval") -> "Interval":
        return Interval(self.lo + o.lo, self.hi + o.hi)

    def __mul__(self, o: "Interval") -> "Interval":
        c = (self.lo * o.lo, self.lo * o.hi, self.hi * o.lo, self.hi * o.hi)
        return Interval(min(c), max(c))

    def scale(self, k: float) -> "Interval":
        return Interval(min(self.lo * k, self.hi * k),
                        max(self.lo * k, self.hi * k))

    def accumulate(self, o: "Interval", depth: int) -> "Interval":
        """Range of a depth-``depth`` sum of products (dot product)."""
        return (self * o).scale(float(depth))

    def clip(self, bound: float) -> "Interval":
        return Interval(max(self.lo, -bound), min(self.hi, bound))


def range_pass(target) -> List[Finding]:
    from ..accel import numerics

    decl = target.lint
    if decl.input_range is None:
        return []
    lo, hi = decl.input_range
    iv = Interval(float(lo), float(hi))
    family = str(target.capabilities.get("numerics", ""))
    sat = numerics.saturation_point(family)
    out: List[Finding] = []
    if iv.mag > sat:
        out.append(Finding(
            "note", "range", target.name, family or "numerics",
            f"wrap reachable for |x| > {sat:g}: declared operand range "
            f"[{lo:g}, {hi:g}] crosses the write-datapath saturation "
            f"point (sat_wrap surface; boundary_inputs() targets it)",
        ))
    return out


def boundary_inputs(target, n: int = 64, seed: int = 0) -> np.ndarray:
    """Targeted co-sim operands straddling the target's saturation point:
    half the values just inside, half just outside (sign-alternating), so
    one op-level diff separates saturate-correct from wrap-faulty
    datapaths — the draws random sampling almost never produces."""
    from ..accel import numerics

    family = str(target.capabilities.get("numerics", ""))
    sat = numerics.saturation_point(family)
    rng = np.random.default_rng(
        zlib.crc32(f"{target.name}:boundary:{seed}".encode())
    )
    mags = sat * rng.uniform(0.8, 1.2, size=n)
    signs = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return (mags * signs).astype(np.float32)


# ---------------------------------------------------------------------------
# Whole-target / whole-registry lint
# ---------------------------------------------------------------------------


def lint_target(target, seed: int = 0, samples: int = 1) -> List[Finding]:
    """All three passes over one target. Raises nothing: trace or planner
    failures become error findings."""
    try:
        probes = probe_streams(target, seed=seed, samples=samples)
    except Exception as e:  # planner bug: report, keep linting the ILA
        probes = []
        return [Finding(
            "error", "decode", target.name, "probes",
            f"probe collection failed: {type(e).__name__}: {e}",
        )] + decode_pass(target, probes) + range_pass(target)
    try:
        effects(target.ila)
    except Exception as e:
        return [Finding(
            "error", "hazard", target.name, "effects",
            f"update-function tracing failed: {type(e).__name__}: {e}",
        )]
    return (decode_pass(target, probes)
            + hazard_pass(target, probes)
            + range_pass(target))


def lint_registry(
    names: Optional[Sequence[str]] = None, seed: int = 0, samples: int = 1
) -> Dict[str, List[Finding]]:
    names = list(names) if names else TARGETS.names()
    return {
        n: lint_target(TARGETS.get(n), seed=seed, samples=samples)
        for n in names
    }


# ---------------------------------------------------------------------------
# Campaign tier 0: classify a mutant's host-side stream transform
# ---------------------------------------------------------------------------


def analyze_mutation(
    target,
    probes: Sequence[Tuple[str, PackedStream]],
    host_xform: Callable,
) -> Tuple[bool, float, str]:
    """Run the golden probe streams through a mutant's host-side transform
    and classify the divergence — still zero simulated commands.

    Returns ``(detected, score, detail)`` where score is the fraction of
    probe streams the static passes flag. Detection rules:

    * opcode or address rewrites — decode soundness violation (the
      transformed stream no longer decodes to the golden instruction
      sequence): ``decode_alias``-class faults;
    * payload divergence on config-writer commands whose written registers
      a later command reads — the order-sensitivity predicate fires:
      ``cmd_reorder``-class faults;
    * payload divergence confined to bulk data-writer commands — numeric
      datapath corruption, *deliberately not* a static detection (value
      faults like ``sat_wrap`` are the simulation tiers' job; the range
      pass reports where to look).
    """
    by_op = effects_by_opcode(target.ila)
    flagged = 0
    bulk_only = 0
    reasons: List[str] = []
    for op, stream in probes:
        ops1, addrs1, data1 = host_xform(
            stream.ops.copy(), stream.addrs.copy(), stream.data.copy()
        )
        ops1 = np.asarray(ops1)
        addrs1 = np.asarray(addrs1)
        data1 = np.asarray(data1)
        if ops1.shape != stream.ops.shape or not np.array_equal(
            ops1, stream.ops
        ):
            flagged += 1
            if len(reasons) < 3:
                reasons.append(f"{op}: opcode stream rewritten"
                               + _first_opcode_diff(stream.ops, ops1, by_op))
            continue
        if not np.array_equal(addrs1, stream.addrs):
            flagged += 1
            if len(reasons) < 3:
                reasons.append(f"{op}: address stream rewritten")
            continue
        rows = np.flatnonzero(np.any(data1 != stream.data, axis=1))
        if rows.size == 0:
            continue
        hit = _config_payload_hazard(stream, rows, by_op)
        if hit is not None:
            flagged += 1
            if len(reasons) < 3:
                reasons.append(f"{op}: {hit}")
        else:
            bulk_only += 1
    if flagged:
        score = flagged / max(len(probes), 1)
        return True, score, "; ".join(reasons)
    detail = "streams identical under transform"
    if bulk_only:
        detail = (f"bulk operand payloads diverge on {bulk_only} stream(s) "
                  "— numeric datapath fault, deferred to simulation tiers")
    return False, 0.0, detail


def _first_opcode_diff(ops0: np.ndarray, ops1: np.ndarray, by_op) -> str:
    if ops0.shape != ops1.shape:
        return f" ({len(ops0)} -> {len(ops1)} commands)"
    i = int(np.flatnonzero(ops0 != ops1)[0])
    a, b = int(ops0[i]), int(ops1[i])
    na = by_op[a].name if a in by_op else f"{a:#x}"
    nb = by_op[b].name if b in by_op else f"{b:#x}"
    return f" (cmd {i}: {na} -> {nb})"


def _config_payload_hazard(
    stream: PackedStream, rows: np.ndarray, by_op
) -> Optional[str]:
    """Does any payload-diverging row configure a register that a later
    command in the stream reads? That is exactly the order-sensitivity
    predicate: the corrupted configuration is architecturally consumed."""
    for i in rows:
        e = by_op.get(int(stream.ops[i]))
        if e is None or not e.is_config_writer:
            continue
        downstream = set()
        for o in stream.ops[i + 1:]:
            later = by_op.get(int(o))
            if later is not None:
                downstream |= later.reads
        hot = sorted(e.scalar_writes & downstream)
        if hot:
            return (f"config payload of {e.name!r} diverges and "
                    f"{hot} are read downstream (order-sensitive)")
    return None
