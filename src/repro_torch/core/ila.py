"""Instruction-Level Abstraction (ILA) formalism in PyTorch.

Mirrors ILAng's model (Huang et al., TODAES'18; Figure 6 of the paper):

* an ILA has **architectural state** — named buffers/registers, here a dict
  of tensors and numbers;
* each **instruction** corresponds to one command at the accelerator's
  interface (an MMIO write in the paper) and is given by a **decode**
  predicate over the command plus a **state-update function**;
* a **program fragment** is a sequence of commands; simulation folds the
  update functions over the fragment — ILAng's auto-generated software
  simulator.

Commands are uniform records so fragments can be stacked into arrays:

    Command(opcode: int, addr: int, data: float32[V])

State representation
--------------------

The reference vmaps one per-sample simulator over a batch; JAX tracks which
values carry the batch axis. Here the state itself carries it:

* a buffer is a tensor of its natural shape (shared by the whole batch) or
  with a leading batch axis ``B`` (one copy per stream);
* a register is a Python float when the host knows it (it was written from
  a payload row shared by the batch: configuration, mode, geometry) or a
  ``(B,)`` tensor when the rows that wrote it differ across the batch (the
  per-sample AdaptivFloat exponent windows).

An update may branch in Python on a host register; a batched register is
applied under a per-row mask. This is what the reference's ``shared_mask``
buys: FN_START's mode dispatch runs one branch, not all of them.

Simulation entry points take ownership of the state they start from (one
clone of its tensors), and instruction updates then write in place into
that copy. A cached state — the post-setup state a ``CompiledFragment``
shares across invocations — is never written.

Fragment-compiler tiers
-----------------------

* ``PackedStream``    — a command stream as dense host arrays;
* a reserved ``NOP`` instruction, auto-registered on every ILA, so streams
  pad to power-of-two **length buckets**;
* ``ILA.simulate_packed`` / ``ILA.simulate_batch`` — single-stream and
  batched simulation over stacked command streams;
* ``CompiledFragment`` — a *setup* stream (weight/config load) simulated once
  per device and cached as architectural state, so steady-state invocations
  only pack and simulate the per-sample *data* stream;
* ``FragmentCache``   — an LRU keyed on (op, operand shapes, params
  fingerprint) holding compiled fragments across Executor invocations.

The batched tiers are split into a **host half** (pure numpy: padding,
stacking, shared-payload detection — safe in a pack worker thread) and a
**dispatch half** (the device work, which CUDA runs asynchronously), which
the Executor's pipelined engine overlaps.

With a **stream mesh** (:func:`set_stream_mesh`) the batched tiers split the
padded batch axis into equal contiguous shards, one per mesh device; each
shard runs on its own device from that device's copy of the setup state,
and the result is a :class:`Shards` list that the Executor joins on the
host, in mesh order, where it reads the group back.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve
from .telemetry import TELEMETRY

State = Dict[str, Any]
#: a host-known index, or one per stream of a batch (a ``(B,)`` LongTensor)
Index = Union[int, torch.Tensor]

# Reserved opcode: identity state update, used only for bucket padding. No
# accelerator model may claim it (they all start their maps at 0x10).
NOP_OPCODE = 0

MIN_BUCKET = 16
MAX_DATA_RUNNERS = 128


def bucket_length(n: int, min_len: int = MIN_BUCKET) -> int:
    """Next power-of-two >= max(n, min_len): the padded stream length."""
    n = max(int(n), min_len)
    return 1 << (n - 1).bit_length()


#: batch-axis bucket ladder for the batched simulators. "pow2" (default)
#: pads the batch dimension to the next power of two; "serving" adds the
#: 3/4-of-pow2 steps (1,2,3,4,6,8,12,16,24,32,...) so coalesced
#: cross-request batches waste less replay padding.
_BATCH_LADDER = "pow2"


def set_batch_ladder(mode: str = "pow2") -> str:
    """Select the batch-axis bucket ladder ("pow2" or "serving"); returns
    the previous mode so callers can restore it. Padding replays the last
    stream and callers slice [:B], so the ladder never changes results."""
    global _BATCH_LADDER
    assert mode in ("pow2", "serving"), f"unknown batch ladder {mode!r}"
    prev = _BATCH_LADDER
    _BATCH_LADDER = mode
    return prev


def batch_bucket(n: int) -> int:
    """Padded batch size for ``n`` streams under the active ladder."""
    p = bucket_length(n, min_len=1)
    if _BATCH_LADDER == "serving" and p >= 4 and n <= (3 * p) // 4:
        return (3 * p) // 4
    return p


# --------------------------------------------------------------------------
# Stream mesh: shard the stacked batch axis over several devices
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """The devices a batched simulation splits its batch axis over, in
    shard order: the counterpart of the reference's 1-D
    ``Mesh(devices, ("stream",))``."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __str__(self) -> str:
        return f"StreamMesh({', '.join(str(d) for d in self.devices)})"


#: process-wide mesh over which batched simulation shards its stream axis
#: (None = single-device dispatch, the default)
_STREAM_MESH: Optional[StreamMesh] = None


def set_stream_mesh(spec: Any = "auto") -> Optional[StreamMesh]:
    """Configure batch-axis sharding for ``simulate_batch``/``run_data_batch``,
    the Executor's batched groups and the fused runners.

    ``spec`` is ``None``/``"off"`` (disable), ``"auto"`` (every card,
    ``torch.cuda.device_count()``), an int N (the first N cards; more than
    the host has raises), a :class:`StreamMesh`, or a sequence of devices.
    Returns the active mesh, or None when fewer than two devices result
    (sharding would be a no-op, so it is disabled rather than building a
    trivial mesh): on a host without a card ``"auto"`` is None, never a CPU
    mesh.

    A sequence may repeat a device (``["cpu"] * 4``, ``["cuda:0"] * 2``):
    every shard then runs on that device, one after the other. This is the
    counterpart of the reference's
    ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` virtual devices,
    and how the sharded path runs on a CPU or on a one-card host.
    """
    global _STREAM_MESH
    if spec is None or (isinstance(spec, str) and spec == "off"):
        devs: Tuple[torch.device, ...] = ()
    elif isinstance(spec, StreamMesh):
        devs = spec.devices
    elif isinstance(spec, (str, int)):
        have = torch.cuda.device_count()
        n = have if spec == "auto" else int(spec)
        if n >= 2 and n > have:
            raise ValueError(f"a stream mesh of {n} cards asked for on a host with {have}")
        devs = tuple(resolve(f"cuda:{i}") for i in range(n)) if n >= 2 else ()
    else:
        devs = tuple(resolve(d) for d in spec)
    _STREAM_MESH = StreamMesh(devs) if len(devs) >= 2 else None
    return _STREAM_MESH


def stream_mesh() -> Optional[StreamMesh]:
    return _STREAM_MESH


def mesh_pad(n: int) -> int:
    """Round a padded batch size up to a multiple of the stream mesh size
    (identity without a mesh), so the shards are equal."""
    if _STREAM_MESH is None:
        return n
    m = _STREAM_MESH.size
    return -(-n // m) * m


def _shard_batched(x) -> list:
    """The stream mesh's shards of a batch-leading array: equal contiguous
    slices of axis 0, one per mesh device, in mesh order. The shards of a
    host array stay on the host: each consumer copies its shard to its own
    device."""
    m = _STREAM_MESH.size
    B = int(x.shape[0])
    assert B % m == 0, f"a batch of {B} does not split over {m} mesh devices (mesh_pad)"
    s = B // m
    return [x[i * s : (i + 1) * s] for i in range(m)]


def _replicated(state) -> List[State]:
    """An unbatched state on every mesh device, in mesh order. A list (one
    state per device, as :class:`CompiledFragment` memoises its setup
    state) passes through; a single state is copied to each device."""
    if isinstance(state, list):
        assert len(state) == _STREAM_MESH.size
        return state
    return [
        {k: (v.to(d) if isinstance(v, torch.Tensor) else v) for k, v in state.items()}
        for d in _STREAM_MESH.devices
    ]


class Shards(list):
    """A sharded group's result: one value per mesh device, in mesh order,
    each on its own device. The shards meet once, on the host, where the
    Executor reads a group back (``codegen.to_numpy``)."""


# --------------------------------------------------------------------------
# Batch-polymorphic state access (used by the accelerator models)
# --------------------------------------------------------------------------


def payload(data, device: torch.device) -> torch.Tensor:
    """A payload row as a device tensor: ``(V,)`` from a host row, or the
    ``(B, V)`` tensor of a batched one as is."""
    if isinstance(data, torch.Tensor):
        return data
    a = np.ascontiguousarray(data, np.float32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def register(data, i: int):
    """Register value carried in lane ``i`` of a payload row: a float for a
    host row, a ``(B,)`` tensor for a batched one."""
    if isinstance(data, torch.Tensor):
        return data[:, i]
    return float(data[i])


def bcast(r, nd: int):
    """A register shaped to broadcast against ``(B, *nd dims)`` tensors."""
    if isinstance(r, torch.Tensor):
        return r.reshape((r.shape[0],) + (1,) * nd)
    return r


def _batch_of(tensors, nd: int) -> Optional[int]:
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.dim() > nd:
            return int(t.shape[0])
    return None


def _start(s: int, size: int, b: int) -> int:
    """A dynamic start as ``jax.lax`` resolves it: a negative start wraps
    once (``+ size``), then the start clamps so the block fits."""
    s = int(s)
    if s < 0:
        s += size
    return min(max(s, 0), size - b)


def _block_index(starts, sizes, bshape, B, device):
    """Per-stream advanced indices for a block at clamped dynamic starts."""
    nd = len(starts)
    idx = [torch.arange(B, device=device).view([B] + [1] * nd)]
    for d, (s, size, b) in enumerate(zip(starts, sizes, bshape)):
        s = torch.as_tensor(s, device=device).to(torch.int64).expand(B)
        s = torch.where(s < 0, s + size, s).clamp(0, size - b).view([B] + [1] * nd)
        ar = torch.arange(b, device=device).view([1] * (d + 1) + [b] + [1] * (nd - d - 1))
        idx.append(s + ar)
    return tuple(idx)


def write_block(buf: torch.Tensor, block: torch.Tensor, starts: Sequence[Index]) -> torch.Tensor:
    """``dynamic_update_slice``: write ``block`` into ``buf`` at ``starts``.

    ``starts`` index the buffer's natural dims; as in ``jax.lax``, a
    negative start wraps once and each start is clamped so the block fits.
    A batched block or per-stream start turns a shared buffer into a
    per-stream copy. Writes in place where the buffer already has the
    result's shape (the simulator owns its state)."""
    nd = len(starts)
    sizes, bshape = buf.shape[-nd:], block.shape[-nd:]
    per_stream = any(isinstance(s, torch.Tensor) for s in starts)
    B = _batch_of((buf, block), nd)
    if B is None and per_stream:
        B = int(next(s for s in starts if isinstance(s, torch.Tensor)).shape[0])
    if B is not None and buf.dim() == nd:
        buf = buf.unsqueeze(0).expand((B,) + tuple(sizes)).clone()
    if not per_stream:
        sl = tuple(slice(c, c + b) for c, b in
                   ((_start(s, size, b), b) for s, size, b in zip(starts, sizes, bshape)))
        buf[(Ellipsis,) + sl] = block
        return buf
    idx = _block_index(starts, sizes, bshape, B, buf.device)
    buf[idx] = block.expand((B,) + tuple(bshape))
    return buf


def read_block(buf: torch.Tensor, starts: Sequence[Index], shape: Sequence[int]) -> torch.Tensor:
    """``dynamic_slice``: the ``shape`` block of ``buf`` at clamped
    ``starts`` (per stream when a start or the buffer is batched)."""
    nd = len(starts)
    sizes = buf.shape[-nd:]
    if not any(isinstance(s, torch.Tensor) for s in starts):
        sl = tuple(slice(c, c + b) for c, b in
                   ((_start(s, size, b), b) for s, size, b in zip(starts, sizes, shape)))
        return buf[(Ellipsis,) + sl]
    B = int(next(s for s in starts if isinstance(s, torch.Tensor)).shape[0])
    if buf.dim() == nd:
        buf = buf.unsqueeze(0).expand((B,) + tuple(sizes))
    return buf[_block_index(starts, sizes, shape, B, buf.device)]


def branch(r, fns: Sequence[Callable], *args, merge: Optional[Callable] = None):
    """``lax.switch`` on a register: a host register picks one function
    (index clamped into range, as ``lax.switch`` does); a batched one runs
    each selected function on the whole batch and keeps, per row, the
    result of its own branch. Tensor results carry a leading batch axis;
    ``merge([(row mask, result), ...])`` combines any other kind."""
    n = len(fns)
    if not isinstance(r, torch.Tensor):
        return fns[min(max(int(r), 0), n - 1)](*args)
    idx = r.to(torch.int64).clamp(0, n - 1)
    parts = [(idx == k, fns[k](*args)) for k in sorted(set(idx.tolist()))]
    if merge is not None:
        return merge(parts)
    out = parts[0][1]
    for mask, v in parts[1:]:
        out = _where_rows(mask, v, out)
    return out


def _where_rows(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rows of ``a`` where ``mask``, else of ``b`` (leading batch axes)."""
    nd = max(a.dim(), b.dim())
    return torch.where(mask.view((-1,) + (1,) * (nd - 1)), a, b)


@dataclasses.dataclass(frozen=True)
class Command:
    opcode: int
    addr: int = 0
    data: Tuple[float, ...] = ()

    def as_arrays(self, vwidth: int):
        d = np.zeros((vwidth,), np.float32)
        d[: len(self.data)] = self.data
        return np.int32(self.opcode), np.int32(self.addr), d


@dataclasses.dataclass
class PackedStream:
    """A command stream as dense host arrays: ops (L,), addrs (L,),
    data (L, V). The hot-path representation — builders that pack tensors
    vectorize straight into these instead of materializing Command lists."""

    ops: np.ndarray
    addrs: np.ndarray
    data: np.ndarray

    def __len__(self) -> int:
        return int(self.ops.shape[0])

    @property
    def vwidth(self) -> int:
        return int(self.data.shape[1])

    @staticmethod
    def empty(vwidth: int) -> "PackedStream":
        return PackedStream(
            np.zeros((0,), np.int32), np.zeros((0,), np.int32),
            np.zeros((0, vwidth), np.float32),
        )

    @staticmethod
    def from_commands(cmds: Sequence[Command], vwidth: int) -> "PackedStream":
        ops = np.array([c.opcode for c in cmds], np.int32)
        addrs = np.array([c.addr for c in cmds], np.int32)
        data = np.zeros((len(cmds), vwidth), np.float32)
        for i, c in enumerate(cmds):
            data[i, : len(c.data)] = c.data
        return PackedStream(ops, addrs, data)

    @staticmethod
    def single(opcode: int, addr: int, values: Sequence[float], vwidth: int) -> "PackedStream":
        d = np.zeros((1, vwidth), np.float32)
        vals = np.asarray(values, np.float32)
        d[0, : len(vals)] = vals
        return PackedStream(np.array([opcode], np.int32), np.array([addr], np.int32), d)

    @staticmethod
    def concat(streams: Sequence["PackedStream"]) -> "PackedStream":
        streams = [s for s in streams if len(s)]
        if not streams:
            raise ValueError("concat of empty stream list")
        return PackedStream(
            np.concatenate([s.ops for s in streams]),
            np.concatenate([s.addrs for s in streams]),
            np.concatenate([s.data for s in streams], axis=0),
        )

    def to_commands(self) -> List[Command]:
        """Inverse of from_commands (compat path; not for the hot loop)."""
        return [
            Command(int(o), int(a), tuple(float(v) for v in d))
            for o, a, d in zip(self.ops, self.addrs, self.data)
        ]

    def sig(self) -> Tuple:
        """Batching signature: the command skeleton (opcodes + addresses as
        static values), so fully-packed streams group and batch through
        ``simulate_batch`` exactly like compiled data streams."""
        return (
            ("stream",),
            tuple(int(o) for o in self.ops),
            tuple(int(a) for a in self.addrs),
        )

    def padded(self, length: int, nop_opcode: int = NOP_OPCODE) -> "PackedStream":
        """Pad with NOPs to ``length`` (identity updates: semantics-free)."""
        n = len(self)
        if n == length:
            return self
        assert n < length, f"stream length {n} exceeds pad target {length}"
        ops = np.full((length,), nop_opcode, np.int32)
        addrs = np.zeros((length,), np.int32)
        data = np.zeros((length, self.vwidth), np.float32)
        ops[:n], addrs[:n], data[:n] = self.ops, self.addrs, self.data
        return PackedStream(ops, addrs, data)


@dataclasses.dataclass
class BulkWrite:
    """A run of row-write commands at contiguous addresses, targeting one
    state buffer: ``buf[base + i] = rows[i]``. The fragment compiler lowers
    the run to ONE slice update instead of len(rows) commands —
    bit-identical, since contiguous row writes at distinct addresses compose
    to exactly that slice update."""

    buf: str
    base: int
    rows: np.ndarray  # (n, V)
    opcode: int       # the equivalent per-row instruction, for parity streams

    def to_stream(self) -> PackedStream:
        n = self.rows.shape[0]
        return PackedStream(
            np.full((n,), self.opcode, np.int32),
            np.arange(self.base, self.base + n, dtype=np.int32),
            np.asarray(self.rows, np.float32),
        )

    @property
    def sig(self) -> Tuple:
        return (self.buf, self.base, self.rows.shape)


@dataclasses.dataclass
class DataStream:
    """The per-invocation half of a compiled fragment: bulk tensor loads
    plus the irregular tail (config writes + FN_START trigger)."""

    bulk: List[BulkWrite]
    tail: PackedStream

    def __len__(self) -> int:
        return sum(b.rows.shape[0] for b in self.bulk) + len(self.tail)

    def to_stream(self) -> PackedStream:
        """Full command-stream form (eager simulation / parity checks)."""
        return PackedStream.concat([b.to_stream() for b in self.bulk] + [self.tail])

    def sig(self) -> Tuple:
        """Compilation signature: bulk layout + the tail's *command skeleton*
        (opcodes + addresses as static values). Streams sharing a signature
        differ only in payloads and run through one executor."""
        return (
            tuple(b.sig for b in self.bulk),
            tuple(int(o) for o in self.tail.ops),
            tuple(int(a) for a in self.tail.addrs),
        )


@dataclasses.dataclass(frozen=True)
class Instruction:
    """One ILA instruction: name + opcode + state-update semantics.

    ``update(state, addr, data) -> state`` receives a state the simulator
    owns (it may write into it), a host ``addr`` (or a per-stream ``(B,)``
    tensor) and a payload row (a host ``(V,)`` array, or a ``(B, V)``
    tensor when the batch's rows differ).
    """

    name: str
    opcode: int
    update: Callable[[State, Index, Any], State]
    doc: str = ""


def _device_of(st: State) -> torch.device:
    for v in st.values():
        if isinstance(v, torch.Tensor):
            return v.device
    raise ValueError("state holds no tensor")


class ILA:
    """An accelerator (or compiler-IR) ILA model."""

    def __init__(self, name: str, vwidth: int = 16):
        self.name = name
        self.vwidth = vwidth
        self.instructions: List[Instruction] = []
        self._by_opcode: Dict[int, Instruction] = {}
        self._state_init: Dict[str, Callable[[torch.device], Any]] = {}
        self._ndim: Dict[str, int] = {}
        # bookkeeping mirrored from the reference's trace counters: one per
        # data-runner signature first run single / batched
        self.n_traces_single = 0
        self.n_traces_batch = 0
        self._lut: Optional[List[Instruction]] = None
        self.instruction("nop", NOP_OPCODE, "identity update (bucket padding)")(
            lambda st, addr, data: st
        )

    # -- model construction ---------------------------------------------
    def state(self, name: str, init: Callable[[torch.device], Any]):
        """Declare a state element: ``init(device)`` returns its reset
        value (a tensor for a buffer, a float for a register)."""
        self._state_init[name] = init
        v = init(torch.device("meta"))
        self._ndim[name] = v.dim() if isinstance(v, torch.Tensor) else 0

    def instruction(self, name: str, opcode: int, doc: str = ""):
        def deco(fn):
            ins = Instruction(name, opcode, fn, doc)
            self.instructions.append(ins)
            self._by_opcode[opcode] = ins
            self._lut = None
            return fn

        return deco

    def init_state(self, device: DeviceLike = None) -> State:
        dev = resolve(device)
        return {k: f(dev) for k, f in self._state_init.items()}

    # -- state ownership and batching -------------------------------------
    @staticmethod
    def own(st: State) -> State:
        """A private copy of ``st`` that updates may write into."""
        return {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in st.items()}

    def batch_size(self, st: State) -> Optional[int]:
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and v.dim() > self._ndim.get(k, 0):
                return int(v.shape[0])
        return None

    def expand_batch(self, st: State, B: int) -> State:
        """Every entry with a leading batch axis of ``B`` (shared entries
        broadcast as views; host registers become tensors)."""
        dev = _device_of(st)
        out = {}
        for k, v in st.items():
            nd = self._ndim.get(k, 0)
            if isinstance(v, torch.Tensor):
                out[k] = v if v.dim() > nd else v.unsqueeze(0).expand((B,) + tuple(v.shape))
            else:
                out[k] = torch.full((B,), float(v), dtype=torch.float32, device=dev)
        return out

    def lift(self, st: State, name: str) -> torch.Tensor:
        """State buffer ``name`` with a leading batch axis (1 when shared)."""
        v = st[name]
        return v if v.dim() > self._ndim[name] else v.unsqueeze(0)

    def merge_rows(self, parts, B: int) -> State:
        """Per-row merge of whole states: ``parts`` is [(row mask, state)]."""
        out = None
        for mask, st in parts:
            st = self.expand_batch(st, B)
            out = st if out is None else {k: _where_rows(mask, v, out[k]) for k, v in st.items()}
        return out

    # -- simulation --------------------------------------------------------
    def simulate(
        self, commands: Sequence[Command], state: Optional[State] = None,
        device: DeviceLike = None,
    ) -> State:
        """Reference (eager, per-command) simulation — the analogue of the
        ILAng-generated sequential C++ simulator."""
        st = self.own(state) if state is not None else self.init_state(device)
        for i, cmd in enumerate(commands):
            ins = self._by_opcode.get(cmd.opcode)
            if ins is None:
                raise self._decode_error(i, cmd.opcode, len(commands))
            _, addr, data = cmd.as_arrays(self.vwidth)
            st = ins.update(st, int(addr), data)
        return st

    def _decode_error(self, index: int, opcode: int, n: int) -> RuntimeError:
        """Diagnostic for an undecodable command: names the ILA, the
        offending command's position and opcode, and the nearest registered
        opcodes."""
        nearest = sorted(
            self.instructions, key=lambda ins: abs(ins.opcode - opcode)
        )[:4]
        lines = [
            f"  candidate: {ins.name!r} = {ins.opcode:#x} "
            f"(distance {abs(ins.opcode - opcode)})"
            for ins in nearest
        ]
        return RuntimeError(
            f"{self.name}: no instruction decodes opcode {opcode:#x} "
            f"(command {index}/{n}).\n"
            f"  {len(self.instructions)} instructions registered; "
            "nearest opcodes:\n" + "\n".join(lines)
        )

    def _decode_packed(self, op: int) -> Instruction:
        """Opcode -> instruction as the reference's scanned simulator
        decodes it: a dense lookup table over opcodes (unclaimed opcodes
        below the largest run the lowest-opcode instruction, NOP) indexed
        with JAX's clamping (negative indices wrap once)."""
        if self._lut is None:
            instrs = sorted(self.instructions, key=lambda i: i.opcode)
            lut = [instrs[0]] * (instrs[-1].opcode + 1)
            for ins in instrs:
                lut[ins.opcode] = ins
            self._lut = lut
        n = len(self._lut)
        if op < 0:
            op += n
        return self._lut[min(max(op, 0), n - 1)]

    def simulate_jit(
        self, commands: Sequence[Command], state: Optional[State] = None,
        device: DeviceLike = None,
    ) -> State:
        """The reference's scanned-stream simulation: the packed command
        stream folded through the opcode lookup table (PyTorch runs
        eagerly, so no tracing is involved)."""
        return self.simulate_packed(
            PackedStream.from_commands(commands, self.vwidth), state,
            bucket=False, device=device,
        )

    # -- fragment-compiler fast path ------------------------------------
    def simulate_packed(
        self,
        stream: PackedStream,
        state: Optional[State] = None,
        bucket: bool = True,
        device: DeviceLike = None,
    ) -> State:
        """Simulate a packed stream, NOP-padded to a power-of-two bucket
        like the reference (NOPs are identity updates)."""
        st = self.own(state) if state is not None else self.init_state(device)
        if bucket:
            stream = stream.padded(bucket_length(len(stream)))
        for op, addr, data in zip(stream.ops, stream.addrs, stream.data):
            st = self._decode_packed(int(op)).update(st, int(addr), data)
        return st

    def _host_stream_batch(self, streams: Sequence[PackedStream]):
        """Host half of :meth:`simulate_batch`: NOP-pad to the common length
        bucket, bucket the batch dim (replaying the last stream; a multiple
        of the stream mesh size when one is active) and stack to dense
        arrays. Pure numpy — safe in a pack worker thread."""
        assert streams, "simulate_batch needs at least one stream"
        L = bucket_length(max(len(s) for s in streams))
        B = len(streams)
        Bp = mesh_pad(batch_bucket(B))
        padded = [s.padded(L) for s in streams]
        padded += [padded[-1]] * (Bp - B)
        ops = np.stack([s.ops for s in padded])
        addrs = np.stack([s.addrs for s in padded])
        data = np.stack([s.data for s in padded])
        return ops, addrs, data

    def _dispatch_stream_batch(self, host, state: State) -> State:
        """Dispatch half. With a stream mesh, each shard of the batch steps
        on its own mesh device from its copy of ``state`` (the result is
        the :class:`Shards`); the host loop then runs once per shard."""
        if _STREAM_MESH is None:
            return self._step_streams(host, state)
        parts = zip(*(_shard_batched(a) for a in host))
        return Shards(self._step_streams(h, st) for h, st in zip(parts, _replicated(state)))

    def _step_streams(self, host, state: State) -> State:
        """Step through the stacked streams. A step whose opcode, address or
        payload is the same for every stream is applied once with host
        values; one that differs is applied per stream (a per-stream opcode
        runs each decoded instruction on its own copy of the state and
        keeps the rows that issued it)."""
        ops, addrs, data = host
        Bp, L = ops.shape
        st = self.own(state)
        dev = _device_of(st)
        for t in range(L):
            a, d = addrs[:, t], data[:, t]
            addr = int(a[0]) if (a == a[0]).all() else torch.from_numpy(a).to(dev).long()
            row = d[0] if (d == d[0]).all() else payload(d, dev)
            instrs = [self._decode_packed(int(o)) for o in ops[:, t]]
            if all(ins is instrs[0] for ins in instrs):
                st = instrs[0].update(st, addr, row)
                continue
            parts = []
            for ins in {id(i): i for i in instrs}.values():
                mask = torch.tensor([i is ins for i in instrs], device=dev)
                parts.append((mask, ins.update(self.own(st), addr, row)))
            st = self.merge_rows(parts, Bp)
        return self.expand_batch(st, Bp)

    def simulate_batch(
        self,
        streams: Sequence[PackedStream],
        state: Optional[State] = None,
        device: DeviceLike = None,
    ) -> State:
        """Simulate B independent streams (each from the same initial state).
        Streams may have ragged true lengths: all are NOP-padded to the
        common bucket. The batch dimension is bucketed too (padding replays
        the last stream; callers slice [:B]).

        Returns the stacked final state (leading axis = padded batch).
        """
        st = state if state is not None else self.init_state(device)
        return self._dispatch_stream_batch(self._host_stream_batch(streams), st)

    # -- compiled data-stream execution ---------------------------------
    def _data_runner(self, sig: Tuple, shared_mask: Tuple[bool, ...]):
        """Build the executor for one data-stream signature: each bulk write
        lowers to ONE slice update, and the short tail unrolls with static
        opcodes and addresses.

        ``shared_mask[i]`` marks tail payload rows that are identical across
        a batch: those are applied as host rows, so the registers they write
        stay host-known and FN_START's mode dispatch executes exactly one
        branch.
        """
        if not hasattr(self, "_data_runners"):
            self._data_runners: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        key = (sig, shared_mask)
        run = self._data_runners.get(key)
        if run is not None:
            self._data_runners.move_to_end(key)
            return run
        bulk_sig, tail_ops, tail_addrs = sig
        updates = [self._by_opcode[op].update for op in tail_ops]
        shared_pos = [i for i, s in enumerate(shared_mask) if s]
        batched_pos = [i for i, s in enumerate(shared_mask) if not s]
        row_src = {}  # position -> (which argument, index within it)
        for k, i in enumerate(shared_pos):
            row_src[i] = ("shared", k)
        for k, i in enumerate(batched_pos):
            row_src[i] = ("batched", k)
        first = {"single": True, "batch": True}

        def apply(st, rows_list, shared_data, batched_data):
            for (buf, base, _shape), rows in zip(bulk_sig, rows_list):
                st[buf] = write_block(st[buf], rows, (base, 0))
            for i, (update, addr) in enumerate(zip(updates, tail_addrs)):
                which, k = row_src[i]
                row = shared_data[k] if which == "shared" else batched_data[:, k]
                st = update(st, int(addr), row)
            return st

        def run_single(state, rows_list, shared_data, batched_data):
            if first["single"]:
                first["single"] = False
                self.n_traces_single += 1
            return apply(self.own(state), rows_list, shared_data, batched_data)

        def run_batch(state, rows_list, shared_data, batched_data):
            if first["batch"]:
                first["batch"] = False
                self.n_traces_batch += 1
            B = int(batched_data.shape[0])
            st = apply(self.own(state), rows_list, shared_data, batched_data)
            return self.expand_batch(st, B)

        run = (run_single, run_batch)
        self._data_runners[key] = run
        # bound the runner cache: heavily ragged workloads (a distinct
        # operand shape per sample) would otherwise grow it without limit
        while len(self._data_runners) > MAX_DATA_RUNNERS:
            self._data_runners.popitem(last=False)
        return run

    @staticmethod
    def _split_rows(tail_data: np.ndarray, shared_mask: Tuple[bool, ...]):
        shared = [tail_data[i] for i, s in enumerate(shared_mask) if s]
        batched = [tail_data[i] for i, s in enumerate(shared_mask) if not s]
        V = tail_data.shape[1] if tail_data.ndim == 2 else 0
        sh = np.stack(shared) if shared else np.zeros((0, V), np.float32)
        ba = np.stack(batched) if batched else np.zeros((0, V), np.float32)
        return sh, ba

    def run_data(
        self, data: DataStream, state: Optional[State] = None, device: DeviceLike = None,
    ) -> State:
        st = state if state is not None else self.init_state(device)
        dev = _device_of(st)
        mask = (True,) * len(data.tail)  # single stream: everything "shared"
        single, _ = self._data_runner(data.sig(), mask)
        shared, _ = self._split_rows(data.tail.data, mask)
        rows = [payload(b.rows, dev) for b in data.bulk]
        return single(st, rows, shared, None)

    def _host_data_batch(self, datas: Sequence[DataStream]):
        """Host half of :meth:`run_data_batch`: signature check, batch
        bucketing (a multiple of the stream mesh size when one is active),
        shared-payload detection over the whole padded batch and payload
        stacking. Pure numpy — safe in a pack worker thread."""
        assert datas, "run_data_batch needs at least one stream"
        sig = datas[0].sig()
        assert all(d.sig() == sig for d in datas), "mixed signatures in one batch"
        B = len(datas)
        Bp = mesh_pad(batch_bucket(B))
        datas = list(datas) + [datas[-1]] * (Bp - B)
        tail0 = datas[0].tail.data
        shared_mask = tuple(
            bool(all(np.array_equal(d.tail.data[i], tail0[i]) for d in datas[1:]))
            for i in range(tail0.shape[0])
        )
        rows_list = [
            np.stack([d.bulk[i].rows for d in datas])
            for i in range(len(sig[0]))
        ]
        splits = [self._split_rows(d.tail.data, shared_mask) for d in datas]
        shared = splits[0][0]
        batched = np.stack([s[1] for s in splits])
        return sig, shared_mask, rows_list, shared, batched

    def _dispatch_data_batch(self, host, state: State) -> State:
        """Dispatch half: runner lookup + the device work (host-to-device
        copies of the batched payloads, then the unrolled stream). With a
        stream mesh, every shard takes the whole batch's runner (one shared
        mask) and runs on its own mesh device from its copy of ``state``;
        the result is the :class:`Shards`."""
        sig, shared_mask, rows_list, shared, batched = host
        _, batch = self._data_runner(sig, shared_mask)
        if _STREAM_MESH is None:
            dev = _device_of(state)
            return batch(
                state, [payload(r, dev) for r in rows_list], shared, payload(batched, dev),
            )
        rows = [_shard_batched(r) for r in rows_list]
        return Shards(
            batch(st, [payload(r[i], dev) for r in rows], shared, payload(b, dev))
            for i, (dev, st, b) in enumerate(zip(
                _STREAM_MESH.devices, _replicated(state), _shard_batched(batched)))
        )

    def run_data_batch(
        self, datas: Sequence[DataStream], state: Optional[State] = None,
        device: DeviceLike = None,
    ) -> State:
        """Batched compiled execution of streams sharing one signature (same
        bulk layout and tail command skeleton; payloads differ). The batch
        dim is bucketed by replaying the last stream (callers slice [:B])."""
        st = state if state is not None else self.init_state(device)
        return self._dispatch_data_batch(self._host_data_batch(datas), st)

    def jit_cache_info(self) -> Dict[str, int]:
        return {
            "traces_single": self.n_traces_single,
            "traces_batch": self.n_traces_batch,
            "data_runners": len(getattr(self, "_data_runners", {})),
        }


# --------------------------------------------------------------------------
# Fragments & mappings (Section 2.1.3)
# --------------------------------------------------------------------------


def fingerprint(*arrays, extra: Tuple = ()) -> str:
    """Content fingerprint of parameter tensors (+ static attrs) — the
    params half of a fragment-cache key. blake2b over dtype/shape/bytes."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    if extra:
        h.update(repr(extra).encode())
    return h.hexdigest()


@dataclasses.dataclass
class CompiledFragment:
    """A fragment compiled for steady-state reuse.

    ``setup`` is the one-time stream (weight + static-config load) for one
    parameter set; its effect is simulated once per device and memoized —
    architectural state with weights resident, exactly as a real driver
    leaves the device configured between invocations. Per invocation,
    callers pack only the *data* stream (activation load + FN_START) and run
    it from the cached setup state, which is never written. ``meta`` carries
    builder-specific constants (exponent biases, layout dims) the data
    packer and read-out need.
    """

    ila: ILA
    key: Tuple
    setup: PackedStream
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _setup_states: Dict[torch.device, State] = dataclasses.field(
        default_factory=dict, repr=False
    )

    def setup_state(self, device: DeviceLike = None) -> State:
        dev = resolve(device)
        st = self._setup_states.get(dev)
        if st is None:
            st = self.ila.init_state(dev)
            if len(self.setup):
                st = self.ila.simulate_packed(self.setup, state=st)
            self._setup_states[dev] = st
        return st

    def run(self, data: "DataStream | PackedStream", device: DeviceLike = None) -> State:
        """One invocation: data stream from the cached post-setup state."""
        st = self.setup_state(device)
        if isinstance(data, DataStream):
            return self.ila.run_data(data, state=st)
        return self.ila.simulate_packed(data, state=st)

    def run_batch(
        self, streams: Sequence["DataStream | PackedStream"], device: DeviceLike = None,
    ) -> State:
        """Batched invocations sharing this fragment's setup state; returns
        the stacked final state (leading axis covers the padded batch)."""
        return self.run_prepared(self.prepare_batch(streams), device)

    def prepare_batch(self, streams: Sequence["DataStream | PackedStream"]):
        """Host half of :meth:`run_batch` — padding, stacking and shared-
        payload detection in pure numpy. Safe to run in a pack worker
        thread; hand the result to :meth:`run_prepared`."""
        if isinstance(streams[0], DataStream):
            return ("data", self.ila._host_data_batch(streams))
        return ("stream", self.ila._host_stream_batch(streams))

    def run_prepared(self, prepared, device: DeviceLike = None) -> State:
        """Dispatch half of :meth:`run_batch`: resolve the setup state and
        issue the batched simulation for a prepared batch. With a stream
        mesh the setup state is the one memoised on each mesh device (the
        replication), and the result is the :class:`Shards`."""
        kind, host = prepared
        mesh = _STREAM_MESH
        st = (self.setup_state(device) if mesh is None
              else [self.setup_state(d) for d in mesh.devices])
        if kind == "data":
            return self.ila._dispatch_data_batch(host, st)
        return self.ila._dispatch_stream_batch(host, st)

    def full_commands(self, data: "DataStream | PackedStream") -> List[Command]:
        """setup + data as one eager-simulable Command list (parity checks)."""
        stream = data.to_stream() if isinstance(data, DataStream) else data
        if len(self.setup) == 0:
            return stream.to_commands()
        return PackedStream.concat([self.setup, stream]).to_commands()


class FragmentCache:
    """LRU of CompiledFragments keyed by (op, shapes, params fingerprint).

    Thread-safe: the pipelined Executor's pack worker builds fragments while
    the dispatch thread resolves device-local copies, so lookup+insert (and
    the LRU reordering they imply) run under a lock.
    """

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._entries: "OrderedDict[Tuple, CompiledFragment]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple, build: Callable[[], CompiledFragment]) -> CompiledFragment:
        with self._lock:
            frag = self._entries.get(key)
            if frag is not None:
                self.hits += 1
                if TELEMETRY.enabled:
                    TELEMETRY.counter("fragments.hits").inc()
                self._entries.move_to_end(key)
                return frag
            self.misses += 1
            if TELEMETRY.enabled:
                TELEMETRY.counter("fragments.misses").inc()
            frag = build()
            frag.key = key
            self._entries[key] = frag
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
            return frag

    def clear(self):
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key: Tuple) -> bool:
        return key in self._entries

    def info(self) -> Dict[str, int]:
        return {"size": len(self._entries), "hits": self.hits, "misses": self.misses}


# --------------------------------------------------------------------------
# Fused fast-path tier
# --------------------------------------------------------------------------


def fused_pad_streams(datas: Sequence["DataStream"]) -> List["DataStream"]:
    """Pad a fused batch exactly like :meth:`ILA._host_data_batch` pads the
    compiled tier's (bucket per the active batch ladder, times the stream
    mesh size, replaying the last stream), keeping ``[b]`` handle indexing
    aligned."""
    B = len(datas)
    Bp = mesh_pad(batch_bucket(B))
    return list(datas) + [datas[-1]] * (Bp - B)


@dataclasses.dataclass
class FusedRunner:
    """A target-registered fast path for one compiled-fragment family.

    The compiled tier simulates a ``DataStream`` through architectural
    state: bulk slice writes into the state buffers, an unrolled config
    tail, the FN_START update, then a read-out slice. A ``FusedRunner``
    lowers that whole round trip into one fused computation on the stream
    payloads themselves, skipping state materialization entirely.

    Contract: ``dispatch(prepare(datas))`` must return the stacked
    full-region read of the fragment's output — element ``b`` equal (within
    the owning intrinsic's declared tolerance; bit-exact where the numerics
    round-trip exactly) to ``read(frag.run(datas[b]))`` for the planner's
    read function, for every ``b < len(datas)``. Entries past ``len(datas)``
    (bucket padding) are unconstrained.

    ``prepare`` is the host half (pure numpy — safe on the pipelined
    engine's pack worker thread); ``dispatch`` is the device half and
    returns a device tensor without waiting for it. ``read`` optionally pins
    the planner read function the runner fuses; the Executor falls back to
    the compiled tier when a job's read differs.
    """

    name: str
    prepare: Callable[[Sequence["DataStream"]], Any]
    dispatch: Callable[[Any], torch.Tensor]
    read: Optional[Callable] = None
    lowering: str = "plain"

    def run(self, datas: Sequence["DataStream"]) -> torch.Tensor:
        return self.dispatch(self.prepare(datas))

    @staticmethod
    def sharded(runners: Sequence["FusedRunner"]) -> "FusedRunner":
        """One runner over the stream mesh from one runner per mesh device
        (each holds its weights and masks on its own device): the prepared
        batch-leading arrays split into the mesh's shards, each shard goes
        to its device's runner, and the result is the :class:`Shards`."""
        first = runners[0]

        def dispatch(prepared):
            parts = zip(*(_shard_batched(a) for a in prepared))
            return Shards(r.dispatch(p) for r, p in zip(runners, parts))

        return FusedRunner(first.name, first.prepare, dispatch,
                           read=first.read, lowering=first.lowering)


# --------------------------------------------------------------------------
# Target registry (the AcceleratorTarget plugin surface)
# --------------------------------------------------------------------------


class TargetRegistry:
    """Process-wide registry of :class:`~repro_torch.accel.target.AcceleratorTarget`
    plugins. The core compile/codegen layers are written against this
    registry only — they never name a backend.
    """

    def __init__(self):
        self._targets: "OrderedDict[str, Any]" = OrderedDict()
        self._by_op: Dict[str, Tuple[Any, Any]] = {}

    def register(self, target) -> None:
        for op in target.intrinsics:
            claimed = self._by_op.get(op)
            if claimed is not None and claimed[0].name != target.name:
                raise ValueError(
                    f"intrinsic {op!r} of target {target.name!r} is already "
                    f"claimed by target {claimed[0].name!r}; intrinsic op "
                    "names must be unique across targets"
                )
        self._targets[target.name] = target
        for op, intr in target.intrinsics.items():
            self._by_op[op] = (target, intr)

    def unregister(self, name: str):
        """Remove a registered target (inverse of :meth:`register`).
        Returns the removed target (None if ``name`` was not registered)."""
        target = self._targets.pop(name, None)
        if target is None:
            return None
        for op in target.intrinsics:
            claimed = self._by_op.get(op)
            if claimed is not None and claimed[0] is target:
                del self._by_op[op]
        return target

    def replace(self, target):
        """Swap ``target`` in under an existing registration of the same
        name, preserving registry order and requiring the same intrinsic op
        set. Returns the displaced target."""
        old = self._targets.get(target.name)
        if old is None:
            raise KeyError(
                f"replace: no registered target named {target.name!r}"
            )
        if set(old.intrinsics) != set(target.intrinsics):
            raise ValueError(
                f"replace: target {target.name!r} intrinsic set changed "
                f"({sorted(set(old.intrinsics) ^ set(target.intrinsics))})"
            )
        self._targets[target.name] = target  # same key: order preserved
        for op, intr in target.intrinsics.items():
            self._by_op[op] = (target, intr)
        return old

    def names(self) -> List[str]:
        return list(self._targets)

    def get(self, name: str):
        if name not in self._targets:
            raise KeyError(
                f"unknown accelerator target {name!r}; registered: {self.names()}"
            )
        return self._targets[name]

    def all(self, names: Optional[Sequence[str]] = None) -> List[Any]:
        if names is None:
            return list(self._targets.values())
        return [self.get(n) for n in names]

    def intrinsic(self, op: str) -> Tuple[Any, Any]:
        """(target, intrinsic) owning intrinsic op ``op``; KeyError if none."""
        if op not in self._by_op:
            raise KeyError(f"no registered target declares intrinsic {op!r}")
        return self._by_op[op]

    def has_planner(self, op: str) -> bool:
        entry = self._by_op.get(op)
        return entry is not None and entry[1].planner is not None


#: the process-wide target registry; populated by importing ``repro_torch.accel``
TARGETS = TargetRegistry()
