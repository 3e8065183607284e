"""Multi-pod dry-run: prove the distribution config is coherent, and count it.

Port of ``repro/launch/dryrun.py``. For every (architecture x input shape)
cell on the 16x16 mesh (``--multi-pod``: 2x16x16), it builds the step the
cell runs (``shape_kind_step``: train, prefill or decode bundle) over a
``"fake"`` process group of the mesh's world size and calls
``bundle.fn(*bundle.abstract_args)`` on meta tensors: nothing is allocated
and no collective moves a byte. A :class:`Counter` reads what the step does.
The reference lowers and compiles instead; the keys map as follows.

* ``acct_flops_global``: the step's FLOPs, every DTensor op at its global
  shape (``FlopCounterMode``), with the reference's accounting pass's
  meaning (every trip counted, the whole mesh's work); ``acct_flops`` is
  that over ``n_devices``, as the reference divides its global count
  (``dryrun.py:98-103``). Work a rank does on its own shard outside
  DTensor's dispatch (attention on the local heads, Mamba2's scan per rank)
  counts once per shard (``layers.local_work``). Attention counts as the
  reference's plain attention, dense over all S x Sk pairs
  (``layers.attention_shape``), and its backward as the plain ops that
  differentiate it.
* ``collectives``: ``{"bytes": {kind: ..., "total": ...}, "counts": {kind:
  n}}`` per device, kinds named as the reference's HLO ops. A dispatch mode
  below DTensor's sees each collective a rank issues and the local shape of
  its result (an all-gather's gathered size, as the reference reads the
  result type).
* ``arg_bytes_per_dev``, ``out_bytes_per_dev``: the local shards of the
  arguments (parameters, optimizer state, batch, cache) and of the outputs,
  at rank 0 (the largest shard where a split is uneven).
* ``acct_bytes``: their sum, the bytes the step moves at least (each
  argument read once, each output written once). The reference's counts
  every op's operands, which depends on the compiler's fusion; this is a
  lower bound of it, and the roofline's memory term reads it.
* ``resident_bytes_per_dev``: arguments and outputs, less the outputs
  written over donated arguments; ``fits_h100`` is that within the H100's
  80 GB. Activations and temporaries are not in it, so a cell that does not
  fit surely does not, and one that fits may still not.
* ``hlo_flops``, ``hlo_bytes``, ``temp_bytes_per_dev``,
  ``peak_bytes_per_dev``: null, each with its reason under
  ``null_reasons``: no compiler lowers the step, so there is no compiled
  program to read them from.

Decode cells run at ``pos = seq_len - 1``, the deepest position of the
cache: the decode step takes its position as a Python int, where the
reference traces an abstract one.

A loop of alike trips (Mamba1's scan over positions, the microbatches of a
train step, the MoE token groups: ``layers.scan``) runs until two trips
count the same, and the rest are counted from the last, as the reference
multiplies ``while`` bodies by their trip counts
(``roofline/analysis.py::collective_bytes_from_hlo``). ``trips`` counts
such loops by "trips/trips run".

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out PATH]

``--no-hlo`` skips the collective counter. The default ``--out`` is
``build/dryrun_torch.json``; the cell list is rewritten after every cell.
A cell still counting after ``CELL_TIMEOUT_S`` (600 s) is "failed" with a
``CellTimeout``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import signal
import threading
import time
import traceback
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .. import optim
from ..configs import ARCH_IDS, DASHED, get_config
from ..models import api, layers as mlayers, lm
from ..models.config import SHAPES
from ..optim.optimizers import tree_leaves, tree_map
from . import steps as st
from .mesh import make_mesh

H100_HBM_BYTES = 80e9
#: a cell still counting after this many seconds is "failed" (timeout)
CELL_TIMEOUT_S = 600
DEFAULT_OUT = os.path.join("build", "dryrun_torch.json")
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
NULL_REASONS = {
    "hlo_flops": "no compiled program: the step runs eagerly on DTensors",
    "hlo_bytes": "no compiled program: the step runs eagerly on DTensors",
    "temp_bytes_per_dev": "no compiler plans the temporaries of an eager step",
    "peak_bytes_per_dev": "needs temp_bytes_per_dev",
}

#: collective ops (functional and c10d) by the reference's HLO kind
KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _nbytes(tree) -> int:
    """Bytes of the tensors in ``tree`` (nested lists and tuples)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    return 0


class _Collectives(TorchDispatchMode):
    """Counts collectives and the bytes of their results, per kind, as the
    rank issues them: on a DTensor op it steps aside (as ``CommDebugMode``
    does), so DTensor's dispatch runs and the collectives it issues on local
    tensors come back through this mode."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = collections.Counter()
        self.bytes: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = KINDS.get(func._overloadpacket.__name__)
            if kind is not None:
                self.counts[kind] += 1
                self.bytes[kind] += _nbytes(out)
        return out


class _Mark(torch.autograd.Function):
    """Identity on its tensors; in backward it calls ``hook``. A pair of
    marks brackets a region's backward: the autograd engine runs nodes in
    the reverse order of their creation, so every node made between the two
    marks runs after the outer one (the end mark) and before the inner one
    (the begin mark)."""

    @staticmethod
    def forward(ctx, hook, *tensors):
        ctx.hook = hook
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.hook()
        return (None, *grads)


def _marked(hook, tree):
    """``tree`` (a tensor, or nested lists and tuples, other leaves kept)
    with its tensors that need a gradient passed through one :class:`_Mark`;
    (tree, whether any was)."""
    flat = []

    def collect(t):
        if isinstance(t, torch.Tensor) and t.requires_grad:
            flat.append(t)
        elif isinstance(t, (list, tuple)):
            for x in t:
                collect(x)

    collect(tree)
    if not flat:
        return tree, False
    it = iter(_Mark.apply(hook, *flat))

    def rebuild(t):
        if isinstance(t, torch.Tensor) and t.requires_grad:
            return next(it)
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(x) for x in t)
        return t

    return rebuild(tree), True


class Counter:
    """The dry-run's counter: FLOPs (``FlopCounterMode``) and collectives
    (:class:`_Collectives`) of what runs inside it, and the active counter
    of ``models.layers`` (``layers.counting``), which hands it
    :func:`layers.scan` loops and :func:`layers.local_work` regions.

    ``shortcut``: a scan runs until two trips in a row count the same, and
    counts the rest as that trip; off, every trip runs. Either way a
    region's local work counts once per shard."""

    #: trips a loop runs at least before it is cut: the first may differ
    #: (a carry without a gradient, a first accumulation), then two alike
    MIN_TRIPS = 3

    def __init__(self, shortcut: bool = True, collectives: bool = True):
        self.shortcut = shortcut
        self.flop_mode = FlopCounterMode(display=False)
        self.comm = _Collectives() if collectives else None
        self.extra_flops = 0
        self.trips: Dict[str, int] = collections.Counter()
        self._stack = None

    def __enter__(self):
        stack = contextlib.ExitStack()
        # the collective mode first, the FLOP counter on top of it: the
        # counter sees each DTensor op whole (global shapes) and runs it,
        # then DTensor's local ops, collectives included, reach the mode
        # below, and are not counted as FLOPs twice
        if self.comm is not None:
            stack.enter_context(self.comm)
        stack.enter_context(self.flop_mode)
        stack.enter_context(mlayers.counting(self))
        self._stack = stack.__enter__()
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    # -- totals -------------------------------------------------------------
    def flops(self) -> int:
        return self.flop_mode.get_total_flops() + self.extra_flops

    def collectives(self) -> Dict[str, Any]:
        """The reference's ``{"bytes": {kind, "total"}, "counts": {kind}}``."""
        if self.comm is None:
            return {}
        nbytes = {k: int(v) for k, v in sorted(self.comm.bytes.items())}
        nbytes["total"] = sum(nbytes.values())
        return {"bytes": nbytes, "counts": {k: int(v) for k, v in sorted(self.comm.counts.items())}}

    def snapshot(self):
        if self.comm is None:
            return self.flops(), {}, {}
        return self.flops(), dict(self.comm.counts), dict(self.comm.bytes)

    def _add(self, before, after, times: int, collectives: bool = True) -> None:
        """Count ``times`` more of what ran between two snapshots."""
        self.extra_flops += (after[0] - before[0]) * times
        if collectives and self.comm is not None:
            for total, was, now in ((self.comm.counts, before[1], after[1]),
                                    (self.comm.bytes, before[2], after[2])):
                for k, v in now.items():
                    total[k] += (v - was.get(k, 0)) * times

    def _bracket(self, times, collectives: bool):
        """(begin hook, end hook) for :class:`_Mark`: the end mark's backward
        takes a snapshot, the begin mark's counts ``times[0]`` more of the
        backward between them."""
        box = {}
        end = lambda: box.__setitem__("snap", self.snapshot())
        begin = lambda: self._add(box["snap"], self.snapshot(), times[0], collectives)
        return begin, end

    # -- the hooks layers calls -----------------------------------------------
    def local(self, factor: int, fn, *args):
        """``fn(*args)`` on one rank's shard, its FLOPs (forward and, through
        a bracket, backward) counted ``factor`` times; its collectives are
        this rank's and count once."""
        begin, end = self._bracket([factor - 1], collectives=False)
        args, marked = _marked(begin, args) if torch.is_grad_enabled() else (args, False)
        before = self.snapshot()
        out = fn(*args)
        self._add(before, self.snapshot(), factor - 1, collectives=False)
        if marked:
            out, _ = _marked(end, out)
        return out

    def scan(self, body, carry, xs):
        """``layers.scan`` under the counter: with the shortcut and enough
        trips, trips 0, 1, 2 run; if trips 1 and 2 count the same, the other
        trips count as trip 2 (and, through a bracket around trip 1, their
        backward as trip 1's), their outputs stand in as trip 2's. Otherwise
        every trip runs.

        The skipped trips are counted ahead, as trip 1, before trip 2 runs,
        and taken back if trip 2 differs: a checkpoint's recompute in
        backward (``layers.recompute``) stops at the last tensor its
        forward kept, which may lie in trip 2, and so never returns to count
        them after it; the uncut loop's recompute stops at the same place in
        its last trip, having run the others."""
        n, ys, times = len(xs), [], [0]
        grad = torch.is_grad_enabled()
        prev = ahead = None
        for i, x in enumerate(xs):
            cut = self.shortcut and n > self.MIN_TRIPS
            marked = False
            if cut and grad and i == 1:
                begin, end = self._bracket(times, collectives=True)
                (carry, x), marked = _marked(begin, (carry, x))
            before = self.snapshot()
            carry, y = body(carry, x)
            after = self.snapshot()
            if marked:
                (carry, y), _ = _marked(end, (carry, y))
            ys.append(y)
            delta = _delta(before, after)
            if cut and i == self.MIN_TRIPS - 2:
                ahead = (before, after)
                self._add(*ahead, n - self.MIN_TRIPS)
            if cut and i == self.MIN_TRIPS - 1:
                if delta == prev:
                    times[0] = n - self.MIN_TRIPS
                    self.trips[f"{n}/{self.MIN_TRIPS}"] += 1
                    return carry, ys + [ys[-1]] * times[0]
                self._add(*ahead, self.MIN_TRIPS - n)
            prev = delta
        if n > self.MIN_TRIPS:
            self.trips[f"{n}/{n}"] += 1
        return carry, ys


def _delta(before, after):
    return (after[0] - before[0],
            {k: v - before[1].get(k, 0) for k, v in after[1].items() if v != before[1].get(k, 0)},
            {k: v - before[2].get(k, 0) for k, v in after[2].items() if v != before[2].get(k, 0)})


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def shape_kind_step(cfg, shape, mesh):
    if shape.kind == "train":
        return st.make_train_step(cfg, shape, mesh), "train_step"
    if shape.kind == "prefill":
        return st.make_serve_step(cfg, shape, mesh, "prefill"), "prefill_step"
    return st.make_serve_step(cfg, shape, mesh, "decode"), "serve_step"


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks (this process is
    rank 0; collectives return at once), destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _trees(args):
    """A bundle's arguments with each model as its parameter tree."""
    return tuple(a.tree() if isinstance(a, lm.Model) else a for a in args)


def _local_bytes(tree, placements, mesh) -> int:
    """Bytes of rank 0's shards of ``tree``'s tensors laid out by
    ``placements`` (a tree of placement tuples along ``tree``)."""
    sizes = []

    def leaf(t, pl):
        if isinstance(t, torch.Tensor):
            local, _ = compute_local_shape_and_global_offset(t.shape, mesh, tuple(pl))
            sizes.append(math.prod(local) * t.element_size())

    tree_map(leaf, tree, placements)
    return sum(sizes)


def _out_bytes(tree) -> int:
    """Bytes of this rank's shards of a step's outputs."""
    leaves = tree_leaves(_trees(tree) if isinstance(tree, tuple) else tree)
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel() * t.element_size()
               for t in leaves if isinstance(t, torch.Tensor))


def count_step(bundle, args=None, shortcut: bool = True, collectives: bool = True):
    """Run ``bundle.fn`` on ``args`` (default its meta stand-ins) under a
    :class:`Counter`; (counter, outputs)."""
    args = bundle.abstract_args if args is None else args
    with Counter(shortcut=shortcut, collectives=collectives) as counter:
        out = bundle.fn(*args)
    return counter, out


def one_device_train_cell(cfg, shape, optimizer: str = "adamw") -> Dict[str, Any]:
    """The counts of the one-device train step (``make_train_step(cfg,
    shape)`` without a mesh, as ``launch/train.py`` and the trainer run it)
    on meta tensors: a cell of one device, which the roofline reads."""
    model = st.abstract_params(cfg)
    args = (model, optim.make_optimizer(optimizer).init(model.tree()),
            api.train_input_specs(cfg, shape), 0)
    with Counter() as counter:
        out = st.make_train_step(cfg, shape, optimizer=optimizer)(*args)
    arg_bytes, out_bytes = _out_bytes(args), _out_bytes(out)
    return {"arch": cfg.name, "shape": shape.name, "mesh": "1", "status": "ok",
            "step": "train_step", "n_devices": 1, "acct_flops": counter.flops(),
            "acct_flops_global": counter.flops(), "acct_bytes": arg_bytes + out_bytes,
            "arg_bytes_per_dev": arg_bytes, "out_bytes_per_dev": out_bytes,
            "collectives": counter.collectives()}


class CellTimeout(Exception):
    """A cell ran past its time limit."""


@contextlib.contextmanager
def _time_limit(seconds: float):
    """Raise :class:`CellTimeout` in this (the main) thread after
    ``seconds``; no limit off the main thread or for ``seconds`` <= 0. An
    alarm that lands in a callback which swallows its exception (a garbage
    collector callback only reports it) still fails the block, when it
    ends."""
    if seconds <= 0 or threading.current_thread() is not threading.main_thread():
        yield
        return
    message = f"still counting after {seconds:g} s"
    fired = []

    def expire(signum, frame):
        fired.append(True)
        raise CellTimeout(message)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
    if fired:
        raise CellTimeout(message)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             capture_hlo: bool = True, timeout_s: float = CELL_TIMEOUT_S) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = api.cell_is_supported(cfg, shape)
    mesh_shape, axes = MESHES[multi_pod]
    cell = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mesh_shape)),
        "status": "skipped" if not ok else None, "reason": why or None,
    }
    if not ok:
        return cell
    n_dev = math.prod(mesh_shape)
    t0 = time.time()
    try:
        with _time_limit(timeout_s), fake_group(n_dev):
            mesh = make_mesh(mesh_shape, axes, device="cpu")
            bundle, step_name = shape_kind_step(cfg, shape, mesh)
            args = bundle.abstract_args
            if shape.kind == "decode":
                args = args[:-1] + (shape.seq_len - 1,)    # the deepest cache position
            t_build = time.time() - t0
            counter, out = count_step(bundle, args, collectives=capture_hlo)
            arg_bytes = _local_bytes(_trees(args), bundle.in_placements, mesh)
            donated = _local_bytes(tuple(_trees(args)[i] for i in bundle.donate_argnums),
                                   tuple(bundle.in_placements[i] for i in bundle.donate_argnums),
                                   mesh)
            out_bytes = _out_bytes(out)
        flops = counter.flops()
        resident = arg_bytes + out_bytes - donated
        cell.update({
            "status": "ok",
            "step": step_name,
            "n_devices": n_dev,
            "build_s": round(t_build, 1),
            "count_s": round(time.time() - t0 - t_build, 1),
            "arg_bytes_per_dev": arg_bytes,
            "out_bytes_per_dev": out_bytes,
            "temp_bytes_per_dev": None,
            "peak_bytes_per_dev": None,
            "resident_bytes_per_dev": resident,
            "fits_h100": resident <= H100_HBM_BYTES,
            "hlo_flops": None,
            "hlo_bytes": None,
            "acct_flops": flops / n_dev,
            "acct_bytes": arg_bytes + out_bytes,
            "acct_flops_global": flops,
            "collectives": counter.collectives(),
            "trips": dict(counter.trips),
            "model_params": cfg.n_params(),
            "model_active_params": cfg.n_active_params(),
            "null_reasons": NULL_REASONS,
        })
    except Exception as e:  # a failing cell is a bug in the system
        cell.update({"status": "failed", "error": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()[-2000:]})
    cell["seconds"] = round(time.time() - t0, 1)
    return cell


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-hlo", action="store_true", help="skip collective counting (faster)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [DASHED.get(args.arch, args.arch)]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                print(f"=== {arch} x {shape} x {'2x16x16' if mp else '16x16'} ===", flush=True)
                r = run_cell(arch, shape, multi_pod=mp, capture_hlo=not args.no_hlo)
                print(json.dumps({k: v for k, v in r.items()
                                  if k not in ("traceback", "null_reasons")}), flush=True)
                results.append(r)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_fail = sum(1 for r in results if r["status"] == "failed")
    print(f"DONE: {n_ok} ok, {n_skip} skipped, {n_fail} failed -> {args.out}")
    if n_fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
