"""Code generation + execution for matched programs.

After flexible matching extracts a program containing accelerator intrinsics,
this module plays the role of the paper's BYOC code generator + runtime: each
accelerator op is lowered to an ILA command stream (the "MMIO writes" of
Figure 5d) and either

* ``mode="ila"``     — executed on the ILA simulator, bit-accurate in the
  accelerator's custom numerics (the application-level co-simulation path,
  Section 2.3.2), or
* ``mode="kernel"``  — executed on the hand-written CUDA kernels with the
  same numeric semantics where the target declares one (deployment path), or
* ``mode="ideal"``   — fp32 reference (the IR interpreter; oracle).

The Executor is **target-agnostic**: every intrinsic dispatches through the
:data:`~repro_torch.core.ila.TARGETS` registry to the planner its
``AcceleratorTarget`` declared (``repro/accel/target.py``). Planners own the
driver-layer tiling (row-chunking, 16x16 tiles, column splits) and return
``SimJob`` lists; this module only schedules and batches them. Adding an
accelerator therefore never touches this file.

Execution engine
----------------

``engine="compiled"`` (default) routes every accelerator invocation through
the fragment-compiler fast path of :mod:`..core.ila`: each op is *planned*
into simulation jobs (CompiledFragment + per-sample DataStream + output
window), jobs sharing a fragment and stream signature are batched through
one batched simulator call, and fragment setup (weight load) is
simulated once per parameter set and cached in the owning target's
fragment cache. Minibatched evaluation flows through :meth:`Executor.run_many`.

``engine="jit"`` re-derives and folds the full packed command stream per
invocation (the pre-fragment-compiler behavior); ``engine="eager"``
interprets commands one by one. Both exist as bit-exact references for the
compiled path.

``engine="pipelined"`` layers an asynchronous dispatch pipeline on top of
the compiled path: host packing (planner calls + batch stacking, vectorized
numpy that releases the GIL) runs in a pack worker thread for chunk *k+1*
while the main thread dispatches the device simulation of chunk *k* (CUDA
runs it asynchronously, so readback of chunk *k-1* overlaps both), and
results materialize only at ``assemble()`` barriers. Pipelining reorders
*scheduling* only — per-sample packing, grouping semantics and simulation
are the compiled engine's, so results stay bit-exact and deterministic
(materialization and stat recording follow submission order). Set
``REPRO_ENGINE=pipelined`` to make it the process default.

``engine="fused"`` keeps the pipelined engine's scheduling (pack worker,
async dispatch, assemble barriers) but, per signature group, consults the
owning target for a :class:`~repro_torch.core.ila.FusedRunner` — a registered
fast path that lowers bulk-write + per-sample compute + read-out into one
fused computation on the stream payloads, skipping architectural-state
materialization (see ``docs/simulation.md``). Groups without a declared
runner execute on the compiled path unchanged, so the engine is safe for
every target; the compiled tier remains the bit-exactness oracle the fused
tier is conformance-checked against. ``REPRO_ENGINE=fused`` flips the
process default.

Multi-device scheduling
-----------------------

The Executor owns a :class:`DeviceRegistry`: ``devices_per_target`` simulated
device instances per registered target, each with its **own fragment cache**
(its own "SRAM" — setup streams re-simulate per device, exactly as a real
driver loads weights into each physical accelerator). Signature-grouped
SimJob batches are assigned to devices by estimated cycles with greedy LPT
(longest processing time first onto the least-loaded device), the classic
2-approximation for makespan. Cycle estimates come from the owning target's
declared :class:`~repro_torch.accel.target.CostModel`. Because ILA simulation is a
pure function of architectural state, device placement never changes
results — all engines stay bit-exact for any device count.

Every Executor runs on one torch ``device`` (``None`` -> CUDA; a host
without CUDA raises). Host glue ops evaluate there with the IR interpreter;
planners pack on the host; simulation and kernels run on the device.

Per-invocation statistics (op, rel-error vs ideal, value ranges, predicted
cost) are collected — the "handy debugging information" the paper's authors
gave the accelerator developers to diagnose the HLSCNN weight-quantization
bug — and aggregated per target by :meth:`Executor.stats_summary`, which
also reports per-device utilization and estimated-cycle columns;
:meth:`Executor.cache_info` surfaces per-target warm-cache health for the
serving path.
"""
from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..accel.target import (  # importing registers bundled targets
    CostEstimate, GroupTiming, PlanContext, SimJob,
)
from ..device import DeviceLike, resolve
from . import ir
from .ila import TARGETS, CompiledFragment, FragmentCache
from .telemetry import TELEMETRY, MetricsRegistry

ENGINES = ("compiled", "pipelined", "fused", "jit", "eager")

#: process-wide pack worker for the pipelined engine. One thread by design:
#: numpy packing releases the GIL and overlaps device compute; several
#: packing threads would contend on the interpreter.
_PACK_POOL: Optional[ThreadPoolExecutor] = None


def _pack_pool() -> ThreadPoolExecutor:
    global _PACK_POOL
    if _PACK_POOL is None:
        _PACK_POOL = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-pack"
        )
    return _PACK_POOL


def to_numpy(v) -> np.ndarray:
    """A result as a host array (device tensors are copied back)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclasses.dataclass
class InvocationStat:
    op: str
    backend: str
    rel_err: float
    out_min: float
    out_max: float
    n_commands: int
    #: CostModel prediction made at plan time (None if the target declares
    #: no model); ``CostModel.calibrate`` fits command scales from these
    est: Optional[CostEstimate] = None


class _GroupResult:
    """One dispatched group's (possibly still in-flight) device result with
    memoized host materialization: the copy to the host waits for the
    device work, and every job of the group shares the single transfer."""

    __slots__ = ("_dev", "_np")

    def __init__(self, dev):
        self._dev = dev
        self._np = None

    def materialize(self) -> np.ndarray:
        if self._np is None:
            self._np = to_numpy(self._dev)
            self._dev = None
        return self._np


class _Deferred:
    """A run_many value whose host materialization is postponed: the
    simulation work behind it is already dispatched (async), but the
    readback barrier / host evaluation runs only at :meth:`force` — the
    mechanism behind :meth:`Executor.submit_many`'s deferred request
    tails. Idempotent: the thunk runs once and the result is cached."""

    __slots__ = ("_thunk", "_v")

    def __init__(self, thunk: Callable[[], List[Any]]):
        self._thunk = thunk
        self._v = None

    def force(self) -> List[Any]:
        if self._thunk is not None:
            self._v = self._thunk()
            self._thunk = None
        return self._v


def _forced(v):
    return v.force() if isinstance(v, _Deferred) else v


class Submission:
    """One in-flight :meth:`Executor.run_many` request.

    Returned by :meth:`Executor.submit_many`: every accelerator invocation
    has been planned and *dispatched* (simulation runs asynchronously on
    the devices), but the terminal readback barrier and any host epilogue
    ops downstream of the last accelerator call are deferred until
    :meth:`result`. A serving scheduler can therefore start packing the
    next request on the pack worker while this request's simulation tail
    is still in flight — instead of draining the pipeline at every
    request's assemble barrier. Results are bit-identical to
    :meth:`Executor.run_many` (deferral reorders *when* host code runs,
    never what it computes)."""

    __slots__ = ("_thunk", "_outs", "_done")

    def __init__(self, thunk: Optional[Callable[[], List[Any]]] = None,
                 outs: Optional[List[Any]] = None):
        self._thunk = thunk
        self._outs = outs
        self._done = thunk is None

    @property
    def done(self) -> bool:
        """True once :meth:`result` has materialized the outputs (or the
        submission was created already-complete, e.g. on a sync engine)."""
        return self._done

    def result(self) -> List[Any]:
        """Materialize and return the per-environment outputs (the readback
        barrier + deferred host epilogue). Idempotent."""
        if not self._done:
            self._outs = self._thunk()
            self._thunk = None
            self._done = True
        return self._outs


class Prepack:
    """Host packings staged ahead of a future submit_many/run_many over the
    same ``(program, envs)`` pair — see :meth:`Executor.prepack_many`."""

    __slots__ = ("program", "envs", "spans")

    def __init__(self, program: ir.Expr, envs: Sequence[Dict[str, Any]]):
        self.program = program
        self.envs = envs
        #: leading accel node -> list of pack-pool futures, one per
        #: pipeline_chunk span, each resolving to (planned, jobs, preps)
        self.spans: Dict[ir.Expr, List[Any]] = {}


class _NullDeviceType:
    """Placement stand-in for fragments of unregistered ILAs (no device
    pool): index 0 means "setup already cached", so no cold-load term."""

    index = 0

    @staticmethod
    def is_cold(frag) -> bool:
        return False


_NullDevice = _NullDeviceType()


class SimDevice:
    """One simulated accelerator instance of a target.

    Device 0 shares the target's process-wide fragment cache (the planners
    already build fragments there), so the single-device default is
    bit-and-cost-identical to the pre-device Executor. Devices >= 1 own a
    private :class:`~repro_torch.core.ila.FragmentCache`: their setup streams
    re-simulate on first use — each device loads its own weights, like
    distinct physical accelerators — and stay warm per device thereafter.
    """

    def __init__(self, target, index: int):
        self.target = target
        self.index = index
        self.name = f"{target.name}[{index}]"
        self.fragments = target.fragments if index == 0 else FragmentCache()
        self.busy_cycles = 0.0
        self.n_jobs = 0
        self.n_groups = 0

    def resolve(self, frag: CompiledFragment) -> CompiledFragment:
        """This device's instance of ``frag`` (device-local setup state)."""
        if self.index == 0:
            return frag
        return self.fragments.get(
            self._key(frag),
            lambda: CompiledFragment(frag.ila, frag.key, frag.setup, dict(frag.meta)),
        )

    @staticmethod
    def _key(frag: CompiledFragment) -> Tuple:
        """Device-local cache key: the fragment key, the ILA's identity and
        the setup stream's identity. Fragment keys hash op/shapes/params
        only, so two ILAs with divergent semantics (the fault campaign's
        golden target vs its mutants, run through one long-lived Executor)
        build same-key fragments; and a host-side fault shares the golden
        ILA but loads a transformed setup stream, which must not be served
        to (or be served from) the golden fragment's device-local copy. The
        cached copy holds ``frag.ila`` and ``frag.setup``, so neither id can
        be recycled while the entry is resident."""
        return (frag.key, id(frag.ila), id(frag.setup))

    def is_cold(self, frag: CompiledFragment) -> bool:
        """True when resolving ``frag`` here would re-simulate its setup
        stream (device-local weight load not yet cached)."""
        return self.index > 0 and self._key(frag) not in self.fragments

    def account(self, n_jobs: int, cycles: float) -> None:
        self.n_groups += 1
        self.n_jobs += n_jobs
        self.busy_cycles += cycles

    def reset_accounting(self) -> None:
        """Zero the scheduling accumulators (cycles/jobs/groups) without
        touching the device's fragment cache — the warm state survives a
        stats reset, exactly like a real device keeps its SRAM contents."""
        self.busy_cycles = 0.0
        self.n_jobs = 0
        self.n_groups = 0

    def summary(self) -> Dict[str, float]:
        return {
            "jobs": self.n_jobs,
            "groups": self.n_groups,
            "est_cycles": self.busy_cycles,
        }


class DeviceRegistry:
    """N simulated device instances per registered target, created lazily
    (targets may register after the Executor is constructed)."""

    def __init__(self, devices_per_target: Union[int, Dict[str, int]] = 1):
        self.devices_per_target = devices_per_target
        self._devices: Dict[str, List[SimDevice]] = {}

    def n_for(self, name: str) -> int:
        if isinstance(self.devices_per_target, dict):
            return max(1, int(self.devices_per_target.get(name, 1)))
        return max(1, int(self.devices_per_target))

    def devices(self, target) -> List[SimDevice]:
        devs = self._devices.get(target.name)
        if devs is None or len(devs) != self.n_for(target.name):
            devs = [SimDevice(target, i) for i in range(self.n_for(target.name))]
            self._devices[target.name] = devs
        return devs

    def owner(self, frag: CompiledFragment):
        """The registered target owning ``frag`` (matched by ILA identity);
        None for fragments of unregistered ILAs (executed unscheduled)."""
        for t in TARGETS.all():
            if t.ila is frag.ila:
                return t
        return None

    def pick(self, target) -> SimDevice:
        """Least-loaded device of ``target`` (the LPT assignment step)."""
        return min(self.devices(target), key=lambda d: (d.busy_cycles, d.index))

    def summary(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """Per-target per-device accounting with utilization relative to the
        target's makespan (most-loaded device = 1.0)."""
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for tname, devs in self._devices.items():
            makespan = max((d.busy_cycles for d in devs), default=0.0)
            out[tname] = {
                d.name: dict(
                    d.summary(),
                    utilization=(d.busy_cycles / makespan) if makespan > 0 else 0.0,
                )
                for d in devs
            }
        return out


class Executor:
    """Executes an extracted IR program, offloading accelerator intrinsics.

    ``target_options`` carries per-target execution options keyed by target
    name (e.g. a weight-datatype selection for a backend with configurable
    numerics); planners read them through their
    :class:`~repro_torch.accel.target.PlanContext`.

    ``devices_per_target`` sizes the :class:`DeviceRegistry`: an int applies
    to every target, a dict keys per-target counts by name. With more than
    one device per target, signature-grouped SimJob batches are scheduled
    greedy-LPT by CostModel cycle estimates (see the module docstring);
    results are bit-identical for any count.

    ``device`` is the torch device everything runs on (``None`` -> CUDA).
    """

    def __init__(
        self,
        mode: str = "ila",
        collect_stats: bool = True,
        jit_sim: bool = True,
        engine: Optional[str] = None,
        target_options: Optional[Dict[str, Dict[str, Any]]] = None,
        devices_per_target: Union[int, Dict[str, int]] = 1,
        pipeline_chunk: int = 8,
        device: DeviceLike = None,
    ):
        assert mode in ("ila", "kernel", "ideal")
        self.device = resolve(device)
        self.mode = mode
        self.collect_stats = collect_stats
        # explicit engine > REPRO_ENGINE env (lets CI/serving flip every
        # Executor in the process) > jit_sim legacy default
        self.engine = (
            engine
            or os.environ.get("REPRO_ENGINE")
            or ("compiled" if jit_sim else "eager")
        )
        assert self.engine in ENGINES, f"unknown engine {self.engine!r}"
        self.target_options = {k: dict(v) for k, v in (target_options or {}).items()}
        self.devices = DeviceRegistry(devices_per_target)
        #: samples planned per pack-pipeline stage in ``run_many`` (the
        #: pipelined engine packs chunk k+1 while chunk k simulates)
        self.pipeline_chunk = max(1, int(pipeline_chunk))
        self.stats: List[InvocationStat] = []
        #: per-group wall-clock records feeding CostModel.calibrate_from_timings
        self.group_timings: List[GroupTiming] = []
        #: this executor's scoped metrics registry — the single source of
        #: truth for stage timers and invocation aggregates; attached to the
        #: process TELEMETRY singleton (weakref) so global snapshots see it
        self.metrics = TELEMETRY.attach(MetricsRegistry(scope="executor"))
        #: per-stage wall-clock counters (pack worker / dispatch / barrier);
        #: the legacy ``stage_seconds`` dict is now a read-only view property
        self._stage = {
            k: self.metrics.counter(f"pipeline.{k}")
            for k in ("pack_s", "dispatch_s", "readback_s")
        }
        self._groups_ctr = self.metrics.counter("pipeline.groups")
        self._inv_metrics: Dict[str, Tuple[Any, Any, Any, Any]] = {}
        #: programs already shape/dtype-checked (once per distinct Expr)
        self._checked: set = set()
        #: per-program deferral analysis for submit_many (Expr -> node set)
        self._defer_sets: Dict[ir.Expr, set] = {}

    @property
    def stage_seconds(self) -> Dict[str, float]:
        """Per-stage accumulated wall clock, read from the metrics registry
        (kept as a dict-shaped view for existing callers/tests)."""
        return {k: c.value for k, c in self._stage.items()}

    def _inv_for(self, tname: str):
        """The per-target invocation aggregate metrics (lazily created)."""
        m = self._inv_metrics.get(tname)
        if m is None:
            m = (
                self.metrics.counter("executor.invocations", target=tname),
                self.metrics.counter("executor.commands", target=tname),
                self.metrics.counter("executor.est_cycles", target=tname),
                self.metrics.gauge("executor.max_rel_err_ratio", target=tname),
            )
            self._inv_metrics[tname] = m
        return m

    # ------------------------------------------------------------------
    def _precheck(self, e: ir.Expr, env: Dict[str, Any]) -> None:
        """Static shape/dtype validation (:func:`ir.check_expr`) before any
        planner runs — an extraction candidate with an inconsistent shape
        fails here with the offending call named, not deep inside a
        planner. Cached per distinct program."""
        if e in self._checked:
            return
        ir.check_expr(e, {k: np.shape(v) for k, v in env.items()})
        self._checked.add(e)

    def run(self, e: ir.Expr, env: Dict[str, Any]):
        self._precheck(e, env)
        memo: Dict[ir.Expr, Any] = {}

        def rec(x: ir.Expr):
            if x in memo:
                return memo[x]
            if isinstance(x, ir.Call) and x.op in ir.ACCEL_OPS:
                args = [to_numpy(rec(a)) for a in x.args]
                v = self._exec_accel(x, args)
            else:
                v = ir._eval(x, rec, env, self.device)
            memo[x] = v
            return v

        return rec(e)

    def run_many(self, e: ir.Expr, envs: Sequence[Dict[str, Any]]):
        """Evaluate the program once per environment, batching accelerator
        invocations *across samples*: all B samples' jobs for one IR node
        run through one batched simulator call (sharing the node's cached
        fragment), while host glue ops evaluate per sample. Per-sample
        numerics (chunking, AF exponent windows) are identical to B calls
        of :meth:`run`."""
        if envs:
            self._precheck(e, envs[0])
        B = len(envs)
        memo: Dict[ir.Expr, List[Any]] = {}

        def rec(x: ir.Expr) -> List[Any]:
            if x in memo:
                return memo[x]
            if isinstance(x, ir.Call) and x.op in ir.ACCEL_OPS:
                args_b = [rec(a) for a in x.args]
                sample_args = [
                    [to_numpy(args_b[k][s]) for k in range(len(args_b))]
                    for s in range(B)
                ]
                if (
                    self.mode == "ila"
                    and self.engine in ("compiled", "pipelined", "fused")
                    and TARGETS.has_planner(x.op)
                ):
                    if self.engine in ("pipelined", "fused"):
                        v = self._node_pipelined(x, sample_args)
                    else:
                        plans, jobs = [], []
                        t0 = time.perf_counter()
                        for s in range(B):
                            s_jobs, assemble = self._plan(x, sample_args[s])
                            plans.append((len(jobs), len(s_jobs), assemble))
                            jobs += s_jobs
                        t1 = time.perf_counter()
                        dt = t1 - t0
                        self._stage["pack_s"].inc(dt)
                        if TELEMETRY.enabled:
                            TELEMETRY.record_span(
                                "pipeline.pack", t0, t1,
                                target=TARGETS.intrinsic(x.op)[0].name,
                                jobs=len(jobs))
                        if self.collect_stats:
                            self._groups_ctr.inc()
                            self.group_timings.append(GroupTiming(
                                TARGETS.intrinsic(x.op)[0].name, len(jobs),
                                PlanContext.data_ncmds(jobs), pack_s=dt,
                            ))
                        outs = self._execute_jobs(jobs)
                        v = [asm(outs[o : o + n]) for (o, n, asm) in plans]
                else:
                    v = [self._exec_accel(x, sample_args[s]) for s in range(B)]
            else:
                v = [
                    ir._eval(x, (lambda a, s=s: rec(a)[s]), envs[s], self.device)
                    for s in range(B)
                ]
            memo[x] = v
            return v

        return rec(e)

    # -- request-level submit/prepack API (continuous-batching serving) --
    def _defer_split(self, e: ir.Expr) -> set:
        """Nodes whose materialization :meth:`submit_many` defers: every
        node that (a) does not feed any accelerator call's operands and
        (b) has an accelerator call somewhere in its subtree. Those are
        exactly the nodes nothing further on the device depends on — the
        request's *tail*: terminal accelerator calls (readback barrier)
        and the host epilogue above them. Nodes feeding an accelerator
        operand are never deferred, so the dispatch order of simulation
        work is unchanged. Cached per distinct program."""
        cached = self._defer_sets.get(e)
        if cached is not None:
            return cached
        nodes = list(ir.postorder(e))
        feeds: set = set()
        for x in nodes:
            if isinstance(x, ir.Call) and x.op in ir.ACCEL_OPS:
                for a in x.args:
                    feeds.update(ir.postorder(a))
        has_accel: Dict[ir.Expr, bool] = {}
        for x in nodes:  # postorder: children resolved first
            has_accel[x] = isinstance(x, ir.Call) and (
                x.op in ir.ACCEL_OPS
                or any(has_accel.get(a, False) for a in x.args)
            )
        deferred = {x for x in nodes if x not in feeds and has_accel[x]}
        self._defer_sets[e] = deferred
        return deferred

    def submit_many(
        self,
        e: ir.Expr,
        envs: Sequence[Dict[str, Any]],
        prepack: Optional[Prepack] = None,
    ) -> Submission:
        """Asynchronous :meth:`run_many`: plan and *dispatch* every
        accelerator invocation, but defer the terminal readback barrier and
        the host epilogue downstream of the last accelerator call to
        ``Submission.result()``. Between ``submit_many(k)`` returning and
        ``result(k)`` being called, the pack worker is free — a serving
        scheduler uses the gap to pre-pack request ``k+1``
        (:meth:`prepack_many`) while request ``k``'s simulation tail
        completes, instead of draining the pipeline per request.

        ``prepack`` hands in host packings staged earlier for the *same*
        program and environment list (anything else is ignored). On
        synchronous engines (or non-ILA modes) this degrades to an
        already-complete submission wrapping :meth:`run_many`: correct
        everywhere, overlapped only where the engine pipelines."""
        if self.mode != "ila" or self.engine not in ("pipelined", "fused") \
                or not envs:
            return Submission(outs=self.run_many(e, envs))
        self._precheck(e, envs[0])
        if prepack is not None and (
            prepack.program is not e or prepack.envs is not envs
        ):
            prepack = None
        deferred = self._defer_split(e)
        B = len(envs)
        memo: Dict[ir.Expr, Any] = {}

        def rec(x: ir.Expr):
            if x in memo:
                return memo[x]
            if isinstance(x, ir.Call) and x.op in ir.ACCEL_OPS:
                # operand subtrees feed an accelerator call, so they are
                # never deferred: args_b holds plain per-sample lists
                args_b = [rec(a) for a in x.args]
                sample_args = [
                    [to_numpy(args_b[k][s]) for k in range(len(args_b))]
                    for s in range(B)
                ]
                if TARGETS.has_planner(x.op):
                    v = self._node_pipelined(
                        x, sample_args, defer=x in deferred,
                        prepacked=(
                            prepack.spans.get(x) if prepack is not None
                            else None
                        ),
                    )
                else:
                    v = [self._exec_accel(x, sample_args[s]) for s in range(B)]
            elif x in deferred:
                # host epilogue above the last accelerator call: record the
                # children now (dispatching any accel work below), evaluate
                # lazily at result() time
                for a in x.args:
                    rec(a)
                v = _Deferred(lambda x=x: [
                    ir._eval(x, (lambda a, s=s: _forced(memo[a])[s]), envs[s], self.device)
                    for s in range(B)
                ])
            else:
                v = [
                    ir._eval(x, (lambda a, s=s: rec(a)[s]), envs[s], self.device)
                    for s in range(B)
                ]
            memo[x] = v
            return v

        root = rec(e)
        if isinstance(root, _Deferred):
            return Submission(thunk=root.force)
        return Submission(outs=root)

    def prepack_many(
        self, e: ir.Expr, envs: Sequence[Dict[str, Any]]
    ) -> Prepack:
        """Stage the *leading* accelerator nodes' host packing (planner
        calls + batch stacking, pure numpy) on the pack worker, ahead of a
        later :meth:`submit_many`/:meth:`run_many` over the exact same
        ``(e, envs)``. Leading nodes are accelerator calls whose operand
        subtrees contain no other accelerator call — their operands are
        computable from the environments alone, so their packing needs
        nothing from the current request. The serving scheduler calls this
        for request ``k+1`` while request ``k``'s simulation tail is in
        flight: the single pack worker fills the readback gap instead of
        idling. Numerics are unchanged (same planners, same span grouping
        as :meth:`_node_pipelined`); on synchronous engines this is a
        no-op."""
        pre = Prepack(e, envs)
        if self.mode != "ila" or self.engine not in ("pipelined", "fused") \
                or not envs:
            return pre
        self._precheck(e, envs[0])
        B = len(envs)
        for x in ir.postorder(e):
            if not (isinstance(x, ir.Call) and x.op in ir.ACCEL_OPS
                    and TARGETS.has_planner(x.op)):
                continue
            if any(
                isinstance(n, ir.Call) and n.op in ir.ACCEL_OPS
                for a in x.args for n in ir.postorder(a)
            ):
                continue  # not leading: operands depend on accel results
            sample_args = []
            for s in range(B):
                ememo: Dict[ir.Expr, Any] = {}

                def ev(a, s=s, ememo=ememo):
                    if a in ememo:
                        return ememo[a]
                    v = ir._eval(a, ev, envs[s], self.device)
                    ememo[a] = v
                    return v

                sample_args.append([to_numpy(ev(a)) for a in x.args])
            spans = [
                range(i, min(i + self.pipeline_chunk, B))
                for i in range(0, B, self.pipeline_chunk)
            ]
            plan_span = self._make_plan_span(x, sample_args)
            pre.spans[x] = [_pack_pool().submit(plan_span, sp) for sp in spans]
        return pre

    # ------------------------------------------------------------------
    def _record(self, op, backend, out, ideal, ncmds, est=None):
        if not self.collect_stats:
            return
        out = np.asarray(out, np.float64)
        ideal = np.asarray(ideal, np.float64)
        denom = np.linalg.norm(ideal)
        err = float(np.linalg.norm(ideal - out) / denom) if denom > 0 else 0.0
        self.stats.append(
            InvocationStat(
                op, backend, err, float(out.min()), float(out.max()), ncmds, est
            )
        )
        inv, cmds, cyc, rel = self._inv_for(ir.accel_op_target(op) or backend)
        inv.inc()
        cmds.inc(ncmds)
        if est is not None:
            cyc.inc(est.cycles)
        rel.set_max(err)

    def _estimate(self, target, x: ir.Call, args) -> Optional[CostEstimate]:
        """CostModel prediction for one invocation (None without a model)."""
        model = target.cost_model
        if model is None or not model.covers(x.op):
            return None
        return model.estimate(x.op, dict(x.attrs), [np.shape(a) for a in args])

    def _ctx(self, target, est: Optional[CostEstimate] = None) -> PlanContext:
        record = self._record if est is None else (
            lambda *a, _est=est, **kw: self._record(*a, est=_est, **kw)
        )
        return PlanContext(
            record=record, options=self.target_options.get(target.name, {}),
            device=self.device,
        )

    def _exec_accel(self, x: ir.Call, args: List[np.ndarray]):
        if self.mode == "ideal":
            return self._ideal(x, args)
        target, intr = TARGETS.intrinsic(x.op)
        if intr.passthrough:
            return args[0]
        if self.mode == "kernel" and intr.kernel is not None:
            return intr.kernel(self._ctx(target, self._estimate(target, x, args)), x, args)
        jobs, assemble = self._plan(x, args)
        return assemble(self._execute_jobs(jobs))

    def _ideal(self, x: ir.Call, args):
        vs = [ir.Var(f"_{i}", np.shape(a)) for i, a in enumerate(args)]
        env = {f"_{i}": a for i, a in enumerate(args)}
        return ir.interpret(ir.Call(x.op, tuple(vs), x.attrs), env, device=self.device)

    def _plan(self, x: ir.Call, args) -> Tuple[List[SimJob], Callable]:
        target, intr = TARGETS.intrinsic(x.op)
        if intr.planner is None:
            raise NotImplementedError(
                f"target {target.name!r} declares no planner for {x.op!r}"
            )
        return intr.planner(self._ctx(target, self._estimate(target, x, args)), x, args)

    # -- job execution ---------------------------------------------------
    def _group_cycles(self, frag, idxs: List[int], jobs, target, device) -> float:
        """Estimated cycles for one signature group on ``device``: data
        commands for every job, plus the setup stream when this device has
        not simulated it yet (cold weight load). Under the pipelined engine
        a latency-calibrated CostModel prices the group ``max(pack, sim)``
        — the stage the group actually occupies the pipeline for — instead
        of their serial sum."""
        n = sum(len(jobs[i].data) for i in idxs)
        if device.is_cold(frag):
            n += len(frag.setup)
        model = target.cost_model if target is not None else None
        if model is None:
            return float(n)
        return model.job_cycles(n, pipelined=self.engine in ("pipelined", "fused"))

    def _fused_for(self, frag, read, target):
        """The fused fast-path runner for one job group, or None when the
        compiled tier should execute it: only under ``engine="fused"``, only
        for fragments whose owning target resolves a
        :class:`~repro_torch.core.ila.FusedRunner` for the signature, and only
        when the runner fuses the group's read function (runners bake the
        read-out into the kernel; a planner using a different read falls
        back to the oracle path)."""
        if self.engine != "fused" or target is None:
            return None
        runner = target.fused_runner(frag, self.device)
        if runner is None or (runner.read is not None and runner.read is not read):
            return None
        return runner

    @staticmethod
    def _group_jobs(jobs: List[SimJob]) -> Dict[Tuple, List[int]]:
        """Batchable-group partition: jobs sharing a fragment and a
        data-stream signature run through one batched simulator call."""
        groups: Dict[Tuple, List[int]] = {}
        for i, j in enumerate(jobs):
            groups.setdefault((id(j.frag), j.data.sig()), []).append(i)
        return groups

    def _dispatch_jobs(
        self,
        jobs: List[SimJob],
        sync: bool = False,
        pack_ahead: bool = False,
        preps: Optional[Dict[Tuple, Any]] = None,
    ) -> List[Callable[[], np.ndarray]]:
        """Group jobs by (fragment, data signature), schedule the groups
        over the owning targets' simulated devices (greedy LPT on CostModel
        estimates) and *dispatch* their simulations, returning one lazy
        materializer per job (CUDA work is asynchronous, so the calls
        return while simulation is still in flight).

        ``sync=True`` (the compiled engine) materializes each group before
        dispatching the next — the pre-pipeline behavior — and records a
        :class:`~repro_torch.accel.target.GroupTiming` with the group's exact
        dispatch-to-materialization wall clock for latency calibration.
        ``pack_ahead=True`` (the pipelined engine) stages each group's host
        packing (stacking, shared-payload detection) in the pack worker so
        it overlaps the previous group's simulation; ``preps`` passes in
        host packings already prepared elsewhere (``_node_pipelined`` packs
        them in the worker alongside planning), keyed like
        :meth:`_group_jobs`.
        """
        handles: List[Optional[Callable[[], np.ndarray]]] = [None] * len(jobs)
        groups = self._group_jobs(jobs)
        # longest-processing-time-first over each target's device pool; a
        # single-device pool preserves the original group order exactly
        order = []
        for key, idxs in groups.items():
            frag = jobs[idxs[0]].frag
            target = self.devices.owner(frag)
            rank = self._group_cycles(frag, idxs, jobs, target, _NullDevice)
            order.append((rank, idxs, target))
        multi = any(
            t is not None and self.devices.n_for(t.name) > 1 for _, _, t in order
        )
        if multi:
            order.sort(key=lambda e: -e[0])
        preps = dict(preps or {})
        if pack_ahead:
            for _rank, idxs, _t in order:
                if len(idxs) > 1:
                    frag = jobs[idxs[0]].frag
                    key = (id(frag), jobs[idxs[0]].data.sig())
                    if key not in preps:
                        runner = self._fused_for(frag, jobs[idxs[0]].read, _t)
                        datas = [jobs[i].data for i in idxs]
                        if runner is not None:
                            preps[key] = _pack_pool().submit(
                                lambda r=runner, ds=datas: ("fused", r.prepare(ds))
                            )
                        else:
                            preps[key] = _pack_pool().submit(
                                frag.prepare_batch, datas
                            )
        t_disp = time.perf_counter()
        for _rank, idxs, target in order:
            frag = jobs[idxs[0]].frag
            read = jobs[idxs[0]].read
            t_grp = time.perf_counter()
            grp_cycles = 0.0
            dev_name = frag.ila.name
            # fused resolution happens on the *shared* fragment, before any
            # device-local clone: runners compute from fragment meta, so a
            # fused group never pays a per-device setup re-simulation
            runner = self._fused_for(frag, read, target)
            n_cmds = sum(len(jobs[i].data) for i in idxs)
            if target is not None:
                device = self.devices.pick(target)
                # book against the chosen device, including its cold-setup
                # cost (the ranking pass above is placement-blind)
                if runner is None and device.is_cold(frag):
                    n_cmds += len(frag.setup)
                grp_cycles = self._group_cycles(
                    frag, idxs, jobs, target,
                    _NullDevice if runner is not None else device,
                )
                device.account(len(idxs), grp_cycles)
                dev_name = device.name
                if runner is None:
                    frag = device.resolve(frag)
            stack_dt = 0.0
            if len(idxs) == 1:
                t0 = time.perf_counter()
                j = jobs[idxs[0]]
                if runner is not None:
                    group = _GroupResult(runner.run([j.data]))
                    handles[idxs[0]] = (
                        lambda g=group, w=j.window: g.materialize()[0][w]
                    )
                else:
                    out = read(frag.run(j.data, self.device))
                    group = _GroupResult(out)
                    handles[idxs[0]] = (
                        lambda g=group, w=j.window: g.materialize()[w]
                    )
            else:
                datas = [jobs[i].data for i in idxs]

                def _prep():
                    if runner is not None:
                        return ("fused", runner.prepare(datas))
                    return frag.prepare_batch(datas)

                prep = preps.get((id(jobs[idxs[0]].frag), jobs[idxs[0]].data.sig()))
                if prep is not None:
                    prepared = prep.result() if hasattr(prep, "result") else prep
                elif sync:
                    # host half timed apart so the GroupTiming pack/sim
                    # split matches what the pipelined engine's pack stage
                    # actually covers (planner packing + group stacking)
                    t0 = time.perf_counter()
                    prepared = _prep()
                    stack_dt = time.perf_counter() - t0
                else:
                    prepared = _prep()
                # a staged prep can disagree with the resolved path when the
                # fused env flags flip between pack and dispatch — re-prep
                if (prepared[0] == "fused") != (runner is not None):
                    prepared = _prep()
                t0 = time.perf_counter()
                if runner is not None:
                    fulls = runner.dispatch(prepared[1])
                else:
                    # reads are batch-polymorphic: one read of the
                    # batched state yields every stream's region
                    fulls = read(frag.run_prepared(prepared, self.device))
                group = _GroupResult(fulls)
                for bi, i in enumerate(idxs):
                    handles[i] = (
                        lambda g=group, b=bi, w=jobs[i].window: g.materialize()[b][w]
                    )
            if sync:
                group.materialize()
                sim_dt = time.perf_counter() - t0
                if self.collect_stats:
                    self._groups_ctr.inc()
                    self.group_timings.append(GroupTiming(
                        target.name if target is not None else frag.ila.name,
                        len(idxs), n_cmds, pack_s=stack_dt,
                        sim_s=sim_dt,
                    ))
                    # drift probe: the scheduler priced this group at
                    # grp_cycles; the simulation actually took sim_dt. On a
                    # latency-calibrated model (1 cycle == 1 us) the ratio
                    # is directly actionable (CostModel.drift_summary)
                    if target is not None and target.cost_model is not None \
                            and grp_cycles > 0:
                        target.cost_model.record_drift(
                            grp_cycles, sim_dt * 1e6)
            if TELEMETRY.enabled:
                TELEMETRY.record_span(
                    "pipeline.dispatch_group", t_grp, time.perf_counter(),
                    device=dev_name, jobs=len(idxs),
                    est_cycles=round(grp_cycles, 1))
        self._stage["dispatch_s"].inc(time.perf_counter() - t_disp)
        return handles

    def _execute_jobs(self, jobs: List[SimJob]) -> List[np.ndarray]:
        """Run simulation jobs to completion. The compiled engine executes
        group-by-group (synchronous); the pipelined engine dispatches every
        group asynchronously — host packing staged through the pack worker
        — and materializes at the end, in job order."""
        if self.engine in ("jit", "eager"):
            results = []
            for j in jobs:
                cmds = j.frag.full_commands(j.data)
                ila = j.frag.ila
                sim = ila.simulate_jit if self.engine == "jit" else ila.simulate
                st = sim(cmds, device=self.device)
                results.append(to_numpy(j.read(st))[j.window])
            return results
        sync = self.engine == "compiled"
        handles = self._dispatch_jobs(jobs, sync=sync, pack_ahead=not sync)
        t0 = time.perf_counter()
        results = [h() for h in handles]
        if not sync:
            t1 = time.perf_counter()
            self._stage["readback_s"].inc(t1 - t0)
            if TELEMETRY.enabled:
                TELEMETRY.record_span("pipeline.readback", t0, t1,
                                      jobs=len(jobs))
        return results

    def _make_plan_span(self, x: ir.Call, sample_args: List[List[np.ndarray]]):
        """Build the pack-stage closure for one accelerator node: plan every
        sample of a span (planner packing, host-only) AND pre-stack its
        batchable groups, so the main thread's dispatch is the device work
        only. Shared by :meth:`_node_pipelined` (packing one
        span ahead within a request) and :meth:`prepack_many` (staging a
        whole later request's leading nodes)."""
        target, _intr = TARGETS.intrinsic(x.op)
        # the pack closure runs on the pack-worker thread, which has no
        # thread-local trace binding — capture the submitting thread's
        # current trace id now so the pack span stays request-correlated
        trace_id = TELEMETRY.current_trace() if TELEMETRY.enabled else None

        def plan_span(span):
            t0 = time.perf_counter()
            planned = [self._plan(x, sample_args[s]) for s in span]
            jobs = [j for js, _ in planned for j in js]
            preps = {}
            for key, idxs in self._group_jobs(jobs).items():
                if len(idxs) <= 1:
                    continue
                frag0 = jobs[idxs[0]].frag
                runner = self._fused_for(
                    frag0, jobs[idxs[0]].read, self.devices.owner(frag0)
                )
                datas = [jobs[i].data for i in idxs]
                preps[key] = (
                    ("fused", runner.prepare(datas))
                    if runner is not None
                    else frag0.prepare_batch(datas)
                )
            t1 = time.perf_counter()
            dt = t1 - t0
            self._stage["pack_s"].inc(dt)
            if TELEMETRY.enabled:
                TELEMETRY.record_span("pipeline.pack", t0, t1, trace_id,
                                      target=target.name, jobs=len(jobs))
            if self.collect_stats:
                self._groups_ctr.inc()
                self.group_timings.append(GroupTiming(
                    target.name, len(jobs), PlanContext.data_ncmds(jobs),
                    pack_s=dt,
                ))
            return planned, jobs, preps

        return plan_span

    def _node_pipelined(
        self,
        x: ir.Call,
        sample_args: List[List[np.ndarray]],
        defer: bool = False,
        prepacked: Optional[List[Any]] = None,
    ):
        """Pipelined execution of one accelerator IR node across the B
        samples of a ``run_many`` minibatch: samples are planned (host
        packing, pure numpy) in :attr:`pipeline_chunk`-sized chunks on the
        pack worker while the main thread dispatches the previous chunk's
        simulations to the device queues; results materialize at the final
        assemble barrier, in submission order (deterministic stats/order).
        Chunking only regroups the batched calls — per-sample numerics
        are grouping-independent, so results match the compiled engine
        bit-for-bit.

        ``defer=True`` (submit_many's terminal nodes) dispatches every span
        but returns a :class:`_Deferred` whose force runs the assemble
        barrier — the caller decides when to pay the readback.
        ``prepacked`` passes span packings already staged on the pack
        worker by :meth:`prepack_many` (one future per span); span
        boundaries depend only on B and :attr:`pipeline_chunk`, and a
        length mismatch falls back to packing here."""
        B = len(sample_args)
        if B == 0:
            return _Deferred(list) if defer else []
        spans = [
            range(i, min(i + self.pipeline_chunk, B))
            for i in range(0, B, self.pipeline_chunk)
        ]
        if prepacked is not None and len(prepacked) != len(spans):
            prepacked = None
        plan_span = self._make_plan_span(x, sample_args)

        def stage(ci):
            if prepacked is not None:
                return prepacked[ci]
            return _pack_pool().submit(plan_span, spans[ci])

        fut = stage(0)
        stages = []
        for ci in range(len(spans)):
            planned, jobs, preps = fut.result()
            if ci + 1 < len(spans):
                fut = stage(ci + 1)
            handles = self._dispatch_jobs(jobs, preps=preps)
            stages.append((planned, handles))

        trace_id = TELEMETRY.current_trace() if TELEMETRY.enabled else None

        def readback():
            t0 = time.perf_counter()
            v = []
            for planned, handles in stages:
                outs = [h() for h in handles]
                o = 0
                for js, asm in planned:
                    v.append(asm(outs[o : o + len(js)]))
                    o += len(js)
            t1 = time.perf_counter()
            self._stage["readback_s"].inc(t1 - t0)
            if TELEMETRY.enabled:
                TELEMETRY.record_span("pipeline.readback", t0, t1, trace_id,
                                      spans=len(stages))
            return v

        return _Deferred(readback) if defer else readback()

    # -- statistics & cache surfacing ------------------------------------
    def reset_stats(self) -> None:
        """Clear every accumulated statistic: invocation stats, per-group
        timing records, per-stage timers AND the per-device scheduling
        accumulators (cycles/jobs/groups) — so ``stats_summary()``
        utilization after a reset reflects only post-reset work (the
        serving path resets between warmup and measured requests). Warm
        state (fragment caches, compiled runners) is untouched."""
        self.stats.clear()
        self.group_timings.clear()
        self.metrics.reset()
        for devs in self.devices._devices.values():
            for d in devs:
                d.reset_accounting()

    def stats_summary(self) -> Dict[str, Dict[str, Any]]:
        """Aggregate invocation stats per target: invocation count, total
        interface commands, worst relative error vs the fp32 oracle, total
        CostModel-estimated cycles, and — once jobs have been scheduled —
        per-device rows (jobs, estimated cycles, utilization relative to
        the target's makespan). A thin view over the executor's metrics
        registry — ``_record`` aggregates into per-target counters as
        invocations happen, so this never re-scans ``self.stats``."""
        out: Dict[str, Dict[str, Any]] = {}
        for tname, (inv, cmds, cyc, rel) in self._inv_metrics.items():
            if inv.value == 0 and cmds.value == 0:
                continue  # reset since last use
            out[tname] = {
                "invocations": int(inv.value),
                "commands": int(cmds.value),
                "max_rel_err": rel.value,
                "est_cycles": cyc.value,
            }
        for tname, devs in self.devices.summary().items():
            out.setdefault(
                tname,
                {"invocations": 0, "commands": 0, "max_rel_err": 0.0,
                 "est_cycles": 0.0},
            )["devices"] = devs
        return out

    def calibrate_cost_models(self) -> Dict[str, Dict[str, float]]:
        """Run every registered target's ``CostModel.calibrate`` against the
        invocation stats collected so far (observed interface command counts
        vs the analytic predictions); returns the fitted per-op command
        scales keyed by target name."""
        out: Dict[str, Dict[str, float]] = {}
        for t in TARGETS.all():
            if t.cost_model is not None:
                out[t.name] = t.cost_model.calibrate(self.stats)
        return out

    def calibrate_from_timings(self) -> Dict[str, Dict[str, float]]:
        """Fit every registered target's wall-clock latency model
        (``CostModel.calibrate_from_timings``) from the per-group timings
        recorded so far. Synchronous (``compiled``) runs record exact
        per-group sim timings, so the serving path calibrates during its
        warmup requests and the pipelined scheduler then prices groups as
        measured ``max(pack, sim)`` microseconds. Returns the fitted models
        keyed by target name (targets without usable timings are omitted)."""
        out: Dict[str, Dict[str, float]] = {}
        for t in TARGETS.all():
            if t.cost_model is not None:
                fit = t.cost_model.calibrate_from_timings(self.group_timings)
                if fit:
                    out[t.name] = fit
        return out

    def pipeline_summary(self) -> Dict[str, float]:
        """Per-stage accumulated wall clock plus an overlap estimate:
        ``overlap_s`` is pack time hidden behind simulation (pack runs in
        the worker while the main thread dispatches/blocks), the pipelined
        engine's whole win. All values reset with :meth:`reset_stats`.
        A thin view over the registry's ``pipeline.*`` counters."""
        stages = self.stage_seconds
        packed = stages["pack_s"]
        busy = stages["dispatch_s"] + stages["readback_s"]
        return dict(
            stages,
            groups=self._groups_ctr.value,
            overlap_s=(
                min(packed, busy)
                if self.engine in ("pipelined", "fused")
                else 0.0
            ),
        )

    def cache_info(self, targets: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
        """Per-target warm-cache health: fragment-cache hits/misses plus data-runner
        trace / compiled-runner counts (serving-path observability)."""
        return {t.name: t.cache_info() for t in TARGETS.all(targets)}
