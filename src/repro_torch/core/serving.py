"""Continuous-batching co-simulation serving: a request queue and one
dispatch thread in front of a persistent Executor.

Port of ``repro/core/serving.py``. What the port adds, for a card:

* **One device and one stream per device.** The dispatch thread is not the
  thread that built the Executor, and the current CUDA device and stream
  are per thread. The server records the Executor's device and the
  constructing thread's current stream on it, and on every device of the
  stream mesh (``ila.set_stream_mesh``) when one is set, and the dispatch
  thread makes them its own before it serves (``_loop``), so every launch
  lands where the kernels' wrappers look
  (``torch.cuda.current_stream(device)``) and each shard is computed and
  read back on one stream of its own device. Only the dispatch thread
  calls a kernel wrapper while the server runs (the wrappers' launch
  counters are plain integers); the pack worker packs on the host.
* **Outputs are numpy arrays**, as the reference's are: a request's outputs
  are read back to the host once, at the group's barrier, in the dispatch
  thread (one stacked copy where the outputs are tensors of one shape).

The mechanisms, as in the reference:

* **Request queue + scheduler.** :class:`CosimServer` owns a bounded FIFO
  of :class:`RequestHandle`\\ s and a single dispatch thread (one thread by
  design: every Executor/fragment-cache touch happens there, so the engine's
  single-threaded invariants hold no matter how many clients submit).

* **Request overlap.** The scheduler runs requests through
  :meth:`~repro_torch.core.codegen.Executor.submit_many`, which defers each
  request's terminal readback barrier + host epilogue into a
  :class:`~repro_torch.core.codegen.Submission`, and stages the *next* request's
  host packing on the pack worker (:meth:`Executor.prepack_many`) before
  paying the previous request's barrier — so request k+1's packing
  overlaps request k's simulation tail instead of the pipeline draining
  at every request boundary. Up to ``max_inflight`` submissions ride the
  device queues at once; results still complete in submission order.

* **Cross-request coalescing.** Queued requests for the same application
  are merged — up to ``max_batch`` samples — into one ``run_many``-shaped
  dispatch, so B concurrent batch-1 requests share the vmapped simulator
  calls (the per-fragment batching win) instead of issuing B scalar
  dispatches. Outputs are de-interleaved per request. Per-sample numerics
  are batch-composition-independent across all engines, so coalesced
  results are bit-exact vs serving the same requests serially; with
  ``batch_ladder="serving"`` the vmapped batch axis pads on a finer
  (pow2 + 3/4-pow2) ladder so merged sizes waste less replay padding.

* **Admission control.** ``queue_depth`` bounds the queue; optionally
  ``max_backlog_cycles`` bounds the CostModel-estimated cycles of accepted
  but uncompleted work (each app's per-sample cost is priced once from its
  compiled program). Requests beyond either bound are *rejected*
  immediately — the fleet degrades by shedding load, not by queueing
  unboundedly.

Reproducibility: each request's operands derive from
``default_rng((seed, request_id))`` (:func:`request_rng`), never from a
shared stream — results are identical no matter how requests interleave,
queue, or coalesce, which is what makes the bit-exact coalescing tests
(and any replay of a served trace) possible.

``docs/serving.md`` describes the reference's usage and semantics, which
the port keeps.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from . import ila, ir
from .codegen import Executor, to_numpy
from .ila import TARGETS
from .telemetry import TELEMETRY, MetricsRegistry

# request lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
REJECTED = "rejected"
CANCELLED = "cancelled"
FAILED = "failed"

# rejection reasons (RequestHandle.reject_reason)
REJECT_QUEUE_FULL = "queue_full"
REJECT_BACKLOG = "backlog"
REJECT_SHUTDOWN = "shutdown"


#: synthetic per-request lanes in the exported trace (rid mod _REQ_LANES):
#: request-lifecycle spans overlap in time, so they render on their own
#: timelines instead of breaking the dispatch thread's flame nesting
_REQ_LANES = 16

_NULL_CTX = contextlib.nullcontext()


def _group_trace(group: Sequence["RequestHandle"]) -> str:
    """The trace id shared by every span of one coalesced dispatch group —
    ``req-3+4+5`` — so searching any member's ``req-<id>`` in Perfetto
    finds the whole correlated flame."""
    return "req-" + "+".join(str(h.id) for h in group)


def _to_host(outs: Sequence[Any]) -> List[np.ndarray]:
    """Outputs as numpy arrays: tensors of one shape, dtype and device in one
    stacked copy (one readback for the group), anything else one by one."""
    if outs and all(isinstance(o, torch.Tensor) for o in outs) and len(
            {(o.shape, o.dtype, o.device) for o in outs}) == 1:
        return list(torch.stack([o.detach() for o in outs]).cpu().numpy())
    return [to_numpy(o) for o in outs]


def request_rng(seed: int, request_id: int) -> np.random.Generator:
    """The operand stream for one request: seeded by ``(seed, request_id)``
    so a request's inputs are a pure function of its id — independent of
    submission interleaving, queue order, and coalescing decisions."""
    return np.random.default_rng((int(seed), int(request_id)))


@dataclasses.dataclass
class ServedApp:
    """One application the server can execute: its extracted program, the
    parameter environment shared by every request, the input Var's shape,
    and the CostModel-estimated accelerator cycles one sample costs (the
    unit of admission backpressure)."""

    name: str
    program: ir.Expr
    params: Dict[str, Any]
    xshape: Tuple[int, ...]
    est_cycles_per_sample: float


class RequestHandle:
    """A submitted request: its environments, lifecycle status, and — once
    served — one output array per sample. Thread-safe: the submitting
    thread blocks in :meth:`result` until the dispatch thread completes
    (or rejects/cancels) the request."""

    def __init__(self, request_id: int, app: str, envs: List[Dict[str, Any]]):
        self.id = request_id
        self.app = app
        self.envs = envs
        self.status = QUEUED
        self.outputs: Optional[List[np.ndarray]] = None
        self.reject_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.est_cycles = 0.0
        self.t_submit = time.perf_counter()
        self.t_start: Optional[float] = None
        self.t_done: Optional[float] = None
        self.coalesced_with = 0  # other requests sharing the dispatch
        self._event = threading.Event()

    # -- caller side ----------------------------------------------------
    @property
    def rejected(self) -> bool:
        return self.status == REJECTED

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        """Block until served and return one output per sample. Raises on
        rejection/cancellation/failure."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} not done after {timeout}s")
        if self.status == DONE:
            return self.outputs
        if self.status == FAILED and self.error is not None:
            raise self.error
        raise RuntimeError(
            f"request {self.id} {self.status}"
            + (f" ({self.reject_reason})" if self.reject_reason else "")
        )

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    # -- server side ----------------------------------------------------
    def _finish(self, status: str, reason: Optional[str] = None,
                error: Optional[BaseException] = None) -> None:
        self.status = status
        self.reject_reason = reason
        self.error = error
        self._event.set()


class CosimServer:
    """Continuous-batching serving front end over one persistent
    :class:`~repro_torch.core.codegen.Executor` (see module docstring).

    Typical use::

        server = CosimServer(engine="pipelined", queue_depth=32)
        server.add_program("resmlp", program, params)   # or add_app("resmlp")
        server.start(warmup=1)                          # compiled warmup + calibration
        h = server.submit("resmlp", batch=4)
        outs = h.result()
        server.close(drain=True)

    ``coalesce=False`` / ``overlap=False`` select the serial
    one-request-at-a-time and draining-pipeline baselines the serving
    benchmark compares against; both knobs only re-schedule work — served
    results are bit-exact across every setting (deterministic engines).

    ``device`` is the torch device the Executor runs on (``None`` -> CUDA,
    raising without it); a given ``executor`` brings its own.
    """

    def __init__(
        self,
        *,
        engine: Optional[str] = None,
        devices_per_target=1,
        pipeline_chunk: int = 4,
        queue_depth: int = 16,
        max_batch: int = 16,
        coalesce: bool = True,
        overlap: bool = True,
        max_inflight: int = 2,
        max_backlog_cycles: Optional[float] = None,
        seed: int = 0,
        batch_ladder: str = "serving",
        executor: Optional[Executor] = None,
        device: DeviceLike = None,
    ):
        self.executor = executor or Executor(
            "ila", engine=engine, devices_per_target=devices_per_target,
            pipeline_chunk=pipeline_chunk, device=device,
        )
        mesh = ila.stream_mesh()
        devices = dict.fromkeys((self.executor.device, *(mesh.devices if mesh else ())))
        #: the streams the dispatch thread launches on: the constructing
        #: thread's current stream on the Executor's device and on every
        #: stream-mesh device
        self._streams = [torch.cuda.current_stream(d) for d in devices if d.type == "cuda"]
        self.queue_depth = int(queue_depth)
        self.max_batch = max(1, int(max_batch))
        self.coalesce = bool(coalesce)
        self.overlap = bool(overlap)
        self.max_inflight = max(1, int(max_inflight))
        self.max_backlog_cycles = max_backlog_cycles
        self.seed = int(seed)
        self.batch_ladder = batch_ladder
        self._apps: Dict[str, ServedApp] = {}
        self._queue: "deque[RequestHandle]" = deque()
        self._cond = threading.Condition()
        self._id_lock = threading.Lock()
        self._next_id = 0
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._prev_ladder: Optional[str] = None
        self._inflight_cycles = 0.0
        self._latencies: List[float] = []  # exact percentiles for summary()
        # serving statistics live in this server's scoped metrics registry
        # (attached to the process TELEMETRY singleton; summary() is a thin
        # view). Counters/gauges are always on — they replace the previous
        # ad-hoc dict accounting at the same cost; spans are enabled-gated.
        self.metrics = TELEMETRY.attach(MetricsRegistry(scope="serving"))
        self._m_served = self.metrics.counter("serving.served")
        self._m_batches = self.metrics.counter("serving.batches")
        self._m_submitted = self.metrics.counter("serving.submitted")
        self._m_queue = self.metrics.gauge("serving.queue_depth")
        self._m_backlog = self.metrics.gauge("serving.backlog_cycles")
        self._m_inflight = self.metrics.gauge("serving.inflight_batch")
        self._m_inflight_subs = self.metrics.gauge("serving.inflight_submissions")
        self._m_coalesced_max = self.metrics.gauge("serving.coalesced_max")
        self._m_coalesced_max.set(1.0)
        self._m_latency = self.metrics.histogram("serving.latency_ms")
        # predicted-vs-actual request pricing: actual served microseconds
        # over admission-control est_cycles (1.0 == perfectly priced once
        # the CostModel is latency-calibrated)
        self._m_drift = self.metrics.histogram("serving.drift_ratio")
        self._m_rejected: Dict[str, Any] = {}

    # -- application registry -------------------------------------------
    def add_program(self, name: str, program: ir.Expr,
                    params: Dict[str, Any]) -> ServedApp:
        """Register an already-extracted program (input Var must be named
        ``x``; every other free Var bound by ``params``)."""
        xshape = next(
            v.shape for v in ir.postorder(program)
            if isinstance(v, ir.Var) and v.name == "x"
        )
        app = ServedApp(
            name, program, dict(params), tuple(xshape),
            self._estimate_cycles(program, params, xshape),
        )
        self._apps[name] = app
        return app

    def add_app(self, name: str, **compile_kwargs) -> ServedApp:
        """Register a bundled application by name: build it, run flexible
        matching once, keep the extracted program for every request."""
        from . import apps as app_registry
        from .compile import compile_program

        by_name = {k.lower(): v for k, v in app_registry.APPLICATIONS.items()}
        if name.lower() not in by_name:
            raise KeyError(
                f"unknown application {name!r}; "
                f"available: {sorted(app_registry.APPLICATIONS)}"
            )
        builder, _dsl = by_name[name.lower()]
        expr, params = builder()
        res = compile_program(expr, **compile_kwargs)
        return self.add_program(name.lower(), res.program, params)

    def _estimate_cycles(self, program: ir.Expr, params: Dict[str, Any],
                         xshape: Tuple[int, ...]) -> float:
        """Price one sample of the program: CostModel-estimated cycles
        summed over its accelerator calls (0 for ops without a model) —
        the per-sample unit ``max_backlog_cycles`` backpressure is
        denominated in."""
        shape_env = {k: tuple(np.shape(v)) for k, v in params.items()}
        shape_env["x"] = tuple(xshape)
        total = 0.0
        for node in ir.postorder(program):
            if not (isinstance(node, ir.Call) and node.op in ir.ACCEL_OPS):
                continue
            try:
                target, _intr = TARGETS.intrinsic(node.op)
            except KeyError:
                continue
            model = target.cost_model
            if model is None or not model.covers(node.op):
                continue
            arg_shapes = [ir.infer_shape(a, shape_env) for a in node.args]
            est = model.estimate(node.op, dict(node.attrs), arg_shapes)
            if est is not None:
                total += float(est.cycles)
        return total

    # -- client side -----------------------------------------------------
    def request_envs(self, app: str, request_id: int,
                     batch: int = 1) -> List[Dict[str, Any]]:
        """The exact environments request ``request_id`` serves: params +
        per-sample operands from :func:`request_rng`. Public so serial
        baselines and replay harnesses can reconstruct any request's
        inputs bit-for-bit."""
        a = self._apps[app]
        rng = request_rng(self.seed, request_id)
        return [
            dict(a.params, x=rng.standard_normal(a.xshape).astype(np.float32))
            for _ in range(batch)
        ]

    def submit(self, app: str, batch: int = 1,
               envs: Optional[List[Dict[str, Any]]] = None) -> RequestHandle:
        """Submit one request (thread-safe). Operands are drawn from the
        request's own seeded stream unless explicit ``envs`` are passed.
        Returns immediately; a rejected handle has ``status ==
        "rejected"`` and a ``reject_reason``."""
        if app not in self._apps:
            raise KeyError(f"unknown app {app!r}; registered: {sorted(self._apps)}")
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
        if envs is None:
            envs = self.request_envs(app, rid, batch)
        h = RequestHandle(rid, app, envs)
        h.est_cycles = self._apps[app].est_cycles_per_sample * len(envs)
        with self._cond:
            if self._stopping:
                h._finish(REJECTED, REJECT_SHUTDOWN)
            elif len(self._queue) >= self.queue_depth:
                h._finish(REJECTED, REJECT_QUEUE_FULL)
            elif (
                self.max_backlog_cycles is not None
                and self._backlog_cycles() + h.est_cycles > self.max_backlog_cycles
            ):
                h._finish(REJECTED, REJECT_BACKLOG)
            else:
                self._queue.append(h)
                self._cond.notify()
            if h.status == REJECTED:
                ctr = self._m_rejected.get(h.reject_reason)
                if ctr is None:
                    ctr = self._m_rejected[h.reject_reason] = (
                        self.metrics.counter("serving.rejected",
                                             reason=h.reject_reason)
                    )
                ctr.inc()
            self._m_submitted.inc()
            self._m_queue.set(len(self._queue))
            self._m_backlog.set(self._backlog_cycles())
        if TELEMETRY.enabled:
            TELEMETRY.record_span(
                "serving.admission", h.t_submit, time.perf_counter(),
                trace_id=f"req-{rid}", rid=rid, app=app,
                outcome=h.status if h.status == REJECTED else "accepted",
                reason=h.reject_reason, est_cycles=round(h.est_cycles, 1))
        return h

    def _backlog_cycles(self) -> float:
        """Estimated cycles of accepted-but-unfinished work (queued +
        in-flight). Called under ``_cond``."""
        return self._inflight_cycles + sum(h.est_cycles for h in self._queue)

    # -- dispatch thread -------------------------------------------------
    def _overlap_active(self) -> bool:
        return self.overlap and self.executor.engine in ("pipelined", "fused")

    def _next_group(self, wait: bool = True) -> Optional[List[RequestHandle]]:
        """Dequeue the head request plus — under coalescing — every queued
        same-app request that fits in ``max_batch`` samples (FIFO among
        the merged; other apps keep their places). ``wait=False`` returns
        None immediately on an empty queue (the dispatch loop has in-flight
        work to finalize instead); ``wait=True`` blocks until a request
        arrives, returning None only at shutdown with an empty queue."""
        with self._cond:
            while wait and not self._queue and not self._stopping:
                self._cond.wait(timeout=0.05)
            if not self._queue:
                return None
            t0 = time.perf_counter()
            first = self._queue.popleft()
            group = [first]
            if self.coalesce:
                n = len(first.envs)
                taken = []
                for h in self._queue:
                    if h.app == first.app and n + len(h.envs) <= self.max_batch:
                        taken.append(h)
                        n += len(h.envs)
                for h in taken:
                    self._queue.remove(h)
                group += taken
            self._inflight_cycles += sum(h.est_cycles for h in group)
            self._m_queue.set(len(self._queue))
            self._m_backlog.set(self._backlog_cycles())
        if TELEMETRY.enabled:
            TELEMETRY.record_span(
                "serving.coalesce", t0, time.perf_counter(),
                trace_id=_group_trace(group), app=first.app,
                requests=len(group),
                samples=sum(len(h.envs) for h in group))
        return group

    def _loop(self) -> None:
        # this thread's current streams, then its current device: the
        # Executor's (setting a stream also makes its device current)
        for stream in self._streams:
            torch.cuda.set_stream(stream)
        if self.executor.device.type == "cuda":
            torch.cuda.set_device(self.executor.device)
        inflight: "deque[Tuple[Any, List[RequestHandle]]]" = deque()
        while True:
            # only block for arrivals when nothing is in flight: with work
            # pending, an empty queue means finalize now (nothing to overlap)
            group = self._next_group(wait=not inflight)
            if group is None:
                if inflight:
                    self._finalize(*inflight.popleft())
                    continue
                with self._cond:
                    if self._stopping and not self._queue:
                        return
                continue
            t_start = time.perf_counter()
            for h in group:
                h.status = RUNNING
                h.t_start = t_start
                h.coalesced_with = len(group) - 1
            a = self._apps[group[0].app]
            envs = [e for h in group for e in h.envs]
            enabled = TELEMETRY.enabled
            if enabled:
                grp = _group_trace(group)
                for h in group:
                    # queue wait straddles threads (submit thread -> here):
                    # recorded from explicit endpoints, on a synthetic
                    # per-request lane so overlapping waits don't fight for
                    # the dispatch thread's flame nesting
                    TELEMETRY.record_span(
                        "serving.queue_wait", h.t_submit, t_start,
                        trace_id=grp, track=f"req:{h.id % _REQ_LANES}",
                        rid=h.id)
            self._m_inflight.set(len(envs))
            try:
                if self._overlap_active():
                    # stage the new request's leading-node packing *before*
                    # paying any pending readback barrier: the pack worker
                    # fills the barrier gap instead of idling. The group
                    # trace id is bound thread-locally here so the executor
                    # spans this triggers (pipeline.pack on the pack worker,
                    # pipeline.dispatch_group, the deferred readback) stay
                    # correlated with this group's serving spans.
                    with TELEMETRY.trace(grp) if enabled else _NULL_CTX:
                        with TELEMETRY.span("serving.prepack",
                                            samples=len(envs)):
                            pre = self.executor.prepack_many(a.program, envs)
                        while len(inflight) >= self.max_inflight:
                            self._finalize(*inflight.popleft())
                        with TELEMETRY.span("serving.dispatch", app=a.name,
                                            requests=len(group),
                                            samples=len(envs)):
                            sub = self.executor.submit_many(
                                a.program, envs, prepack=pre)
                    inflight.append((sub, group))
                    self._m_inflight_subs.set(len(inflight))
                else:
                    # draining baseline: run to the assemble barrier and
                    # materialize before the next request is even dequeued
                    with TELEMETRY.trace(grp) if enabled else _NULL_CTX:
                        with TELEMETRY.span("serving.dispatch", app=a.name,
                                            requests=len(group),
                                            samples=len(envs)):
                            outs = self.executor.run_many(a.program, envs)
                    self._complete(group, outs)
            except Exception as e:  # a failed request must not kill the server
                for h in group:
                    self._retire(h)
                    h._finish(FAILED, error=e)

    def _finalize(self, sub, group: List[RequestHandle]) -> None:
        try:
            # sub.result() is the deferred assemble barrier: the simulation
            # tail + readback of an overlapped submission is paid here
            with TELEMETRY.span("serving.readback",
                                trace_id=(_group_trace(group)
                                          if TELEMETRY.enabled else None)):
                outs = sub.result()
            self._complete(group, outs)
        except Exception as e:
            for h in group:
                self._retire(h)
                h._finish(FAILED, error=e)

    def _complete(self, group: List[RequestHandle], outs: List[Any]) -> None:
        enabled = TELEMETRY.enabled
        t0 = time.perf_counter()
        outs = _to_host(outs)
        o = 0
        for h in group:
            n = len(h.envs)
            h.outputs = outs[o:o + n]
            o += n
            h.t_done = time.perf_counter()
            self._retire(h)
            h._finish(DONE)
        if enabled:
            grp = _group_trace(group)
            TELEMETRY.record_span(
                "serving.deinterleave", t0, time.perf_counter(),
                trace_id=grp, requests=len(group))
        with self._cond:
            self._m_served.inc(len(group))
            self._m_batches.inc()
            self._m_coalesced_max.set_max(len(group))
            self._latencies += [h.latency_s for h in group]
        for h in group:
            lat = h.latency_s
            self._m_latency.observe(lat * 1e3)
            if h.est_cycles > 0 and h.t_start is not None:
                # request drift: measured service microseconds over the
                # est_cycles admission control priced the request at
                self._m_drift.observe(
                    (h.t_done - h.t_start) * 1e6 / h.est_cycles)
            if enabled:
                TELEMETRY.record_span(
                    "serving.request", h.t_submit, h.t_done, trace_id=grp,
                    track=f"req:{h.id % _REQ_LANES}", rid=h.id, app=h.app,
                    coalesced_with=h.coalesced_with,
                    latency_ms=round(lat * 1e3, 3))

    def _retire(self, h: RequestHandle) -> None:
        with self._cond:
            self._inflight_cycles = max(
                0.0, self._inflight_cycles - h.est_cycles
            )

    # -- lifecycle -------------------------------------------------------
    def start(self, warmup: int = 1, warm_batch: Optional[int] = None) -> "CosimServer":
        """Start the dispatch thread. ``warmup`` > 0 first runs every
        registered app on the synchronous compiled engine (filling
        fragment caches AND recording the exact per-group timings that
        calibrate each target's wall-clock CostModel), then one trace
        request per app on the serving engine, then resets the stats so
        measured serving starts clean. Also switches the vmapped batch
        axis to the serving bucket ladder (restored by :meth:`close`)."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._prev_ladder = ila.set_batch_ladder(self.batch_ladder)
        if warmup > 0:
            ex = self.executor
            engine = ex.engine
            wb = warm_batch or self.max_batch
            rng = np.random.default_rng(self.seed)  # warmup-only stream
            warm_envs = {
                name: [
                    dict(a.params,
                         x=rng.standard_normal(a.xshape).astype(np.float32))
                    for _ in range(wb)
                ]
                for name, a in self._apps.items()
            }
            ex.engine = "compiled"
            for name, a in self._apps.items():
                for _ in range(warmup):
                    ex.run_many(a.program, warm_envs[name])
            ex.calibrate_from_timings()
            ex.engine = engine
            if engine != "compiled":
                # trace the serving engine's own vmap shapes (and fused
                # runners) so measured requests start warm
                for name, a in self._apps.items():
                    ex.submit_many(a.program, warm_envs[name]).result()
            ex.reset_stats()
        self._thread = threading.Thread(
            target=self._loop, name="repro-serve-dispatch", daemon=True
        )
        self._thread.start()
        return self

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop serving. ``drain=True`` (default) serves every accepted
        request before the dispatch thread exits — accepted work is never
        dropped; ``drain=False`` cancels queued requests (in-flight
        submissions still complete). Restores the batch ladder."""
        with self._cond:
            self._stopping = True
            if not drain:
                while self._queue:
                    h = self._queue.popleft()
                    h._finish(CANCELLED)
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self._prev_ladder is not None:
            ila.set_batch_ladder(self._prev_ladder)
            self._prev_ladder = None

    # -- observability ---------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Serving statistics: served/rejected counts, dispatch batches,
        coalescing reach, and latency percentiles (ms) over completed
        requests. A thin view over the server's metrics registry (the
        ``serving.*`` names documented in docs/observability.md)."""
        with self._cond:
            lat = np.asarray(self._latencies, dtype=np.float64)
            served = int(self._m_served.value)
            batches = int(self._m_batches.value)
            out: Dict[str, Any] = {
                "served": served,
                "batches": batches,
                "coalesced_max": int(self._m_coalesced_max.value),
                "mean_batch": (served / batches) if batches else 0.0,
                "rejected": {r: int(c.value)
                             for r, c in self._m_rejected.items()},
                "queued": len(self._queue),
            }
        if lat.size:
            out.update(
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p95_ms=float(np.percentile(lat, 95) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                mean_ms=float(lat.mean() * 1e3),
            )
        return out


def percentiles_ms(latencies_s: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99/mean (milliseconds) of a latency sample — shared by the
    load generator and the serve CLI."""
    lat = np.asarray(list(latencies_s), dtype=np.float64)
    if lat.size == 0:
        return {"p50_ms": float("nan"), "p95_ms": float("nan"),
                "p99_ms": float("nan"), "mean_ms": float("nan")}
    return {
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p95_ms": float(np.percentile(lat, 95) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "mean_ms": float(lat.mean() * 1e3),
    }
