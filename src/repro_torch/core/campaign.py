"""Fault-injection / differential-validation campaign driver.

Enumerates (target x instruction x fault) mutants — :mod:`.faults` — and
runs every mutant through a **tiered detection ladder**, measuring which
validation tier first distinguishes it from the golden design:

  ``static``    tier 0 — the static verifier (:mod:`.ilalint`): golden
                planner-emitted probe streams are pushed through the
                mutant's host-side stream transform and classified against
                the traced instruction effects — **zero simulated
                commands**. Decode violations (opcode/address rewrites)
                and order-sensitive config corruption are caught here;
                bulk numeric payload corruption is deliberately deferred
                to the simulation tiers. Under ``ladder="escalate"`` a
                static detection skips every simulated tier.
  ``vt2``       the declared VT2 fragment-equivalence checks over abstract
                (fp32) semantics, with each target's threaded tolerance.
                This is the formal-proof analogue: it validates the
                *mapping*, deliberately abstracting numerics away — so a
                fault injected into ILA instruction semantics passes it by
                construction. Quantifying exactly that blind spot is the
                point of running the tier.
  ``frag_sim``  the same declared fragment pairs, but with the accelerator
                side **co-simulated on the mutant ILA** against the fp32 IR
                interpreter, judged by the target's declared co-simulation
                tolerance (the loosest ideal-vs-numerics bound among the
                fragment's intrinsics). The VT3 testing analogue: ILA vs
                reference at fragment granularity.
  ``op_diff``   per-intrinsic golden-vs-mutant differential test: identical
                sampled operands through the golden and the mutant target;
                a relative deviation beyond the intrinsic's declared
                tolerance is a detection.
  ``app``       full-application co-simulation: every selected application
                that offloads work to the target is evaluated end-to-end
                (accuracy or perplexity) on golden and mutant; a metric
                delta beyond the campaign thresholds is a detection.
  ``stat``      the calibrated statistical tier, sharing the ``app`` tier's
                evaluation pass: **paired per-example** golden-vs-mutant
                output deltas. The statistic is the mean relative logit
                displacement over the (seeded) evaluation subset; because
                golden and mutant see byte-identical inputs, the identity
                mutant scores *exactly* zero, and the detection threshold
                ``max(stat_floor, 2 x worst identity-null shift)`` is
                calibrated per (target, app) by evaluating the identity
                mutant on ``stat_calib_seeds`` independently seeded subsets
                — a measured false-positive budget. This is what catches
                distribution-shifting faults (``round_floor``'s half-step
                bias) that never flip a top-1 label.

The output is an **escape-analysis matrix**: per mutant, the verdict of
every tier plus the first detecting tier. Mutants that pass the fragment
tiers (``vt2`` + ``frag_sim``) but are caught by an application metric are
the paper's thesis made quantitative — application-level validation
catching what fragment-level checks miss. The ``identity`` control mutant
must show zero detections at every tier (no false positives).

Robustness: a mutant that *raises* during its ladder is recorded with
outcome ``crash`` (partial tiers kept, registries restored) instead of
killing the campaign; under the sharded runner a mutant that *hangs* is
terminated at ``mutant_timeout`` and recorded as ``timeout``. Campaign
state checkpoints to ``CAMPAIGN.json`` after every mutant (atomic
replace), and ``resume=True`` skips already-completed mutants after
verifying the config fingerprint — an interrupted campaign continues
instead of restarting. :func:`matrix_digest` hashes the deterministic
fields of the escape matrix so a resumed run can be proven bit-identical
to an uninterrupted one.

Scale: mutant runs execute on the Executor's ``pipelined`` engine over
``devices_per_target`` simulated devices by default, and all golden-side
host packing comes out of warm shared caches (see :mod:`.faults`), so a
campaign is thousands of co-sim invocations at steady-state cost.
:func:`run_campaign_sharded` additionally fans mutants out across worker
*subprocesses* (each owning its private device fleet and registries), with
bounded retry + backoff for transient failures — throughput is reported as
mutants/sec.

Device: every runner takes ``device`` (``None`` -> CUDA) and records the
resolved device in the campaign config, which is part of the config
fingerprint — a checkpoint written on the CPU is never resumed on the card.
Training, golden and mutant evaluation, and every simulated tier run there.
Sharded workers are *spawned* (a forked CUDA context is unusable), each
resolves the config's device itself and raises when it cannot reach it:
no worker carries on on the CPU. The statistical tier rests on golden and
identity mutant producing the same bits on that device; the identity
null shift is then exactly 0.0.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue as queue_mod
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import apps as apps_mod, cosim, ilalint, ir, validate
from ..device import DeviceLike, resolve
from .codegen import Executor, to_numpy
from .compile import compile_program
from .faults import FaultInstance, fault_instances, make_mutant, swapped_in
from .ila import TARGETS
from .telemetry import TELEMETRY

TIER_ORDER = ("static", "vt2", "frag_sim", "op_diff", "app", "stat")

#: mutant outcomes beyond a clean ladder: the mutant raised mid-ladder
#: (crash isolation) or exceeded the sharded runner's per-mutant timeout
FAILURE_OUTCOMES = ("crash", "timeout")


@dataclasses.dataclass
class TierResult:
    """One tier's verdict on one mutant. ``detected=None`` means the tier
    did not run (not applicable, or skipped by an escalation ladder)."""

    tier: str
    detected: Optional[bool]
    score: float = 0.0        # worst observed deviation / delta
    threshold: float = 0.0
    detail: str = ""

    def cell(self) -> str:
        if self.detected is None:
            return "-"
        return "CAUGHT" if self.detected else "pass"


@dataclasses.dataclass
class MutantReport:
    target: str
    fault: str
    instruction: str
    note: str
    tiers: Dict[str, TierResult]
    seconds: float = 0.0
    outcome: str = "ok"       # "ok" | "crash" | "timeout"
    error: str = ""
    attempts: int = 1

    @property
    def key(self) -> str:
        return f"{self.target}:{self.fault}@{self.instruction}"

    @property
    def detected_at(self) -> Optional[str]:
        if self.outcome in FAILURE_OUTCOMES:
            return self.outcome
        for name in TIER_ORDER:
            t = self.tiers.get(name)
            if t is not None and t.detected:
                return name
        return None

    @property
    def escaped_fragment_checks(self) -> bool:
        """Passed both fragment tiers (vt2 abstract + co-simulated)."""
        return all(
            (self.tiers.get(n) is None or self.tiers[n].detected is not True)
            for n in ("vt2", "frag_sim")
        )

    def _only(self, tier: str, earlier: Tuple[str, ...]) -> bool:
        caught = self.tiers.get(tier)
        return (
            self.outcome == "ok"
            and caught is not None and bool(caught.detected)
            and all(
                (self.tiers.get(n) is None
                 or self.tiers[n].detected is not True)
                for n in earlier
            )
        )

    @property
    def app_only(self) -> bool:
        """The paper's thesis case: every pre-application tier passed (or
        could not run), and an application metric caught the fault."""
        return self._only("app", ("static", "vt2", "frag_sim", "op_diff"))

    @property
    def stat_only(self) -> bool:
        """The calibrated statistical tier's marginal value: every other
        tier — including the coarse app-metric threshold — passed, and only
        the paired per-example statistic caught the fault."""
        return self._only(
            "stat", ("static", "vt2", "frag_sim", "op_diff", "app"))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "target": self.target,
            "fault": self.fault,
            "instruction": self.instruction,
            "note": self.note,
            "seconds": self.seconds,
            "outcome": self.outcome,
            "error": self.error,
            "attempts": self.attempts,
            "detected_at": self.detected_at,
            "escaped_fragment_checks": self.escaped_fragment_checks,
            "app_only": self.app_only,
            "stat_only": self.stat_only,
            "tiers": {
                n: {
                    "detected": t.detected,
                    "score": t.score,
                    "threshold": t.threshold,
                    "detail": t.detail,
                }
                for n, t in self.tiers.items()
            },
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "MutantReport":
        return MutantReport(
            d["target"], d["fault"], d["instruction"], d.get("note", ""),
            {
                n: TierResult(n, tv.get("detected"), tv.get("score", 0.0),
                              tv.get("threshold", 0.0), tv.get("detail", ""))
                for n, tv in d.get("tiers", {}).items()
            },
            seconds=d.get("seconds", 0.0),
            outcome=d.get("outcome", "ok"),
            error=d.get("error", ""),
            attempts=d.get("attempts", 1),
        )


@dataclasses.dataclass
class CampaignResult:
    reports: List[MutantReport]
    golden: Dict[str, Dict[str, Any]]      # app -> {metric, value, offloads}
    config: Dict[str, Any]
    stat_calibration: Dict[str, Any] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    @property
    def mutants_per_sec(self) -> float:
        return len(self.reports) / self.seconds if self.seconds > 0 else 0.0

    def summary(self) -> Dict[str, Any]:
        per_tier = {t: 0 for t in TIER_ORDER}
        for r in self.reports:
            d = r.detected_at
            if d in per_tier:
                per_tier[d] += 1
        return {
            "mutants": len(self.reports),
            "detected": sum(1 for r in self.reports if r.detected_at),
            "undetected": [
                r.key for r in _nonidentity(self.reports)
                if r.outcome == "ok" and not r.detected_at
            ],
            "first_detection_by_tier": per_tier,
            "app_only": [r.key for r in self.reports if r.app_only],
            "stat_only": [r.key for r in self.reports if r.stat_only],
            "crashes": [r.key for r in self.reports if r.outcome == "crash"],
            "timeouts": [r.key for r in self.reports
                         if r.outcome == "timeout"],
            "mutants_per_sec": self.mutants_per_sec,
        }

    def to_json(self) -> Dict[str, Any]:
        return {
            "schema": 2,
            "partial": False,
            "fingerprint": config_fingerprint(self.config),
            "config": self.config,
            "golden": self.golden,
            "stat_calibration": self.stat_calibration,
            "mutants": [r.to_dict() for r in self.reports],
            "summary": self.summary(),
            "seconds": self.seconds,
        }


def _nonidentity(reports):
    return [r for r in reports if r.fault != "identity"]


# ---------------------------------------------------------------------------
# Determinism plumbing: fingerprints, digests, checkpoints
# ---------------------------------------------------------------------------

#: config keys that determine the escape matrix bit-for-bit. Runner knobs
#: (workers, timeouts, retries, checkpoint paths) are deliberately absent:
#: a resumed or re-sharded campaign must produce the identical matrix.
_FINGERPRINT_KEYS = (
    "targets", "faults", "apps", "engine", "devices_per_target", "ladder",
    "n_eval", "train_steps", "op_samples", "op_boundary", "vt2_n",
    "acc_delta", "ppl_ratio", "seed", "stat_floor", "stat_calib_seeds",
    "device",
)


def config_fingerprint(config: Dict[str, Any]) -> str:
    """Hash of the detection-relevant campaign config — the resume guard:
    a checkpoint may only seed a run whose matrix-determining knobs match."""
    det = {k: config.get(k) for k in _FINGERPRINT_KEYS}
    blob = json.dumps(det, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def matrix_digest(data) -> str:
    """Hash of the deterministic content of an escape matrix (verdicts,
    scores, thresholds, golden values — NOT wall-clock or attempt counts).
    A killed-and-resumed campaign must reproduce the uninterrupted run's
    digest bit-for-bit."""
    if isinstance(data, CampaignResult):
        data = data.to_json()
    canon = {
        "fingerprint": data.get("fingerprint"),
        "golden": {
            a: {
                "metric": g.get("metric"),
                "value": repr(float(g.get("value", 0.0))),
                "offloads": g.get("offloads"),
            }
            for a, g in data.get("golden", {}).items()
        },
        "mutants": [
            {
                "key": f"{m['target']}:{m['fault']}@{m['instruction']}",
                "outcome": m.get("outcome", "ok"),
                "detected_at": m.get("detected_at"),
                "tiers": {
                    n: {
                        "detected": tv.get("detected"),
                        "score": repr(float(tv.get("score", 0.0))),
                        "threshold": repr(float(tv.get("threshold", 0.0))),
                        "detail": tv.get("detail", ""),
                    }
                    for n, tv in sorted(m.get("tiers", {}).items())
                },
            }
            for m in sorted(
                data.get("mutants", []),
                key=lambda m: (m["target"], m["fault"], m["instruction"]),
            )
        ],
    }
    blob = json.dumps(canon, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def _save_checkpoint(path: str, config: Dict[str, Any],
                     golden: Dict[str, Any], stat_cal: Dict[str, Any],
                     mutants: List[Dict[str, Any]], seconds: float,
                     partial: bool) -> None:
    data = {
        "schema": 2,
        "partial": partial,
        "fingerprint": config_fingerprint(config),
        "config": config,
        "golden": golden,
        "stat_calibration": stat_cal,
        "mutants": mutants,
        "seconds": seconds,
    }
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)   # atomic: a kill mid-write never corrupts


def _load_checkpoint(path: str, config: Dict[str, Any]):
    """-> (completed: key -> report dict, seconds, golden, stat_cal)."""
    with open(path) as f:
        data = json.load(f)
    want = config_fingerprint(config)
    got = data.get("fingerprint")
    if got != want:
        raise ValueError(
            f"checkpoint {path!r} was produced by a different campaign "
            f"config (fingerprint {got} != {want}); refusing to resume — "
            "delete it or rerun with the original settings"
        )
    completed = {
        f"{m['target']}:{m['fault']}@{m['instruction']}": m
        for m in data.get("mutants", [])
    }
    return (completed, float(data.get("seconds", 0.0)),
            data.get("golden", {}), data.get("stat_calibration", {}))


# ---------------------------------------------------------------------------
# Applications: build + train once, evaluate many mutants per-example
# ---------------------------------------------------------------------------

#: campaign-facing app registry: name -> (builder kwargs shim, metric kind)
_APP_BUILDERS: Dict[str, Tuple[Callable, str]] = {
    "resmlp": (lambda seed=0: apps_mod.build_resmlp(seed=seed, layers=2), "acc"),
    "lstm-wlm": (apps_mod.build_lstm_wlm, "ppl"),
    "efficientnet": (apps_mod.build_efficientnet, "acc"),
    "resnet-20": (apps_mod.build_resnet20, "acc"),
    "mobilenet-v2": (apps_mod.build_mobilenet_v2, "acc"),
    "transformer": (lambda seed=0: apps_mod.build_transformer(seed=seed, layers=1), "acc"),
}


@dataclasses.dataclass
class PerExample:
    """One evaluation pass, resolved per example: flattened raw outputs
    (n, d), per-example losses (n,), and the aggregate app metric."""

    outputs: np.ndarray
    losses: np.ndarray
    metric: float


def paired_stats(golden: PerExample, mutant: PerExample) -> Dict[str, float]:
    """Paired golden-vs-mutant statistics over byte-identical inputs.

    ``shift``: mean relative per-example output displacement
    ``mean ||o_mut - o_gold|| / ||o_gold||`` — the detection statistic. A
    bit-exact mutant scores exactly 0.0; a systematic per-value bias (wrong
    rounding mode) scores at its relative magnitude, far above any
    calibrated identity-null threshold, even when no top-1 label flips.
    ``bias_t``: |t|-statistic of the paired per-example loss deltas
    (reported for diagnosis: it separates *systematic* loss bias from
    symmetric noise). ``mean_loss_delta``: its raw effect size."""
    g = np.asarray(golden.outputs, np.float64)
    m = np.asarray(mutant.outputs, np.float64)
    disp = np.linalg.norm(m - g, axis=1) / (np.linalg.norm(g, axis=1) + 1e-12)
    shift = float(disp.mean())
    d = np.asarray(mutant.losses, np.float64) - np.asarray(
        golden.losses, np.float64)
    if d.size > 1 and float(np.abs(d).max()) > 0.0:
        sem = float(d.std(ddof=1)) / float(np.sqrt(d.size))
        scale = max(float(np.abs(np.asarray(golden.losses)).mean()), 1e-12)
        bias_t = float(abs(d.mean()) / max(sem, 1e-9 * scale))
    else:
        bias_t = 0.0
    return {
        "shift": shift,
        "bias_t": bias_t,
        "mean_loss_delta": float(d.mean()) if d.size else 0.0,
    }


def _subset(pool: int, n: int, tag: str, seed: int) -> Tuple[int, ...]:
    """Seeded evaluation-subset sampler: ``n`` distinct dataset rows out of
    ``pool``, reproducible across processes (crc32, not PYTHONHASHSEED)."""
    rng = np.random.default_rng(zlib.crc32(f"{tag}:{seed}".encode()))
    take = min(n, pool)
    return tuple(int(i) for i in np.sort(
        rng.choice(pool, size=take, replace=False)))


@dataclasses.dataclass
class _App:
    name: str
    kind: str                  # "acc" | "ppl"
    program: ir.Expr
    offloads: Dict[str, int]
    pool: int                  # evaluation dataset size (subset source)
    per_example: Callable[[Executor, Sequence[int]], PerExample]
    golden_metric: float = float("nan")
    #: golden per-example results keyed by evaluation subset (computed once
    #: per campaign, BEFORE any mutant is swapped in)
    golden_pe: Dict[Tuple[int, ...], PerExample] = dataclasses.field(
        default_factory=dict)


def _softmax_logp(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(-1, keepdims=True)
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


def _prepare_app(name: str, n_eval: int, train_steps: int, seed: int,
                 device: DeviceLike = None) -> _App:
    dev = resolve(device)
    builder, kind = _APP_BUILDERS[name]
    expr, params = builder(seed=seed)
    if kind == "ppl":
        pool = max(n_eval, 64)
        Xtok, Ytok, _ = cosim.make_char_task(n=pool, seed=seed)
        embed_dim = next(
            v for v in ir.postorder(expr)
            if isinstance(v, ir.Var) and v.name == "x"
        ).shape[-1]
        vocab = int(Xtok.max()) + 1
        trained = cosim.train_app(
            expr, params, Xtok, Ytok, steps=train_steps, seed=seed,
            embed=(max(vocab, 32), embed_dim), device=dev,
        )
        res = compile_program(expr)
        emb = trained["_embed"]
        model_params = {k: v for k, v in trained.items() if k != "_embed"}

        def per_example(ex: Executor, idx, program=res.program) -> PerExample:
            outs = cosim.eval_outputs(
                program, model_params,
                lambda i: emb[Xtok[i]][:, None, :], idx, ex,
            )
            flat, losses = [], []
            for out, i in zip(outs, idx):
                logp = _softmax_logp(np.asarray(out, np.float64))
                losses.append(
                    float(-logp[np.arange(len(Ytok[i])), Ytok[i]].mean()))
                flat.append(np.asarray(out, np.float64).reshape(-1))
            losses_arr = np.array(losses, np.float64)
            # fixed-length sequences: per-token NLL == mean of per-seq means
            return PerExample(np.stack(flat), losses_arr,
                              float(np.exp(losses_arr.mean())))

    else:
        xshape = next(
            v for v in ir.postorder(expr)
            if isinstance(v, ir.Var) and v.name == "x"
        ).shape
        pool = max(4 * n_eval, 128)
        X, y = cosim.make_teacher_task(builder, xshape, n=pool, seed=seed,
                                       device=dev)
        trained = cosim.train_app(
            expr, params, X, y, steps=train_steps, lr=3e-3, seed=seed,
            device=dev,
        )
        res = compile_program(expr)

        def per_example(ex: Executor, idx, program=res.program) -> PerExample:
            outs = cosim.eval_outputs(
                program, trained, lambda i: X[i], idx, ex)
            logits = np.stack(
                [np.asarray(o, np.float64).reshape(-1) for o in outs])
            labels = y[np.asarray(idx, np.int64)]
            logp = _softmax_logp(logits)
            losses = -logp[np.arange(len(idx)), labels]
            metric = float((logits.argmax(1) == labels).mean())
            return PerExample(logits, losses, metric)

    return _App(name, kind, res.program, dict(res.accelerator_calls), pool,
                per_example)


# ---------------------------------------------------------------------------
# Tier runners
# ---------------------------------------------------------------------------


def _target_options() -> Dict[str, Dict[str, Any]]:
    """Per-target execution options recommended by the declared intrinsics
    (e.g. HLSCNN's updated 16-bit weight datatype)."""
    out: Dict[str, Dict[str, Any]] = {}
    for t in TARGETS.all():
        merged: Dict[str, Any] = {}
        for intr in t.intrinsics.values():
            merged.update(intr.options)
        if merged:
            out[t.name] = merged
    return out


#: per-process (= per sharded worker) executor memo. Building a fresh
#: Executor per tier call per mutant re-created the device fleet and the
#: jit(vmap(read)) caches from cold for every mutant — the sharded-runner
#: regression where each worker re-warmed per *mutant*, not per worker.
#: Sharing one executor per (engine, devices) keeps device-local fragment
#: caches and batched-read jits warm from the golden ``_prepare`` pass
#: onward; mutant isolation holds because targets resolve through the
#: swapped registries at run time and device caches key on ILA identity.
_EXECUTORS: Dict[Tuple[str, int, str], Executor] = {}


def _executor(engine: str, devices: int, device: DeviceLike) -> Executor:
    dev = resolve(device)
    key = (engine, devices, str(dev))
    ex = _EXECUTORS.get(key)
    if ex is None:
        ex = _EXECUTORS[key] = Executor(
            "ila", engine=engine, devices_per_target=devices,
            target_options=_target_options(), collect_stats=False,
            device=dev,
        )
    else:
        # zero the LPT scheduling accumulators so every tier call sees the
        # same deterministic device placement a fresh Executor would.
        # Placement is observable for setup-stream faults (devices >= 1
        # re-simulate the mutant's setup; device 0 reuses the planner-built
        # state), so letting busy-cycle history from *other* mutants leak
        # into placement would make a mutant's outcome depend on execution
        # order — breaking the sharded runner's matrix-digest parity with
        # serial runs. Warm caches survive the reset.
        ex.reset_stats()
    return ex


def _fragment_ops(e: ir.Expr) -> List[str]:
    return [
        x.op for x in ir.postorder(e)
        if isinstance(x, ir.Call) and x.op in ir.ACCEL_OPS
    ]


def _tier_static(target, probes, inst: FaultInstance) -> TierResult:
    """Tier 0 — the static verifier (:mod:`.ilalint`): golden probe
    streams through the mutant's host-side stream transform, classified
    with **zero simulated commands**. Faults with no host-visible
    transform (pure ILA-update wrappers) are out of static scope and pass;
    a transform that *raises* while being applied (e.g. the crash-inject
    diagnostic fault) leaves the tier inconclusive so the simulation
    ladder still exercises it."""
    hx = inst.host_xform()
    if hx is None:
        return TierResult(
            "static", False,
            detail="no host-visible stream transform (ILA-update fault); "
                   "out of static scope")
    try:
        detected, score, detail = ilalint.analyze_mutation(
            target, probes, hx)
    except KeyboardInterrupt:
        raise
    except Exception as e:
        return TierResult(
            "static", None,
            detail=f"static analysis inconclusive: transform raised "
                   f"{type(e).__name__}: {e}")
    return TierResult("static", detected, score=score, detail=detail)


def _tier_vt2(target, cases, n: int, seed: int, device: DeviceLike) -> TierResult:
    worst_name = ""
    for case in cases:
        if not validate.vt2_check(case, n=n, seed=seed, device=device):
            worst_name = case.name
            break
    if not cases:
        return TierResult("vt2", None, detail="target declares no VT2 cases")
    return TierResult(
        "vt2", bool(worst_name), threshold=target.vt2_tol,
        detail=(f"failed case {worst_name!r}" if worst_name
                else f"{len(cases)} cases pass (abstract semantics)"),
    )


def _tier_frag_sim(target, cases, engine: str, devices: int, seed: int,
                   device: DeviceLike, n_envs: int = 2) -> TierResult:
    if not cases:
        return TierResult("frag_sim", None, detail="no declared fragments")
    worst, worst_name, thr_used = 0.0, "", 0.0
    ex = _executor(engine, devices, device)   # shared: caches warm across cases
    for case in cases:
        thr = target.cosim_tol(_fragment_ops(case.accel_fragment))
        rng = np.random.default_rng(seed)
        for _ in range(n_envs):
            env = {
                k: rng.standard_normal(s).astype(np.float32)
                for k, s in case.var_shapes.items()
            }
            ideal = to_numpy(ir.interpret(case.ir_fragment, env, device=ex.device))
            got = to_numpy(ex.run(case.accel_fragment, env))
            err = validate.frob_rel_err(ideal, got)
            if err / max(thr, 1e-12) > worst / max(thr_used, 1e-12):
                worst, worst_name, thr_used = err, case.name, thr
    return TierResult(
        "frag_sim", worst > thr_used, score=worst, threshold=thr_used,
        detail=f"worst fragment {worst_name!r} rel err {worst:.4f} "
               f"(tol {thr_used:g})",
    )


def _golden_op_outputs(target, n_samples: int, seed: int,
                       engine: str, devices: int, device: DeviceLike,
                       boundary: int = 0) -> Dict[str, List]:
    """Reference outputs of every sampled intrinsic on the *golden* target,
    cached per campaign so every mutant diffs against the same baselines.

    ``boundary`` > 0 appends that many *range-directed* samples per op:
    the intrinsic's own operand draw, with its activation operand
    (``args[0]``) overwritten by :func:`ilalint.boundary_inputs` values
    straddling the target's statically computed saturation point. Uniform
    draws almost never land within the wrap window, which is exactly how
    ``sat_wrap``-class faults escape the op tier; aimed draws make the
    same one-op diff catch them. The default (0) keeps the historical
    uniform-only pool — and the escape matrix — unchanged."""
    out: Dict[str, List] = {}
    ex = _executor(engine, devices, device)
    for op, intr in target.intrinsics.items():
        if intr.planner is None or intr.sample is None:
            continue
        runs = []
        # stable across processes (str hash() is PYTHONHASHSEED-randomized)
        rng = np.random.default_rng(
            zlib.crc32(f"{target.name}:{op}:{seed}".encode())
        )
        for k in range(n_samples + boundary):
            args, attrs = intr.sample(rng)
            if k >= n_samples:
                x0 = np.asarray(args[0])
                bv = ilalint.boundary_inputs(
                    target, n=x0.size, seed=seed * 8191 + k
                )
                args = [bv.reshape(x0.shape)] + list(args[1:])
            vs = tuple(ir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
            expr = ir.call(op, *vs, **attrs)
            env = {f"_{i}": a for i, a in enumerate(args)}
            runs.append((expr, env, to_numpy(ex.run(expr, env))))
        out[op] = runs
    return out


def _tier_op_diff(target, golden_runs: Dict[str, List],
                  engine: str, devices: int, device: DeviceLike) -> TierResult:
    worst, worst_op, thr_used = 0.0, "", 0.0
    detected = False
    ex = _executor(engine, devices, device)   # shared: caches warm across ops
    for op, runs in golden_runs.items():
        tol = target.intrinsics[op].tol
        for expr, env, golden_out in runs:
            got = to_numpy(ex.run(expr, env))
            err = validate.frob_rel_err(golden_out, got)
            if err / max(tol, 1e-12) > worst / max(thr_used, 1e-12):
                worst, worst_op, thr_used = err, op, tol
            detected = detected or err > tol
    if not golden_runs:
        return TierResult("op_diff", None, detail="no sampled intrinsics")
    return TierResult(
        "op_diff", detected, score=worst, threshold=thr_used,
        detail=f"worst op {worst_op!r} golden-vs-mutant rel diff "
               f"{worst:.4f} (tol {thr_used:g})",
    )


def _tier_app_and_stat(ctx: "_Ctx", t) -> Tuple[TierResult, TierResult]:
    """The application tier and the statistical tier share ONE mutant
    evaluation pass per app: per-example outputs feed both the aggregate
    metric delta (``app``) and the paired displacement statistic against
    the calibrated identity-null threshold (``stat``)."""
    cfg = ctx.config
    relevant = [a for a in ctx.campaign_apps
                if a.offloads.get(t.name, 0) > 0]
    if not relevant:
        na = "no selected application offloads to target"
        return (TierResult("app", None, detail=na),
                TierResult("stat", None, detail=na))
    acc_delta, ppl_ratio = cfg["acc_delta"], cfg["ppl_ratio"]
    calibrated = cfg["stat_calib_seeds"] > 0
    app_det, app_details, app_worst, app_thr = False, [], 0.0, acc_delta
    st_det, st_details, st_worst, st_thr = False, [], 0.0, cfg["stat_floor"]
    for app in relevant:
        idx = ctx.eval_idx[app.name]
        pe = app.per_example(
            _executor(cfg["engine"], cfg["devices_per_target"], cfg["device"]),
            idx)
        gpe = app.golden_pe[idx]
        # -- aggregate metric -----------------------------------------------
        if app.kind == "acc":
            delta = abs(gpe.metric - pe.metric)
            hit = delta > acc_delta
            app_details.append(
                f"{app.name}: acc {gpe.metric:.3f}->{pe.metric:.3f}"
                f" (|d|={delta:.3f}{'*' if hit else ''})"
            )
            score, thr = delta, acc_delta
        else:
            ratio = max(pe.metric, 1e-9) / max(gpe.metric, 1e-9)
            ratio = max(ratio, 1.0 / ratio)
            hit = ratio > ppl_ratio
            app_details.append(
                f"{app.name}: ppl {gpe.metric:.3f}->{pe.metric:.3f}"
                f" (x{ratio:.3f}{'*' if hit else ''})"
            )
            score, thr = ratio, ppl_ratio
        if score / thr > app_worst / app_thr:
            app_worst, app_thr = score, thr
        app_det = app_det or hit
        # -- paired per-example statistic ----------------------------------
        if calibrated:
            thr = ctx.stat_cal["thresholds"].get(
                f"{t.name}:{app.name}", cfg["stat_floor"])
            s = paired_stats(gpe, pe)
            s_hit = s["shift"] > thr
            st_details.append(
                f"{app.name}: shift={s['shift']:.2e} (thr {thr:.2e}) "
                f"bias_t={s['bias_t']:.1f}{'*' if s_hit else ''}"
            )
            if s["shift"] / thr > st_worst / st_thr:
                st_worst, st_thr = s["shift"], thr
            st_det = st_det or s_hit
    app_tier = TierResult("app", app_det, score=app_worst, threshold=app_thr,
                          detail="; ".join(app_details))
    if not calibrated:
        return app_tier, TierResult(
            "stat", None, detail="uncalibrated (stat_calib_seeds=0)")
    return app_tier, TierResult("stat", st_det, score=st_worst,
                                threshold=st_thr,
                                detail="; ".join(st_details))


# ---------------------------------------------------------------------------
# Campaign context: everything prepared once, before any mutant swap
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Ctx:
    config: Dict[str, Any]
    selected: List[Any]
    campaign_apps: List[_App]
    golden_info: Dict[str, Dict[str, Any]]
    golden_ops: Dict[str, Dict[str, List]]
    vt2_cases: Dict[str, List]
    eval_idx: Dict[str, Tuple[int, ...]]
    stat_cal: Dict[str, Any]
    instances: Dict[str, Tuple[Any, FaultInstance]]
    #: golden planner-emitted probe streams per target, for the static tier
    probes: Dict[str, List] = dataclasses.field(default_factory=dict)


def _resolve_config(
    targets: Optional[Sequence[str]] = None,
    faults: Optional[Sequence[str]] = None,
    apps: Sequence[str] = ("resmlp", "lstm-wlm"),
    engine: str = "pipelined",
    devices_per_target: int = 2,
    ladder: str = "full",
    n_eval: int = 32,
    train_steps: int = 120,
    op_samples: int = 2,
    op_boundary: int = 0,
    vt2_n: int = 4,
    acc_delta: float = 0.02,
    ppl_ratio: float = 1.02,
    seed: int = 0,
    stat_floor: float = 1e-3,
    stat_calib_seeds: int = 2,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    assert ladder in ("full", "escalate"), ladder
    from .faults import FAULT_CLASSES
    return dict(
        targets=[t.name for t in TARGETS.all(targets)],
        faults=list(faults) if faults is not None else list(FAULT_CLASSES),
        apps=list(apps), engine=engine,
        devices_per_target=devices_per_target, ladder=ladder,
        n_eval=n_eval, train_steps=train_steps, op_samples=op_samples,
        op_boundary=op_boundary, vt2_n=vt2_n, acc_delta=acc_delta,
        ppl_ratio=ppl_ratio, seed=seed,
        stat_floor=stat_floor, stat_calib_seeds=stat_calib_seeds,
        device=str(resolve(device)),
    )


def _enumerate_instances(selected, faults) -> Dict[str, Tuple[Any, FaultInstance]]:
    out: Dict[str, Tuple[Any, FaultInstance]] = {}
    for t in selected:
        for inst in fault_instances(t, faults):
            out[f"{t.name}:{inst.fault}@{inst.instruction}"] = (t, inst)
    return out


def _calibrate_stat(ctx_apps: List[_App], selected, config: Dict[str, Any],
                    say) -> Dict[str, Any]:
    """FP-budget calibration of the statistical tier: evaluate the identity
    mutant of each target on ``stat_calib_seeds`` independently seeded
    evaluation subsets, collect the null distribution of the paired shift
    statistic (exactly zero for a bit-exact stack), and set the per
    (target, app) detection threshold to ``max(stat_floor, 2 x worst
    null)``. The measured false-positive count against that threshold is
    recorded — the budget is empirical, not assumed."""
    n_seeds = config["stat_calib_seeds"]
    cal: Dict[str, Any] = {
        "floor": config["stat_floor"], "calib_seeds": n_seeds,
        "null_shifts": {}, "thresholds": {}, "false_positives": {},
    }
    if n_seeds <= 0 or not ctx_apps:
        return cal
    engine, devices = config["engine"], config["devices_per_target"]
    device = config["device"]
    for t in selected:
        relevant = [a for a in ctx_apps if a.offloads.get(t.name, 0) > 0]
        if not relevant:
            continue
        (inst,) = fault_instances(t, ("identity",))
        mutant = make_mutant(t, inst)
        nulls: Dict[str, List[float]] = {a.name: [] for a in relevant}
        with swapped_in(mutant):
            for k in range(n_seeds):
                for a in relevant:
                    idx = _subset(a.pool, config["n_eval"],
                                  f"calib:{a.name}:{k}", config["seed"])
                    pe = a.per_example(_executor(engine, devices, device), idx)
                    s = paired_stats(a.golden_pe[idx], pe)
                    nulls[a.name].append(s["shift"])
        for a in relevant:
            key = f"{t.name}:{a.name}"
            thr = max(config["stat_floor"], 2.0 * max(nulls[a.name]))
            cal["null_shifts"][key] = nulls[a.name]
            cal["thresholds"][key] = thr
            cal["false_positives"][key] = sum(
                1 for v in nulls[a.name] if v > thr)
            say(f"  stat calibration {key}: nulls={nulls[a.name]} "
                f"threshold={thr:g} fp={cal['false_positives'][key]}")
    return cal


def _prepare(config: Dict[str, Any], say) -> _Ctx:
    """Build everything a campaign (or one sharded worker) needs: trained
    apps, golden per-example baselines for the main + calibration subsets,
    golden op outputs, VT2 cases, the stat calibration, and the mutant
    instance map. All golden evaluation happens HERE, before any mutant is
    ever swapped into the registries."""
    selected = TARGETS.all(config["targets"])
    n_eval, train_steps, seed = (config["n_eval"], config["train_steps"],
                                 config["seed"])
    engine, devices = config["engine"], config["devices_per_target"]
    device = config["device"]
    say(f"preparing {len(config['apps'])} application(s): build, "
        f"train({train_steps} steps), compile, golden eval({n_eval})")
    campaign_apps = [_prepare_app(a, n_eval, train_steps, seed, device)
                     for a in config["apps"]]
    golden_info: Dict[str, Dict[str, Any]] = {}
    eval_idx: Dict[str, Tuple[int, ...]] = {}
    for app in campaign_apps:
        idx = _subset(app.pool, n_eval, f"eval:{app.name}", seed)
        eval_idx[app.name] = idx
        subsets = [idx] + [
            _subset(app.pool, n_eval, f"calib:{app.name}:{k}", seed)
            for k in range(config["stat_calib_seeds"])
        ]
        for s in subsets:
            if s not in app.golden_pe:
                app.golden_pe[s] = app.per_example(
                    _executor(engine, devices, device), s)
        app.golden_metric = app.golden_pe[idx].metric
        golden_info[app.name] = {
            "metric": app.kind, "value": app.golden_metric,
            "offloads": app.offloads,
        }
        say(f"  golden {app.name}: {app.kind}={app.golden_metric:.4f} "
            f"offloads={app.offloads}")
    golden_ops = {
        t.name: _golden_op_outputs(t, config["op_samples"], seed, engine,
                                   devices, device,
                                   boundary=config.get("op_boundary", 0))
        for t in selected
    }
    vt2_cases = {t.name: t.vt2_cases(8, 32) for t in selected}
    stat_cal = _calibrate_stat(campaign_apps, selected, config, say)
    instances = _enumerate_instances(selected, config["faults"])
    # golden probe streams for the static tier: planner packing only
    # (crc32-seeded, so sharded workers derive identical probes)
    probes = {t.name: ilalint.probe_streams(t, seed=seed, samples=1)
              for t in selected}
    return _Ctx(config, selected, campaign_apps, golden_info, golden_ops,
                vt2_cases, eval_idx, stat_cal, instances, probes)


def _run_one(ctx: _Ctx, t, inst: FaultInstance) -> MutantReport:
    """One mutant through the ladder, crash-isolated: an exception raised
    by the mutant (planning, simulation, or a deliberately injected fault)
    is recorded as outcome ``crash`` with whatever tiers completed;
    ``swapped_in`` guarantees registry restoration either way."""
    cfg = ctx.config
    t0 = time.perf_counter()
    mutant = make_mutant(t, inst)
    tiers: Dict[str, TierResult] = {}
    outcome, error = "ok", ""
    mkey = f"{t.name}:{inst.fault}@{inst.instruction}"

    def tier_span(name):
        # one span per tier, trace-correlated by mutant key; the sharded
        # runner ships these back with the result (worker-side export)
        return TELEMETRY.span("campaign.tier", trace_id=mkey, tier=name,
                              target=t.name, fault=inst.fault)

    try:
        with swapped_in(mutant):
            # tier 0: static verification against the golden probe streams
            # — no simulation; under an escalation ladder a static
            # detection skips every simulated tier below
            with tier_span("static") as sp:
                tiers["static"] = _tier_static(t, ctx.probes[t.name], inst)
                sp.set(detected=tiers["static"].detected)

            def app_and_stat():
                app_tier, stat_tier = _tier_app_and_stat(ctx, t)
                tiers["app"] = app_tier
                return stat_tier

            runner = [
                ("vt2", lambda: _tier_vt2(
                    mutant, mutant.vt2_cases(8, 32), cfg["vt2_n"],
                    cfg["seed"], cfg["device"])),
                ("frag_sim", lambda: _tier_frag_sim(
                    mutant, ctx.vt2_cases[t.name], cfg["engine"],
                    cfg["devices_per_target"], cfg["seed"], cfg["device"])),
                ("op_diff", lambda: _tier_op_diff(
                    t, ctx.golden_ops[t.name], cfg["engine"],
                    cfg["devices_per_target"], cfg["device"])),
                # one shared evaluation pass fills BOTH app and stat
                ("stat", app_and_stat),
            ]
            for name, run in runner:
                if cfg["ladder"] == "escalate" and any(
                    r.detected for r in tiers.values() if r.detected
                ):
                    tiers[name] = TierResult(
                        name, None, detail="skipped (caught earlier)")
                    if name == "stat":
                        tiers.setdefault("app", TierResult(
                            "app", None, detail="skipped (caught earlier)"))
                    continue
                with tier_span(name) as sp:
                    tiers[name] = run()
                    sp.set(detected=tiers[name].detected)
    except KeyboardInterrupt:
        raise
    except Exception as e:
        outcome = "crash"
        error = f"{type(e).__name__}: {e}"
    t1 = time.perf_counter()
    rep = MutantReport(
        t.name, inst.fault, inst.instruction, inst.note, tiers,
        seconds=t1 - t0, outcome=outcome, error=error,
    )
    if TELEMETRY.enabled:
        TELEMETRY.record_span(
            "campaign.mutant", t0, t1, trace_id=mkey, outcome=outcome,
            detected_at=rep.detected_at or "never")
    return rep


def _count_report(rep: Dict[str, Any]) -> None:
    """Escape-matrix counters into the process metrics registry: every
    finished mutant increments ``campaign.mutants``, its first detecting
    tier (or ``campaign.escaped``), its outcome, and the per-mutant
    wall-clock histogram. Both runners call this — for the sharded runner
    it runs parent-side on the checkpointed report dict, so worker
    process boundaries don't lose counts."""
    TELEMETRY.counter("campaign.mutants").inc()
    det = rep.get("detected_at")
    if det:
        TELEMETRY.counter("campaign.detected", tier=det).inc()
    else:
        TELEMETRY.counter("campaign.escaped").inc()
    TELEMETRY.counter(
        "campaign.outcome", outcome=rep.get("outcome", "ok")).inc()
    TELEMETRY.histogram("campaign.mutant_s").observe(
        float(rep.get("seconds", 0.0)))


def _eta_suffix(done: int, total: int, elapsed_s: float) -> str:
    """The running throughput/ETA tail of a campaign progress line.
    ``done``/``elapsed_s`` cover only this run (resumed mutants excluded);
    the rate is published as ``campaign.mutants_per_s`` and the line reads
    it back from the registry — one source of truth for reporting."""
    rate = TELEMETRY.gauge("campaign.mutants_per_s")
    rate.set(done / elapsed_s if elapsed_s > 0 else 0.0)
    r = rate.value
    if r <= 0 or done >= total:
        return ""
    return f" | {r:.2f} mutants/s, ETA {(total - done) / r:.0f}s"


# ---------------------------------------------------------------------------
# The serial campaign (with checkpoint/resume)
# ---------------------------------------------------------------------------


def run_campaign(
    targets: Optional[Sequence[str]] = None,
    faults: Optional[Sequence[str]] = None,
    apps: Sequence[str] = ("resmlp", "lstm-wlm"),
    engine: str = "pipelined",
    devices_per_target: int = 2,
    ladder: str = "full",
    n_eval: int = 32,
    train_steps: int = 120,
    op_samples: int = 2,
    op_boundary: int = 0,
    vt2_n: int = 4,
    acc_delta: float = 0.02,
    ppl_ratio: float = 1.02,
    seed: int = 0,
    stat_floor: float = 1e-3,
    stat_calib_seeds: int = 2,
    device: DeviceLike = None,
    checkpoint: Optional[str] = None,
    resume: bool = False,
    progress: Optional[Callable[[str], None]] = None,
) -> CampaignResult:
    """Run the full campaign on ``device`` (``None`` -> CUDA); see the
    module docstring.

    ``ladder="full"`` runs every tier on every mutant (the complete escape
    matrix); ``"escalate"`` stops at the first detecting tier (cheaper —
    the first-detection statistics are identical). All randomness is seeded:
    golden and mutant evaluations see identical inputs (the evaluation
    subset itself is drawn from ``seed``), so every reported delta is a
    real semantic difference, not sampling noise. ``checkpoint`` names a
    JSON file updated atomically after every mutant; with ``resume=True``
    completed mutants recorded there (under a matching config fingerprint)
    are skipped.
    """
    say = progress or (lambda s: None)
    t_start = time.perf_counter()
    config = _resolve_config(
        targets=targets, faults=faults, apps=apps, engine=engine,
        devices_per_target=devices_per_target, ladder=ladder, n_eval=n_eval,
        train_steps=train_steps, op_samples=op_samples,
        op_boundary=op_boundary, vt2_n=vt2_n,
        acc_delta=acc_delta, ppl_ratio=ppl_ratio, seed=seed,
        stat_floor=stat_floor, stat_calib_seeds=stat_calib_seeds,
        device=device,
    )

    completed: Dict[str, Dict[str, Any]] = {}
    prior_seconds = 0.0
    ckpt_golden: Dict[str, Any] = {}
    ckpt_cal: Dict[str, Any] = {}
    if resume and checkpoint and os.path.exists(checkpoint):
        completed, prior_seconds, ckpt_golden, ckpt_cal = _load_checkpoint(
            checkpoint, config)
        say(f"resuming: {len(completed)} mutant(s) already completed")

    keys = list(_enumerate_instances(
        TARGETS.all(config["targets"]), config["faults"]))
    if all(k in completed for k in keys):
        # nothing left to run: finalize straight from the checkpoint
        reports = [MutantReport.from_dict(completed[k]) for k in keys]
        result = CampaignResult(reports, ckpt_golden, config, ckpt_cal,
                                seconds=prior_seconds)
        if checkpoint:
            _save_checkpoint(checkpoint, config, ckpt_golden, ckpt_cal,
                             [r.to_dict() for r in reports],
                             result.seconds, partial=False)
        return result

    ctx = _prepare(config, say)
    reports: List[MutantReport] = []
    n_run = 0
    n_todo = sum(1 for k in ctx.instances if k not in completed)
    t_run = time.perf_counter()
    for key, (t, inst) in ctx.instances.items():
        if key in completed:
            reports.append(MutantReport.from_dict(completed[key]))
            continue
        rep = _run_one(ctx, t, inst)
        reports.append(rep)
        completed[key] = rep.to_dict()
        n_run += 1
        _count_report(completed[key])
        if checkpoint:
            _save_checkpoint(
                checkpoint, config, ctx.golden_info, ctx.stat_cal,
                [r.to_dict() for r in reports],
                prior_seconds + time.perf_counter() - t_start, partial=True)
        say(f"  {rep.key}: detected_at={rep.detected_at or 'never'} "
            f"({rep.seconds:.1f}s)"
            + _eta_suffix(n_run, n_todo, time.perf_counter() - t_run))

    result = CampaignResult(
        reports, ctx.golden_info, config, ctx.stat_cal,
        seconds=prior_seconds + time.perf_counter() - t_start,
    )
    if checkpoint:
        _save_checkpoint(checkpoint, config, ctx.golden_info, ctx.stat_cal,
                         [r.to_dict() for r in reports], result.seconds,
                         partial=False)
    return result


# ---------------------------------------------------------------------------
# The fault-tolerant sharded runner
# ---------------------------------------------------------------------------


def _shard_worker(wid: int, config: Dict[str, Any], task_q, result_q) -> None:
    """Worker-subprocess loop: prepare a private campaign context (own
    torch runtime and CUDA context, own registries, own device fleet),
    then run mutants by key. The worker resolves the config's device
    itself; a worker that cannot reach it fails to initialize.
    Mutant crashes are already absorbed by :func:`_run_one` (outcome
    ``crash``); anything escaping it — infrastructure failure — is reported
    as ``error`` for the parent's retry policy. The worker itself never
    dies from a mutant."""
    import traceback
    try:
        from .. import accel  # noqa: F401  (registers bundled targets)
        resolve(config["device"])   # raises where the device is unreachable
        if config.get("_trace_spans"):
            # tracing requested in the parent: record spans here too and
            # ship each mutant's spans back with its result (the ring is
            # drained per mutant, so worker memory stays bounded)
            TELEMETRY.enable()
        ctx = _prepare(config, lambda s: None)
        TELEMETRY.drain_spans()  # prepare/warmup spans are not per-mutant
        result_q.put(("ready", wid, {
            "golden": ctx.golden_info, "stat_calibration": ctx.stat_cal,
        }))
    except BaseException:
        result_q.put(("init_failed", wid, traceback.format_exc(limit=20)))
        return
    while True:
        try:
            key = task_q.get(timeout=30)
        except queue_mod.Empty:
            # if the parent was SIGKILLed (a kill-and-resume run) we are
            # re-parented to init — exit instead of lingering forever
            if os.getppid() == 1:
                return
            continue
        if key is None:
            return
        result_q.put(("begin", wid, key))
        try:
            t, inst = ctx.instances[key]
            rep = _run_one(ctx, t, inst)
            spans = TELEMETRY.drain_spans() if TELEMETRY.enabled else []
            result_q.put(("done", wid, key, rep.to_dict(), spans))
        except BaseException:
            result_q.put(("error", wid, key, traceback.format_exc(limit=20)))


def _failure_report(meta: Tuple[str, str, str, str], outcome: str,
                    error: str, attempts: int, seconds: float) -> Dict[str, Any]:
    tname, fault, instruction, note = meta
    return MutantReport(
        tname, fault, instruction, note, {}, seconds=seconds,
        outcome=outcome, error=error, attempts=attempts,
    ).to_dict()


def run_campaign_sharded(
    workers: int = 2,
    mutant_timeout: float = 300.0,
    retries: int = 1,
    retry_backoff: float = 2.0,
    checkpoint: Optional[str] = None,
    resume: bool = False,
    progress: Optional[Callable[[str], None]] = None,
    trace_spans: Optional[bool] = None,
    **params,
) -> CampaignResult:
    """The fault-tolerant sharded campaign: mutants fan out across
    ``workers`` subprocesses, each owning a private device fleet and
    registries (spawned, so mutant state can never leak between workers or
    back into this process).

    Per-mutant robustness semantics:

    * a mutant that **raises** is absorbed inside the worker (outcome
      ``crash`` via :func:`_run_one`); a worker that *dies* mid-mutant
      (segfault, OOM-kill) is treated the same, after retries;
    * a mutant exceeding ``mutant_timeout`` seconds gets its worker
      terminated and is recorded as outcome ``timeout`` (never retried — a
      hang would hang again); a fresh worker replaces the killed one;
    * transient infrastructure failures retry up to ``retries`` times with
      ``retry_backoff * attempt`` seconds of backoff;
    * every completed mutant checkpoints to ``checkpoint`` atomically, and
      ``resume=True`` continues an interrupted campaign (config fingerprint
      permitting) with a bit-identical final matrix (:func:`matrix_digest`).

    ``trace_spans`` (default: inherit ``TELEMETRY.enabled``) makes each
    worker record telemetry spans and ship them back with every result;
    the parent merges them into its own span buffer (per-worker lanes), so
    an exported trace covers the whole sharded campaign. Runner knobs —
    including ``trace_spans`` — are outside the config fingerprint, so
    tracing never invalidates a resume.

    Remaining keyword arguments are :func:`run_campaign`'s campaign knobs,
    ``device`` included: the parent resolves it into the config (raising
    without CUDA when it is ``None``), and each spawned worker opens its own
    context on it.
    The escape matrix is deterministic and identical to the serial
    runner's; only wall-clock and attempt counts differ.
    """
    import multiprocessing as mp

    say = progress or (lambda s: None)
    t_start = time.perf_counter()
    config = _resolve_config(**params)
    run_cfg = dict(config, workers=workers, mutant_timeout=mutant_timeout,
                   retries=retries)
    if trace_spans is None:
        trace_spans = TELEMETRY.enabled
    worker_cfg = dict(config, _trace_spans=bool(trace_spans))

    selected = TARGETS.all(config["targets"])
    instances = _enumerate_instances(selected, config["faults"])
    keys = list(instances)
    meta = {
        k: (t.name, inst.fault, inst.instruction, inst.note)
        for k, (t, inst) in instances.items()
    }

    completed: Dict[str, Dict[str, Any]] = {}
    prior_seconds = 0.0
    golden_info: Dict[str, Any] = {}
    stat_cal: Dict[str, Any] = {}
    if resume and checkpoint and os.path.exists(checkpoint):
        completed, prior_seconds, golden_info, stat_cal = _load_checkpoint(
            checkpoint, config)
        completed = {k: v for k, v in completed.items() if k in meta}
        say(f"resuming: {len(completed)} mutant(s) already completed")

    pending = [k for k in keys if k not in completed]
    attempts = {k: 0 for k in pending}
    not_before = {k: 0.0 for k in pending}

    def finalize() -> CampaignResult:
        reports = [MutantReport.from_dict(completed[k]) for k in keys]
        result = CampaignResult(
            reports, golden_info, run_cfg, stat_cal,
            seconds=prior_seconds + time.perf_counter() - t_start,
        )
        if checkpoint:
            _save_checkpoint(checkpoint, run_cfg, golden_info, stat_cal,
                             [r.to_dict() for r in reports], result.seconds,
                             partial=False)
        return result

    if not pending:
        return finalize()

    n_resumed = len(completed)

    def record(key: str, rep: Dict[str, Any]) -> None:
        completed[key] = rep
        _count_report(rep)
        if checkpoint:
            _save_checkpoint(
                checkpoint, run_cfg, golden_info, stat_cal,
                [completed[k] for k in keys if k in completed],
                prior_seconds + time.perf_counter() - t_start, partial=True)
        say(f"  [{len(completed)}/{len(keys)}] {key}: "
            f"{rep.get('detected_at') or 'never'} "
            f"(outcome={rep.get('outcome', 'ok')}, "
            f"{rep.get('seconds', 0.0):.1f}s)"
            + _eta_suffix(len(completed) - n_resumed, len(keys) - n_resumed,
                          time.perf_counter() - t_start))

    mpctx = mp.get_context("spawn")
    result_q = mpctx.Queue()
    next_wid = 0

    def spawn():
        nonlocal next_wid
        wid = next_wid
        next_wid += 1
        q = mpctx.Queue()
        p = mpctx.Process(target=_shard_worker,
                          args=(wid, worker_cfg, q, result_q), daemon=True)
        p.start()
        # init covers app training + golden eval + calibration; give it a
        # generous independent watchdog so a wedged init cannot stall the
        # campaign forever
        return {"proc": p, "q": q, "wid": wid, "key": None, "deadline": None,
                "ready": False, "init_deadline": time.monotonic() + max(
                    900.0, 3.0 * mutant_timeout)}

    fleet = {w["wid"]: w for w in
             (spawn() for _ in range(max(1, min(workers, len(pending)))))}

    def requeue_or_fail(key: str, why: str) -> None:
        if attempts[key] <= retries:
            not_before[key] = time.monotonic() + retry_backoff * attempts[key]
            pending.append(key)
            say(f"  retrying {key} (attempt {attempts[key]} failed: {why})")
        else:
            record(key, _failure_report(meta[key], "crash", why,
                                        attempts[key], 0.0))

    try:
        while len(completed) < len(keys):
            now = time.monotonic()
            # dispatch to idle ready workers
            for w in fleet.values():
                if w["ready"] and w["key"] is None and w["proc"].is_alive():
                    k = next((k for k in pending if not_before[k] <= now),
                             None)
                    if k is None:
                        continue
                    pending.remove(k)
                    attempts[k] += 1
                    w["key"] = k
                    # fallback deadline in case "begin" is never received
                    w["deadline"] = now + mutant_timeout + 60.0
                    w["q"].put(k)
            # drain one message (with a poll timeout so watchdogs tick)
            try:
                msg = result_q.get(timeout=0.25)
            except queue_mod.Empty:
                msg = None
            if msg is not None:
                kind, wid = msg[0], msg[1]
                w = fleet.get(wid)
                if w is None:
                    pass  # late message from an already-killed worker
                elif kind == "ready":
                    w["ready"] = True
                    w["init_deadline"] = None
                    if not golden_info:
                        golden_info = msg[2]["golden"]
                        stat_cal = msg[2]["stat_calibration"]
                elif kind == "init_failed":
                    raise RuntimeError(
                        f"sharded campaign worker failed to initialize:\n"
                        f"{msg[2]}")
                elif kind == "begin":
                    w["deadline"] = time.monotonic() + mutant_timeout
                elif kind == "done":
                    key, rep = msg[2], msg[3]
                    rep["attempts"] = attempts.get(key, 1)
                    spans = msg[4] if len(msg) > 4 else []
                    if spans:
                        TELEMETRY.ingest(spans, source=f"worker{wid}")
                    record(key, rep)
                    w["key"], w["deadline"] = None, None
                elif kind == "error":
                    key = msg[2]
                    w["key"], w["deadline"] = None, None
                    requeue_or_fail(key, msg[3].strip().splitlines()[-1]
                                    if msg[3].strip() else "worker error")
            # watchdogs: per-mutant timeout, init timeout, worker death
            now = time.monotonic()
            for wid, w in list(fleet.items()):
                key = w["key"]
                if key is not None and w["deadline"] and now > w["deadline"]:
                    say(f"  {key}: exceeded mutant_timeout="
                        f"{mutant_timeout:g}s — terminating worker {wid}")
                    w["proc"].terminate()
                    w["proc"].join(10)
                    record(key, _failure_report(
                        meta[key], "timeout",
                        f"exceeded mutant_timeout={mutant_timeout:g}s",
                        attempts[key], mutant_timeout))
                    del fleet[wid]
                elif not w["proc"].is_alive():
                    del fleet[wid]
                    if not w["ready"]:
                        # died before ever reporting ready: environment
                        # problem, not a mutant — respawning would loop
                        raise RuntimeError(
                            "sharded campaign worker died during "
                            f"initialization (exitcode={w['proc'].exitcode})"
                            "; is the entry point spawn-safe "
                            "(__main__ importable)?")
                    if key is not None:
                        requeue_or_fail(
                            key, "worker process died "
                            f"(exitcode={w['proc'].exitcode})")
                elif (not w["ready"] and w["init_deadline"]
                      and now > w["init_deadline"]):
                    w["proc"].terminate()
                    w["proc"].join(10)
                    del fleet[wid]
                    raise RuntimeError(
                        "sharded campaign worker hung during initialization")
            # keep the fleet sized to the remaining work
            in_flight = sum(1 for w in fleet.values() if w["key"] is not None)
            todo = len(keys) - len(completed) - in_flight
            while todo > 0 and len(fleet) < max(1, min(workers, todo + in_flight)):
                w = spawn()
                fleet[w["wid"]] = w
                todo -= 1
    finally:
        for w in fleet.values():
            if w["proc"].is_alive():
                try:
                    w["q"].put(None)
                except Exception:
                    pass
        deadline = time.monotonic() + 5.0
        for w in fleet.values():
            w["proc"].join(max(0.1, deadline - time.monotonic()))
            if w["proc"].is_alive():
                w["proc"].terminate()
                w["proc"].join(5)

    return finalize()


def format_matrix(result: CampaignResult) -> str:
    """The human-readable escape-analysis matrix."""
    iw = max([13] + [len(r.instruction) for r in result.reports])
    rows = [
        f"{'target':9s} {'fault':12s} {'instruction':{iw}s} "
        + " ".join(f"{t:>9s}" for t in TIER_ORDER)
        + "  detected_at"
    ]
    rows.append("-" * len(rows[0]))
    for r in result.reports:
        cells = " ".join(
            f"{(r.tiers[t].cell() if t in r.tiers else '-'):>9s}"
            for t in TIER_ORDER
        )
        flag = ""
        if r.app_only:
            flag = " [app-only escape]"
        elif r.stat_only:
            flag = " [stat-only escape]"
        rows.append(
            f"{r.target:9s} {r.fault:12s} {r.instruction:{iw}s} {cells}"
            f"  {r.detected_at or 'never'}{flag}"
        )
    s = result.summary()
    rows.append("")
    rows.append(
        f"{s['mutants']} mutants in {result.seconds:.1f}s "
        f"({s['mutants_per_sec']:.2f} mutants/sec); "
        f"first detection by tier: {s['first_detection_by_tier']}"
    )
    if s["app_only"]:
        rows.append(
            "caught ONLY at application level (the paper's thesis, "
            f"quantified): {s['app_only']}"
        )
    if s["stat_only"]:
        rows.append(
            "caught ONLY by the calibrated statistical tier (escaped even "
            f"the app-metric threshold): {s['stat_only']}"
        )
    if s["crashes"]:
        rows.append(f"crashed mutants (isolated, campaign completed): "
                    f"{s['crashes']}")
    if s["timeouts"]:
        rows.append(f"timed-out mutants (terminated at the per-mutant "
                    f"deadline): {s['timeouts']}")
    if s["undetected"]:
        rows.append(f"undetected non-identity mutants: {s['undetected']}")
    return "\n".join(rows)
