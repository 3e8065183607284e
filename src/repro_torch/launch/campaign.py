"""Fault-injection campaign launcher.

    python -m repro_torch.launch.campaign \
        [--targets flexasr,hlscnn,vecunit] [--apps resmlp,lstm-wlm] \
        [--faults identity,trunc_width,round_floor,drop_cfg,stale_state] \
        [--engine pipelined] [--devices-per-target 2] [--ladder full] \
        [--n-eval 32] [--train-steps 120] [--seed 0] \
        [--workers 4 --mutant-timeout 300 --retries 1] \
        [--json CAMPAIGN.json] [--resume] [--device cuda]

Enumerates (target x instruction x fault) mutants from the fault library
(``repro_torch.core.faults``), runs each through the tiered detection
ladder (``repro_torch.core.campaign``: static -> VT2 abstract -> co-simulated fragments ->
per-op golden-vs-mutant diff -> full-application metric deltas -> the
calibrated per-example statistical tier), prints the escape-analysis
matrix, mutants/sec throughput and the canonical matrix digest, and
writes the machine-readable ``CAMPAIGN.json``. Everything runs on
``--device`` (default CUDA, which must be present; ``--device cpu`` runs on
the host), sharded workers included.

``--workers N`` (N > 1) selects the fault-tolerant sharded runner:
mutants fan out across N worker subprocesses with per-mutant timeouts,
crash isolation and bounded retry. With ``--json`` the campaign
checkpoints after every mutant, and ``--resume`` continues an
interrupted run from that file (config fingerprint permitting) — the
resumed escape matrix is bit-identical to an uninterrupted one
(compare ``matrix digest`` lines).
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from ..core.campaign import (
    format_matrix, matrix_digest, run_campaign, run_campaign_sharded,
)
from ..core.faults import DIAGNOSTIC_FAULT_CLASSES, FAULT_CLASSES
from ..device import resolve


def _csv(s):
    return [x.strip() for x in s.split(",") if x.strip()] if s else None


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--targets", default=None,
                    help="comma-separated target names (default: all registered)")
    ap.add_argument("--faults", default=None,
                    help="comma-separated fault classes (default: full "
                         f"library: {list(FAULT_CLASSES)}; diagnostic "
                         f"extras: {list(DIAGNOSTIC_FAULT_CLASSES)})")
    ap.add_argument("--apps", default="resmlp,lstm-wlm",
                    help="applications for the app-metric tier")
    ap.add_argument("--engine", default="pipelined",
                    choices=["compiled", "pipelined", "jit", "eager"])
    ap.add_argument("--devices-per-target", type=int, default=2)
    ap.add_argument("--ladder", default="full", choices=["full", "escalate"],
                    help="full = every tier on every mutant (complete "
                         "matrix); escalate = stop at first detection")
    ap.add_argument("--n-eval", type=int, default=32)
    ap.add_argument("--train-steps", type=int, default=120)
    ap.add_argument("--op-samples", type=int, default=2)
    ap.add_argument("--op-boundary", type=int, default=0,
                    help="range-directed op-tier samples per intrinsic: "
                         "activation operands straddling the statically "
                         "computed saturation boundary (ilalint."
                         "boundary_inputs), aimed at sat_wrap-class "
                         "faults; 0 (default) keeps the uniform-only pool")
    ap.add_argument("--acc-delta", type=float, default=0.02,
                    help="app-tier detection threshold: |accuracy delta|")
    ap.add_argument("--ppl-ratio", type=float, default=1.02,
                    help="app-tier detection threshold: perplexity ratio")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds mutant sampling, app training AND the "
                         "evaluation-subset draw — identical seeds "
                         "reproduce the matrix bit-for-bit")
    ap.add_argument("--stat-floor", type=float, default=1e-3,
                    help="statistical-tier minimum detection threshold on "
                         "the paired per-example shift")
    ap.add_argument("--stat-calib-seeds", type=int, default=2,
                    help="identity-null calibration subsets per (target, "
                         "app); 0 disables the statistical tier")
    ap.add_argument("--workers", type=int, default=1,
                    help=">1 selects the fault-tolerant sharded runner "
                         "with this many worker subprocesses")
    ap.add_argument("--mutant-timeout", type=float, default=300.0,
                    help="sharded runner: per-mutant wall-clock budget; a "
                         "hanging mutant is terminated and recorded as "
                         "outcome 'timeout'")
    ap.add_argument("--retries", type=int, default=1,
                    help="sharded runner: retry budget for transient "
                         "worker failures")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable campaign result here "
                         "(also the per-mutant checkpoint file)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the --json checkpoint if present")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record telemetry spans (per-mutant tier spans; "
                         "sharded workers ship theirs back per result) and "
                         "export a Perfetto trace_event JSON at exit")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="export a JSON snapshot of the telemetry metrics "
                         "(escape counters, mutant_s histogram, throughput)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    resolve(args.device)

    # importing repro_torch.accel registers the bundled targets
    from .. import accel  # noqa: F401
    from ..core.telemetry import TELEMETRY

    if args.trace:
        TELEMETRY.enable()

    params = dict(
        targets=_csv(args.targets),
        faults=_csv(args.faults),
        apps=_csv(args.apps) or (),
        engine=args.engine,
        devices_per_target=args.devices_per_target,
        ladder=args.ladder,
        n_eval=args.n_eval,
        train_steps=args.train_steps,
        op_samples=args.op_samples,
        op_boundary=args.op_boundary,
        acc_delta=args.acc_delta,
        ppl_ratio=args.ppl_ratio,
        seed=args.seed,
        stat_floor=args.stat_floor,
        stat_calib_seeds=args.stat_calib_seeds,
        device=args.device,
    )
    if args.workers > 1:
        result = run_campaign_sharded(
            workers=args.workers,
            mutant_timeout=args.mutant_timeout,
            retries=args.retries,
            checkpoint=args.json,
            resume=args.resume,
            progress=print,
            **params,
        )
    else:
        result = run_campaign(
            checkpoint=args.json, resume=args.resume, progress=print,
            **params,
        )
    print()
    print(format_matrix(result))
    print(f"\nmatrix digest: {matrix_digest(result)}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.json}")
    if args.trace:
        path = TELEMETRY.export_trace(args.trace)
        print(f"trace: {TELEMETRY.spans_recorded} span(s) "
              f"({TELEMETRY.spans_dropped} dropped) -> {path}")
    if args.metrics:
        bad = TELEMETRY.check_names()
        assert not bad, f"metric names violate the documented schema: {bad}"
        print(f"metrics: -> {TELEMETRY.export_metrics(args.metrics)}")
    return result


if __name__ == "__main__":
    main()
