"""Static ILA verifier launcher.

    python -m repro_torch.launch.lint \
        [--targets flexasr,hlscnn,vta,vecunit] [--seed 0] [--samples 1] \
        [--json LINT.json] [--fail-on warn] [--device cuda]

Runs the three static-analysis passes (``repro_torch.core.ilalint``: decode
soundness, state dataflow/hazards over planner-emitted probe streams,
numeric range analysis) over every selected registered target — **zero
simulated commands** — and prints each result. ``error`` and ``warn``
results are *findings*; ``note`` results record fault-surface facts
(order-sensitive configuration, carried recurrent state, statically
reachable wrap boundaries).

``--fail-on warn`` (the default) exits non-zero when any finding at or
above that severity survives; ``--fail-on error`` tolerates warnings.
``--json LINT.json`` writes the machine-readable result. ``--device``
resolves like every entry point (``None`` -> CUDA, which must be present);
the instruction-effect trace itself runs on CPU tensors.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from ..core import ilalint
from ..device import resolve


def _csv(s):
    return [x.strip() for x in s.split(",") if x.strip()] if s else None


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--targets", default=None,
                    help="comma-separated target names (default: all registered)")
    ap.add_argument("--seed", type=int, default=0,
                    help="probe-stream sampling seed (crc32-mixed per "
                         "target and intrinsic)")
    ap.add_argument("--samples", type=int, default=1,
                    help="sampled operand draws per intrinsic when "
                         "collecting probe streams")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable lint result here")
    ap.add_argument("--fail-on", default="warn", choices=["warn", "error"],
                    help="exit non-zero when a finding at or above this "
                         "severity is reported (default: warn)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    resolve(args.device)

    # importing repro_torch.accel registers the bundled targets
    from .. import accel  # noqa: F401

    per_target = ilalint.lint_registry(
        _csv(args.targets), seed=args.seed, samples=args.samples
    )
    failing = 0
    notes = 0
    for name, findings in per_target.items():
        print(f"== {name}: {len(findings)} result(s)")
        for f in findings:
            print(f"   {f}")
            if ilalint.severity_at_least(f, args.fail_on):
                failing += 1
            elif f.severity == "note":
                notes += 1
    n_find = sum(
        1 for fs in per_target.values() for f in fs if f.severity != "note"
    )
    print(f"\n{n_find} finding(s), {notes} note(s) across "
          f"{len(per_target)} target(s); "
          f"{failing} at or above --fail-on={args.fail_on}")

    if args.json:
        payload = {
            "schema": 1,
            "seed": args.seed,
            "samples": args.samples,
            "fail_on": args.fail_on,
            "targets": {
                name: [f.to_dict() for f in findings]
                for name, findings in per_target.items()
            },
            "findings": n_find,
            "failing": failing,
        }
        with open(args.json, "w") as fp:
            json.dump(payload, fp, indent=1, sort_keys=True)
            fp.write("\n")
        print(f"wrote {args.json}")
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
