"""Table 3 of the paper on the port: verification of the FlexASR MaxPool
mapping.

    python -m repro_torch.launch.table3 [--device cuda] [--n 200]

No SMT solver is available offline, so instead of BMC/CHC this runs a
*complete finite-domain* equivalence check — every assignment of a small
value lattice to the fragment inputs (decidable and exhaustive over that
domain) — for the three small shapes, plus a randomized check for the
paper's larger ones, and reports verification time against matrix
dimension. The counterpart of ``benchmarks/table3_formal.py``, with its
rows.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence

from .. import accel  # noqa: F401  (registers the bundled targets)
from ..core import ir, validate
from ..device import DeviceLike, resolve

#: (rows, cols, lattice) of the complete checks
EXHAUSTIVE = ((2, 2, (-1.0, 0.0, 1.0)), (2, 4, (-1.0, 1.0)), (4, 2, (-1.0, 1.0)))
#: (rows, cols) of the randomized checks
RANDOMIZED = ((2, 16), (4, 16), (4, 32), (8, 64), (16, 64))
N_RANDOM = 200


def maxpool_case(rows: int, cols: int) -> validate.VT2Case:
    T = ir.Var("T", (rows, cols))
    return validate.VT2Case(
        f"maxpool-{rows}x{cols}",
        ir.call("reduce_max", ir.call("windows", T, wh=2, ww=1, sh=2, sw=1), axis=(2, 3)),
        ir.call("fasr_load", ir.call("fasr_maxpool", ir.call("fasr_store", T))),
        {"T": (rows, cols)},
    )


def run(device: DeviceLike = None, n: int = N_RANDOM) -> List[Dict[str, Any]]:
    """The eight rows: ``{"dim", "method", "ok", "count", "seconds"}``
    (``count`` is the number of assignments or random draws checked)."""
    dev = resolve(device)
    out = []
    for rows, cols, lattice in EXHAUSTIVE:
        t0 = time.perf_counter()
        ok, count = validate.vt2_exhaustive(maxpool_case(rows, cols), lattice, device=dev)
        out.append({"dim": (rows, cols), "method": f"exhaustive({len(lattice)}^{rows * cols})",
                    "ok": ok, "count": count, "seconds": time.perf_counter() - t0})
    for rows, cols in RANDOMIZED:
        t0 = time.perf_counter()
        ok = validate.vt2_check(maxpool_case(rows, cols), n=n, device=dev)
        out.append({"dim": (rows, cols), "method": f"randomized({n})", "ok": ok,
                    "count": n, "seconds": time.perf_counter() - t0})
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--n", type=int, default=N_RANDOM, help="draws per randomized row")
    args = ap.parse_args(argv)
    rows = run(args.device, args.n)
    print("\n== Table 3: verification of the FlexASR MaxPool mapping ==")
    print(f"{'Matrix dim.':12s} {'method':26s} {'time (s)':>9s} {'result':>8s}")
    for r in rows:
        dim = "%dx%d" % r["dim"]
        print(f"{dim:12s} {r['method']:26s} {r['seconds']:9.2f} {str(r['ok']):>8s}")
    return rows


if __name__ == "__main__":
    main()
