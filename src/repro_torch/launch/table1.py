"""Table 1 of the paper on the port: end-to-end compilation statistics.

    python -m repro_torch.launch.table1 [--device cuda]

Per application x accelerator: static invocations under exact vs flexible
matching (per-target compiles, as the paper's rows 4-6 are). Columns come
from the target registry, so a newly registered backend gets a column — and
its exact/flexible offload counts — automatically. The counterpart of
``benchmarks/table1_matching.py``. Matching is host work (the e-graph), so
``--device`` only selects the device the run is charged to; it resolves
like every entry point (``None`` -> CUDA, which must be present).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence

from .. import accel  # noqa: F401  (registers the bundled targets)
from ..core import apps, ir
from ..core.compile import compile_program
from ..core.ila import TARGETS
from ..device import DeviceLike, resolve


def run(device: DeviceLike = None) -> List[Dict[str, Any]]:
    """One row per application: ``{"application", "dsl", "n_ops",
    "cells": {target: (exact, flexible)}, "saturated", "seconds"}``."""
    resolve(device)
    rows = []
    targets = TARGETS.all()
    for name, (builder, dsl) in apps.APPLICATIONS.items():
        expr, _ = builder()
        t0 = time.perf_counter()
        cells, saturated = {}, True
        for t in targets:
            e = compile_program(expr, targets=(t.name,), flexible=False)
            f = compile_program(expr, targets=(t.name,), flexible=True)
            saturated &= f.stats["saturated"]
            cells[t.name] = (e.accelerator_calls[t.name], f.accelerator_calls[t.name])
        rows.append({"application": name, "dsl": dsl, "n_ops": ir.count_ops(expr),
                     "cells": cells, "saturated": bool(saturated),
                     "seconds": time.perf_counter() - t0})
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    rows = run(args.device)
    targets = TARGETS.all()
    print("\n== Table 1: compilation statistics (exact/flexible) ==")
    header = " ".join(f"{t.display_name:>10s}" for t in targets)
    print(f"{'Application':14s} {'DSL':8s} {'#IR ops':>8s} {header} {'sat?':>5s}")
    for r in rows:
        cells = " ".join(f"{'%d/%d' % r['cells'][t.name]:>10s}" for t in targets)
        print(f"{r['application']:14s} {r['dsl']:8s} {r['n_ops']:8d} {cells} "
              f"{str(r['saturated']):>5s}")
    return rows


if __name__ == "__main__":
    main()
