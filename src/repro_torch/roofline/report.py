"""Roofline summary of the dry-run's cells.

    python -m repro_torch.roofline.report [path]

Port of ``benchmarks/roofline_report.py``. ``path`` is the dry-run's JSON
(default ``build/dryrun_torch.json``, ``launch/dryrun.py``'s ``--out``).
Prints the table and returns the ``(name, us, derived)`` rows: each ok
cell's roofline bound on the H100's published peaks, in microseconds.
"""
from __future__ import annotations

import json
import os
import sys

from ..configs import get_config
from ..launch.dryrun import DEFAULT_OUT
from ..models.config import SHAPES
from .analysis import roofline_report, roofline_terms


def run(path: str = DEFAULT_OUT):
    if not os.path.exists(path):
        print(f"\n(no {path} — run `python -m repro_torch.launch.dryrun --all` first)")
        return []
    with open(path) as f:
        cells = json.load(f)
    print("\n== Roofline (H100 published peaks, from the dry-run's counts) ==")
    print(roofline_report(cells))
    rows = []
    for c in cells:
        if c.get("status") != "ok":
            continue
        t = roofline_terms(c, get_config(c["arch"]), SHAPES[c["shape"]])
        rows.append((f"roofline_{c['arch']}_{c['shape']}",
                     t["roofline_bound_s"] * 1e6,
                     f"dominant={t['dominant']},mfu_bound={t['mfu_bound']}"))
    return rows


if __name__ == "__main__":
    run(*sys.argv[1:2])
