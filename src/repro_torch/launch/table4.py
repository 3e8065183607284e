"""Table 4 of the paper on the port: application-level co-simulation.

    python -m repro_torch.launch.table4 [--device cuda] [--n-eval 40] [--steps 600]

Trains the Table-4 applications on deterministic teacher tasks, compiles
them by flexible matching and evaluates the compiled program on the
Executor, column by column:

  reference — fp32 on the device (the IR interpreter)
  original  — ILA co-simulation, original numerics (HLSCNN 8-bit weights)
  updated   — ILA co-simulation with the developers' fix (16-bit weights)

The counterpart of ``benchmarks/table4_cosim.py`` at the repository's own
configuration: ResMLP (2 layers) on FlexASR, ResNet-20 and MobileNet-V2
(``img=12, cin=8, width=16, blocks=3``) on FlexASR + HLSCNN, a 512-point
teacher task, 600 steps at lr 3e-3 and 40 evaluation points. The 8-bit
HLSCNN weights are expected to collapse the conv nets' accuracy and the
16-bit update to recover it. :data:`APPS` also holds EfficientNet on
FlexASR + HLSCNN + VecUnit and ResMLP on VTA, which ``chip_smoke.py``
drives through the same functions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..core import apps, cosim
from ..core.codegen import Executor
from ..core.compile import compile_program
from ..device import DeviceLike, resolve

N_EVAL = 40
TRAIN_STEPS = 600
N_TRAIN = 512
LR = 3e-3


@dataclasses.dataclass(frozen=True)
class App:
    """One application row: its builder, input shape and the targets it is
    compiled onto."""

    name: str
    platform: str
    builder: Callable[..., Tuple[Any, Dict[str, np.ndarray]]]
    input_shape: Tuple[int, ...]
    targets: Tuple[str, ...]


def _resmlp(seed=0):
    return apps.build_resmlp(seed=seed, layers=2)


APPS: Dict[str, App] = {
    "resmlp": App("ResMLP", "FlexASR", _resmlp, (16, 64), ("flexasr",)),
    "resnet20": App("ResNet-20", "FlexASR & HLSCNN", apps.build_resnet20,
                    (1, 12, 12, 8), ("flexasr", "hlscnn")),
    "mobilenet_v2": App("MobileNet-V2", "FlexASR & HLSCNN", apps.build_mobilenet_v2,
                        (1, 12, 12, 8), ("flexasr", "hlscnn")),
    "efficientnet": App("EfficientNet", "FlexASR & HLSCNN & VecUnit",
                        apps.build_efficientnet, (1, 12, 12, 8),
                        ("flexasr", "hlscnn", "vecunit")),
    "resmlp_vta": App("ResMLP", "VTA", _resmlp, (16, 64), ("vta",)),
}
#: the paper's Table-4 rows, in its order
TABLE4 = ("resmlp", "resnet20", "mobilenet_v2")

#: column -> (Executor mode, engine, HLSCNN weight bits)
COLUMNS: Dict[str, Tuple[str, Optional[str], int]] = {
    "ideal": ("ideal", None, 16),
    "ila": ("ila", "compiled", 16),
    "ila-8": ("ila", "compiled", 8),
    "ila-16": ("ila", "compiled", 16),
    "kernel": ("kernel", None, 16),
    "fused-8": ("ila", "fused", 8),
    "fused-16": ("ila", "fused", 16),
}


@dataclasses.dataclass
class Prepared:
    """A trained, compiled application and its teacher task."""

    app: App
    program: Any
    params: Dict[str, np.ndarray]
    X: np.ndarray
    y: np.ndarray
    offloads: Dict[str, int]
    setup_s: float


def prepare(app: App, device: DeviceLike = None, steps: int = TRAIN_STEPS,
            params: Optional[Dict[str, np.ndarray]] = None) -> Prepared:
    """Teacher labels, training (skipped when ``params`` are given) and
    flexible matching; ``setup_s`` is their wall clock."""
    dev = resolve(device)
    t0 = time.perf_counter()
    expr, init = app.builder()
    X, y = cosim.make_teacher_task(app.builder, app.input_shape, n=N_TRAIN, device=dev)
    if params is None:
        params = cosim.train_app(expr, init, X, y, steps=steps, lr=LR, device=dev)
    res = compile_program(expr, targets=app.targets, flexible=True)
    return Prepared(app, res.program, params, X, y, dict(res.accelerator_calls),
                    time.perf_counter() - t0)


def executor(column: str, device: DeviceLike = None) -> Executor:
    mode, engine, bits = COLUMNS[column]
    return Executor(mode, engine=engine, target_options={"hlscnn": {"wgt_bits": bits}},
                    device=device)


def evaluate(prep: Prepared, ex: Executor, n_eval: int = N_EVAL) -> Tuple[float, float]:
    """(accuracy, seconds per point) of one column on the first ``n_eval``
    points (``cosim.eval_classification``)."""
    return cosim.eval_classification(prep.program, prep.params, prep.X, prep.y, ex, n_eval)


def logits(prep: Prepared, ex: Executor, n_eval: int = N_EVAL) -> np.ndarray:
    """(n_eval, classes) output logits of one column."""
    outs = cosim.eval_outputs(prep.program, prep.params, lambda i: prep.X[i],
                              range(n_eval), ex)
    return np.stack([o.reshape(-1) for o in outs])


def acc_row(app: App, device: DeviceLike = None, n_eval: int = N_EVAL,
            steps: int = TRAIN_STEPS) -> Dict[str, Any]:
    """One Table-4 row, as ``benchmarks/table4_cosim.py::_acc_row`` reports it."""
    prep = prepare(app, device, steps)
    ref, _ = evaluate(prep, executor("ideal", device), n_eval)
    ex8 = executor("ila-8", device)
    orig, dt = evaluate(prep, ex8, n_eval)
    upd = None
    if "hlscnn" in app.targets:
        upd, _ = evaluate(prep, executor("ila-16", device), n_eval)
    per_op: Dict[str, list] = {}
    for s in ex8.stats:
        per_op.setdefault(s.op, []).append(s.rel_err)
    return {
        "application": app.name, "platform": app.platform,
        "reference": ref, "original": orig, "updated": upd,
        "sim_s_per_point": dt, "setup_s": prep.setup_s, "offloads": prep.offloads,
        "per_op_err": {k: float(np.mean(v)) for k, v in per_op.items()},
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--n-eval", type=int, default=N_EVAL)
    ap.add_argument("--steps", type=int, default=TRAIN_STEPS)
    args = ap.parse_args(argv)
    print(f"\n== Table 4: application-level co-simulation ({args.n_eval} points) ==")
    rows = [acc_row(APPS[k], args.device, args.n_eval, args.steps) for k in TABLE4]
    print(f"{'Application':14s} {'Platform':18s} {'Reference':>10s} {'Original':>10s} "
          f"{'Updated':>10s} {'s/point':>8s}")
    for r in rows:
        upd = f"{r['updated']:.1%}" if r["updated"] is not None else "n/a"
        print(f"{r['application']:14s} {r['platform']:18s} {r['reference']:>10.1%} "
              f"{r['original']:>10.1%} {upd:>10s} {r['sim_s_per_point']:>8.4f}")
        print(f"    per-op errors (original): "
              f"{ {k: f'{v:.1%}' for k, v in r['per_op_err'].items()} }")


if __name__ == "__main__":
    main()
