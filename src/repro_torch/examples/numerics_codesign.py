"""The paper's software/hardware co-design story (Section 4.4.2) on the
port: application-level co-simulation exposes a numerics bug,
per-invocation statistics localize it, a datatype change fixes it.

    PYTHONPATH=src python -m repro_torch.examples.numerics_codesign \
        [--steps 400] [--n 30] [--device cuda]
"""
import argparse

import numpy as np

from repro_torch import device as devmod
from repro_torch.core import apps, cosim
from repro_torch.core.codegen import Executor
from repro_torch.core.compile import compile_program


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400, help="training steps")
    ap.add_argument("--n", type=int, default=30, help="evaluation points")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)

    print("1. train ResNet-20 (reduced) on a deterministic synthetic task")
    expr, params = apps.build_resnet20()
    X, y = cosim.make_teacher_task(apps.build_resnet20, (1, 12, 12, 8), n=512, device=dev)
    trained = cosim.train_app(expr, params, X, y, steps=args.steps, lr=3e-3, device=dev)

    print("2. compile for FlexASR + HLSCNN (flexible matching)")
    res = compile_program(expr, targets=("flexasr", "hlscnn"), flexible=True)
    print("   offloads:", res.accelerator_calls)

    n = args.n
    ref, _ = cosim.eval_classification(res.program, trained, X, y,
                                       Executor("ideal", device=dev), n)
    print(f"3. reference accuracy (host fp32): {ref:.1%}")

    ex8 = Executor("ila", target_options={"hlscnn": {"wgt_bits": 8}}, device=dev)
    orig, _ = cosim.eval_classification(res.program, trained, X, y, ex8, n)
    print(f"4. ORIGINAL design (8-bit fixed-point conv weights): {orig:.1%}")
    print("   per-invocation debugging statistics (given to the 'accelerator")
    print("   developers' to localize the bug):")
    per_op = {}
    for s in ex8.stats:
        per_op.setdefault(s.op, []).append(s.rel_err)
    for op, errs in per_op.items():
        print(f"     {op:16s} mean rel err {np.mean(errs):.1%}")
    print("   per-target summary:", ex8.stats_summary())

    ex16 = Executor("ila", target_options={"hlscnn": {"wgt_bits": 16}}, device=dev)
    upd, _ = cosim.eval_classification(res.program, trained, X, y, ex16, n)
    print(f"5. UPDATED design (16-bit weights): {upd:.1%}")
    print(f"\n   collapse {ref:.1%} -> {orig:.1%}, recovery -> {upd:.1%}"
          "  (cf. Table 4: 91.55% -> 29.15% -> 91.85%)")
    return ref, orig, upd


if __name__ == "__main__":
    main()
