"""Quickstart: the D2A flow end to end on one program, on the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda]

1. Build a small DL program in the compiler IR.
2. Flexible matching (equality saturation) maps it onto accelerator
   instructions — including the linear layer the exact matcher misses.
3. Lower to ILA command streams ("MMIO writes") and co-simulate with the
   accelerator's AdaptivFloat numerics.
4. Compare against the fp32 host reference, and run the same numerics on
   the hand-written kernel (``af_gemm``; its plain version on the CPU).
"""
import argparse

import numpy as np

from repro_torch import device as devmod
from repro_torch.core import ir
from repro_torch.core.codegen import Executor, to_numpy
from repro_torch.core.compile import compile_program


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)
    rng = np.random.default_rng(0)

    # 1. a linear layer written the "wrong" way for exact matching:
    #    add(reshape(dense(x, w), s), b)  — semantically bias_add(dense(x, w), b)
    x = ir.Var("x", (8, 64))
    w = ir.Var("w", (32, 64))
    b = ir.Var("b", (32,))
    program = ir.call("relu", ir.call("add", ir.reshape(ir.dense(x, w), (8, 32)), b))
    print("source program:", program)

    # 2. exact vs flexible matching
    exact = compile_program(program, targets=("flexasr",), flexible=False)
    flexible = compile_program(program, targets=("flexasr",), flexible=True)
    print("\nexact matching offloads:   ", exact.accelerator_calls)
    print("flexible matching offloads:", flexible.accelerator_calls)
    print("matched program:", flexible.program)

    # 3. execute: fp32 reference vs bit-accurate ILA co-simulation
    env = {
        "x": rng.standard_normal((8, 64)).astype(np.float32),
        "w": (rng.standard_normal((32, 64)) * 0.1).astype(np.float32),
        "b": (rng.standard_normal((32,)) * 0.1).astype(np.float32),
    }
    ref = to_numpy(Executor("ideal", device=dev).run(flexible.program, env))
    ila = Executor("ila", device=dev)
    got = to_numpy(ila.run(flexible.program, env))

    err = np.linalg.norm(ref - got) / np.linalg.norm(ref)
    print(f"\nfp32 reference vs AdaptivFloat co-simulation: rel err {err:.2%}")
    for s in ila.stats:
        print(f"  invocation: {s.op} on {s.backend}: rel_err={s.rel_err:.2%} "
              f"range [{s.out_min:.2f}, {s.out_max:.2f}]")

    # 4. the hand-written kernel computes the same numerics
    kern = to_numpy(Executor("kernel", device=dev).run(flexible.program, env))
    same = np.array_equal(got, kern)
    print(f"kernel ({dev.type}) == ILA simulation:", same)
    return err, same


if __name__ == "__main__":
    main()
