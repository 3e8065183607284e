"""Table 2 of the paper on the port: simulation-based validation of the
IR-accelerator mappings.

    python -m repro_torch.launch.table2 [--device cuda] [--n-inputs 25] [--seed 0]

Relative Frobenius error of each target's ILA simulation against the fp32
reference over N random inputs per (accelerator, operation)
(``core.validate.validate_mappings``). The counterpart of
``benchmarks/table2_mapping_validation.py``; ``--n-inputs`` defaults to 25
as its ``REPRO_TABLE2_N`` does (the paper used 100).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

from .. import accel  # noqa: F401  (registers the bundled targets)
from ..core.validate import MappingValidation, validate_mappings

N_INPUTS = 25
#: (accelerator, operation) row -> the intrinsic whose declared ``tol``
#: bounds how far that row's error may move between two runs
TABLE2_INTRINSICS = {
    ("FlexASR", "LinearLayer"): "fasr_linear", ("FlexASR", "LSTM"): "fasr_lstm",
    ("FlexASR", "LayerNorm"): "fasr_layernorm", ("FlexASR", "MaxPool"): "fasr_maxpool",
    ("FlexASR", "MeanPool"): "fasr_meanpool", ("FlexASR", "Attention"): "fasr_attention",
    ("HLSCNN", "Conv2D"): "hlscnn_conv2d", ("VecUnit", "EwMul"): "veu_mul",
    ("VecUnit", "Sigmoid"): "veu_sigmoid", ("VTA", "GEMM"): "vta_gemm",
}


def main(argv: Optional[Sequence[str]] = None) -> List[MappingValidation]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--n-inputs", type=int, default=N_INPUTS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    rows = validate_mappings(n_inputs=args.n_inputs, seed=args.seed, device=args.device)
    dt = time.perf_counter() - t0
    print(f"\n== Table 2: mapping validation ({args.n_inputs} random inputs each) ==")
    print(f"{'Accelerator':12s} {'Operation':14s} {'Avg. Err.':>10s} {'Std. Dev.':>10s}")
    for r in rows:
        print(f"{r.accelerator:12s} {r.operation:14s} {r.avg_err:10.2%} {r.std_err:10.2%}")
    print(f"({dt:.2f} s)")
    return rows


if __name__ == "__main__":
    main()
