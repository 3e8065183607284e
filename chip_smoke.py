"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a host with one CUDA card (it exits non-zero
without one). Phases, one line each:

1. device    the card's name and power limit (nvidia-smi); TF32 is off
2. build     compile every CUDA kernel of the path from src/repro_torch/csrc
             (one nvcc per source, all started together); for each
             instantiation of flash_attention's wgmma source (head dim DP,
             T = 1 bf16 or 3 fp32 terms) the registers and spill bytes ptxas
             reports, whether it serialised the wgmmas (C7512) and the HGMMA
             instructions in its SASS (gate: > 0 in each), and for each
             kernel of af_gemm (quantize pass, product tiles), fx_gemm (16-
             and 4-byte copy paths) and int8_gemm
3. kernels   each kernel against its plain PyTorch version on the card, at the
             shapes the main path gives it (``torch.equal`` for the three
             GEMMs, af_gemm also with a per-sample weight bias on a shared
             weight; flash_attention at the eight shapes of the LM
             configs, the fp32 forward's S = 1055 and the smoke config's
             shape, each in fp32 (the wgmma3 design) within 2e-5 and in
             bf16 (the wgmma design) within one bf16 step of the plain
             output and within 3e-2, plus TinyLlama's shape in bf16 with q
             scaled by 8, which spreads P far below 1), and the FlexASR and
             VTA VT3 checks (ILA simulator vs kernel, worst deviation 0.0)
4. resmlp    the paper's Table-4 ResMLP row on FlexASR at the repository's
             configuration: teacher task, 600 training steps, flexible
             matching, then 40 points through the ideal, ILA (compiled),
             kernel and fused executors; af_gemm launches counted over that
             run; the three accelerator columns agree with the ideal logits
             within fasr_linear's tolerance and are bit-identical to each
             other on every point
5. resnet20, mobilenet_v2
             the two conv rows of Table 4 on FlexASR + HLSCNN through
             ``repro_torch.launch.table4`` (600 steps, 40 points), columns
             ideal, ila-8 (original), ila-16 (updated), fused-8 and fused-16;
             7 hlscnn + 1 flexasr offloads; each fused column launches
             fx_gemm once per conv per fused group and is bit-identical to
             the ila column of the same weight width; the original-vs-updated
             gap (the paper's finding) is reported, not gated
   determinism
             the ResNet-20 row's teacher task and training (600 steps, lr
             3e-3, seed 0) twice more: labels and every parameter equal to
             phase 5's (``torch.equal``), so two runs give the same Table-4
             accuracies
6. efficientnet
             on FlexASR + HLSCNN + VecUnit (6 vecunit, 4 hlscnn, 2 flexasr
             offloads), columns ideal, ila-16 and fused-16; fused is
             bit-identical to ila
7. vta       the ResMLP program (the parameters trained in phase 4) compiled
             onto VTA (7 vta_gemm, 4 vta_add, 2 vta_relu), columns ideal,
             ila and kernel; int8_gemm launches 7 times per point in the
             kernel column, which is bit-identical to ila
   validate  the paper's verification tasks on the card
             (``repro_torch.core.validate``): VT1 (4 ops), VT2 over every
             declared case of the four targets, Table 3 (3 exhaustive + 5
             randomized rows), Table 1 and Table 2 (25 inputs per row);
             VT3 through ``validate.vt3_results``, its af_gemm and int8_gemm
             launches counted as a path of their own ("vt3"). Gates: every
             VT1, VT2 and Table-3 verdict true, VT3 (True, 0.0) for both
             checks, each Table-2 row's error within its intrinsic's tol of
             the same rows run on the CPU
   lint      ``ilalint.lint_registry()``: the findings equal LINT_EXPECTED
             (FlexASR's five fn_start hazards and the targets' notes, which
             tests/test_torch_ilalint.py holds equal to the JAX reference's)
   campaign  the fault-injection acceptance campaign on the card (FlexASR,
             HLSCNN, VecUnit x identity, trunc_width, sat_wrap,
             round_floor, drop_cfg, stale_state; ResMLP; pipelined, 2
             devices per target, escalate, 24 points, 60 training steps).
             Gates: identity mutants undetected at every tier, identity
             null shifts exactly 0.0, flexasr:sat_wrap an app-only escape.
             Then the static configuration run serially and with 2 spawned
             workers on the card: equal matrix digests; and a sharded run
             with a crashing and a hanging mutant: recorded as crash and
             timeout (the hung worker terminated holding its CUDA
             context), the healthy mutants complete
8. timing    kernel, plain version, bound and (where one exists) the PyTorch
             library call at the main path's shapes (CUDA events around
             CUDA-graph replays, after a warm-up), and an empty kernel in
             the same harness: the launch floor, which every time is also
             given above; flash_attention at the TinyLlama prefill and Gemma
             shapes in bf16 (wgmma) and fp32 (wgmma3), at the fp32
             forward's S = 1055 and the smoke config's shape (so every
             main-path fp32 launch has a measured time) and at the
             Granite/Qwen3 shape in bf16, each
             with the bound with P.V at the fp32 rate (fp32 inputs: both
             products), the split bound (Q.K^T and P.V as exact bf16
             products on the tensor cores: 4 GEMM-equivalents for bf16, 12
             for fp32's six pairs each; the least time, which the kernel
             line gives) and scaled_dot_product_attention; int8_gemm also at
             128^3 against torch._int_mm; the CUDA launches one call of each
             GEMM and of each flash_attention design makes and each
             launch's device time (torch.profiler), the counts gated
             against the wrappers' declared ones
9. profile   the device's busy share over one fused-engine minibatch of the
             ResMLP row and of the ResNet-20 row (torch.profiler)
10. lm_serve TinyLlama-1.1B at full width (22 layers, d_model 2048, 32/4
             heads, vocab 32000), bf16 weights from a seeded generator on the
             card: ``launch.serve.generate`` serves 4 prompts of 1024 tokens
             and 32 generated tokens after a warm-up; prefill seconds, decode
             ms/step, tokens/s, and the busy share of a prefill and of 8
             decode steps (torch.profiler). Gates: 22 flash_attention launches
             in prefill, all of the wgmma design, and 0 in decode, ids
             within the vocabulary, finite logits
11. lm_consistency
             the same weights cast to fp32: ``forward`` over prompt +
             generated tokens (the kernel's wgmma3 design) against prefill
             + decode (kernel prefill, plain decode) at the generated
             positions; max relative deviation below 2e-2
             (tests/test_models.py's bound); all 2 x 22 launches wgmma3
12. lm_cpu_parity
             the TinyLlama smoke config on identical seeded fp32 weights on
             the card (kernel) and on the CPU (plain version): last-position
             prefill logits within rtol = atol = 1e-4

Every count of kernel launches is set to 0 just before a path runs and read
just after it. Then one JSON line with an entry per kernel and per design of
flash_attention (``{"kernels": [...]}``; each entry also gives its CUDA
launches per call, its time above the launch floor and its launches per
path: "table4" for phases 4-7, "vt3", "lm" for phases 10-12), the
card's nvidia-smi line and, last, the result line ``{"ok": true, "device":
{...}}``. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published H100 SXM peaks (NVIDIA data sheet): dense bf16 on the tensor
#: cores, float32 outside them, int8 on the tensor cores, and HBM3
#: bandwidth. An AF(8,3) value has 5 significant bits, so af_gemm's
#: quantized operands and their products are exact in bf16 and the bf16
#: rate is the fastest rate at which the same products can run; fx_gemm
#: takes float32 operands, int8_gemm int8 ones.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

#: flash_attention against its plain version: tests/test_kernels.py's
#: tolerances (fp32 sums in another order; a few bf16 steps of outputs near 1)
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
#: and, in bf16, elementwise |got - want| <= 2e-5 + 2^-7 |want|: both round
#: the same fp32 function to nearest even, so they differ by at most one
#: bf16 step (2^-7 of |want| at most) over the fp32 sums' own difference
FLASH_BF16_STEP = 2.0 ** -7
#: the LM serving path: TinyLlama-1.1B, 4 prompts of 1024 tokens, 32 more
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "tinyllama_1_1b", 4, 1024, 32
#: fp32 forward vs prefill + decode (tests/test_models.py:60); card vs CPU
LM_CONSISTENCY_TOL, LM_CPU_TOL = 2e-2, 1e-4

N_EVAL = 40
TRAIN_STEPS = 600
#: fasr_linear's declared tolerance (Intrinsic.tol)
LINEAR_TOL = 0.08
#: Table 2's inputs per row (benchmarks/table2_mapping_validation.py's default)
TABLE2_N = 25
#: lint_registry()'s findings as (severity, pass, target, subject) on the
#: bundled targets; tests/test_torch_ilalint.py holds them equal to the
#: port's CPU run and that to the JAX reference's
LINT_EXPECTED = frozenset({
    *(("warn", "hazard", "flexasr", f"fn_start/{r}")
      for r in ("act_mode", "is_bias", "pe_b", "pe_w", "pe_wh")),
    ("note", "hazard", "flexasr", "c_state,h_state"),
    ("note", "hazard", "flexasr", "act_mode,base_aux,base_in,base_out,exp_bias_a,exp_bias_o,"
     "exp_bias_w,is_bias,mode,num_aux,num_in,num_out,num_ts"),
    ("note", "range", "flexasr", "adaptivfloat8"),
    ("note", "hazard", "hlscnn", "in_c,in_h,in_w,k_h,k_w,out_k,wgt_bits"),
    ("note", "hazard", "vecunit", "exp_a,exp_b,exp_o,mode,n_cols,n_rows"),
})
#: the acceptance campaign (tests/test_fault_campaign.py's fixture)
CAMPAIGN = dict(
    targets=("flexasr", "hlscnn", "vecunit"),
    faults=("identity", "trunc_width", "sat_wrap", "round_floor", "drop_cfg", "stale_state"),
    apps=("resmlp",), engine="pipelined", devices_per_target=2, ladder="escalate",
    n_eval=24, train_steps=60, op_samples=1, vt2_n=2,
)
#: a crashing and a hanging mutant among two healthy ones
#: (tests/test_campaign_shard.py), and the per-mutant deadline there
CAMPAIGN_ROUGH = dict(
    targets=("vecunit",), faults=("identity", "drop_cfg", "crash_inject", "hang_inject"),
    apps=(), engine="compiled", devices_per_target=1, op_samples=1, vt2_n=2, seed=0,
    stat_calib_seeds=0,
)
CAMPAIGN_TIMEOUT_S = 15.0
#: the static-tier configuration (tests/test_campaign_static.py), run serially
#: and sharded over spawned workers
CAMPAIGN_STATIC = dict(
    targets=("vecunit", "hlscnn"), faults=("identity", "decode_alias", "cmd_reorder", "drop_cfg"),
    apps=(), engine="compiled", devices_per_target=1, ladder="escalate", op_samples=1,
    stat_calib_seeds=0, seed=0,
)


def entry_resources(ptxas: str) -> dict:
    """Per kernel entry in a ``-Xptxas -v`` report: (registers, spill store
    + load bytes), keyed by the kernel's name and template arguments."""
    out = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads.*?Used (\d+) registers", ptxas, re.S):
        # the mangled name's last length-prefixed part, then its template args
        rest, name = m.group(1).removeprefix("_ZN"), m.group(1)
        while (n := re.match(r"\d+", rest)):
            name, rest = rest[n.end():n.end() + int(n.group())], rest[n.end() + int(n.group()):]
        args = re.findall(r"L[ib](\d+)E", rest.split("EEv")[0]) if rest.startswith("I") else []
        out[name + (f"<{','.join(args)}>" if args else "")] = (
            int(m.group(4)), int(m.group(2)) + int(m.group(3)))
    return out


def kernel_label(name: str) -> str:
    """A profiler's kernel name cut to the kernel and its template
    arguments (``af_product_kernel<32,32>``)."""
    m = re.search(r"(\w+_kernel)(<[^>]*>)?", name)
    return (m.group(1) + (m.group(2) or "").replace(" ", "")) if m else name[:32]


def phase(label: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{label}] {body}", flush=True)


def main() -> int:
    import copy
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch import device as devmod
    from repro_torch.accel import flexasr as fa, numerics, vta
    from repro_torch.core import apps, campaign, cosim, ilalint, ir, validate
    from repro_torch.core.ila import TARGETS
    from repro_torch.core.codegen import Executor
    from repro_torch.core.compile import compile_program
    from repro_torch.kernels import (
        af_gemm as kaf, build, flash_attention as kfa, fx_gemm as kfx, int8_gemm as ki8, ref,
    )
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.af_gemm import af_gemm
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fx_gemm import fx_gemm
    from repro_torch.kernels.int8_gemm import int8_gemm
    from repro_torch.launch import table1, table2, table3, table4
    from repro_torch.launch.serve import generate
    from repro_torch.models import api as lm_api

    report = {}
    dev = devmod.resolve("cuda")
    wrappers = {"af_gemm": af_gemm, "fx_gemm": fx_gemm, "int8_gemm": int8_gemm,
                "flash_attention": flash_attention}
    designs = sorted(flash_attention.launches_by_design)   # wgmma, wgmma3
    #: per kernel (flash_attention in all and per design, "flash_attention:
    #: wgmma"), launches summed over every main-path run (read per path)
    path_launches = {name: 0 for name in list(wrappers) + [f"flash_attention:{d}"
                                                           for d in designs]}
    #: the same launches per path: "table4" (phases 4-7), "vt3", "lm" (10-12)
    launches_by_path = {name: {} for name in path_launches}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0
        kfa.reset_launches()

    def read_counts(path="table4"):
        counts = {name: w.launches for name, w in wrappers.items()}
        counts.update({f"flash_attention:{d}": n
                       for d, n in flash_attention.launches_by_design.items()})
        for name, n in counts.items():
            path_launches[name] += n
            launches_by_path[name][path] = launches_by_path[name].get(path, 0) + n
        return counts

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    assert devmod.tf32_off(), "TF32 must be off"
    phase("device", name=torch.cuda.get_device_name(0).replace(" ", "_"),
          count=torch.cuda.device_count(), tf32_off=True, torch=torch.__version__,
          cuda=torch.version.cuda)
    report["nvidia_smi"] = smi

    # 2. build ---------------------------------------------------------------
    secs = build.build()
    # the wgmma source, per instantiation <DP, T> (padded head dim, bf16 terms
    # per operand: 1 for bf16, 3 for fp32): ptxas's registers and spill
    # bytes, whether it serialised the wgmmas (C7512), and the tensor-core
    # instructions in its SASS
    sm90 = build.PTXAS_REPORT.get("flash_attention_sm90", "")
    serialized = {f"<{d},{t}>" for d, t in re.findall(
        r"serialized[^\n]*flash_wgmma_kernelILi(\d+)ELi(\d+)E", sm90)}
    hgmma, fn = {}, None
    for ln in build.sass("flash_attention_sm90").splitlines():
        if (m := re.search(r"Function : \S*flash_wgmma_kernelILi(\d+)ELi(\d+)E", ln)):
            fn = f"<{m.group(1)},{m.group(2)}>"
            hgmma[fn] = 0
        elif "Function :" in ln:
            fn = None
        elif fn is not None and "HGMMA" in ln:
            hgmma[fn] += 1
    wgmma_build = {
        inst: {"registers": r, "spill_bytes": b, "serialized": inst in serialized,
               "hgmma": hgmma.get(inst, 0)}
        for name, (r, b) in entry_resources(sm90).items()
        if name.startswith("flash_wgmma_kernel") and (inst := name[len("flash_wgmma_kernel"):])}
    gemm_build = {k: entry_resources(build.PTXAS_REPORT.get(k, ""))
                  for k in ("af_gemm", "fx_gemm", "int8_gemm", "flash_attention_sm90")}
    phase("build", **{k: f"{v:.1f}s" for k, v in secs.items()},
          wgmma="/".join(f"{i}:{v['registers']}r,{v['spill_bytes']}sp,"
                         f"{'ser' if v['serialized'] else 'noser'},{v['hgmma']}hgmma"
                         for i, v in sorted(wgmma_build.items())) or "cached",
          **{f"{k}_regs_spill": ",".join(f"{n}:{r}/{b}" for n, (r, b) in v.items()
                                         if not n.startswith("flash_wgmma")) or "cached"
             for k, v in gemm_build.items()})
    report["build_s"] = secs
    report["ptxas"] = build.PTXAS_REPORT
    report["wgmma_build"] = wgmma_build
    report["gemm_build"] = gemm_build
    if len(hgmma) != 8 or min(hgmma.values()) <= 0:
        raise AssertionError(f"HGMMA instructions per wgmma instantiation: {hgmma}")

    # 3. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(1)
    spec = ref.AF83
    act = numerics.HLSCNN_ACT
    wspecs = {16: numerics.HLSCNN_WEIGHT_UPDATED, 8: numerics.HLSCNN_WEIGHT_ORIGINAL}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def linear_case(m, n, k):
        x = t(rng.standard_normal((m, k)))
        w = t(rng.standard_normal((n, k)) * 0.1)
        b = t(rng.standard_normal((n,)) * 0.1)
        bx, bw = numerics.af_exp_bias(x, spec), numerics.af_exp_bias(w, spec)
        bo = numerics.af_exp_bias(x @ w.T + b, spec)
        return (x, w, b, bx, bw, bo)

    def fused_case(B):
        x = t(rng.standard_normal((B, 128, 128)))
        w = t(rng.standard_normal((256, 128)) * 0.1)
        b = t(rng.standard_normal((256,)) * 0.1)
        bx = t(rng.integers(-7, -4, B))
        bo = t(rng.integers(-5, -2, B))
        return (x, w, b, bx, numerics.af_exp_bias(w, spec), bo)

    def per_sample_case(B, m, n, k):
        """A shared (N, K) weight with per-sample x, weight and output
        biases: the kernel quantizes one copy of the weight per sample."""
        x = t(rng.standard_normal((B, m, k)) * rng.choice([0.1, 1.0, 8.0], (B, 1, 1)))
        w = t(rng.standard_normal((n, k)) * 0.1)
        b = t(rng.standard_normal((n,)) * 0.1)
        bx = torch.stack([numerics.af_exp_bias(x[i], spec) for i in range(B)])
        bo = torch.stack([numerics.af_exp_bias(x[i] @ w.T + b, spec) for i in range(B)])
        return (x, w, b, bx, bx - 3, bo)

    def fx_case(B, m, n, k):
        return (t(rng.standard_normal((B, m, k)) * 4), t(rng.standard_normal((n, k)) * 0.1))

    def i8_case(m, n, k):
        return tuple(torch.from_numpy(rng.integers(-128, 128, s).astype(np.int8)).to(dev)
                     for s in ((m, k), (n, k)))

    af_shapes = {
        "test_16x32x64": linear_case(16, 32, 64),
        "test_128x128x128": linear_case(128, 128, 128),
        "test_100x50x200": linear_case(100, 50, 200),
        # ResMLP kernel mode: (M, N, K) of its four linear shapes
        "resmlp_tok_64x16x16": linear_case(64, 16, 16),
        "resmlp_fc1_16x128x64": linear_case(16, 128, 64),
        "resmlp_fc2_16x64x128": linear_case(16, 64, 128),
        "resmlp_head_1x10x64": linear_case(1, 10, 64),
        # the fused engine's groups: one pipeline chunk (8) per launch
        "fused_8x128x256x128": fused_case(8),
        "fused_16x128x256x128": fused_case(16),
        # per-sample weight biases on a shared weight, at B == N and B != N
        "per_sample_w_4x16x4x64": per_sample_case(4, 16, 4, 64),
        "per_sample_w_3x16x128x64": per_sample_case(3, 16, 128, 64),
    }
    # (B, M, N, K): the fused HLSCNN conv groups (im2col patches of a
    # 16x16x32 activation image against the 5x5x32x32 weight), then ragged
    fx_shapes = {f"{name}_w{bits}": (fx_case(*shape), bits)
                 for name, shape in (("fused_8x144x32x800", (8, 144, 32, 800)),
                                     ("fused_16x144x32x800", (16, 144, 32, 800)),
                                     ("ragged_1x7x5x3", (1, 7, 5, 3)),
                                     ("ragged_3x33x17x70", (3, 33, 17, 70)),
                                     ("ragged_2x144x32x75", (2, 144, 32, 75)))
                 for bits in (16, 8)}
    i8_shapes = {
        # ResMLP on VTA in kernel mode: (M, N, K) of its four GEMM shapes
        "vta_tok_64x16x16": i8_case(64, 16, 16),
        "vta_fc1_16x128x64": i8_case(16, 128, 64),
        "vta_fc2_16x64x128": i8_case(16, 64, 128),
        "vta_head_1x10x64": i8_case(1, 10, 64),
        # the VTA VT3 check's GEMM (validate.vt3_results)
        "vt3_24x20x48": i8_case(24, 20, 48),
        # tests/test_kernels.py: (M, N, K)
        "test_1x3x7": i8_case(1, 3, 7),
        "test_128x128x128": i8_case(128, 128, 128),
        "test_200x300x150": i8_case(200, 300, 150),
    }

    def fx_kernel(args, bits):
        return fx_gemm(*args, x_spec=act, w_spec=wspecs[bits], o_spec=act)

    def fx_plain(args, bits):
        return ref.fx_gemm_ref(*args, act, wspecs[bits], act)

    checks = {
        "af_gemm": [(n, lambda a=a: af_gemm(*a, spec=spec), lambda a=a: ref.af_gemm_ref(*a, spec))
                    for n, a in af_shapes.items()],
        "fx_gemm": [(n, lambda a=a, b=b: fx_kernel(a, b), lambda a=a, b=b: fx_plain(a, b))
                    for n, (a, b) in fx_shapes.items()],
        "int8_gemm": [(n, lambda a=a: int8_gemm(*a), lambda a=a: ref.int8_gemm_ref(*a))
                      for n, a in i8_shapes.items()],
    }
    worst_kernel = {}
    mismatched = []
    for kname, cases in checks.items():
        worst_kernel[kname] = 0.0
        for name, kern, plain in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
            worst_kernel[kname] = max(worst_kernel[kname], err)
            if not torch.equal(got, want):
                mismatched.append(f"{kname}:{name}")
    # (B, Hq, Hkv, S, Sk, D, causal), each in bf16 and in fp32 on the same
    # values: q, k, v made (B, S, H, D) as the models hold them and passed as
    # (B, H, S, D) views
    flash_shapes = {
        "tinyllama_prefill": (4, 32, 4, 1024, 1024, 64, True),
        # phase 11's fp32 forward over prompt + generated tokens, and phase
        # 12's smoke config
        "tinyllama_forward": (4, 32, 4, 1055, 1055, 64, True),
        "tinyllama_smoke": (4, 4, 2, 96, 96, 16, True),
        "ragged_prompt": (4, 32, 4, 1000, 1000, 64, True),
        "whisper_encoder": (1, 8, 8, 1500, 1500, 64, False),
        "whisper_cross": (1, 8, 8, 32, 1500, 64, False),
        "granite_qwen3": (1, 32, 8, 512, 512, 128, True),
        "zamba2": (1, 32, 32, 512, 512, 112, True),
        "gemma": (1, 16, 16, 512, 512, 256, True),
        "mla_v_padded": (1, 16, 16, 256, 256, 192, True),
    }
    flash_cases = {}
    for name, (B, Hq, Hkv, S, Sk, D, causal) in flash_shapes.items():
        qkv = [t(rng.standard_normal(shape))
               for shape in ((B, S, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]
        for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            flash_cases[f"{name}_{tag}"] = tuple(a.to(dtype).transpose(1, 2) for a in qkv), causal
        if name == "tinyllama_prefill":
            # q scaled by 8: most of P lies far below 1, where mid and lo count
            qkv[0] = qkv[0] * 8
            flash_cases["tinyllama_spread_bf16"] = (
                tuple(a.bfloat16().transpose(1, 2) for a in qkv), causal)
    flash_err, flash_design = {}, {}
    for name, (args, causal) in flash_cases.items():
        before = dict(flash_attention.launches_by_design)
        got = flash_attention(*args, causal=causal).float()
        want = ref.flash_attention_ref(*args, causal=causal).float()
        torch.cuda.synchronize()
        flash_design[name] = next(d for d, n in flash_attention.launches_by_design.items()
                                  if n > before[d])
        err = (got - want).abs()
        flash_err[name] = float(err.max())
        limit = FLASH_ATOL[str(args[0].dtype).removeprefix("torch.")]
        if args[0].dtype == torch.bfloat16:
            limit = (FLASH_ATOL["float32"] + FLASH_BF16_STEP * want.abs()).clamp(max=limit)
        if not bool((err <= limit).all()):
            mismatched.append(f"flash_attention:{name}")
    if any(flash_design[n] != kfa.DESIGNS[a[0].dtype] for n, (a, _) in flash_cases.items()):
        mismatched.append(f"flash_attention designs {flash_design}")
    for d in designs:
        worst_kernel[f"flash_attention:{d}"] = max(
            (e for n, e in flash_err.items() if flash_design[n] == d), default=0.0)
    report["flash_attention_err"] = flash_err
    report["flash_attention_design"] = flash_design
    _, vt3_fasr = fa._vt3_linear(device=dev)
    _, vt3_vta = vta._vt3_gemm(device=dev)
    n_checked = sum(len(c) for c in checks.values()) + len(flash_cases)
    phase("kernels", shapes=n_checked, within_tolerance=n_checked - len(mismatched),
          **{f"{k.replace(':', '_')}_max_abs_err": v for k, v in worst_kernel.items()},
          vt3_flexasr=vt3_fasr, vt3_vta=vt3_vta)
    report["kernel_mismatches"] = mismatched
    report["vt3"] = {"flexasr": vt3_fasr, "vta": vt3_vta}
    if mismatched or vt3_fasr != 0.0 or vt3_vta != 0.0:
        raise AssertionError(f"kernels disagree with their plain versions: {mismatched}, "
                             f"vt3 flexasr {vt3_fasr} vta {vt3_vta}")

    # 4. the ResMLP Table-4 row --------------------------------------------
    t0 = time.perf_counter()
    builder = lambda seed=0: apps.build_resmlp(seed=seed, layers=2)
    expr, params = builder()
    X, y = cosim.make_teacher_task(builder, (16, 64), n=512, device=dev)
    trained = cosim.train_app(expr, params, X, y, steps=TRAIN_STEPS, lr=3e-3, device=dev)
    res = compile_program(expr, targets=("flexasr",), flexible=True)
    setup_s = time.perf_counter() - t0
    executors = {
        "ideal": Executor("ideal", device=dev),
        "ila": Executor("ila", device=dev),
        "kernel": Executor("kernel", device=dev),
        "fused": Executor("ila", engine="fused", device=dev),
    }
    chunk = executors["fused"].pipeline_chunk
    batch = cosim._pipeline_batch(executors["fused"], 16)
    # fused groups over N_EVAL points: one per pipeline chunk of a minibatch
    groups = sum(-(-min(batch, N_EVAL - i) // chunk) for i in range(0, N_EVAL, batch))
    rows = {}
    for name, ex in executors.items():
        zero_counts()
        acc, sec = cosim.eval_classification(res.program, trained, X, y, ex, N_EVAL)
        torch.cuda.synchronize()
        rows[name] = {"accuracy": acc, "s_per_point": sec, "launches": read_counts()}
    phase("resmlp", offloads=res.accelerator_calls["flexasr"], setup_s=f"{setup_s:.1f}",
          **{f"{k}_acc": f"{v['accuracy']:.3f}" for k, v in rows.items()},
          **{f"{k}_s_per_pt": f"{v['s_per_point']:.4f}" for k, v in rows.items()},
          **{f"{k}_launches": v["launches"]["af_gemm"] for k, v in rows.items()})
    # one launch per linear per point in kernel mode; one per fused linear
    # group (a pipeline chunk of one minibatch) in the fused engine
    n_linear = 7
    expected = {"ideal": 0, "ila": 0, "kernel": n_linear * N_EVAL, "fused": n_linear * groups}
    for name, want in expected.items():
        if rows[name]["launches"]["af_gemm"] != want:
            raise AssertionError(f"{name} launched {rows[name]['launches']['af_gemm']}"
                                 f" af_gemm kernels, expected {want}")
    logits = {
        name: np.stack([o.reshape(-1) for o in cosim.eval_outputs(
            res.program, trained, lambda i: X[i], range(N_EVAL), ex)])
        for name, ex in executors.items()
    }
    ideal = logits["ideal"]
    scale = np.abs(ideal).max(axis=1)
    worst = {n: float((np.abs(logits[n] - ideal).max(axis=1) / scale).max())
             for n in ("ila", "kernel", "fused")}
    identical = int(sum(
        np.array_equal(logits["ila"][i], logits["kernel"][i])
        and np.array_equal(logits["ila"][i], logits["fused"][i])
        for i in range(N_EVAL)))
    finite = all(np.isfinite(v).all() and v.shape == (N_EVAL, 10) for v in logits.values())
    phase("resmlp_parity", points=N_EVAL, bit_identical=identical, finite=finite,
          **{f"{k}_rel_dev": f"{v:.4f}" for k, v in worst.items()})
    report["resmlp"] = {"rows": rows, "rel_dev": worst, "bit_identical": identical,
                        "setup_s": setup_s, "offloads": res.accelerator_calls}
    if not finite or max(worst.values()) > LINEAR_TOL:
        raise AssertionError(f"ResMLP logits off the ideal by {worst}")
    # the three accelerator columns compute the same AF lattice function
    if identical != N_EVAL:
        raise AssertionError(f"only {identical}/{N_EVAL} points bit-identical across "
                             "ila, kernel and fused")

    # 5-7. the conv rows, EfficientNet and ResMLP on VTA --------------------
    def run_app(key, columns, offloads, pairs, fx_per_group=0, i8_per_point=0,
                params=None):
        """Drive one application through ``columns``; check offloads, launch
        counts, finite logits and bit-identity of each (a, b) in ``pairs``."""
        prep = table4.prepare(table4.APPS[key], dev, TRAIN_STEPS, params=params)
        ops = [x.op for x in ir.postorder(prep.program) if isinstance(x, ir.Call)]
        got_offloads = {op: ops.count(op) for op in offloads}
        if got_offloads != offloads:
            raise AssertionError(f"{key}: offloads {got_offloads}, expected {offloads}")
        cols, outs = {}, {}
        for col in columns:
            ex = table4.executor(col, dev)
            zero_counts()
            acc, sec = table4.evaluate(prep, ex, N_EVAL)
            torch.cuda.synchronize()
            cols[col] = {"accuracy": acc, "s_per_point": sec, "launches": read_counts()}
            outs[col] = table4.logits(prep, ex, N_EVAL)
            fx_want = fx_per_group * groups if col.startswith("fused") else 0
            i8_want = i8_per_point * N_EVAL if col == "kernel" else 0
            got = cols[col]["launches"]
            if got["fx_gemm"] != fx_want or got["int8_gemm"] != i8_want:
                raise AssertionError(f"{key}:{col} launched {got}, expected fx_gemm "
                                     f"{fx_want} and int8_gemm {i8_want}")
        ideal = outs["ideal"]
        scale = np.abs(ideal).max(axis=1)
        rel_dev = {c: float((np.abs(o - ideal).max(axis=1) / scale).max())
                   for c, o in outs.items() if c != "ideal"}
        same = {f"{a}=={b}": int(sum(np.array_equal(outs[a][i], outs[b][i])
                                     for i in range(N_EVAL))) for a, b in pairs}
        finite = all(np.isfinite(o).all() and o.shape == (N_EVAL, 10) for o in outs.values())
        phase(key, offloads=prep.offloads, setup_s=f"{prep.setup_s:.1f}",
              **{f"{c}_acc": f"{v['accuracy']:.3f}" for c, v in cols.items()},
              **{f"{c}_s_per_pt": f"{v['s_per_point']:.4f}" for c, v in cols.items()},
              **{f"{c}_launches": "/".join(str(n) for n in v["launches"].values())
                 for c, v in cols.items()},
              bit_identical=same, finite=finite)
        report[key] = {"columns": cols, "rel_dev": rel_dev, "bit_identical": same,
                       "setup_s": prep.setup_s, "offloads": prep.offloads,
                       "finite": finite}
        if not finite:
            raise AssertionError(f"{key}: non-finite or misshapen logits")
        if any(n != N_EVAL for n in same.values()):
            raise AssertionError(f"{key}: columns not bit-identical on every point: {same}")
        return prep, cols

    conv_cols = ("ideal", "ila-8", "ila-16", "fused-8", "fused-16")
    conv_pairs = (("ila-8", "fused-8"), ("ila-16", "fused-16"))
    finding = {}
    for key in ("resnet20", "mobilenet_v2"):
        prep, cols = run_app(key, conv_cols, {"hlscnn_conv2d": 7, "fasr_linear": 1},
                             conv_pairs, fx_per_group=7)
        finding[key] = {"reference": cols["ideal"]["accuracy"],
                        "original": cols["ila-8"]["accuracy"],
                        "updated": cols["ila-16"]["accuracy"]}
        if key == "resnet20":
            resnet_prep = prep
    phase("table4_finding", **{k: "ref={reference:.3f}/orig={original:.3f}/upd={updated:.3f}"
                               .format(**v) for k, v in finding.items()})
    report["table4_finding"] = finding

    # training on the card is deterministic: the ResNet-20 row's teacher task
    # and training (its own configuration: 600 steps, lr 3e-3, seed 0) twice
    # more, each equal to phase 5's bit for bit; train_app leaves the global
    # settings as it found them
    app = table4.APPS["resnet20"]
    expr_r, init_r = app.builder()
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    same, train_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        Xr, yr = cosim.make_teacher_task(app.builder, app.input_shape, n=table4.N_TRAIN,
                                         device=dev)
        again = cosim.train_app(expr_r, init_r, Xr, yr, steps=TRAIN_STEPS, lr=table4.LR,
                                device=dev)
        train_s.append(time.perf_counter() - t0)
        same.append(np.array_equal(Xr, resnet_prep.X) and np.array_equal(yr, resnet_prep.y)
                    and set(again) == set(resnet_prep.params)
                    and all(torch.equal(torch.from_numpy(again[k]),
                                        torch.from_numpy(resnet_prep.params[k]))
                            for k in again))
    restored = flags == (torch.are_deterministic_algorithms_enabled(),
                         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    phase("determinism", row="resnet20", steps=TRAIN_STEPS, lr=table4.LR, trainings=3,
          params_equal="/".join(map(str, same)), flags_restored=restored,
          train_s="/".join(f"{x:.2f}" for x in train_s))
    report["determinism"] = {"equal": same, "flags_restored": restored, "train_s": train_s}
    if not all(same) or not restored:
        raise AssertionError(f"ResNet-20 training not reproducible on the card: equal {same}, "
                             f"settings restored {restored}")
    run_app("efficientnet", ("ideal", "ila-16", "fused-16"),
            {"veu_mul": 3, "veu_sigmoid": 3, "hlscnn_conv2d": 4, "fasr_linear": 2},
            (("ila-16", "fused-16"),), fx_per_group=4)
    run_app("resmlp_vta", ("ideal", "ila", "kernel"),
            {"vta_gemm": 7, "vta_add": 4, "vta_relu": 2}, (("ila", "kernel"),),
            i8_per_point=7, params=trained)

    # validate: VT1-VT3, Tables 1-3 on the card --------------------------------
    secs = {}
    t0 = time.perf_counter()
    vt1 = {op: validate.vt1_check(op, device=dev) for op in validate.VT1_CASES}
    vt2 = {f"{c.name}": validate.vt2_check(c, device=dev) for c in validate.vt2_cases()}
    secs["vt1_vt2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    t3 = table3.run(device=dev)
    secs["table3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    t1 = table1.run(device=dev)
    secs["table1"] = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    vt3 = validate.vt3_results(device=dev)
    torch.cuda.synchronize()
    secs["vt3"] = time.perf_counter() - t0
    vt3_counts = read_counts("vt3")
    t0 = time.perf_counter()
    t2 = validate.validate_mappings(n_inputs=TABLE2_N, device=dev)
    secs["table2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    t2_cpu = validate.validate_mappings(n_inputs=TABLE2_N, device="cpu")
    secs["table2_cpu"] = time.perf_counter() - t0
    t2_dev = {}
    for r, c in zip(t2, t2_cpu):
        (tgt,) = [x for x in TARGETS.all() if x.display_name == r.accelerator]
        tol = tgt.intrinsics[table2.TABLE2_INTRINSICS[(r.accelerator, r.operation)]].tol
        t2_dev[f"{r.accelerator}/{r.operation}"] = (r.avg_err, c.avg_err, tol)
    phase("validate", vt1=sum(vt1.values()), vt1_of=len(vt1), vt2=sum(vt2.values()),
          vt2_of=len(vt2), table3="/".join(f"{'%dx%d' % r['dim']}:{r['ok']}:{r['count']}:"
                                           f"{r['seconds']:.2f}s" for r in t3),
          vt3={f"{k}:{c}": v for k, cs in vt3.items() for c, v in cs.items()},
          vt3_af_gemm_launches=vt3_counts["af_gemm"],
          vt3_int8_gemm_launches=vt3_counts["int8_gemm"],
          **{f"{k}_s": f"{v:.2f}" for k, v in secs.items()})
    for r in t1:
        phase("table1", app=r["application"],
              **{k: "%d/%d" % v for k, v in r["cells"].items()}, saturated=r["saturated"])
    for key, (card, cpu, tol) in t2_dev.items():
        phase("table2", row=key, n=TABLE2_N, avg_err_card=f"{card:.6f}",
              avg_err_cpu=f"{cpu:.6f}", tol=tol)
    report["validate"] = {
        "vt1": vt1, "vt2": vt2, "vt3": vt3, "vt3_launches": vt3_counts, "table1": t1,
        "table2": [dataclasses.asdict(r) for r in t2],
        "table2_cpu": [dataclasses.asdict(r) for r in t2_cpu], "table3": t3, "seconds": secs}
    vt3_ok = all(v == (True, 0.0) for cs in vt3.values() for v in cs.values()) \
        and len([v for cs in vt3.values() for v in cs.values()]) == 2
    t2_bad = {k: v for k, v in t2_dev.items() if abs(v[0] - v[1]) > v[2]}
    if not (all(vt1.values()) and all(vt2.values()) and all(r["ok"] for r in t3)
            and len(t3) == 8 and vt3_ok and not t2_bad
            and [(r.accelerator, r.operation) for r in t2] == list(table2.TABLE2_INTRINSICS)):
        raise AssertionError(f"validate: vt1 {vt1} vt2 {vt2} table3 {t3} vt3 {vt3} "
                             f"table2 card vs cpu outside tol: {t2_bad}")
    if vt3_counts["af_gemm"] <= 0 or vt3_counts["int8_gemm"] <= 0:
        raise AssertionError(f"VT3 did not launch af_gemm and int8_gemm: {vt3_counts}")

    # lint: the static verifier ----------------------------------------------
    t0 = time.perf_counter()
    findings = ilalint.lint_registry()
    lint_s = time.perf_counter() - t0
    got_lint = {(f.severity, f.pass_name, f.target, f.subject)
                for fs in findings.values() for f in fs}
    phase("lint", targets=len(findings), findings=sum(f[0] != "note" for f in got_lint),
          notes=sum(f[0] == "note" for f in got_lint), equal_expected=got_lint == LINT_EXPECTED,
          seconds=f"{lint_s:.2f}")
    report["lint"] = {"findings": sorted(got_lint), "seconds": lint_s}
    if got_lint != LINT_EXPECTED:
        raise AssertionError(f"lint findings differ: extra {got_lint - LINT_EXPECTED}, "
                             f"missing {LINT_EXPECTED - got_lint}")

    # campaign: the fault-injection acceptance campaign, then sharded ------------
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    ck = out_dir / "chip_smoke_campaign.json"
    ck.unlink(missing_ok=True)
    accept = campaign.run_campaign(device=dev, checkpoint=str(ck), **CAMPAIGN)
    idents = [m for m in accept.reports if m.fault == "identity"]
    ident_clean = len(idents) == 3 and all(
        m.detected_at is None and all(t.detected in (False, None) for t in m.tiers.values())
        for m in idents)
    nulls = accept.stat_calibration["null_shifts"]
    app_only = [m.key for m in accept.reports if m.app_only]
    digest = campaign.matrix_digest(accept)
    phase("campaign", mutants=len(accept.reports), seconds=f"{accept.seconds:.2f}",
          mutants_per_s=f"{accept.mutants_per_sec:.3f}", digest=digest[:16],
          identity_clean=ident_clean, null_shifts=nulls, app_only=",".join(app_only),
          first_detection=accept.summary()["first_detection_by_tier"])
    print(campaign.format_matrix(accept), flush=True)
    report["campaign"] = {"result": accept.to_json(), "digest": digest}
    if not ident_clean or not nulls or any(v != 0.0 for vs in nulls.values() for v in vs) \
            or "flexasr:sat_wrap@write_v" not in app_only:
        raise AssertionError(f"campaign gates: identity clean {ident_clean}, null shifts "
                             f"{nulls}, app-only escapes {app_only}")
    t0 = time.perf_counter()
    serial = campaign.run_campaign(device=dev, **CAMPAIGN_STATIC)
    serial_s = time.perf_counter() - t0
    ck = out_dir / "chip_smoke_campaign_sharded.json"
    ck.unlink(missing_ok=True)
    t0 = time.perf_counter()
    sharded = campaign.run_campaign_sharded(workers=2, mutant_timeout=300.0,
                                            checkpoint=str(ck), device=dev, **CAMPAIGN_STATIC)
    sharded_s = time.perf_counter() - t0
    same = campaign.matrix_digest(serial) == campaign.matrix_digest(sharded)
    phase("campaign_sharded", mutants=len(sharded.reports), workers=2,
          serial_s=f"{serial_s:.2f}", sharded_s=f"{sharded_s:.2f}",
          digest=campaign.matrix_digest(sharded)[:16], digest_equal_serial=same,
          outcomes="/".join(sorted({r.outcome for r in sharded.reports})))
    report["campaign_sharded"] = {"serial_s": serial_s, "sharded_s": sharded_s,
                                  "digest_equal": same}
    if not same or any(r.outcome != "ok" for r in sharded.reports):
        raise AssertionError("sharded campaign digest differs from the serial run's")
    # a worker that raises and one that hangs holding its CUDA context: the
    # parent terminates the hung worker at the deadline, and the campaign
    # completes the other mutants on the remaining and respawned workers
    t0 = time.perf_counter()
    rough = campaign.run_campaign_sharded(workers=2, mutant_timeout=CAMPAIGN_TIMEOUT_S,
                                          device=dev, **CAMPAIGN_ROUGH)
    rough_s = time.perf_counter() - t0
    outcome = {r.fault: (r.outcome, r.detected_at) for r in rough.reports}
    phase("campaign_crash_hang", workers=2, mutant_timeout_s=CAMPAIGN_TIMEOUT_S,
          seconds=f"{rough_s:.2f}",
          outcomes=",".join(f"{k}:{o}:{d}" for k, (o, d) in outcome.items()))
    report["campaign_crash_hang"] = {"outcomes": outcome, "seconds": rough_s}
    if outcome != {"identity": ("ok", None), "drop_cfg": ("ok", outcome["drop_cfg"][1]),
                   "crash_inject": ("crash", "crash"), "hang_inject": ("timeout", "timeout")} \
            or outcome["drop_cfg"][1] is None:
        raise AssertionError(f"crash/hang isolation on the card: {outcome}")

    # 8. timing --------------------------------------------------------------
    def graph_ms(fn, reps=20, iters=25):
        """Device time per call: ``reps`` calls captured in one CUDA graph,
        replayed ``iters`` times between CUDA events (no host overhead)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (iters * reps)

    def call_ms(fn, iters=200):
        """Wall time per eager call (host launch overhead included)."""
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def bound_ms(nbytes, ops, peak):
        """Least time for the work: each input read once and the output
        written once at HBM rate, or the operations at the peak rate of the
        operands' type, whichever is longer."""
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def nbytes(tensors, out):
        return sum(a.numel() * a.element_size() for a in tensors if torch.is_tensor(a)) \
            + out.numel() * out.element_size()

    def af_bound(args):
        x, w = args[:2]
        M, K = x.shape[-2:]
        B = x.shape[0] if x.dim() == 3 else 1
        out = torch.empty((B, M, w.shape[-2]), device=dev)
        return bound_ms(nbytes(args, out), 2 * out.numel() * K, PEAK_BF16_FLOPS)

    def fx_bound(args):
        x, w = args
        out = torch.empty(x.shape[:-1] + (w.shape[0],), device=dev)
        return bound_ms(nbytes(args, out), 2 * out.numel() * x.shape[-1], PEAK_FP32_FLOPS)

    def i8_bound(args):
        a, b = args
        out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32, device=dev)
        return bound_ms(nbytes(args, out), 2 * out.numel() * a.shape[1], PEAK_INT8_OPS)

    def library(args):
        """torch._int_mm where it accepts the shape (M > 16, K and N
        multiples of 8): the library int8 GEMM, timed only."""
        a, b = args
        if a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[0] % 8 == 0:
            return lambda: torch._int_mm(a, b.t())
        return None

    timed = [("af_gemm", n, lambda a=af_shapes[n]: af_gemm(*a, spec=spec),
              lambda a=af_shapes[n]: ref.af_gemm_ref(*a, spec), af_bound(af_shapes[n]), None)
             for n in ("fused_8x128x256x128", "fused_16x128x256x128", "resmlp_tok_64x16x16",
                       "resmlp_fc1_16x128x64", "resmlp_fc2_16x64x128", "resmlp_head_1x10x64",
                       "test_16x32x64")]
    timed += [("fx_gemm", n, lambda a=fx_shapes[n]: fx_kernel(*a),
               lambda a=fx_shapes[n]: fx_plain(*a), fx_bound(fx_shapes[n][0]), None)
              for n in ("fused_8x144x32x800_w16", "fused_8x144x32x800_w8",
                        "fused_16x144x32x800_w16")]
    timed += [("int8_gemm", n, lambda a=i8_shapes[n]: int8_gemm(*a),
               lambda a=i8_shapes[n]: ref.int8_gemm_ref(*a), i8_bound(i8_shapes[n]),
               library(i8_shapes[n]))
              for n in ("vta_tok_64x16x16", "vta_fc1_16x128x64", "vta_fc2_16x64x128",
                        "vta_head_1x10x64", "vt3_24x20x48", "test_128x128x128")]

    def flash_pairs(q, k, causal):
        """Score pairs the mask keeps (top-left causal), over all heads."""
        B, Hq, S, _ = q.shape
        Sk = k.shape[2]
        return B * Hq * (sum(min(i + 1, Sk) for i in range(S)) if causal else S * Sk)

    def flash_bound(args, causal):
        """The bound of the products at the fp32 rate (PR 13's bound, kept
        beside the split bound as a yardstick). Bytes: q, k, v read once and
        the output written once. Operations: P.V at the fp32 rate, since P
        is fp32; Q.K^T at the rate its inputs are exact. For bf16 inputs
        that is the tensor cores, a unit beside the fp32 one, so the slower
        product bounds the two; for fp32 inputs both products share the
        fp32 units and add."""
        q, k, _ = args
        flops = 2 * flash_pairs(q, k, causal) * q.shape[3]
        if q.dtype == torch.bfloat16:
            t_ops = max(flops / PEAK_BF16_FLOPS, flops / PEAK_FP32_FLOPS) * 1e3
        else:
            t_ops = 2 * flops / PEAK_FP32_FLOPS * 1e3
        t_bytes = (nbytes(args, q) / PEAK_BYTES) * 1e3   # the output is q-sized
        return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")

    def flash_split_bound(args, causal):
        """The split bound, the least time for the function: every product
        as exact bf16 products at the bf16 tensor-core rate, or the bytes,
        whichever is longer. bf16 inputs: Q.K^T once and P.V with P in three
        bf16 terms, 4 GEMM-equivalents; fp32 inputs: q, k, v and P in three
        terms each, six pairs of terms for each product, 12 (the three
        pairs dropped weigh under fp32's rounding)."""
        q, k, _ = args
        flops = 2 * flash_pairs(q, k, causal) * q.shape[3]
        gemms = 4 if q.dtype == torch.bfloat16 else 12
        return max(gemms * flops / PEAK_BF16_FLOPS, nbytes(args, q) / PEAK_BYTES) * 1e3

    def flash_least_bound(args, causal):
        """The split bound and what bounds it."""
        t_bytes = nbytes(args, args[0]) / PEAK_BYTES * 1e3
        t = flash_split_bound(args, causal)
        return t, ("bytes" if t_bytes >= t else "operations")

    flash_timed = ("tinyllama_prefill_bf16", "granite_qwen3_bf16", "tinyllama_prefill_fp32",
                   "tinyllama_forward_fp32", "tinyllama_smoke_fp32", "gemma_bf16",
                   "gemma_fp32")
    for n in flash_timed:
        args, causal = flash_cases[n]
        timed.append(("flash_attention", n,
                      lambda a=args, c=causal: flash_attention(*a, causal=c),
                      lambda a=args, c=causal: ref.flash_attention_ref(*a, causal=c),
                      flash_least_bound(args, causal),
                      lambda a=args, c=causal: F.scaled_dot_product_attention(
                          *a, is_causal=c, enable_gqa=True)))
    # the launch floor: an empty kernel of int8_gemm's block shape, timed in
    # the same harness; every time below is also given above it
    floor_ms = graph_ms(ki8.empty_launch)
    timings = {}
    for kname, name, kern, plain, (b_ms, b_by), lib in timed:
        # plain, kernel, kernel, plain: the two versions in turns
        runs = [graph_ms(plain), graph_ms(kern), graph_ms(kern), graph_ms(plain)]
        calls = [call_ms(kern), call_ms(plain)]
        timings[f"{kname}:{name}"] = {
            "ms": min(runs[1:3]), "plain_ms": min(runs[0], runs[3]), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": graph_ms(lib) if lib is not None else None,
            "graph_runs_ms": runs, "call_ms": calls[0], "plain_call_ms": calls[1],
            "above_floor_ms": min(runs[1:3]) - floor_ms}
    for n in flash_timed:
        tm = timings[f"flash_attention:{n}"]
        tm["split_bound_ms"] = flash_split_bound(*flash_cases[n])
        tm["flash_bound_ms"] = flash_bound(*flash_cases[n])[0]
        tm["design"] = kfa.DESIGNS[flash_cases[n][0][0].dtype]
    # CUDA launches one call makes, read from the profiler: every kernel the
    # device ran during the call (copies and fills excluded), with each
    # kernel's device time (us, mean of 5 calls)
    from torch.profiler import ProfilerActivity, profile

    def cuda_kernels(fn, calls=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        # a kernel seen at all ran in every call: round the count up, so an
        # event the profiler drops cannot hide a kernel
        return {e.key: (-(-e.count // calls), e.self_device_time_total / e.count)
                for e in prof.key_averages() if e.self_device_time_total > 0
                and not e.key.startswith(("Memcpy", "Memset"))}

    def flash_call(name):
        args, causal = flash_cases[name]
        return lambda: flash_attention(*args, causal=causal)

    per_kernel = {
        "af_gemm": cuda_kernels(lambda: af_gemm(*af_shapes["fused_8x128x256x128"], spec=spec)),
        "fx_gemm": cuda_kernels(lambda: fx_kernel(*fx_shapes["fused_8x144x32x800_w16"])),
        "int8_gemm": cuda_kernels(lambda: int8_gemm(*i8_shapes["vta_tok_64x16x16"])),
        "flash_attention": cuda_kernels(flash_call("tinyllama_prefill_bf16")),
        "flash_attention_fp32": cuda_kernels(flash_call("tinyllama_prefill_fp32"))}
    per_call = {k: sum(n for n, _ in v.values()) for k, v in per_kernel.items()}
    report["cuda_launches_per_call"] = per_call
    report["cuda_kernel_us"] = {k: {name: us for name, (_, us) in v.items()}
                                for k, v in per_kernel.items()}
    zero_counts()  # timing launches are not main-path launches
    declared = {"af_gemm": kaf.CUDA_LAUNCHES, "fx_gemm": kfx.CUDA_LAUNCHES, "int8_gemm": 1,
                "flash_attention": kfa.CUDA_LAUNCHES["wgmma"],
                "flash_attention_fp32": kfa.CUDA_LAUNCHES["wgmma3"]}
    if per_call != declared:
        raise AssertionError(f"CUDA launches per call {per_call}, declared {declared}")
    phase("timing", floor_ms=f"{floor_ms:.5f}",
          **{f"{k}_ms": f"{v['ms']:.5f}/{v['plain_ms']:.5f}/{v['bound_ms']:.5f}"
                        f"/+floor={v['above_floor_ms']:.5f}"
                        + (f"/fp32pv={v['flash_bound_ms']:.5f}/split={v['split_bound_ms']:.5f}"
                           if "split_bound_ms" in v else "")
                        + (f"/lib={v['library_ms']:.5f}" if v["library_ms"] is not None else "")
             for k, v in timings.items()},
          cuda_launches_per_call="/".join(f"{k}:{v}" for k, v in per_call.items()),
          kernel_us="/".join(f"{kernel_label(name)}={us:.3f}"
                             for v in report["cuda_kernel_us"].values()
                             for name, us in v.items()))
    report["timing"] = timings
    report["launch_floor_ms"] = floor_ms

    # 9. where the time goes: device busy share over one fused minibatch ------
    def device_busy(label, fn):
        """(wall s, device busy s, top kernels) of one call of ``fn``."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                       if e.self_device_time_total > 0), key=lambda r: -r[1])
        busy = sum(r[1] for r in rows) / 1e6
        if busy <= 0:
            raise AssertionError(f"{label}: the profiler saw no device activity")
        return wall, busy, rows[:15]

    def busy_share(label, program, params_, X_, y_, ex):
        wall, busy, top = device_busy(label, lambda: cosim.eval_classification(
            program, params_, X_, y_, ex, 16))
        report[f"profile_{label}"] = {"wall_s": wall, "device_busy_s": busy, "top": top}
        phase("profile", row=label, engine="fused", points=16, wall_s=f"{wall:.4f}",
              device_busy_s=f"{busy:.5f}", busy_share=f"{busy / wall:.4f}")

    busy_share("resmlp", res.program, trained, X, y, executors["fused"])
    busy_share("resnet20", resnet_prep.program, resnet_prep.params, resnet_prep.X,
               resnet_prep.y, table4.executor("fused-16", dev))
    zero_counts()

    # 10. TinyLlama-1.1B serving at full width ---------------------------------
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = lm_api.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(dev)
    generate(cfg, model, prompt, 2)   # warm-up: cuBLAS handles, first launches
    torch.cuda.synchronize()
    lm_setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stats = {}
    tokens = generate(cfg, model, prompt, LM_GEN, stats)
    counts = read_counts("lm")
    steps = stats["decode_steps"]
    serve = {
        "setup_s": lm_setup_s, "prefill_s": stats["prefill_s"],
        "decode_ms_per_step": stats["decode_s"] / steps * 1e3,
        "generated_tok_s": LM_BATCH * LM_GEN / (stats["prefill_s"] + stats["decode_s"]),
        "decode_tok_s": LM_BATCH * steps / stats["decode_s"],
        "prefill_tok_s": LM_BATCH * LM_PROMPT / stats["prefill_s"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "prefill_launches": stats["prefill_launches"],
        "decode_launches": stats["decode_launches"], "finite": stats["finite"],
        "in_vocab": bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
        "tokens_head": tokens[0, :8].tolist(),
    }
    cache = lm_api.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, torch.bfloat16, dev)
    for label, fn in (
            ("prefill", lambda: lm_api.prefill(cfg, model, prompt, cache)),
            ("decode_8_steps", lambda: [lm_api.decode_step(cfg, model, cache, tokens[:, i:i + 1],
                                                           LM_PROMPT + i) for i in range(8)])):
        wall, busy, top = device_busy(label, fn)
        serve[f"profile_{label}"] = {"wall_s": wall, "device_busy_s": busy,
                                     "busy_share": busy / wall, "top": top}
    zero_counts()
    phase("lm_serve", arch=cfg.name, batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN,
          prefill_s=f"{serve['prefill_s']:.4f}",
          decode_ms_per_step=f"{serve['decode_ms_per_step']:.3f}",
          generated_tok_s=f"{serve['generated_tok_s']:.1f}",
          decode_tok_s=f"{serve['decode_tok_s']:.1f}",
          prefill_launches=serve["prefill_launches"], decode_launches=serve["decode_launches"],
          prefill_wgmma_launches=counts["flash_attention:wgmma"],
          prefill_busy=f"{serve['profile_prefill']['busy_share']:.4f}",
          decode_busy=f"{serve['profile_decode_8_steps']['busy_share']:.4f}",
          peak_mem_gb=f"{serve['peak_mem_gb']:.2f}", finite=serve["finite"],
          in_vocab=serve["in_vocab"])
    report["lm_serve"] = serve
    others = {k: v for k, v in counts.items() if not k.startswith("flash_attention")}
    if (serve["prefill_launches"], serve["decode_launches"]) != (cfg.n_layers, 0) \
            or counts["flash_attention"] != cfg.n_layers \
            or counts["flash_attention:wgmma"] != cfg.n_layers or any(others.values()):
        raise AssertionError(f"lm_serve launched {counts} (prefill {serve['prefill_launches']},"
                             f" decode {serve['decode_launches']}); expected {cfg.n_layers}"
                             " flash_attention launches of the wgmma design, all in prefill")
    if tokens.shape != (LM_BATCH, LM_GEN) or not serve["in_vocab"] or not serve["finite"]:
        raise AssertionError(f"lm_serve: tokens {tuple(tokens.shape)}, in vocab "
                             f"{serve['in_vocab']}, finite logits {serve['finite']}")

    # 11. fp32: forward (kernel) against prefill + decode at generated positions
    model.float()
    zero_counts()
    full = lm_api.forward(cfg, model, torch.cat([prompt, tokens[:, :-1]], dim=1))
    full = full[:, LM_PROMPT - 1:]
    cache = lm_api.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, torch.float32, dev)
    logits, cache = lm_api.prefill(cfg, model, prompt, cache)
    dec = [logits[:, 0]]
    for i in range(LM_GEN - 1):
        logits, cache = lm_api.decode_step(cfg, model, cache, tokens[:, i:i + 1], LM_PROMPT + i)
        dec.append(logits[:, 0])
    dec = torch.stack(dec, dim=1)
    torch.cuda.synchronize()
    counts = read_counts("lm")
    rel = float((dec - full).abs().max() / full.abs().max())
    finite = bool(torch.isfinite(full).all() and torch.isfinite(dec).all())
    phase("lm_consistency", dtype="float32", positions=LM_GEN, max_rel_dev=f"{rel:.3e}",
          flash_launches=counts["flash_attention"],
          wgmma3_launches=counts["flash_attention:wgmma3"], finite=finite)
    report["lm_consistency"] = {"max_rel_dev": rel, "launches": counts, "finite": finite}
    del model, cache, full, dec
    if not finite or not rel < LM_CONSISTENCY_TOL \
            or counts["flash_attention:wgmma3"] != 2 * cfg.n_layers:
        raise AssertionError(f"lm_consistency: relative deviation {rel}, finite {finite}, "
                             f"launches {counts}")

    # 12. the smoke config on identical fp32 weights: card against CPU --------
    scfg = get_smoke_config(LM_ARCH)
    cpu_model = lm_api.init_params(scfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    card_model = copy.deepcopy(cpu_model).to(dev)
    sprompt = torch.from_numpy(np.random.default_rng(1).integers(0, scfg.vocab, (LM_BATCH, 96)))
    zero_counts()
    card, _ = lm_api.prefill(scfg, card_model, sprompt.to(dev),
                             lm_api.init_cache(scfg, LM_BATCH, 96, torch.float32, dev))
    torch.cuda.synchronize()
    counts = read_counts("lm")
    cpu, _ = lm_api.prefill(scfg, cpu_model, sprompt,
                            lm_api.init_cache(scfg, LM_BATCH, 96, torch.float32, "cpu"))
    dev_abs = float((card.cpu() - cpu).abs().max())
    close = bool(torch.allclose(card.cpu(), cpu, rtol=LM_CPU_TOL, atol=LM_CPU_TOL))
    phase("lm_cpu_parity", arch=scfg.name, prompt=96, max_abs_dev=f"{dev_abs:.3e}",
          allclose=close, flash_launches=counts["flash_attention"])
    report["lm_cpu_parity"] = {"max_abs_dev": dev_abs, "allclose": close, "launches": counts}
    if not close or counts["flash_attention"] != scfg.n_layers:
        raise AssertionError(f"lm_cpu_parity: card vs CPU {dev_abs}, launches {counts}")

    # the kernel line, one entry per CUDA source and per design of
    # flash_attention (bf16 and fp32, both from flash_attention_sm90.cu): the
    # shape each one's main path launched most
    line = {  # name: (launch count, timing, source, error key, TPU kernel)
        "af_gemm": ("af_gemm", "af_gemm:fused_8x128x256x128", "af_gemm", "af_gemm",
                    "af_gemm.py:68"),
        "fx_gemm": ("fx_gemm", "fx_gemm:fused_8x144x32x800_w16", "fx_gemm", "fx_gemm",
                    "fx_gemm.py:53"),
        "int8_gemm": ("int8_gemm", "int8_gemm:vta_tok_64x16x16", "int8_gemm", "int8_gemm",
                      "int8_gemm.py:39"),
        "flash_attention": ("flash_attention:wgmma", "flash_attention:tinyllama_prefill_bf16",
                            "flash_attention_sm90", "flash_attention:wgmma",
                            "flash_attention.py:64"),
        "flash_attention_fp32": ("flash_attention:wgmma3",
                                 "flash_attention:tinyllama_prefill_fp32",
                                 "flash_attention_sm90", "flash_attention:wgmma3",
                                 "flash_attention.py:64"),
    }
    kernels = []
    for kname, (count, timing, source, err_key, tpu) in line.items():
        tm = timings[timing]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": path_launches[count],
            "max_abs_err": worst_kernel[err_key],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
            "above_floor_ms": tm["above_floor_ms"],
        })
        if kname in per_call:
            kernels[-1]["cuda_launches_per_call"] = per_call[kname]
        kernels[-1]["launches_by_path"] = launches_by_path[count]
        if path_launches[count] <= 0:
            raise AssertionError(f"{kname} was never launched on the main path")
    report["kernels"] = kernels
    report["kernel_line"] = {k: v[1] for k, v in line.items()}
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
