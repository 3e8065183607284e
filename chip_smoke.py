"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a host with one CUDA card (it exits non-zero
without one). Phases, one line each:

1. device    the card's name and power limit (nvidia-smi); TF32 is off
2. build     compile every CUDA kernel of the path from src/repro_torch/csrc
             (one nvcc per source, all started together)
3. kernels   each kernel against its plain PyTorch version on the card, at the
             shapes the main path gives it (``torch.equal`` for the three
             GEMMs; flash_attention at the eight shapes of the LM configs,
             each in fp32 within 2e-5 and in bf16 within one bf16 step of
             the plain output and within 3e-2), and the
             FlexASR and VTA VT3 checks (ILA simulator vs kernel, worst
             deviation 0.0)
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
6. efficientnet
             on FlexASR + HLSCNN + VecUnit (6 vecunit, 4 hlscnn, 2 flexasr
             offloads), columns ideal, ila-16 and fused-16; fused is
             bit-identical to ila
7. vta       the ResMLP program (the parameters trained in phase 4) compiled
             onto VTA (7 vta_gemm, 4 vta_add, 2 vta_relu), columns ideal,
             ila and kernel; int8_gemm launches 7 times per point in the
             kernel column, which is bit-identical to ila
8. timing    kernel, plain version, bound and (where one exists) the PyTorch
             library call at the main path's shapes (CUDA events around
             CUDA-graph replays, after a warm-up); flash_attention at the
             TinyLlama prefill shape, against scaled_dot_product_attention
9. profile   the device's busy share over one fused-engine minibatch of the
             ResMLP row and of the ResNet-20 row (torch.profiler)
10. lm_serve TinyLlama-1.1B at full width (22 layers, d_model 2048, 32/4
             heads, vocab 32000), bf16 weights from a seeded generator on the
             card: ``launch.serve.generate`` serves 4 prompts of 1024 tokens
             and 32 generated tokens after a warm-up; prefill seconds, decode
             ms/step, tokens/s, and the busy share of a prefill and of 8
             decode steps (torch.profiler). Gates: 22 flash_attention launches
             in prefill and 0 in decode, ids within the vocabulary, finite
             logits
11. lm_consistency
             the same weights cast to fp32: ``forward`` over prompt +
             generated tokens (the kernel) against prefill + decode (kernel
             prefill, plain decode) at the generated positions; max relative
             deviation below 2e-2 (tests/test_models.py's bound)
12. lm_cpu_parity
             the TinyLlama smoke config on identical seeded fp32 weights on
             the card (kernel) and on the CPU (plain version): last-position
             prefill logits within rtol = atol = 1e-4

Every count of kernel launches is set to 0 just before a path runs and read
just after it. Then one JSON line per kernel (``{"kernels": [...]}``), the
card's nvidia-smi line and, last, the result line ``{"ok": true, "device":
{...}}``. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
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


def phase(label: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{label}] {body}", flush=True)


def main() -> int:
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch import device as devmod
    from repro_torch.accel import flexasr as fa, numerics, vta
    from repro_torch.core import apps, cosim, ir
    from repro_torch.core.codegen import Executor
    from repro_torch.core.compile import compile_program
    from repro_torch.kernels import build, ref
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.af_gemm import af_gemm
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fx_gemm import fx_gemm
    from repro_torch.kernels.int8_gemm import int8_gemm
    from repro_torch.launch import table4
    from repro_torch.launch.serve import generate
    from repro_torch.models import api as lm_api

    report = {}
    dev = devmod.resolve("cuda")
    wrappers = {"af_gemm": af_gemm, "fx_gemm": fx_gemm, "int8_gemm": int8_gemm,
                "flash_attention": flash_attention}
    #: per kernel, launches summed over every main-path run (read per path)
    path_launches = {name: 0 for name in wrappers}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        counts = {name: w.launches for name, w in wrappers.items()}
        for name, n in counts.items():
            path_launches[name] += n
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
    regs = {name: [ln.strip() for ln in text.splitlines() if "registers" in ln]
            for name, text in build.PTXAS_REPORT.items()}
    phase("build", **{k: f"{v:.1f}s" for k, v in secs.items()},
          ptxas=";".join(f"{k}:{v[0].replace(' ', '_')}" for k, v in regs.items() if v)
          or "cached")
    report["build_s"] = secs
    report["ptxas"] = build.PTXAS_REPORT

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
    flash_err = {}
    for name, (args, causal) in flash_cases.items():
        got = flash_attention(*args, causal=causal).float()
        want = ref.flash_attention_ref(*args, causal=causal).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        flash_err[name] = float(err.max())
        limit = FLASH_ATOL[str(args[0].dtype).removeprefix("torch.")]
        if args[0].dtype == torch.bfloat16:
            limit = (FLASH_ATOL["float32"] + FLASH_BF16_STEP * want.abs()).clamp(max=limit)
        if not bool((err <= limit).all()):
            mismatched.append(f"flash_attention:{name}")
    worst_kernel["flash_attention"] = max(flash_err.values())
    report["flash_attention_err"] = flash_err
    _, vt3_fasr = fa._vt3_linear(device=dev)
    _, vt3_vta = vta._vt3_gemm(device=dev)
    n_checked = sum(len(c) for c in checks.values()) + len(flash_cases)
    phase("kernels", shapes=n_checked, within_tolerance=n_checked - len(mismatched),
          **{f"{k}_max_abs_err": v for k, v in worst_kernel.items()},
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
    run_app("efficientnet", ("ideal", "ila-16", "fused-16"),
            {"veu_mul": 3, "veu_sigmoid": 3, "hlscnn_conv2d": 4, "fasr_linear": 2},
            (("ila-16", "fused-16"),), fx_per_group=4)
    run_app("resmlp_vta", ("ideal", "ila", "kernel"),
            {"vta_gemm": 7, "vta_add": 4, "vta_relu": 2}, (("ila", "kernel"),),
            i8_per_point=7, params=trained)

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
                       "resmlp_fc1_16x128x64", "resmlp_fc2_16x64x128", "resmlp_head_1x10x64")]
    timed += [("fx_gemm", n, lambda a=fx_shapes[n]: fx_kernel(*a),
               lambda a=fx_shapes[n]: fx_plain(*a), fx_bound(fx_shapes[n][0]), None)
              for n in ("fused_8x144x32x800_w16", "fused_8x144x32x800_w8",
                        "fused_16x144x32x800_w16")]
    timed += [("int8_gemm", n, lambda a=i8_shapes[n]: int8_gemm(*a),
               lambda a=i8_shapes[n]: ref.int8_gemm_ref(*a), i8_bound(i8_shapes[n]),
               library(i8_shapes[n]))
              for n in ("vta_tok_64x16x16", "vta_fc1_16x128x64", "vta_fc2_16x64x128",
                        "vta_head_1x10x64")]

    def flash_pairs(q, k, causal):
        """Score pairs the mask keeps (top-left causal), over all heads."""
        B, Hq, S, _ = q.shape
        Sk = k.shape[2]
        return B * Hq * (sum(min(i + 1, Sk) for i in range(S)) if causal else S * Sk)

    def flash_bound(args, causal):
        """Bytes: q, k, v read once and the output written once. Operations:
        P.V at the fp32 rate, since P is fp32; Q.K^T at the rate its inputs
        are exact. For bf16 inputs that is the tensor cores, a unit beside
        the fp32 one, so the slower product bounds the two; for fp32 inputs
        both products share the fp32 units and add."""
        q, k, _ = args
        flops = 2 * flash_pairs(q, k, causal) * q.shape[3]
        if q.dtype == torch.bfloat16:
            t_ops = max(flops / PEAK_BF16_FLOPS, flops / PEAK_FP32_FLOPS) * 1e3
        else:
            t_ops = 2 * flops / PEAK_FP32_FLOPS * 1e3
        t_bytes = (nbytes(args, q) / PEAK_BYTES) * 1e3   # the output is q-sized
        return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")

    def flash_split_bound(args, causal):
        """The bound of the wgmma design for bf16 inputs: Q.K^T once and P.V
        with P split into three bf16 terms (exact), all on the bf16 tensor
        cores, or the bytes, whichever is longer."""
        q, k, _ = args
        flops = 2 * flash_pairs(q, k, causal) * q.shape[3]
        return max(4 * flops / PEAK_BF16_FLOPS, nbytes(args, q) / PEAK_BYTES) * 1e3

    for n in ("tinyllama_prefill_bf16", "tinyllama_prefill_fp32"):
        args, causal = flash_cases[n]
        timed.append(("flash_attention", n,
                      lambda a=args, c=causal: flash_attention(*a, causal=c),
                      lambda a=args, c=causal: ref.flash_attention_ref(*a, causal=c),
                      flash_bound(args, causal),
                      lambda a=args, c=causal: F.scaled_dot_product_attention(
                          *a, is_causal=c, enable_gqa=True)))
    timings = {}
    for kname, name, kern, plain, (b_ms, b_by), lib in timed:
        # plain, kernel, kernel, plain: the two versions in turns
        runs = [graph_ms(plain), graph_ms(kern), graph_ms(kern), graph_ms(plain)]
        calls = [call_ms(kern), call_ms(plain)]
        timings[f"{kname}:{name}"] = {
            "ms": min(runs[1:3]), "plain_ms": min(runs[0], runs[3]), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": graph_ms(lib) if lib is not None else None,
            "graph_runs_ms": runs, "call_ms": calls[0], "plain_call_ms": calls[1]}
    split_ms = flash_split_bound(*flash_cases["tinyllama_prefill_bf16"])
    timings["flash_attention:tinyllama_prefill_bf16"]["split_bound_ms"] = split_ms
    zero_counts()  # timing launches are not main-path launches
    phase("timing", flash_attention_split_bound_ms=f"{split_ms:.5f}", **{f"{k}_ms": f"{v['ms']:.5f}/{v['plain_ms']:.5f}/{v['bound_ms']:.5f}"
                       + (f"/lib={v['library_ms']:.5f}" if v["library_ms"] is not None else "")
                       for k, v in timings.items()})
    report["timing"] = timings

    # 9. where the time goes: device busy share over one fused minibatch ------
    from torch.profiler import ProfilerActivity, profile

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
    counts = read_counts()
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
          prefill_busy=f"{serve['profile_prefill']['busy_share']:.4f}",
          decode_busy=f"{serve['profile_decode_8_steps']['busy_share']:.4f}",
          peak_mem_gb=f"{serve['peak_mem_gb']:.2f}", finite=serve["finite"],
          in_vocab=serve["in_vocab"])
    report["lm_serve"] = serve
    others = {k: v for k, v in counts.items() if k != "flash_attention"}
    if (serve["prefill_launches"], serve["decode_launches"]) != (cfg.n_layers, 0) \
            or counts["flash_attention"] != cfg.n_layers or any(others.values()):
        raise AssertionError(f"lm_serve launched {counts} (prefill {serve['prefill_launches']},"
                             f" decode {serve['decode_launches']}); expected {cfg.n_layers}"
                             " flash_attention launches, all in prefill")
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
    counts = read_counts()
    rel = float((dec - full).abs().max() / full.abs().max())
    finite = bool(torch.isfinite(full).all() and torch.isfinite(dec).all())
    phase("lm_consistency", dtype="float32", positions=LM_GEN, max_rel_dev=f"{rel:.3e}",
          flash_launches=counts["flash_attention"], finite=finite)
    report["lm_consistency"] = {"max_rel_dev": rel, "launches": counts, "finite": finite}
    del model, cache, full, dec
    if not finite or not rel < LM_CONSISTENCY_TOL or counts["flash_attention"] != 2 * cfg.n_layers:
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
    counts = read_counts()
    cpu, _ = lm_api.prefill(scfg, cpu_model, sprompt,
                            lm_api.init_cache(scfg, LM_BATCH, 96, torch.float32, "cpu"))
    dev_abs = float((card.cpu() - cpu).abs().max())
    close = bool(torch.allclose(card.cpu(), cpu, rtol=LM_CPU_TOL, atol=LM_CPU_TOL))
    phase("lm_cpu_parity", arch=scfg.name, prompt=96, max_abs_dev=f"{dev_abs:.3e}",
          allclose=close, flash_launches=counts["flash_attention"])
    report["lm_cpu_parity"] = {"max_abs_dev": dev_abs, "allclose": close, "launches": counts}
    if not close or counts["flash_attention"] != scfg.n_layers:
        raise AssertionError(f"lm_cpu_parity: card vs CPU {dev_abs}, launches {counts}")

    # the kernel line: the shape each kernel's main path launched most
    line_shape = {"af_gemm": "fused_8x128x256x128", "fx_gemm": "fused_8x144x32x800_w16",
                  "int8_gemm": "vta_tok_64x16x16", "flash_attention": "tinyllama_prefill_bf16"}
    replaces = {"af_gemm": "src/repro/kernels/af_gemm.py:68",
                "fx_gemm": "src/repro/kernels/fx_gemm.py:53",
                "int8_gemm": "src/repro/kernels/int8_gemm.py:39",
                "flash_attention": "src/repro/kernels/flash_attention.py:64"}
    kernels = []
    for kname in wrappers:
        tm = timings[f"{kname}:{line_shape[kname]}"]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname}.cu",
            "replaces": replaces[kname],
            "launches": path_launches[kname],
            "max_abs_err": worst_kernel[kname],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
        })
        if path_launches[kname] <= 0:
            raise AssertionError(f"{kname} was never launched on the main path")
    report["kernels"] = kernels
    report["kernel_line_shapes"] = line_shape
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
