"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a host with one CUDA card (it exits non-zero
without one). Phases, one line each:

1. device   the card's name and power limit (nvidia-smi); TF32 is off
2. build    compile every CUDA kernel of the path from src/repro_torch/csrc
3. kernels  each kernel against its plain PyTorch version on the card, at the
            shapes the main path gives it (``torch.equal``), and the FlexASR
            VT3 check (ILA simulator vs af_gemm, worst deviation 0.0)
4. resmlp   the paper's Table-4 ResMLP row on FlexASR at the repository's
            configuration: teacher task, 600 training steps, flexible
            matching, then 40 points through the ideal, ILA (compiled),
            kernel and fused executors; kernel launches counted over that
            run; the three accelerator columns agree with the ideal logits
            within fasr_linear's tolerance and are bit-identical to each
            other on every point
5. timing   kernel, plain version and bound at the main path's shapes (CUDA
            events around CUDA-graph replays, after a warm-up)
6. profile  the device's busy share over 16 fused-engine points
            (torch.profiler; a diagnostic that fails nothing)

Then one JSON line per kernel (``{"kernels": [...]}``) and, last, the result
line ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
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
#: cores, and HBM3 bandwidth. An AF(8,3) value has 5 significant bits, so
#: af_gemm's quantized operands and their products are exact in bf16 and
#: the bf16 rate is the fastest rate at which the same products can run.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

N_EVAL = 40
TRAIN_STEPS = 600
#: fasr_linear's declared tolerance (Intrinsic.tol)
LINEAR_TOL = 0.08


def phase(label: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{label}] {body}", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch import device as devmod
    from repro_torch.accel import flexasr as fa
    from repro_torch.core import apps, cosim
    from repro_torch.core.codegen import Executor
    from repro_torch.core.compile import compile_program
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.af_gemm import af_gemm

    report = {}
    dev = devmod.resolve("cuda")

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
    regs = [ln.strip() for ln in build.PTXAS_REPORT.get("af_gemm", "").splitlines()
            if "registers" in ln]
    phase("build", **{k: f"{v:.1f}s" for k, v in secs.items()},
          ptxas=(regs[0].replace(" ", "_") if regs else "cached"))
    report["build_s"] = secs
    report["ptxas"] = build.PTXAS_REPORT

    # 3. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(1)
    spec = ref.AF83
    from repro_torch.accel import numerics

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

    shapes = {
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
    worst_kernel = 0.0
    mismatched = []
    for name, args in shapes.items():
        got = af_gemm(*args, spec=spec)
        want = ref.af_gemm_ref(*args, spec)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst_kernel = max(worst_kernel, err)
        if not torch.equal(got, want):
            mismatched.append(name)
    _, worst_vt3 = fa._vt3_linear(device=dev)
    phase("kernels", shapes=len(shapes), equal=len(shapes) - len(mismatched),
          max_abs_err=worst_kernel, vt3_worst=worst_vt3)
    report["kernel_mismatches"] = mismatched
    if mismatched or worst_vt3 != 0.0:
        raise AssertionError(f"af_gemm disagrees with its plain version: {mismatched}, "
                             f"vt3 worst {worst_vt3}")

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
    rows = {}
    af_gemm.launches = 0
    for name, ex in executors.items():
        before = af_gemm.launches
        acc, sec = cosim.eval_classification(res.program, trained, X, y, ex, N_EVAL)
        torch.cuda.synchronize()
        rows[name] = {"accuracy": acc, "s_per_point": sec,
                      "af_gemm_launches": af_gemm.launches - before}
    main_launches = af_gemm.launches
    phase("resmlp", offloads=res.accelerator_calls["flexasr"], setup_s=f"{setup_s:.1f}",
          **{f"{k}_acc": f"{v['accuracy']:.3f}" for k, v in rows.items()},
          **{f"{k}_s_per_pt": f"{v['s_per_point']:.4f}" for k, v in rows.items()},
          **{f"{k}_launches": v["af_gemm_launches"] for k, v in rows.items()})
    # one launch per linear per point in kernel mode; one per fused linear
    # group (a pipeline chunk of one minibatch) in the fused engine
    n_linear = 7
    chunk = executors["fused"].pipeline_chunk
    batch = cosim._pipeline_batch(executors["fused"], 16)
    groups = sum(-(-min(batch, N_EVAL - i) // chunk) for i in range(0, N_EVAL, batch))
    expected = {"kernel": n_linear * N_EVAL, "fused": n_linear * groups}
    for name, want in expected.items():
        if rows[name]["af_gemm_launches"] != want:
            raise AssertionError(f"{name} launched {rows[name]['af_gemm_launches']}"
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

    # 5. timing --------------------------------------------------------------
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

    def bound_ms(args):
        """Least time for the work: each input read once and the output
        written once at HBM rate, or 2*B*M*N*K operations at the bf16
        tensor-core peak (exact for AF(8,3) operands), whichever is longer."""
        x, w, b = args[:3]
        M, K = x.shape[-2:]
        N = w.shape[-2]
        B = x.shape[0] if x.dim() == 3 else 1
        nbytes = sum(a.numel() * 4 for a in args if torch.is_tensor(a)) + B * M * N * 4
        flops = 2 * B * M * N * K
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    timings = {}
    for name in ("fused_8x128x256x128", "fused_16x128x256x128", "resmlp_tok_64x16x16",
                 "resmlp_fc1_16x128x64", "resmlp_fc2_16x64x128", "resmlp_head_1x10x64"):
        args = shapes[name]
        kern = lambda: af_gemm(*args, spec=spec)
        plain = lambda: ref.af_gemm_ref(*args, spec)
        before = af_gemm.launches
        # plain, kernel, kernel, plain: the two versions in turns
        runs = [graph_ms(plain), graph_ms(kern), graph_ms(kern), graph_ms(plain)]
        calls = [call_ms(kern), call_ms(plain)]
        af_gemm.launches = before
        b_ms, b_by = bound_ms(args)
        timings[name] = {"ms": min(runs[1:3]), "plain_ms": min(runs[0], runs[3]),
                         "bound_ms": b_ms, "bound_by": b_by, "graph_runs_ms": runs,
                         "call_ms": calls[0], "plain_call_ms": calls[1]}
    # the kernel line reports the fused group shape the main path launched
    fz = timings["fused_8x128x256x128"]
    phase("timing", **{f"{k}_ms": f"{v['ms']:.5f}/{v['plain_ms']:.5f}/{v['bound_ms']:.5f}"
                       for k, v in timings.items()}, library="none")
    report["timing"] = timings

    # where the time goes: device busy share over one fused-engine minibatch
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cosim.eval_classification(res.program, trained, X, y, executors["fused"], 16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels_us = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                      if e.self_device_time_total > 0]
        busy = sum(k[1] for k in kernels_us) / 1e6
        kernels_us.sort(key=lambda k: -k[1])
        report["profile_fused_16pt"] = {"wall_s": wall, "device_busy_s": busy,
                                        "top": kernels_us[:15]}
        phase("profile", engine="fused", points=16, wall_s=f"{wall:.4f}",
              device_busy_s=f"{busy:.5f}", busy_share=f"{busy / wall:.4f}")
    except Exception as err:  # the profiler is a diagnostic, not a gate
        report["profile_fused_16pt"] = f"not measured: {err!r}"
        phase("profile", busy_share="not_measured")

    kernels = [{
        "name": "af_gemm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/af_gemm.cu",
        "replaces": "src/repro/kernels/af_gemm.py:68",
        "launches": main_launches,
        "max_abs_err": worst_kernel,
        "ms": fz["ms"],
        "plain_ms": fz["plain_ms"],
        "bound_ms": fz["bound_ms"],
        "bound_by": fz["bound_by"],
        "library_ms": None,
    }]
    report["kernels"] = kernels
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
