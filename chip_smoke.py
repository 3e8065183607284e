"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --stream-mesh    # phase 21 alone, on every card
    python3 chip_smoke.py --nccl           # phase 22 alone, on every card (two or more)

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
             VTA VT3 checks (ILA simulator vs kernel, worst deviation 0.0);
             then the reference's log, exp and exp2 on the card
             (``af_exponent``, a gate: no point may differ from the CPU):
             ``floor_log2`` and ``af_exp_bias`` at the 254 powers of two in
             [2^-126, 2^127] and one ulp each side, both signs, and on the
             +-2048-ulp band around each (af_exp_bias at every 256th
             point); ``exp2_ref`` at every integer in [-149, 127];
             ``log_f32`` / ``exp_f32`` on 2^20 bit patterns;
             ``af_quantize`` on N(0, sigma^2), sigma 1e-6, 1e-3, 1, 1e3;
             VecUnit's EW_START (mul, sigmoid) on the int16 grids at
             exponents -13 to -15; ``exp2_neg`` at every integer and
             ``af_quantize`` in both tiers (numerics.tier) on the lattice
             midpoints, and one ulp each side, of every window from bias
             -149 to 130; and af_gemm with x's largest magnitude at 2^13,
             2^27, 2^-47, 2^-126, 2^-6, 2^-20, 2^20, 2^100, 2^-122 and
             2^-124, and with x on the lattice midpoints of the window
             [-20, -13], against its plain version, bit for bit, every
             output finite (gated with the kernels)
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
             the same rows run on the CPU (VecUnit's rows equal to them)
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
             Granite/Qwen3 shape and the trainer's (phase 15) in bf16, each
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
             the same weights cast to fp32: greedy prefill + decode
             (kernel prefill, plain decode) against ``forward`` over the
             prompt and the tokens generated (the kernel's wgmma3 design)
             at those positions (``decode_vs_forward``); max relative
             deviation below 2e-2
             (tests/test_models.py's bound); all 2 x 22 launches wgmma3
12. lm_cpu_parity
             the TinyLlama smoke config on identical seeded fp32 weights on
             the card (kernel) and on the CPU (plain version): last-position
             prefill logits within rtol = atol = 1e-4
13. cosim_serve
             ``core.serving.CosimServer`` under ``launch.serve --cosim``'s
             default load (16 requests x batch 4, concurrency 4, queue depth
             16, coalescing up to 16 samples, arrival asap) for ResMLP at
             ``add_app``'s defaults and ResNet-20, on the pipelined and the
             fused engine: QPS and p50/p95/p99 latency, and the device's
             busy share over one more load on the fused engine (torch.profiler).
             Gates: 16/16 served,
             coalesced_max > 1, every output bit-identical to a
             coalesce=False, overlap=False server on the same request ids,
             fused bit-identical to pipelined, a burst of queue depth + 8
             rejects the 8 with queue_full and close(drain=True) serves the
             rest and leaves nothing queued, af_gemm and fx_gemm launched on
             the path ("serve_cosim")
14. lm_train TinyLlama-1.1B at full width (nothing cut), seeded bf16 weights,
             AdamW, ``SyntheticLM`` batches of 4 x 1024 tokens, 6 steps of
             ``launch.steps.make_train_step``: s/step, tokens/s, peak
             memory. Gates: finite loss and grad norm every step, a finite
             gradient for every parameter at step 0, 22 + 22 flash_attention
             launches per step (forward and the remat recompute in backward),
             all on wgmma. Then the smoke config on identical weights: the
             kernel-forward gradient against the all-plain one, and the card
             against the CPU, per leaf within TRAIN_GRAD_BF16 in bf16 (wgmma)
             and TRAIN_GRAD_FP32 in fp32 (wgmma3); the bf16 kernel-forward
             gradient against the fp32 all-plain one on the upcast weights,
             per leaf in relative L2 within TRAIN_GRAD_BF16_L2, and wrong
             forwards in the kernel's place (non-causal, scale x1.1) beyond it
15. trainer_restart
             ``runtime.trainer.Trainer`` on the card with TestTrainer's
             configuration (SmolLM smoke, 4 x 32 tokens, checkpoints every 10
             steps under chiprun_out/trainer_ckpt): a WorkerFailure at step
             15 restarts once from the step-9 checkpoint (step 10 run twice,
             step 0 once), the last loss below the first; a sleep at step 20
             (30 x the median step, 1-6 s) flagged as a straggler
16. distributed
             the sharding layer (``launch/{mesh,sharding,steps}.py``):
             the spec trees (params, AdamW and Adafactor state, batch, the
             decode_32k and long_500k caches) of all ten full configs on
             the 16x16 and 2x16x16 meshes over a fake process group, on
             meta tensors: sharded / replicated leaves and parameter bytes
             per device. Then NCCL at world size 1 (a HashStore) and the
             1x1 smoke mesh: TinyLlama-1.1B at full width, bf16, AdamW, 2
             steps of 4 x 1024 tokens through ``make_train_step(cfg,
             shape, mesh)`` on DTensors against the plain step on the same
             weights and batches (gates: loss, grad norm, every parameter
             and both moments bit-identical; 44 wgmma launches a step on
             path "dist"), s/step of both; prefill + 8 decode steps
             through ``make_serve_step`` at lm_serve's shapes (gates:
             greedy ids equal ``launch.serve.generate``'s, 22 wgmma
             launches in prefill); then Qwen3-MoE and Falcon-Mamba-7B at
             their published widths, depth cut to 2 layers, bf16, one
             sharded train step of 8 x 64 tokens each on the same mesh
             against the plain step (the MoE's token group cut to 256:
             two group pieces; gates: bit-identical under
             ``device.deterministic()``, the MoE's local-shard dispatch
             and the wgmma design, or the Mamba1 local scan and in_proj's
             halves, ran twice a layer: forward and remat recompute), and
             Falcon-Mamba's prefill of 8 x 512 tokens (in_proj's weight
             sliced) + 3 decode steps through the serve bundles against
             the plain prefill and decode (gate: logits within 2e-2 of
             their largest magnitude); every process group destroyed
17. dryrun   ``launch.dryrun`` on the card's host (its own PyTorch release):
             TinyLlama-1.1B's train_4k, prefill_32k and decode_32k cells,
             Zamba2-7B's long_500k (hybrid) and Falcon-Mamba-7B's
             decode_32k (SSM), and the cells of the local-shard paths:
             Qwen3-MoE train_4k and DeepSeek-V3 decode_32k (the MoE
             dispatch), SmolLM-360M and Whisper-base train_4k (the
             o-projection after a sequence split), Falcon-Mamba-7B
             prefill_32k (the Mamba1 scan), at 16x16 over a fake process
             group of 256, meta tensors: seconds, FLOPs per device, collective bytes,
             resident bytes, the roofline bound on the H100's published
             peaks (``roofline.analysis``); gate: every cell "ok". Then the
             roofline bound of phase 14's own step (TinyLlama-1.1B, one
             device, 4 x 1024, AdamW, counted on meta tensors) beside the
             s/step phase 14 measured, and their ratio. No kernel runs.
18. gloo_cpu 4 gloo processes on the host's CPU, on purpose: the card's
             PyTorch release's DTensor rules held against real collectives
             (the card is one device). The smoke configs' sharded steps on
             2x2, 1x4 and 4x1 meshes against the unsharded step on the same
             seeded fp32 weights: Qwen3-MoE and DeepSeek-V3 (capacity factor
             0.5, ``layers.MOE_GROUP`` 256: slots dropped, groups across
             ranks) and Falcon-Mamba-7B (Mamba1), a train step and prefill +
             3 decode steps each; SmolLM-360M (3 heads on a 2-way 'model'
             axis: the o-projection after a sequence split), a train step.
             Checks and gates: ``launch/checks.py``, as the CPU tests
             (tests/test_torch_sharded_moe_ssm.py) run them: loss and grad
             norm within 1e-5 relative, both AdamW moments within 1e-5 of
             the leaf's largest magnitude, parameters within 5e-3 (and 1e-6
             of the AdamW update of the sharded moments), collectives
             counted, logits within 1e-5, greedy ids equal, dropped slots in
             the MoE train steps and prefills, SmolLM's attention output
             split over batch and sequence. No kernel runs.
19. remat_memory
             the memory that recomputing in backward saves, each layer alone
             at its published widths, forward and backward against a fixed
             upstream gradient under ``device.deterministic()``, the peak
             (``max_memory_allocated``) above inputs and parameters: one
             Falcon-Mamba-7B Mamba1 block on 2 x 4096 bf16 tokens (16 scan
             chunks of 256 steps against ``ssm.SSM_CHUNK`` = 4096: one chunk
             whose backward keeps every step), one Qwen3-MoE FFN on 4 x 32768
             tokens (four groups, each recomputed, against the same four
             ``_moe_group`` calls kept), and that FFN through
             ``_moe_sharded`` on a 1x1 NCCL mesh (pieces recomputed against
             ``layers.recompute`` made a plain call); each line with the drop
             predicted from what autograd keeps (``remat_predictions``) and
             the card's name and power limit. Gates: outputs and gradients
             bit-identical, the drop at least half the predicted one, no
             kernel launched.
20. lm_families
             the nine configurations but TinyLlama, in ARCH_IDS order, each
             at its published widths on seeded bf16 weights on the card,
             depth cut only where ``family_plan`` finds the weights too
             large (DeepSeek-V3: 1 layer, its MTP block and MoE included),
             served through ``launch.serve.generate``: 2 prompts of 512
             tokens (Whisper: 1500 stub frames) and 16 tokens after a
             warm-up; prefill seconds, decode ms/step, the family's peak
             memory above what was allocated before it (set-up included),
             each beside the plan's reckoning. Gates: ids of the right shape
             within the vocabulary, finite logits, flash_attention's
             launches in prefill and in decode equal to the plan's
             (``flash_calls``: per attention layer in prefill for the GQA
             families, one per group for Zamba2, none for DeepSeek-V3's
             absorbed MLA cache or Falcon-Mamba, Whisper's 6 encoder layers
             in prefill, its 6 cross-attentions on every decode step and
             its 6 self-attentions at position 0),
             all of the wgmma design, no other kernel launched. Then fp32
             at published widths (depth 2; Zamba2 7: a group and a tail
             block; Whisper whole; DeepSeek-V3 at its smoke config), MoE
             capacity with no drops: ``forward`` (Whisper: ``encode`` +
             ``decode_train``) against greedy prefill + decode at the
             generated positions (16; Zamba2 257, so that the forward's
             768 tokens split into whole SSD chunks) within 2e-2, every launch wgmma3 and as
             many as the plan says; then the smoke config on identical
             fp32 weights on the card and on the CPU: prefill and 3 decode
             steps' logits within rtol = atol = 1e-4. One line per family,
             with the card's name and power limit.
21. stream_mesh
             the ILA stream mesh (``core/ila.py::set_stream_mesh``): the
             simulators' batch axis split over every card when the host has
             more than one, else over a two-way mesh of the one card
             repeated (``cards``, ``mesh`` on each line). Mesh off, then on,
             each on a fresh Executor or server: the Table-4 ResMLP row on
             FlexASR (phase 4's program and parameters) on the compiled,
             pipelined and fused engines, the ResNet-20 fused-16 column
             (phase 5's), 40 points each, and the serve launcher's default
             co-sim load on ResMLP (phase 13's program, 16 requests x batch
             4, pipelined); s/point and requests/s on and off, with the
             card's name and power limit. Gates: outputs bit-identical on
             against off, engine by engine, and request by request;
             accuracies equal; af_gemm and fx_gemm launches of the timed
             passes equal to the mesh size times the unsharded reckoning
             (phase 4's: one per fused linear or conv group), counted on
             path "mesh"; every sharded group's shards on the mesh's
             devices, in order, where the Executor joins them.

22. nccl_mesh
             the sharded steps over real collectives: an NCCL group of one
             spawned process per card (``launch.checks.spawn(...,
             backend="nccl")``: rank r on card r), on a host of two cards or
             more (on one card, one line: NCCL cannot put two ranks on one
             card, and phase 16 runs the 1x1 NCCL mesh). (a) Phase 18's
             cases (the same smoke configs, meshes and ``launch/checks.py``
             gates) on the cards, seeded fp32 weights made on each rank's
             card; (b) TinyLlama-1.1B at its published widths, all 22
             layers, seeded fp32: one AdamW train step of 8 x 64 tokens,
             then prefill + 3 decode steps through the serve bundles, on the
             2x2 and 1x4 meshes, against the plain step on each rank's own
             card (the same gates), with s/step sharded and plain (each step's
             first call) and the collectives ``CommDebugMode`` counted;
             flash_attention's launches on every rank equal to
             ``nccl_flash_calls`` (all wgmma3), counted on path "nccl"; (c)
             ``torchrun --nproc-per-node <cards> -m repro_torch.launch.train
             --arch smollm_360m --smoke --steps 3``: exit 0, rank 0 trains
             with a finite loss, every other rank prints the "fewer than 256
             devices" line naming its own card. Each line with the card's
             name and power limit and the number of cards.

Every count of kernel launches is set to 0 just before a path runs and read
just after it. Then one JSON line with an entry per kernel and per design of
flash_attention (``{"kernels": [...]}``; each entry also gives its CUDA
launches per call, its time above the launch floor and its launches per
path: "table4" for phases 4-7, "vt3", "lm" for phases 10-12,
"serve_cosim" for 13, "train" for 14-15, "dist" for 16, "families" for
20, "mesh" for 21 and "nccl" for 22), the card's
nvidia-smi line
and, last, the result line ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import re
import shutil
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
#: af_gemm's check at x's largest magnitude 2^k: two powers where
#: floor(log2) is one below k (in the reference and the port), two where
#: dividing log(x) by ln 2 gave another exponent than the reference's
#: multiply, 2^-126 with its window below the normals (its powers of two
#: flushed to 0: the compiled reference multiplies by their finite
#: reciprocals, so every output is finite), four whose windows lie outside
#: [-12, 12], where the reference's exp2 is not the exact power, and two
#: whose windows reach below 2^-126 (their lowest powers flushed to 0)
AF_POWERS = (13, 27, -47, -126, -6, -20, 20, 100, -122, -124)
#: af_gemm's lattice-midpoint check: x on the midpoints, and one ulp each
#: side, of the window of this bias ([-20, -13], outside [-15, 8], where
#: the compiled form's multiply and the eager division round apart)
AF_MID_BIAS = -20
#: the af_exponent gate's sigma sweep (af_quantize on seeded N(0, sigma^2))
AF_SIGMAS = (1e-6, 1e-3, 1.0, 1e3)
#: the LM serving path: TinyLlama-1.1B, 4 prompts of 1024 tokens, 32 more
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "tinyllama_1_1b", 4, 1024, 32
#: fp32 forward vs prefill + decode (tests/test_models.py:60); card vs CPU
LM_CONSISTENCY_TOL, LM_CPU_TOL = 2e-2, 1e-4

#: co-sim serving: ResMLP (add_app's default size, 4 layers) and ResNet-20
#: under the serve launcher's default load (16 requests x batch 4,
#: concurrency 4, queue depth 16, coalescing up to 16 samples, arrival asap)
SERVE_APPS = ("resmlp", "resnet-20")
SERVE_REQUESTS, SERVE_BATCH, SERVE_CONCURRENCY = 16, 4, 4
SERVE_QUEUE_DEPTH, SERVE_MAX_BATCH = 16, 16
#: LM training: TinyLlama-1.1B at full width, AdamW, 4 x 1024 tokens a step
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS_LM, TRAIN_LR = 4, 1024, 6, 3e-4
#: per gradient leaf, max |kernel - plain| (and |card - CPU|) over max |plain|:
#: bf16 2^-4 (the kernel keeps P in fp32 where the plain attention rounds it
#: to bf16; 1.8e-2 measured on the CPU at the smoke config), fp32 1e-4
TRAIN_GRAD_BF16, TRAIN_GRAD_FP32 = 2.0 ** -4, 1e-4
#: per gradient leaf, ||bf16 kernel-forward - fp32 all-plain|| / ||fp32||
#: on the same (upcast) weights, every entry of a leaf counting: bf16 alone
#: gave at most 2.2e-2 on the CPU at the smoke config, a forward with the
#: scale 10% off at least 1.9e-1 (a non-causal one 2.5); 2^-4 lies between.
#: The run holds such wrong forwards (TRAIN_GRAD_WRONG) beyond it as well.
TRAIN_GRAD_BF16_L2 = 2.0 ** -4
TRAIN_GRAD_WRONG = ("non_causal", "scale_x1.1")
#: the sharding layer: TinyLlama-1.1B at full width on a 1x1 NCCL mesh,
#: 2 sharded train steps at lm_train's shapes, then prefill + 8 decode steps
#: at lm_serve's
DIST_ARCH, DIST_STEPS, DIST_DECODE = LM_ARCH, 2, 8
#: the dry-run's cells on the card's host (16x16): TinyLlama's three, a
#: hybrid and an SSM cell, and one cell of each local-shard path (the MoE
#: dispatch, the o-projection after a sequence split, the Mamba1 scan)
DRYRUN_CELLS = (("tinyllama_1_1b", "train_4k"), ("tinyllama_1_1b", "prefill_32k"),
                ("tinyllama_1_1b", "decode_32k"), ("zamba2_7b", "long_500k"),
                ("falcon_mamba_7b", "decode_32k"), ("qwen3_moe_30b_a3b", "train_4k"),
                ("deepseek_v3_671b", "decode_32k"), ("smollm_360m", "train_4k"),
                ("whisper_base", "train_4k"), ("falcon_mamba_7b", "prefill_32k"))
#: phase 16's local-shard steps: Qwen3-MoE (d_model 2048, 128 experts,
#: top-8, expert FFN 768) and Falcon-Mamba-7B (Mamba1, d_inner 8192) at
#: their published widths, depth cut to LOCAL_LAYERS; a train step of 8 x 64
#: tokens (the MoE's token group cut to LOCAL_MOE_GROUP, so that its 512
#: tokens run as two group pieces), and Falcon-Mamba's prefill of 8 x
#: LOCAL_PROMPT tokens (4096 tokens: in_proj's halves taken by slicing the
#: weight) and LOCAL_GEN - 1 decode steps, logits within LOCAL_LOGITS_TOL of
#: their largest magnitude (the plain prefill slices the product instead)
LOCAL_ARCHS, LOCAL_LAYERS, LOCAL_MOE_GROUP = ("qwen3_moe_30b_a3b", "falcon_mamba_7b"), 2, 256
LOCAL_PROMPT, LOCAL_GEN, LOCAL_LOGITS_TOL = 512, 4, 2e-2
#: phase 18: 4 gloo ranks on the host's CPU; the smoke configs checked on
#: each mesh shape (launch/checks.py: its capacity factor and token group,
#: and its gates, tests/test_torch_sharded_moe_ssm.py's); SmolLM's train
#: step only, its attention output split over batch and sequence
GLOO_WORLD, GLOO_TIMEOUT_S = 4, 300
GLOO_CASES = {(2, 2): ("qwen3_moe_30b_a3b", "deepseek_v3_671b", "falcon_mamba_7b", "smollm_360m"),
              (1, 4): ("qwen3_moe_30b_a3b", "deepseek_v3_671b", "falcon_mamba_7b"),
              (4, 1): ("qwen3_moe_30b_a3b",)}
GLOO_SEQ_SPLIT = "smollm_360m"
#: phase 22: phase 18's cases over NCCL, one process per card, on seeded fp32
#: weights, and NCCL_ARCH at its published widths (all layers, nothing cut)
#: on NCCL_PUBLISHED_MESHES; then the train launcher under torchrun on every
#: card (NCCL_LAUNCH: arch, steps). The spawned group (every mesh in turn)
#: and the launcher run are each killed after NCCL_TIMEOUT_S
NCCL_ARCH, NCCL_PUBLISHED_MESHES = LM_ARCH, ((2, 2), (1, 4))
NCCL_LAUNCH = ("smollm_360m", 3)
NCCL_TIMEOUT_S = 450
#: phase 19: each layer that recomputes in backward, alone at its published
#: widths: one Mamba1 block of Falcon-Mamba-7B on 2 x 4096 bf16 tokens (16
#: scan chunks of 256 steps), one MoE FFN of Qwen3-MoE on 4 x 32768 (four
#: token groups of the reference's MOE_GROUP); the measured drop in peak
#: memory must reach REMAT_MIN_SHARE of the predicted one
REMAT_MAMBA = ("falcon_mamba_7b", 2, 4096)
REMAT_MOE = ("qwen3_moe_30b_a3b", 4, 32_768)
REMAT_MIN_SHARE = 0.5
#: phase 20: every configuration but LM_ARCH (phase 10's) served through
#: launch.serve.generate on seeded bf16 weights at its published widths:
#: FAMILY_BATCH prompts of FAMILY_PROMPT tokens (Whisper: AUDIO_ENC_FRAMES
#: stub frames), FAMILY_GEN tokens; depth cut only where the parameters and
#: their reckoned set-up peak (family_plan) would pass FAMILY_MEM_LIMIT of
#: the card's 80 GB. The fp32 forward against prefill + decode runs at
#: published widths, depth cut to the least that holds every kind of layer
#: (FAMILY_FP32_LAYERS, else 2; Whisper whole), MoE capacity raised so that
#: no token drops (tests/test_models.py:53 does the same); card against CPU
#: at the smoke configs: a prompt of FAMILY_CPU_PROMPT tokens, then
#: FAMILY_CPU_STEPS decode steps
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN = 2, 512, 16
FAMILY_MEM_LIMIT = 72e9
FAMILY_FP32_LAYERS = {"zamba2_7b": 7, "whisper_base": None}
FAMILY_CPU_PROMPT, FAMILY_CPU_STEPS = 24, 3

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


def af_power_case(k: int, rng, dev, spec, m: int = 64, n: int = 32, kk: int = 64) -> tuple:
    """af_gemm's arguments with x's largest magnitude exactly 2^k (one
    element, every other below it) and w scaled by 2^-k, so that each
    product and sum is a normal float (``AF_POWERS``; at 2^-126 the
    elements below the top are subnormal, read as 0, and at 2^-122 and
    2^-124 many of them are); the biases from
    ``af_exp_bias`` on ``dev``."""
    import numpy as np
    import torch

    from repro_torch.accel import numerics

    xa = rng.standard_normal((m, kk))
    xa = xa / np.abs(xa).max() * 0.99 * 2.0 ** k
    xa[m // 2, kk // 3] = -(2.0 ** k)
    x, w, b = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (
        xa, rng.standard_normal((n, kk)) * 0.1 * 2.0 ** -k, rng.standard_normal((n,)) * 0.1))
    return (x, w, b, numerics.af_exp_bias(x, spec), numerics.af_exp_bias(w, spec),
            numerics.af_exp_bias(x @ w.T + b, spec))


def af_midpoints(bias: int, spec) -> "np.ndarray":
    """The positive lattice midpoints of the AdaptivFloat window of
    ``bias`` (every binade's (2^m + j + 1/2) 2^(e - m), j in [0, 2^m)),
    each with the float32 one ulp below and one above it (subnormal, 0 or
    inf where the binade lies outside float32's normals)."""
    import numpy as np

    m = spec.n_man
    e = np.arange(bias, bias + 2 ** spec.n_exp, dtype=np.float64)
    mid = ((2 ** m + np.arange(2 ** m) + 0.5)[None, :] * 2.0 ** (e[:, None] - m)).ravel()
    with np.errstate(over="ignore"):   # inf past the float32 range
        mid = mid.astype(np.float32)
    return np.concatenate([mid, np.nextafter(mid, np.float32(0)),
                           np.nextafter(mid, np.float32(np.inf))])


def af_midpoint_case(rng, dev, spec, m: int = 64, n: int = 32, kk: int = 128) -> tuple:
    """af_gemm's arguments with x on ``af_midpoints(AF_MID_BIAS)`` (random
    signs; its largest value puts x's bias at AF_MID_BIAS), w and b random;
    the biases from ``af_exp_bias`` on ``dev``."""
    import numpy as np
    import torch

    from repro_torch.accel import numerics

    mids = af_midpoints(AF_MID_BIAS, spec)
    xa = rng.choice(mids, (m, kk)) * rng.choice([-1.0, 1.0], (m, kk))
    xa[0, 0] = mids.max()
    x, w, b = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (
        xa, rng.standard_normal((n, kk)), rng.standard_normal((n,)) * 2.0 ** AF_MID_BIAS))
    return (x, w, b, numerics.af_exp_bias(x, spec), numerics.af_exp_bias(w, spec),
            numerics.af_exp_bias(x @ w.T + b, spec))


def af_signed_zero_case(dev, kk: int, m: int = 16, n: int = 16) -> tuple:
    """af_gemm's arguments on a grid of one block whose every product is
    flushed from a tiny negative and whose b is -0: each sum is a zero
    whose sign the reference's zero padding of K decides (-0 at K = 128,
    +0 where the last block is short of it)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(kk)
    x, w, b = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (
        -np.abs(rng.standard_normal((m, kk))) * 1e-20,
        np.abs(rng.standard_normal((n, kk))) * 1e-20, np.full(n, -0.0)))
    return x, w, b, -72.0, -72.0, -10.0


def equal_bits(got, want) -> bool:
    """float32 ``got`` and ``want`` equal bit for bit, signed zeros
    included, with NaN equal to NaN in the same places."""
    import torch

    nan = torch.isnan(got)
    return bool(torch.equal(nan, torch.isnan(want)) and torch.equal(
        torch.where(nan, 0.0, got).view(torch.int32), torch.where(nan, 0.0, want).view(torch.int32)))


def equal_nan(got, want) -> bool:
    """``torch.equal``, with NaN equal to NaN in the same places."""
    import torch

    nan = torch.isnan(got)
    return bool(torch.equal(nan, torch.isnan(want))
                and torch.equal(torch.where(nan, 0.0, got), torch.where(nan, 0.0, want)))


def af_exponent_card_vs_cpu(dev, spec) -> dict:
    """The reference's log, exp and exp2 as the port computes them
    (``numerics.log_f32``, ``exp_f32``, ``exp2_ref``: IEEE float32 and
    float64 operations only) on the card against the CPU, point for point:
    ``floor_log2`` and ``af_exp_bias`` (each value a tensor of its own) at
    the 254 powers of two in [2^-126, 2^127] and one ulp each side, both
    signs (1524 values), and on the +-2048-ulp band around each power
    (1,038,590 values; ``af_exp_bias`` at every 256th); ``exp2_ref`` at
    every integer in [-149, 127]; ``log_f32`` and ``exp_f32`` on 2^20
    seeded bit patterns; ``af_quantize`` on seeded N(0, sigma^2) tensors
    (``AF_SIGMAS``); ``exp2_neg`` at every integer in [-149, 127] and
    ``af_quantize`` in the eager and the compiled tier on the lattice
    midpoints, one ulp each side, of every window from bias -149 to 130
    (``af_midpoints``, both signs, each value with its window's bias); and
    VecUnit's ``EW_START``, mul and sigmoid, at every point of the int16
    grids k * 2^ea, ea in {-13, -14, -15}. One ``af_exponent`` line; a
    point whose float32 bits differ fails the run."""
    import numpy as np
    import torch

    from repro_torch.accel import numerics, vecunit as veu

    pw = np.ldexp(np.float32(1.0), np.arange(-126, 128)).astype(np.float32)
    pts = np.concatenate([pw, np.nextafter(pw, np.float32(0)),
                          np.nextafter(pw, np.float32(np.inf))])
    x = torch.from_numpy(np.concatenate([pts, -pts]))
    p = np.arange(1, 255, dtype=np.int64) << 23
    band = (p[:, None] + np.arange(-2048, 2049)[None, :]).ravel()
    band = torch.from_numpy(band[(band >= 1 << 23) & (band < 0x7f800000)]
                            .astype(np.uint32).view(np.float32))
    rng = np.random.default_rng(28)
    bits = torch.from_numpy(rng.integers(0, 2 ** 32, 2 ** 20, dtype=np.uint64)
                            .astype(np.uint32).view(np.float32))

    def bias_each(v):
        return torch.cat([numerics.af_exp_bias(u, spec)[None] for u in v.split(1)])

    cases = {
        "floor_log2": (lambda v: numerics.floor_log2(v.abs()), x),
        "af_exp_bias": (bias_each, x),
        "band_floor_log2": (numerics.floor_log2, band),
        # every 256th point of the band, each value a tensor of its own
        "band_af_exp_bias": (bias_each, band[::256].contiguous()),
        "exp2_ref": (numerics.exp2_ref, torch.arange(-149, 128, dtype=torch.float32)),
        "log_f32": (numerics.log_f32, bits),
        "exp_f32": (numerics.exp_f32, bits),
    }
    for sigma in AF_SIGMAS:
        v = torch.from_numpy((rng.standard_normal(1 << 16) * sigma).astype(np.float32))
        cases[f"af_quantize_{sigma:g}"] = (lambda u: numerics.af_quantize(u, spec), v)
    cases["exp2_neg"] = (numerics.exp2_neg, torch.arange(-149, 128, dtype=torch.float32))
    mids = [af_midpoints(b, spec) for b in range(-149, 131)]
    mid_x = torch.from_numpy(np.concatenate([np.concatenate([v, -v]) for v in mids]))
    mid_bias = torch.from_numpy(np.concatenate(
        [np.full(2 * v.size, b, np.float32) for b, v in zip(range(-149, 131), mids)]))

    def midpoints(u, tier):
        with numerics.tier(tier):
            return numerics.af_quantize(u, spec, exp_bias=mid_bias.to(u.device))

    for tier in ("eager", "compiled"):
        cases[f"af_quantize_midpoints_{tier}"] = (lambda u, t=tier: midpoints(u, t), mid_x)

    def ew_start(mode, ea, device):
        """EW_START over the whole grid k * 2^ea, 4096 points a state."""
        g = np.arange(-32767, 32768, dtype=np.float64) * 2.0 ** ea
        g = np.concatenate([g, np.zeros(-g.size % (veu.MAX_ROWS * veu.MAX_COLS))])
        r = np.random.default_rng(-ea)
        outs = []
        for a in torch.from_numpy(g.astype(np.float32)).reshape(-1, veu._WORDS, veu.V):
            b = torch.from_numpy((np.round(r.standard_normal(tuple(a.shape)) * 2 ** 13)
                                  * 2.0 ** -14).astype(np.float32))
            st = {"vec_a": a.to(device), "vec_b": b.to(device),
                  "vec_out": torch.zeros_like(a, device=device),
                  "mode": float(mode), "n_rows": float(veu.MAX_ROWS),
                  "n_cols": float(veu.MAX_COLS), "exp_a": float(ea), "exp_b": -14.0,
                  "exp_o": float(ea + 1) if mode == veu.MODE_MUL else -14.0}
            outs.append(veu._ew_start(st, 0, None)["vec_out"].cpu())
        return torch.stack(outs)

    for mode, name in ((veu.MODE_MUL, "mul"), (veu.MODE_SIGMOID, "sigmoid")):
        for ea in (-13, -14, -15):
            cases[f"vecunit_{name}_{ea}"] = (
                lambda d, m=mode, e=ea: ew_start(m, e, d), None)

    out = {"points": {}, "differ": {}}
    for name, (fn, v) in cases.items():
        if v is None:
            card, cpu = fn(dev), fn("cpu")
        else:
            card, cpu = fn(v.to(dev)).cpu(), fn(v)
        nan = torch.isnan(card) & torch.isnan(cpu)
        # float32 bits: a zero's sign counts
        bad = torch.nonzero(((card.view(torch.int32) != cpu.view(torch.int32)) & ~nan)
                            .reshape(-1)).flatten().tolist()
        flat = v.reshape(-1) if v is not None else None
        out["points"][name] = card.numel()
        out["differ"][name] = [(float(flat[i]) if flat is not None and i < flat.numel()
                                else i, float(card.reshape(-1)[i]), float(cpu.reshape(-1)[i]))
                               for i in bad[:20]] + ([len(bad)] if len(bad) > 20 else [])
    n_bad = {k: len(v) for k, v in out["differ"].items() if v}
    phase("af_exponent", points=sum(out["points"].values()),
          **{f"{k}_differ": len(v) for k, v in out["differ"].items()},
          differing=";".join(f"{k}:{v[:3]!r}" for k, v in out["differ"].items() if v) or "none",
          af_gemm_x_max=",".join(f"2^{k}" for k in AF_POWERS))
    if n_bad:
        raise AssertionError(f"af_exponent: the card differs from the CPU: {n_bad}")
    return out


def ila_linear_order(dev, spec) -> dict:
    """FlexASR's ILA linear sums ``Xq @ Wq^T`` with torch's matmul at
    (B, MAX_TS, MAX_IN) by (MAX_OUT, MAX_IN), one K block of 128; the
    reference's is XLA's dot, the sequential fp32 FMA chain over k that
    ``kernels.ref.af_block_sums`` computes (``tests/test_torch_af_gemm_order.py``
    holds both on the CPU). On the card, at B = 1, 8 and 16, the weight
    shared (the fused tier's matmul) and per sample (the ILA's), on
    full-mantissa N(0, 1) data and on AdaptivFloat lattices whose powers
    are inexact (biases -20 and -8): the outputs whose float32 bits
    differ from the chain. One ``ila_linear_order`` line; a differing
    output fails the run."""
    import numpy as np
    import torch

    from repro_torch.accel import flexasr as fa, numerics
    from repro_torch.kernels import ref

    rng = np.random.default_rng(29)
    out = {}
    for B in (1, 8, 16):
        for data in ("normal", "af"):
            x = torch.from_numpy(rng.standard_normal((B, fa.MAX_TS, fa.MAX_IN)).astype(np.float32))
            w = torch.from_numpy(rng.standard_normal((fa.MAX_OUT, fa.MAX_IN)).astype(np.float32))
            if data == "af":
                x = numerics.af_quantize(x * 2e-5, spec, exp_bias=-20.0)
                w = numerics.af_quantize(w * 0.1, spec, exp_bias=-8.0)
            x, w = x.to(dev), w.to(dev)
            chain = ref.af_block_sums(x, w, one_block=True)
            wb = w.expand(B, *w.shape).contiguous()
            for form, got in (("shared", x @ w.mT), ("per_sample", x @ wb.mT)):
                out[f"B{B}_{data}_{form}"] = int((got.view(torch.int32)
                                                  != chain.view(torch.int32)).sum())
    phase("ila_linear_order", outputs=sum(B * fa.MAX_TS * fa.MAX_OUT for B in (1, 8, 16)) * 4,
          **{f"{k}_differ": v for k, v in out.items()})
    if any(out.values()):
        raise AssertionError(f"ila_linear_order: torch's matmul is not the chain on the card: {out}")
    return out


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


def nvidia_smi() -> list:
    """Each card's name and power limit, a line a card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()


def result_line() -> str:
    """The last line of a run: the device the run passed on."""
    import torch

    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def phase(label: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{label}] {body}", flush=True)


def device_busy(label: str, fn):
    """(wall s, device busy s, top kernels) of one call of ``fn``
    (torch.profiler's CUDA activity; fails if it saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a trace the profiler lost whole is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                       if e.self_device_time_total > 0), key=lambda r: -r[1])
        busy = sum(r[1] for r in rows) / 1e6
        if busy > 0:
            return wall, busy, rows[:15]
    raise AssertionError(f"{label}: the profiler saw no device activity")


def cosim_serve_phase(dev, zero_counts, read_counts, launches_by_path: dict,
                      report: dict) -> dict:
    """Phase 13: CosimServer under the serve launcher's default load; returns
    each application's compiled (program, params)."""
    import numpy as np
    import torch

    from repro_torch.core.serving import REJECT_QUEUE_FULL, CosimServer, percentiles_ms
    from repro_torch.launch.serve import drive_load

    def serve_load(server, app):
        """The serve launcher's load generator at its defaults (arrival asap)."""
        return drive_load(server, app, SERVE_REQUESTS, SERVE_BATCH, SERVE_CONCURRENCY)

    t_phase = time.perf_counter()
    serving = {}
    served_outs = {}
    compiled = {}
    for app in SERVE_APPS:
        for engine in ("pipelined", "fused"):
            t0 = time.perf_counter()
            server = CosimServer(engine=engine, device=dev, queue_depth=SERVE_QUEUE_DEPTH,
                                 max_batch=SERVE_MAX_BATCH,
                                 pipeline_chunk=max(1, min(8, -(-SERVE_BATCH // 2))))
            if app in compiled:
                server.add_program(app, *compiled[app])
            else:
                a = server.add_app(app)   # add_app's defaults: the application's full size
                compiled[app] = (a.program, a.params)
            server.start(warmup=1, warm_batch=SERVE_BATCH)
            torch.cuda.synchronize()
            start_s = time.perf_counter() - t0
            zero_counts()
            handles, load_s = serve_load(server, app)
            launched = read_counts("serve_cosim")
            summ = server.summary()
            stages = server.executor.pipeline_summary()
            # where the time goes, on the fused engine only: the same load
            # once more (new request ids) under the profiler, not counted
            prof = {}
            if engine == "fused":
                t0 = time.perf_counter()
                wall, busy, top = device_busy(f"cosim_serve {app}/{engine}",
                                              lambda: serve_load(server, app))
                prof = {"profiled_wall_s": wall, "device_busy_s": busy,
                        "busy_share": busy / wall, "top_kernels": top,
                        "profile_s": time.perf_counter() - t0}   # with the trace's parsing
            server.close(drain=True)
            zero_counts()
            done = [h for h in handles if h.status == "done"]
            pct = percentiles_ms([h.latency_s for h in done])
            # the same request ids, served one at a time through a draining
            # pipeline (coalesce=False, overlap=False) on the same engine
            serial = CosimServer(engine=engine, device=dev, queue_depth=SERVE_QUEUE_DEPTH,
                                 max_batch=SERVE_MAX_BATCH, coalesce=False, overlap=False,
                                 pipeline_chunk=max(1, min(8, -(-SERVE_BATCH // 2))))
            serial.add_program(app, *compiled[app])
            serial.start(warmup=0)
            ref_handles, serial_s = serve_load(serial, app)
            serial.close(drain=True)
            zero_counts()   # the serial reference's launches are a check's
            outs = {h.id: h.result() for h in done}
            same_serial = len(done) == SERVE_REQUESTS and all(
                len(outs[r.id]) == SERVE_BATCH
                and all(np.array_equal(a, b) for a, b in zip(outs[r.id], r.result()))
                for r in ref_handles)
            finite = all(np.isfinite(o).all() for os_ in outs.values() for o in os_)
            served_outs[(app, engine)] = outs
            row = {"served": len(done), "rejected": summ["rejected"],
                   "coalesced_max": summ["coalesced_max"], "batches": summ["batches"],
                   "qps": len(done) / load_s, "samples_per_s": len(done) * SERVE_BATCH / load_s,
                   "load_s": load_s, "start_s": start_s, **pct,
                   "launches": launched, "equal_serial": same_serial, "finite": finite,
                   "serial_load_s": serial_s,
                   "stages_s": stages, **prof}
            serving[f"{app}:{engine}"] = row
            phase("cosim_serve", app=app, engine=engine,
                  served=f"{len(done)}/{SERVE_REQUESTS}", qps=f"{row['qps']:.2f}",
                  samples_per_s=f"{row['samples_per_s']:.1f}",
                  p50_ms=f"{pct['p50_ms']:.2f}", p95_ms=f"{pct['p95_ms']:.2f}",
                  p99_ms=f"{pct['p99_ms']:.2f}", coalesced_max=summ["coalesced_max"],
                  batches=summ["batches"], start_s=f"{start_s:.2f}",
                  pack_s=f"{stages['pack_s']:.3f}", dispatch_s=f"{stages['dispatch_s']:.3f}",
                  readback_s=f"{stages['readback_s']:.3f}",
                  busy_share=f"{prof['busy_share']:.4f}" if prof else "not_profiled",
                  profile_s=f"{prof['profile_s']:.2f}" if prof else 0,
                  serial_load_s=f"{serial_s:.2f}",
                  af_gemm=launched["af_gemm"], fx_gemm=launched["fx_gemm"],
                  equal_serial=same_serial, finite=finite)
            if len(done) != SERVE_REQUESTS or summ["coalesced_max"] <= 1 or not same_serial \
                    or not finite:
                raise AssertionError(f"cosim_serve {app}/{engine}: {row}")
        fused, piped = served_outs[(app, "fused")], served_outs[(app, "pipelined")]
        same_engines = sorted(fused) == sorted(piped) and all(
            np.array_equal(a, b) for r in fused for a, b in zip(fused[r], piped[r]))
        serving[f"{app}:fused==pipelined"] = same_engines
        if not same_engines:
            raise AssertionError(f"cosim_serve {app}: fused outputs differ from pipelined")
    # admission control and shutdown: a burst of queue_depth + 8 before start
    burst = CosimServer(engine="pipelined", device=dev, queue_depth=SERVE_QUEUE_DEPTH,
                        max_batch=SERVE_MAX_BATCH)
    burst.add_program(SERVE_APPS[0], *compiled[SERVE_APPS[0]])
    handles = [burst.submit(SERVE_APPS[0], batch=1) for _ in range(SERVE_QUEUE_DEPTH + 8)]
    burst.start(warmup=0)
    burst.close(drain=True)
    zero_counts()
    rejected = [h.reject_reason for h in handles if h.rejected]
    queued_after = burst.summary()["queued"]
    all_done = all(h.status == "done" for h in handles if not h.rejected)
    by_path = {k: v.get("serve_cosim", 0) for k, v in launches_by_path.items()}
    phase("cosim_serve_admission", burst=SERVE_QUEUE_DEPTH + 8, rejected=len(rejected),
          reasons="/".join(sorted(set(rejected))), accepted_served=all_done,
          queued_after_close=queued_after, fused_equal_pipelined=all(
              serving[f"{a}:fused==pipelined"] for a in SERVE_APPS),
          af_gemm_launches=by_path["af_gemm"], fx_gemm_launches=by_path["fx_gemm"],
          phase_s=f"{time.perf_counter() - t_phase:.2f}")
    serving["admission"] = {"rejected": len(rejected), "reasons": rejected,
                            "accepted_served": all_done, "queued_after_close": queued_after}
    report["cosim_serve"] = serving
    if rejected != [REJECT_QUEUE_FULL] * 8 or not all_done or queued_after != 0:
        raise AssertionError(f"cosim_serve admission: {serving['admission']}")
    if by_path["af_gemm"] <= 0 or by_path["fx_gemm"] <= 0:
        raise AssertionError(f"serve_cosim launched af_gemm {by_path['af_gemm']} and fx_gemm "
                             f"{by_path['fx_gemm']} times; both must run")
    return compiled


@contextlib.contextmanager
def plain_attention():
    """Training attention in plain ops, forward and backward (the all-plain
    gradient a check compares the kernel-forward one with)."""
    from repro_torch.models import layers

    saved = layers.FlashAttention.apply
    layers.FlashAttention.apply = lambda q, k, v, c, s: layers._attend(q, k, v, c, s)
    try:
        yield
    finally:
        layers.FlashAttention.apply = saved


def bf16_grad_vs_fp32(dev, scfg, model, grads, batch) -> dict:
    """``grads``, the bf16 kernel-forward gradient of ``model`` on ``batch``,
    against the fp32 all-plain gradient on the same weights, upcast: the
    worst leaf's relative L2 error and its name, so that a leaf whose typical
    entry lies far below its largest (the embedding) counts whole. Wrong
    forwards in the kernel's place (TRAIN_GRAD_WRONG) must land beyond
    TRAIN_GRAD_BF16_L2, the kernel within it."""
    import copy

    import torch

    from repro_torch.launch import steps
    from repro_torch.models import layers
    from repro_torch.optim.optimizers import tree_leaves

    names = [n for n, _ in model.named_parameters()]
    with plain_attention():
        _, want = steps.value_and_grad(scfg, copy.deepcopy(model).float(),
                                       steps.batch_to(batch, dev))
    want = tree_leaves(want)

    def worst_l2(got):
        errs = [float((a.float() - b).norm() / b.norm().clamp(min=1e-30))
                for a, b in zip(tree_leaves(got), want)]
        i = max(range(len(errs)), key=errs.__getitem__)
        return errs[i], names[i]

    wrong = {"non_causal": lambda q, k, v, c, s: layers._attend(q, k, v, False, s),
             "scale_x1.1": lambda q, k, v, c, s: layers._attend(q, k, v, c, 1.1 * s)}
    worst = {"kernel": worst_l2(grads)}
    for name in TRAIN_GRAD_WRONG:
        saved = layers._flash
        layers._flash = wrong[name]
        try:
            worst[name] = worst_l2(steps.value_and_grad(scfg, model,
                                                        steps.batch_to(batch, dev))[1])
        finally:
            layers._flash = saved
    phase("lm_train_grad_check", arch=scfg.name, dtype="bf16_vs_fp32", metric="rel_l2",
          tol=TRAIN_GRAD_BF16_L2,
          **{k.replace(".", "_"): f"{e:.3e}@{leaf}" for k, (e, leaf) in worst.items()})
    if worst["kernel"][0] > TRAIN_GRAD_BF16_L2 or any(
            worst[n][0] <= TRAIN_GRAD_BF16_L2 for n in TRAIN_GRAD_WRONG):
        raise AssertionError(f"lm_train gradient check bf16 vs fp32: {worst}")
    return {"tol": TRAIN_GRAD_BF16_L2, **worst}


def lm_train_phase(dev, zero_counts, read_counts, report: dict, cfg, scfg) -> None:
    """Phase 14: ``cfg`` trained through make_train_step; the gradient checks
    at ``scfg``."""
    import copy

    import numpy as np
    import torch

    from repro_torch import optim as roptim
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps as train_steps
    from repro_torch.models import api as lm_api
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.optimizers import tree_leaves

    designs = sorted(flash_attention.launches_by_design)
    def grads_close(got, want, rel):
        """The worst leaf's max |got - want| over its max |want|, and whether
        every leaf is within ``rel``."""
        worst = 0.0
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            a, b = a.detach().float().cpu(), b.detach().float().cpu()
            worst = max(worst, float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)))
        return worst, worst <= rel

    t_phase = time.perf_counter()
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    model = lm_api.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = roptim.make_optimizer("adamw").init(model.tree())
    step_fn = train_steps.make_train_step(cfg, shape, optimizer="adamw", lr=TRAIN_LR,
                                          warmup=2, total_steps=TRAIN_STEPS_LM)
    data = SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    torch.cuda.synchronize()
    train_setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    # every leaf's gradient at step 0: present (value_and_grad raises if not)
    # and finite
    zero_counts()
    loss0, grads = train_steps.value_and_grad(cfg, model, train_steps.batch_to(
        data.batch_at(0), dev))
    torch.cuda.synchronize()
    grad_counts = read_counts("train")
    leaves = tree_leaves(grads)
    n_params = sum(1 for _ in model.parameters())
    grads_finite = len(leaves) == n_params and all(bool(torch.isfinite(g).all())
                                                   for g in leaves)
    del grads, leaves
    losses, norms, secs, per_step = [], [], [], []
    zero_counts()
    for step in range(TRAIN_STEPS_LM):
        before = flash_attention.launches_by_design["wgmma"]
        t0 = time.perf_counter()
        batch = train_steps.batch_to(data.batch_at(step), dev)
        model, opt_state, metrics = step_fn(model, opt_state, batch, step)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(flash_attention.launches_by_design["wgmma"] - before)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launched = read_counts("train")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s_step = float(np.median(secs[1:]))
    # where the time goes: one more step under the profiler, not counted
    state = {}

    def profiled_step():
        state["out"] = step_fn(model, opt_state, train_steps.batch_to(
            data.batch_at(TRAIN_STEPS_LM), dev), TRAIN_STEPS_LM)

    wall, busy, top = device_busy("lm_train", profiled_step)
    model, opt_state, _ = state.pop("out")
    zero_counts()
    train = {"setup_s": train_setup_s, "step_s": secs, "s_per_step": s_step,
             "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / s_step, "peak_mem_gb": peak_gb,
             "losses": losses, "grad_norms": norms, "loss0": float(loss0),
             "grad_leaves": n_params, "grads_finite": grads_finite,
             "grad_check_launches": grad_counts, "launches": launched,
             "wgmma_per_step": per_step, "profiled_step_s": wall, "device_busy_s": busy,
             "busy_share": busy / wall, "top_kernels": top}
    finite = all(np.isfinite(losses)) and all(np.isfinite(norms))
    phase("lm_train", arch=cfg.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS_LM,
          optimizer="adamw", s_per_step=f"{s_step:.4f}", first_step_s=f"{secs[0]:.3f}",
          tokens_per_s=f"{train['tokens_per_s']:.0f}", peak_mem_gb=f"{peak_gb:.2f}",
          loss="/".join(f"{x:.4f}" for x in losses),
          grad_norm="/".join(f"{x:.3f}" for x in norms),
          grad_leaves=f"{n_params}/{n_params}" if grads_finite else "missing_or_nonfinite",
          wgmma_per_step="/".join(map(str, per_step)),
          grad_check_wgmma=grad_counts["flash_attention:wgmma"], finite=finite,
          busy_share=f"{busy / wall:.4f}",
          top="/".join(f"{kernel_label(k)}={us / 1e3:.1f}ms" for k, us, _ in top[:5]))
    report["lm_train"] = train
    others = {k: v for k, v in launched.items() if not k.startswith("flash_attention")}
    want_per_step = 2 * cfg.n_layers   # forward + the remat recompute in backward
    if not finite or not grads_finite or per_step != [want_per_step] * TRAIN_STEPS_LM \
            or launched["flash_attention"] != launched["flash_attention:wgmma"] \
            or launched["flash_attention"] != want_per_step * TRAIN_STEPS_LM \
            or grad_counts["flash_attention:wgmma"] != want_per_step or any(others.values()):
        raise AssertionError(f"lm_train: finite {finite}, grads {grads_finite}, launches "
                             f"{launched} per step {per_step} (want {want_per_step} wgmma)")
    del model, opt_state, step_fn

    # the kernel-forward gradient against the all-plain one, and the card
    # against the CPU, at the smoke config on identical weights
    sbatch = SyntheticLM(scfg.vocab, TRAIN_BATCH, 96, seed=1).batch_at(0)
    grad_check = {}
    for tag, dtype, rel in (("bf16", torch.bfloat16, TRAIN_GRAD_BF16),
                            ("fp32", torch.float32, TRAIN_GRAD_FP32)):
        cpu_model = lm_api.init_params(scfg, torch.Generator().manual_seed(0), dtype=dtype)
        card_model = copy.deepcopy(cpu_model).to(dev)
        before = dict(flash_attention.launches_by_design)
        l_card, g_card = train_steps.value_and_grad(scfg, card_model,
                                                    train_steps.batch_to(sbatch, dev))
        torch.cuda.synchronize()
        design = {d: flash_attention.launches_by_design[d] - before[d] for d in designs}
        with plain_attention():
            l_plain, g_plain = train_steps.value_and_grad(scfg, card_model,
                                                          train_steps.batch_to(sbatch, dev))
        l_cpu, g_cpu = train_steps.value_and_grad(scfg, cpu_model,
                                                  train_steps.batch_to(sbatch, "cpu"))
        vs_plain, ok_plain = grads_close(g_card, g_plain, rel)
        vs_cpu, ok_cpu = grads_close(g_card, g_cpu, rel)
        grad_check[tag] = {"vs_plain": vs_plain, "vs_cpu": vs_cpu, "tol": rel,
                           "launches": design, "loss": [float(l_card), float(l_plain),
                                                        float(l_cpu)]}
        phase("lm_train_grad_check", arch=scfg.name, dtype=tag, tol=rel,
              kernel_vs_plain=f"{vs_plain:.3e}", card_vs_cpu=f"{vs_cpu:.3e}",
              launches="/".join(f"{d}:{n}" for d, n in design.items()))
        if not (ok_plain and ok_cpu) or design[kfa.DESIGNS[dtype]] != 2 * scfg.n_layers:
            raise AssertionError(f"lm_train gradient check {tag}: {grad_check[tag]}")
        if dtype == torch.bfloat16:
            bf16_model, g_bf16 = card_model, g_card
    grad_check["bf16_vs_fp32_l2"] = bf16_grad_vs_fp32(dev, scfg, bf16_model, g_bf16, sbatch)
    zero_counts()
    report["lm_train_grad_check"] = grad_check
    phase("lm_train_done", phase_s=f"{time.perf_counter() - t_phase:.2f}")


def trainer_phase(dev, zero_counts, read_counts, report: dict, out_dir: Path) -> None:
    """Phase 15: the fault-tolerant trainer with TestTrainer's configuration."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig, WorkerFailure

    ckpt_root = out_dir / "trainer_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    tcfg = get_smoke_config("smollm_360m")

    def trainer(name, max_steps, hook):
        return Trainer(tcfg, ShapeConfig("t", 32, 4, "train"), SyntheticLM(tcfg.vocab, 4, 32,
                                                                           seed=1),
                       TrainerConfig(ckpt_dir=str(ckpt_root / name), ckpt_every=10,
                                     max_steps=max_steps, lr=5e-3, warmup=5),
                       failure_hook=hook, device=dev)

    fails = {"n": 0}

    def fail_once(step):
        if step == 15 and fails["n"] == 0:
            fails["n"] += 1
            raise WorkerFailure("injected")

    t_phase = time.perf_counter()
    zero_counts()
    t0 = time.perf_counter()
    run = trainer("restart", 30, fail_once)
    run.run()
    restart_s = time.perf_counter() - t0
    restart_counts = read_counts("train")
    steps_seen = [m["step"] for m in run.metrics if "step" in m]
    tlosses = [m["loss"] for m in run.metrics if "loss" in m]
    restarts = [m for m in run.metrics if m.get("event") == "restart"]
    dts = sorted(m["dt"] for m in run.metrics if "dt" in m)
    # a sleep far above 3x the EWMA of this card's steps
    sleep_s = min(6.0, max(1.0, 30 * dts[len(dts) // 2]))
    slow = {"done": False}

    def sleep_once(step):
        if step == 20 and not slow["done"]:
            slow["done"] = True
            time.sleep(sleep_s)

    zero_counts()
    strag = trainer("straggler", 25, sleep_once)
    strag.run()
    strag_counts = read_counts("train")
    ok_restart = (len(restarts) == 1 and steps_seen.count(10) == 2 and steps_seen.count(0) == 1
                  and tlosses[-1] < tlosses[0] and run.ckpt.all_steps() == [9, 19, 29])
    phase("trainer_restart", arch=tcfg.name, steps=len(steps_seen), restarts=len(restarts),
          step10_runs=steps_seen.count(10), step0_runs=steps_seen.count(0),
          loss=f"{tlosses[0]:.4f}->{tlosses[-1]:.4f}", checkpoints=run.ckpt.all_steps(),
          median_step_s=f"{dts[len(dts) // 2]:.4f}", seconds=f"{restart_s:.2f}",
          straggler_sleep_s=f"{sleep_s:.2f}", stragglers=strag.straggler_steps,
          wgmma_launches=restart_counts["flash_attention:wgmma"]
          + strag_counts["flash_attention:wgmma"], phase_s=f"{time.perf_counter() - t_phase:.2f}")
    report["trainer_restart"] = {"steps": steps_seen, "losses": tlosses,
                                 "checkpoints": run.ckpt.all_steps(), "seconds": restart_s,
                                 "median_step_s": dts[len(dts) // 2], "sleep_s": sleep_s,
                                 "stragglers": strag.straggler_steps,
                                 "launches": [restart_counts, strag_counts]}
    if not ok_restart or 20 not in strag.straggler_steps:
        raise AssertionError(f"trainer_restart: {report['trainer_restart']}")


def spec_trees(arch_ids) -> dict:
    """Every spec tree of the sharding layer (params, AdamW and Adafactor
    state, batch, the decode_32k and, where supported, long_500k caches)
    for each full config on the production meshes, over a fake process
    group of the mesh's world size, on meta tensors: per config and mesh,
    the sharded and replicated leaf counts and the parameter bytes one
    device holds."""
    import math

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import optim as roptim
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as rmesh, sharding as shd, steps as rsteps
    from repro_torch.models import api as lm_api
    from repro_torch.models.config import SHAPES
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    out = {}
    for multi_pod in (False, True):
        world = 512 if multi_pod else 256
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        try:
            mesh = rmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
            sizes = rmesh.axis_sizes(mesh)
            name = "x".join(map(str, mesh.mesh.shape))
            for arch in arch_ids:
                cfg = get_config(arch)
                params = rsteps.abstract_params(cfg)
                pspecs = shd.param_specs(params, mesh)
                trees = {"params": pspecs, "batch": shd.batch_specs(cfg, mesh)}
                for opt in ("adamw", "adafactor"):
                    trees[opt] = rsteps._opt_specs(
                        roptim.make_optimizer(opt).init(params.tree()), pspecs)
                for sname in ("decode_32k", "long_500k"):
                    shape = SHAPES[sname]
                    if lm_api.cell_is_supported(cfg, shape)[0]:
                        trees[sname] = shd.cache_specs(cfg, lm_api.init_cache(
                            cfg, shape.global_batch, shape.seq_len, device="meta"), mesh,
                            shape.global_batch)
                counts = {}
                for key, tree in trees.items():
                    specs = tree_leaves(tree)
                    n_sh = sum(any(a is not None for a in s) for s in specs)
                    counts[key] = (n_sh, len(specs) - n_sh)
                per_dev = []
                tree_map(lambda t, s: per_dev.append(t.numel() * t.element_size() // math.prod(
                    sizes[a] for e in s for a in ((e,) if isinstance(e, str) else e or ()))),
                    params.tree(), pspecs)
                out[f"{arch}@{name}"] = {"leaves": counts, "param_bytes_per_device": sum(per_dev),
                                         "param_bytes": sum(p.numel() * p.element_size()
                                                            for p in params.parameters())}
        finally:
            dist.destroy_process_group()
    return out


def distributed_phase(dev, zero_counts, read_counts, report: dict, smi: str) -> None:
    """Phase 16: the sharding layer on the card. TinyLlama-1.1B trained
    through the sharded step bundle on a 1x1 NCCL mesh against the plain
    step, prefill + decode through the serve bundles against
    ``launch.serve.generate``, and the spec trees of all ten configs at the
    production meshes."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import optim as roptim
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import mesh as rmesh, sharding as shd, steps as rsteps
    from repro_torch.launch.serve import generate
    from repro_torch.models import api as lm_api
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.optimizers import tree_leaves

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    trees = spec_trees(ARCH_IDS)
    trees_s = time.perf_counter() - t0
    for key, v in trees.items():
        phase("dist_specs", config=key, **{k: f"{a}/{b}" for k, (a, b) in v["leaves"].items()},
              param_gb_per_device=f"{v['param_bytes_per_device'] / 1e9:.3f}",
              param_gb=f"{v['param_bytes'] / 1e9:.1f}")

    cfg = get_config(DIST_ARCH)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = rmesh.make_smoke_mesh(device=dev)
        shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
        kw = dict(optimizer="adamw", lr=TRAIN_LR, warmup=1, total_steps=DIST_STEPS)
        model = lm_api.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        opt_state = roptim.make_optimizer("adamw").init(model.tree())
        data = SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
        batches = [rsteps.batch_to(data.batch_at(i), dev) for i in range(DIST_STEPS)]

        def run(fn, model, opt_state):
            metrics, secs, wgmma = [], [], []
            for i, batch in enumerate(batches):
                before = flash_attention.launches_by_design["wgmma"]
                t0 = time.perf_counter()
                model, opt_state, m = fn(model, opt_state, batch, i)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                wgmma.append(flash_attention.launches_by_design["wgmma"] - before)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            return model, opt_state, metrics, secs, wgmma

        plain = rsteps.make_train_step(cfg, shape, **kw)
        zero_counts()
        p_model, p_opt, p_metrics, p_secs, _ = run(plain, model, opt_state)
        zero_counts()
        bundle = rsteps.make_train_step(cfg, shape, mesh, **kw)
        zero_counts()
        s_model, s_opt, s_metrics, s_secs, s_wgmma = run(bundle.fn, model, opt_state)
        launched = read_counts("dist")
        is_dt = all(isinstance(p, DTensor) for p in s_model.parameters())
        worst = {"params": 0.0, "m": 0.0, "v": 0.0}
        for key, got, want in (("params", s_model.tree(), p_model.tree()),
                               ("m", s_opt["m"], p_opt["m"]), ("v", s_opt["v"], p_opt["v"])):
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                a = (a.full_tensor() if isinstance(a, DTensor) else a).detach()
                worst[key] = max(worst[key], float((a.float() - b.detach().float()).abs().max()))
        del p_model, p_opt, s_model, s_opt
        same = p_metrics == s_metrics and not any(worst.values())
        want_per_step = 2 * cfg.n_layers
        phase("dist_train", arch=cfg.name, mesh="1x1", backend="nccl", dtype="bf16",
              batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=DIST_STEPS,
              loss="/".join(f"{a[0]:.6f}" for a in s_metrics),
              grad_norm="/".join(f"{a[1]:.6f}" for a in s_metrics),
              plain_loss="/".join(f"{a[0]:.6f}" for a in p_metrics),
              max_abs_dev="/".join(f"{k}:{v:.3e}" for k, v in worst.items()),
              bit_identical=same, dtensor_params=is_dt,
              wgmma_per_step="/".join(map(str, s_wgmma)),
              s_per_step_dtensor="/".join(f"{x:.4f}" for x in s_secs),
              s_per_step_plain="/".join(f"{x:.4f}" for x in p_secs), card=smi.replace(" ", "_"))
        dist_report = {"spec_trees": trees, "spec_trees_s": trees_s, "train": {
            "loss_grad_norm": s_metrics, "plain_loss_grad_norm": p_metrics, "max_abs_dev": worst,
            "bit_identical": same, "wgmma_per_step": s_wgmma, "launches": launched,
            "s_per_step_dtensor": s_secs, "s_per_step_plain": p_secs, "card": smi}}
        report["distributed"] = dist_report
        others = {k: v for k, v in launched.items() if not k.startswith("flash_attention")}
        if not same or not is_dt or s_wgmma != [want_per_step] * DIST_STEPS \
                or launched["flash_attention"] != launched["flash_attention:wgmma"] \
                or any(others.values()):
            raise AssertionError(f"dist_train: {dist_report['train']}")

        # serving through the bundles at lm_serve's shapes, against generate
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(dev)
        with torch.no_grad():
            want = generate(cfg, model, prompt, DIST_DECODE + 1)
        model = shd.distribute(model, mesh)     # once, as a server would
        sshape = ShapeConfig("serve", LM_PROMPT + DIST_DECODE + 1, LM_BATCH, "decode")
        pre = rsteps.make_serve_step(cfg, sshape, mesh, "prefill")
        dec = rsteps.make_serve_step(cfg, sshape, mesh, "decode")
        cache = lm_api.init_cache(cfg, LM_BATCH, LM_PROMPT + DIST_DECODE + 1, torch.bfloat16,
                                  dev)
        zero_counts()
        t0 = time.perf_counter()
        logits, cache = pre.fn(model, {"tokens": prompt}, cache)
        tok = logits.full_tensor()[:, -1].argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        ids, decode_ms = [tok], []
        for i in range(DIST_DECODE):
            t0 = time.perf_counter()
            logits, cache = dec.fn(model, cache, tok, LM_PROMPT + i)
            tok = logits.full_tensor()[:, -1].argmax(dim=-1, keepdim=True)
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            ids.append(tok)
        serve_counts = read_counts("dist")
        got = torch.cat(ids, dim=1)
        ids_equal = bool(torch.equal(got, want))
        phase("dist_serve", arch=cfg.name, mesh="1x1", batch=LM_BATCH, prompt=LM_PROMPT,
              decode_steps=DIST_DECODE, ids_equal=ids_equal,
              prefill_s=f"{prefill_s:.4f}", first_decode_ms=f"{decode_ms[0]:.3f}",
              decode_ms_per_step=f"{float(np.median(decode_ms[1:])):.3f}",
              prefill_wgmma=serve_counts["flash_attention:wgmma"], card=smi.replace(" ", "_"))
        dist_report["serve"] = {"ids_equal": ids_equal, "prefill_s": prefill_s,
                                "decode_ms": decode_ms, "launches": serve_counts,
                                "ids_head": got[0].tolist()}
        if not ids_equal or serve_counts["flash_attention:wgmma"] != cfg.n_layers:
            raise AssertionError(f"dist_serve: {dist_report['serve']}")
        del model, opt_state, cache
        dist_report["local_shard"] = local_shard_steps_1x1(dev, mesh, kw, zero_counts,
                                                           read_counts)
    finally:
        dist.destroy_process_group()
    if dist.is_initialized():
        raise AssertionError("a process group outlived the distributed phase")
    phase("distributed_done", phase_s=f"{time.perf_counter() - t_phase:.2f}")


def local_shard_steps_1x1(dev, mesh, kw, zero_counts, read_counts) -> dict:
    """Phase 16's local-shard steps on the 1x1 mesh: for each of
    LOCAL_ARCHS at its published widths and LOCAL_LAYERS layers (seeded
    bf16 weights), one sharded train step against the plain step, both
    under ``device.deterministic()`` (the dispatch's index_add and the
    backward of its gathers accumulate with atomics otherwise), gate
    bit-identical; then Falcon-Mamba's prefill + decode through the serve
    bundles (``launch.checks.serve_vs_plain``). The local-shard functions
    (``layers._moe_sharded``, ``ssm._selective_scan_local``,
    ``ssm._in_proj_halves`` and its branch) are counted as they run on
    CUDA tensors."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch import device as devmod, optim as roptim
    from repro_torch.configs import get_config
    from repro_torch.launch import checks, steps as rsteps
    from repro_torch.models import api as lm_api, layers, ssm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.optimizers import tree_leaves

    calls = {"moe_sharded": 0, "selective_scan_local": 0, "in_proj_product": 0,
             "in_proj_weight": 0}
    originals = (layers._moe_sharded, ssm._selective_scan_local, ssm._in_proj_halves,
                 layers.MOE_GROUP)

    def counted(key, fn):
        def call(*args):
            calls[key] += 1
            return fn(*args)
        return call

    def leaves(model, opt):
        return [*tree_leaves(model.tree()), *tree_leaves(opt["m"]), *tree_leaves(opt["v"])]

    def halves(x, w):       # ssm._in_proj_halves' own test of its branch
        product = x.to_local().shape[0] * x.to_local().shape[1] < w.to_local().shape[0]
        calls["in_proj_product" if product else "in_proj_weight"] += 1
        return originals[2](x, w)

    layers._moe_sharded = counted("moe_sharded", originals[0])
    ssm._selective_scan_local = counted("selective_scan_local", originals[1])
    ssm._in_proj_halves = halves
    layers.MOE_GROUP = LOCAL_MOE_GROUP
    torch.cuda.empty_cache()            # Qwen3-MoE's two steps peak at 62.7 GB
    out, failed = {}, []
    try:
        for arch in LOCAL_ARCHS:
            cfg = dataclasses.replace(get_config(arch), n_layers=LOCAL_LAYERS)
            L = cfg.n_layers
            model = lm_api.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
            opt_state = roptim.make_optimizer("adamw").init(model.tree())
            batch = lm_api.make_train_batch(cfg, 8, 64, np.random.default_rng(0), device=dev)
            shape = ShapeConfig("train", 64, 8, "train")
            with devmod.deterministic():
                t0 = time.perf_counter()
                p_model, p_opt, p_metrics = rsteps.make_train_step(cfg, shape, **kw)(
                    model, opt_state, batch, 0)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                # the plain step's parameters and moments wait on the host:
                # two steps' AdamW state do not fit the card beside each
                # other at Qwen3-MoE's width
                want = [t.detach().cpu() for t in leaves(p_model, p_opt)]
                del p_model, p_opt
                torch.cuda.empty_cache()
                bundle = rsteps.make_train_step(cfg, shape, mesh, **kw)
                zero_counts()
                calls.update(dict.fromkeys(calls, 0))
                t0 = time.perf_counter()
                s_model, s_opt, s_metrics = bundle.fn(model, opt_state, batch, 0)
                torch.cuda.synchronize()
                sharded_s = time.perf_counter() - t0
                launched, train_calls = read_counts("dist"), dict(calls)
            worst = 0.0
            for a, b in zip(leaves(s_model, s_opt), want):
                a = (a.full_tensor() if isinstance(a, DTensor) else a).detach()
                worst = max(worst, float((a.float() - b.to(dev).float()).abs().max()))
            del want, s_model, s_opt, opt_state
            metrics = [(float(m["loss"]), float(m["grad_norm"])) for m in (s_metrics, p_metrics)]
            same = metrics[0] == metrics[1] and worst == 0.0
            r = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model,
                 "loss_grad_norm": metrics[0], "plain_loss_grad_norm": metrics[1],
                 "max_abs_dev": worst, "bit_identical": same, "calls": train_calls,
                 "launches": launched, "s_sharded": sharded_s, "s_plain": plain_s}
            # each layer runs twice: the forward and the remat recompute
            bad = [] if same else ["bit_identical"]
            if cfg.n_experts:
                bad += [] if train_calls["moe_sharded"] == 2 * L \
                    and launched["flash_attention:wgmma"] == 2 * L else ["moe calls"]
            else:
                bad += [] if train_calls["selective_scan_local"] == 2 * L \
                    and train_calls["in_proj_product"] == 2 * L else ["mamba1 calls"]
                tokens = torch.from_numpy(np.random.default_rng(1).integers(
                    0, cfg.vocab, (8, LOCAL_PROMPT))).to(dev)
                calls.update(dict.fromkeys(calls, 0))
                with devmod.deterministic(), torch.no_grad():
                    r["serve"] = checks.serve_vs_plain(cfg, model, tokens, mesh, batch=8,
                                                       prompt=LOCAL_PROMPT, gen=LOCAL_GEN,
                                                       device=dev, dtype=torch.bfloat16)
                r["serve_calls"] = dict(calls)
                # prefill: the weight sliced (4096 tokens); decode: the product
                want = {"selective_scan_local": LOCAL_GEN * L, "in_proj_weight": L,
                        "in_proj_product": (LOCAL_GEN - 1) * L}
                bad += [] if all(calls[k] == v for k, v in want.items()) else ["mamba1 serve calls"]
                bad += [] if max(r["serve"]["errs"]) <= LOCAL_LOGITS_TOL else ["logits"]
            del model
            torch.cuda.empty_cache()
            phase("dist_local_shard", arch=cfg.name, layers=L, mesh="1x1", backend="nccl",
                  dtype="bf16", batch=8, seq=64, loss=f"{metrics[0][0]:.6f}",
                  grad_norm=f"{metrics[0][1]:.6f}", plain_loss=f"{metrics[1][0]:.6f}",
                  max_abs_dev=f"{worst:.3e}", bit_identical=same,
                  calls="/".join(f"{k}:{v}" for k, v in train_calls.items() if v),
                  serve_logits_rel=f"{max(r['serve']['errs']):.3e}" if "serve" in r else "-",
                  serve_ids_equal=r["serve"]["same_ids"] if "serve" in r else "-",
                  s_step=f"{sharded_s:.3f}/{plain_s:.3f}", ok=not bad)
            out[arch] = r
            failed += [f"{arch}:{k}" for k in bad]
    finally:
        (layers._moe_sharded, ssm._selective_scan_local, ssm._in_proj_halves,
         layers.MOE_GROUP) = originals
    if failed:
        raise AssertionError(f"dist_local_shard: {failed} {out}")
    return out


def saved_bytes(fn, *args, exclude=()) -> int:
    """Bytes of the storages autograd keeps for backward while ``fn(*args)``
    runs, each storage once, less those of the ``exclude`` tensors (inputs
    and parameters, held anyway); on meta tensors, what they would take."""
    import torch

    skip = {t.untyped_storage()._cdata for t in exclude}
    kept = {}

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in skip:
            kept[st._cdata] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return sum(kept.values())


def remat_predictions(dev) -> dict:
    """Phase 19's predicted drops in peak memory, from what autograd keeps
    (:func:`saved_bytes`) with nothing recomputed (``recompute`` made a
    plain call): a Mamba1 scan step's bytes (12 steps less 4, at
    Falcon-Mamba-7B's widths, on ``dev``), so the one-chunk baseline keeps
    S - 256 steps more and 15 chunk starting states fewer; one MoE group's
    bytes at Qwen3-MoE's widths on meta tensors (nothing allocated), of
    which the baseline keeps three more (the chunked run rebuilds one group
    at a time). ``python -c "import chip_smoke as c;
    print(c.remat_predictions('cpu'))"`` gives them on the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import layers, ssm

    plain = lambda fn, *a: fn(*a)
    arch, B, S = REMAT_MAMBA
    cfg = get_config(arch)
    di, N = cfg.d_inner, cfg.ssm_state

    def scan_bytes(steps):
        leaf = lambda *shape: torch.rand(*shape, device=dev).requires_grad_(True)
        args = (leaf(B, steps, di), leaf(B, steps, di), leaf(B, steps, N), leaf(B, steps, N),
                -leaf(di, N), leaf(di))
        return saved_bytes(ssm._selective_scan, *args, exclude=args)

    orig = ssm.recompute
    ssm.recompute = plain
    try:
        step = (scan_bytes(12) - scan_bytes(4)) // 8
    finally:
        ssm.recompute = orig
    state = B * di * N * 4
    chunks = S // ssm.SSM_CHUNK
    mamba = (S - ssm.SSM_CHUNK) * step - (chunks - 1) * state

    arch, B, S = REMAT_MOE
    mcfg = get_config(arch)
    E, D, F = mcfg.n_experts, mcfg.d_model, mcfg.d_expert_ff
    meta = lambda shape, dtype=torch.bfloat16: torch.empty(
        shape, dtype=dtype, device="meta").requires_grad_(True)
    p = {"router": meta((D, E), torch.float32), "w_gate": meta((E, D, F)),
         "w_up": meta((E, D, F)), "w_down": meta((E, F, D))}
    x = meta((layers.MOE_GROUP, D))
    routed = layers._route(mcfg, x, p["router"])
    group = saved_bytes(layers._moe_group, mcfg, p, x, routed,
                        exclude=[x, *routed, *p.values()])
    groups = B * S // layers.MOE_GROUP
    return {"mamba1_step_bytes": step, "mamba1_drop_bytes": mamba,
            "moe_group_bytes": group, "moe_drop_bytes": (groups - 1) * group}


def remat_memory_phase(dev, zero_counts, read_counts, report: dict, smi: str) -> None:
    """Phase 19: the memory that recomputing in backward saves, each layer
    alone at its published widths (REMAT_MAMBA, REMAT_MOE), forward and
    backward against a fixed upstream gradient under
    ``device.deterministic()``; a peak is ``max_memory_allocated`` above
    the inputs and parameters. Mamba1: ``ssm.mamba1_block`` chunked, then
    with ``ssm.SSM_CHUNK`` = S (one chunk of S steps, whose backward keeps
    every step). MoE: ``layers.moe_ffn`` (each group recomputed), then the
    same routing and four ``layers._moe_group`` calls with nothing
    recomputed; then both on the 1x1 NCCL mesh through
    ``layers._moe_sharded`` (its pieces recomputed, then ``layers.recompute``
    made a plain call). Gates: outputs and gradients bit-identical, the
    drop at least REMAT_MIN_SHARE of the predicted one
    (:func:`remat_predictions`), no kernel launched."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import device as devmod
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as rmesh, sharding as shd
    from repro_torch.models import layers, ssm

    t_phase = time.perf_counter()
    pred = remat_predictions(dev)
    gib = 2.0 ** 30
    plain = lambda fn, *a: fn(*a)

    def measured(fn):
        """(fn()'s outputs and gradients as plain tensors, peak bytes above
        what was allocated before, seconds)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with devmod.deterministic():
            got = [t.full_tensor() if isinstance(t, DTensor) else t for t in fn()]
        torch.cuda.synchronize()
        return got, torch.cuda.max_memory_allocated() - base, time.perf_counter() - t0

    def grads(out, leaves, g):
        return [out.detach(), *torch.autograd.grad(out, leaves, g)]

    results, failed = {}, []

    def record(name, cfg, tokens, runs, predicted, **extra):
        (a, peak_a, s_a), (b, peak_b, s_b) = runs
        same = len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))
        drop = peak_b - peak_a
        ok = same and drop >= REMAT_MIN_SHARE * predicted
        r = {"arch": cfg.name, "tokens": tokens, "peak_bytes": peak_a,
             "baseline_peak_bytes": peak_b, "drop_bytes": drop, "predicted_drop_bytes": predicted,
             "bit_identical": same, "s": s_a, "baseline_s": s_b, "card": smi, **extra}
        results[name] = r
        phase("remat_memory", layer=name, arch=cfg.name, tokens=tokens,
              peak_gib=f"{peak_a / gib:.3f}", baseline_peak_gib=f"{peak_b / gib:.3f}",
              drop_gib=f"{drop / gib:.3f}", predicted_drop_gib=f"{predicted / gib:.3f}",
              bit_identical=same, s=f"{s_a:.2f}/{s_b:.2f}",
              **{k: v for k, v in extra.items()}, card=smi.replace(" ", "_"))
        if not ok:
            failed.append(name)

    zero_counts()
    torch.cuda.empty_cache()
    # Mamba1: one block, chunked against one chunk of S steps
    arch, B, S = REMAT_MAMBA
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {k: v.requires_grad_(True) for k, v in ssm.mamba1_params(cfg, gen).items()}
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    x.requires_grad_(True)
    g = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    block = lambda: grads(ssm.mamba1_block(cfg, p, x)[0], [x, *p.values()], g)
    runs = [measured(block)]
    chunk = ssm.SSM_CHUNK
    ssm.SSM_CHUNK = S
    try:
        runs.append(measured(block))
    finally:
        ssm.SSM_CHUNK = chunk
    record("mamba1_block", cfg, f"{B}x{S}", runs, pred["mamba1_drop_bytes"],
           chunks=S // chunk, step_mib=f"{pred['mamba1_step_bytes'] / 2 ** 20:.3f}")
    del p, x, g, runs

    # MoE: moe_ffn's groups recomputed, against the same groups kept
    arch, B, S = REMAT_MOE
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {k: v.requires_grad_(True) for k, v in layers.moe_params(cfg, gen).items()}
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    x.requires_grad_(True)
    g = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    leaves = [x, *p.values()]

    def kept():
        x2 = x.reshape(B * S, cfg.d_model)
        routed = zip(*(t.split(layers.MOE_GROUP) for t in
                       (x2, *layers._route(cfg, x2, p["router"]))))
        return torch.cat([layers._moe_group(cfg, p, xg, (gv, gi))
                          for xg, gv, gi in routed]).reshape(B, S, cfg.d_model)

    groups = B * S // layers.MOE_GROUP
    runs = [measured(lambda: grads(layers.moe_ffn(cfg, p, x), leaves, g)),
            measured(lambda: grads(kept(), leaves, g))]
    record("moe_ffn", cfg, f"{B}x{S}", runs, pred["moe_drop_bytes"], groups=groups,
           group_gib=f"{pred['moe_group_bytes'] / gib:.3f}")
    del runs

    # the same layer through _moe_sharded on the 1x1 NCCL mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = rmesh.make_smoke_mesh(device=dev)
        dp = {"router": shd.place(p["router"].detach(), (Replicate(), Replicate()), mesh),
              **{k: shd.place(p[k].detach(), (Replicate(), Shard(0)), mesh)
                 for k in ("w_gate", "w_up", "w_down")}}
        dx = shd.place(x.detach(), (Shard(0), Replicate()), mesh)
        dg = shd.place(g, (Shard(0), Replicate()), mesh)
        dleaves = [t.requires_grad_(True) for t in (dx, *dp.values())]

        def sharded():
            with implicit_replication(), layers.mesh_hints(mesh):
                return grads(layers.moe_ffn(cfg, dp, dx), dleaves, dg)

        runs = [measured(sharded)]
        recompute = layers.recompute
        layers.recompute = plain
        try:
            runs.append(measured(sharded))
        finally:
            layers.recompute = recompute
        record("moe_ffn_sharded", cfg, f"{B}x{S}", runs, pred["moe_drop_bytes"],
               groups=groups, mesh="1x1", backend="nccl")
        del runs, dp, dx, dg, dleaves
    finally:
        dist.destroy_process_group()
    del p, x, g, leaves
    torch.cuda.empty_cache()
    launched = read_counts("remat")
    if any(launched.values()):
        failed.append(f"launches {launched}")
    report["remat_memory"] = {"predicted": pred, "layers": results, "launches": launched,
                              "card": smi}
    phase("remat_memory_done", phase_s=f"{time.perf_counter() - t_phase:.2f}")
    if failed:
        raise AssertionError(f"remat_memory: {failed} {results}")


def _gloo_job(mesh_shape, archs) -> dict:
    """One rank of phase 18: ``launch.checks.local_shard_case`` of each
    smoke config of ``archs`` on a ``mesh_shape`` ("data", "model") mesh,
    on the port's seeded fp32 weights (MoE: ``checks.MOE_CAPACITY`` and
    ``checks.MOE_GROUP``)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import checks, mesh as rmesh
    from repro_torch.models import api as lm_api, layers

    layers.MOE_GROUP = checks.MOE_GROUP
    mesh = rmesh.make_mesh(mesh_shape, ("data", "model"), device="cpu")
    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=checks.MOE_CAPACITY)
        model = lm_api.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
        batch = lm_api.make_train_batch(cfg, 8, 64, np.random.default_rng(0), device="cpu")
        out[arch] = checks.local_shard_case(cfg, model, batch, mesh,
                                            serve=arch != GLOO_SEQ_SPLIT)
    return out


def gloo_phase(report: dict, out_dir: Path) -> None:
    """Phase 18: the local-shard paths (the MoE dispatch, the Mamba1 scan,
    the o-projection after a sequence split) on 4 gloo processes of the
    host's CPU, under the card's PyTorch, against the unsharded step."""
    from repro_torch.launch import checks

    t_phase = time.perf_counter()
    results, failed = {}, []
    tmp = out_dir / "gloo"
    for mesh_shape, archs in GLOO_CASES.items():
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        t0 = time.perf_counter()
        try:
            out = checks.spawn(_gloo_job, (mesh_shape, archs), GLOO_WORLD, tmp,
                               GLOO_TIMEOUT_S)[0]
        except Exception as e:
            raise AssertionError(f"gloo_cpu {mesh_shape}: {e}") from e
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        mesh_name = "x".join(map(str, mesh_shape))
        for arch, r in out.items():
            bad = checks.failures(r, seq_split=arch == GLOO_SEQ_SPLIT)
            t = r["train"]
            rel = {k: abs(t[k][0] - t[k][1]) / abs(t[k][1]) for k in ("loss", "grad_norm")}
            phase("gloo_cpu", on="host_cpu_on_purpose", arch=arch, mesh=mesh_name,
                  loss_rel=f"{rel['loss']:.2e}", grad_norm_rel=f"{rel['grad_norm']:.2e}",
                  m=f"{t['m']:.2e}", v=f"{t['v']:.2e}", params=f"{t['params']:.2e}",
                  logits=f"{max(r['serve']['errs']):.2e}" if "serve" in r else "-",
                  drops="/".join(map(str, r["drops"])), ok=not bad)
            results[f"{arch}@{mesh_name}"] = r
            failed += [f"{arch}@{mesh_name}:{k}" for k in bad]
        results[f"seconds@{mesh_name}"] = time.perf_counter() - t0
    report["gloo_cpu"] = results
    if failed:
        raise AssertionError(f"gloo_cpu: {failed}")
    phase("gloo_cpu_done", phase_s=f"{time.perf_counter() - t_phase:.2f}")


def dryrun_phase(report: dict, smi: str) -> None:
    """Phase 17: the dry-run's cells on the card's host, and the roofline
    bound of phase 14's step beside its measured s/step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPES, ShapeConfig
    from repro_torch.roofline import analysis

    t_phase = time.perf_counter()
    cells = []
    for arch, shape in DRYRUN_CELLS:
        c = dryrun.run_cell(arch, shape)
        cells.append(c)
        fields = {"status": c["status"], "seconds": c["seconds"]}
        if c["status"] == "ok":
            terms = analysis.roofline_terms(c, get_config(arch), SHAPES[shape])
            c["roofline"] = terms
            fields.update(acct_flops=f"{c['acct_flops']:.4e}",
                          collective_gb=f"{c['collectives']['bytes']['total'] / 1e9:.3f}",
                          resident_gb=f"{c['resident_bytes_per_dev'] / 1e9:.3f}",
                          fits_h100=c["fits_h100"],
                          bound_ms=f"{terms['roofline_bound_s'] * 1e3:.3f}",
                          dominant=terms["dominant"], trips=c["trips"])
        else:
            fields["error"] = c["error"][:200]
        phase("dryrun_cell", arch=arch, shape=shape, mesh=c["mesh"], **fields)
    cfg = get_config(LM_ARCH)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    step = dryrun.one_device_train_cell(cfg, shape, "adamw")
    terms = analysis.roofline_terms(step, cfg, shape)
    measured = report["lm_train"]["s_per_step"]
    phase("dryrun_lm_train_roofline", arch=cfg.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
          flops=f"{step['acct_flops']:.4e}", bytes_gb=f"{step['acct_bytes'] / 1e9:.3f}",
          t_compute_ms=f"{terms['t_compute_s'] * 1e3:.3f}",
          t_memory_ms=f"{terms['t_memory_s'] * 1e3:.3f}",
          bound_ms=f"{terms['roofline_bound_s'] * 1e3:.3f}", dominant=terms["dominant"],
          measured_s_per_step=f"{measured:.4f}",
          measured_over_bound=f"{measured / terms['roofline_bound_s']:.2f}",
          count_s=f"{time.perf_counter() - t0:.2f}", peaks="h100_sxm_published",
          card=smi.replace(" ", "_"))
    report["dryrun"] = {"cells": cells, "lm_train_step": step, "lm_train_roofline": terms,
                        "lm_train_measured_s_per_step": measured, "card": smi,
                        "phase_s": time.perf_counter() - t_phase}
    failed = [f"{c['arch']}:{c['shape']}" for c in cells if c["status"] != "ok"]
    if failed:
        raise AssertionError(f"dry-run cells failed: {failed}")
    phase("dryrun_done", phase_s=f"{time.perf_counter() - t_phase:.2f}")


def flash_calls(cfg, steps: int) -> dict:
    """flash_attention calls, read from the model code, of one prefill, of
    ``steps`` decode steps after it and of one no-cache forward (the audio
    family: ``encode`` + ``decode_train``) of ``cfg``. Every attention
    without a cache goes through ``layers.sdpa``, and so does GQA's
    prefill (``gqa_attention`` at cache_pos 0); GQA's decode and MLA's
    cached (absorbed) path attend in plain ops. Zamba2 attends once per
    group of ``attn_every`` SSM layers (``lm._blocks``). Whisper's decode
    (``whisper.decode_step``) runs each layer's cross-attention through
    the kernel on every step, and its first step, at position 0, each
    self-attention too: ``gqa_attention`` takes its cache_pos 0 branch."""
    if cfg.family == "audio":
        return {"prefill": cfg.n_enc_layers,
                "decode": cfg.n_dec_layers * (steps + (steps > 0)),
                "forward": cfg.n_enc_layers + 2 * cfg.n_dec_layers}
    attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}.get(cfg.family,
                                                                             cfg.n_layers)
    return {"prefill": 0 if cfg.use_mla else attn, "decode": 0, "forward": attn}


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _activation_bytes(cfg, B: int, S: int, gen: int) -> int:
    """A reckoning of what one layer of a bf16 prefill of B x S tokens
    (Whisper: its encoder over AUDIO_ENC_FRAMES) holds at once at its
    widest, and the last position's logits: per token the widest of the
    residual stream's four tensors, attention's q, k, v and output with
    their (B, H, S, D) copies, the GLU's three (B, S, d_ff), Mamba1's x|z
    and four fp32 (d_inner) tensors, Mamba2's projection and three fp32
    ones; plus MoE's gathered slots, buffer and expert GLU, MLA's fp32
    latent scores (three of them) and the SSD's decay blocks."""
    from repro_torch.models.api import AUDIO_ENC_FRAMES

    T = B * (AUDIO_ENC_FRAMES if cfg.family == "audio" else S)
    d, hd8 = cfg.d_model, -(-cfg.hd // 8) * 8
    per_token = [4 * d * 2, 2 * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd8 * 2,
                 3 * cfg.d_ff * 2]
    H = cfg.d_inner // cfg.ssm_head_dim if cfg.family == "hybrid" else 0
    if cfg.family == "ssm":
        per_token.append(2 * cfg.d_inner * 2 + 4 * cfg.d_inner * 4)
    if cfg.family == "hybrid":
        per_token.append((2 * cfg.d_inner + 2 * cfg.ssm_state + H) * 2 + 3 * cfg.d_inner * 4)
    out = T * max(per_token) + B * cfg.vocab * 4
    if cfg.n_experts:
        C = max(8, int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts))
        out += (3 * T * cfg.top_k * d + 2 * cfg.n_experts * C * d
                + 3 * cfg.n_experts * C * cfg.d_expert_ff) * 2
    if cfg.use_mla:
        out += 3 * B * cfg.n_heads * S * (S + gen) * 4 + T * cfg.n_heads * cfg.kv_lora_rank * 2
    if cfg.family == "hybrid":
        c = min(256, S)
        out += 2 * B * (S // c) * H * c * c * 4
    return out


def family_plan() -> dict:
    """Phase 20's plan, computed on meta tensors (nothing allocated), one
    entry per configuration of ``ARCH_IDS`` (LM_ARCH's too, which phase 10
    serves): ``cfg``, ``get_config(arch)`` with its depth cut only where
    the bf16 weights and the set-up's peak (every weight, and the largest
    one's fp32 draw and bf16 copy beside it: ``layers.normal``) would pass
    FAMILY_MEM_LIMIT, to the most layers that stay below it; ``reduced``,
    each field changed, as (published, served); ``param_bytes``;
    ``peak_bytes``, the reckoned peak (set-up, or weights + cache +
    :func:`_activation_bytes`, whichever is larger); ``launches``, the
    flash_attention launches ``generate`` makes in prefill and in decode
    (all FAMILY_GEN - 1 steps; :func:`flash_calls`); ``fp32_cfg``, the
    consistency check's config (depth FAMILY_FP32_LAYERS or 2 at published
    widths, or the smoke config where 2 layers' fp32 weights pass the
    limit; MoE capacity E / top_k, where C = T: no drops), ``fp32_base``
    ("published" or "smoke"), ``fp32_reduced`` against that base and
    ``fp32_launches`` (forward + prefill + decode)."""
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.launch.steps import abstract_params
    from repro_torch.models import api as lm_api
    from repro_torch.models.ssm import SSM_CHUNK

    def weights(cfg):
        sizes = [p.numel() * p.element_size() for p in abstract_params(cfg).parameters()]
        return sum(sizes), max(sizes)

    def changed(base, cfg):
        return {f.name: (getattr(base, f.name), getattr(cfg, f.name))
                for f in dataclasses.fields(cfg) if getattr(base, f.name) != getattr(cfg, f.name)}

    B, P, G = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN
    plan = {}
    for arch in ARCH_IDS:
        pub = cfg = get_config(arch)
        params, largest = weights(cfg)
        if params + 2 * largest > FAMILY_MEM_LIMIT:
            one, _ = weights(dataclasses.replace(pub, n_layers=1))
            two, _ = weights(dataclasses.replace(pub, n_layers=2))
            depth = int((FAMILY_MEM_LIMIT - 2 * largest - one) // (two - one)) + 1
            cfg = dataclasses.replace(pub, n_layers=max(1, min(depth, pub.n_layers)))
            params, largest = weights(cfg)
        audio = cfg.family == "audio"
        cache = _nbytes(lm_api.init_cache(cfg, B, (0 if audio else P) + G, device="meta"))
        calls = flash_calls(cfg, G - 1)

        depth = FAMILY_FP32_LAYERS.get(arch, 2)
        base, fcfg = pub, pub if depth is None else dataclasses.replace(pub, n_layers=depth)
        if 2 * weights(fcfg)[0] > FAMILY_MEM_LIMIT:
            base = fcfg = get_smoke_config(arch)
        if fcfg.n_experts:
            fcfg = dataclasses.replace(fcfg, capacity_factor=fcfg.n_experts / fcfg.top_k)
        # a hybrid forward's length must split into whole SSD chunks
        # (mamba2_ssd, the reference's too, takes S <= SSM_CHUNK or a
        # multiple of it): its prompt + SSM_CHUNK + 1 generated tokens
        fgen = SSM_CHUNK + 1 if fcfg.family == "hybrid" else G
        fcalls = flash_calls(fcfg, fgen - 1)
        plan[arch] = {
            "cfg": cfg, "reduced": changed(pub, cfg), "param_bytes": params,
            "peak_bytes": max(params + 2 * largest,
                              params + cache + _activation_bytes(cfg, B, P, G)),
            "launches": {"prefill": calls["prefill"], "decode": calls["decode"]},
            "fp32_cfg": fcfg, "fp32_base": "smoke" if base is not pub else "published",
            "fp32_reduced": changed(base, fcfg), "fp32_gen": fgen,
            "fp32_launches": fcalls["forward"] + fcalls["prefill"] + fcalls["decode"],
        }
    return plan


def family_inputs(cfg, batch: int, length: int, device, dtype, seed: int = 0):
    """A prompt as ``launch.serve.serve_llm`` draws it from numpy's
    generator at ``seed``: token ids (batch, length), or for the audio
    family stub frames (batch, AUDIO_ENC_FRAMES, d_model) in ``dtype``."""
    import numpy as np
    import torch

    from repro_torch.models import api as lm_api

    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        frames = rng.standard_normal((batch, lm_api.AUDIO_ENC_FRAMES, cfg.d_model))
        return torch.from_numpy(frames).to(device, dtype)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, length))).to(device)


def decode_vs_forward(cfg, model, prompt, gen: int):
    """Greedy prefill + gen - 1 decode steps against one no-cache forward
    over the same tokens (phase 11's check; the audio family starts from
    token 0 and its forward is ``encode`` + ``decode_train``): (max
    |decode - forward| / max |forward| at the decoded positions, every
    logit finite)."""
    import torch

    from repro_torch.models import api as lm_api, whisper

    B, audio = prompt.shape[0], cfg.family == "audio"
    start = 0 if audio else prompt.shape[1]
    dtype = model["tok_embed" if audio else "embed"].dtype
    cache = lm_api.init_cache(cfg, B, start + gen, dtype, prompt.device)
    logits, cache = lm_api.prefill(cfg, model, prompt, cache)
    pick = lambda lg: lg[:, -1].argmax(dim=-1, keepdim=True)
    tok = torch.zeros((B, 1), dtype=torch.long, device=prompt.device) if audio else pick(logits)
    dec, toks = ([] if audio else [logits[:, 0]]), [tok]
    for i in range(gen - 1):
        logits, cache = lm_api.decode_step(cfg, model, cache, tok, start + i)
        tok = pick(logits)
        dec.append(logits[:, 0])
        toks.append(tok)
    inp = torch.cat(toks[:-1], dim=1)
    if audio:
        enc = whisper.encode(cfg, model, prompt, remat=False)
        full = whisper.decode_train(cfg, model, inp, enc, remat=False)
    else:
        full = lm_api.forward(cfg, model, torch.cat([prompt, inp], dim=1), remat=False)
        full = full[:, start - 1:]
    dec = torch.stack(dec, dim=1)
    rel = float((dec - full).abs().max() / full.abs().max())
    return rel, bool(torch.isfinite(full).all() and torch.isfinite(dec).all())


def card_vs_cpu(scfg, dev, batch: int, prompt_len: int, steps: int, zero_counts,
                read_counts):
    """``scfg`` on identical seeded fp32 weights on the card and on the CPU:
    a prefill of ``prompt_len`` tokens (the audio family: stub frames), then
    ``steps`` teacher-forced decode steps; every step's logits compared.
    Returns (max |card - CPU|, allclose within LM_CPU_TOL, the launch
    counts of the card's run, read by ``read_counts()``)."""
    import copy

    import numpy as np
    import torch

    from repro_torch.models import api as lm_api

    def logits(model, prompt, tokens):
        start = 0 if scfg.family == "audio" else prompt.shape[1]
        cache = lm_api.init_cache(scfg, batch, start + steps, torch.float32, prompt.device)
        out, cache = lm_api.prefill(scfg, model, prompt, cache)
        outs = [out]
        for i in range(steps):
            out, cache = lm_api.decode_step(scfg, model, cache, tokens[:, i:i + 1], start + i)
            outs.append(out)
        return torch.cat(outs, dim=1)

    cpu_model = lm_api.init_params(scfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    card_model = copy.deepcopy(cpu_model).to(dev)
    prompt = family_inputs(scfg, batch, prompt_len, "cpu", torch.float32, seed=1)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, scfg.vocab, (batch, steps)))
    zero_counts()
    card = logits(card_model, prompt.to(dev), tokens.to(dev)).cpu()
    counts = read_counts()
    cpu = logits(cpu_model, prompt, tokens)
    return (float((card - cpu).abs().max()),
            bool(torch.allclose(card, cpu, rtol=LM_CPU_TOL, atol=LM_CPU_TOL)), counts)


def lm_families_phase(dev, zero_counts, read_counts, report: dict, smi: str) -> None:
    """Phase 20: every configuration but LM_ARCH served on the card at its
    published widths by :func:`family_plan`, held in fp32 against its own
    forward and at the smoke config against the CPU (the module docstring
    says what each gate holds). A family that fails is recorded and the
    next one runs; the phase raises after the last if any failed."""
    import traceback

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import api as lm_api

    t_phase = time.perf_counter()
    plan = family_plan()
    gb = 1e9
    fmt = lambda cut: ",".join(f"{k}:{a}->{b}" for k, (a, b) in cut.items()) or "none"
    results, failed = {}, []
    for arch, fp in plan.items():
        if arch == LM_ARCH:
            continue
        cfg, t_fam = fp["cfg"], time.perf_counter()
        r = results[arch] = {"config": cfg.name, "layers": cfg.n_layers,
                             "reduced": fmt(fp["reduced"]), "param_gb": fp["param_bytes"] / gb,
                             "predicted_peak_gb": fp["peak_bytes"] / gb,
                             "expected_launches": fp["launches"], "card": smi}
        model = None
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            model = lm_api.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
            prompt = family_inputs(cfg, FAMILY_BATCH, FAMILY_PROMPT, dev, torch.bfloat16)
            generate(cfg, model, prompt, 2)   # warm-up
            torch.cuda.synchronize()
            r["setup_s"] = time.perf_counter() - t_fam
            zero_counts()
            stats = {}
            tokens = generate(cfg, model, prompt, FAMILY_GEN, stats)
            counts = read_counts("families")
            r.update(
                prefill_s=stats["prefill_s"],
                decode_ms_per_step=stats["decode_s"] / stats["decode_steps"] * 1e3,
                peak_gb=(torch.cuda.max_memory_allocated() - base) / gb,
                prefill_launches=stats["prefill_launches"],
                decode_launches=stats["decode_launches"], launches=counts,
                finite=stats["finite"],
                in_vocab=bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
                shape_ok=tuple(tokens.shape) == (FAMILY_BATCH, FAMILY_GEN))
            model = None
            want = fp["launches"]["prefill"] + fp["launches"]["decode"]
            others = {k: v for k, v in counts.items() if not k.startswith("flash_attention")}
            r["serve_ok"] = (r["shape_ok"] and r["in_vocab"] and r["finite"]
                             and (r["prefill_launches"], r["decode_launches"])
                             == (fp["launches"]["prefill"], fp["launches"]["decode"])
                             and counts["flash_attention"] == counts["flash_attention:wgmma"]
                             == want and not any(others.values()))

            # fp32: forward against prefill + decode
            fcfg = fp["fp32_cfg"]
            torch.cuda.empty_cache()
            model = lm_api.init_params(fcfg, torch.Generator(device=dev).manual_seed(0),
                                       dtype=torch.float32)
            prompt = family_inputs(fcfg, FAMILY_BATCH, FAMILY_PROMPT, dev, torch.float32)
            zero_counts()
            rel, finite = decode_vs_forward(fcfg, model, prompt, fp["fp32_gen"])
            torch.cuda.synchronize()
            counts = read_counts("families")
            model = None
            r.update(fp32_config=f"{fp['fp32_base']}:{fmt(fp['fp32_reduced'])}",
                     fp32_max_rel_dev=rel, fp32_finite=finite, fp32_launches=counts,
                     fp32_ok=finite and rel < LM_CONSISTENCY_TOL
                     and counts["flash_attention"] == counts["flash_attention:wgmma3"]
                     == fp["fp32_launches"])

            # the smoke config on identical fp32 weights: card against CPU
            scfg = get_smoke_config(arch)
            dev_abs, close, counts = card_vs_cpu(
                scfg, dev, FAMILY_BATCH, FAMILY_CPU_PROMPT, FAMILY_CPU_STEPS, zero_counts,
                functools.partial(read_counts, "families"))
            calls = flash_calls(scfg, FAMILY_CPU_STEPS)
            r.update(cpu_max_abs_dev=dev_abs, cpu_launches=counts,
                     cpu_ok=close and counts["flash_attention:wgmma3"]
                     == counts["flash_attention"] == calls["prefill"] + calls["decode"])
        except Exception:   # recorded, and raised after the last family
            r["error"] = traceback.format_exc(limit=6)
            print(r["error"], file=sys.stderr, flush=True)
        finally:
            model = prompt = None
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        r["s"] = time.perf_counter() - t_fam
        ok = all(r.get(k) for k in ("serve_ok", "fp32_ok", "cpu_ok")) and "error" not in r
        if not ok:
            failed.append(arch)
        num = lambda k, f: f.format(r[k]) if k in r else "not_run"
        phase("lm_families", arch=cfg.name, layers=cfg.n_layers, reduced=r["reduced"],
              batch=FAMILY_BATCH, prompt=FAMILY_PROMPT, gen=FAMILY_GEN,
              param_gb=f"{r['param_gb']:.2f}", peak_gb=num("peak_gb", "{:.2f}"),
              predicted_peak_gb=f"{r['predicted_peak_gb']:.2f}",
              prefill_s=num("prefill_s", "{:.4f}"),
              decode_ms_per_step=num("decode_ms_per_step", "{:.3f}"),
              launches=f"{r.get('prefill_launches')}/{r.get('decode_launches')}",
              expected=f"{fp['launches']['prefill']}/{fp['launches']['decode']}",
              wgmma=r.get("launches", {}).get("flash_attention:wgmma"),
              finite=r.get("finite"), in_vocab=r.get("in_vocab"),
              fp32=r.get("fp32_config"), fp32_gen=fp["fp32_gen"],
              fp32_max_rel_dev=num("fp32_max_rel_dev", "{:.3e}"),
              fp32_wgmma3=r.get("fp32_launches", {}).get("flash_attention:wgmma3"),
              cpu_max_abs_dev=num("cpu_max_abs_dev", "{:.3e}"), ok=ok, s=f"{r['s']:.2f}",
              card=smi.replace(" ", "_"))
    report["lm_families"] = results
    phase("lm_families_done", families=len(results), failed=",".join(failed) or "none",
          phase_s=f"{time.perf_counter() - t_phase:.2f}")
    if failed:
        raise AssertionError(f"lm_families: {failed} failed: "
                             + json.dumps({a: results[a] for a in failed}, default=str))


@contextlib.contextmanager
def shard_devices_seen():
    """The devices of every sharded group's shards, where the Executor joins
    them (``codegen.to_numpy``), one list per group, in mesh order."""
    from repro_torch.core import codegen, ila

    seen = []
    join = codegen.to_numpy

    def recording(v):
        if isinstance(v, ila.Shards):
            seen.append([s.device for s in v])
        return join(v)

    codegen.to_numpy = recording
    try:
        yield seen
    finally:
        codegen.to_numpy = join


def stream_mesh_phase(dev, zero_counts, read_counts, peek_counts, report: dict, smi: str,
                      resmlp, resnet_prep, served_resmlp, groups: int) -> None:
    """Phase 21: the ILA stream mesh. Every card when the host has more than
    one, else a two-way mesh on ``dev`` repeated; each case runs mesh off,
    then on (a fresh Executor or server each, its outputs read once before
    its timed pass): the Table-4 ResMLP row on FlexASR (compiled, pipelined,
    fused; 40 points), the ResNet-20 fused-16 column, and the serve
    launcher's default co-sim load on ResMLP (pipelined). Gates: outputs
    bit-identical on against off, accuracies equal, af_gemm / fx_gemm
    launches of the timed passes on path "mesh" equal to the mesh size
    times the unsharded reckoning (and the unsharded runs equal to it),
    every shard on its mesh device."""
    import numpy as np
    import torch

    from repro_torch.core import cosim, ila
    from repro_torch.core.codegen import Executor
    from repro_torch.core.serving import CosimServer
    from repro_torch.launch import table4
    from repro_torch.launch.serve import drive_load

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(cards)] if cards > 1 else [dev, dev]
    kind = "cards" if cards > 1 else "repeated"
    program, params, X, y = resmlp
    # unsharded launches a timed pass makes: one af_gemm per fused FlexASR
    # linear group (7 linears in ResMLP, 1 in ResNet-20), one fx_gemm per
    # fused HLSCNN conv group (7 convs); a mesh launches each group once per
    # shard
    cases = {
        "resmlp:compiled": (lambda: Executor("ila", engine="compiled", device=dev), {}),
        "resmlp:pipelined": (lambda: Executor("ila", engine="pipelined", device=dev), {}),
        "resmlp:fused": (lambda: Executor("ila", engine="fused", device=dev),
                         {"af_gemm": 7 * groups}),
        "resnet20:fused-16": (lambda: table4.executor("fused-16", dev),
                              {"af_gemm": groups, "fx_gemm": 7 * groups}),
    }
    rows, failed = {}, []
    for case, (make, unsharded) in cases.items():
        app, column = case.split(":")
        row = {}
        for on in (False, True):
            mesh = ila.set_stream_mesh(devices if on else None)
            ex = make()
            with shard_devices_seen() as seen:
                if app == "resmlp":
                    outs = np.stack([o.reshape(-1) for o in cosim.eval_outputs(
                        program, params, lambda i: X[i], range(N_EVAL), ex)])
                    zero_counts()
                    acc, sec = cosim.eval_classification(program, params, X, y, ex, N_EVAL)
                else:
                    outs = table4.logits(resnet_prep, ex, N_EVAL)
                    zero_counts()
                    acc, sec = table4.evaluate(resnet_prep, ex, N_EVAL)
                torch.cuda.synchronize()
                launched = read_counts("mesh") if on else peek_counts()
            ila.set_stream_mesh(None)
            zero_counts()
            want = {k: n * (len(devices) if on else 1) for k, n in unsharded.items()}
            row["on" if on else "off"] = {
                "accuracy": acc, "s_per_point": sec, "outs": outs,
                "launches": {k: launched[k] for k in ("af_gemm", "fx_gemm")}, "want": want,
                "sharded_groups": len(seen),
                "placed": all(d == list(mesh.devices) for d in seen) if on else not seen}
        off, on_ = row["off"], row["on"]
        same = bool(np.array_equal(off["outs"], on_["outs"]))
        ok = (same and off["accuracy"] == on_["accuracy"] and on_["placed"] and off["placed"]
              and on_["sharded_groups"] > 0 and np.isfinite(on_["outs"]).all()
              and on_["outs"].shape == (N_EVAL, 10)
              and all(r["launches"] == {k: r["want"].get(k, 0) for k in ("af_gemm", "fx_gemm")}
                      for r in (off, on_)))
        phase("stream_mesh", case=case, cards=cards, mesh=kind, size=len(devices),
              points=N_EVAL, acc_off=f"{off['accuracy']:.3f}", acc_on=f"{on_['accuracy']:.3f}",
              s_per_pt_off=f"{off['s_per_point']:.7f}", s_per_pt_on=f"{on_['s_per_point']:.7f}",
              launches_off="/".join(str(v) for v in off["launches"].values()),
              launches_on="/".join(str(v) for v in on_["launches"].values()),
              sharded_groups=on_["sharded_groups"], placed=on_["placed"],
              bit_identical=same, ok=ok, card=smi.replace(" ", "_"))
        rows[case] = {k: {kk: vv for kk, vv in v.items() if kk != "outs"}
                      for k, v in row.items()}
        rows[case]["bit_identical"] = same
        if not ok:
            failed.append(case)

    # the serve launcher's default co-sim load on ResMLP, mesh off then on
    served = {}
    for on in (False, True):
        mesh = ila.set_stream_mesh(devices if on else None)
        t0 = time.perf_counter()
        server = CosimServer(engine="pipelined", device=dev, queue_depth=SERVE_QUEUE_DEPTH,
                             max_batch=SERVE_MAX_BATCH,
                             pipeline_chunk=max(1, min(8, -(-SERVE_BATCH // 2))))
        server.add_program("resmlp", *served_resmlp)
        server.start(warmup=1, warm_batch=SERVE_BATCH)
        torch.cuda.synchronize()
        start_s = time.perf_counter() - t0
        zero_counts()
        with shard_devices_seen() as seen:
            handles, load_s = drive_load(server, "resmlp", SERVE_REQUESTS, SERVE_BATCH,
                                         SERVE_CONCURRENCY)
            server.close(drain=True)
        launched = read_counts("mesh") if on else peek_counts()
        ila.set_stream_mesh(None)
        zero_counts()
        done = [h for h in handles if h.status == "done"]
        served["on" if on else "off"] = {
            "outs": {h.id: h.result() for h in done}, "served": len(done),
            "qps": len(done) / load_s, "load_s": load_s, "start_s": start_s,
            "coalesced_max": server.summary()["coalesced_max"],
            "launches": {k: launched[k] for k in ("af_gemm", "fx_gemm")},
            "sharded_groups": len(seen),
            "placed": all(d == list(mesh.devices) for d in seen) if on else not seen}
    off, on_ = served["off"], served["on"]
    same = sorted(off["outs"]) == sorted(on_["outs"]) and all(
        len(off["outs"][r]) == len(on_["outs"][r])
        and all(np.array_equal(a, b) for a, b in zip(off["outs"][r], on_["outs"][r]))
        for r in off["outs"])
    ok = (same and off["served"] == on_["served"] == SERVE_REQUESTS and on_["placed"]
          and off["placed"] and on_["sharded_groups"] > 0
          and not any(off["launches"].values()) and not any(on_["launches"].values()))
    phase("stream_mesh", case="serve:resmlp:pipelined", cards=cards, mesh=kind,
          size=len(devices), requests=SERVE_REQUESTS, batch=SERVE_BATCH,
          served=f"{off['served']}/{on_['served']}", qps_off=f"{off['qps']:.3f}",
          qps_on=f"{on_['qps']:.3f}", load_s_off=f"{off['load_s']:.3f}",
          load_s_on=f"{on_['load_s']:.3f}", coalesced_max=f"{off['coalesced_max']}/"
          f"{on_['coalesced_max']}", sharded_groups=on_["sharded_groups"],
          placed=on_["placed"], bit_identical=same, ok=ok, card=smi.replace(" ", "_"))
    rows["serve:resmlp:pipelined"] = {k: {kk: vv for kk, vv in v.items() if kk != "outs"}
                                      for k, v in served.items()}
    rows["serve:resmlp:pipelined"]["bit_identical"] = same
    if not ok:
        failed.append("serve:resmlp:pipelined")
    report["stream_mesh"] = {"cards": cards, "mesh": kind, "devices": [str(d) for d in devices],
                             "rows": rows, "card": smi,
                             "phase_s": time.perf_counter() - t_phase}
    phase("stream_mesh_done", cards=cards, mesh=kind, size=len(devices),
          failed=",".join(failed) or "none", phase_s=f"{time.perf_counter() - t_phase:.2f}")
    if failed:
        raise AssertionError(f"stream_mesh: {failed} failed: "
                             + json.dumps({c: rows[c] for c in failed}, default=str))


def nccl_plan(cards: int) -> dict:
    """Phase 22's meshes on a host of ``cards`` cards (two or more):
    {mesh shape: ((arch, "smoke" or "published"), ...)}, each in turn over
    one spawned NCCL group, a process per card. Four cards or more: phase 18's cases
    (GLOO_CASES) on the first four, and NCCL_ARCH published on
    NCCL_PUBLISHED_MESHES; two or three: 2x2's configs on a 1x2 mesh and
    4x1's on 2x1 (the first two cards), NCCL_ARCH published on both."""
    if cards < 2:
        raise ValueError(f"an NCCL mesh needs two cards or more, this host has {cards}")
    if cards >= GLOO_WORLD:
        cases = {m: tuple((a, "smoke") for a in archs) for m, archs in GLOO_CASES.items()}
        meshes = NCCL_PUBLISHED_MESHES
    else:
        cases = {m: tuple((a, "smoke") for a in GLOO_CASES[g])
                 for m, g in (((1, 2), (2, 2)), ((2, 1), (4, 1)))}
        meshes = tuple(cases)
    for m in meshes:
        cases[m] += ((NCCL_ARCH, "published"),)
    return cases


def nccl_flash_calls(cfg, serve: bool) -> int:
    """flash_attention launches one rank of a phase-22 case makes, read
    from the model code (``flash_calls``): the plain and the sharded train
    step each run every attention layer twice (the forward and its
    recompute in backward; the backward itself is plain) and DeepSeek-V3's
    multi-token-prediction block once (``lm.loss_fn``, outside the
    recompute), and with ``serve`` the plain and the sharded prefill once
    a layer each (the rank's local head shard); decode attends in plain
    ops."""
    calls = flash_calls(cfg, 0)
    train = 2 * calls["forward"] + cfg.mtp_depth
    return 2 * train + (2 * calls["prefill"] if serve else 0)


def _nccl_job(plan: dict) -> dict:
    """One rank of phase 22: for each mesh shape of ``plan`` (``nccl_plan``),
    a ("data", "model") mesh over the group on this rank's device (its card
    under NCCL), then ``launch.checks.local_shard_case`` of each (arch,
    "smoke" or "published") config there, on seeded fp32 weights made on
    the device (MoE: ``checks.MOE_CAPACITY`` and ``checks.MOE_GROUP``),
    each with its seconds, its flash_attention launches per design, the
    rank's device and its peak memory; keyed "arch:width@DxM"."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import checks, mesh as rmesh
    from repro_torch.models import api as lm_api, layers
    from repro_torch.models.config import ShapeConfig

    cuda = dist.get_backend() == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    layers.MOE_GROUP = checks.MOE_GROUP
    shape = ShapeConfig(*checks.TRAIN_SHAPE)
    out = {}
    for mesh_shape, cases in plan.items():
        mesh = rmesh.make_mesh(mesh_shape, ("data", "model"), device=dev)
        for i in range(mesh.ndim):      # every dim's communicator up before the cases
            dist.all_reduce(torch.ones(1, device=dev), group=mesh.get_group(i))
        for arch, width in cases:
            cfg = get_config(arch) if width == "published" else get_smoke_config(arch)
            if cfg.n_experts:
                cfg = dataclasses.replace(cfg, capacity_factor=checks.MOE_CAPACITY)
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            model = lm_api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                       torch.float32)
            batch = lm_api.make_train_batch(cfg, shape.global_batch, shape.seq_len,
                                            np.random.default_rng(0), device=dev)
            kfa.reset_launches()
            t0 = time.perf_counter()
            r = checks.local_shard_case(cfg, model, batch, mesh, serve=arch != GLOO_SEQ_SPLIT)
            r["seconds"] = time.perf_counter() - t0
            r["launches"] = dict(kfa.flash_attention.launches_by_design)
            r["device"] = str(dev)
            r["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
            out[f"{arch}:{width}@{'x'.join(map(str, mesh_shape))}"] = r
            del model, batch
            if cuda:
                torch.cuda.empty_cache()
    return out


def _run_group(cmd, env, timeout: float):
    """(exit code, stdout, stderr) of ``cmd`` in a session of its own; past
    ``timeout`` seconds the whole session is killed (torchrun's ranks
    included) and TimeoutError raised."""
    import os
    import signal

    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise TimeoutError(f"{' '.join(map(str, cmd))} ran past {timeout} s") from None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, out, err


def nccl_launcher(cards: int, out_dir: Path) -> dict:
    """Phase 22c: ``torchrun --nproc-per-node cards -m
    repro_torch.launch.train --arch NCCL_LAUNCH[0] --smoke --steps
    NCCL_LAUNCH[1]`` from the checkout: rank 0's losses and mesh line, the
    other ranks' "fewer than 256 devices" lines with the card each named,
    the exit code and the seconds."""
    import math
    import os

    arch, steps = NCCL_LAUNCH
    ckpt = out_dir / "nccl_launch_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={cards}", "-m", "repro_torch.launch.train", "--arch", arch,
           "--smoke", "--steps", str(steps), "--ckpt-dir", str(ckpt)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    try:
        rc, out, err = _run_group(cmd, env, NCCL_TIMEOUT_S)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    others = {int(m.group(1)): m.group(3) for m in re.finditer(
        r"rank (\d+) of (\d+): fewer than \d+ devices, rank 0 trains on one \((\S+)\)", out)}
    loss = re.search(r"loss (\S+) -> (\S+) over (\d+) steps", out)
    mesh = re.search(r"training \S+ on (\S+) mesh (\{[^}]*\})", out)
    r = {"rc": rc, "seconds": time.perf_counter() - t0, "other_ranks": others,
         "loss": (float(loss.group(1)), float(loss.group(2))) if loss else None,
         "steps": int(loss.group(3)) if loss else 0,
         "mesh": f"{mesh.group(1)}:{mesh.group(2)}" if mesh else None,
         "stdout_tail": out[-2000:], "stderr_tail": err[-4000:]}
    r["ok"] = (rc == 0 and r["loss"] is not None and all(map(math.isfinite, r["loss"]))
               and r["steps"] == steps and others == {k: f"cuda:{k}" for k in range(1, cards)})
    return r


def nccl_phase(report: dict, smi: str, cards: int, out_dir: Path) -> dict:
    """Phase 22: the sharded train and serve steps over NCCL, a process per
    card (``nccl_plan``), against the plain step on each rank's own card,
    gated by ``launch.checks.failures``; flash_attention launches per rank
    against ``nccl_flash_calls``; then the train launcher under torchrun.
    Returns the launches per design summed over the ranks (path "nccl").
    On a one-card host: one line, nothing run (NCCL cannot put two ranks on
    one card; phase 16 runs the 1x1 NCCL mesh)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import checks

    card = smi.replace(" ", "_")
    if cards < 2:
        phase("nccl_mesh", cards=cards, ran=False,
              reason="nccl_puts_one_rank_on_a_card_and_this_host_has_one",
              covered_by="phase16_1x1_nccl_mesh", card=card)
        report["nccl_mesh"] = {"cards": cards, "ran": False}
        return {}
    t_phase = time.perf_counter()
    plan = nccl_plan(cards)
    world = 4 if cards >= GLOO_WORLD else 2
    results, failed, launched = {"cards": cards, "world": world}, [], {}
    tmp = out_dir / "nccl"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:        # one group for every mesh: a spawn costs ~30 s of start-up
        ranks = checks.spawn(_nccl_job, (plan,), world, tmp, NCCL_TIMEOUT_S, backend="nccl")
    except Exception as e:
        raise AssertionError(f"nccl_mesh: {e}") from e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["group_s"] = time.perf_counter() - t_phase
    for mesh_shape, cases in plan.items():
        mesh_name = "x".join(map(str, mesh_shape))
        for arch, width in cases:
            key = f"{arch}:{width}@{mesh_name}"
            cfg = get_config(arch) if width == "published" else get_smoke_config(arch)
            seq_split = arch == GLOO_SEQ_SPLIT
            want = nccl_flash_calls(cfg, serve=not seq_split)
            per_rank = [rr[key] for rr in ranks]
            bad = sorted({k for rr in per_rank for k in checks.failures(rr, seq_split)})
            devices = [rr["device"] for rr in per_rank]
            if devices != [f"cuda:{i}" for i in range(world)]:
                bad.append("devices")
            got = [rr["launches"] for rr in per_rank]
            if any(g.get("wgmma3", 0) != want or sum(g.values()) != want for g in got):
                bad.append("launches")
            for d in got[0]:
                launched[d] = launched.get(d, 0) + sum(g.get(d, 0) for g in got)
            r = per_rank[0]
            t = r["train"]
            rel = {k: abs(t[k][0] - t[k][1]) / abs(t[k][1]) for k in ("loss", "grad_norm")}
            phase("nccl_mesh", arch=arch, width=width, layers=cfg.n_layers, mesh=mesh_name,
                  backend="nccl", cards=cards, loss_rel=f"{rel['loss']:.2e}",
                  grad_norm_rel=f"{rel['grad_norm']:.2e}", m=f"{t['m']:.2e}",
                  v=f"{t['v']:.2e}", params=f"{t['params']:.2e}",
                  logits=f"{max(r['serve']['errs']):.2e}" if "serve" in r else "-",
                  ids_equal=r["serve"]["same_ids"] if "serve" in r else "-",
                  drops="/".join(map(str, r["drops"])),
                  s_per_step_sharded=f"{t['s_sharded']:.4f}",
                  s_per_step_plain=f"{t['s_plain']:.4f}", case_s=f"{r['seconds']:.2f}",
                  collectives=",".join(f"{k}:{v}" for k, v in sorted(t["counts"].items())),
                  flash_per_rank="/".join(str(sum(g.values())) for g in got), flash_want=want,
                  peak_gb=f"{max(rr['peak_gb'] for rr in per_rank):.2f}",
                  devices=",".join(devices), ok=not bad, card=card)
            results[key] = {"ranks": per_rank, "flash_want": want, "failures": bad}
            failed += [f"{key}:{k}" for k in bad]
    launch = nccl_launcher(cards, out_dir)
    phase("nccl_launcher", arch=NCCL_LAUNCH[0], smoke=True, nproc_per_node=cards,
          rc=launch["rc"], steps=launch["steps"], mesh=launch["mesh"],
          loss="->".join(f"{x:.4f}" for x in launch["loss"] or ()) or "none",
          other_ranks=",".join(f"{k}:{v}" for k, v in sorted(launch["other_ranks"].items())),
          seconds=f"{launch['seconds']:.2f}", ok=launch["ok"], cards=cards, card=card)
    results["launcher"] = launch
    if not launch["ok"]:
        failed.append("launcher")
    results["launches"] = launched
    results["seconds"] = time.perf_counter() - t_phase
    report["nccl_mesh"] = results
    if failed:
        raise AssertionError(f"nccl_mesh: {failed}")
    phase("nccl_mesh_done", cards=cards, world=world,
          flash_wgmma3=launched.get("wgmma3", 0), phase_s=f"{results['seconds']:.2f}",
          card=card)
    return launched


def nccl_only() -> int:
    """``--nccl``: phase 22 alone, over the host's cards (two or more; a
    one-card host exits non-zero), after building flash_attention's kernel,
    which every rank loads. Prints the phase's lines, the nvidia-smi lines
    and the result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"chip_smoke --nccl: an NCCL mesh needs two cards or more, this host has "
              f"{cards}", file=sys.stderr)
        return 2
    from repro_torch import device as devmod
    from repro_torch.kernels import build

    devmod.resolve("cuda")
    smi = nvidia_smi()
    phase("build", **{k: f"{v:.1f}s" for k, v in build.build(["flash_attention_sm90"]).items()})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = {"nvidia_smi": smi}
    try:
        nccl_phase(report, smi[0], cards, out_dir)
    finally:
        (out_dir / "chip_smoke_nccl.json").write_text(json.dumps(report, indent=1,
                                                                 default=str))
    print("\n".join(smi))
    print(result_line())
    return 0


def stream_mesh_only() -> int:
    """``--stream-mesh``: phase 21 alone, over every card of the host (the
    two-way repeated mesh on a one-card host), after the set-up it needs:
    af_gemm and fx_gemm built, the ResMLP and ResNet-20 rows trained as
    phases 4 and 5 train them, the served ResMLP compiled as phase 13 does.
    Prints the phase's lines, the nvidia-smi line and the result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import device as devmod
    from repro_torch.core import apps, cosim
    from repro_torch.core.codegen import Executor
    from repro_torch.core.compile import compile_program
    from repro_torch.core.serving import CosimServer
    from repro_torch.kernels import build
    from repro_torch.kernels.af_gemm import af_gemm
    from repro_torch.kernels.fx_gemm import fx_gemm
    from repro_torch.launch import table4

    dev = devmod.resolve("cuda")
    smi = nvidia_smi()
    phase("build", **{k: f"{v:.1f}s" for k, v in build.build(["af_gemm", "fx_gemm"]).items()})
    wrappers = {"af_gemm": af_gemm, "fx_gemm": fx_gemm}
    by_path = {}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def peek_counts():
        return {name: w.launches for name, w in wrappers.items()}

    def read_counts(path):
        counts = peek_counts()
        for name, n in counts.items():
            by_path.setdefault(name, {}).setdefault(path, 0)
            by_path[name][path] += n
        return counts

    builder = lambda seed=0: apps.build_resmlp(seed=seed, layers=2)
    expr, params = builder()
    X, y = cosim.make_teacher_task(builder, (16, 64), n=512, device=dev)
    trained = cosim.train_app(expr, params, X, y, steps=TRAIN_STEPS, lr=3e-3, device=dev)
    res = compile_program(expr, targets=("flexasr",), flexible=True)
    resnet_prep = table4.prepare(table4.APPS["resnet20"], dev, TRAIN_STEPS)
    served = CosimServer(device=dev).add_app("resmlp")
    fused = Executor("ila", engine="fused", device=dev)
    batch = cosim._pipeline_batch(fused, 16)
    groups = sum(-(-min(batch, N_EVAL - i) // fused.pipeline_chunk)
                 for i in range(0, N_EVAL, batch))
    report = {}
    stream_mesh_phase(dev, zero_counts, read_counts, peek_counts, report, smi[0],
                      (res.program, trained, X, y), resnet_prep,
                      (served.program, served.params), groups)
    report["launches_by_path"] = by_path
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_stream_mesh.json").write_text(json.dumps(report, indent=1,
                                                                    default=str))
    print("\n".join(smi))
    print(result_line())
    return 0


def main() -> int:
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

    t_start = time.perf_counter()
    report = {}
    dev = devmod.resolve("cuda")
    wrappers = {"af_gemm": af_gemm, "fx_gemm": fx_gemm, "int8_gemm": int8_gemm,
                "flash_attention": flash_attention}
    designs = sorted(flash_attention.launches_by_design)   # wgmma, wgmma3
    #: per kernel (flash_attention in all and per design, "flash_attention:
    #: wgmma"), launches summed over every main-path run (read per path)
    path_launches = {name: 0 for name in list(wrappers) + [f"flash_attention:{d}"
                                                           for d in designs]}
    #: the same launches per path: "table4" (phases 4-7), "vt3", "lm" (10-12),
    #: "serve_cosim" (13), "train" (14-15), "dist" (16), "families" (20),
    #: "mesh" (21), "nccl" (22: the ranks' launches, summed)
    launches_by_path = {name: {} for name in path_launches}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0
        kfa.reset_launches()

    def peek_counts():
        """The counts as they stand, added to no path (a check's launches)."""
        return {name: w.launches for name, w in wrappers.items()}

    def read_counts(path="table4"):
        counts = {name: w.launches for name, w in wrappers.items()}
        counts.update({f"flash_attention:{d}": n
                       for d, n in flash_attention.launches_by_design.items()})
        for name, n in counts.items():
            path_launches[name] += n
            launches_by_path[name][path] = launches_by_path[name].get(path, 0) + n
        return counts

    # 1. device -------------------------------------------------------------
    smi = nvidia_smi()[0]
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
        # x's largest magnitude at a power of two (the exponent's hard points)
        **{f"x_max_2^{k}": af_power_case(k, rng, dev, spec) for k in AF_POWERS},
        f"x_midpoints_{AF_MID_BIAS}": af_midpoint_case(rng, dev, spec),
        # zero sums whose sign the reference's padding of K sets
        **{f"signed_zero_1x16x16x{kk}": af_signed_zero_case(dev, kk) for kk in (48, 64, 128)},
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
            diff = (got.double() - want.double()).nan_to_num(0.0)
            err = float(diff.abs().max()) if got.numel() else 0.0
            worst_kernel[kname] = max(worst_kernel[kname], err)
            # af_gemm bit for bit, the sign of a zero included
            if not (equal_bits if kname == "af_gemm" else equal_nan)(got, want):
                mismatched.append(f"{kname}:{name}")
            elif not bool(torch.isfinite(want).all()):
                mismatched.append(f"{kname}:{name} (not finite)")
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
        # phase 15's trainer (SmolLM smoke, head dim 20 padded to 24)
        "smollm_trainer": (4, 3, 1, 32, 32, 24, True),
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
    report["af_exponent"] = af_exponent_card_vs_cpu(dev, spec)
    report["ila_linear_order"] = ila_linear_order(dev, spec)
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
    # VecUnit computes the reference's exp2 and exp: its rows equal the CPU's
    t2_bad = {k: v for k, v in t2_dev.items()
              if (v[0] != v[1] if k.startswith("VecUnit/") else abs(v[0] - v[1]) > v[2])}
    if not (all(vt1.values()) and all(vt2.values()) and all(r["ok"] for r in t3)
            and len(t3) == 8 and vt3_ok and not t2_bad
            and [(r.accelerator, r.operation) for r in t2] == list(table2.TABLE2_INTRINSICS)):
        raise AssertionError(f"validate: vt1 {vt1} vt2 {vt2} table3 {t3} vt3 {vt3} "
                             f"table2 card vs cpu outside tol (VecUnit: not equal): {t2_bad}")
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

    def call_ms(fn, iters=200, warm=10):
        """Wall time per eager call (host launch overhead included)."""
        for _ in range(warm):
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
                   "gemma_fp32", "smollm_trainer_bf16")
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
        # plain, kernel, kernel, plain: the two versions in turns.
        # af_gemm's plain version runs its fp32 chain one k at a time (a
        # dozen launches a k, milliseconds a call): fewer calls of it
        few = {"reps": 2, "iters": 3} if kname == "af_gemm" else {}
        runs = [graph_ms(plain, **few), graph_ms(kern), graph_ms(kern), graph_ms(plain, **few)]
        calls = [call_ms(kern), call_ms(plain, **({"iters": 3, "warm": 1} if few else {}))]
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

    profile_tries = report["cuda_profile_tries"] = {}

    def cuda_kernels(fn, label, calls=5, tries=3):
        fn()
        torch.cuda.synchronize()
        for attempt in range(1, tries + 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            # a kernel seen at all ran in every call: round the count up, so an
            # event the profiler drops cannot hide a kernel
            seen = {e.key: (-(-e.count // calls), e.self_device_time_total / e.count)
                    for e in prof.key_averages() if e.self_device_time_total > 0
                    and not e.key.startswith(("Memcpy", "Memset"))}
            profile_tries[label] = attempt
            # every call launches at least one kernel, so a trace with none is
            # one the profiler lost whole: profile again; a trace with kernels
            # is taken as it is
            if seen:
                return seen
        return seen

    def flash_call(name):
        args, causal = flash_cases[name]
        return lambda: flash_attention(*args, causal=causal)

    per_kernel = {label: cuda_kernels(fn, label) for label, fn in (
        ("af_gemm", lambda: af_gemm(*af_shapes["fused_8x128x256x128"], spec=spec)),
        ("fx_gemm", lambda: fx_kernel(*fx_shapes["fused_8x144x32x800_w16"])),
        ("int8_gemm", lambda: int8_gemm(*i8_shapes["vta_tok_64x16x16"])),
        ("flash_attention", flash_call("tinyllama_prefill_bf16")),
        ("flash_attention_fp32", flash_call("tinyllama_prefill_fp32")))}
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
          profile_tries="/".join(f"{k}:{v}" for k, v in profile_tries.items()),
          kernel_us="/".join(f"{kernel_label(name)}={us:.3f}"
                             for v in report["cuda_kernel_us"].values()
                             for name, us in v.items()))
    report["timing"] = timings
    report["launch_floor_ms"] = floor_ms

    # 9. where the time goes: device busy share over one fused minibatch ------
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
    del cache
    model.float()
    zero_counts()
    rel, finite = decode_vs_forward(cfg, model, prompt, LM_GEN)
    torch.cuda.synchronize()
    counts = read_counts("lm")
    phase("lm_consistency", dtype="float32", positions=LM_GEN, max_rel_dev=f"{rel:.3e}",
          flash_launches=counts["flash_attention"],
          wgmma3_launches=counts["flash_attention:wgmma3"], finite=finite)
    report["lm_consistency"] = {"max_rel_dev": rel, "launches": counts, "finite": finite}
    del model
    if not finite or not rel < LM_CONSISTENCY_TOL \
            or counts["flash_attention:wgmma3"] != 2 * cfg.n_layers:
        raise AssertionError(f"lm_consistency: relative deviation {rel}, finite {finite}, "
                             f"launches {counts}")

    # 12. the smoke config on identical fp32 weights: card against CPU --------
    scfg = get_smoke_config(LM_ARCH)
    dev_abs, close, counts = card_vs_cpu(scfg, dev, LM_BATCH, 96, 0, zero_counts,
                                         functools.partial(read_counts, "lm"))
    phase("lm_cpu_parity", arch=scfg.name, prompt=96, max_abs_dev=f"{dev_abs:.3e}",
          allclose=close, flash_launches=counts["flash_attention"])
    report["lm_cpu_parity"] = {"max_abs_dev": dev_abs, "allclose": close, "launches": counts}
    if not close or counts["flash_attention"] != scfg.n_layers:
        raise AssertionError(f"lm_cpu_parity: card vs CPU {dev_abs}, launches {counts}")

    # 13-15. co-simulation serving, LM training, the fault-tolerant trainer
    served_apps = cosim_serve_phase(dev, zero_counts, read_counts, launches_by_path, report)
    lm_train_phase(dev, zero_counts, read_counts, report, get_config(LM_ARCH),
                   get_smoke_config(LM_ARCH))
    trainer_phase(dev, zero_counts, read_counts, report, out_dir)
    # 16. the sharding layer on the card
    distributed_phase(dev, zero_counts, read_counts, report, smi)
    # 17. the dry-run and the roofline (no kernel runs)
    dryrun_phase(report, smi)
    # 18. the local-shard paths on 4 gloo processes of the host's CPU
    gloo_phase(report, out_dir)
    # 19. the memory that recomputing in backward saves (no kernel runs)
    remat_memory_phase(dev, zero_counts, read_counts, report, smi)
    # 20. every other configuration served at its published widths
    lm_families_phase(dev, zero_counts, read_counts, report, smi)
    # 21. the ILA stream mesh: the simulators' batch axis split over devices
    stream_mesh_phase(dev, zero_counts, read_counts, peek_counts, report, smi,
                      (res.program, trained, X, y), resnet_prep, served_apps["resmlp"], groups)
    # 22. the sharded steps over NCCL, a process per card (one line on one card)
    torch.cuda.empty_cache()        # card 0 is rank 0's too
    for design, n in nccl_phase(report, smi, torch.cuda.device_count(), out_dir).items():
        for name in ("flash_attention", f"flash_attention:{design}"):
            path_launches[name] += n
            launches_by_path[name]["nccl"] = launches_by_path[name].get("nccl", 0) + n

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
    report["seconds"] = time.perf_counter() - t_start
    phase("total", seconds=f"{report['seconds']:.1f}")
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(result_line())
    return 0


if __name__ == "__main__":
    sys.exit({"--stream-mesh": stream_mesh_only, "--nccl": nccl_only}.get(
        " ".join(sys.argv[1:]), main)())
