"""Serving launcher: prefill + batched greedy decode over a KV cache, or a
continuous-batching co-simulation service over the accelerator ILAs.

Port of ``repro/launch/serve.py``. LLM decode (``serve_llm``):

    python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        [--smoke] [--batch 4] [--prompt 16] [--gen 16] [--seed 0] [--device cuda]

Weights are seeded (a ``torch.Generator`` on the device), bf16 as in the
reference. Every prefill attention goes through the flash_attention kernel on
the card; decode attends over the cache in plain ops. ``--device cpu`` runs
the kernels' plain versions (use ``--smoke`` there).

Co-sim serving (``serve_cosim``):

    python -m repro_torch.launch.serve --cosim resmlp --devices-per-target 2 \
        [--requests 16] [--batch 2] [--engine pipelined] [--mesh auto] [--warmup 1] \
        [--concurrency 4] [--queue-depth 16] [--arrival poisson:8] \
        [--max-batch 0] [--no-coalesce] [--no-overlap] [--device cuda]

compiles the named application once (cost-driven flexible matching) and
serves it through :class:`repro_torch.core.serving.CosimServer`: a bounded
request queue + single dispatch thread where request k+1's host packing
overlaps request k's simulation tail, queued same-app requests coalesce
into one batched dispatch, and admission control rejects work beyond
``--queue-depth``. Warmup runs on the synchronous ``compiled`` engine —
filling every fragment cache and calibrating each target's wall-clock
CostModel — then measured requests run on ``--engine`` (default
``pipelined``, or ``REPRO_ENGINE``). On the fused engine every FlexASR
linear without an activation goes through ``af_gemm`` and every HLSCNN conv
group through ``fx_gemm``.

``--concurrency N`` bounds the load generator's outstanding requests;
``--arrival poisson:RATE`` draws exponential inter-arrival gaps at RATE
requests/second (default ``asap``: back-to-back). The run reports
sustained QPS, p50/p95/p99 request latency, rejections, then the
per-device utilization, pipeline-stage and cache-health tables. All
engines serve bit-identical results for a given ``--seed`` (request
operands derive from ``(seed, request_id)``). ``--mesh auto|N`` shards the
ILA simulators' batch axis over every card or the first N
(``ila.set_stream_mesh``): each batched group splits into equal shards, one
per card, with identical results; on a host with fewer than two cards the
mesh is disabled. It shards no model: sharded LM serving steps are
``launch.steps.make_serve_step``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import device as devmod
from ..configs import get_config, get_smoke_config
from ..kernels.flash_attention import flash_attention
from ..models import api


def generate(cfg, model, prompt: torch.Tensor, gen: int,
             stats: Optional[dict] = None) -> torch.Tensor:
    """Prefill ``prompt``, then greedy-decode: (B, gen) token ids.

    ``prompt`` is (B, S) token ids, or (B, frames, D) frame embeddings for
    the audio family, whose first token is 0 (the reference's start token)
    instead of the prefill's argmax. With ``stats`` (a dict), records the
    prefill's and the decode's seconds (synchronised), the decode steps,
    the flash_attention launches of each phase and whether every logit was
    finite.
    """
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = prompt.device
    B = prompt.shape[0]
    audio = cfg.family == "audio"
    start = 0 if audio else prompt.shape[1]
    dtype = model["tok_embed" if audio else "embed"].dtype
    cache = api.init_cache(cfg, B, start + gen, dtype, dev)

    launches = flash_attention.launches
    t0 = time.perf_counter()
    logits, cache = api.prefill(cfg, model, prompt, cache)
    if audio:
        tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
    else:
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    finite = torch.isfinite(logits).all()
    devmod.synchronize(dev)
    t1 = time.perf_counter()
    prefill_launches = flash_attention.launches - launches

    outs = [tok]
    for i in range(gen - 1):
        logits, cache = api.decode_step(cfg, model, cache, tok, start + i)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        finite = finite & torch.isfinite(logits).all()
        outs.append(tok)
    devmod.synchronize(dev)
    if stats is not None:
        stats.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1, decode_steps=gen - 1,
                     prefill_launches=prefill_launches,
                     decode_launches=flash_attention.launches - launches - prefill_launches,
                     finite=bool(finite))
    return torch.cat(outs, dim=1)


def serve_llm(args) -> torch.Tensor:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = devmod.resolve(args.device)
    model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    B = args.batch
    if cfg.family == "audio":
        prompt = torch.from_numpy(
            rng.standard_normal((B, api.AUDIO_ENC_FRAMES, cfg.d_model))).to(dev, torch.bfloat16)
    else:
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, args.prompt))).to(dev)
    stats = {}
    tokens = generate(cfg, model, prompt, args.gen, stats)
    steps = max(stats["decode_steps"], 1)
    print(f"prefill: {stats['prefill_s']:.2f}s ({stats['prefill_launches']} flash_attention "
          f"launches)")
    print(f"decode: {stats['decode_steps']} steps x{B} in {stats['decode_s']:.2f}s "
          f"({stats['decode_s'] / steps * 1e3:.0f} ms/step)")
    print(tokens.cpu().numpy())
    return tokens


def _parse_arrival(spec: str):
    """"asap" -> None (back-to-back); "poisson:RATE" -> RATE (req/s)."""
    if spec == "asap":
        return None
    if spec.startswith("poisson:"):
        rate = float(spec.split(":", 1)[1])
        if rate <= 0:
            raise SystemExit(f"--arrival poisson rate must be > 0, got {rate}")
        return rate
    raise SystemExit(f'--arrival must be "asap" or "poisson:RATE", got {spec!r}')


def drive_load(server, app: str, requests: int, batch: int, concurrency: int,
               rate: Optional[float] = None, rng: Optional[np.random.Generator] = None):
    """The load generator: submit ``requests`` requests of ``batch`` samples,
    at most ``concurrency`` outstanding, back to back (``rate`` None) or with
    exponential gaps at ``rate`` requests/s drawn from ``rng``; wait for all.
    Returns (handles, seconds)."""
    handles = []
    t0 = time.perf_counter()
    for _ in range(requests):
        outstanding = [h for h in handles if not h.done()]
        while len(outstanding) >= max(1, concurrency):
            outstanding[0].wait()
            outstanding = [h for h in outstanding if not h.done()]
        handles.append(server.submit(app, batch=batch))
        if rate is not None:
            time.sleep(rng.exponential(1.0 / rate))
    for h in handles:
        h.wait()
    return handles, time.perf_counter() - t0


def serve_cosim(args):
    """Serve ``args.cosim`` through a CosimServer under the load generator;
    returns the server (closed) and the request handles."""
    from ..core import apps, ila
    from ..core.compile import compile_program
    from ..core.ila import TARGETS
    from ..core.serving import CosimServer, percentiles_ms
    from ..core.telemetry import TELEMETRY

    dev = devmod.resolve(args.device)
    if args.trace:
        # span recording (Perfetto export at exit); metrics counters are
        # always on — this only turns on the timed-region ring buffer
        TELEMETRY.enable()

    by_name = {k.lower(): v for k, v in apps.APPLICATIONS.items()}
    if args.cosim.lower() not in by_name:
        raise SystemExit(
            f"unknown application {args.cosim!r}; "
            f"available: {sorted(apps.APPLICATIONS)}"
        )
    builder, _dsl = by_name[args.cosim.lower()]
    expr, params = builder()
    res = compile_program(expr)
    print(f"compiled {args.cosim}: offloads={res.accelerator_calls} "
          f"policy={res.stats['extraction']['policy']}")
    mesh = ila.set_stream_mesh(args.mesh) if args.mesh != "off" else None
    if args.mesh != "off":
        print(f"stream mesh: {mesh if mesh is not None else 'disabled (single device host)'}")

    # the serving path defaults to the async engine (unlike the Executor's
    # process-wide compiled default): --engine > REPRO_ENGINE > pipelined.
    # The chunk size is clamped so even the default --batch splits into
    # >= 2 pack/sim chunks per node — a single-chunk batch has nothing for
    # the pipeline to overlap.
    engine = args.engine or os.environ.get("REPRO_ENGINE") or "pipelined"
    rate = _parse_arrival(args.arrival)
    server = CosimServer(
        engine=engine,
        devices_per_target=args.devices_per_target,
        pipeline_chunk=max(1, min(8, -(-args.batch // 2))),
        queue_depth=args.queue_depth,
        max_batch=args.max_batch or max(4 * args.batch, 8),
        coalesce=not args.no_coalesce,
        overlap=not args.no_overlap,
        seed=args.seed,
        device=dev,
    )
    server.add_program(args.cosim.lower(), res.program, params)
    ex = server.executor

    warmup = max(args.warmup, 1)
    t0 = time.perf_counter()
    server.start(warmup=warmup, warm_batch=args.batch)
    warm_s = time.perf_counter() - t0
    cold_ms = warm_s / (warmup * args.batch) * 1e3
    print(f"warmup: {warmup} request(s) x batch {args.batch} in {warm_s:.3f}s "
          f"({cold_ms:.1f} ms/sample incl. first calls, compiled engine) "
          f"-> serving on {engine} ({dev})")

    handles, load_s = drive_load(server, args.cosim.lower(), args.requests, args.batch,
                                 args.concurrency, rate, np.random.default_rng(args.seed))
    server.close(drain=True)

    served = [h for h in handles if h.status == "done"]
    rejected = [h for h in handles if h.rejected]
    print(f"load: {len(served)}/{len(handles)} served, "
          f"{len(rejected)} rejected "
          f"({args.arrival}, concurrency {args.concurrency}, "
          f"queue depth {args.queue_depth})")

    # steady-state stats — guarded: with --requests 0 (or every request
    # rejected / a ~0s warm request) there is nothing to ratio against
    if served and load_s > 0:
        lats = [h.latency_s for h in served]
        pct = percentiles_ms(lats)
        qps = len(served) / load_s
        warm_ms = float(np.mean(lats)) / args.batch * 1e3
        print(f"sustained: {qps:.1f} req/s ({qps * args.batch:.1f} samples/s) "
              f"| latency p50 {pct['p50_ms']:.1f} / p95 {pct['p95_ms']:.1f} "
              f"/ p99 {pct['p99_ms']:.1f} ms")
        summ = server.summary()
        print(f"coalescing: {summ['batches']} dispatch batch(es), "
              f"mean {summ['mean_batch']:.1f} req/batch, "
              f"max {summ['coalesced_max']}")
        if warm_ms > 0 and np.isfinite(warm_ms) and np.isfinite(cold_ms):
            print(f"cold vs steady state: {cold_ms:.1f} ms/sample (warmup, "
                  f"compiled) vs {warm_ms:.1f} ms/sample (mean of "
                  f"{len(served)} served, {engine}) "
                  f"-> {cold_ms / warm_ms:.1f}x")
    else:
        print("no measured requests (0 requested or all rejected); "
              "skipping steady-state stats")

    print("\nper-target summary (devices: jobs / est cycles / utilization):")
    for tname, row in sorted(ex.stats_summary().items()):
        devs = row.pop("devices", {})
        print(f"  {tname}: invocations={row['invocations']} "
              f"commands={row['commands']} est_cycles={row['est_cycles']:.0f} "
              f"max_rel_err={row['max_rel_err']:.4f}")
        for dname, d in sorted(devs.items()):
            print(f"    {dname}: jobs={d['jobs']} groups={d['groups']} "
                  f"est_cycles={d['est_cycles']:.0f} "
                  f"utilization={d['utilization']:.2f}")
    if engine in ("pipelined", "fused"):
        stages = ex.pipeline_summary()
        print("pipeline stages (measured requests): "
              f"pack {stages['pack_s']:.3f}s / dispatch {stages['dispatch_s']:.3f}s "
              f"/ readback {stages['readback_s']:.3f}s "
              f"(overlap ~{stages['overlap_s']:.3f}s)")
    print("\ncache health:", ex.cache_info())

    # drift probes: how far the CostModel's pricing sits from measured
    # latency — request-level drift is in the serving.drift_ratio
    # histogram of --metrics
    drifts = {
        t.name: t.cost_model.drift_summary()
        for t in TARGETS.all()
        if t.cost_model is not None and t.cost_model.drift_summary()
    }
    if drifts:
        print("cost-model drift (actual us / predicted cycles):")
        for tname, d in sorted(drifts.items()):
            print(f"  {tname}: geomean {d['ratio_geomean']:.2f} "
                  f"(spread {d['log_ratio_std']:.2f}, n={d['n']:.0f}, "
                  f"{'latency-calibrated' if d['calibrated'] else 'analytic'})")
    else:
        # pipelined serving: per-group drift needs a synchronous
        # materialize (and warmup calibration just reset the probes), so
        # fall back to the request-level ratio admission control ran under
        dr = server.metrics.find("serving.drift_ratio")
        if dr and dr[0].snapshot()["count"]:
            s = dr[0].snapshot()
            print(f"admission drift (service us / priced cycles): "
                  f"p50 {s['p50']:.2f} p95 {s['p95']:.2f} "
                  f"(n={s['count']}, latency-calibrated)")

    if args.trace:
        path = TELEMETRY.export_trace(args.trace)
        print(f"trace: {TELEMETRY.spans_recorded} span(s) "
              f"({TELEMETRY.spans_dropped} dropped) -> {path} "
              f"(open in https://ui.perfetto.dev or chrome://tracing)")
    if args.metrics:
        bad = TELEMETRY.check_names()
        if bad:
            raise RuntimeError(f"metric names violate the documented schema: {bad}")
        print(f"metrics: -> {TELEMETRY.export_metrics(args.metrics)}")
    if mesh is not None:
        ila.set_stream_mesh(None)
    return server, handles


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="LLM decode mode: model config name")
    ap.add_argument("--cosim", default=None,
                    help="co-sim serving mode: application name (repro_torch.core.apps)")
    ap.add_argument("--smoke", action="store_true", help="the config's reduced smoke size")
    ap.add_argument("--devices-per-target", type=int, default=1,
                    help="simulated device instances per accelerator target")
    ap.add_argument("--engine", default=None,
                    choices=["compiled", "pipelined", "fused", "jit", "eager"],
                    help="co-sim engine for measured requests (default: "
                         "REPRO_ENGINE or pipelined); warmup always runs "
                         "compiled to calibrate the cost models")
    ap.add_argument("--mesh", default="off",
                    help='"off" (default), "auto" (all host devices) or an '
                         "int: shard the vmapped batch axis over a device mesh")
    ap.add_argument("--warmup", type=int, default=1,
                    help="warmup requests excluded from steady-state stats")
    ap.add_argument("--requests", type=int, default=16,
                    help="measured requests the load generator submits")
    ap.add_argument("--concurrency", type=int, default=4,
                    help="load generator: max outstanding requests")
    ap.add_argument("--queue-depth", type=int, default=16,
                    help="server admission control: max queued requests "
                         "(beyond this, submissions are rejected)")
    ap.add_argument("--arrival", default="asap",
                    help='"asap" (back-to-back) or "poisson:RATE" '
                         "(exponential inter-arrival gaps, RATE req/s)")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="coalescing cap in samples per dispatch "
                         "(0: 4x --batch)")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="disable cross-request coalescing (serial baseline)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="drain the pipeline at every request's assemble "
                         "barrier (pre-serving baseline)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record telemetry spans and export a Perfetto/"
                         "chrome://tracing trace_event JSON at exit")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="export a JSON snapshot of every telemetry metric "
                         "(counters/gauges/histograms) at exit")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.cosim is not None:
        return serve_cosim(args)
    if args.arch is None:
        ap.error("one of --arch (LLM decode) or --cosim (co-sim serving) is required")
    return serve_llm(args)


if __name__ == "__main__":
    main()
