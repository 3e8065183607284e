"""Serving launcher: prefill, then batched greedy decode over a KV cache.

Port of ``repro/launch/serve.py::serve_llm``:

    python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        [--smoke] [--batch 4] [--prompt 16] [--gen 16] [--seed 0] [--device cuda]

Weights are seeded (a ``torch.Generator`` on the device), bf16 as in the
reference. Every prefill attention goes through the flash_attention kernel on
the card; decode attends over the cache in plain ops. ``--device cpu`` runs
the kernels' plain versions (use ``--smoke`` there).

The co-simulation service (``--cosim``, the reference's ``CosimServer``) is
not ported yet (ROADMAP.md, Queue 1 item 13).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from .. import device as devmod
from ..configs import get_config, get_smoke_config
from ..kernels.flash_attention import flash_attention
from ..models import api


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    _sync(dev)
    t1 = time.perf_counter()
    prefill_launches = flash_attention.launches - launches

    outs = [tok]
    for i in range(gen - 1):
        logits, cache = api.decode_step(cfg, model, cache, tok, start + i)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        finite = finite & torch.isfinite(logits).all()
        outs.append(tok)
    _sync(dev)
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="model config name (repro_torch.configs)")
    ap.add_argument("--cosim", default=None, help="co-sim serving: not ported yet")
    ap.add_argument("--smoke", action="store_true", help="the config's reduced smoke size")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.cosim is not None:
        raise SystemExit("--cosim (co-simulation serving through CosimServer) is not ported "
                         "to repro_torch yet: ROADMAP.md, Queue 1 item 13")
    if args.arch is None:
        ap.error("--arch is required")
    serve_llm(args)


if __name__ == "__main__":
    main()
