"""Serving example: prefill a prompt, then batched greedy decode with the
KV cache, on a reduced TinyLlama config.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cuda]

Prefill attends through the flash_attention kernel (its plain version on
the CPU); decode attends over the cache in plain ops.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.configs import get_smoke_config
from repro_torch.models import api

B, PROMPT, GEN = 4, 16, 24


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)
    cfg = get_smoke_config("tinyllama-1.1b")
    params = api.init_params(cfg, torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, PROMPT))).to(dev)

    cache = api.init_cache(cfg, B, PROMPT + GEN, device=dev)
    t0 = time.perf_counter()
    logits, cache = api.prefill(cfg, params, prompt, cache)
    devmod.synchronize(dev)
    print(f"prefill {PROMPT} tokens x{B}: {time.perf_counter() - t0:.2f}s")

    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(GEN - 1):
        logits, cache = api.decode_step(cfg, params, cache, tok, PROMPT + i)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        out_tokens.append(tok)
    devmod.synchronize(dev)
    dt = time.perf_counter() - t0
    gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    print(f"decoded {GEN - 1} steps x{B} seqs in {dt:.2f}s ({dt / (GEN - 1) * 1e3:.0f} ms/step)")
    print("generations:\n", gen)
    print("OK")
    return gen


if __name__ == "__main__":
    main()
