"""Training launcher.

    python -m repro_torch.launch.train --arch smollm-360m --steps 200 \
        [--smoke] [--ckpt-dir DIR] [--batch 8] [--seq 64] [--device cuda]

Port of ``repro/launch/train.py`` on one device (``--device``, default the
GPU; a host without CUDA raises, ``--device cpu`` runs there). ``--smoke``
selects the reduced same-family config; without it the full published
config is used. There is no ``--multi-pod`` and no mesh: sharding is not
ported (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import tempfile

from .. import device as devmod
from ..configs import get_config, get_smoke_config
from ..data.pipeline import SyntheticLM
from ..models.config import ShapeConfig
from ..runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = devmod.resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch, kind="train")
    data = SyntheticLM(cfg.vocab, args.batch, args.seq, seed=0)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    trainer = Trainer(
        cfg, shape, data,
        TrainerConfig(ckpt_dir=ckpt, ckpt_every=args.ckpt_every,
                      max_steps=args.steps, lr=args.lr, warmup=args.warmup),
        device=dev,
    )
    print(f"training {cfg.name} on {dev} ckpt={ckpt}")
    trainer.run()
    losses = [m["loss"] for m in trainer.metrics if "loss" in m]
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps; "
          f"checkpoints {trainer.ckpt.all_steps()}")
    return trainer


if __name__ == "__main__":
    main()
