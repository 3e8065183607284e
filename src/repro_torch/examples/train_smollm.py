"""End-to-end driver: train a ~360M-architecture LM (reduced width by
default) for a few hundred steps with the port's training stack —
deterministic data, the train step with the differentiable flash_attention,
checkpointing, the fault-tolerant trainer.

    PYTHONPATH=src python -m repro_torch.examples.train_smollm \
        [--steps 300] [--full] [--ckpt-dir DIR] [--device cuda]

``--full`` uses the real smollm-360m config (for the card); the default
reduced config trains visibly in minutes on a CPU.
"""
import argparse
import tempfile

from repro_torch import device as devmod
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.config import ShapeConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = devmod.resolve(args.device)

    cfg = get_config("smollm-360m") if args.full else get_smoke_config("smollm-360m")
    shape = ShapeConfig("train", seq_len=64, global_batch=8, kind="train")
    data = SyntheticLM(cfg.vocab, shape.global_batch, shape.seq_len, seed=0)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    trainer = Trainer(
        cfg, shape, data,
        TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=100, max_steps=args.steps,
                      lr=3e-3, warmup=20),
        device=dev,
    )
    print(f"arch={cfg.name} params~{cfg.n_params() / 1e6:.1f}M device={dev} ckpt={ckpt_dir}")
    trainer.run()
    losses = [m["loss"] for m in trainer.metrics if "loss" in m]
    print(f"step 0 loss {losses[0]:.3f} -> step {len(losses) - 1} loss {losses[-1]:.3f}")
    print(f"checkpoints: {trainer.ckpt.all_steps()}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    print("OK")
    return trainer


if __name__ == "__main__":
    main()
