"""Training launcher.

    python -m repro_torch.launch.train --arch smollm-360m --steps 200 \
        [--smoke] [--ckpt-dir DIR] [--batch 8] [--seq 64] [--device cuda]

Port of ``repro/launch/train.py`` (``--device``, default the GPU; a host
without CUDA raises, ``--device cpu`` runs there). ``--smoke`` selects the
reduced same-family config; without it the full published config is used.

The mesh follows the reference's rule (``src/repro/launch/train.py:39``):
the production mesh (``--multi-pod``: 2x16x16) with at least 256 devices,
else the 1x1 smoke mesh, one device. Here the devices are the ranks of the
process group ``torchrun`` sets up (``torchrun --nproc-per-node 8 -m
repro_torch.launch.train ...`` on each host), or a group of one that this
launcher starts itself. At world sizes 2-255 rank 0 trains alone on a 1x1
mesh of its own device (a process group of rank 0 only, which every rank
helps make); the other ranks have nothing to run and return at once
(``main`` gives them None), and ``torchrun``'s job ends with rank 0's
training. The production mesh needs the world size to be its own, 256 (or
512 with ``--multi-pod``): ``launch/mesh.py`` raises otherwise.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from .. import device as devmod
from ..configs import get_config, get_smoke_config
from ..data.pipeline import SyntheticLM
from ..models.config import ShapeConfig
from ..runtime.trainer import Trainer, TrainerConfig
from .mesh import axis_sizes, make_production_mesh, make_smoke_mesh


def _process_group(dev) -> bool:
    """Join ``torchrun``'s process group (its environment names the
    address, rank and world size) or start a group of one on a free local
    port; True when this launcher started it (and so ends it). Under
    ``torchrun`` on the GPU, the rank's card (``LOCAL_RANK``) becomes the
    current device first: NCCL refuses two ranks on one card."""
    if dist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend)
    else:
        store = dist.TCPStore("localhost", 0, 1, is_master=True)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return True


#: the reference's device count for the production mesh (its train.py:39)
PRODUCTION_DEVICES = 256


def _mesh(dev, multi_pod: bool):
    """The production mesh with at least PRODUCTION_DEVICES ranks, else a
    1x1 mesh: over the whole group at world size 1, over rank 0 alone
    otherwise (None on the other ranks)."""
    world = dist.get_world_size()
    if world >= PRODUCTION_DEVICES:
        return make_production_mesh(multi_pod=multi_pod, device=dev)
    if world == 1:
        return make_smoke_mesh(device=dev)
    group = dist.new_group([0])     # a collective: every rank makes it
    return make_smoke_mesh(device=dev, group=group) if dist.get_rank() == 0 else None


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
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = devmod.resolve(args.device)
    started = _process_group(dev)
    dev = devmod.resolve(args.device)   # under torchrun, this rank's own card
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch, kind="train")
    data = SyntheticLM(cfg.vocab, args.batch, args.seq, seed=0)
    try:
        mesh = _mesh(dev, args.multi_pod)
        if mesh is None:
            print(f"rank {dist.get_rank()} of {dist.get_world_size()}: fewer than "
                  f"{PRODUCTION_DEVICES} devices, rank 0 trains on one ({dev})")
            return None
        ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
        trainer = Trainer(
            cfg, shape, data,
            TrainerConfig(ckpt_dir=ckpt, ckpt_every=args.ckpt_every,
                          max_steps=args.steps, lr=args.lr, warmup=args.warmup),
            mesh=mesh,
        )
        print(f"training {cfg.name} on {dev.type} mesh {axis_sizes(mesh)} ckpt={ckpt}")
        trainer.run()
    finally:
        if started:
            dist.destroy_process_group()
    losses = [m["loss"] for m in trainer.metrics if "loss" in m]
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps; "
          f"checkpoints {trainer.ckpt.all_steps()}")
    return trainer


if __name__ == "__main__":
    main()
