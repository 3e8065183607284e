"""Sharded steps against the unsharded step, over real collectives.

Each check runs on every rank of a process group and holds a step bundle
(``launch.steps``) on a mesh to the unsharded step on the same weights and
inputs: one AdamW train step (:func:`train_vs_plain`), and prefill plus
decode through the serve bundles (:func:`serve_vs_plain`).
:func:`local_shard_case` runs both with the MoE's dropped slots and the
placements that reach the o-projection recorded, and :func:`failures`
names the gates a result misses. :func:`spawn` runs a function on the
ranks of a process group: a ``gloo`` group of CPU processes, or an
``nccl`` group of one process per card (:func:`rank_device`).

The port's tests run these checks on the reference's weights; ``python
chip_smoke.py`` runs them on the port's own, under the PyTorch release of
the machine that holds the card.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import time
import traceback

import torch

#: loss, grad norm, logits: relative to the unsharded value (the logits to
#: their largest magnitude); the AdamW moments: to the leaf's largest
#: magnitude
REL = 1e-5
#: AdamW's first step divides each gradient element by its own magnitude
#: (u = g / (|g| + eps)), so where a gradient element is near eps the fp32
#: rounding of the gradient moves the parameter by up to lr * O(1): the
#: updated parameters get a looser gate against the unsharded step than the
#: gradients (the moments) do (measured: 9.1e-4 for Zamba2, 2.1e-4 at most
#: for the others), and a tight one against the AdamW update of the sharded
#: step's own moments (SELF_REL; measured 0.0: each gradient is reduced to
#: its parameter's layout before the update, launch.steps.value_and_grad).
REL_PARAMS = 5e-3
SELF_REL = 1e-6
TRAIN_SHAPE = ("t", 64, 8, "train")
#: the MoE's token group and capacity factor in :func:`local_shard_case`'s
#: checks: a 4x1 mesh splits a train step's 512 tokens into 2 groups of 256
#: over 4 ranks of 128 tokens, and the capacity drops slots in a train step
#: and at prefill
MOE_GROUP, MOE_CAPACITY = 256, 0.5
#: serving: prompt length, tokens generated, batch
PROMPT, GEN, SERVE_BATCH = 16, 4, 4
#: the placements of an attention output split over batch and sequence
SEQ_SPLIT = "(Shard(dim=0), Shard(dim=1))"
_COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce")


def rel(a, b) -> float:
    """max |a - b| over max |b| (gathering a DTensor: every rank calls it)."""
    from .sharding import gather

    a, b = gather(a).detach().float(), gather(b).detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _synced(model) -> float:
    """``time.perf_counter()`` once the work queued on the model's card is
    done (at once on the CPU)."""
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def train_vs_plain(cfg, model, batch, mesh) -> dict:
    """One AdamW step of the sharded bundle on ``mesh`` and of the plain
    step, from the same weights and batch (``TRAIN_SHAPE``): their losses,
    grad norms, parameters and moments, the sharded parameters against the
    AdamW update of the sharded step's own moments, the collectives
    DTensor ran, and each step's seconds (``s_plain``, ``s_sharded``: the
    first call of each, set-up included)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from ..models.config import ShapeConfig
    from ..optim import make_optimizer
    from ..optim.optimizers import tree_leaves
    from . import steps

    shape = ShapeConfig(*TRAIN_SHAPE)
    kw = dict(optimizer="adamw", lr=1e-3, warmup=0, total_steps=10)
    opt_state = make_optimizer("adamw").init(model.tree())
    t0 = time.perf_counter()
    p_model, p_opt, p_metrics = steps.make_train_step(cfg, shape, **kw)(model, opt_state,
                                                                       batch, 0)
    t1 = _synced(model)
    bundle = steps.make_train_step(cfg, shape, mesh, **kw)
    t2 = time.perf_counter()
    with CommDebugMode() as comm:
        s_model, s_opt, s_metrics = bundle.fn(model, opt_state, batch, 0)
    t3 = _synced(model)
    counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
    # the AdamW update (optim.adamw_update, step 1) of the sharded moments
    lr, (b1, b2, eps, wd) = s_metrics["lr"], (0.9, 0.95, 1e-8, 0.1)
    bc1, bc2 = 1 - b1 ** torch.ones(()), 1 - b2 ** torch.ones(())

    def adamw(p, m, v):
        m, v = (t.full_tensor() for t in (m, v))
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p.float()
        return (p.float() - lr * u).to(p.dtype)

    return {
        "loss": (float(s_metrics["loss"]), float(p_metrics["loss"])),
        "grad_norm": (float(s_metrics["grad_norm"]), float(p_metrics["grad_norm"])),
        "params": max(rel(a, b) for a, b in zip(tree_leaves(s_model.tree()),
                                                 tree_leaves(p_model.tree()))),
        "self": max(rel(a, adamw(p, m, v)) for a, p, m, v in zip(
            tree_leaves(s_model.tree()), tree_leaves(model.tree()), tree_leaves(s_opt["m"]),
            tree_leaves(s_opt["v"]))),
        **{k: max(rel(a, b) for a, b in zip(tree_leaves(s_opt[k]), tree_leaves(p_opt[k])))
           for k in ("m", "v")},
        "moved": max(float((a - b).detach().abs().max())
                     for a, b in zip(tree_leaves(p_model.tree()), tree_leaves(model.tree()))),
        "counts": counts,
        "s_plain": t1 - t0,
        "s_sharded": t3 - t2,
        "sharded_leaves": sum(1 for p in s_model.parameters()
                              if any(not pl.is_replicate() for pl in p.placements)),
        "leaves": len(list(s_model.parameters())),
    }


def serve_vs_plain(cfg, model, tokens, mesh, batch: int = SERVE_BATCH, prompt: int = PROMPT,
                   gen: int = GEN, device="cpu", dtype=torch.float32) -> dict:
    """Prefill of ``prompt`` tokens and ``gen`` - 1 decode steps through
    the serve bundles on ``mesh`` against the unsharded prefill and decode,
    both fed the unsharded step's greedy tokens, caches of ``dtype`` on
    ``device``: each step's logits' error (:func:`rel`), whether the greedy
    ids agree, and the placements of the prefill's logits and cache."""
    from ..models import api
    from ..models.config import ShapeConfig
    from . import steps

    shape = ShapeConfig("s", prompt + gen, batch, "decode")
    prefill = steps.make_serve_step(cfg, shape, mesh, "prefill")
    decode = steps.make_serve_step(cfg, shape, mesh, "decode")
    ids = tokens[:batch, :prompt]
    cache = api.init_cache(cfg, batch, prompt + gen, dtype, device)
    ref_cache = api.init_cache(cfg, batch, prompt + gen, dtype, device)
    logits, cache = prefill.fn(model, {"tokens": ids}, cache)
    with torch.no_grad():
        ref, ref_cache = api.prefill(cfg, model, ids, ref_cache)
    errs, same_ids = [rel(logits, ref)], True
    placements = {"logits": str(logits.placements),
                  "cache": {k: str(v.placements) for k, v in cache.items()}}
    tok = ref[:, -1].argmax(-1, keepdim=True)
    for i in range(gen - 1):
        logits, cache = decode.fn(model, cache, tok, prompt + i)
        with torch.no_grad():
            ref, ref_cache = api.decode_step(cfg, model, ref_cache, tok, prompt + i)
        errs.append(rel(logits, ref))
        same_ids &= bool(torch.equal(logits.full_tensor()[:, -1].argmax(-1),
                                     ref[:, -1].argmax(-1)))
        tok = ref[:, -1].argmax(-1, keepdim=True)
    return {"errs": errs, "same_ids": same_ids, "placements": placements}


@contextlib.contextmanager
def _recorded():
    """(drops, placements): the (token, expert) slots each unsharded MoE
    group drops (place in its queue >= capacity), and the placements of
    every DTensor attention output that reaches ``layers.o_proj``."""
    from ..models import layers

    drops, seen, group, o_proj = [], [], layers._moe_group, layers.o_proj

    def counted(cfg, p, x2, routed=None):
        _, gidx = layers._route(cfg, x2, p["router"]) if routed is None else routed
        _, _, pos = layers._queue(gidx)
        drops.append(int((pos >= layers._capacity(cfg, x2.shape[0])).sum()))
        return group(cfg, p, x2, routed)

    def recorded(out, w):
        if hasattr(out, "placements"):
            seen.append(str(tuple(out.placements)))
        return o_proj(out, w)

    layers._moe_group, layers.o_proj = counted, recorded
    try:
        yield drops, seen
    finally:
        layers._moe_group, layers.o_proj = group, o_proj


def local_shard_case(cfg, model, batch, mesh, serve: bool = True) -> dict:
    """:func:`train_vs_plain`, then (``serve``) :func:`serve_vs_plain` on
    the batch's tokens, with the unsharded MoE's dropped slots of each
    (``drops``) and the placements that reached the o-projection. The
    serve caches take the model's device and dtype."""
    like = next(model.parameters())
    with _recorded() as (drops, seen):
        out = {"train": train_vs_plain(cfg, model, batch, mesh), "moe": bool(cfg.n_experts)}
        out["drops"] = [sum(drops)]
        if serve:
            out["serve"] = serve_vs_plain(cfg, model, batch["tokens"], mesh,
                                          device=like.device, dtype=like.dtype)
            out["drops"].append(sum(drops) - out["drops"][0])
    out["o_proj_placements"] = sorted(set(seen))
    return out


def train_failures(r: dict) -> list:
    """The gates a :func:`train_vs_plain` result misses: loss and grad norm
    within ``REL``, the moments within ``REL``, the parameters within
    ``REL_PARAMS`` of the unsharded step and ``SELF_REL`` of their own
    update, the weights moved, some leaf sharded, some collective run."""
    bad = [k for k in ("loss", "grad_norm")
           if not abs(r[k][0] - r[k][1]) <= REL * abs(r[k][1])]
    bad += [k for k in ("m", "v") if not r[k] <= REL]
    bad += [] if r["params"] <= REL_PARAMS else ["params"]
    bad += [] if r["self"] <= SELF_REL else ["self"]
    bad += [] if r["moved"] > 1e-4 else ["moved"]         # lr 1e-3 moved the weights
    bad += [] if r["sharded_leaves"] > 0 else ["sharded_leaves"]
    bad += [] if sum(r["counts"].get(k, 0) for k in _COLLECTIVES) > 0 else ["collectives"]
    return bad


def serve_failures(r: dict) -> list:
    """The gates a :func:`serve_vs_plain` result misses: every step's
    logits within ``REL``, the greedy ids equal."""
    return ([] if max(r["errs"]) <= REL else ["logits"]) + ([] if r["same_ids"] else ["ids"])


def failures(r: dict, seq_split: bool = False) -> list:
    """The gates a :func:`local_shard_case` result misses: the train and
    serve gates, dropped slots in each MoE step, and (``seq_split``) an
    attention output split over batch and sequence reaching the
    o-projection."""
    bad = train_failures(r["train"])
    bad += serve_failures(r["serve"]) if "serve" in r else []
    bad += [] if not r["moe"] or all(d > 0 for d in r["drops"]) else ["drops"]
    bad += [] if not seq_split or SEQ_SPLIT in r["o_proj_placements"] else ["sequence split"]
    return bad


#: the backends :func:`spawn` starts a group of
BACKENDS = ("gloo", "nccl")


def rank_device(rank: int, backend: str) -> torch.device:
    """The device rank ``rank`` of a ``backend`` group runs on: the CPU for
    ``gloo``; for ``nccl``, card ``rank``, made the process's current
    device. NCCL refuses two ranks on one card, so a rank with no card of
    its own raises (it never shares one, nor falls back to gloo)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "gloo":
        return torch.device("cpu")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if rank >= cards:
        raise RuntimeError(f"rank {rank} of an nccl group has no card of its own: "
                           f"this host has {cards}")
    torch.cuda.set_device(rank)
    return torch.device("cuda", rank)


def _rank(rank: int, fn, args, world: int, tmp: str, backend: str = "gloo") -> None:
    import torch.distributed as dist

    rank_device(rank, backend)
    if backend == "gloo":
        torch.set_num_threads(1)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        out, err = fn(*args), None
    except Exception:
        out, err = None, traceback.format_exc()
    # the result first: a rank whose peers wait in a collective may never
    # get past the group's destruction
    try:
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump({"out": out, "err": err}, f)
    finally:
        dist.destroy_process_group()


def _results(tmp: str, world: int) -> list:
    """Each rank's pickled result, None where a rank wrote none."""
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"result_{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        else:
            out.append(None)
    return out


def spawn(fn, args, world: int, tmp, timeout: float, backend: str = "gloo") -> list:
    """``fn(*args)`` on ``world`` spawned processes, each a rank of a
    ``backend`` group over a FileStore in the directory ``tmp``; every
    rank's result. ``gloo``: CPU processes of one thread each; ``nccl``:
    rank r on card r (:func:`rank_device`; fewer cards than ranks raises
    before any process starts). A rank's error raises, as does a group that
    outlives ``timeout`` seconds (its processes are killed)."""
    import torch.multiprocessing as mp

    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > cards:
            raise RuntimeError(f"an nccl group of {world} ranks needs a card each; "
                               f"this host has {cards}")
    elif backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    tmp = str(tmp)
    for name in ["store"] + [f"result_{r}.pkl" for r in range(world)]:
        if os.path.exists(os.path.join(tmp, name)):
            os.remove(os.path.join(tmp, name))
    ctx = mp.start_processes(_rank, args=(fn, args, world, tmp, backend), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                errs = [r["err"] for r in _results(tmp, world) if r and r["err"]]
                raise TimeoutError(f"{getattr(fn, '__name__', fn)}{args[:2]} ran past "
                                   f"{timeout} s" + (f"; a rank failed: {errs[0]}" if errs else ""))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    results = _results(tmp, world)
    if None in results:
        raise RuntimeError(f"rank {results.index(None)} of {getattr(fn, '__name__', fn)} "
                           f"wrote no result")
    errs = [r["err"] for r in results if r["err"]]
    if errs:
        raise RuntimeError(errs[0])
    return [r["out"] for r in results]
