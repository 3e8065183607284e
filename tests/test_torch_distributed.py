"""PyTorch port: sharded steps over real collectives against the unsharded
step.

Four spawned processes form a ``gloo`` process group (a FileStore in the
test's temporary directory, so no port is chosen by hand) and a 2x2
("data", "model") DeviceMesh on the CPU. The weights are the reference's
(``repro.models.api.init_params`` in fp32, turned into the port's model by
``params_from_numpy``); the unsharded port step is held to the reference
by ``tests/test_torch_train.py``. On the reference's SPMD cells
(``tests/test_distribution.py``: TinyLlama, Qwen3-MoE and Falcon-Mamba
smoke configs at ``ShapeConfig("t", 64, 8, "train")``), and on the other
seven smoke configs at the same shape:

* one bundle train step (``launch.steps.make_train_step(cfg, shape,
  mesh)``, AdamW) equals the unsharded step on the same weights and batch:
  loss and grad norm within ``REL`` = 1e-5 relative (measured 1e-7), both
  AdamW moments (the gradient and its square) within ``REL`` of the leaf's
  largest magnitude (measured 5.3e-6 at most), every updated parameter
  within ``REL_PARAMS`` = 5e-3 of it (see ``REL_PARAMS``) and within
  ``SELF_REL`` of the AdamW update of the sharded step's own moments, and
  ``CommDebugMode`` counts
  all-gathers, reduce-scatters or all-reduces, as the reference asserts
  ``has_collectives``;
* TinyLlama's and DeepSeek-V3's (MLA's latent attention on local
  shards) prefill and decode bundles at B = 4 (batch-sharded cache) and
  B = 1 (sequence-sharded cache) give the unsharded logits within ``REL``
  of their largest magnitude, greedy ids equal;
* ``Trainer.reshard`` from 2x2 to 1x4 leaves the gathered parameters and
  optimizer state bit-equal, laid out by the new mesh's placements;
* Whisper's smoke config with its heads narrowed to 2 (head dim 32), which
  the 4-way 'model' axis of a 1x4 mesh does not divide: the sharded train
  step equals the unsharded one as above, and the sharded prefill's cross-
  attention cache the unsharded one's within ``REL`` (its head splits and
  merges go through ``layers.split_heads``/``merge_heads``);
* the dry-run's counter (``launch.dryrun.Counter``, every trip run) counts
  the same collectives, kind by kind, and the same bytes on this gloo mesh
  as on a fake process group of 4 ranks with meta copies of the same
  inputs: TinyLlama's train, prefill and decode steps, Qwen3-MoE's and
  Falcon-Mamba's train steps;
* ``launch.train`` at world size 4 trains on rank 0 alone, on a 1x1 mesh of
  its own (the reference's rule: the production mesh needs 256 devices),
  and the other ranks return without training.

Each test spawns its own group, destroys it, and joins its processes
within ``TIMEOUT`` seconds.
"""
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import checks

WORLD = 4
TIMEOUT = 240
# the gates (REL, REL_PARAMS, SELF_REL: see launch/checks.py)
REL, REL_PARAMS, SELF_REL = checks.REL, checks.REL_PARAMS, checks.SELF_REL
TRAIN_SHAPE = checks.TRAIN_SHAPE
SPMD_ARCHS = ["tinyllama_1_1b", "qwen3_moe_30b_a3b", "falcon_mamba_7b"]
#: the other configs, each family's sharded path (MLA + MTP, Mamba2 with the
#: shared attention block, the encoder-decoder, GQA widths that the 2-way
#: 'model' axis does and does not divide)
OTHER_ARCHS = ["pixtral_12b", "deepseek_v3_671b", "zamba2_7b", "gemma_7b", "granite_8b",
               "smollm_360m", "whisper_base"]


# ---------------------------------------------------------------------------
# harness: the parent writes the inputs, the ranks run a job, rank 0 reports
# ---------------------------------------------------------------------------


def _ref_inputs(arch, path, batch=8, seq=64, overrides=None):
    """The reference's fp32 weights and a batch, as numpy, pickled; the
    smoke config with ``overrides`` (config fields) when given."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import api as japi

    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **(overrides or {}))
    params = jax.tree_util.tree_map(
        np.asarray, japi.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    batch = {k: np.asarray(v, np.float32 if k == "frames" else np.int64) for k, v in
             japi.make_train_batch(cfg, batch, seq, np.random.default_rng(0)).items()}
    with open(path, "wb") as f:
        pickle.dump({"params": params, "batch": batch, "tokens": batch["tokens"],
                     "overrides": overrides or {}}, f)


def _run(job, arch, tmp, extra):
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    return (JOBS[job] if isinstance(job, str) else job)(arch, inputs, extra)


def _spawn(job, arch, tmp, extra=None):
    """Run ``job`` (a name in JOBS, or a module-level function of a test
    module) on WORLD ranks (``launch.checks.spawn``); rank 0's result (any
    rank's error raises). A test may spawn more than once in its directory:
    each spawn starts a fresh store."""
    return checks.spawn(_run, (job, arch, str(tmp), extra), WORLD, tmp, TIMEOUT)[0]


def _model(arch, inputs):
    import dataclasses

    from repro_torch import configs as tconfigs
    from repro_torch.models import api as tapi

    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **inputs["overrides"])
    return cfg, tapi.params_from_numpy(cfg, inputs["params"], device="cpu")


def _mesh(shape=(2, 2)):
    from repro_torch.launch import mesh as tmesh

    return tmesh.make_mesh(shape, ("data", "model"), device="cpu")


_rel = checks.rel


# ---------------------------------------------------------------------------
# jobs (run on every rank)
# ---------------------------------------------------------------------------


def _job_train(arch, inputs, mesh_shape):
    cfg, model = _model(arch, inputs)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    return checks.train_vs_plain(cfg, model, batch, _mesh(mesh_shape or (2, 2)))


def _job_serve(arch, inputs, batch):
    cfg, model = _model(arch, inputs)
    return checks.serve_vs_plain(cfg, model, torch.from_numpy(inputs["tokens"]), _mesh(), batch)


def _job_reshard(arch, inputs, tmp):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import sharding as shd
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg, _ = _model(arch, inputs)
    shape = ShapeConfig(*TRAIN_SHAPE)
    trainer = Trainer(cfg, shape, SyntheticLM(cfg.vocab, 8, 64, seed=0),
                      TrainerConfig(ckpt_dir=os.path.join(tmp, f"ckpt_{dist.get_rank()}"),
                                    lr=1e-3, warmup=0, max_steps=4),
                      optimizer="adamw", mesh=_mesh((2, 2)))
    params, opt = trainer.init_state(0)
    batch = {"tokens": torch.from_numpy(inputs["tokens"])}
    params, opt, _ = trainer.step_fn(params, opt, batch, 0)    # moments not zero
    leaves = lambda p, o: tree_leaves(p.tree()) + tree_leaves(o["m"]) + tree_leaves(o["v"])
    before = [shd.gather(t).detach().clone() for t in leaves(params, opt)]
    params, opt = trainer.reshard(_mesh((1, 4)), params, opt)
    after = leaves(params, opt)
    placed = all(tuple(t.placements) == p for t, p in zip(
        tree_leaves(params.tree()), _placements(params.tree(), trainer.bundle.in_placements[0])))
    equal = all(torch.equal(shd.gather(a), b) for a, b in zip(after, before))
    mesh_shape = tuple(after[0].device_mesh.mesh.shape)
    _, _, metrics = trainer.step_fn(params, opt, batch, 1)
    return {"equal": equal, "placed": placed, "mesh": mesh_shape,
            "loss_after": float(metrics["loss"])}


def _job_whisper_prefill(arch, inputs, mesh_shape):
    """The sharded prefill (encoder, cross-attention K/V into the cache)
    against the unsharded one, on 1500 seeded frames."""
    from repro_torch.launch import steps
    from repro_torch.models import api as tapi
    from repro_torch.models.config import ShapeConfig

    cfg, model = _model(arch, inputs)
    B, S = 2, 8
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, tapi.AUDIO_ENC_FRAMES, cfg.d_model)).astype(np.float32))
    bundle = steps.make_serve_step(cfg, ShapeConfig("s", S, B, "prefill"), _mesh(mesh_shape),
                                   "prefill")
    _, cache = bundle.fn(model, {"frames": frames}, tapi.init_cache(cfg, B, S, torch.float32,
                                                                    "cpu"))
    with torch.no_grad():
        _, ref = tapi.prefill(cfg, model, frames, tapi.init_cache(cfg, B, S, torch.float32,
                                                                  "cpu"))
    return {k: _rel(cache[k], ref[k]) for k in ("xk", "xv")}


def _job_whisper_uneven(arch, inputs, mesh_shape):
    """The train step and the prefill of one spawned group."""
    return {"train": _job_train(arch, inputs, mesh_shape),
            "prefill": _job_whisper_prefill(arch, inputs, mesh_shape)}


def _count(bundle, args, mesh):
    """(collective counts, bytes) of ``bundle.fn(*args)``, every trip run,
    with the arguments laid out beforehand (placing a whole tensor
    scatters it, which the step itself does not)."""
    from repro_torch.launch import dryrun, sharding as shd, steps

    placed = []
    for a, pl in zip(args, bundle.in_placements):
        if hasattr(a, "tree"):
            a = steps._placed_model(a, pl, mesh)
        elif isinstance(a, dict):
            a = {k: v if k == "step" else shd.place_tree(v, pl[k], mesh) for k, v in a.items()}
        elif isinstance(a, torch.Tensor) and a.dim():
            a = shd.place(a, pl, mesh)
        placed.append(a)
    counter, _ = dryrun.count_step(bundle, tuple(placed), shortcut=False)
    coll = counter.collectives()
    return coll["counts"], coll["bytes"]


def count_cases(arch, inputs, mesh, device):
    """{step: (counts, bytes)} of the arch's train step (and TinyLlama's
    prefill and decode) on ``mesh``, the inputs on ``device`` ("meta" for
    the fake group: the same shapes and dtypes, nothing allocated)."""
    from repro_torch.launch import steps
    from repro_torch.models import api as tapi
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import make_optimizer

    cfg, model = _model(arch, inputs)
    model = model.to(device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in inputs["batch"].items()}
    train = steps.make_train_step(cfg, ShapeConfig(*TRAIN_SHAPE), mesh, optimizer="adamw")
    out = {"train": _count(train, (model, make_optimizer("adamw").init(model.tree()), batch,
                                   torch.zeros((), dtype=torch.int32)), mesh)}
    if arch == "tinyllama_1_1b":
        B, S = 4, 16
        shape = ShapeConfig("s", S + 1, B, "decode")
        prompt = batch["tokens"][:B, :S]
        cache = lambda: tapi.init_cache(cfg, B, S + 1, torch.float32, device)
        pre = steps.make_serve_step(cfg, shape, mesh, "prefill")
        out["prefill"] = _count(pre, (model, {"tokens": prompt}, cache()), mesh)
        dec = steps.make_serve_step(cfg, shape, mesh, "decode")
        out["decode"] = _count(dec, (model, cache(), prompt[:, -1:], S), mesh)
    return out


def _job_count(arch, inputs, _extra):
    return count_cases(arch, inputs, _mesh(), "cpu")


def _job_launch(arch, inputs, tmp):
    """``launch.train.main`` on every rank, the group already up (as under
    torchrun); then every rank reports whether it trained."""
    from repro_torch.launch import train

    trainer = train.main(["--arch", arch, "--smoke", "--steps", "3", "--batch", "4", "--seq",
                          "16", "--device", "cpu", "--ckpt-every", "2", "--ckpt-dir",
                          os.path.join(tmp, f"ckpt_{dist.get_rank()}")])
    trained = [None] * dist.get_world_size()
    dist.all_gather_object(trained, trainer is not None)
    out = {"trained": trained}
    if trainer is not None:
        out.update(mesh=tuple(trainer.mesh.mesh.shape), mesh_size=trainer.mesh.size(),
                   losses=[m["loss"] for m in trainer.metrics if "loss" in m],
                   ckpts=trainer.ckpt.all_steps())
    return out


def _placements(tree, pl):
    """``pl``'s placement tuples in ``tree``'s leaf order."""
    from repro_torch.optim.optimizers import tree_map

    out = []
    tree_map(lambda _, p: out.append(p), tree, pl)
    return out


JOBS = {"train": _job_train, "serve": _job_serve, "reshard": _job_reshard,
        "whisper_uneven": _job_whisper_uneven, "count": _job_count, "launch": _job_launch}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.fixture
def inputs(tmp_path, request):
    arch = getattr(request, "param", "tinyllama_1_1b")
    _ref_inputs(arch, tmp_path / "inputs.pkl")
    return arch, tmp_path


def assert_train_equal(r):
    assert np.isfinite(r["loss"][0]) and np.isfinite(r["grad_norm"][0]), r
    assert not checks.train_failures(r), (checks.train_failures(r), r)


@pytest.mark.parametrize("inputs", SPMD_ARCHS + OTHER_ARCHS, indirect=True)
def test_sharded_train_step_equals_unsharded(inputs):
    arch, tmp = inputs
    assert_train_equal(_spawn("train", arch, tmp))


#: Whisper's heads narrowed so that a 4-way 'model' axis does not divide them
WHISPER_NARROW = {"n_heads": 2, "n_kv_heads": 2, "head_dim": 32}


def test_whisper_uneven_heads_sharded_equal_unsharded(tmp_path):
    _ref_inputs("whisper_base", tmp_path / "inputs.pkl", overrides=WHISPER_NARROW)
    r = _spawn("whisper_uneven", "whisper_base", tmp_path, (1, 4))
    assert_train_equal(r["train"])
    assert max(r["prefill"].values()) <= REL, r["prefill"]


@pytest.mark.parametrize("inputs", ["tinyllama_1_1b", "qwen3_moe_30b_a3b", "falcon_mamba_7b"],
                         indirect=True)
def test_fake_group_counts_equal_gloo(inputs):
    import pickle as pkl

    from repro_torch.launch import dryrun

    arch, tmp = inputs
    real = _spawn("count", arch, tmp)
    with open(tmp / "inputs.pkl", "rb") as f:
        ref_inputs = pkl.load(f)
    with dryrun.fake_group(WORLD):
        fake = count_cases(arch, ref_inputs, _mesh(), "meta")
    assert fake == real
    assert all(sum(c.values()) > 0 for c, _ in real.values()), real


def test_train_launcher_below_256_ranks_trains_on_rank_0(tmp_path):
    _ref_inputs("smollm_360m", tmp_path / "inputs.pkl")
    r = _spawn("launch", "smollm_360m", tmp_path, str(tmp_path))
    assert r["trained"] == [True, False, False, False], r
    assert r["mesh"] == (1, 1) and r["mesh_size"] == 1, r
    assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all(), r
    assert r["ckpts"] == [1, 2], r


@pytest.mark.parametrize("batch", [4, 1])
def test_sharded_prefill_and_decode_equal_unsharded(tmp_path, batch):
    _ref_inputs("tinyllama_1_1b", tmp_path / "inputs.pkl")
    r = _spawn("serve", "tinyllama_1_1b", tmp_path, batch)
    assert max(r["errs"]) <= REL, r
    assert r["same_ids"], r
    # B = 4 splits the cache's batch over 'data'; B = 1 its sequence (SP)
    want = "Shard(dim=1)" if batch == 4 else "Shard(dim=2)"
    assert all(p.startswith(f"({want}") for p in r["placements"]["cache"].values()), r


@pytest.mark.parametrize("batch", [4, 1])
def test_sharded_mla_prefill_and_decode_equal_unsharded(tmp_path, batch):
    """DeepSeek-V3's absorbed (latent) attention over its compressed cache,
    which the sharded path computes on local shards."""
    _ref_inputs("deepseek_v3_671b", tmp_path / "inputs.pkl")
    r = _spawn("serve", "deepseek_v3_671b", tmp_path, batch)
    assert max(r["errs"]) <= REL, r
    assert r["same_ids"], r


def test_reshard_2x2_to_1x4_is_bit_equal(inputs):
    arch, tmp = inputs
    r = _spawn("reshard", arch, tmp, str(tmp))
    assert r["equal"] and r["placed"] and r["mesh"] == (1, 4), r
    assert np.isfinite(r["loss_after"]), r


def test_mesh_without_a_process_group_raises():
    from repro_torch.launch import mesh as tmesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
