"""PyTorch port: the MoE dispatch, the Mamba1 scan and the o-projection
after a sequence split, on local shards, against the unsharded step.

On DTensors, ``layers.moe_ffn`` dispatches each rank's own tokens to its own
experts (each slot keeps the reference's global place in its expert's
queue, so capacity and drops are the reference's), ``ssm.mamba1_scan``
scans each rank's rows and channels with no collective per position, and
``layers.o_proj`` projects a sequence-split attention output on local
shards. Four spawned ``gloo`` processes (``tests/test_torch_distributed.py``'s
harness; one spawn per group of checks) run ``launch.checks``' checks,
which hold each sharded step to the unsharded one on the same weights (the
reference's fp32 smoke weights) at the same tolerances:

* Qwen3-MoE and DeepSeek-V3 (capacity factor 0.5, ``MOE_GROUP`` = 256 in
  the port, so that a train step drops slots and, on a 4x1 mesh, each
  group spans two ranks; one group spans the ranks at prefill and decode):
  a train step, and prefill + decode through ``make_serve_step``, on 2x2,
  1x4 and (Qwen3-MoE) 4x1 meshes; dropped slots asserted;
* Falcon-Mamba (Mamba1): a train step, prefill and decode on 2x2 and 1x4;
* SmolLM (3 heads on the 2-way 'model' axis: the attention output is split
  over batch and sequence before the o-projection, asserted): a train step;
* the dry-run's counter on a fake 2x2 group with meta tensors counts the
  same collectives and bytes as on the gloo mesh (the train steps of
  Qwen3-MoE, one group across both data ranks or two recomputed pieces a
  rank, and Falcon-Mamba), and one
  MoE layer's dispatch and combine count exactly their hand count;
* groups that do not nest in the token shards raise.
"""
import pickle

import pytest
import torch

from repro_torch.launch import checks
from test_torch_distributed import WORLD, _mesh, _model, _ref_inputs, _spawn, count_cases

#: a capacity factor that drops slots in a train step and at prefill
MOE_OVERRIDES = {"capacity_factor": checks.MOE_CAPACITY}


# ---------------------------------------------------------------------------
# jobs (run on every rank)
# ---------------------------------------------------------------------------


def _job_case(arch, inputs, mesh_shape):
    """``launch.checks.local_shard_case`` of one spawned group on a
    ``mesh_shape`` mesh, the port's MOE_GROUP at ``checks.MOE_GROUP``;
    SmolLM's train step only."""
    from repro_torch.models import layers

    layers.MOE_GROUP = checks.MOE_GROUP
    cfg, model = _model(arch, inputs)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    return checks.local_shard_case(cfg, model, batch, _mesh(mesh_shape),
                                   serve=arch != "smollm_360m")


def _job_count(arch, inputs, moe_group):
    """The counts on the gloo mesh, the port's MOE_GROUP at ``moe_group``
    when given."""
    from repro_torch.models import layers

    if moe_group:
        layers.MOE_GROUP = moe_group
    return count_cases(arch, inputs, _mesh(), "cpu")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mesh_shape", [
    ("qwen3_moe_30b_a3b", (2, 2)), ("qwen3_moe_30b_a3b", (1, 4)),
    ("qwen3_moe_30b_a3b", (4, 1)),     # two groups, each across two ranks
    ("deepseek_v3_671b", (2, 2)), ("deepseek_v3_671b", (1, 4)),
])
def test_sharded_moe_steps_equal_unsharded(tmp_path, arch, mesh_shape):
    _ref_inputs(arch, tmp_path / "inputs.pkl", overrides=MOE_OVERRIDES)
    r = _spawn(_job_case, arch, tmp_path, mesh_shape)
    assert r["moe"] and len(r["drops"]) == 2, r
    assert not checks.failures(r), (checks.failures(r), r)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_sharded_mamba1_steps_equal_unsharded(tmp_path, mesh_shape):
    _ref_inputs("falcon_mamba_7b", tmp_path / "inputs.pkl")
    r = _spawn(_job_case, "falcon_mamba_7b", tmp_path, mesh_shape)
    assert "serve" in r, r
    assert not checks.failures(r), (checks.failures(r), r)


def test_sequence_split_o_projection_equals_unsharded(tmp_path):
    """SmolLM's 3 heads on the 2-way 'model' axis: hint_heads splits the
    sequence, so the o-projection's input is split over batch and
    sequence."""
    _ref_inputs("smollm_360m", tmp_path / "inputs.pkl")
    r = _spawn(_job_case, "smollm_360m", tmp_path, (2, 2))
    assert not checks.failures(r, seq_split=True), (checks.failures(r, seq_split=True), r)


@pytest.mark.parametrize("arch,moe_group", [
    ("qwen3_moe_30b_a3b", None), ("falcon_mamba_7b", None), ("qwen3_moe_30b_a3b", 128)],
    ids=["qwen3_moe_30b_a3b", "falcon_mamba_7b", "qwen3_moe_30b_a3b_groups"])
def test_fake_group_counts_equal_gloo_on_local_shard_paths(tmp_path, arch, moe_group,
                                                           monkeypatch):
    """The train step (at the default MOE_GROUP one group spans both data
    ranks, so the expert counts are all-gathered; with groups of 128, two
    pieces a rank, each recomputed in backward)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import layers

    overrides = MOE_OVERRIDES if arch == "qwen3_moe_30b_a3b" else None
    _ref_inputs(arch, tmp_path / "inputs.pkl", overrides=overrides)
    real = _spawn(_job_count, arch, tmp_path, moe_group)
    with open(tmp_path / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    if moe_group:
        monkeypatch.setattr(layers, "MOE_GROUP", moe_group)
    with dryrun.fake_group(WORLD):
        fake = count_cases(arch, inputs, _mesh(), "meta")
    assert fake == real
    assert all(sum(c.values()) > 0 for c, _ in real.values()), real


def _moe_layer(cfg, mesh, B, S):
    """One MoE layer's weights and (B, S, D) bf16 tokens as meta DTensors
    on ``mesh``: tokens split over 'data', experts over 'model', the router
    and expert weights whole over 'data' (so no FSDP gather)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import sharding as shd
    from repro_torch.models import layers

    p = layers.moe_params(cfg, torch.Generator().manual_seed(0))
    place = lambda t, pl: shd.place(t.to("meta"), pl, mesh)
    p = {"router": place(p["router"], [Replicate(), Replicate()]),
         **{k: place(p[k], [Replicate(), Shard(0)]) for k in ("w_gate", "w_up", "w_down")}}
    return p, place(torch.zeros(B, S, cfg.d_model, dtype=torch.bfloat16), [Shard(0), Replicate()])


def test_moe_layer_dispatch_and_combine_bytes_equal_hand_count():
    """One MoE layer's forward on a fake 2x2 mesh, meta tensors
    (:func:`_moe_layer`), one group across both data ranks. Its
    collectives are the expert counts' all-gather over 'data' (E int64 a
    rank) and the combine's all-reduce over 'model' (a rank's tokens,
    bf16); nothing else moves."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs as tconfigs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers

    cfg = tconfigs.get_smoke_config("qwen3_moe_30b_a3b")
    B, S, D, E = 4, 16, cfg.d_model, cfg.n_experts
    with dryrun.fake_group(WORLD):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        p, x = _moe_layer(cfg, mesh, B, S)
        with implicit_replication(), layers.mesh_hints(mesh), dryrun.Counter() as counter:
            out = layers.moe_ffn(cfg, p, x)
        coll = counter.collectives()
    assert out.shape == (B, S, D) and tuple(out.placements) == (Shard(0), Replicate())
    tokens_a_rank = B * S // 2
    assert coll["counts"] == {"all-gather": 1, "all-reduce": 1}, coll
    assert coll["bytes"] == {"all-gather": 2 * E * 8, "all-reduce": tokens_a_rank * D * 2,
                             "total": 2 * E * 8 + tokens_a_rank * D * 2}, coll


def test_moe_groups_that_do_not_nest_in_token_shards_raise(monkeypatch):
    """48 tokens a data rank and groups of 32 (neither divides the other):
    the sharded dispatch raises rather than gather every token."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs as tconfigs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "MOE_GROUP", 32)
    cfg = tconfigs.get_smoke_config("qwen3_moe_30b_a3b")
    with dryrun.fake_group(WORLD):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        p, x = _moe_layer(cfg, mesh, 4, 24)
        with implicit_replication(), layers.mesh_hints(mesh), \
                pytest.raises(ValueError, match="groups of 32 tokens and 2 token shards"):
            layers.moe_ffn(cfg, p, x)
