"""PyTorch port: the sharding rules against the JAX reference, leaf by leaf.

For every config at its full published size, on the 1x1, 16x16 and
2x16x16 meshes, the port's spec of each leaf equals the reference's:
parameters, AdamW and Adafactor state, the batch, the caches of
``decode_32k`` (batch 128: batch-sharded) and ``long_500k`` (batch 1: the
sequence-sharded SP layout) where ``cell_is_supported``, and the serve
steps' token and logit specs and placements.

Neither side allocates a tensor. The reference's rules read only
``mesh.axis_names`` and ``mesh.devices.shape``, so a stand-in object gives
them the production sizes (no 256 XLA devices, nothing in ``src/repro``
changes); its trees come from ``jax.eval_shape``. The port's rules take a
DeviceMesh over a ``"fake"`` process group of the mesh's world size, made
and destroyed around each mesh, and its trees are meta tensors. The port
holds one tensor per layer where the reference stacks ``(L, ...)``: each
per-layer leaf must equal the stacked leaf's spec with its leading (layer)
entry dropped.
"""
import contextlib
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro import configs as jconfigs, optim as joptim
from repro.launch import sharding as rshd, steps as rst
from repro.models import api as rapi
from repro_torch import configs as tconfigs, optim as toptim
from repro_torch.launch import mesh as tmesh, sharding as shd, steps as tst
from repro_torch.models import api as tapi
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.optim.optimizers import tree_leaves

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
CACHE_SHAPES = ("decode_32k", "long_500k")


@contextlib.contextmanager
def fake_mesh(name):
    """The port's DeviceMesh over a fake process group, destroyed after."""
    shape, axes = MESHES[name]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        yield tmesh.make_mesh(shape, axes, device="cpu")
    finally:
        dist.destroy_process_group()


def ref_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return rst.abstract_params(jconfigs.get_config(arch))


def ref_paths(tree):
    """{"/"-joined path: spec} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(k.key) for k in path): tuple(spec) for path, spec in flat}


def port_paths(tree, stacks=tapi.STACKED):
    """{(path, layer or None): spec} of a port spec tree; a layer list
    (only under ``stacks``) gives one entry per layer."""
    out = {}

    def walk(t, path, layer):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k, layer)
        elif isinstance(t, list):
            assert path.split("/")[-1] in stacks, path
            for i, v in enumerate(t):
                walk(v, path, i)
        else:
            assert isinstance(t, shd.Spec), (path, t)
            out[(path, layer)] = tuple(t)

    walk(tree, "", None)
    return out


def assert_same(ref_tree, port_tree, what, stacks=tapi.STACKED):
    ref = ref_paths(ref_tree)
    port = port_paths(port_tree, stacks)
    assert {p for p, _ in port} == set(ref), what
    for (path, layer), spec in port.items():
        want = ref[path] if layer is None else ref[path][1:]
        if layer is not None:
            assert ref[path][0] is None, (what, path, ref[path])
        assert spec == want, (what, path, layer, spec, want)
    return sum(1 for s in port.values() if any(a is not None for a in s)), len(port)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_specs_equal_reference_leaf_by_leaf(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    rparams = ref_params(arch)
    tparams = tst.abstract_params(tcfg)
    assert all(p.device.type == "meta" for p in tparams.parameters())
    for name in MESHES:
        rm = ref_mesh(name)
        with fake_mesh(name) as tm:
            rp = rshd.param_specs(rparams, rm)
            tp = shd.param_specs(tparams, tm)
            sharded, total = assert_same(rp, tp, f"{arch} {name} params")
            assert total == len(list(tparams.parameters()))
            if name != "1x1":
                assert sharded > 0, (arch, name)

            for opt in ("adamw", "adafactor"):
                r_opt = rst._opt_specs(
                    jax.eval_shape(joptim.make_optimizer(opt).init, rparams), rp)
                t_opt = tst._opt_specs(toptim.make_optimizer(opt).init(tparams.tree()), tp)
                assert tuple(t_opt["step"]) == tuple(r_opt["step"]) == ()
                assert_same(r_opt["m"], t_opt["m"], f"{arch} {name} {opt} m")
                # Adafactor's v is stacked in both packages: no layer lists
                assert_same(r_opt["v"], t_opt["v"], f"{arch} {name} {opt} v",
                            stacks=tapi.STACKED if opt == "adamw" else ())

            rb, tb = rshd.batch_specs(jcfg, rm), shd.batch_specs(tcfg, tm)
            assert {k: tuple(v) for k, v in rb.items()} == {k: tuple(v) for k, v in tb.items()}

            for sname in CACHE_SHAPES:
                shape = SHAPES[sname]
                ok, _ = rapi.cell_is_supported(jcfg, shape)
                assert tapi.cell_is_supported(tcfg, shape)[0] == ok
                if not ok:
                    continue
                B, S = shape.global_batch, shape.seq_len
                rc = rshd.cache_specs(jcfg, jax.eval_shape(lambda: rapi.init_cache(jcfg, B, S)),
                                      rm, B)
                tc = shd.cache_specs(tcfg, tapi.init_cache(tcfg, B, S, device="meta"), tm, B)
                assert_same(rc, tc, f"{arch} {name} {sname} cache", stacks=())


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_serve_step_placements_equal_reference(arch, monkeypatch):
    """Tokens in and logits out of both serve steps, batch-sharded (128)
    and not (1), on every mesh; the cache specs as above."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    monkeypatch.setattr(rst, "abstract_params", lambda cfg: ref_params(arch))
    # a NamedSharding needs a real jax mesh: record the spec instead
    named = lambda mesh, spec: SimpleNamespace(spec=spec)
    monkeypatch.setattr(rst, "NamedSharding", named)
    monkeypatch.setattr(rshd, "NamedSharding", named)
    for name in MESHES:
        rm = ref_mesh(name)
        with fake_mesh(name) as tm:
            for B in (128, 1):
                shape = ShapeConfig("s", 64, B, "decode")
                for kind in ("decode", "prefill"):
                    rb = rst.make_serve_step(jcfg, shape, rm, kind)
                    tb = tst.make_serve_step(tcfg, shape, tm, kind)
                    ref_in = (rb.in_shardings[2] if kind == "decode"
                              else {k: v for k, v in rb.in_shardings[1].items()})
                    port_in = tb.in_specs[2] if kind == "decode" else tb.in_specs[1]
                    if kind == "decode":
                        assert tuple(port_in) == tuple(ref_in.spec), (name, B, kind)
                    else:
                        assert {k: tuple(v) for k, v in port_in.items()} == \
                            {k: tuple(v.spec) for k, v in ref_in.items()}, (name, B, kind)
                    assert tuple(tb.out_specs[0]) == tuple(rb.out_shardings[0].spec), \
                        (name, B, kind)
                    assert tb.out_placements[0] == shd.to_placements(
                        shd.Spec(*rb.out_shardings[0].spec), tm)
                    cache_ref = rb.in_shardings[1 if kind == "decode" else 2]
                    cache_port = tb.in_specs[1 if kind == "decode" else 2]
                    cache_ref = jax.tree_util.tree_map(
                        lambda s: s.spec, cache_ref, is_leaf=lambda x: isinstance(x, SimpleNamespace))
                    assert_same(cache_ref, cache_port, f"{arch} {name} {kind} cache", stacks=())


def test_attention_tp_fsdp():
    with fake_mesh("1x1") as mesh:
        specs = shd.param_specs(tst.abstract_params(tconfigs.get_smoke_config("tinyllama_1_1b")),
                                mesh)
    q = specs["layers"][0]["attn"]["q"]
    assert tuple(q) == ("data", "model")       # (D@fsdp, heads@tp), per layer
    assert tuple(specs["layers"][0]["attn"]["o"]) == ("model", "data")


def test_moe_expert_parallel():
    with fake_mesh("1x1") as mesh:
        specs = shd.param_specs(
            tst.abstract_params(tconfigs.get_smoke_config("qwen3_moe_30b_a3b")), mesh)
    assert tuple(specs["layers"][0]["moe"]["w_gate"])[:1] == ("model",)   # (E@ep, ...)


def test_norms_replicated():
    with fake_mesh("1x1") as mesh:
        specs = shd.param_specs(tst.abstract_params(tconfigs.get_smoke_config("gemma_7b")),
                                mesh)
    assert all(a is None for a in specs["final_norm"])


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "falcon_mamba_7b", "zamba2_7b",
                                  "whisper_base"])
def test_every_leaf_has_spec(arch):
    model = tst.abstract_params(tconfigs.get_smoke_config(arch))
    with fake_mesh("1x1") as mesh:
        specs = shd.param_specs(model, mesh)
    assert len(tree_leaves(specs)) == len(list(model.parameters())), arch
    assert all(isinstance(s, shd.Spec) for s in tree_leaves(specs))


def test_nondivisible_axes_dropped():
    """SmolLM's 15 heads on the 16-way 'model' axis: attention activations
    are not sharded over heads there; ``hint_heads`` shards the sequence
    instead. (Its q/k/v weights still shard their 960 / 320 columns, which
    16 divides, as the reference's do: checked leaf by leaf above.)"""
    from repro_torch.models import layers as TL

    cfg = tconfigs.get_config("smollm_360m")
    assert cfg.n_heads == 15
    with fake_mesh("16x16") as mesh:
        with TL.mesh_hints(mesh):
            sizes = TL._MESH_HINTS.get()[1]
        q = (16, 1024, cfg.n_heads, cfg.hd)
        assert TL.hint_spec(q, TL.heads_spec(q, sizes), sizes) == ("data", "model", None, None)
        # a weight's dim 16 does not divide is left unsharded
        assert TL.hint_spec((15, 64), ("model", None), sizes) == (None, None)
        llama = (16, 1024, 32, 64)
        assert TL.hint_spec(llama, TL.heads_spec(llama, sizes), sizes) == \
            ("data", None, "model", None)


def test_mesh_needs_a_process_group_of_its_size():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no.*initialised|none is initialised"):
        tmesh.make_smoke_mesh(device="cpu")
    with fake_mesh("1x1"):
        with pytest.raises(RuntimeError, match="world size 256"):
            tmesh.make_production_mesh(device="cpu")
    assert not dist.is_initialized()


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    with fake_mesh("2x16x16") as mesh:
        assert shd.to_placements(shd.Spec(("pod", "data"), "model"), mesh) == \
            (Shard(0), Shard(0), Shard(1))
        assert shd.to_placements(shd.Spec(None, "data"), mesh) == \
            (Replicate(), Shard(1), Replicate())
        assert tmesh.data_axes(mesh) == ("pod", "data")
        assert shd.dp_total(mesh) == 32
