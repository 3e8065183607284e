"""PyTorch port: the ILA stream mesh (``core/ila.py::set_stream_mesh``).

The batched tiers split their padded batch axis over the mesh's devices.
On this CPU the mesh repeats one device (``["cpu"] * 3``), the port's
counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=N``; every shard then
runs on the CPU, one after the other, through the same sharded path a mesh
of cards takes.

* the mesh rules of ``tests/test_pipeline.py`` (padding, one device
  disables) and ``mesh_pad`` equal to the reference's at mesh sizes 2-4;
* ``tests/test_target_conformance.py::test_mesh_sharded_batch_parity`` on
  the port: for every planner intrinsic of every target, on 3- and 4-way
  meshes, the compiled and pipelined engines give the unsharded port's
  outputs bit for bit and the reference's unsharded outputs bit for bit,
  VecUnit's included (the port computes the reference's exp2 and exp);
  the fused engine gives the unsharded fused outputs bit for bit and stays
  within ``tol`` of the compiled ones;
* ``CosimServer`` serves the same bits on a 3-way mesh as without one;
* the serve launcher's ``--mesh``.
"""
import functools
import types

import numpy as np
import pytest
import torch

import repro.accel  # noqa: F401  (registers the reference's targets)
from repro.core import ila as jila, ir as jir, validate
from repro.core.codegen import Executor as JExecutor
from repro_torch.accel import flexasr as fa
from repro_torch.core import ila, ir
from repro_torch.core.codegen import Executor
from repro_torch.core.ila import TARGETS
from repro_torch.core.serving import CosimServer
from repro_torch.launch import serve

CPU = torch.device("cpu")
ENGINES = ("compiled", "pipelined", "fused")
#: targets held to the reference at ``Intrinsic.tol`` rather than bit for
#: bit: none (the port computes VecUnit's exp2 and sigmoid as the reference does)
TOL_TARGETS = ()


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of small ops: torch's intra-op thread pool only adds
    overhead, and oversubscribes the cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_mesh_after():
    """Every test leaves the process-wide mesh off."""
    yield
    ila.set_stream_mesh(None)


def _cpu_mesh(n):
    return ila.set_stream_mesh([CPU] * n)


# ---------------------------------------------------------------------------
# the mesh rules
# ---------------------------------------------------------------------------


def test_mesh_pad_rounds_to_mesh_multiple(monkeypatch):
    assert ila.mesh_pad(8) == 8  # no mesh: identity
    monkeypatch.setattr(ila, "_STREAM_MESH", ila.StreamMesh((CPU,) * 3))
    assert ila.mesh_pad(8) == 9
    assert ila.mesh_pad(3) == 3
    assert ila.mesh_pad(1) == 3


def test_set_stream_mesh_single_device_disables():
    assert ila.set_stream_mesh(1) is None
    assert ila.stream_mesh() is None
    assert ila.set_stream_mesh([CPU]) is None
    if torch.cuda.device_count() < 2:
        assert ila.set_stream_mesh("auto") is None   # never a CPU mesh
        assert ila.stream_mesh() is None


@pytest.mark.parametrize("m", (2, 3, 4))
def test_mesh_pad_matches_reference(monkeypatch, m):
    monkeypatch.setattr(jila, "_STREAM_MESH", types.SimpleNamespace(devices=np.zeros(m)))
    monkeypatch.setattr(ila, "_STREAM_MESH", ila.StreamMesh((CPU,) * m))
    for n in range(1, 101):
        assert ila.mesh_pad(n) == jila.mesh_pad(n), n
        assert ila.mesh_pad(ila.batch_bucket(n)) == jila.mesh_pad(jila.batch_bucket(n)), n


def test_set_stream_mesh_specs():
    mesh = _cpu_mesh(3)
    assert mesh.devices == (CPU,) * 3 and mesh.size == 3
    assert ila.stream_mesh() is mesh and "cpu" in str(mesh)
    assert ila.set_stream_mesh("off") is None and ila.stream_mesh() is None
    assert ila.set_stream_mesh(mesh) == mesh
    assert ila.set_stream_mesh(None) is None
    assert ila.set_stream_mesh(["cpu", "cpu"]).devices == (CPU, CPU)
    ila.set_stream_mesh(None)
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match="cards asked for"):
        ila.set_stream_mesh(have + 2)
    assert ila.stream_mesh() is None


def test_batched_tiers_return_one_shard_per_device():
    """5 streams pad to 8, then to 9 on a 3-way mesh: three shards of 3,
    each read like an unsharded batch, joined in mesh order."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((16, 32)) * 0.1).astype(np.float32)
    frag = fa.linear_fragment(w, np.zeros((16,), np.float32))
    datas = [fa.pack_linear_data(frag, rng.standard_normal((8, 32)).astype(np.float32))
             for _ in range(5)]
    want = fa.read_full(frag.run_batch(datas, CPU))
    _cpu_mesh(3)
    shards = frag.run_batch(datas, CPU)
    assert isinstance(shards, ila.Shards) and len(shards) == 3
    for st in shards:
        assert frag.ila.batch_size(st) == 3
        assert all(v.device == CPU for v in st.values() if isinstance(v, torch.Tensor))
    got = np.concatenate([fa.read_full(st).numpy() for st in shards])
    np.testing.assert_array_equal(got[:5], want.numpy()[:5])
    # one state handed in: copied to every mesh device
    copied = frag.ila.run_data_batch(datas, frag.setup_state(CPU))
    assert isinstance(copied, ila.Shards) and len(copied) == 3
    np.testing.assert_array_equal(
        np.concatenate([fa.read_full(st).numpy() for st in copied]), got)
    runner = Executor("ila", engine="fused", device="cpu")._fused_for(
        frag, fa.read_full, TARGETS.get("flexasr"))
    fused = runner.run(datas)
    assert isinstance(fused, ila.Shards) and [f.shape[0] for f in fused] == [3, 3, 3]
    np.testing.assert_array_equal(np.concatenate([f.numpy() for f in fused])[:5], want.numpy()[:5])


# ---------------------------------------------------------------------------
# engine parity on a mesh (test_mesh_sharded_batch_parity)
# ---------------------------------------------------------------------------


def _intrinsic_params():
    return [pytest.param(t, intr, id=f"{t.name}:{op}")
            for t in TARGETS.all() for op, intr in t.intrinsics.items()
            if intr.planner is not None and intr.sample is not None]


def _envs(intr, mod):
    """Five environments, two distinct samples interleaved (8 pads to 9 on
    a 3-way mesh)."""
    cases = []
    for seed in (11, 12):
        args, attrs = intr.sample(np.random.default_rng(seed))
        vs = tuple(mod.Var(f"_{i}", a.shape) for i, a in enumerate(args))
        cases.append((mod.call(intr.op, *vs, **attrs), {f"_{i}": a for i, a in enumerate(args)}))
    (expr, env), (_, env2) = cases
    return expr, [env, env2, env, env2, env]


def _run(t, intr, engine):
    expr, envs = _envs(intr, ir)
    ex = Executor("ila", engine=engine, target_options={t.name: intr.options}, device="cpu",
                  pipeline_chunk=2)
    return [np.asarray(o) for o in ex.run_many(expr, envs)]


@functools.lru_cache(maxsize=None)
def _unsharded(tname, op):
    """The port's unsharded outputs per engine and the reference's compiled
    ones, once per intrinsic (the reference runs each of the two distinct
    samples once: its per-sample numerics do not depend on the batch)."""
    t = TARGETS.get(tname)
    intr = t.intrinsics[op]
    outs = {e: _run(t, intr, e) for e in ENGINES}
    jexpr, jenvs = _envs(intr, jir)
    jex = JExecutor("ila", engine="compiled", target_options={t.name: intr.options})
    ref = [np.asarray(jex.run(jexpr, env)) for env in jenvs[:2]]
    outs["reference"] = [ref[i % 2] for i in range(len(jenvs))]
    return outs


@pytest.mark.parametrize("m", (3, 4))
@pytest.mark.parametrize("t,intr", _intrinsic_params())
def test_mesh_sharded_engines_bit_exact(monkeypatch, t, intr, m):
    want = _unsharded(t.name, intr.op)
    shards = []
    split = ila._shard_batched
    monkeypatch.setattr(ila, "_shard_batched", lambda x: shards.append(len(x)) or split(x))
    assert _cpu_mesh(m).size == m
    got = {e: _run(t, intr, e) for e in ENGINES}
    ila.set_stream_mesh(None)
    assert shards and all(n % m == 0 for n in shards), "the batched tiers never sharded"
    for i, ref in enumerate(want["reference"]):
        for e in ENGINES:
            np.testing.assert_array_equal(
                got[e][i], want[e][i], err_msg=f"{t.name}:{intr.op} {e} on {m} shards")
        for e in ("compiled", "pipelined"):
            if t.name in TOL_TARGETS:
                assert validate.frob_rel_err(ref, got[e][i]) <= intr.tol
            else:
                np.testing.assert_array_equal(
                    got[e][i], ref, err_msg=f"{t.name}:{intr.op} {e} on {m} shards vs reference")
        err = validate.frob_rel_err(got["compiled"][i], got["fused"][i])
        assert err <= intr.tol, f"{t.name}:{intr.op} mesh+fused rel err {err} > tol {intr.tol}"


# ---------------------------------------------------------------------------
# serving and the launcher
# ---------------------------------------------------------------------------


def _serve(engine, mesh):
    """Six batch-1 requests submitted before start, on ``mesh`` devices."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((8, 16)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((8,)) * 0.1).astype(np.float32)
    expr = ir.call("relu", ir.call("fasr_linear", ir.Var("x", (4, 16)), ir.Var("w", w.shape),
                                   ir.Var("b", b.shape)))
    ila.set_stream_mesh(mesh)
    srv = CosimServer(engine=engine, pipeline_chunk=2, device="cpu", seed=3, max_batch=8,
                      queue_depth=32)
    srv.add_program("tiny", expr, {"w": w, "b": b})
    handles = [srv.submit("tiny", batch=1) for _ in range(6)]
    try:
        srv.start(warmup=1, warm_batch=2)
        outs = {h.id: h.result(timeout=300) for h in handles}
    finally:
        srv.close(drain=True)
        ila.set_stream_mesh(None)
    assert srv.summary()["served"] == 6
    return outs


@pytest.mark.parametrize("engine", ["pipelined", "fused"])
def test_server_on_a_mesh_serves_the_unsharded_bits(engine):
    want = _serve(engine, None)
    got = _serve(engine, [CPU] * 3)
    assert sorted(got) == sorted(want)
    for rid in want:
        for g, w in zip(got[rid], want[rid]):
            assert isinstance(g, np.ndarray)
            np.testing.assert_array_equal(g, w, err_msg=f"request {rid}")


def test_cosim_launcher_mesh_flag(capsys):
    srv, handles = serve.main(["--cosim", "resmlp", "--device", "cpu", "--requests", "1",
                               "--batch", "1", "--mesh", "auto"])
    out = capsys.readouterr().out
    if torch.cuda.device_count() < 2:
        assert "stream mesh: disabled (single device host)" in out
    assert "load: 1/1 served" in out
    assert ila.stream_mesh() is None
    serve.main(["--cosim", "resmlp", "--device", "cpu", "--requests", "1", "--batch", "1"])
    assert "stream mesh" not in capsys.readouterr().out   # --mesh off: no line
