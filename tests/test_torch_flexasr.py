"""PyTorch port: the FlexASR ILA and the ILA core against the JAX reference.

* Each FlexASR intrinsic (linear, LSTM, max/mean pool, layer norm,
  attention), planned into fragments and simulated, matches the JAX ILA
  within its declared ``Intrinsic.tol``; the two are expected to agree bit
  for bit, so each test reports how many elements differ and holds every
  difference to one AF lattice step (fp32 sums and transcendentals round
  differently in the two frameworks, and a rounding flip moves a value by
  one step).
* Within the port, the compiled, eager, jit and pipelined engines are
  bit-exact to each other, and the fused engine is held to the compiled
  one as ``tests/test_fused.py`` holds the reference's.
* The ILA core's batch handling (per-stream registers, per-row opcodes and
  modes, clamped dynamic slices) matches per-stream eager simulation and
  ``jax.lax``'s clamping.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import flexasr as jfa
from repro.core import ir as jir, validate
from repro.core.codegen import Executor as JExecutor
from repro_torch.accel import flexasr as tfa
from repro_torch.core import ila as tila, ir as tir
from repro_torch.core.codegen import Executor as TExecutor

#: fused-vs-compiled bound for reassociated lowerings (as tests/test_fused.py)
TIGHT = 1e-4
OPS = ["fasr_linear", "fasr_lstm", "fasr_maxpool", "fasr_meanpool",
       "fasr_layernorm", "fasr_attention"]


def _case(op, seed):
    args, attrs = tfa.TARGET.intrinsics[op].sample(np.random.default_rng(seed))
    return args, attrs


def _run_port(op, args, attrs, engine="compiled", mode="ila"):
    vs = tuple(tir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
    env = {f"_{i}": a for i, a in enumerate(args)}
    ex = TExecutor(mode, engine=engine, device="cpu")
    return np.asarray(ex.run(tir.call(op, *vs, **attrs), env))


def _run_jax(op, args, attrs):
    vs = tuple(jir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
    env = {f"_{i}": a for i, a in enumerate(args)}
    return np.asarray(JExecutor("ila", engine="compiled").run(jir.call(op, *vs, **attrs), env))


def _lattice_step(a, b):
    m = np.maximum(np.abs(a), np.abs(b)).astype(np.float64)
    e = np.floor(np.log2(np.where(m > 0, m, 1.0)))
    return np.exp2(e - tfa.AF.n_man)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op", OPS)
def test_fragment_matches_jax_ila(op, seed):
    args, attrs = _case(op, seed)
    want = _run_jax(op, args, attrs)
    got = _run_port(op, args, attrs)
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.float64) - want)
    n_diff = int((diff > 0).sum())
    print(f"{op} seed={seed}: {n_diff}/{got.size} elements differ, max {diff.max():.3g}")
    assert validate.frob_rel_err(want, got) <= tfa.TARGET.intrinsics[op].tol
    assert np.all(diff <= _lattice_step(got, want) * (1 + 1e-6))


@pytest.mark.parametrize("op", OPS)
def test_engines_bit_exact_within_port(op):
    args, attrs = _case(op, 5)
    ref = _run_port(op, args, attrs, "compiled")
    for engine in ("eager", "jit", "pipelined"):
        np.testing.assert_array_equal(_run_port(op, args, attrs, engine), ref, err_msg=engine)


def test_run_many_batches_match_single_runs():
    """Per-sample exponent windows become per-stream registers in one
    batched run; every sample equals its own single-stream run."""
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((24, 40)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((24,)) * 0.1).astype(np.float32)
    xs = [(rng.standard_normal((6, 40)) * s).astype(np.float32) for s in (0.1, 1.0, 7.0)]
    e = tir.call("fasr_linear", tir.Var("x", (6, 40)), tir.Var("w", w.shape), tir.Var("b", b.shape))
    envs = [{"x": x, "w": w, "b": b} for x in xs]
    for engine in ("compiled", "pipelined", "fused"):
        ex = TExecutor("ila", engine=engine, device="cpu")
        many = ex.run_many(e, envs)
        singles = [np.asarray(TExecutor("ila", engine="eager", device="cpu").run(e, env))
                   for env in envs]
        for s, m in zip(singles, many):
            np.testing.assert_array_equal(np.asarray(m), s, err_msg=engine)


def _fused_args(op, seed=0):
    rng = np.random.default_rng(seed)
    if op == "fasr_linear":
        return [rng.standard_normal((64, 96)).astype(np.float32),
                (rng.standard_normal((48, 96)) * 0.1).astype(np.float32),
                rng.standard_normal((48,)).astype(np.float32)]
    return [rng.standard_normal((24, 1, 48)).astype(np.float32),
            (rng.standard_normal((4 * 32, 48)) * 0.2).astype(np.float32),
            (rng.standard_normal((4 * 32, 32)) * 0.2).astype(np.float32),
            rng.standard_normal((4 * 32,)).astype(np.float32)]


@pytest.mark.parametrize("op,exact", [("fasr_linear", True), ("fasr_lstm", False)])
def test_fused_plain_leg_replicates_compiled(op, exact):
    """The plain PyTorch leg: the LSTM runner through the Executor, and the
    linear runner of fragments with an on-accelerator activation (planners
    leave activations on the host, so these are built directly)."""
    args = _fused_args(op)
    pairs = []
    if op == "fasr_lstm":
        pairs.append((_run_port(op, args, {}, "compiled"), _run_port(op, args, {}, "fused")))
    else:
        x, w, b = args
        for act in (tfa.ACT_RELU, tfa.ACT_SIGMOID, tfa.ACT_TANH):
            frag = tfa.linear_fragment(w, b, act, cache=False)
            runner = tfa.TARGET.fused_runner(frag, "cpu")
            assert runner.lowering == "plain"
            datas = [tfa.pack_linear_data(frag, x[:32]), tfa.pack_linear_data(frag, 3 * x[32:])]
            ref = tfa.read_full(frag.run_batch(datas, "cpu"))[: len(datas)]
            pairs.append((ref.numpy(), runner.run(datas)[: len(datas)].numpy()))
    for ref, got in pairs:
        if exact:
            np.testing.assert_array_equal(ref, got)
        else:
            assert validate.frob_rel_err(ref, got) <= TIGHT
    assert tfa.TARGET.cache_info()["fused_runners"] >= 1


def test_fused_kernel_leg_tracks_compiled():
    """The activation-free linear runner is the af_gemm leg on every device
    (the wrapper's plain version on CPU tensors) and matches the compiled
    tier."""
    args = _fused_args("fasr_linear")
    frag = tfa.linear_fragment(args[1], args[2])
    assert tfa.TARGET.fused_runner(frag, "cpu").lowering == "kernel"
    ref = _run_port("fasr_linear", args, {}, "compiled")
    got = _run_port("fasr_linear", args, {}, "fused")
    assert validate.frob_rel_err(ref, got) <= TIGHT
    np.testing.assert_array_equal(ref, got)


def test_fused_runner_refuses_foreign_ila():
    args = _fused_args("fasr_linear")
    frag = tfa.linear_fragment(args[1], args[2])
    assert tfa.TARGET.fused_runner(frag, "cpu") is not None
    foreign = tila.CompiledFragment(tila.ILA("foreign", vwidth=16), frag.key, frag.setup,
                                    dict(frag.meta))
    assert tfa.TARGET.fused_runner(foreign, "cpu") is None


def test_kernel_mode_matches_jax_kernel_mode():
    args, _ = _case("fasr_linear", 3)
    vs = tuple(jir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
    env = {f"_{i}": a for i, a in enumerate(args)}
    want = np.asarray(JExecutor("kernel").run(jir.call("fasr_linear", *vs), env))
    np.testing.assert_array_equal(_run_port("fasr_linear", args, {}, mode="kernel"), want)


def test_simulate_batch_mixed_streams_match_eager():
    """Stacked full streams whose steps differ per row — payloads, opcodes
    (a linear and a pooling stream) and FN_START modes (max vs mean pool,
    same skeleton) — match per-stream eager simulation."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    w = (rng.standard_normal((8, 16)) * 0.3).astype(np.float32)
    b = np.zeros((8,), np.float32)
    lin = tfa.linear_fragment(w, b, cache=False)
    mx, mn = tfa.pool_fragment(16, "max", cache=False), tfa.pool_fragment(16, "mean", cache=False)
    streams = [
        tila.PackedStream.from_commands(lin.full_commands(tfa.pack_linear_data(lin, x)), 16),
        tila.PackedStream.from_commands(mx.full_commands(tfa.pack_pool_data(mx, x)), 16),
        tila.PackedStream.from_commands(mn.full_commands(tfa.pack_pool_data(mn, x)), 16),
        tila.PackedStream.from_commands(mn.full_commands(tfa.pack_pool_data(mn, 2 * x)), 16),
    ]
    sts = tfa.flexasr.simulate_batch(streams, device="cpu")
    full = tfa.read_full(sts)
    assert full.shape[0] == 4
    for i, s in enumerate(streams):
        one = tfa.read_full(tfa.flexasr.simulate(s.to_commands(), device="cpu"))
        np.testing.assert_array_equal(full[i].numpy(), one.numpy())


@pytest.mark.parametrize("start", [(0, 0), (3, 5), (9, 2), (-4, 7), (40, 40)])
def test_dynamic_slices_clamp_like_jax(start):
    rng = np.random.default_rng(1)
    buf = rng.standard_normal((12, 10)).astype(np.float32)
    blk = rng.standard_normal((4, 3)).astype(np.float32)
    want_w = np.asarray(jax.lax.dynamic_update_slice(jnp.asarray(buf), jnp.asarray(blk), start))
    want_r = np.asarray(jax.lax.dynamic_slice(jnp.asarray(buf), start, (4, 3)))
    got_w = tila.write_block(torch.from_numpy(buf.copy()), torch.from_numpy(blk), start)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    np.testing.assert_array_equal(tila.read_block(torch.from_numpy(buf), start, (4, 3)).numpy(),
                                  want_r)
    # the same start per stream of a batch (tensor starts)
    per = tuple(torch.tensor([s, s]) for s in start)
    got_b = tila.write_block(torch.from_numpy(buf.copy()), torch.from_numpy(blk), per)
    np.testing.assert_array_equal(got_b.numpy(), np.stack([want_w, want_w]))
    np.testing.assert_array_equal(
        tila.read_block(torch.from_numpy(buf), per, (4, 3)).numpy(), np.stack([want_r, want_r]))


def test_setup_state_is_never_written():
    args = _fused_args("fasr_linear")
    frag = tfa.linear_fragment(args[1], args[2], cache=False)
    st0 = frag.setup_state("cpu")
    snap = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in st0.items()}
    data = tfa.pack_linear_data(frag, args[0][:5])
    frag.run(data, "cpu")
    frag.run_batch([data, tfa.pack_linear_data(frag, args[0][5:10])], "cpu")
    for k, v in frag.setup_state("cpu").items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, snap[k]), k
        else:
            assert v == snap[k], k


def test_jax_and_port_bucketing_agree():
    from repro.core import ila as jila

    for n in (1, 3, 5, 16, 17, 100):
        assert tila.bucket_length(n) == jila.bucket_length(n)
        assert tila.batch_bucket(n) == jila.batch_bucket(n)
    assert tila.set_stream_mesh("auto") is None
    assert jfa.V == tfa.V and jfa.BASE_OUT == tfa.BASE_OUT


@contextlib.contextmanager
def _restored_cost_models():
    """Snapshot every registered target's CostModel (command scales, fitted
    latency model, drift accumulators) and restore it on exit."""
    models = [t.cost_model for t in tila.TARGETS.all() if t.cost_model is not None]
    saved = [(dict(m.command_scale), dict(m.latency), list(m._drift)) for m in models]
    try:
        yield
    finally:
        for m, (scale, latency, drift) in zip(models, saved):
            m.command_scale.clear()
            m.command_scale.update(scale)
            m.latency.clear()
            m.latency.update(latency)
            m._drift = drift


def test_multi_device_scheduling_and_submit_paths_are_bit_exact():
    """Two simulated devices per target (LPT placement, device-local setup
    state) and the request-level submit/prepack API change scheduling
    only: results equal the single-device compiled run."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    w = (rng.standard_normal((24, 40)) * 0.1).astype(np.float32)
    g = rng.standard_normal((24,)).astype(np.float32)
    xv, wv, gv = tir.Var("x", x.shape), tir.Var("w", w.shape), tir.Var("g", g.shape)
    lin = tir.call("fasr_linear", xv, wv, tir.call("zeros", shape=(24,)))
    e = tir.call("relu", tir.call("fasr_layernorm", lin, gv, gv, eps=1e-5))
    envs = [{"x": x * s, "w": w, "g": g} for s in (0.5, 1.0, 2.0)]
    ref = [np.asarray(o) for o in TExecutor("ila", device="cpu").run_many(e, envs)]
    for engine in ("compiled", "pipelined", "fused"):
        ex = TExecutor("ila", engine=engine, devices_per_target=2, device="cpu")
        for got, want in zip(ex.run_many(e, envs), ref):
            np.testing.assert_array_equal(np.asarray(got), want, err_msg=engine)
        pre = ex.prepack_many(e, envs)
        sub = ex.submit_many(e, envs, prepack=pre)
        for got, want in zip(sub.result(), ref):
            np.testing.assert_array_equal(np.asarray(got), want, err_msg=engine)
        summary = ex.stats_summary()["flexasr"]
        assert summary["invocations"] == 2 * 2 * 3  # two runs x two ops x three samples
        assert set(summary["devices"]) == {"flexasr[0]", "flexasr[1]"}
        assert ex.pipeline_summary()["groups"] > 0
        # calibration fits the registered targets' shared CostModels: undo
        # it so that later tests in this process price with the analytic
        # model the reference uses
        with _restored_cost_models():
            ex.calibrate_cost_models()
            ex.calibrate_from_timings()
        ex.reset_stats()
        assert ex.stats_summary().get("flexasr", {}).get("invocations", 0) == 0
