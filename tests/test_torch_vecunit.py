"""PyTorch port: the VecUnit ILA against the JAX reference.

* Each VecUnit intrinsic (element-wise mul, sigmoid), planned and
  simulated, equals the JAX ILA bit for bit: the port's grid scale is the
  reference's ``jnp.exp2`` (``numerics.exp2_ref_int``, an ulp off 2^e at
  the exponents the fragment builders pick, about -13 to -15) and its sigmoid the
  reference's ``1 / (1 + jnp.exp(-a))`` (``numerics.exp_f32``).
* ``EW_START`` on random states with exponents in that range, and at every
  point of the int16 grids k * 2^ea for ea in {-13, -14, -15}, equals the
  reference bit for bit in both modes.
* Within the port, the eager, jit, compiled, pipelined and fused engines
  are bit-identical, and per-stream modes in one batch match eager runs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import vecunit as jvu
from repro.core import ir as jir, validate
from repro.core.codegen import Executor as JExecutor
from repro_torch.accel import numerics as tn, vecunit as tvu
from repro_torch.core import ir as tir
from repro_torch.core.codegen import Executor as TExecutor

OPS = ["veu_mul", "veu_sigmoid"]


def _case(op, seed):
    return tvu.TARGET.intrinsics[op].sample(np.random.default_rng(seed))


def _run_port(op, args, engine="compiled"):
    vs = tuple(tir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
    env = {f"_{i}": a for i, a in enumerate(args)}
    return np.asarray(TExecutor("ila", engine=engine, device="cpu").run(tir.call(op, *vs), env))


def _run_jax(op, args):
    vs = tuple(jir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
    env = {f"_{i}": a for i, a in enumerate(args)}
    return np.asarray(JExecutor("ila").run(jir.call(op, *vs), env))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("op", OPS)
def test_intrinsic_matches_jax_ila(op, seed):
    args, _ = _case(op, seed)
    want = _run_jax(op, args)
    got = _run_port(op, args)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _ew_start_both(mode, bufs, regs):
    """``EW_START`` on one state in the reference and in the port."""
    jst = {k: jnp.asarray(v) for k, v in bufs.items()}
    jst.update({k: jnp.float32(v) for k, v in regs.items()})
    tst = {k: torch.from_numpy(v.copy()) for k, v in bufs.items()}
    tst.update(regs)
    want = np.asarray(jvu._ew_start(jst, 0, None)["vec_out"])
    return want, tvu._ew_start(tst, 0, None)["vec_out"].numpy()


@pytest.mark.parametrize("mode", [tvu.MODE_MUL, tvu.MODE_SIGMOID])
def test_ew_start_on_random_states(mode):
    rng = np.random.default_rng(mode)
    bufs = {k: (rng.standard_normal((tvu._WORDS, tvu.V)) * 0.5).astype(np.float32)
            for k in ("vec_a", "vec_b", "vec_out")}
    regs = {"mode": float(mode), "n_rows": 50.0, "n_cols": 37.0,
            "exp_a": -14.0, "exp_b": -15.0, "exp_o": -13.0 if mode == tvu.MODE_MUL else -15.0}
    want, got = _ew_start_both(mode, bufs, regs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ea", [-13, -14, -15])
@pytest.mark.parametrize("mode", [tvu.MODE_MUL, tvu.MODE_SIGMOID])
def test_ew_start_on_every_int16_grid_point(mode, ea):
    """a = k * 2^ea for every k in [-32767, 32767] (16 states of 4096),
    b random on the 2^-14 grid, the output grid 2^(ea + 1) for mul and the
    builders' 2^-14 for sigmoid: bit for bit."""
    rng = np.random.default_rng(-ea)
    grid = np.arange(-32767, 32768, dtype=np.float64) * 2.0 ** ea
    n = tvu.MAX_ROWS * tvu.MAX_COLS
    grid = np.concatenate([grid, np.zeros(-grid.size % n)]).astype(np.float32)
    regs = {"mode": float(mode), "n_rows": float(tvu.MAX_ROWS), "n_cols": float(tvu.MAX_COLS),
            "exp_a": float(ea), "exp_b": -14.0,
            "exp_o": float(ea + 1) if mode == tvu.MODE_MUL else -14.0}
    for chunk in grid.reshape(-1, tvu._WORDS, tvu.V):
        b = np.round(rng.standard_normal(chunk.shape) * 2 ** 13) * 2.0 ** -14
        bufs = {"vec_a": chunk, "vec_b": b.astype(np.float32),
                "vec_out": np.zeros_like(chunk)}
        want, got = _ew_start_both(mode, bufs, regs)
        np.testing.assert_array_equal(got, want)


def test_exp2_int_is_exact_where_the_driver_scales():
    """The grid scale is the reference's ``jnp.exp2``: exact down to 2^-12,
    an ulp or more off 2^e at -13, -15 and below (2^-14 is exact)."""
    e = torch.arange(-20, 3, dtype=torch.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(e.numpy())))
    got = tn.exp2_ref_int(e).numpy()
    np.testing.assert_array_equal(got, want)
    exact = np.array([2.0 ** int(v) for v in e], np.float32)
    assert [int(v) for v in e[torch.from_numpy(got != exact)]] == [-20, -19, -18, -17, -16,
                                                                     -15, -13]


@pytest.mark.parametrize("op", OPS)
def test_engines_bit_exact_within_port(op):
    args, _ = _case(op, 5)
    ref = _run_port(op, args, "compiled")
    for engine in ("eager", "jit", "pipelined", "fused"):
        np.testing.assert_array_equal(_run_port(op, args, engine), ref, err_msg=engine)


def test_batched_modes_match_eager():
    """One batch whose streams select different functions (mul vs sigmoid)
    and scales: each row equals its own eager run."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((20, 30)).astype(np.float32)
    b = rng.standard_normal((20, 30)).astype(np.float32)
    mul, sig = tvu.ew_fragment("mul", cache=False), tvu.ew_fragment("sigmoid", cache=False)
    streams = [tvu.pack_ew_data(mul, a, b).to_stream(), tvu.pack_ew_data(sig, 3 * a).to_stream(),
               tvu.pack_ew_data(mul, 0.01 * a, b).to_stream()]
    sts = tvu.vecunit.simulate_batch(streams, device="cpu")
    for i, s in enumerate(streams):
        one = tvu.read_full(tvu.vecunit.simulate(s.to_commands(), device="cpu"))
        np.testing.assert_array_equal(tvu.read_full(sts)[i].numpy(), one.numpy())


def test_vt2_and_mapping_cases_run_on_cpu():
    rng = np.random.default_rng(0)
    for case in tvu.TARGET.vt2_cases(8, 32):
        env = {k: rng.standard_normal(s).astype(np.float32) for k, s in case.var_shapes.items()}
        np.testing.assert_allclose(
            tir.interpret(case.ir_fragment, env, device="cpu").numpy(),
            tir.interpret(case.accel_fragment, env, device="cpu").numpy(), rtol=1e-6, atol=1e-7)
    for label, fn in tvu.TARGET.mapping_cases(np.random.default_rng(1)):
        ref, out = fn(device="cpu")
        assert validate.frob_rel_err(ref, out) <= 1e-3, label
