"""PyTorch port: the VTA ILA and ``int8_gemm``'s plain version against the JAX reference.

* Each VTA intrinsic, planned and simulated, matches the JAX ILA: the GEMM
  bit for bit (int8 products summed in float32 stay integers below 2^24,
  exact in any order), add and relu within their declared ``tol`` (they
  are expected bit-identical too: integer adds and maxima).
* The ALU's shift (requantization) and narrowing STORE match the reference,
  and the one-shot add/relu builders emit the reference's commands.
* Within the port, the eager, jit, compiled, pipelined and fused engines are
  bit-identical; per-stream ALU opcodes in one batch match eager runs.
* ``int8_gemm_ref`` equals the JAX ``int8_gemm`` (interpret mode) exactly on
  ``tests/test_kernels.py``'s shapes; kernel mode equals the reference's;
  the VT3 check is 0.0 on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import vta as jv
from repro.core import ir as jir, validate
from repro.core.codegen import Executor as JExecutor
from repro.kernels import ops as jops
from repro_torch.accel import vta as tv
from repro_torch.core import ila as tila, ir as tir
from repro_torch.core.codegen import Executor as TExecutor
from repro_torch.kernels import int8_gemm as ti8, ops as tops, ref as tref

OPS = ["vta_gemm", "vta_add", "vta_relu"]


def _case(op, seed):
    return tv.TARGET.intrinsics[op].sample(np.random.default_rng(seed))


def _run_port(op, args, engine="compiled", mode="ila"):
    vs = tuple(tir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
    env = {f"_{i}": a for i, a in enumerate(args)}
    return np.asarray(TExecutor(mode, engine=engine, device="cpu").run(tir.call(op, *vs), env))


def _run_jax(op, args, mode="ila"):
    vs = tuple(jir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
    env = {f"_{i}": a for i, a in enumerate(args)}
    return np.asarray(JExecutor(mode).run(jir.call(op, *vs), env))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op", OPS)
def test_intrinsic_matches_jax_ila(op, seed):
    args, _ = _case(op, seed)
    want = _run_jax(op, args)
    got = _run_port(op, args)
    assert got.shape == want.shape
    assert validate.frob_rel_err(want, got) <= tv.TARGET.intrinsics[op].tol
    if op == "vta_gemm":
        np.testing.assert_array_equal(got, want)
    print(f"{op} seed={seed}: {int((got != want).sum())}/{got.size} elements differ")


@pytest.mark.parametrize("op", OPS)
def test_engines_bit_exact_within_port(op):
    args, _ = _case(op, 5)
    ref = _run_port(op, args, "compiled")
    for engine in ("eager", "jit", "pipelined", "fused"):
        np.testing.assert_array_equal(_run_port(op, args, engine), ref, err_msg=engine)


@pytest.mark.parametrize("shift", [0, 3])
def test_requant_shift_and_narrowing_match_reference(shift):
    """ALU_SHR (floor(a / 2^b)) then a narrowing STORE clamps to int8."""
    rng = np.random.default_rng(shift)
    a = rng.integers(-120, 120, (20, 40)).astype(np.float32)
    b = rng.integers(-120, 120, (18, 40)).astype(np.float32)
    jcmds, jrd = jv.build_gemm_fragment(a, b, requant_shift=shift)
    tcmds, trd = tv.build_gemm_fragment(a, b, requant_shift=shift)
    assert [(c.opcode, c.addr) for c in tcmds] == [(c.opcode, c.addr) for c in jcmds]
    want = np.asarray(jrd(jv.vta.simulate(jcmds)))
    got = trd(tv.vta.simulate(tcmds, device="cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    if shift:
        assert got.min() >= -128 and got.max() <= 127
        np.testing.assert_array_equal(got, np.clip(np.floor((a @ b.T) / 2 ** shift), -128, 127))


@pytest.mark.parametrize("kind", ["add", "relu"])
def test_one_shot_alu_builders_match_reference(kind):
    """build_add_fragment/build_relu_fragment: the same command stream as
    the reference, and the same integer results on a ragged (R, C)."""
    rng = np.random.default_rng(9)
    a = rng.integers(-100, 100, (20, 37)).astype(np.float32)
    b = rng.integers(-100, 100, (20, 37)).astype(np.float32)
    args = (a, b) if kind == "add" else (a,)
    jcmds, jrd = getattr(jv, f"build_{kind}_fragment")(*args)
    tcmds, trd = getattr(tv, f"build_{kind}_fragment")(*args)
    assert [(c.opcode, c.addr, tuple(c.data)) for c in tcmds] == \
        [(c.opcode, c.addr, tuple(c.data)) for c in jcmds]
    got = trd(tv.vta.simulate(tcmds, device="cpu")).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrd(jv.vta.simulate(jcmds))))
    np.testing.assert_array_equal(got, a + b if kind == "add" else np.maximum(a, 0))


def test_batched_alu_opcodes_match_eager():
    """Stacked full streams whose ALU steps differ per row (add vs max)
    match per-stream eager simulation."""
    rng = np.random.default_rng(4)
    a = rng.integers(-50, 50, (16, 16)).astype(np.float32)
    b = rng.integers(-50, 50, (16, 16)).astype(np.float32)
    add = tv.alu_fragment(1, 1, "add", cache=False)
    relu = tv.alu_fragment(1, 1, "relu", cache=False)
    streams = [
        tv.pack_alu_data(add, a, b).to_stream(),
        tv.pack_alu_data(relu, a).to_stream(),
        tv.pack_alu_data(add, -a, b).to_stream(),
    ]
    # pad the relu stream's tail to the add streams' skeleton length
    sts = tv.vta.simulate_batch(streams, device="cpu")
    reads = [tv.read_alu_full(f) for f in (add, relu, add)]
    for i, (s, rd) in enumerate(zip(streams, reads)):
        one = rd(tv.vta.simulate(s.to_commands(), device="cpu"))
        np.testing.assert_array_equal(rd(sts)[i].numpy(), one.numpy())


@pytest.mark.parametrize("m,n,k", [(1, 3, 7), (128, 128, 128), (200, 300, 150)])
def test_int8_gemm_ref_equals_pallas(m, n, k):
    rng = np.random.default_rng(m)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (n, k)).astype(np.int8)
    want = np.asarray(jops.int8_gemm(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = ti8.int8_gemm.launches
    got = tops.int8_gemm(ta, tb)
    assert ti8.int8_gemm.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.int8_gemm_ref(ta, tb).numpy(), want)


def test_kernel_mode_matches_jax_kernel_mode():
    args, _ = _case("vta_gemm", 3)
    args = [a * 0.013 for a in args]  # non-integer operands: the ±127 host scaling
    want = _run_jax("vta_gemm", args, mode="kernel")
    np.testing.assert_array_equal(_run_port("vta_gemm", args, mode="kernel"), want)
    np.testing.assert_array_equal(_run_port("vta_gemm", args), want)


def test_vt3_ila_vs_kernel_on_cpu():
    ok, worst = tv.TARGET.vt3_checks["gemm_ila_vs_int8_gemm_kernel"](device="cpu")
    assert ok and worst == 0.0


def test_fragment_layout_and_cases_match_reference():
    rng = np.random.default_rng(7)
    b = rng.integers(-100, 100, (40, 70)).astype(np.float32)
    jf, tf = jv.gemm_fragment(b, 2, cache=False), tv.gemm_fragment(b, 2, cache=False)
    assert tf.key == jf.key and tf.meta == jf.meta
    np.testing.assert_array_equal(tf.setup.ops, jf.setup.ops)
    np.testing.assert_array_equal(tf.setup.data, jf.setup.data)
    (case,) = tv.TARGET.vt2_cases(8, 32)
    env = {k: rng.standard_normal(s).astype(np.float32) for k, s in case.var_shapes.items()}
    assert torch.equal(tir.interpret(case.ir_fragment, env, device="cpu"),
                       tir.interpret(case.accel_fragment, env, device="cpu"))
    ((label, fn),) = tv.TARGET.mapping_cases(np.random.default_rng(1))
    ref, out = fn(device="cpu")
    assert label == "GEMM"
    np.testing.assert_array_equal(out, ref)
    assert tila.set_stream_mesh() is None
