"""PyTorch port: the HLSCNN ILA and ``fx_gemm``'s plain version against the JAX reference.

* ``CONV_START`` on random architectural states (random SRAM contents and
  geometry, 8- and 16-bit weights) matches the JAX ILA within one output
  step (2^-8) everywhere, and bit for bit on at least 99% of the outputs:
  the port sums the exact float64 convolution and rounds once, the
  reference sums in float32, so they differ only where a float32 rounding
  error flips an output rounding.
* Fragment keys (which carry ``wgt_bits``) and the interface-command counts
  of ``plan_conv2d`` equal the reference's.
* Within the port, the eager, jit, compiled, pipelined and fused engines
  are bit-identical for ``wgt_bits`` 8 and 16 (the fused engine goes through
  ``fx_gemm``, whose plain version runs on CPU tensors).
* ``fx_gemm_ref`` matches the Pallas ``fx_gemm`` (interpret mode, padded as
  the reference's fused runner pads) within one output step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import hlscnn as jh
from repro.core import ir as jir
from repro.core.codegen import Executor as JExecutor
from repro.kernels.fx_gemm import fx_gemm as jfx_gemm
from repro_torch.accel import hlscnn as th, numerics as tn
from repro_torch.core import ila as tila, ir as tir
from repro_torch.core.codegen import Executor as TExecutor
from repro_torch.kernels import fx_gemm as tfx, ref as tref

STEP = 2.0 ** -8
#: least share of outputs bit-equal to the reference (float32 vs exact sums)
MIN_EQUAL = 0.99
REGS = ("in_h", "in_w", "in_c", "out_k", "k_h", "k_w", "s_h", "s_w", "wgt_bits")


def _random_state(seed, bits):
    rng = np.random.default_rng(seed)
    bufs = {
        "act_mem": (rng.standard_normal((th.ACT_WORDS, th.V)) * 4).astype(np.float32),
        "wgt_mem": (rng.standard_normal((th.WGT_WORDS, th.V)) * 0.1).astype(np.float32),
        "out_mem": rng.standard_normal((th.OUT_WORDS, th.V)).astype(np.float32),
    }
    geo = [int(rng.integers(6, 17)), int(rng.integers(6, 17)), int(rng.integers(1, 33)),
           int(rng.integers(1, 33)), int(rng.integers(1, 6)), int(rng.integers(1, 6)), 1, 1]
    return bufs, dict(zip(REGS, [float(g) for g in geo] + [float(bits)]))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conv_start_matches_jax_ila(seed, bits):
    bufs, regs = _random_state(seed, bits)
    jst = {k: jnp.asarray(v) for k, v in bufs.items()}
    jst.update({k: jnp.float32(v) for k, v in regs.items()})
    tst = {k: torch.from_numpy(v.copy()) for k, v in bufs.items()}
    tst.update(regs)
    want = np.asarray(jh._conv_start(jst, 0, np.zeros(th.V, np.float32))["out_mem"])
    got = th._conv_start(tst, 0, np.zeros(th.V, np.float32))["out_mem"].numpy()
    diff = np.abs(got.astype(np.float64) - want)
    equal = float(np.mean(diff == 0))
    print(f"seed={seed} bits={bits}: {equal:.5f} bit-equal, max diff {diff.max()}")
    assert diff.max() <= STEP
    assert equal >= MIN_EQUAL


def test_conv_start_batched_registers_match_per_stream():
    """Per-stream geometry and weight-width registers (a batched state)
    give each stream its own single-stream result."""
    states = [_random_state(s, b) for s, b in ((3, 8), (4, 16))]
    singles = []
    for bufs, regs in states:
        st = {k: torch.from_numpy(v.copy()) for k, v in bufs.items()}
        st.update(regs)
        singles.append(th._conv_start(st, 0, None)["out_mem"])
    batched = {k: torch.from_numpy(np.stack([b[k] for b, _ in states])) for k in states[0][0]}
    batched.update({k: torch.tensor([r[k] for _, r in states]) for k in REGS})
    out = th._conv_start(batched, 0, None)["out_mem"]
    for i, one in enumerate(singles):
        assert torch.equal(out[i], one)


@pytest.mark.parametrize("bits", [8, 16])
def test_fragment_keys_and_command_counts_match_reference(bits):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((2, 10, 10, 6)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 6, 12)) * 0.1).astype(np.float32)
    jf = jh.conv2d_fragment(w, (12, 12, 6), (1, 1), wgt_bits=bits, cache=False)
    tf = th.conv2d_fragment(w, (12, 12, 6), (1, 1), wgt_bits=bits, cache=False)
    assert tf.key == jf.key and tf.key[3] == bits
    assert len(tf.setup) == len(jf.setup)
    np.testing.assert_array_equal(tf.setup.data, jf.setup.data)
    xp = np.pad(x[:1], ((0, 0), (1, 1), (1, 1), (0, 0)))
    tdata = th.pack_conv2d_data(tf, xp)
    jdata = jh.pack_conv2d_data(jf, xp)
    assert tdata.sig() == jdata.sig()
    opts = {"hlscnn": {"wgt_bits": bits}}
    attrs = {"strides": (1, 1), "padding": (1, 1)}
    jex, tex = JExecutor("ila", target_options=opts), TExecutor("ila", target_options=opts,
                                                                 device="cpu")
    jout = np.asarray(jex.run(jir.call("hlscnn_conv2d", jir.Var("x", x.shape),
                                       jir.Var("w", w.shape), **attrs), {"x": x, "w": w}))
    tout = np.asarray(tex.run(tir.call("hlscnn_conv2d", tir.Var("x", x.shape),
                                       tir.Var("w", w.shape), **attrs), {"x": x, "w": w}))
    assert np.abs(tout.astype(np.float64) - jout).max() <= STEP
    js, ts = jex.stats_summary()["hlscnn"], tex.stats_summary()["hlscnn"]
    assert ts["invocations"] == js["invocations"] == 1
    assert ts["commands"] == js["commands"]
    assert ts["est_cycles"] == js["est_cycles"]


@pytest.mark.parametrize("bits", [8, 16])
def test_engines_bit_identical_within_port(bits):
    rng = np.random.default_rng(20 + bits)
    xs = [rng.standard_normal((1, 9, 9, 5)).astype(np.float32) for _ in range(3)]
    w = (rng.standard_normal((3, 3, 5, 7)) * 0.1).astype(np.float32)
    e = tir.call("hlscnn_conv2d", tir.Var("x", (1, 9, 9, 5)), tir.Var("w", w.shape),
                 strides=(1, 1), padding=(1, 1))
    envs = [{"x": x, "w": w} for x in xs]
    opts = {"hlscnn": {"wgt_bits": bits}}
    ref = [np.asarray(TExecutor("ila", engine="eager", target_options=opts,
                                device="cpu").run(e, env)) for env in envs]
    for engine in ("jit", "compiled", "pipelined", "fused"):
        ex = TExecutor("ila", engine=engine, target_options=opts, device="cpu")
        for got, want in zip(ex.run_many(e, envs), ref):
            np.testing.assert_array_equal(np.asarray(got), want, err_msg=engine)
        np.testing.assert_array_equal(np.asarray(ex.run(e, envs[0])), ref[0], err_msg=engine)


def test_fused_runner_plumbing():
    """One kernel-lowered runner per (fragment key, device): the 8- and
    16-bit fragments get separate runners; foreign ILAs get none."""
    w = (np.random.default_rng(5).standard_normal((3, 3, 4, 6)) * 0.1).astype(np.float32)
    f8 = th.conv2d_fragment(w, (8, 8, 4), wgt_bits=8)
    f16 = th.conv2d_fragment(w, (8, 8, 4), wgt_bits=16)
    r8, r16 = th.TARGET.fused_runner(f8, "cpu"), th.TARGET.fused_runner(f16, "cpu")
    assert r8 is not r16 and r8.lowering == r16.lowering == "kernel"
    assert th.TARGET.fused_runner(f8, "cpu") is r8
    foreign = tila.CompiledFragment(tila.ILA("foreign", vwidth=16), f8.key, f8.setup,
                                    dict(f8.meta))
    assert th.TARGET.fused_runner(foreign, "cpu") is None
    x = np.random.default_rng(6).standard_normal((1, 8, 8, 4)).astype(np.float32)
    datas = [th.pack_conv2d_data(f16, x), th.pack_conv2d_data(f16, 2 * x)]
    want = th.read_full(f16.run_batch(datas, "cpu"))[:2]
    before = tfx.fx_gemm.launches
    assert torch.equal(r16.run(datas)[:2], want)
    assert tfx.fx_gemm.launches == before  # CPU tensors run the plain version


@pytest.mark.parametrize("bits", [8, 16])
def test_fx_gemm_ref_matches_pallas_fx_gemm(bits):
    """(144, 800) patches against a (32, 800) weight, padded to the Pallas
    tiles (K 896, N 128) for the reference as hlscnn.py pads them."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((144, 800)) * 4).astype(np.float32)
    w = (rng.standard_normal((32, 800)) * 0.1).astype(np.float32)
    wspec_t = tn.HLSCNN_WEIGHT_UPDATED if bits == 16 else tn.HLSCNN_WEIGHT_ORIGINAL
    wspec_j = jh.W16 if bits == 16 else jh.W8
    xp = np.pad(x, ((0, 0), (0, 96)))
    wp = np.zeros((128, 896), np.float32)
    wp[:32, :800] = w
    want = np.asarray(jfx_gemm(jnp.asarray(xp), jnp.asarray(wp), x_spec=jh.ACT_SPEC,
                               w_spec=wspec_j, o_spec=jh.ACT_SPEC, interpret=True))[:, :32]
    got = tref.fx_gemm_ref(torch.from_numpy(x), torch.from_numpy(w), tn.HLSCNN_ACT,
                           wspec_t, tn.HLSCNN_ACT).numpy()
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.max() <= STEP
    assert np.mean(diff == 0) >= MIN_EQUAL
    # the wrapper on CPU tensors is the plain version, batch or not
    specs = dict(x_spec=tn.HLSCNN_ACT, w_spec=wspec_t, o_spec=tn.HLSCNN_ACT)
    batched = tfx.fx_gemm(torch.from_numpy(np.stack([x, -x])), torch.from_numpy(w), **specs)
    assert torch.equal(batched[0], torch.from_numpy(got))
    assert torch.equal(batched[1], tref.fx_gemm_ref(torch.from_numpy(-x), torch.from_numpy(w),
                                                    tn.HLSCNN_ACT, wspec_t, tn.HLSCNN_ACT))


def test_fx_gemm_sum_is_exact():
    """The float64 sum is the exact integer dot product, in any order."""
    rng = np.random.default_rng(8)
    xi = rng.integers(-2 ** 15, 2 ** 15, (4, 800))
    wi = rng.integers(-2 ** 15, 2 ** 15, (3, 800))
    x = torch.from_numpy((xi / 256.0).astype(np.float32))
    w = torch.from_numpy((wi / 2048.0).astype(np.float32))
    big = tn.FixedPointSpec(n_bits=32, n_frac=0)
    got = tref.fx_gemm_ref(x, w, tn.HLSCNN_ACT, tn.HLSCNN_WEIGHT_UPDATED, big)
    exact = (xi.astype(object) @ wi.T.astype(object))
    want = np.vectorize(lambda v: float(np.float32(v / 2 ** 19)))(exact)
    np.testing.assert_array_equal(got.numpy(), np.round(want).astype(np.float32))
    with pytest.raises(ValueError, match="exact"):
        tfx.check_exact(2 ** 24, tn.HLSCNN_ACT, tn.HLSCNN_WEIGHT_UPDATED)


def test_vt2_and_mapping_cases_run_on_cpu():
    (case,) = th.TARGET.vt2_cases()
    rng = np.random.default_rng(0)
    env = {k: rng.standard_normal(s).astype(np.float32) for k, s in case.var_shapes.items()}
    a = tir.interpret(case.ir_fragment, env, device="cpu")
    b = tir.interpret(case.accel_fragment, env, device="cpu")
    assert torch.equal(a, b)
    ((label, fn),) = th.TARGET.mapping_cases(np.random.default_rng(1))
    ref, out = fn(device="cpu")
    assert label == "Conv2D" and ref.shape == out.shape == (1, 10, 10, 16)
    assert np.linalg.norm(ref - out) / np.linalg.norm(ref) <= th.TARGET.intrinsics[
        "hlscnn_conv2d"].tol
