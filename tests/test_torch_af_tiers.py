"""PyTorch port: the reference's two tiers of ``a / jnp.exp2(e)``.

Run op by op (eager), the reference divides by ``jnp.exp2(e)``; compiled
(``jax.jit``, and every ``lax.switch``, whose branches XLA compiles as one
computation even op by op), XLA rewrites ``A / exp(B)`` into
``A * exp(-B)``. The two differ at AdaptivFloat lattice midpoints wherever
the window's powers are inexact, and on windows whose top is at or below
2^-126. The port computes both (``numerics.tier``, ``numerics.div_exp2``)
and runs each where the reference runs it:

* ``af_quantize`` in each tier equals the reference's tier at every lattice
  midpoint, and one ulp each side, of every window from bias -149 to 130;
* ``af_gemm_ref`` takes the compiled form (``tests/test_torch_af_gemm_order.py``);
* FlexASR's FN_START is compiled in every tier of the reference: the eager
  and compiled engines both equal theirs on a linear whose input sits on
  midpoints, where the eager form would give other outputs;
* VecUnit's grid power has a second use, so XLA keeps its division: both
  tiers divide, in the reference and in the port, where the multiply would
  round otherwise;
* VTA's shift ``floor(a / jnp.exp2(s))`` is off by one at the exact
  multiples k 2^s for s = 13 and 15 (``jnp.exp2`` misses 2^s there), in
  both tiers of the reference and in the port alike; near them the
  reference's switch takes the compiled multiply, and so does the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.accel import numerics as jn, vecunit as jvu, vta as jvta
from repro.core import ir as jir
from repro.core.codegen import Executor as JExecutor
from repro.core.ila import Command as JCommand
from repro_torch.accel import flexasr as tfa, numerics as tn, vecunit as tvu, vta as tvta
from repro_torch.core import ir as tir
from repro_torch.core.codegen import Executor as TExecutor
from repro_torch.core.ila import Command as TCommand

J_SPEC = jn.AdaptivFloatSpec(8, 3)
T_SPEC = tn.AdaptivFloatSpec(8, 3)
#: the bias sweep in chunks (each a test case of a few seconds)
BIAS_CHUNKS = [(-149, -110), (-109, -60), (-59, -10), (-9, 40), (41, 90), (91, 130)]
_JIT_Q = jax.jit(lambda a, b: jn.af_quantize(a, J_SPEC, exp_bias=b))


def _differ(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Indices where the float32 bits differ (any NaN equals any NaN)."""
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    nan = np.isnan(got) & np.isnan(want)
    return np.flatnonzero((got.view(np.uint32) != want.view(np.uint32)) & ~nan)


def _sweep_points(bias: int) -> np.ndarray:
    """Every lattice midpoint of the window, one ulp each side, both signs,
    with 0, 2^bias and the midpoints of the binades just outside."""
    inner = [chip_smoke.af_midpoints(b, T_SPEC) for b in (bias - 8, bias, bias + 8)]
    with np.errstate(over="ignore"):   # inf past the top binade, one shape for all
        x = np.concatenate(inner + [np.array([0.0, 2.0 ** bias], np.float32)])
    return np.concatenate([x, -x])


@pytest.mark.parametrize("lo,hi", BIAS_CHUNKS)
def test_af_quantize_each_tier_equals_the_reference_at_every_midpoint(lo, hi):
    """Compiled form vs ``jax.jit(af_quantize)``, eager form vs the
    reference op by op: no point differs, at any bias."""
    tiers_differ = 0
    for bias in range(lo, hi + 1):
        x = _sweep_points(bias)
        want_jit = np.asarray(_JIT_Q(jnp.asarray(x), jnp.float32(bias)))
        want_eager = np.asarray(jn.af_quantize(jnp.asarray(x), J_SPEC, exp_bias=jnp.float32(bias)))
        got = tn.af_quantize(torch.from_numpy(x), T_SPEC, exp_bias=float(bias)).numpy()
        with tn.tier("eager"):
            got_eager = tn.af_quantize(torch.from_numpy(x), T_SPEC, exp_bias=float(bias)).numpy()
        bad = _differ(got, want_jit)
        assert bad.size == 0, (bias, x[bad][:4], got[bad][:4], want_jit[bad][:4])
        bad = _differ(got_eager, want_eager)
        assert bad.size == 0, (bias, x[bad][:4], got_eager[bad][:4], want_eager[bad][:4])
        tiers_differ += _differ(want_jit, want_eager).size
    assert tiers_differ > 0  # each chunk holds windows where the tiers part


def test_the_tiers_part_at_a_midpoint_and_below_2_126():
    """The reference facts, pinned: bias -20, x = 9.834766e-07 (a midpoint
    of the binade 2^-20); bias -134, whose powers all flush to 0: eager
    0 / 0 is NaN, compiled multiplies by the finite exp2_neg(-127)."""
    x = np.array([9.834766e-07], np.float32)
    cases = [(x, -20.0, [1.0132788e-06], [9.5367426e-07]),
             (np.array([0.0, 2.0 ** -126, 1.5 * 2.0 ** -130], np.float32), -134.0,
              [np.nan, 0.0, np.nan], [0.0, 0.0, 0.0])]
    for v, bias, eager, compiled in cases:
        eager, compiled = np.array(eager, np.float32), np.array(compiled, np.float32)
        assert _differ(np.asarray(jn.af_quantize(jnp.asarray(v), J_SPEC, bias)), eager).size == 0
        assert _differ(np.asarray(_JIT_Q(jnp.asarray(v), jnp.float32(bias))), compiled).size == 0
        with tn.tier("eager"):
            assert _differ(tn.af_quantize(torch.from_numpy(v), T_SPEC, bias).numpy(),
                           eager).size == 0
        assert _differ(tn.af_quantize(torch.from_numpy(v), T_SPEC, bias).numpy(),
                       compiled).size == 0


def _midpoint_linear():
    """A FlexASR linear whose input lies on the lattice midpoints of the
    window [-20, -13] (bias -20)."""
    rng = np.random.default_rng(3)
    mids = chip_smoke.af_midpoints(-20, T_SPEC)
    x = (rng.choice(mids, (16, 64)) * rng.choice([-1.0, 1.0], (16, 64))).astype(np.float32)
    x[0, 0] = mids.max()
    w = (rng.standard_normal((48, 64)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(48) * 1e-5).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("engine", ["eager", "compiled"])
def test_flexasr_linear_on_midpoints_each_engine_equals_its_reference(engine):
    """The reference's FN_START is a ``lax.switch``: compiled in every tier,
    so its eager engine gives the compiled form too, and so does the
    port's; the eager form would give other outputs here."""
    x, w, b = _midpoint_linear()
    env = {"x": x, "w": w, "b": b}
    jexpr = jir.call("fasr_linear", *(jir.Var(k, v.shape) for k, v in env.items()))
    texpr = tir.call("fasr_linear", *(tir.Var(k, v.shape) for k, v in env.items()))
    want = np.asarray(JExecutor("ila", engine=engine).run(jexpr, env))
    got = np.asarray(TExecutor("ila", engine=engine, device="cpu").run(texpr, env))
    assert _differ(got, want).size == 0
    assert _differ(want, np.asarray(JExecutor("ila", engine="compiled").run(jexpr, env))).size == 0
    # the same linear with x quantized in the eager form
    ba, bo = tfa._exp_biases(x, x @ w.T + b)
    (bw,) = tfa._exp_biases(w)
    with tn.tier("eager"):
        xq = tn.af_quantize(torch.from_numpy(x), T_SPEC, ba)
    assert _differ(xq.numpy(), tn.af_quantize(torch.from_numpy(x), T_SPEC, ba).numpy()).size > 0
    wq = tn.af_quantize(torch.from_numpy(w), T_SPEC, bw)
    y_eager = tn.af_quantize(xq @ wq.T + torch.from_numpy(b), T_SPEC, bo).numpy()
    assert _differ(y_eager, want).size > 0


def _vecunit_points(ea: int) -> np.ndarray:
    """The points that divide to k + 1/2 by ``jnp.exp2(ea)``, and their
    float32 neighbours up to 3 ulps: where x / exp2(ea) and x *
    exp2_neg(ea) can round apart. As (states, words, V)."""
    s = float(tn.exp2_ref_int(torch.tensor(float(ea))))
    lo = hi = ((np.arange(-8192, 8192) + 0.5) * s).astype(np.float32)
    pts = [lo]
    for _ in range(3):
        lo, hi = np.nextafter(lo, np.float32(-np.inf)), np.nextafter(hi, np.float32(np.inf))
        pts += [lo, hi]
    return np.concatenate(pts).reshape(-1, tvu._WORDS, tvu.V)


@pytest.mark.parametrize("ea", [-15, -16])
def test_vecunit_divides_in_both_tiers(ea):
    """EW_START's grid scale ``jnp.exp2(ea)`` also multiplies the rounded
    value back, so XLA keeps the division under ``jit``: ``simulate`` and
    ``simulate_jit`` agree, where the multiply by ``exp2_neg`` would round
    otherwise (a few of these points at -15, every half-way point at -16,
    the builders' exponent for |a| <= 1/4); the port's equal the
    reference's (mul by 1.0, output grid 2^ea)."""
    cfg = [(tvu.CFG, (tvu.MODE_MUL, tvu.MAX_ROWS, tvu.MAX_COLS)),
           (tvu.CFG_NUM, (ea, -14, ea)), (tvu.EW_START, ())]
    jc = [JCommand(op, 0, d) for op, d in cfg]
    tc = [TCommand(op, 0, d) for op, d in cfg]
    forms_differ = 0
    for a in _vecunit_points(ea):
        one = np.ones_like(a)
        jst = dict(jvu.vecunit.init_state(), vec_a=jnp.asarray(a), vec_b=jnp.asarray(one))
        tst = dict(tvu.vecunit.init_state("cpu"), vec_a=torch.from_numpy(a),
                   vec_b=torch.from_numpy(one))
        je = np.asarray(jvu.vecunit.simulate(jc, jst)["vec_out"])
        jj = np.asarray(jvu.vecunit.simulate_jit(jc, jst)["vec_out"])
        te = tvu.vecunit.simulate(tc, tst)["vec_out"].numpy()
        tj = tvu.vecunit.simulate_jit(tc, tst)["vec_out"].numpy()
        assert _differ(je, jj).size == 0
        assert _differ(te, je).size == 0 and _differ(tj, jj).size == 0
        e = torch.full(a.shape, float(ea))
        forms_differ += _differ(torch.round(tn.div_exp2(torch.from_numpy(a), e)).numpy(),
                                torch.round(torch.from_numpy(a) / tn.exp2_ref_int(e)).numpy()).size
    assert forms_differ > 0


def _vta_shift(pkg: str, engine: str, a: np.ndarray, s: int) -> np.ndarray:
    """``floor(a / jnp.exp2(s))`` through VTA's ALU in the reference
    (``pkg`` "jax") or the port ("torch"): one SHR command with immediate
    s per tile of a, in rounds of N_ACC tiles."""
    if pkg == "jax":
        ila, command, tensor, init = jvta.vta, JCommand, jnp.asarray, ()
    else:
        ila, command, tensor, init = tvta.vta, TCommand, torch.from_numpy, ("cpu",)
    tile = tvta.T * tvta.T
    out = []
    for r in range(0, a.size, tvta.N_ACC * tile):
        part = a[r: r + tvta.N_ACC * tile]
        acc = np.zeros((tvta.N_ACC, tvta.T, tvta.T), np.float32)
        acc.reshape(-1)[: part.size] = part
        cmds = [command(tvta.ALU, 0, (tvta.ALU_SHR, d, 0, 1, s))
                for d in range(-(-part.size // tile))]
        st = dict(ila.init_state(*init), acc_rf=tensor(acc))
        out.append(np.asarray(getattr(ila, engine)(cmds, st)["acc_rf"]).reshape(-1)[: part.size])
    return np.concatenate(out)


@pytest.mark.parametrize("engine", ["simulate", "simulate_jit"])
def test_vta_shift_off_by_one_at_exact_multiples(engine):
    """``floor(a / jnp.exp2(s))`` at a = k 2^s, k in [-3000, 3000), s in
    0..15: the reference is one below k where ``jnp.exp2(s)`` is above 2^s
    (s = 13 and 15 only), 5999 of 96000 points, in both tiers (its shift is
    in a ``lax.switch``); the port gives the reference's values. The eager
    engine runs s = 13 and 15 alone (each eager switch compiles anew)."""
    k = np.arange(-3000, 3000, dtype=np.float64)
    wrong = 0
    for s in (range(16) if engine == "simulate_jit" else (13, 15)):
        a = (k * 2.0 ** s).astype(np.float32)
        want = _vta_shift("jax", engine, a, s)
        got = _vta_shift("torch", engine, a, s)
        np.testing.assert_array_equal(got, want)
        wrong += int((want != k).sum())
        assert (want != k).any() == (s in (13, 15)), s
    assert wrong == 5999


def test_vta_shift_takes_the_compiled_form():
    """Near the multiples of 2^13 and 2^15 (a = k 2^s + d, |d| <= 2, |a| <
    2^24) the eager division and the compiled multiply part at a few
    points; the reference's switch takes the multiply, in ``simulate_jit``
    as in ``simulate``, and so does the port's ALU in every tier."""
    forms_differ = 0
    for s in (13, 15):
        kmax = 2 ** 24 >> s
        k = np.arange(-kmax, kmax, max(1, kmax // 4096), dtype=np.float64)
        a = np.concatenate([k * 2.0 ** s + d for d in (-2, -1, 0, 1, 2)]).astype(np.float32)
        want = _vta_shift("jax", "simulate_jit", a, s)
        for engine in ("simulate", "simulate_jit"):
            np.testing.assert_array_equal(_vta_shift("torch", engine, a, s), want)
        with tn.tier("eager"):
            eager = torch.floor(tn.div_exp2(torch.from_numpy(a), torch.tensor(float(s)))).numpy()
        forms_differ += int((eager != want).sum())
    assert forms_differ > 0
