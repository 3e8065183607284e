"""PyTorch port: the registry-wide conformance suite, for every ported target.

The port's counterpart of ``tests/test_target_conformance.py``, held to the
JAX reference where the reference is the oracle. Parameterized over every
target in ``repro_torch.core.ila.TARGETS`` (FlexASR, HLSCNN, VecUnit, VTA)
and every intrinsic each declares, through the intrinsic's own ``sample``
generator:

* the registry itself matches the reference's: target names and order,
  intrinsic ops, tolerances, options, capabilities and VT2 tolerances;
* ideal-vs-numerics: the port's ILA co-simulation tracks its fp32 IR
  interpreter within the intrinsic's ``tol``, and the reference's ILA
  within the same ``tol``;
* engine parity within the port: eager == jit == compiled == pipelined ==
  ``run_many``, bit for bit; the fused engine within ``tol`` (bit-exact
  where the fused numerics replicate the compiled ones), on one and two
  simulated devices;
* rewrite soundness: each VT2 fragment pair agrees under ideal semantics
  within its declared bound, and compiling the IR side extracts the
  intrinsic;
* cost models: every target prices every intrinsic it claims, exactly as
  the reference prices it; costs grow with the batch; calibration fits the
  observed command counts; a cheaper competing target wins extraction and
  ``forbid``/``prefer`` flip it;
* coverage: every target receives offloads from some stock application.

This file never names a target.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import ila as jila, ir as jir, validate
from repro.core.codegen import Executor as JExecutor
from repro_torch.core import apps, ir
from repro_torch.core.codegen import Executor
from repro_torch.core.compile import SelectionPolicy, compile_program
from repro_torch.core.ila import ILA, TARGETS


def _intrinsic_params():
    return [pytest.param(t, intr, id=f"{t.name}:{op}")
            for t in TARGETS.all() for op, intr in t.intrinsics.items()
            if intr.sample is not None]


def _case(intr, seed, mod=ir):
    args, attrs = intr.sample(np.random.default_rng(seed))
    vs = tuple(mod.Var(f"_{i}", a.shape) for i, a in enumerate(args))
    return mod.call(intr.op, *vs, **attrs), {f"_{i}": a for i, a in enumerate(args)}


def _executor(t, intr, **kw):
    return Executor("ila", target_options={t.name: intr.options}, device="cpu", **kw)


def test_registry_matches_reference():
    assert TARGETS.names() == jila.TARGETS.names()
    for t, jt in zip(TARGETS.all(), jila.TARGETS.all()):
        assert t.name == jt.name and t.capabilities == jt.capabilities
        assert t.vt2_tol == jt.vt2_tol and t.lint == t.lint.__class__(**vars(jt.lint))
        assert list(t.intrinsics) == list(jt.intrinsics)
        for op, intr in t.intrinsics.items():
            ji = jt.intrinsics[op]
            assert (intr.tol, intr.options, intr.passthrough) == (ji.tol, ji.options,
                                                                  ji.passthrough)
            assert (intr.kernel is None) == (ji.kernel is None)
            assert (intr.planner is None) == (ji.planner is None)
        assert sorted(t.vt3_checks) == sorted(jt.vt3_checks)


@pytest.mark.parametrize("t,intr", _intrinsic_params())
def test_numerics_within_tol_of_ideal_and_reference(t, intr):
    for seed in (0, 1):
        expr, env = _case(intr, seed)
        ideal = np.asarray(Executor("ideal", device="cpu").run(expr, env))
        got = np.asarray(_executor(t, intr).run(expr, env))
        assert got.shape == ideal.shape
        assert validate.frob_rel_err(ideal, got) <= intr.tol
    jexpr, jenv = _case(intr, 0, jir)
    want = np.asarray(JExecutor("ila", target_options={t.name: intr.options}).run(jexpr, jenv))
    expr, env = _case(intr, 0)
    got = np.asarray(_executor(t, intr).run(expr, env))
    assert validate.frob_rel_err(want, got) <= intr.tol


@pytest.mark.parametrize("t,intr", _intrinsic_params())
def test_engines_bit_exact_and_fused_within_tol(t, intr):
    expr, env = _case(intr, 2)
    _, env2 = _case(intr, 3)
    ref = np.asarray(_executor(t, intr, engine="compiled").run(expr, env))
    for engine in ("jit", "eager", "pipelined"):
        np.testing.assert_array_equal(
            np.asarray(_executor(t, intr, engine=engine).run(expr, env)), ref,
            err_msg=f"{t.name}:{intr.op} {engine}")
    ref2 = np.asarray(_executor(t, intr).run(expr, env2))
    outs = _executor(t, intr, pipeline_chunk=2).run_many(expr, [env, env2, env])
    for got, want in zip(outs, (ref, ref2, ref)):
        np.testing.assert_array_equal(np.asarray(got), want)
    for ndev in (1, 2):
        fused = _executor(t, intr, engine="fused", devices_per_target=ndev)
        for got, want in zip(fused.run_many(expr, [env, env2, env]), (ref, ref2, ref)):
            assert validate.frob_rel_err(want, np.asarray(got)) <= intr.tol


def _vt2_params():
    return [pytest.param(t, case, id=f"{t.name}:{case.name}")
            for t in TARGETS.all() for case in t.vt2_cases(8, 32)]


@pytest.mark.parametrize("t,case", _vt2_params())
def test_vt2_cases_sound_and_extracted(t, case):
    rng = np.random.default_rng(0)
    for _ in range(3):
        env = {k: rng.standard_normal(s).astype(np.float32) for k, s in case.var_shapes.items()}
        a = ir.interpret(case.ir_fragment, env, device="cpu").numpy()
        b = ir.interpret(case.accel_fragment, env, device="cpu").numpy()
        assert validate.frob_rel_err(a, b) <= case.tol
    res = compile_program(case.ir_fragment, targets=(t.name,), flexible=True)
    assert res.accelerator_calls.get(t.name, 0) >= 1
    env = {k: rng.standard_normal(s).astype(np.float32) for k, s in case.var_shapes.items()}
    np.testing.assert_allclose(ir.interpret(res.program, env, device="cpu").numpy(),
                               ir.interpret(case.ir_fragment, env, device="cpu").numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tname", TARGETS.names())
def test_every_target_offloaded_by_some_app(tname):
    hits = {name: compile_program(builder()[0]).accelerator_calls.get(tname, 0)
            for name, (builder, _) in apps.APPLICATIONS.items()}
    assert any(n >= 1 for n in hits.values()), hits


@pytest.mark.parametrize("t", TARGETS.all(), ids=TARGETS.names())
def test_cost_model_prices_every_intrinsic_as_reference(t):
    jt = jila.TARGETS.get(t.name)
    assert t.cost_model is not None
    rng = np.random.default_rng(0)
    for op, intr in t.intrinsics.items():
        assert t.cost_model.covers(op), op
        if intr.sample is not None:
            args, attrs = intr.sample(rng)
            shapes = [np.shape(a) for a in args]
        else:
            shapes, attrs = [(8, 8)], {}
        est = t.cost_model.estimate(op, attrs, shapes)
        assert est.cycles > 0 and est.commands >= 0 and est.bytes_moved >= 0
        want = jt.cost_model.estimate(op, attrs, shapes)
        assert dataclasses.astuple(est) == dataclasses.astuple(want), op


@pytest.mark.parametrize("t,intr", _intrinsic_params())
def test_cost_monotone_in_batch_size(t, intr):
    args, attrs = intr.sample(np.random.default_rng(0))
    shapes = [np.shape(a) for a in args]

    def scaled(k):
        return [((s[0] * k,) + tuple(s[1:])) if (i == 0 or tuple(s) == tuple(shapes[0]))
                else tuple(s) for i, s in enumerate(shapes)]

    e1 = t.cost_model.estimate(intr.op, attrs, scaled(1))
    e4 = t.cost_model.estimate(intr.op, attrs, scaled(4))
    assert e1.cycles > 0 and e1.commands > 0 and e4.cycles > e1.cycles
    assert e4.commands >= e1.commands and e4.bytes_moved >= e1.bytes_moved


@pytest.mark.parametrize("t,intr", _intrinsic_params())
def test_calibration_fits_observed_commands(t, intr):
    expr, env = _case(intr, 5)
    ex = _executor(t, intr)
    ex.run(expr, env)
    observed = sum(s.n_commands for s in ex.stats if s.op == intr.op)
    assert observed > 0
    saved = dict(t.cost_model.command_scale)
    try:
        ex.calibrate_cost_models()
        refit = t.cost_model.estimate(intr.op, dict(expr.attrs),
                                      [np.shape(env[f"_{i}"]) for i in range(len(env))])
        assert refit.commands == pytest.approx(observed, rel=1e-6)
    finally:
        t.cost_model.command_scale.clear()
        t.cost_model.command_scale.update(saved)


@pytest.fixture
def competing_targets():
    """Two synthetic targets claiming the host op ``maximum`` with cost
    models 50x apart, registered for the test only."""
    from repro_torch.accel.target import (
        AcceleratorTarget, CostModel, Intrinsic, register_target, unregister_target,
    )
    from repro_torch.core.egraph import P, Rewrite, V as PV

    def build(name, op, cycles_per_elem):
        target = AcceleratorTarget(name, ILA(name))
        target.add_intrinsic(Intrinsic(
            op, shape=lambda attrs, cs: tuple(np.broadcast_shapes(cs[0], cs[1])),
            ideal=lambda attrs, a: a[0].maximum(a[1])))
        costs = CostModel(name)
        costs.op(op)(lambda attrs, shapes, c=cycles_per_elem: (
            1, 12, c * int(np.prod(np.broadcast_shapes(*shapes)))))
        target.add_cost_model(costs)
        target.add_rewrites(lambda op=op: [
            Rewrite(f"{name}-max", P("maximum", PV("a"), PV("b")), P(op, PV("a"), PV("b")))])
        return register_target(target)

    cheap = build("t_cheap", "tcheap_max", 1.0)
    pricey = build("t_pricey", "tpricey_max", 50.0)
    try:
        yield cheap, pricey
    finally:
        unregister_target(cheap)
        unregister_target(pricey)


def test_policy_picks_cheaper_target_and_overrides_flip(competing_targets):
    cheap, pricey = competing_targets
    prog = ir.call("maximum", ir.Var("a", (8, 8)), ir.Var("b", (8, 8)))
    names = (cheap.name, pricey.name)
    calls = compile_program(prog, targets=names).accelerator_calls
    assert (calls[cheap.name], calls[pricey.name]) == (1, 0)
    calls = compile_program(prog, targets=names,
                            policy=SelectionPolicy(forbid=(cheap.name,))).accelerator_calls
    assert (calls[cheap.name], calls[pricey.name]) == (0, 1)
    calls = compile_program(prog, targets=names,
                            policy=SelectionPolicy(prefer=(pricey.name,))).accelerator_calls
    assert (calls[cheap.name], calls[pricey.name]) == (0, 1)
    assert TARGETS.names()[-2:] == list(names)
