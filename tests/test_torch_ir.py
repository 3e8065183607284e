"""PyTorch port: IR interpreter and flexible matching against the JAX reference.

The port's interpreter evaluates all six ``apps.build_*`` programs within
rtol = atol = 1e-5 of ``repro.core.ir.interpret`` on the same seeded inputs
(fp32 sums and transcendentals round differently in the two frameworks).
Flexible matching extracts a structurally equal program with the same
per-target accelerator-call counts for every app on FlexASR alone, and for
the conv apps and ResMLP on the target sets of the later slices:
(flexasr, hlscnn), (flexasr, hlscnn, vecunit) and (vta,).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apps as japps, ir as jir
from repro.core.compile import compile_program as jcompile
from repro_torch.core import apps as tapps, ir as tir
from repro_torch.core.compile import compile_program as tcompile

APPS = {
    "build_efficientnet": (1, 12, 12, 8),
    "build_lstm_wlm": (16, 1, 32),
    "build_mobilenet_v2": (1, 12, 12, 8),
    "build_resmlp": (16, 64),
    "build_resnet20": (1, 12, 12, 8),
    "build_transformer": (16, 64),
}


@pytest.mark.parametrize("name", sorted(APPS))
def test_interpreter_matches_reference(name):
    j_expr, params = getattr(japps, name)(seed=0)
    t_expr, t_params = getattr(tapps, name)(seed=0)
    assert repr(t_expr) == repr(j_expr)
    for k in params:
        np.testing.assert_array_equal(t_params[k], params[k])
    x = np.random.default_rng(11).standard_normal(APPS[name]).astype(np.float32)
    want = np.asarray(jir.interpret(j_expr, dict(params, x=jnp.asarray(x))))
    got = tir.interpret(t_expr, dict(params, x=x), device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


TARGET_SETS = {
    ("flexasr",): sorted(APPS),
    ("flexasr", "hlscnn"): ["build_efficientnet", "build_mobilenet_v2", "build_resnet20"],
    ("flexasr", "hlscnn", "vecunit"): ["build_efficientnet", "build_mobilenet_v2"],
    ("vta",): ["build_resmlp", "build_transformer"],
}


@pytest.mark.parametrize("targets,name", [
    pytest.param(t, n, id=n if t == ("flexasr",) else f"{'+'.join(t)}-{n}")
    for t, names in TARGET_SETS.items() for n in names])
def test_flexible_matching_extracts_same_program(targets, name):
    j_expr, _ = getattr(japps, name)(seed=0)
    t_expr, _ = getattr(tapps, name)(seed=0)
    j_res = jcompile(j_expr, targets=targets, flexible=True)
    t_res = tcompile(t_expr, targets=targets, flexible=True)
    assert repr(t_res.program) == repr(j_res.program)
    assert dict(t_res.accelerator_calls) == dict(j_res.accelerator_calls)
    assert set(k for k, v in t_res.accelerator_calls.items() if v) <= set(targets)
    assert t_res.n_relay_ops == j_res.n_relay_ops


def test_resmlp_offloads_seven_linears_and_two_layernorms():
    expr, _ = tapps.build_resmlp(seed=0, layers=2)
    res = tcompile(expr, targets=("flexasr",), flexible=True)
    ops = [x.op for x in tir.postorder(res.program) if isinstance(x, tir.Call)]
    assert res.accelerator_calls["flexasr"] == 9
    assert ops.count("fasr_linear") == 7 and ops.count("fasr_layernorm") == 2


def test_shape_checker_and_conv_layout():
    """Convolutions keep the reference's NHWC/HWIO layout at the interface."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 7, 7, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    dw = rng.standard_normal((3, 3, 3, 1)).astype(np.float32)
    for mod, dev in ((jir, {}), (tir, {"device": "cpu"})):
        xv, wv, dv = mod.Var("x", x.shape), mod.Var("w", w.shape), mod.Var("d", dw.shape)
        e = mod.call("add", mod.conv2d(xv, wv, (1, 1), (1, 1)),
                     mod.conv2d(mod.call("dw_conv2d", xv, dv, strides=(1, 1), padding=(1, 1)),
                                wv, (1, 1), (1, 1)))
        assert mod.check_expr(e) == (1, 7, 7, 5)
        out = np.asarray(mod.interpret(e, {"x": x, "w": w, "d": dw}, **dev))
        if mod is jir:
            want = out
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
