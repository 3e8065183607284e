"""PyTorch port: the ResMLP-on-FlexASR slice end to end against the JAX reference.

ResMLP parameters trained by the reference's ``cosim.train_app`` (30 steps)
are carried across with ``params_to_torch`` and the flexibly matched
program runs through both packages' Executors on 8 points. Per point, the
port's logits are within 0.08·max|ideal| of the reference's (fasr_linear's
declared tolerance) — they are in fact expected bit-identical — and the
predicted classes are equal.
"""
import numpy as np
import pytest

from repro.core import apps as japps, cosim as jcosim
from repro.core.codegen import Executor as JExecutor
from repro.core.compile import compile_program as jcompile
from repro_torch.core import apps as tapps, cosim as tcosim
from repro_torch.core.codegen import Executor as TExecutor, to_numpy
from repro_torch.core.compile import compile_program as tcompile

N = 8
TOL = 0.08


def _builder(mod):
    return lambda seed=0: mod.build_resmlp(seed=seed, layers=2)


@pytest.fixture(scope="module")
def slice_setup():
    expr, params = _builder(japps)()
    X, y = jcosim.make_teacher_task(_builder(japps), (16, 64), n=512)
    trained = jcosim.train_app(expr, params, X, y, steps=30, lr=3e-3)
    j_prog = jcompile(expr, targets=("flexasr",), flexible=True).program
    t_expr, _ = _builder(tapps)()
    t_prog = tcompile(t_expr, targets=("flexasr",), flexible=True).program
    return X, y, trained, j_prog, t_prog


def _jax_executor(kind):
    if kind == "fused":
        return JExecutor("ila", engine="fused")
    return JExecutor(kind)


def _port_executor(kind):
    if kind == "fused":
        return TExecutor("ila", engine="fused", device="cpu")
    return TExecutor(kind, device="cpu")


def _logits(run):
    return np.stack([np.asarray(o).reshape(-1) for o in run])


@pytest.mark.parametrize("kind", ["ideal", "ila", "kernel", "fused"])
def test_slice_matches_reference_per_point(kind, slice_setup):
    X, y, trained, j_prog, t_prog = slice_setup
    t_params = tcosim.params_to_torch(trained, device="cpu")
    ideal = _logits(jcosim.eval_outputs(j_prog, trained, lambda i: X[i], range(N),
                                        JExecutor("ideal")))
    want = ideal if kind == "ideal" else _logits(jcosim.eval_outputs(
        j_prog, trained, lambda i: X[i], range(N), _jax_executor(kind)))
    got = _logits(tcosim.eval_outputs(t_prog, t_params, lambda i: X[i], range(N),
                                      _port_executor(kind)))
    assert got.shape == want.shape == (N, 10)
    scale = np.abs(ideal).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= TOL * scale)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    acc_j, _ = jcosim.eval_classification(j_prog, trained, X, y, _jax_executor(kind), N)
    acc_t, _ = tcosim.eval_classification(t_prog, t_params, X, y, _port_executor(kind), N)
    assert acc_t == acc_j


def test_ila_columns_stay_within_tolerance_of_ideal(slice_setup):
    """The accelerator columns of the port deviate from its own ideal logits
    by less than fasr_linear's tolerance, per point."""
    X, _, trained, _, t_prog = slice_setup
    outs = {k: _logits(tcosim.eval_outputs(t_prog, trained, lambda i: X[i], range(N),
                                           _port_executor(k)))
            for k in ("ideal", "ila", "kernel", "fused")}
    scale = np.abs(outs["ideal"]).max(axis=1)
    for k in ("ila", "kernel", "fused"):
        dev = np.abs(outs[k] - outs["ideal"]).max(axis=1) / scale
        assert dev.max() <= TOL, (k, dev)
    np.testing.assert_array_equal(outs["ila"], outs["kernel"])
    np.testing.assert_array_equal(outs["ila"], outs["fused"])


def test_params_to_torch_keeps_values(slice_setup):
    _, _, trained, _, _ = slice_setup
    t = tcosim.params_to_torch(trained, device="cpu")
    assert set(t) == set(trained)
    for k, v in trained.items():
        assert str(t[k].dtype) == "torch.float32" and t[k].device.type == "cpu"
        np.testing.assert_array_equal(to_numpy(t[k]), v)


def test_invocation_stats_match_reference(slice_setup):
    """Same planners, same streams: the Executors count the same
    invocations and interface commands, with the same per-op errors."""
    X, _, trained, j_prog, t_prog = slice_setup
    jex, tex = JExecutor("ila"), TExecutor("ila", device="cpu")
    jcosim.eval_outputs(j_prog, trained, lambda i: X[i], range(4), jex)
    tcosim.eval_outputs(t_prog, trained, lambda i: X[i], range(4), tex)
    js, ts = jex.stats_summary()["flexasr"], tex.stats_summary()["flexasr"]
    assert ts["invocations"] == js["invocations"] == 4 * 9
    assert ts["commands"] == js["commands"]
    assert ts["est_cycles"] == js["est_cycles"]
    assert [s.op for s in tex.stats] == [s.op for s in jex.stats]
    np.testing.assert_allclose([s.rel_err for s in tex.stats], [s.rel_err for s in jex.stats],
                               rtol=1e-4, atol=1e-7)
