"""PyTorch port: the Table-4 conv rows against the JAX reference.

ResNet-20 and MobileNet-V2 on FlexASR + HLSCNN (here) and EfficientNet on
FlexASR + HLSCNN + VecUnit and ResMLP on VTA (``test_torch_table4_targets.py``,
through the helpers below): parameters trained by the reference's
``cosim.train_app`` (30 steps) carry across, and the flexibly matched
programs run through both packages' Executors on 8 points, column by column
(ideal, original = 8-bit HLSCNN weights, updated = 16-bit, and the fused
engine at both widths; ideal/ila/kernel on VTA). Per point, the port's
logits are within 0.05·max|ideal| of the reference's (``hlscnn_conv2d``'s
declared tolerance, the loosest intrinsic on these paths), the predicted
classes and the accuracies are equal, and within the port each fused column
is bit-identical to its ila column (and VTA's kernel column to its ila
column). ``repro_torch.launch.table4`` drives the port's side.
"""
import numpy as np
import pytest

from repro.core import apps as japps, cosim as jcosim
from repro.core.codegen import Executor as JExecutor
from repro.core.compile import compile_program as jcompile
from repro_torch.launch import table4

N = 8
TOL = 0.05
STEPS = 30

#: app -> (reference builder, columns)
ROWS = {
    "resnet20": (japps.build_resnet20, ("ideal", "ila-8", "ila-16", "fused-8", "fused-16")),
    "mobilenet_v2": (japps.build_mobilenet_v2,
                     ("ideal", "ila-8", "ila-16", "fused-8", "fused-16")),
    "efficientnet": (japps.build_efficientnet, ("ideal", "ila-16", "fused-16")),
    "resmlp_vta": (lambda seed=0: japps.build_resmlp(seed=seed, layers=2),
                   ("ideal", "ila", "kernel")),
}
#: fused / kernel column -> the ila column it must equal bit for bit
SAME_AS = {"fused-8": "ila-8", "fused-16": "ila-16", "kernel": "ila"}


def _jax_executor(column):
    mode, engine, bits = table4.COLUMNS[column]
    return JExecutor(mode, engine=engine, target_options={"hlscnn": {"wgt_bits": bits}})


def _jax_logits(prog, params, X, ex):
    outs = jcosim.eval_outputs(prog, params, lambda i: X[i], range(N), ex)
    return np.stack([np.asarray(o).reshape(-1) for o in outs])


_CACHE = {}


def _row(key):
    """Reference-trained parameters, both programs and every column's
    logits of both packages (computed once per app)."""
    if key not in _CACHE:
        jbuild, columns = ROWS[key]
        app = table4.APPS[key]
        expr, params = jbuild()
        X, y = jcosim.make_teacher_task(jbuild, app.input_shape, n=512)
        trained = jcosim.train_app(expr, params, X, y, steps=STEPS, lr=table4.LR)
        j_prog = jcompile(expr, targets=app.targets, flexible=True).program
        prep = table4.prepare(app, "cpu", params=trained)
        np.testing.assert_array_equal(prep.X, X)
        assert repr(prep.program) == repr(j_prog)
        want = {c: _jax_logits(j_prog, trained, X, _jax_executor(c)) for c in columns}
        got = {c: table4.logits(prep, table4.executor(c, "cpu"), N) for c in columns}
        _CACHE[key] = (y, prep, want, got)
    return _CACHE[key]


def column_params(keys):
    return [pytest.param(k, c, id=f"{k}-{c}") for k in keys for c in ROWS[k][1]]


def check_column(key, column):
    y, prep, want, got = _row(key)
    scale = np.abs(want["ideal"]).max(axis=1, keepdims=True)
    assert got[column].shape == want[column].shape == (N, 10)
    dev = np.abs(got[column] - want[column]) / scale
    print(f"{key}:{column} worst {dev.max():.2e} x max|ideal|")
    assert np.all(dev <= TOL)
    np.testing.assert_array_equal(got[column].argmax(1), want[column].argmax(1))
    acc_t = float(np.mean(got[column].argmax(1) == y[:N]))
    acc_j = float(np.mean(want[column].argmax(1) == y[:N]))
    assert acc_t == acc_j


def check_bit_identical(key):
    _, prep, _, got = _row(key)
    pairs = [(c, SAME_AS[c]) for c in got if c in SAME_AS]
    assert pairs
    for fast, ila in pairs:
        np.testing.assert_array_equal(got[fast], got[ila], err_msg=f"{key}:{fast}")


CONV_ROWS = ("resnet20", "mobilenet_v2")


@pytest.mark.parametrize("key,column", column_params(CONV_ROWS))
def test_column_matches_reference_per_point(key, column):
    check_column(key, column)


@pytest.mark.parametrize("key", CONV_ROWS)
def test_fused_columns_bit_identical_to_ila(key):
    check_bit_identical(key)


def test_offloads_and_table4_row_shape():
    for key in CONV_ROWS:
        assert _row(key)[1].offloads == {"flexasr": 1, "hlscnn": 7, "vecunit": 0, "vta": 0}
    row = table4.acc_row(table4.APPS["resnet20"], "cpu", n_eval=4, steps=2)
    assert set(row) >= {"reference", "original", "updated", "sim_s_per_point", "offloads",
                        "per_op_err", "setup_s"}
    assert row["updated"] is not None and "hlscnn_conv2d" in row["per_op_err"]
