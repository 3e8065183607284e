"""PyTorch port: VT1-VT3, Table 1, Table 2 and Table 3 against the JAX reference.

Both packages draw the same numpy inputs from the same seeds:

* VT1: each of the four ops gets the reference's verdict, and the
  interpreter outputs agree within 1e-6 relative;
* VT2: ``vt2_cases`` enumerates the same names, shapes and tolerances per
  target and in order, and ``vt2_check`` gives the same verdicts;
* Table 3: the three exhaustive rows give the same ``(ok, count)`` (81,
  256, 256 assignments), the randomized rows the same verdicts at n=20;
* Table 2: the same (accelerator, operation) rows in the same order;
  FlexASR's and VTA's simulated outputs bit-equal to the reference's,
  HLSCNN's within one 2^-8 output step (the port sums exactly in float64,
  the reference in float32), VecUnit's within its intrinsic's tol, and
  every ``avg_err`` within its intrinsic's tol of the reference's;
* VT3: the same check names, each ``(True, 0.0)`` on the CPU;
* Table 1: equal exact and flexible offload counts per application and
  target.
"""
import numpy as np
import pytest

import repro.accel  # noqa: F401
import repro_torch.accel  # noqa: F401
from repro.core import compile as jcompile, ir as jir, validate as jval
from repro.core.ila import TARGETS as JTARGETS
from repro_torch.core import validate as tval
from repro_torch.core.ila import TARGETS as TTARGETS
from repro_torch.launch import table1, table2, table3

N_TABLE2 = 2


@pytest.mark.parametrize("op", list(tval.VT1_CASES))
def test_vt1_verdict_and_outputs_match_reference(op):
    assert tval.vt1_check(op, n=5, device="cpu") == jval.vt1_check(op, n=5)
    gen, _ = jval.VT1_CASES[op]
    rng = np.random.default_rng(0)
    for got, want_np in tval.vt1_outputs(op, n=5, device="cpu"):
        args = gen(rng)
        vs = tuple(jir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
        attrs = {"strides": (1, 1), "padding": (0, 0)} if op == "conv2d" else {}
        want = np.asarray(jir.interpret(jir.call(op, *vs, **attrs),
                                        {f"_{i}": a for i, a in enumerate(args)}))
        assert got.shape == want.shape
        assert jval.frob_rel_err(want, got) <= 1e-6
        assert jval.frob_rel_err(want_np, got) <= 1e-4


@pytest.mark.parametrize("dims", [(8, 32), (16, 64)])
def test_vt2_cases_enumerate_like_reference(dims):
    for name in JTARGETS.names():
        want = JTARGETS.get(name).vt2_cases(*dims)
        got = TTARGETS.get(name).vt2_cases(*dims)
        assert [(c.name, c.var_shapes, c.tol) for c in got] == \
            [(c.name, c.var_shapes, c.tol) for c in want], name
    assert [c.name for c in tval.vt2_cases(*dims)] == [c.name for c in jval.vt2_cases(*dims)]


@pytest.mark.parametrize("case", tval.vt2_cases(8, 32), ids=lambda c: c.name)
def test_vt2_check_verdict_matches_reference(case):
    (jcase,) = [c for c in jval.vt2_cases(8, 32) if c.name == case.name]
    assert tval.vt2_check(case, n=5, device="cpu") == jval.vt2_check(jcase, n=5)


def _jax_maxpool_case(rows, cols):
    T = jir.Var("T", (rows, cols))
    return jval.VT2Case(
        f"maxpool-{rows}x{cols}",
        jir.call("reduce_max", jir.call("windows", T, wh=2, ww=1, sh=2, sw=1), axis=(2, 3)),
        jir.call("fasr_load", jir.call("fasr_maxpool", jir.call("fasr_store", T))),
        {"T": (rows, cols)},
    )


def test_table3_rows_match_reference():
    rows = table3.run(device="cpu", n=20)
    assert len(rows) == 8
    counts = []
    for (r, c, lattice), row in zip(table3.EXHAUSTIVE, rows):
        want = jval.vt2_exhaustive(_jax_maxpool_case(r, c), lattice)
        assert (row["ok"], row["count"]) == want
        counts.append(row["count"])
    assert counts == [81, 256, 256]
    for (r, c), row in zip(table3.RANDOMIZED, rows[3:]):
        assert row["ok"] == jval.vt2_check(_jax_maxpool_case(r, c), n=20)
    assert all(row["ok"] for row in rows)


def test_table3_exhaustive_catches_wrong_mapping():
    from repro_torch.core import ir as tir

    T = tir.Var("T", (2, 2))
    case = tval.VT2Case(
        "wrong",
        tir.call("reduce_max", tir.call("windows", T, wh=2, ww=1, sh=2, sw=1), axis=(2, 3)),
        tir.call("fasr_load", tir.call("fasr_meanpool", tir.call("fasr_store", T))),
        {"T": (2, 2)},
    )
    ok, _ = tval.vt2_exhaustive(case, (-1.0, 0.0, 1.0), device="cpu")
    assert not ok


@pytest.fixture(scope="module")
def table2_outputs():
    port = tval.mapping_outputs(n_inputs=N_TABLE2, device="cpu")
    ref = []
    for t in JTARGETS.all():
        rng = np.random.default_rng(0)
        for opname, case in t.mapping_cases(rng):
            pairs = [tuple(np.asarray(a) for a in case()) for _ in range(N_TABLE2)]
            ref.append((t.name, t.display_name, opname, pairs))
    return port, ref


def test_table2_rows_and_simulated_outputs_match_reference(table2_outputs):
    port, ref = table2_outputs
    assert [(p[1], p[2]) for p in port] == [(r[1], r[2]) for r in ref]
    step = 2.0 ** -8
    for (tname, _, op, pp), (_, _, _, rp) in zip(port, ref):
        tol = TTARGETS.get(tname).intrinsics[
            table2.TABLE2_INTRINSICS[(TTARGETS.get(tname).display_name, op)]].tol
        for (pref, psim), (rref, rsim) in zip(pp, rp):
            assert psim.shape == rsim.shape
            if tname in ("flexasr", "vta"):
                np.testing.assert_array_equal(psim, rsim, err_msg=f"{tname}:{op}")
            elif tname == "hlscnn":
                assert np.abs(psim - rsim).max() <= step, f"{tname}:{op}"
            else:
                assert jval.frob_rel_err(rsim, psim) <= tol, f"{tname}:{op}"
            assert jval.frob_rel_err(rref, pref) <= 1e-5, f"{tname}:{op} reference side"


def test_table2_avg_err_within_tol_of_reference(table2_outputs):
    port, ref = table2_outputs
    got = tval.validate_mappings(n_inputs=N_TABLE2, device="cpu")
    want = []
    for _, display, op, pairs in ref:
        errs = [jval.frob_rel_err(a, b) for a, b in pairs]
        want.append((display, op, float(np.mean(errs))))
    assert [(r.accelerator, r.operation) for r in got] == [(w[0], w[1]) for w in want]
    for r, (display, op, avg) in zip(got, want):
        (t,) = [t for t in TTARGETS.all() if t.display_name == display]
        tol = t.intrinsics[table2.TABLE2_INTRINSICS[(display, op)]].tol
        assert abs(r.avg_err - avg) <= tol, (display, op, r.avg_err, avg)
        assert r.n_inputs == N_TABLE2
    by_op = {(r.accelerator, r.operation): r for r in got}
    assert by_op[("VTA", "GEMM")].avg_err == 0.0
    assert by_op[("FlexASR", "MaxPool")].avg_err == 0.0
    assert 0 < by_op[("FlexASR", "LinearLayer")].avg_err < 0.06


def test_table2_launcher_prints_every_row(capsys):
    rows = table2.main(["--device", "cpu", "--n-inputs", "1"])
    out = capsys.readouterr().out
    assert len(rows) == len(table2.TABLE2_INTRINSICS)
    for acc, op in table2.TABLE2_INTRINSICS:
        assert op in out and acc in out


def test_vt3_results_match_reference_names_and_are_exact():
    got = tval.vt3_results(device="cpu")
    want = jval.vt3_results()
    assert {t: sorted(c) for t, c in got.items()} == {t: sorted(c) for t, c in want.items()}
    for tname, checks in got.items():
        for cname, res in checks.items():
            assert res == (True, 0.0), f"{tname}:{cname} {res}"


def test_table1_offload_counts_match_reference():
    rows = table1.run(device="cpu")
    apps = {r["application"]: r for r in rows}
    from repro.core import apps as japps

    assert list(apps) == list(japps.APPLICATIONS)
    for name, (builder, _) in japps.APPLICATIONS.items():
        expr, _ = builder()
        for t in JTARGETS.all():
            e = jcompile.compile_program(expr, targets=(t.name,), flexible=False)
            f = jcompile.compile_program(expr, targets=(t.name,), flexible=True)
            assert apps[name]["cells"][t.name] == (
                e.accelerator_calls[t.name], f.accelerator_calls[t.name]), (name, t.name)
        assert apps[name]["n_ops"] == jir.count_ops(expr)
