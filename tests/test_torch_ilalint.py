"""PyTorch port: the static ILA verifier against the JAX reference.

The port derives instruction effects from a labeled trace of each update
(``repro_torch.core.ilalint``), where the reference reads them off a jaxpr.
These tests hold the port to the reference, not to "lints clean": on this
tree the reference's FlexASR lint reports five ``warn`` hazards on
``fn_start`` (``tests/test_ilalint.py::test_registered_target_lints_clean
[flexasr]`` fails on them), and the port must report the same five.

* effects: ``reads``, ``writes``, ``scalar_writes``, ``buffer_writes``,
  ``reads_data`` and ``reads_addr`` equal the reference's for every
  instruction of all four targets;
* ``lint_target`` findings equal as ``(severity, pass, target, subject)``
  (and message) per target, with zero simulated commands;
* ``boundary_inputs`` equal; ``analyze_mutation`` verdicts equal for every
  fault instance of the library;
* ``launch.lint.main`` gives the reference's exit code and finding counts;
* a small torch ILA shows each pass firing, as the reference's toy target
  does.
"""
import json

import numpy as np
import pytest
import torch

import repro.accel  # noqa: F401
import repro_torch.accel  # noqa: F401
from repro.core import faults as jfaults, ilalint as jlint
from repro.core.ila import TARGETS as JT
from repro.launch import lint as jlaunch
from repro_torch.accel.target import AcceleratorTarget
from repro_torch.core import faults as tfaults, ilalint as tlint
from repro_torch.core.ila import ILA, TARGETS as TT, PackedStream, payload, register, write_block
from repro_torch.launch import lint as tlaunch

NAMES = ["flexasr", "hlscnn", "vecunit", "vta"]
FIELDS = ("reads", "writes", "scalar_writes", "buffer_writes", "reads_data", "reads_addr")


def _key(f):
    return (f.severity, f.pass_name, f.target, f.subject, f.message)


@pytest.mark.parametrize("name", NAMES)
def test_effects_equal_reference_field_by_field(name):
    want = jlint.effects(JT.get(name).ila)
    got = tlint.effects(TT.get(name).ila)
    assert [(e.name, e.opcode) for e in got] == [(e.name, e.opcode) for e in want]
    for g, w in zip(got, want):
        for f in FIELDS:
            assert getattr(g, f) == getattr(w, f), (name, g.name, f)


@pytest.mark.parametrize("name", NAMES)
def test_lint_findings_equal_reference(name):
    t = TT.get(name)
    before = (t.ila.n_traces_single, t.ila.n_traces_batch)
    got = tlint.lint_target(t, seed=0, samples=1)
    assert (t.ila.n_traces_single, t.ila.n_traces_batch) == before, \
        "static lint must not simulate anything"
    want = jlint.lint_target(JT.get(name), seed=0, samples=1)
    assert [_key(f) for f in got] == [_key(f) for f in want]


def test_flexasr_reports_the_five_fn_start_hazards():
    warns = [f for f in tlint.lint_target(TT.get("flexasr")) if f.severity == "warn"]
    assert sorted(f.subject for f in warns) == [
        "fn_start/act_mode", "fn_start/is_bias", "fn_start/pe_b", "fn_start/pe_w",
        "fn_start/pe_wh"]


@pytest.mark.parametrize("name", NAMES)
def test_probe_streams_equal_reference(name):
    got = tlint.probe_streams(TT.get(name), seed=0, samples=2)
    want = jlint.probe_streams(JT.get(name), seed=0, samples=2)
    assert [op for op, _ in got] == [op for op, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.ops, np.asarray(w.ops))
        np.testing.assert_array_equal(g.addrs, np.asarray(w.addrs))
        np.testing.assert_array_equal(g.data, np.asarray(w.data))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 3])
def test_boundary_inputs_equal_reference(name, seed):
    np.testing.assert_array_equal(
        tlint.boundary_inputs(TT.get(name), n=64, seed=seed),
        jlint.boundary_inputs(JT.get(name), n=64, seed=seed))


@pytest.mark.parametrize("name", NAMES)
def test_analyze_mutation_verdicts_equal_reference(name):
    every = list(tfaults.FAULT_CLASSES)
    t, j = TT.get(name), JT.get(name)
    tp, jp = tlint.probe_streams(t), jlint.probe_streams(j)
    got = tfaults.fault_instances(t, every)
    want = jfaults.fault_instances(j, every)
    assert [i.key for i in got] == [i.key for i in want]
    for gi, wi in zip(got, want):
        gx, wx = gi.host_xform(), wi.host_xform()
        assert (gx is None) == (wx is None), gi.key
        if gx is None:
            continue
        assert tlint.analyze_mutation(t, tp, gx) == jlint.analyze_mutation(j, jp, wx), gi.key


def test_lint_launcher_matches_reference(tmp_path, capsys):
    for fail_on in ("warn", "error"):
        tj, jj = tmp_path / f"t_{fail_on}.json", tmp_path / f"j_{fail_on}.json"
        rc_t = tlaunch.main(["--json", str(tj), "--fail-on", fail_on, "--device", "cpu"])
        rc_j = jlaunch.main(["--json", str(jj), "--fail-on", fail_on])
        assert rc_t == rc_j
        got, want = json.loads(tj.read_text()), json.loads(jj.read_text())
        assert (got["findings"], got["failing"]) == (want["findings"], want["failing"])
        assert got["targets"] == want["targets"]
    assert tlaunch.main(["--targets", "vta", "--device", "cpu"]) == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# a small torch ILA exercising every effect class (the reference's toy target)
# ---------------------------------------------------------------------------


def _toy_ila(overlap: bool = False) -> ILA:
    ila = ILA("toy", vwidth=4)
    ila.state("buf", lambda d: torch.zeros((8, 4), device=d))
    ila.state("acc", lambda d: torch.zeros((8, 4), device=d))
    ila.state("gain", lambda d: 0.0)

    @ila.instruction("wr_buf", 0x10)
    def wr_buf(st, addr, data):
        row = payload(data, st["buf"].device).unsqueeze(-2)
        st["buf"] = write_block(st["buf"], row, (addr, 0))
        return st

    @ila.instruction("cfg_gain", 0x20)
    def cfg_gain(st, addr, data):
        st["gain"] = register(data, 0)
        return st

    @ila.instruction("go", 0x30 if not overlap else 0x20)
    def go(st, addr, data):
        g = st["gain"]
        g = g.reshape(-1, 1, 1) if isinstance(g, torch.Tensor) else g
        st["acc"] = st["acc"] + st["buf"] * g
        return st

    return ila


def _toy_target(overlap: bool = False, **lint_kw) -> AcceleratorTarget:
    t = AcceleratorTarget("toy", _toy_ila(overlap), capabilities={"numerics": "adaptivfloat8"})
    if lint_kw:
        t.declare_lint(**lint_kw)
    return t


def _stream(*rows) -> PackedStream:
    ops = np.array([r[0] for r in rows], np.int32)
    addrs = np.array([r[1] for r in rows], np.int32)
    data = np.zeros((len(rows), 4), np.float32)
    for i, r in enumerate(rows):
        data[i, 0] = r[2]
    return PackedStream(ops, addrs, data)


GOOD = _stream((0x20, 0, 2.0), (0x10, 0, 1.0), (0x30, 0, 0.0))
NO_CFG = _stream((0x10, 0, 1.0), (0x30, 0, 0.0))


def test_toy_effects_read_write_sets():
    by_name = {e.name: e for e in tlint.effects(_toy_ila())}
    wr = by_name["wr_buf"]
    assert wr.buffer_writes == {"buf"} and not wr.scalar_writes
    assert wr.reads == {"buf"} and wr.reads_data and wr.reads_addr and wr.is_bulk_writer
    cfg = by_name["cfg_gain"]
    assert cfg.scalar_writes == {"gain"} and cfg.is_config_writer
    assert cfg.reads_data and not cfg.buffer_writes and not cfg.reads
    go = by_name["go"]
    assert go.reads == {"buf", "gain", "acc"}
    assert go.writes == {"acc"} and not go.reads_data and not go.reads_addr
    nop = by_name["nop"]
    assert not nop.reads and not nop.writes


def test_toy_effects_cached_per_ila():
    ila = _toy_ila()
    assert tlint.effects(ila) is tlint.effects(ila)


def test_decode_pass_flags_overlap_nop_claim_and_undecodable():
    errors = [f for f in tlint.decode_pass(_toy_target(overlap=True), [])
              if f.severity == "error"]
    assert errors and "shadow" in errors[0].message
    ila = _toy_ila()
    ila.instruction("evil", 0x0)(lambda st, addr, data: st)
    msgs = [f.message for f in tlint.decode_pass(AcceleratorTarget("toy", ila), [])]
    assert any("reserved NOP" in m for m in msgs)
    bad = [f for f in tlint.decode_pass(_toy_target(), [("toy_op", _stream((0x77, 0, 0.0)))])
           if f.severity == "error"]
    assert bad and "0x77" in bad[0].message
    assert not [f for f in tlint.decode_pass(_toy_target(), [("toy_op", GOOD)])
                if f.severity != "note"]


def test_hazard_pass_warns_exempts_and_notes():
    warns = [f for f in tlint.hazard_pass(_toy_target(), [("toy_op", NO_CFG)])
             if f.severity == "warn"]
    assert [w.subject for w in warns] == ["go/gain"]
    assert not [f for f in tlint.hazard_pass(_toy_target(reset_valid=("gain",)),
                                             [("toy_op", NO_CFG)]) if f.severity == "warn"]
    fs = tlint.hazard_pass(_toy_target(carried_state=("gain",)), [("toy_op", NO_CFG)])
    assert [f for f in fs if "carried" in f.message][0].subject == "gain"
    notes = [f for f in tlint.hazard_pass(_toy_target(), [("toy_op", GOOD)])
             if "cmd_reorder" in f.message]
    assert notes and "gain" in notes[0].subject


def test_range_pass_and_intervals():
    (note,) = tlint.range_pass(_toy_target(input_range=(-10.0, 10.0)))
    assert "wrap reachable" in note.message and "4.5" in note.message
    assert tlint.range_pass(_toy_target(input_range=(-2.0, 2.0))) == []
    a, b = tlint.Interval(-2.0, 3.0), tlint.Interval(-1.0, 4.0)
    assert (a + b) == tlint.Interval(-3.0, 7.0)
    assert (a * b) == tlint.Interval(-8.0, 12.0)
    assert a.accumulate(b, 10).hi == 120.0 and a.clip(1.0) == tlint.Interval(-1.0, 1.0)


def test_analyze_mutation_classifies_toy_transforms():
    t, probes = _toy_target(), [("toy_op", GOOD)]

    def swap(ops, addrs, data):
        return np.where(ops == 0x10, 0x20, np.where(ops == 0x20, 0x10, ops)), addrs, data

    def cfg(ops, addrs, data):
        return ops, addrs, np.where((ops == 0x20)[:, None], data + 1.0, data)

    def bulk(ops, addrs, data):
        return ops, addrs, np.where((ops == 0x10)[:, None], data * 2.0, data)

    det, score, detail = tlint.analyze_mutation(t, probes, swap)
    assert det and score == 1.0 and "opcode stream rewritten" in detail
    det, _, detail = tlint.analyze_mutation(t, probes, cfg)
    assert det and "order-sensitive" in detail and "gain" in detail
    no_trigger = [("toy_op", _stream((0x20, 0, 2.0), (0x10, 0, 1.0)))]
    assert not tlint.analyze_mutation(t, no_trigger, cfg)[0]
    det, score, detail = tlint.analyze_mutation(t, probes, bulk)
    assert not det and score == 0.0 and "deferred to simulation tiers" in detail
    det, _, detail = tlint.analyze_mutation(t, probes, lambda o, a, d: (o, a, d))
    assert not det and "identical" in detail


def test_chip_smoke_lint_expectation_equals_the_cpu_lint():
    """chip_smoke.py gates the card's lint on LINT_EXPECTED; it must be what
    the port reports here (and so, by the tests above, the reference)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = {(f.severity, f.pass_name, f.target, f.subject)
           for fs in tlint.lint_registry().values() for f in fs}
    assert got == smoke.LINT_EXPECTED
