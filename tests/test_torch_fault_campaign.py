"""PyTorch port: the fault library and the campaign engine.

Ports the assertions of ``tests/test_fault_campaign.py`` and holds the
port to the reference where both are deterministic:

* fault coverage: ``fault_instances`` gives the reference's keys per target,
  and every intrinsic is covered by an applicable mutator;
* mutants hold on all five of the port's engines (``fused`` included): the
  identity mutant is bit-exact with the golden target, a bulk-mutating
  wrapper fault and a payload fault give the same faulty output on every
  engine, and a mutant never takes a golden fused runner;
* registry hygiene: a campaign, a crashing mutant, an app tier that raises,
  a swap that raises and a swap that is refused all leave the registries
  bit-identical;
* the acceptance campaign (the reference's fixture, run once): identity
  mutants undetected at every tier, ``flexasr:sat_wrap`` an app-only escape;
* the deterministic tiers (``static``, ``vt2``, ``frag_sim``, ``op_diff``)
  give every mutant of a small campaign the reference's verdicts;
* range-directed sampling (``op_boundary=2``) flips ``sat_wrap`` at the op
  tier.
"""
import numpy as np
import pytest
import torch

import repro.accel  # noqa: F401
import repro_torch.accel  # noqa: F401
from repro.core import campaign as jcampaign, faults as jfaults
from repro.core.ila import TARGETS as JT
from repro_torch.accel.target import register_target, unregister_target
from repro_torch.core import campaign as campaign_mod, faults, ir, validate
from repro_torch.core.codegen import ENGINES, Executor, to_numpy
from repro_torch.core.ila import TARGETS


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The campaigns run thousands of small ops; with several test workers
    on one host, torch's default intra-op thread pool per worker
    oversubscribes the cores and slows them by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _registry_snapshot():
    return (
        [(name, id(t)) for name, t in TARGETS._targets.items()],
        {op: (id(t), id(i)) for op, (t, i) in TARGETS._by_op.items()},
        {op: id(spec) for op, spec in ir._ACCEL_EXT.items()},
        set(ir.ACCEL_OPS),
    )


def _first_sampled(t):
    for intr in t.intrinsics.values():
        if intr.planner is not None and intr.sample is not None:
            return intr
    return None


def _case(intr, seed):
    args, attrs = intr.sample(np.random.default_rng(seed))
    vs = tuple(ir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
    return ir.call(intr.op, *vs, **attrs), {f"_{i}": a for i, a in enumerate(args)}


def _run(expr, env, engine="compiled", opts=None):
    ex = Executor("ila", engine=engine, target_options=opts, device="cpu")
    return to_numpy(ex.run(expr, env))


# ---------------------------------------------------------------------------
# Fault library
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TARGETS.names())
def test_fault_instances_match_reference(name):
    every = list(faults.FAULT_CLASSES) + list(faults.DIAGNOSTIC_FAULT_CLASSES)
    got = faults.fault_instances(TARGETS.get(name), every)
    want = jfaults.fault_instances(JT.get(name), every)
    assert [(i.key, i.mutates_bulk, i.payload is None, i.stream is None, sorted(i.wrappers))
            for i in got] == \
        [(i.key, i.mutates_bulk, i.payload is None, i.stream is None, sorted(i.wrappers))
         for i in want]
    assert [i.key for i in faults.fault_instances(TARGETS.get(name))] == \
        [i.key for i in jfaults.fault_instances(JT.get(name))]


@pytest.mark.parametrize("t", TARGETS.all(), ids=TARGETS.names())
def test_every_intrinsic_covered_by_applicable_mutator(t):
    covered = {}
    for inst in faults.fault_instances(t):
        for op in inst.covers(t):
            covered.setdefault(op, set()).add(inst.fault)
    for op, intr in t.intrinsics.items():
        assert op in covered, f"{t.name}:{op} covered by no fault mutator"
        if intr.planner is not None:
            assert covered[op] - {"identity"}, f"{t.name}:{op} covered only by identity"


# ---------------------------------------------------------------------------
# Mutants hold on every engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", TARGETS.all(), ids=TARGETS.names())
def test_identity_fault_bit_exact_across_engines(t):
    intr = _first_sampled(t)
    expr, env = _case(intr, 0)
    opts = {t.name: intr.options}
    golden = _run(expr, env, opts=opts)
    (inst,) = faults.fault_instances(t, ("identity",))
    with faults.swapped_in(faults.make_mutant(t, inst)):
        for engine in ENGINES:
            np.testing.assert_array_equal(golden, _run(expr, env, engine, opts),
                                          err_msg=f"{t.name} identity != golden ({engine})")


def _holds_on_every_engine(fault):
    t = TARGETS.get("vecunit")
    (inst,) = faults.fault_instances(t, (fault,))
    expr, env = _case(t.intrinsics["veu_mul"], 3 if fault == "addr_swap" else 4)
    golden = _run(expr, env)
    with faults.swapped_in(faults.make_mutant(t, inst)):
        outs = {engine: _run(expr, env, engine) for engine in ENGINES}
    assert validate.frob_rel_err(golden, outs["compiled"]) > 0, f"{fault} changed nothing"
    for engine, got in outs.items():
        np.testing.assert_array_equal(outs["compiled"], got,
                                      err_msg=f"{fault} drifted between engines ({engine})")
    return inst


def test_mutated_write_instruction_holds_on_every_engine():
    inst = _holds_on_every_engine("addr_swap")
    assert inst.mutates_bulk


def test_payload_fault_holds_on_every_engine():
    inst = _holds_on_every_engine("round_floor")
    assert inst.payload is not None and not inst.mutates_bulk


@pytest.mark.parametrize("fault", ["trunc_width", "drop_cfg", "round_floor"])
def test_mutant_never_takes_a_golden_fused_runner(fault):
    """FlexASR's fused linear runner computes FN_START from the golden
    fragment meta; a mutant must run its own (mutated) updates on the fused
    engine, so its fused output equals its compiled output and differs
    from the golden fused output."""
    t = TARGETS.get("flexasr")
    inst = faults.fault_instances(t, (fault,))[0]
    intr = t.intrinsics["fasr_linear"]
    args, _ = intr.sample(np.random.default_rng(1))
    args = [args[0] * 4.0] + list(args[1:])
    vs = tuple(ir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
    expr, env = ir.call("fasr_linear", *vs), {f"_{i}": a for i, a in enumerate(args)}
    golden = _run(expr, env, "fused")
    mutant = faults.make_mutant(t, inst)
    with faults.swapped_in(mutant):
        fused, compiled = _run(expr, env, "fused"), _run(expr, env, "compiled")
    np.testing.assert_array_equal(fused, compiled)
    assert not np.array_equal(fused, golden), f"{inst.key} ran golden semantics"
    assert mutant._fused_fns == [] and not mutant.vt3_checks


def test_host_fault_setup_never_shares_a_device_copy_with_golden():
    """A host-side fault shares the golden ILA and the golden fragment key
    but loads a transformed setup stream. A device >= 1 keeps one copy per
    setup stream, whichever comes first, so the mutant never runs the
    golden setup and the golden target never runs the mutant's (which made
    a later identity mutant fail the app tier in the default campaign)."""
    from repro_torch.accel.target import PlanContext
    from repro_torch.core.codegen import SimDevice

    t = TARGETS.get("flexasr")
    inst = faults.fault_instances(t, ("decode_alias",))[0]
    assert inst.host_xform() is not None and not inst.wrappers
    intr = t.intrinsics["fasr_linear"]
    args, _ = intr.sample(np.random.default_rng(2))
    vs = tuple(ir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
    x = ir.call("fasr_linear", *vs)
    ctx = PlanContext(record=lambda *a, **k: None)
    (gjob,), _ = intr.planner(ctx, x, list(args))
    mutant = faults.make_mutant(t, inst)
    (mjob,), _ = mutant.intrinsics["fasr_linear"].planner(ctx, x, list(args))
    g, m = gjob.frag, mjob.frag
    assert g.key == m.key and g.ila is m.ila and not np.array_equal(g.setup.ops, m.setup.ops)
    for first, second in ((g, m), (m, g)):
        dev = SimDevice(t, 1)
        a, b = dev.resolve(first), dev.resolve(second)
        assert a is not b
        assert a.setup is first.setup and b.setup is second.setup
        assert dev.resolve(first) is a and not dev.is_cold(second)


# ---------------------------------------------------------------------------
# Registry hygiene
# ---------------------------------------------------------------------------


def test_campaign_leaves_registry_bit_identical():
    before = _registry_snapshot()
    result = campaign_mod.run_campaign(
        targets=("vecunit", "hlscnn"), faults=("identity", "drop_cfg", "trunc_width"),
        apps=(), engine="compiled", devices_per_target=1, op_samples=1, vt2_n=2,
        device="cpu")
    assert len(result.reports) == 6
    assert _registry_snapshot() == before


def test_serial_crash_isolated_and_registry_clean():
    before = _registry_snapshot()
    result = campaign_mod.run_campaign(
        targets=("vecunit",), faults=("identity", "drop_cfg", "crash_inject"),
        apps=(), engine="compiled", devices_per_target=1, op_samples=1, vt2_n=2,
        stat_calib_seeds=0, device="cpu")
    assert _registry_snapshot() == before
    by_fault = {r.fault: r for r in result.reports}
    crash = by_fault["crash_inject"]
    assert crash.outcome == "crash" and crash.detected_at == "crash"
    assert "crash_inject" in crash.error and "vt2" in crash.tiers
    assert by_fault["identity"].outcome == "ok" and by_fault["identity"].detected_at is None
    assert by_fault["drop_cfg"].outcome == "ok" and by_fault["drop_cfg"].detected_at is not None


def test_mutant_raising_inside_app_tier_leaves_registry_clean(monkeypatch):
    golden = TARGETS.get("vecunit")

    def fake_prepare(name, n_eval, train_steps, seed, device):
        def per_example(ex, idx):
            if TARGETS.get("vecunit") is not golden:
                raise RuntimeError("app evaluation blew up on the mutant")
            n = len(list(idx))
            return campaign_mod.PerExample(np.zeros((n, 4)), np.zeros(n), 1.0)

        return campaign_mod._App(name, "acc", None, {"vecunit": 1}, pool=128,
                                 per_example=per_example)

    monkeypatch.setattr(campaign_mod, "_prepare_app", fake_prepare)
    before = _registry_snapshot()
    result = campaign_mod.run_campaign(
        targets=("vecunit",), faults=("identity", "drop_cfg"), apps=("resmlp",),
        engine="compiled", devices_per_target=1, op_samples=1, vt2_n=2,
        stat_calib_seeds=0, ladder="full", device="cpu")
    assert _registry_snapshot() == before
    for r in result.reports:
        assert r.outcome == "crash" and "blew up" in r.error
        assert "op_diff" in r.tiers and "app" not in r.tiers


def test_swap_restores_exact_objects_even_on_error():
    t = TARGETS.get("vecunit")
    before = _registry_snapshot()
    (inst,) = faults.fault_instances(t, ("identity",))
    with pytest.raises(RuntimeError):
        with faults.swapped_in(faults.make_mutant(t, inst)):
            assert TARGETS.get("vecunit") is not t
            raise RuntimeError("boom")
    assert _registry_snapshot() == before


def test_failed_swap_in_leaves_registries_untouched():
    t = TARGETS.get("vta")
    (inst,) = faults.fault_instances(t, ("identity",))
    mutant = faults.make_mutant(t, inst)
    removed_specs = unregister_target(t)
    try:
        before = _registry_snapshot()
        with pytest.raises(KeyError):
            with faults.swapped_in(mutant):
                pass  # pragma: no cover
        assert _registry_snapshot() == before
    finally:
        # vta is the last-registered bundled target in the port, so
        # re-registering restores the original order
        register_target(t)
        for op, spec in removed_specs.items():
            ir.restore_accel_op(op, spec)
    assert TARGETS.names() == ["flexasr", "hlscnn", "vecunit", "vta"]


@pytest.mark.parametrize("t", TARGETS.all(), ids=TARGETS.names())
def test_vt2_cases_carry_declared_tolerance(t):
    for case in t.vt2_cases(8, 32):
        assert case.tol == t.vt2_tol
        assert validate.vt2_check(case, n=3, device="cpu")


# ---------------------------------------------------------------------------
# The acceptance campaign
# ---------------------------------------------------------------------------

ACCEPTANCE = dict(
    targets=("flexasr", "hlscnn", "vecunit"),
    faults=("identity", "trunc_width", "sat_wrap", "round_floor", "drop_cfg", "stale_state"),
    apps=("resmlp",), engine="pipelined", devices_per_target=2, ladder="escalate",
    n_eval=24, train_steps=60, op_samples=1, vt2_n=2,
)


@pytest.fixture(scope="module")
def acceptance_campaign():
    before = _registry_snapshot()
    result = campaign_mod.run_campaign(device="cpu", **ACCEPTANCE)
    assert _registry_snapshot() == before
    return result


def test_campaign_runs_at_scale_pipelined_multidevice(acceptance_campaign):
    r = acceptance_campaign
    assert r.config["engine"] == "pipelined" and r.config["devices_per_target"] == 2
    assert r.config["device"] == "cpu" and len(r.config["targets"]) == 3
    assert len({m.fault for m in r.reports} - {"identity"}) >= 4
    assert r.mutants_per_sec > 0
    assert [m for m in r.reports if m.detected_at in ("vt2", "frag_sim", "op_diff")]


def test_identity_mutants_show_zero_detections(acceptance_campaign):
    ids = [m for m in acceptance_campaign.reports if m.fault == "identity"]
    assert len(ids) == 3
    for m in ids:
        assert m.detected_at is None
        assert all(t.detected in (False, None) for t in m.tiers.values())
    cal = acceptance_campaign.stat_calibration
    assert cal["null_shifts"] == {"flexasr:resmlp": [0.0, 0.0]}


def test_sat_wrap_escapes_fragments_but_app_level_catches_it(acceptance_campaign):
    escapees = {m.key: m for m in acceptance_campaign.reports if m.app_only}
    assert "flexasr:sat_wrap@write_v" in escapees, \
        campaign_mod.format_matrix(acceptance_campaign)
    for m in escapees.values():
        assert m.escaped_fragment_checks and m.tiers["app"].detected


def test_acceptance_fault_set_matches_reference(acceptance_campaign):
    want = [f"{t}:{i.fault}@{i.instruction}" for t in ACCEPTANCE["targets"]
            for i in jfaults.fault_instances(JT.get(t), ACCEPTANCE["faults"])]
    assert [m.key for m in acceptance_campaign.reports] == want


# ---------------------------------------------------------------------------
# Deterministic tiers: the reference's verdicts, mutant by mutant
# ---------------------------------------------------------------------------

SMALL = dict(targets=("flexasr", "vta"), faults=("identity", "trunc_width", "sat_wrap",
                                                 "drop_cfg"),
             apps=(), engine="compiled", devices_per_target=1, op_samples=1, vt2_n=2,
             seed=0, stat_calib_seeds=0)


def test_deterministic_tier_verdicts_match_reference():
    got = campaign_mod.run_campaign(device="cpu", **SMALL)
    want = jcampaign.run_campaign(**SMALL)
    assert [m.key for m in got.reports] == [m.key for m in want.reports]
    for g, w in zip(got.reports, want.reports):
        for tier in ("static", "vt2", "frag_sim", "op_diff"):
            assert g.tiers[tier].detected == w.tiers[tier].detected, (g.key, tier)
            assert g.tiers[tier].threshold == w.tiers[tier].threshold, (g.key, tier)
        assert g.detected_at == w.detected_at, g.key


def test_boundary_sampling_makes_sat_wrap_op_tier_detectable():
    base = dict(targets=("flexasr",), faults=("sat_wrap",), apps=(), engine="compiled",
                devices_per_target=1, op_samples=1, vt2_n=2, stat_calib_seeds=0,
                ladder="full", device="cpu")
    miss = campaign_mod.run_campaign(**base)
    hit = campaign_mod.run_campaign(op_boundary=2, **base)
    assert miss.config["op_boundary"] == 0 and hit.config["op_boundary"] == 2
    assert miss.reports and len(miss.reports) == len(hit.reports)
    assert all(m.tiers["op_diff"].detected is False for m in miss.reports)
    assert all(m.tiers["op_diff"].detected is True for m in hit.reports)
