"""PyTorch port: the calibrated statistical tier (``campaign.paired_stats``
et al.), the counterpart of ``tests/test_campaign_stat.py``.

* ``paired_stats`` and the seeded subset sampler equal the reference's on
  the same inputs;
* the statistic's properties: exactly zero for identical outputs, scales
  with systematic bias, ``bias_t`` separates systematic from symmetric;
* the device is part of the config fingerprint (a CPU checkpoint never
  resumes on the card); runner knobs are not;
* the false-positive budget on identity mutants holds for every target
  over five seeds — the identity null shift is exactly 0.0;
* the acceptance result: ``round_floor`` on FlexASR is caught by the
  statistical tier (and escapes every fragment tier), with the identity
  mutant undetected and zero calibration false positives over 5 seeds.
"""
import numpy as np
import pytest
import torch

import repro_torch.accel  # noqa: F401
from repro.core import campaign as jcampaign
from repro_torch.core import campaign as campaign_mod, faults, ir
from repro_torch.core.codegen import Executor, to_numpy
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


def _pe(outputs, losses=None, metric=0.0):
    outputs = np.asarray(outputs, np.float64)
    if losses is None:
        losses = np.zeros(len(outputs))
    return campaign_mod.PerExample(outputs, np.asarray(losses, np.float64), metric)


def test_paired_stats_equal_reference():
    rng = np.random.default_rng(5)
    o, loss = rng.standard_normal((16, 10)), rng.standard_normal(16)
    m, mloss = o * 1.01 + 0.001, loss + rng.standard_normal(16) * 0.1
    got = campaign_mod.paired_stats(_pe(o, loss), _pe(m, mloss))
    want = jcampaign.paired_stats(jcampaign.PerExample(o, loss, 0.0),
                                  jcampaign.PerExample(m, mloss, 0.0))
    assert got == want


def test_paired_shift_properties():
    rng = np.random.default_rng(0)
    o, loss = rng.standard_normal((16, 10)), rng.standard_normal(16)
    s = campaign_mod.paired_stats(_pe(o, loss), _pe(o.copy(), loss.copy()))
    assert s == {"shift": 0.0, "bias_t": 0.0, "mean_loss_delta": 0.0}
    o = rng.standard_normal((32, 8))
    assert campaign_mod.paired_stats(_pe(o), _pe(o * 1.01))["shift"] == \
        pytest.approx(0.01, rel=1e-9)
    o, gold = rng.standard_normal((64, 4)), rng.standard_normal(64)
    sym = rng.standard_normal(64) * 0.1
    sym -= sym.mean()
    systematic = campaign_mod.paired_stats(_pe(o, gold), _pe(o * 1.001, gold + 0.05))
    noisy = campaign_mod.paired_stats(_pe(o, gold), _pe(o * 1.001, gold + sym))
    assert systematic["bias_t"] > 100 * noisy["bias_t"]


@pytest.mark.parametrize("tag,seed", [("eval:resmlp", 0), ("calib:resmlp:1", 0), ("x", 3)])
def test_subset_equals_reference(tag, seed):
    assert campaign_mod._subset(128, 24, tag, seed) == jcampaign._subset(128, 24, tag, seed)
    assert campaign_mod._subset(8, 24, tag, seed) == tuple(range(8))


def test_device_and_seed_are_in_the_fingerprint():
    base = campaign_mod._resolve_config(targets=("vecunit",), seed=0, device="cpu")
    assert base["device"] == "cpu"
    other = campaign_mod._resolve_config(targets=("vecunit",), seed=1, device="cpu")
    assert campaign_mod.config_fingerprint(base) != campaign_mod.config_fingerprint(other)
    card = dict(base, device="cuda:0")
    assert campaign_mod.config_fingerprint(base) != campaign_mod.config_fingerprint(card)
    assert campaign_mod.config_fingerprint(dict(base, workers=7)) == \
        campaign_mod.config_fingerprint(base)


@pytest.mark.parametrize("t", TARGETS.all(), ids=TARGETS.names())
def test_identity_fp_budget_holds_over_five_seeds(t):
    intr = next(i for i in t.intrinsics.values() if i.planner is not None and i.sample)
    opts = {t.name: intr.options}
    cases = []
    for seed in range(5):
        args, attrs = intr.sample(np.random.default_rng(seed))
        vs = tuple(ir.Var(f"_{i}", a.shape) for i, a in enumerate(args))
        expr = ir.call(intr.op, *vs, **attrs)
        env = {f"_{i}": a for i, a in enumerate(args)}
        gold = to_numpy(Executor("ila", target_options=opts, device="cpu").run(expr, env))
        cases.append((expr, env, gold.astype(np.float64)))
    (inst,) = faults.fault_instances(t, ("identity",))
    nulls = []
    with faults.swapped_in(faults.make_mutant(t, inst)):
        ex = Executor("ila", target_options=opts, device="cpu")
        for expr, env, gold in cases:
            got = to_numpy(ex.run(expr, env)).astype(np.float64)
            nulls.append(campaign_mod.paired_stats(
                _pe(gold.reshape(1, -1)), _pe(got.reshape(1, -1)))["shift"])
    assert nulls == [0.0] * 5, f"{t.name}: identity nulls nonzero: {nulls}"
    assert max(1e-3, 2.0 * max(nulls)) == 1e-3


@pytest.fixture(scope="module")
def stat_campaign():
    return campaign_mod.run_campaign(
        targets=("flexasr",), faults=("identity", "round_floor"), apps=("resmlp",),
        engine="pipelined", devices_per_target=2, ladder="full", n_eval=24,
        train_steps=60, op_samples=1, vt2_n=2, seed=0, stat_floor=1e-3,
        stat_calib_seeds=5, device="cpu")


def test_round_floor_detected_by_statistical_tier(stat_campaign):
    (rf,) = [m for m in stat_campaign.reports if m.fault == "round_floor"]
    assert rf.outcome == "ok"
    stat = rf.tiers["stat"]
    assert stat.detected is True, stat.detail
    assert stat.score > 5 * stat.threshold
    assert rf.escaped_fragment_checks
    assert rf.tiers["op_diff"].detected is False


def test_identity_within_fp_budget_in_full_campaign(stat_campaign):
    (ident,) = [m for m in stat_campaign.reports if m.fault == "identity"]
    assert ident.detected_at is None
    assert ident.tiers["stat"].detected is False and ident.tiers["stat"].score == 0.0
    cal = stat_campaign.stat_calibration
    assert cal["calib_seeds"] == 5
    assert cal["null_shifts"]["flexasr:resmlp"] == [0.0] * 5
    assert cal["thresholds"]["flexasr:resmlp"] == cal["floor"] == 1e-3
    assert cal["false_positives"]["flexasr:resmlp"] == 0


def test_stat_tier_disabled_without_calibration(monkeypatch):
    def fake_prepare(name, n_eval, train_steps, seed, device):
        def per_example(ex, idx):
            n = len(list(idx))
            return campaign_mod.PerExample(np.ones((n, 4)), np.zeros(n), 1.0)

        return campaign_mod._App(name, "acc", None, {"vecunit": 1}, pool=128,
                                 per_example=per_example)

    monkeypatch.setattr(campaign_mod, "_prepare_app", fake_prepare)
    r = campaign_mod.run_campaign(
        targets=("vecunit",), faults=("identity",), apps=("resmlp",), engine="compiled",
        devices_per_target=1, op_samples=1, vt2_n=2, stat_calib_seeds=0, device="cpu")
    (rep,) = r.reports
    assert rep.tiers["app"].detected is False
    assert rep.tiers["stat"].detected is None
    assert "uncalibrated" in rep.tiers["stat"].detail
