"""PyTorch port: campaign tier 0 (the static verifier), the counterpart of
``tests/test_campaign_static.py``.

Protocol faults — decode aliasing and command reordering — are flagged by
the static tier with zero simulated commands, and under
``ladder="escalate"`` every simulated tier below is skipped; wrapper faults
stay out of static scope and are caught by a simulated tier. The static
tier's verdicts equal the reference's mutant by mutant.
"""
import pytest

import repro.accel  # noqa: F401
import repro_torch.accel  # noqa: F401
from repro.core import campaign as jcampaign
from repro_torch.core import faults, ilalint
from repro_torch.core.campaign import TIER_ORDER, format_matrix, run_campaign
from repro_torch.core.ila import TARGETS

CONFIG = dict(
    targets=["vecunit", "hlscnn"],
    faults=["identity", "decode_alias", "cmd_reorder", "drop_cfg"],
    apps=(), engine="compiled", devices_per_target=1, ladder="escalate",
    op_samples=1, stat_calib_seeds=0, seed=0,
)


@pytest.fixture(scope="module")
def static_campaign():
    return run_campaign(device="cpu", **CONFIG)


def test_static_is_tier_zero():
    assert TIER_ORDER[0] == "static" and TIER_ORDER == jcampaign.TIER_ORDER


def test_every_decode_alias_mutant_caught_statically(static_campaign):
    aliases = [m for m in static_campaign.reports if m.fault == "decode_alias"]
    assert aliases
    for m in aliases:
        assert m.detected_at == "static"
        assert "opcode stream rewritten" in m.tiers["static"].detail


def test_cmd_reorder_sensitive_mutant_caught_statically(static_campaign):
    caught = [m for m in static_campaign.reports
              if m.fault == "cmd_reorder" and m.detected_at == "static"]
    assert caught
    assert any("order-sensitive" in m.tiers["static"].detail for m in caught)


def test_static_detection_skips_every_simulated_tier(static_campaign):
    for m in static_campaign.reports:
        if m.detected_at != "static":
            continue
        for tier in ("vt2", "frag_sim", "op_diff", "app", "stat"):
            r = m.tiers.get(tier)
            assert r is None or (r.detected is None and "skipped" in r.detail)


def test_identity_passes_and_wrapper_faults_stay_out_of_scope(static_campaign):
    for m in static_campaign.reports:
        if m.fault == "identity":
            assert m.tiers["static"].detected is False and m.detected_at is None
        if m.fault == "drop_cfg":
            assert m.tiers["static"].detected is False
            assert "out of static scope" in m.tiers["static"].detail
            assert m.detected_at not in (None, "static")


def test_static_tier_matches_reference(static_campaign):
    """The static verdict, score and detail of every mutant equal the
    reference's (the tier is pure numpy over identical probe streams)."""
    want = {m.key: m for m in jcampaign.run_campaign(
        **dict(CONFIG, faults=["identity", "decode_alias", "cmd_reorder"])).reports}
    for m in static_campaign.reports:
        if m.key in want:
            w = want[m.key].tiers["static"]
            g = m.tiers["static"]
            assert (g.detected, g.score, g.detail) == (w.detected, w.score, w.detail), m.key


def test_matrix_and_json_gain_static_column(static_campaign):
    assert "static" in format_matrix(static_campaign).splitlines()[0]
    d = static_campaign.to_json()
    assert "static" in {t for m in d["mutants"] for t in m["tiers"]}
    n_alias = sum(1 for m in static_campaign.reports if m.fault == "decode_alias")
    assert d["summary"]["first_detection_by_tier"]["static"] >= n_alias + 1


def test_golden_ilas_not_simulated_by_static_tier():
    t = TARGETS.get("vecunit")
    probes = ilalint.probe_streams(t, seed=0, samples=1)
    before = (t.ila.n_traces_single, t.ila.n_traces_batch)
    for inst in faults.fault_instances(t, ["decode_alias", "cmd_reorder"]):
        ilalint.analyze_mutation(t, probes, inst.host_xform())
    assert (t.ila.n_traces_single, t.ila.n_traces_batch) == before
