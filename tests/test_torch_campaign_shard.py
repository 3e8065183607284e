"""PyTorch port: the sharded campaign runner and checkpoint/resume, the
counterpart of ``tests/test_campaign_shard.py``.

* the sharded runner's escape matrix digest equals the serial runner's
  (spawned workers, each resolving the config's device itself);
* a crashing and a hanging mutant are recorded as ``crash`` and
  ``timeout``, the rest complete, and the parent registries are untouched;
* a campaign resumed from a partial checkpoint has the uninterrupted run's
  digest; a checkpoint of another config (seed or device) refuses to
  resume; the checkpoint write is atomic.
"""
import json
import os

import pytest

import repro_torch.accel  # noqa: F401
from repro_torch.core import campaign as campaign_mod, ir
from repro_torch.core.ila import TARGETS


def _registry_snapshot():
    return (
        [(name, id(t)) for name, t in TARGETS._targets.items()],
        {op: (id(t), id(i)) for op, (t, i) in TARGETS._by_op.items()},
        {op: id(spec) for op, spec in ir._ACCEL_EXT.items()},
        set(ir.ACCEL_OPS),
    )


_BASE = dict(
    targets=("vecunit",), faults=("identity", "drop_cfg", "trunc_width"),
    apps=(), engine="compiled", devices_per_target=1,
    op_samples=1, vt2_n=2, seed=0, stat_calib_seeds=0, device="cpu",
)


def test_sharded_matrix_digest_matches_serial():
    serial = campaign_mod.run_campaign(**_BASE)
    sharded = campaign_mod.run_campaign_sharded(workers=2, mutant_timeout=300.0, **_BASE)
    assert campaign_mod.matrix_digest(serial) == campaign_mod.matrix_digest(sharded)
    assert campaign_mod.matrix_digest(json.loads(json.dumps(sharded.to_json()))) == \
        campaign_mod.matrix_digest(serial)


def test_sharded_campaign_survives_crash_and_hang(tmp_path):
    before = _registry_snapshot()
    ck = str(tmp_path / "CAMPAIGN.json")
    result = campaign_mod.run_campaign_sharded(
        workers=2, mutant_timeout=6.0, checkpoint=ck,
        **dict(_BASE, faults=("identity", "drop_cfg", "crash_inject", "hang_inject")))
    assert _registry_snapshot() == before
    by_fault = {r.fault: r for r in result.reports}
    assert len(result.reports) == 4
    assert by_fault["crash_inject"].outcome == "crash"
    assert "crash_inject" in by_fault["crash_inject"].error
    assert by_fault["hang_inject"].outcome == "timeout"
    assert by_fault["hang_inject"].detected_at == "timeout"
    assert by_fault["identity"].outcome == "ok" and by_fault["identity"].detected_at is None
    assert by_fault["drop_cfg"].outcome == "ok" and by_fault["drop_cfg"].detected_at
    s = result.summary()
    assert s["crashes"] == ["vecunit:crash_inject@wr_a"]
    assert s["timeouts"] == ["vecunit:hang_inject@wr_a"]
    data = json.load(open(ck))
    assert data["partial"] is False
    assert campaign_mod.matrix_digest(data) == campaign_mod.matrix_digest(result)


def test_resume_from_partial_checkpoint_is_bit_identical(tmp_path):
    ck = str(tmp_path / "CAMPAIGN.json")
    full = campaign_mod.run_campaign(checkpoint=ck, **_BASE)
    data = json.load(open(ck))
    assert data["partial"] is False and len(data["mutants"]) == 3
    with open(ck, "w") as f:
        json.dump(dict(data, partial=True, mutants=data["mutants"][:1]), f)
    resumed = campaign_mod.run_campaign(checkpoint=ck, resume=True, **_BASE)
    assert campaign_mod.matrix_digest(resumed) == campaign_mod.matrix_digest(full)
    assert json.load(open(ck))["partial"] is False
    again = campaign_mod.run_campaign(checkpoint=ck, resume=True, **_BASE)
    assert campaign_mod.matrix_digest(again) == campaign_mod.matrix_digest(full)


@pytest.mark.parametrize("change", [dict(seed=1), dict(device="cuda")])
def test_resume_refuses_foreign_fingerprint(tmp_path, change, monkeypatch):
    import torch

    ck = str(tmp_path / "CAMPAIGN.json")
    campaign_mod.run_campaign(checkpoint=ck, **_BASE)
    # a CPU checkpoint resumed for the card: refused before anything runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="fingerprint"):
        campaign_mod.run_campaign(checkpoint=ck, resume=True, **dict(_BASE, **change))


def test_same_seed_reproduces_digest_different_seed_changes_it():
    a = campaign_mod.run_campaign(**_BASE)
    b = campaign_mod.run_campaign(**_BASE)
    assert campaign_mod.matrix_digest(a) == campaign_mod.matrix_digest(b)
    c = campaign_mod.run_campaign(**dict(_BASE, seed=1))
    assert a.to_json()["fingerprint"] != c.to_json()["fingerprint"]
    assert campaign_mod.matrix_digest(a) != campaign_mod.matrix_digest(c)


def test_checkpoint_write_is_atomic(tmp_path):
    ck = str(tmp_path / "CAMPAIGN.json")
    campaign_mod.run_campaign(checkpoint=ck, **_BASE)
    assert os.path.exists(ck) and not os.path.exists(ck + ".tmp")
    json.load(open(ck))


def test_sharded_runner_refuses_an_unreachable_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        campaign_mod.run_campaign_sharded(workers=2, **dict(_BASE, device=None))
