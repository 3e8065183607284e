"""PyTorch port: the fault-tolerant trainer and the training launcher.

The reference's ``Trainer`` fails on this tree (ROADMAP.md, Queue 3), so it
anchors nothing; the port's trainer is held to the two assertions of
``tests/test_substrate.py::TestTrainer`` instead, on the CPU: an injected
worker failure at step 15 restarts once from the step-9 checkpoint and the
loss falls; a step slowed by a sleep is flagged as a straggler.
"""
import time

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train
from repro_torch.models.config import ShapeConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig, WorkerFailure


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of small ops: with several test workers on one host,
    torch's default intra-op thread pool per worker oversubscribes the
    cores and slows them by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(tmp, max_steps=30, hook=None):
    cfg = get_smoke_config("smollm_360m")
    data = SyntheticLM(cfg.vocab, 4, 32, seed=1)
    return Trainer(
        cfg, ShapeConfig("t", 32, 4, "train"), data,
        TrainerConfig(ckpt_dir=tmp, ckpt_every=10, max_steps=max_steps, lr=5e-3, warmup=5),
        failure_hook=hook, device="cpu",
    )


def test_restart_resumes_and_learns(tmp_path):
    fails = {"n": 0}

    def hook(step):
        if step == 15 and fails["n"] == 0:
            fails["n"] += 1
            raise WorkerFailure("injected")

    t = _mk(str(tmp_path), max_steps=30, hook=hook)
    t.run()
    events = [m for m in t.metrics if m.get("event") == "restart"]
    assert len(events) == 1
    losses = [m["loss"] for m in t.metrics if "loss" in m]
    assert losses[-1] < losses[0]
    # resumed from the step-9 checkpoint, not from scratch
    steps = [m["step"] for m in t.metrics if "step" in m]
    assert steps.count(10) == 2 and steps.count(0) == 1
    assert t.ckpt.all_steps() == [9, 19, 29]


def test_straggler_detection(tmp_path):
    slow = {"done": False}

    def hook(step):
        if step == 20 and not slow["done"]:
            slow["done"] = True
            time.sleep(6.0)   # >> 3x EWMA even on a contended CPU

    t = _mk(str(tmp_path), max_steps=25, hook=hook)
    t.run()
    assert 20 in t.straggler_steps


def test_restart_replays_the_uninterrupted_run(tmp_path):
    """Resuming from a checkpoint replays the batches and state exactly: the
    losses after the restart equal those of a run never interrupted."""
    def hook(step):
        if step == 12 and not hook.done:
            hook.done = True
            raise WorkerFailure("injected")
    hook.done = False

    clean = _mk(str(tmp_path / "a"), max_steps=14)
    clean.run()
    failed = _mk(str(tmp_path / "b"), max_steps=14, hook=hook)
    failed.run()
    want = {m["step"]: m["loss"] for m in clean.metrics if "loss" in m}
    got = [(m["step"], m["loss"]) for m in failed.metrics if "loss" in m]
    assert [s for s, _ in got][-4:] == [10, 11, 12, 13]
    for s, loss in got:
        assert loss == want[s], (s, loss, want[s])


def test_train_launcher_runs_checkpoints_and_learns(tmp_path, capsys):
    trainer = train.main(["--arch", "smollm-360m", "--smoke", "--steps", "30", "--device",
                          "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "loss" in out and "checkpoints [29]" in out
    losses = [m["loss"] for m in trainer.metrics if "loss" in m]
    assert len(losses) == 30 and losses[-1] < losses[0]


def test_trainer_without_device_raises_when_cuda_absent(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm_360m")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, ShapeConfig("t", 32, 4, "train"), SyntheticLM(cfg.vocab, 4, 32),
                TrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])
