"""PyTorch port: how a rank of an NCCL group finds its card, on the CPU.

An NCCL group needs a card for each rank: NCCL refuses two ranks on one
card. ``launch.checks.spawn(..., backend="nccl")`` puts rank r on card r
(``checks.rank_device``) and ``launch.train._process_group`` makes
``torchrun``'s ``LOCAL_RANK`` the current card before it joins the group.
Here, without a card, ``torch.cuda`` is monkeypatched: the helpers pick
the card, call ``set_device`` before the group starts, and raise where a
rank has no card of its own. ``spawn``'s default, a gloo group of CPU
processes, is run for real, as are ``local_shard_case``'s device and
dtype hand-off to ``serve_vs_plain`` and ``chip_smoke.nccl_plan``, phase
22's groups (tests/test_torch_families.py holds its launch reckoning to
the kernel calls).
"""
import importlib.util
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch import device as devmod
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import checks, train

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture
def cards(monkeypatch):
    """A host of four faked cards: the current device, and each
    ``set_device`` call in order."""
    state = {"current": 0, "set": []}

    def set_device(d):
        state["current"] = d if isinstance(d, int) else torch.device(d).index
        state["set"].append(state["current"])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    return state


def _whoami():
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(), "threads": torch.get_num_threads()}


def test_spawn_gloo_runs_one_thread_cpu_ranks(tmp_path):
    got = checks.spawn(_whoami, (), 2, tmp_path, 60, backend="gloo")
    assert got == [{"rank": r, "world": 2, "backend": "gloo", "threads": 1} for r in range(2)]


def test_spawn_refuses_before_starting_processes(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card each; this host has 0"):
        checks.spawn(_whoami, (), 2, tmp_path, 60, backend="nccl")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        checks.spawn(_whoami, (), 2, tmp_path, 60, backend="mpi")
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_nccl_rank_picks_its_own_card(cards, rank):
    assert checks.rank_device(rank, "nccl") == torch.device("cuda", rank)
    assert cards["set"] == [rank]
    assert devmod.resolve("cuda") == torch.device("cuda", rank)


def test_nccl_rank_without_a_card_raises(cards, monkeypatch):
    with pytest.raises(RuntimeError, match="rank 4 of an nccl group has no card"):
        checks.rank_device(4, "nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="rank 0 of an nccl group has no card"):
        checks.rank_device(0, "nccl")
    assert cards["set"] == []


def test_gloo_rank_stays_on_the_cpu(cards):
    assert checks.rank_device(3, "gloo") == torch.device("cpu")
    assert cards["set"] == []
    with pytest.raises(ValueError, match="backend 'ucc'"):
        checks.rank_device(0, "ucc")


def _torchrun(monkeypatch, cards, local_rank: int) -> list:
    """torchrun's environment for rank ``local_rank`` of 4 on one host; the
    groups joined, each with the cards set before it."""
    for k, v in {"WORLD_SIZE": "4", "RANK": str(local_rank), "LOCAL_RANK": str(local_rank),
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}.items():
        monkeypatch.setenv(k, v)
    joined = []
    monkeypatch.setattr(train.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(train.dist, "init_process_group",
                        lambda backend, **kw: joined.append((backend, list(cards["set"]))))
    return joined


def test_process_group_sets_local_rank_card_before_joining(cards, monkeypatch):
    joined = _torchrun(monkeypatch, cards, 2)
    assert train._process_group(torch.device("cuda", 0)) is True
    assert joined == [("nccl", [2])]
    # the device the rank then resolves is its own card
    assert devmod.resolve("cuda") == torch.device("cuda", 2)


def test_process_group_on_the_cpu_sets_no_card(cards, monkeypatch):
    joined = _torchrun(monkeypatch, cards, 3)
    assert train._process_group(torch.device("cpu")) is True
    assert joined == [("gloo", [])]


def test_local_shard_case_hands_its_device_to_serve(monkeypatch):
    seen = {}

    def fake_train(cfg, model, batch, mesh):
        return {}

    def fake_serve(cfg, model, tokens, mesh, **kw):
        seen.update(kw)
        return {}

    class Model:
        def parameters(self):
            return iter([torch.zeros(2, dtype=torch.float64)])

    monkeypatch.setattr(checks, "train_vs_plain", fake_train)
    monkeypatch.setattr(checks, "serve_vs_plain", fake_serve)
    cfg = get_smoke_config("tinyllama_1_1b")
    out = checks.local_shard_case(cfg, Model(), {"tokens": torch.zeros(1, 4)}, None)
    assert seen == {"device": torch.device("cpu"), "dtype": torch.float64}
    assert out["serve"] == {} and out["drops"] == [0, 0]


def test_nccl_plan_covers_phase_18_and_the_published_arch():
    plan = smoke.nccl_plan(4)
    assert {m: tuple(a for a, w in c if w == "smoke") for m, c in plan.items()} \
        == smoke.GLOO_CASES
    assert [m for m, c in plan.items() if (smoke.NCCL_ARCH, "published") in c] \
        == list(smoke.NCCL_PUBLISHED_MESHES)
    assert list(smoke.nccl_plan(8)) == list(plan)
    assert set(smoke.nccl_plan(2)) == {(1, 2), (2, 1)}
    with pytest.raises(ValueError, match="two cards or more"):
        smoke.nccl_plan(1)
    # TinyLlama-1.1B published: 22 layers, two train steps of 2 x 22, two
    # prefills of 22
    assert smoke.nccl_flash_calls(get_config("tinyllama_1_1b"), serve=True) == 132
