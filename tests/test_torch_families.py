"""PyTorch port: the plan by which chip_smoke.py serves every configuration.

``chip_smoke.family_plan()`` decides, on meta tensors, how phase 20 serves
each of the ten configurations on the card: the published config with its
depth cut only where the weights do not fit (DeepSeek-V3), the
flash_attention launches ``launch.serve.generate`` must make in prefill and
in decode, and the fp32 consistency check's config. Here, on the CPU: every
configuration is planned, each planned config differs from the published
one only in the fields it lists as cut, its weights stay under the plan's
limit, and ``chip_smoke.flash_calls`` (which the plan's counts come from)
equals the attention calls ``generate`` and the fp32 check make at each
smoke config, counted around ``layers._flash_padded``, where every kernel
call of a model goes.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.steps import abstract_params
from repro_torch.models import api, layers

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

GEN = 5


@pytest.fixture(scope="module")
def plan():
    return smoke.family_plan()


def _differs_only_where_listed(base, cfg, listed):
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(base, f.name)
        if f.name in listed:
            assert listed[f.name] == (want, got) and got != want, f.name
        else:
            assert got == want, f.name


def test_every_configuration_is_planned(plan):
    assert list(plan) == ARCH_IDS
    # DeepSeek-V3 alone is cut, to one layer (about 50 GB with its MTP block)
    cut = {a: p["cfg"].n_layers for a, p in plan.items() if p["reduced"]}
    assert cut == {"deepseek_v3_671b": 1}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_planned_configs_change_only_the_listed_fields(plan, arch):
    p = plan[arch]
    assert set(p["reduced"]) <= {"n_layers"}
    _differs_only_where_listed(get_config(arch), p["cfg"], p["reduced"])
    base = get_smoke_config(arch) if p["fp32_base"] == "smoke" else get_config(arch)
    assert p["fp32_base"] == ("smoke" if arch == "deepseek_v3_671b" else "published")
    assert set(p["fp32_reduced"]) <= {"n_layers", "capacity_factor"}
    _differs_only_where_listed(base, p["fp32_cfg"], p["fp32_reduced"])
    fcfg = p["fp32_cfg"]
    if fcfg.n_experts:   # every token keeps its slots: capacity C = T
        T = 1000
        assert layers._capacity(fcfg, T) >= T


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_weights_fit_under_the_limit(plan, arch):
    p = plan[arch]
    sizes = [t.numel() * t.element_size() for t in abstract_params(p["cfg"]).parameters()]
    assert p["param_bytes"] == sum(sizes)
    assert p["param_bytes"] + 2 * max(sizes) <= smoke.FAMILY_MEM_LIMIT
    assert p["param_bytes"] <= p["peak_bytes"] <= smoke.FAMILY_MEM_LIMIT
    if p["reduced"]:   # one layer more would not fit
        deeper = dataclasses.replace(p["cfg"], n_layers=p["cfg"].n_layers + 1)
        more = sum(t.numel() * t.element_size() for t in abstract_params(deeper).parameters())
        assert more + 2 * max(sizes) > smoke.FAMILY_MEM_LIMIT


@pytest.fixture
def attention_calls(monkeypatch):
    """Counts of ``layers._flash_padded`` calls (every kernel call of a
    model), by the api function that made them."""
    counts = {"prefill": 0, "decode": 0, "forward": 0}
    where = ["forward"]

    def counted(fn, name):
        def call(*a, **kw):
            where.append(name)
            try:
                return fn(*a, **kw)
            finally:
                where.pop()
        return call

    flash = layers._flash_padded

    def flash_counted(*a, **kw):
        counts[where[-1]] += 1
        return flash(*a, **kw)

    monkeypatch.setattr(layers, "_flash_padded", flash_counted)
    monkeypatch.setattr(api, "prefill", counted(api.prefill, "prefill"))
    monkeypatch.setattr(api, "decode_step", counted(api.decode_step, "decode"))
    return counts


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_launches_equal_generate_calls(plan, arch, attention_calls):
    cfg = get_smoke_config(arch)
    model = api.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    prompt = smoke.family_inputs(cfg, 2, 12, "cpu", torch.float32)
    stats = {}
    tokens = serve.generate(cfg, model, prompt, GEN, stats)
    assert tokens.shape == (2, GEN) and stats["finite"]
    want = smoke.flash_calls(cfg, GEN - 1)
    assert attention_calls == {"prefill": want["prefill"], "decode": want["decode"],
                               "forward": 0}
    # the plan's counts are the same reading of its own config
    p = plan[arch]
    assert p["launches"] == {k: v for k, v in smoke.flash_calls(
        p["cfg"], smoke.FAMILY_GEN - 1).items() if k != "forward"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fp32_check_launches_and_agrees(plan, arch, attention_calls):
    """The fp32 check (forward against prefill + decode) at the smoke
    config, with the plan's capacity and generated length: within phase
    11's bound, with the calls ``flash_calls`` counts."""
    p = plan[arch]
    cfg = get_smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=p["fp32_cfg"].capacity_factor)
    model = api.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    prompt = smoke.family_inputs(cfg, 2, 256, "cpu", torch.float32)
    gen = p["fp32_gen"] if cfg.family == "hybrid" else GEN
    rel, finite = smoke.decode_vs_forward(cfg, model, prompt, gen)
    assert finite and rel < smoke.LM_CONSISTENCY_TOL, rel
    want = smoke.flash_calls(cfg, gen - 1)
    assert attention_calls == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_card_vs_cpu_check_runs_every_family(arch, attention_calls):
    """Phase 12's and 20's card-against-CPU check, here with the CPU on
    both sides: the prefill and every decode step's logits compared, the
    calls ``flash_calls`` counts made on the first side."""
    cfg = get_smoke_config(arch)
    counted = {}

    def zero_counts():
        attention_calls.update(dict.fromkeys(attention_calls, 0))

    def read_counts():
        counted.update(attention_calls)
        return counted

    dev, close, counts = smoke.card_vs_cpu(cfg, "cpu", 2, 8, 3, zero_counts, read_counts)
    assert dev == 0.0 and close
    want = smoke.flash_calls(cfg, 3)
    assert counts == {"prefill": want["prefill"], "decode": want["decode"], "forward": 0}


@pytest.fixture
def one_rank_gloo():
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", smoke.GLOO_CASES[(2, 2)] + (smoke.NCCL_ARCH,))
def test_nccl_flash_calls_count_the_kernel_calls(arch, one_rank_gloo, monkeypatch):
    """Phase 22's reckoning of flash_attention launches per rank
    (``chip_smoke.nccl_flash_calls``) against the kernel calls of its case
    (``_nccl_job``: a train step plain and sharded, and the two prefills)
    at the smoke config on a 1x1 gloo mesh: the MoE's dispatch, MLA with
    its multi-token-prediction block, Mamba1, SmolLM's train step alone."""
    from repro_torch.launch import checks

    calls = []
    flash = layers._flash_padded
    monkeypatch.setattr(layers, "_flash_padded", lambda *a: calls.append(1) or flash(*a))
    monkeypatch.setattr(layers, "MOE_GROUP", layers.MOE_GROUP)   # the job sets its own
    r = smoke._nccl_job({(1, 1): ((arch, "smoke"),)})[f"{arch}:smoke@1x1"]
    want = smoke.nccl_flash_calls(get_smoke_config(arch), serve=arch != smoke.GLOO_SEQ_SPLIT)
    assert len(calls) == want
    assert r["device"] == "cpu" and r["launches"] == {"wgmma": 0, "wgmma3": 0}
    loss, plain = r["train"]["loss"]
    assert abs(loss - plain) <= checks.REL * abs(plain)

