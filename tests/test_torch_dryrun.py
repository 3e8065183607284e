"""PyTorch port: the dry-run and the roofline against the JAX reference.

* ``roofline.analysis.model_flops`` equals the reference's for every
  (arch x shape); with the reference's TPU v5e peaks in place of the H100's,
  ``roofline_terms`` and ``roofline_report`` equal the reference's on the
  same cell dicts (the port's dry-run cells among them).
* The dry-run's counts on a fake 2x2 mesh, meta tensors: TinyLlama's smoke
  train step counts exactly a hand count of its GEMMs and attention; four
  layers less two count two layers' worth (the Python layer loops count
  every layer: nothing to unroll); the trip-count shortcut of
  ``layers.scan`` (Mamba1's scan, train and prefill; the microbatch loop;
  the MoE token groups; in train steps, Mamba1's chunks and the MoE's
  groups recomputed in backward) counts exactly what every trip counts.
* ``layers.attention_shape`` (shapes only, on meta tensors) is reached only
  for meta: the kernel wrapper still raises on a device without a kernel.
* ``launch.dryrun`` at 16x16: TinyLlama train_4k is "ok", a skipped cell is
  skipped, and the CLI writes where ``--out`` says; a microbatch of fewer
  rows than data-parallel ranks passes the MoE (DeepSeek-V3, Qwen3-MoE).

The collective counts and bytes of the fake group are held to a real 2x2
gloo mesh in ``tests/test_torch_distributed.py``.
"""
import dataclasses
import json

import pytest
import torch

from repro import configs as jconfigs
from repro.models.config import SHAPES as JSHAPES
from repro.roofline import analysis as ranalysis
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.launch import dryrun, steps as tst
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as tlayers
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.roofline import analysis as tanalysis, report as treport

TRAIN = ShapeConfig("t", 64, 8, "train")
V5E = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9, "NVLINK_BW": 50e9}


def count(cfg, shape, *, shortcut=True, microbatches=None):
    """(flops, collective counts, collective bytes, trips) of the cell's
    step on a fake 2x2 mesh, meta tensors."""
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        if shape.kind == "train":
            bundle = tst.make_train_step(cfg, shape, mesh, microbatches=microbatches)
            args = bundle.abstract_args
        else:
            bundle = tst.make_serve_step(cfg, shape, mesh, shape.kind)
            args = bundle.abstract_args
            if shape.kind == "decode":
                args = args[:-1] + (shape.seq_len - 1,)
        counter, _ = dryrun.count_step(bundle, args, shortcut=shortcut)
    coll = counter.collectives()
    return counter.flops(), coll["counts"], coll["bytes"], dict(counter.trips)


# ---------------------------------------------------------------------------
# the roofline against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_model_flops_equal_reference(arch):
    for name in SHAPES:
        got = tanalysis.model_flops(tconfigs.get_config(arch), SHAPES[name])
        want = ranalysis.model_flops(jconfigs.get_config(arch), JSHAPES[name])
        assert got == want, (arch, name, got, want)


@pytest.fixture(scope="module")
def tinyllama_cell():
    return dryrun.run_cell("tinyllama_1_1b", "train_4k")


def test_tinyllama_train_4k_at_16x16_is_ok(tinyllama_cell):
    c = tinyllama_cell
    assert c["status"] == "ok", c.get("traceback")
    assert c["n_devices"] == 256 and c["step"] == "train_step"
    assert c["acct_flops"] == c["acct_flops_global"] / 256
    # counted work against the 6ND + attention yardstick: more (remat
    # reruns the forward, attention is counted dense), within a small factor
    useful = tanalysis.model_flops(tconfigs.get_config("tinyllama_1_1b"), SHAPES["train_4k"])
    assert 1.0 < c["acct_flops_global"] / useful["total"] < 2.0, c["acct_flops_global"]
    coll = c["collectives"]
    assert coll["bytes"]["total"] == sum(v for k, v in coll["bytes"].items() if k != "total") > 0
    assert set(coll["counts"]) == set(coll["bytes"]) - {"total"}
    assert c["fits_h100"] and 0 < c["arg_bytes_per_dev"] <= c["resident_bytes_per_dev"]
    assert c["acct_bytes"] == c["arg_bytes_per_dev"] + c["out_bytes_per_dev"]
    for key in ("hlo_flops", "temp_bytes_per_dev"):
        assert c[key] is None and c["null_reasons"][key], key


def test_roofline_terms_and_report_equal_reference_on_v5e_peaks(tinyllama_cell, monkeypatch):
    for k, v in V5E.items():
        monkeypatch.setattr(tanalysis, k, v)
    made = [
        {"arch": "gemma_7b", "shape": "decode_32k", "mesh": "16x16", "status": "ok",
         "step": "serve_step", "n_devices": 256, "acct_flops": 3.1e12, "acct_bytes": 9.6e9,
         "collectives": {"bytes": {"all-gather": 4e8, "total": 4e8}}},
        {"arch": "zamba2_7b", "shape": "long_500k", "mesh": "2x16x16", "status": "ok",
         "step": "serve_step", "n_devices": 512, "hlo_flops": 2.5e9, "hlo_bytes": 1e8},
        {"arch": "qwen3_moe_30b_a3b", "shape": "prefill_32k", "mesh": "16x16",
         "status": "ok", "step": "prefill_step", "n_devices": 256, "acct_flops": 0.0},
        {"arch": "smollm_360m", "shape": "long_500k", "mesh": "16x16", "status": "skipped",
         "reason": "long_500k skipped: full-attention arch"},
        {"arch": "whisper_base", "shape": "train_4k", "mesh": "16x16", "status": "failed",
         "error": "RuntimeError: something went wrong in the step"},
    ]
    cells = [tinyllama_cell] + made
    for c in cells:
        if c["status"] != "ok":
            continue
        got = tanalysis.roofline_terms(c, tconfigs.get_config(c["arch"]), SHAPES[c["shape"]])
        want = ranalysis.roofline_terms(c, jconfigs.get_config(c["arch"]), JSHAPES[c["shape"]])
        assert got == want, c["arch"]
    assert tanalysis.roofline_report(cells) == ranalysis.roofline_report(cells)


def test_report_prints_and_returns_the_rows(tinyllama_cell, tmp_path, capsys):
    path = tmp_path / "cells.json"
    skipped = {"arch": "gemma_7b", "shape": "long_500k", "mesh": "16x16", "status": "skipped",
               "reason": "full-attention arch"}
    path.write_text(json.dumps([tinyllama_cell, skipped]))
    rows = treport.run(str(path))
    terms = tanalysis.roofline_terms(tinyllama_cell, tconfigs.get_config("tinyllama_1_1b"),
                                     SHAPES["train_4k"])
    assert rows == [("roofline_tinyllama_1_1b_train_4k", terms["roofline_bound_s"] * 1e6,
                     f"dominant={terms['dominant']},mfu_bound={terms['mfu_bound']}")]
    out = capsys.readouterr().out
    assert "| tinyllama_1_1b | train_4k | 16x16 | train_step |" in out
    assert "| gemma_7b | long_500k | 16x16 | skipped |" in out
    assert treport.run(str(tmp_path / "absent.json")) == []


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------


def hand_count_train(cfg, shape):
    """TinyLlama-family train step FLOPs by hand. Per block, GEMMs: q, k, v,
    o, gate, up, down; attention 4 B Hq S Sk D (Q.K^T and P.V over every
    pair). Each block runs its forward, again in backward (remat: the
    recompute stops at the block's last saved tensor, the input of its
    down projection, so that GEMM is not rerun), and two GEMMs of backward
    per forward GEMM; attention (counted by the kernel's shape-only stand-in
    in the forward and the remat recompute) is recomputed in backward in
    plain ops (Q.K^T and P.V: one attention's worth) and differentiated
    (two GEMMs per product: two). The LM head: forward and backward."""
    B, S = shape.global_batch, shape.seq_len
    T, d, hd = B * S, cfg.d_model, cfg.hd
    qkvo = 2 * T * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    up = 2 * 2 * T * d * cfg.d_ff
    down = 2 * T * cfg.d_ff * d
    attn = 4 * B * cfg.n_heads * S * S * hd
    block = 3 * (qkvo + up + down) + (qkvo + up) + attn * (2 + 1 + 2)
    return cfg.n_layers * block + 3 * 2 * T * d * cfg.vocab


def test_counted_flops_equal_hand_count():
    cfg = tconfigs.get_smoke_config("tinyllama_1_1b")
    flops, counts, _, _ = count(cfg, TRAIN)
    assert flops == hand_count_train(cfg, TRAIN)
    assert sum(counts.values()) > 0


def test_four_layers_less_two_count_two_layers():
    base = tconfigs.get_smoke_config("tinyllama_1_1b")
    c = {n: count(dataclasses.replace(base, n_layers=n), TRAIN) for n in (2, 3, 4)}
    layer = hand_count_train(dataclasses.replace(base, n_layers=1), TRAIN) \
        - hand_count_train(dataclasses.replace(base, n_layers=0), TRAIN)
    assert c[4][0] - c[2][0] == 2 * (c[3][0] - c[2][0]) == 2 * layer
    for i in (1, 2):   # collective counts, bytes
        assert {k: c[4][i][k] - c[2][i].get(k, 0) for k in c[4][i]} == \
            {k: 2 * (c[3][i][k] - c[2][i].get(k, 0)) for k in c[4][i]}


PREFILL = ShapeConfig("p", 64, 4, "prefill")


@pytest.mark.parametrize("arch,shape,microbatches,layers,moe_group", [
    ("falcon_mamba_7b", TRAIN, None, None, None),                         # scan + backward
    ("falcon_mamba_7b", PREFILL, None, 5, None),                          # scan, layers
    ("tinyllama_1_1b", TRAIN, 4, None, None),                             # microbatches
    ("tinyllama_1_1b", ShapeConfig("d", 64, 4, "decode"), None, 5, None),  # layers, decode
    ("zamba2_7b", PREFILL, None, 9, None),                                # hybrid groups
    # MoE groups: 8 x 32768 tokens over 2 data ranks, 4 groups a rank
    ("qwen3_moe_30b_a3b", ShapeConfig("p", 32_768, 8, "prefill"), None, None, None),
    # recomputed in backward: 4 scan chunks of 256 steps; 8 x 64 tokens
    # over 2 data ranks in groups of 64, 4 pieces a rank
    ("falcon_mamba_7b", ShapeConfig("t", 1024, 2, "train"), None, 1, None),
    ("qwen3_moe_30b_a3b", TRAIN, None, None, 64),
], ids=["mamba1_train", "mamba1_prefill", "microbatches", "layers_decode", "hybrid_groups",
        "moe_groups", "mamba1_train_chunks", "moe_train_groups"])
def test_trip_count_shortcut_is_exact(arch, shape, microbatches, layers, moe_group,
                                      monkeypatch):
    if moe_group:
        monkeypatch.setattr(tlayers, "MOE_GROUP", moe_group)
    cfg = tconfigs.get_smoke_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cut = count(cfg, shape, microbatches=microbatches)
    full = count(cfg, shape, shortcut=False, microbatches=microbatches)
    assert cut[3] and all(k.endswith("/3") for k in cut[3]), cut[3]   # loops were cut
    assert not any(k.endswith("/3") for k in full[3]), full[3]
    assert cut[:3] == full[:3]


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "qwen3_moe_30b_a3b"])
def test_uneven_microbatch_rows_through_moe(arch):
    """A microbatch of fewer rows than data-parallel ranks (the 2x16x16
    mesh's 16 rows over 32 ranks, here 2 over 4) through the MoE's token
    flatten, forward and backward."""
    cfg = tconfigs.get_smoke_config(arch)
    with dryrun.fake_group(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        bundle = tst.make_train_step(cfg, ShapeConfig("t", 64, 4, "train"), mesh,
                                     microbatches=2)
        counter, (_, _, metrics) = dryrun.count_step(bundle)
    assert counter.flops() > 0 and set(metrics) == {"loss", "grad_norm", "lr"}


def test_meta_attention_counts_dense_and_kernel_still_refuses_other_devices():
    q = torch.empty(2, 8, 4, 16, device="meta")
    k = torch.empty(2, 8, 2, 16, device="meta")
    with dryrun.Counter() as counter:
        out = tlayers.sdpa(q, k, k)
    assert out.shape == q.shape and out.device.type == "meta"
    assert counter.flops() == 4 * 2 * 4 * 8 * 8 * 16
    with pytest.raises(ValueError, match="no kernel for device meta"):
        kfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2))


def test_a_cell_past_its_time_limit_fails():
    c = dryrun.run_cell("tinyllama_1_1b", "train_4k", timeout_s=0.5)
    assert c["status"] == "failed" and c["error"].startswith("CellTimeout"), c.get("error")
    assert not torch.distributed.is_initialized()


def test_a_timeout_swallowed_by_a_callback_still_fails_the_cell():
    """The alarm may land in a garbage-collector callback (the JAX runtime
    in the same process registers one), which only reports the exception:
    the time limit raises when the block ends all the same."""
    import gc
    import time

    def busy(phase, info):
        if phase == "start":
            t0 = time.monotonic()
            while time.monotonic() - t0 < 0.3:
                pass

    gc.callbacks.append(busy)
    try:
        with pytest.raises(dryrun.CellTimeout, match="after 0.1 s"):
            with dryrun._time_limit(0.1):
                gc.collect()
    finally:
        gc.callbacks.remove(busy)


def test_cli_writes_out_and_skips_unsupported_cells(tmp_path):
    out = tmp_path / "cells.json"
    cells = dryrun.main(["--arch", "gemma-7b", "--shape", "long_500k", "--both-meshes",
                         "--out", str(out)])
    assert [c["status"] for c in cells] == ["skipped", "skipped"]
    assert [c["mesh"] for c in cells] == ["16x16", "2x16x16"]
    assert json.loads(out.read_text()) == cells
