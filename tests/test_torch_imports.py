"""PyTorch port: import isolation and device resolution.

The port (``src/repro_torch``) and ``chip_smoke.py`` import neither JAX nor
the JAX package; every slice module imports with ``jax`` blocked. Entry
points default to CUDA and raise on a host without it — no silent CPU
fallback.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

SLICE_MODULES = [
    "repro_torch.device",
    "repro_torch.core.telemetry",
    "repro_torch.core.ir",
    "repro_torch.core.egraph",
    "repro_torch.core.ila",
    "repro_torch.core.rules",
    "repro_torch.core.compile",
    "repro_torch.core.codegen",
    "repro_torch.core.apps",
    "repro_torch.core.cosim",
    "repro_torch.accel.numerics",
    "repro_torch.accel.target",
    "repro_torch.accel.flexasr",
    "repro_torch.accel.hlscnn",
    "repro_torch.accel.vecunit",
    "repro_torch.accel.vta",
    "repro_torch.kernels.ref",
    "repro_torch.kernels.build",
    "repro_torch.kernels.af_gemm",
    "repro_torch.kernels.fx_gemm",
    "repro_torch.kernels.int8_gemm",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.ops",
    "repro_torch.launch.table4",
    "repro_torch.launch.serve",
    "repro_torch.models.config",
    "repro_torch.models.layers",
    "repro_torch.models.ssm",
    "repro_torch.models.lm",
    "repro_torch.models.whisper",
    "repro_torch.models.api",
    "repro_torch.configs",
] + [f"repro_torch.configs.{a}" for a in (
    "pixtral_12b", "deepseek_v3_671b", "qwen3_moe_30b_a3b", "zamba2_7b", "falcon_mamba_7b",
    "gemma_7b", "granite_8b", "smollm_360m", "tinyllama_1_1b", "whisper_base")]

_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax\b|jaxlib\b|repro(?:\.|\s|$))")


def test_slice_modules_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    __import__(m)\n"
        "leaked = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not leaked, leaked\n"
        "from repro_torch.core.ila import TARGETS\n"
        "assert TARGETS.names() == ['flexasr', 'hlscnn', 'vecunit', 'vta'], TARGETS.names()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_or_reference_imports_in_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [
        f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if _FORBIDDEN.match(line)
    ]
    assert not offenders, offenders


def test_port_never_calls_the_library_attention():
    """scaled_dot_product_attention is chip_smoke's timed yardstick only."""
    offenders = [str(f.relative_to(ROOT)) for f in sorted(PORT.rglob("*.py"))
                 if "scaled_dot_product_attention" in f.read_text()]
    assert not offenders, offenders


def test_executor_without_device_raises_when_cuda_absent(monkeypatch):
    from repro_torch.core.codegen import Executor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor("ila", device="cuda")
    assert Executor("ila", device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("entry", ["interpret", "init_state", "setup_state", "teacher",
                                   "hlscnn_init_state", "vta_init_state",
                                   "vecunit_init_state", "table4_row", "lm_init_cache",
                                   "whisper_init_cache", "params_from_numpy", "train_batch",
                                   "serve"])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    from repro_torch.accel import flexasr as fa, hlscnn, vecunit, vta
    from repro_torch.core import apps, cosim, ir
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve, table4
    from repro_torch.models import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = ir.Var("x", (2, 3))
    calls = {
        "interpret": lambda: ir.interpret(ir.call("relu", x), {"x": np.ones((2, 3))}),
        "init_state": lambda: fa.flexasr.init_state(),
        "setup_state": lambda: fa.pool_fragment(8, "max", cache=False).setup_state(),
        "teacher": lambda: cosim.make_teacher_task(apps.build_resmlp, (16, 64), n=4),
        "hlscnn_init_state": lambda: hlscnn.hlscnn.init_state(),
        "vta_init_state": lambda: vta.vta.init_state(),
        "vecunit_init_state": lambda: vecunit.vecunit.init_state(),
        "table4_row": lambda: table4.acc_row(table4.APPS["resnet20"], n_eval=1, steps=1),
        "lm_init_cache": lambda: api.init_cache(get_smoke_config("tinyllama_1_1b"), 1, 4),
        "whisper_init_cache": lambda: api.init_cache(get_smoke_config("whisper_base"), 1, 4),
        "params_from_numpy": lambda: api.params_from_numpy(
            get_smoke_config("granite_8b"), {"final_norm": np.ones(4, np.float32)}),
        "train_batch": lambda: api.make_train_batch(get_smoke_config("tinyllama_1_1b"), 1, 4,
                                                    np.random.default_rng(0)),
        "serve": lambda: serve.main(["--arch", "tinyllama-1.1b", "--smoke"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_resolving_cuda_turns_tf32_off(monkeypatch):
    from repro_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert not device.tf32_off()
    assert device.resolve(None) == torch.device("cuda", 0)
    assert device.tf32_off()
    assert device.resolve("cpu") == torch.device("cpu")
