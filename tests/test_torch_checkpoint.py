"""PyTorch port: checkpointing in the reference's on-disk format.

``TestCheckpoint`` of ``tests/test_substrate.py`` on the port, plus: a bf16
round trip is exact with no ``ml_dtypes`` (the card's host has none); an
async snapshot is a copy, so a tensor updated in place after
``save_async`` does not tear the checkpoint; and the two packages read each
other's checkpoints (same files, same manifest fields).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch.checkpoint.manager import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
rng = np.random.default_rng(0)


def _tree():
    return (
        {"w": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32)).bfloat16(),
         "b": torch.arange(3, dtype=torch.float32),
         "layers": [{"q": torch.ones(2, 2)}, {"q": torch.zeros(2, 2)}]},
        {"m": {"w": torch.zeros((4, 4)), "b": torch.ones((3,))},
         "step": torch.tensor(7, dtype=torch.int32)},
    )


def test_save_restore_roundtrip(tmp_path):
    params, opt = _tree()
    m = CheckpointManager(str(tmp_path))
    m.save(5, params, opt)
    p2, o2, step, _ = m.restore(params, opt)
    assert step == 5
    assert p2["w"].dtype == torch.bfloat16 and torch.equal(p2["w"], params["w"])
    assert torch.equal(p2["layers"][1]["q"], params["layers"][1]["q"])
    assert o2["step"].dtype == torch.int32 and int(o2["step"]) == 7
    files = sorted(os.listdir(tmp_path / "step_5"))
    assert "params__layers__1__q.npy" in files and "manifest.json" in files


def test_atomic_commit_ignores_torn_checkpoint(tmp_path):
    params, opt = _tree()
    m = CheckpointManager(str(tmp_path))
    m.save(1, params, opt)
    os.makedirs(tmp_path / "step_9")
    (tmp_path / "step_9" / "params__w.npy").write_bytes(b"junk")
    assert m.latest_step() == 1


def test_rotation(tmp_path):
    params, opt = _tree()
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, params, opt)
    assert m.all_steps() == [3, 4]


def test_async_save(tmp_path):
    params, opt = _tree()
    m = CheckpointManager(str(tmp_path))
    m.save_async(11, params, opt)
    m.wait()
    assert m.latest_step() == 11


def test_async_snapshot_is_a_copy(tmp_path):
    params, opt = _tree()
    want = params["b"].clone()
    m = CheckpointManager(str(tmp_path))
    m.save_async(3, params, opt)
    params["b"].add_(100.0)          # an in-place update after the snapshot
    m.wait()
    p2, _, _, _ = m.restore(params, opt)
    assert torch.equal(p2["b"], want)


def test_restore_checks_shapes_and_missing(tmp_path):
    params, opt = _tree()
    m = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        m.restore(params, opt)
    m.save(2, params, opt)
    bad = dict(params, b=torch.zeros(4))
    with pytest.raises(ValueError, match="shape mismatch"):
        m.restore(bad, opt)


def test_bf16_roundtrip_exact_without_ml_dtypes(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint.manager import CheckpointManager\n"
        "g = torch.Generator().manual_seed(0)\n"
        "w = (torch.randn(64, 33, generator=g) * 1e3).bfloat16()\n"
        "w[0, :4] = torch.tensor([float('inf'), -0.0, 1e-40, 3.0e38])\n"
        f"m = CheckpointManager({str(tmp_path)!r})\n"
        "m.save(1, {'w': w}, {'s': torch.zeros(())})\n"
        "p, _, _, _ = m.restore({'w': w}, {'s': torch.zeros(())})\n"
        "assert p['w'].dtype == torch.bfloat16\n"
        "assert torch.equal(p['w'].view(torch.int16), w.view(torch.int16))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert manifest["leaves"]["params/w"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_1" / "params__w.npy").dtype == np.float32


def test_packages_read_each_others_checkpoints(tmp_path):
    w = rng.standard_normal((4, 4)).astype(np.float32)
    b = np.arange(3, dtype=np.float32)
    jparams = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b)}
    jopt = {"step": jnp.asarray(7, jnp.int32)}
    JManager(str(tmp_path / "ref")).save(4, jparams, jopt)
    tparams = {"w": torch.from_numpy(w).bfloat16(), "b": torch.from_numpy(b)}
    topt = {"step": torch.tensor(7, dtype=torch.int32)}
    p, o, step, _ = CheckpointManager(str(tmp_path / "ref")).restore(tparams, topt)
    assert step == 4 and p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"], tparams["w"]) and torch.equal(p["b"], tparams["b"])
    assert int(o["step"]) == 7

    CheckpointManager(str(tmp_path / "port")).save(6, tparams, topt)
    jp, jo, jstep, _ = JManager(str(tmp_path / "port")).restore(jparams, jopt)
    assert jstep == 6 and str(jnp.asarray(jp["w"]).dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jp["w"], np.float32),
                                  np.asarray(jparams["w"], np.float32))
    assert int(jo["step"]) == 7
