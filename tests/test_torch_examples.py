"""PyTorch port: the examples (``python -m repro_torch.examples.<name>``)
run on the CPU at a small size, and refuse to fall back to it."""
import importlib

import pytest
import torch

EXAMPLES = {
    "quickstart": [],
    "serve_decode": [],
    "train_smollm": ["--steps", "40"],
    "numerics_codesign": ["--steps", "60", "--n", "4"],
}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of small ops: with several test workers on one host,
    torch's default intra-op thread pool per worker oversubscribes the
    cores and slows them by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu(name, tmp_path, capsys):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    argv = EXAMPLES[name] + ["--device", "cpu"]
    if name == "train_smollm":
        argv += ["--ckpt-dir", str(tmp_path)]
    out = mod.main(argv)
    text = capsys.readouterr().out
    if name == "quickstart":
        err, same = out
        assert same and 0 < err < 0.1
        assert "kernel (cpu) == ILA simulation: True" in text
    elif name == "serve_decode":
        assert out.shape == (4, 24) and "OK" in text
    elif name == "train_smollm":
        assert out.ckpt.all_steps() == [39] and "OK" in text
    else:
        assert all(0.0 <= a <= 1.0 for a in out) and "UPDATED design" in text


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_device_raises_when_cuda_absent(name, monkeypatch):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(EXAMPLES[name])
