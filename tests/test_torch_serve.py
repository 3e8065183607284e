"""PyTorch port: the LM serving loop against the JAX reference.

``repro_torch.launch.serve.generate`` (prefill, then greedy decode over the
KV cache) returns the same token ids as the reference's loop in
``repro/launch/serve.py::serve_llm``, rebuilt here from ``repro.models.api``
calls, on the same fp32 weights. Greedy ids are compared exactly: the two
packages' logits agree within 1e-4 (``tests/test_torch_models.py``), far
inside the gap between the top two logits, which the test checks so that a
near-tie cannot flip an id. Seeded weights give nearly flat logits (gaps
of 1e-5 over 256 tokens), so both packages get the same final norm scaled
by ``SHARPEN``: the logits scale with it, and so do the gaps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import api as japi
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.launch import serve
from repro_torch.models import api as tapi

GEN = 12
SHARPEN = 64.0


def _reference_generate(cfg, params, prompt, gen):
    """serve_llm's loop: prefill, argmax, then gen - 1 decode steps; also
    the smallest top-1 vs top-2 logit gap met on the way."""
    B, P = prompt.shape
    cache = japi.init_cache(cfg, B, P + gen, dtype=jnp.float32)
    logits, cache = japi.prefill(cfg, params, jnp.asarray(prompt, jnp.int32), cache)
    gaps = []

    def pick(lg):
        top2 = np.sort(np.asarray(lg[:, -1]), axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        return jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)

    tok = pick(logits)
    outs = [tok]
    for i in range(gen - 1):
        logits, cache = japi.decode_step(cfg, params, cache, tok, P + i)
        tok = pick(logits)
        outs.append(tok)
    return np.concatenate([np.asarray(t) for t in outs], axis=1), min(gaps)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "smollm_360m"])
def test_generate_matches_reference_loop(arch):
    cfg = get_smoke_config(arch)
    params = japi.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params["final_norm"] = params["final_norm"] * SHARPEN
    model = tapi.params_from_numpy(tsmoke(arch), jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (3, 9))
    want, gap = _reference_generate(cfg, params, prompt, GEN)
    assert gap > 1e-3, f"near-tie ({gap}) at this seed: pick another"
    stats = {}
    got = serve.generate(model.cfg, model, torch.from_numpy(prompt), GEN, stats)
    assert got.shape == (3, GEN) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["decode_steps"] == GEN - 1 and stats["finite"]
    assert stats["prefill_launches"] == stats["decode_launches"] == 0   # plain versions on CPU


def test_generate_audio_starts_from_token_zero():
    cfg = tsmoke("whisper_base")
    model = tapi.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, tapi.AUDIO_ENC_FRAMES, cfg.d_model)).astype(np.float32))
    got = serve.generate(cfg, model, frames, 3)
    assert got.shape == (2, 3) and (got[:, 0] == 0).all()
    with pytest.raises(ValueError, match="gen"):
        serve.generate(cfg, model, frames, 0)


def test_cli_runs_on_cpu_and_refuses_cosim(capsys):
    tokens = serve.serve_llm(serve.argparse.Namespace(
        arch="smollm-360m", smoke=True, batch=2, prompt=6, gen=3, seed=0, device="cpu"))
    assert tokens.shape == (2, 3)
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode: 2 steps x2" in out
    with pytest.raises(SystemExit, match="Queue 1 item 13"):
        serve.main(["--arch", "smollm-360m", "--cosim", "resmlp"])
