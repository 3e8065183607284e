"""PyTorch port: optimizers, clipping, schedule and int8 compression.

``TestOptimizers`` and ``TestCompression`` of ``tests/test_substrate.py`` on
the port, and the port held to ``repro.optim`` on the same numpy inputs: one
AdamW and one Adafactor step, the global-norm clip and the cosine schedule
within 1e-6 relative (fp32 summed in another order), int8 compression bit
for bit (``torch.round`` and ``jnp.round`` both round half to even).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st  # property tests skip if absent

from repro import optim as joptim
from repro_torch import optim
from repro_torch.optim.optimizers import tree_leaves, tree_map

rng = np.random.default_rng(0)
REL = 1e-6


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, (got, want)


def _pair_tree(seed):
    """The same nested tree as jnp and torch: a layer stack is one stacked
    ``(L, ...)`` tree in the reference and a list of per-layer trees in the
    port (``lm.Model.tree()``)."""
    r = np.random.default_rng(seed)
    tree = {"w": r.standard_normal((6, 5)).astype(np.float32),
            "layers": {"b": r.standard_normal((2, 5)).astype(np.float32),
                       "k": r.standard_normal((2, 4, 3)).astype(np.float32)},
            "e": r.standard_normal((3, 4, 2)).astype(np.float32)}
    j = jax.tree_util.tree_map(jnp.asarray, tree)
    t = tree_map(torch.from_numpy, tree)
    t["layers"] = [tree_map(lambda a: a[i].clone(), t["layers"]) for i in range(2)]
    return j, t


def _leaves_close(got, want, rel=REL):
    """Every leaf of the port's tree against the reference's at its path
    (the reference orders dict keys; the port keeps insertion order); a
    list in the port's tree is stacked along the reference's layer axis."""
    def at(tree, keys):
        if isinstance(tree, list):
            return torch.stack([at(t, keys) for t in tree])
        return at(tree[keys[0]], keys[1:]) if keys else tree

    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert sum(np.asarray(w).size for _, w in flat) == sum(g.numel() for g in tree_leaves(got))
    for path, w in flat:
        g = at(got, [key.key for key in path])
        _close(g.float().numpy(), np.asarray(w, np.float32), rel)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_one_step_matches_reference(name):
    jp, tp = _pair_tree(1)
    jg, tg = _pair_tree(2)
    jopt, topt = joptim.make_optimizer(name), optim.make_optimizer(name)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):   # a few steps: the state carries over
        jp, js = jopt.update(jp, jg, js, lr=0.01)
        tp, ts = topt.update(tp, tg, ts, lr=0.01)
    _leaves_close(tp, jp)
    _leaves_close(ts["m"], js["m"])
    _leaves_close(ts["v"], js["v"])
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32


def test_bf16_params_stay_bf16():
    tp = {"w": torch.randn(4, 4).bfloat16()}
    new, state = optim.make_optimizer("adamw").update(
        tp, {"w": torch.randn(4, 4).bfloat16()}, optim.adamw_init(tp), lr=0.1)
    assert new["w"].dtype == torch.bfloat16 and state["m"]["w"].dtype == torch.float32


def test_clip_and_schedule_match_reference():
    jg, tg = _pair_tree(3)
    jg = jax.tree_util.tree_map(lambda a: a * 10, jg)
    tg = tree_map(lambda a: a * 10, tg)
    jc, jn = joptim.clip_by_global_norm(jg, 1.0)
    tc, tn = optim.clip_by_global_norm(tg, 1.0)
    _close(tn.numpy(), np.asarray(jn))
    _leaves_close(tc, jc)
    for step in (0, 1, 7, 20, 21, 55, 100, 150):
        _close(optim.cosine_schedule(step, 3e-3, 20, 100).numpy(),
               np.asarray(joptim.cosine_schedule(step, 3e-3, 20, 100)))
    assert optim.cosine_schedule(torch.tensor(5), 1.0, 0, 1).dtype == torch.float32


def test_int8_compression_bit_equal_to_reference():
    r = np.random.default_rng(4)
    for shape in ((100, 7), (256,), (3, 5, 9), (513,)):
        g = r.standard_normal(shape).astype(np.float32)
        g.reshape(-1)[:3] = [0.5, -0.5, 1.5]
        jq, js = joptim.compress_int8(jnp.asarray(g))
        tq, ts = optim.compress_int8(torch.from_numpy(g))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            optim.decompress_int8(tq, ts, shape).numpy(),
            np.asarray(joptim.decompress_int8(jq, js, shape)))
        res = r.standard_normal(shape).astype(np.float32) * 0.01
        jd, jr = joptim.error_feedback_update(jnp.asarray(g), jnp.asarray(res))
        td, tr = optim.error_feedback_update(torch.from_numpy(g), torch.from_numpy(res))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    zero = optim.compress_int8(torch.zeros(300))
    assert zero[0].abs().max() == 0 and (zero[1] == 1.0).all()


# ---------------------------------------------------------------------------
# TestOptimizers / TestCompression on the port
# ---------------------------------------------------------------------------


def _quadratic_grad(w):
    w = w.detach().requires_grad_(True)
    return {"w": torch.autograd.grad((w ** 2).sum(), w)[0]}


def test_adamw_reduces_quadratic():
    w = {"w": torch.tensor([3.0, -2.0])}
    opt = optim.make_optimizer("adamw")
    state = opt.init(w)
    for _ in range(200):
        w, state = opt.update(w, _quadratic_grad(w["w"]), state, lr=0.05, wd=0.0)
    assert float(w["w"].abs().max()) < 0.1


def test_adafactor_reduces_quadratic_matrix():
    w = {"w": torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))}
    opt = optim.make_optimizer("adafactor")
    state = opt.init(w)
    for _ in range(200):
        w, state = opt.update(w, _quadratic_grad(w["w"]), state, lr=0.1)
    assert float(w["w"].abs().max()) < 0.2


def test_adafactor_state_is_factored():
    state = optim.make_optimizer("adafactor").init({"w": torch.zeros(64, 32)})
    v = state["v"]["w"]
    assert set(v) == {"vr", "vc"}
    assert v["vr"].shape == (64,) and v["vc"].shape == (32,)
    assert v["vr"].numel() + v["vc"].numel() < 64 * 32 / 5
    assert state["m"]["w"].dtype == torch.bfloat16


def test_global_norm_clip():
    clipped, gn = optim.clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert float(gn) > 1.0
    np.testing.assert_allclose(float(clipped["a"].square().sum().sqrt()), 1.0, rtol=1e-4)


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError):
        optim.make_optimizer("sgd")


@given(st.integers(0, 5))
@settings(max_examples=5, deadline=None)
def test_error_feedback_unbiased_over_time(seed):
    r = np.random.default_rng(seed)
    g_true = torch.from_numpy(r.standard_normal((512,)).astype(np.float32))
    residual = torch.zeros_like(g_true)
    applied = torch.zeros_like(g_true)
    for _ in range(20):
        deq, residual = optim.error_feedback_update(g_true, residual)
        applied = applied + deq
    np.testing.assert_allclose((applied / 20).numpy(), g_true.numpy(), atol=0.02)


def test_roundtrip_shape():
    g = torch.from_numpy(rng.standard_normal((100, 7)).astype(np.float32))
    q, s = optim.compress_int8(g)
    out = optim.decompress_int8(q, s, g.shape)
    assert out.shape == g.shape
    assert float((out - g).abs().max()) < float(g.abs().max()) / 64
