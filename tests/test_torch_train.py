"""PyTorch port: the training path against the JAX reference.

* ``api.loss_fn`` and its gradient for all ten smoke configs in fp32, on the
  reference's own weights (``params_from_numpy``) and batch: the loss within
  1e-5 relative, each gradient leaf within 1e-3 of its largest magnitude
  (both packages sum fp32 in other orders; measured: loss within 2e-7,
  leaves within 6e-6). The reference differentiates its pure-JAX attention;
  the port's ``layers.FlashAttention`` runs the kernel's function forward and
  differentiates the same plain attention in backward.
* ``FlashAttention``'s gradient equals autograd through the plain attention
  (dense, and chunked above ``CHUNK_THRESHOLD`` keys), and the chunked
  recompute equals the reference's ``_sdpa_chunked`` gradient.
* One train step (``launch.steps.make_train_step``) against the same step
  composed by hand from ``jax.value_and_grad(api.loss_fn)`` and
  ``repro.optim`` (the reference's own ``train_step`` needs a mesh and fails
  on this tree: ROADMAP.md, Queue 3).
* Remat recomputes each block's attention once more in backward, and a
  parameter that no gradient reaches makes the step raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs, optim as joptim
from repro.models import api as japi, layers as JL
from repro_torch import configs as tconfigs
from repro_torch.launch import steps
from repro_torch.models import api as tapi, layers as TL
from repro_torch.models.config import ShapeConfig
from repro_torch.optim.optimizers import tree_leaves

LOSS_REL, GRAD_REL = 1e-5, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of small ops: with several test workers on one host,
    torch's default intra-op thread pool per worker oversubscribes the
    cores and slows them by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, seed=0):
    cfg = jconfigs.get_smoke_config(arch)
    params = japi.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    model = tapi.params_from_numpy(tconfigs.get_smoke_config(arch),
                                   jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return cfg, params, model


def _batch(cfg, seed=0, B=2, S=16):
    batch = japi.make_train_batch(cfg, B, S, np.random.default_rng(seed))
    batch = {k: np.asarray(v, np.float32 if k == "frames" else np.int32)
             for k, v in batch.items()}
    return batch, {k: jnp.asarray(v) for k, v in batch.items()}, \
        {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _port_leaf(model, path):
    """The port's tensor at a reference tree path; stacked layer trees hold
    one port module per layer, so the leaf is the stack of them."""
    keys = [p.key for p in path]
    if keys[0] in tapi.STACKED:
        layers = model.tree()[keys[0]]
        node = []
        for lp in layers:
            for k in keys[1:]:
                lp = lp[k]
            node.append(lp)
        return torch.stack(node)
    node = model.tree()
    for k in keys:
        node = node[k]
    return node


def _tree_at(tree, path):
    """The leaf at a reference tree path in a tree of the same layout."""
    for p in path:
        tree = tree[p.key]
    return tree


def _assert_tree_close(model_tree_fn, jtree, rel):
    for path, want in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        got = model_tree_fn(path).detach().float().numpy()
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= rel * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_and_gradients_match_reference(arch):
    cfg, params, model = _pair(arch)
    _, jb, tb = _batch(cfg)
    jl, jg = jax.value_and_grad(lambda p: japi.loss_fn(cfg, p, jb))(params)
    tl, tg = steps.value_and_grad(model.cfg, model, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    grads = type(model)(tg, model.cfg)   # the gradient tree, addressable like the model
    _assert_tree_close(lambda path: _port_leaf(grads, path), jg, GRAD_REL)


# ---------------------------------------------------------------------------
# the differentiable kernel
# ---------------------------------------------------------------------------


def _qkv(B, S, Sk, H, Hkv, D, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).requires_grad_(True)
            for shape in ((B, S, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,shape", [(True, (2, 12, 12, 4, 2, 16)),
                                          (False, (1, 5, 9, 2, 2, 8)),
                                          (True, (1, 7, 7, 3, 1, 20))])
def test_flash_function_gradient_equals_plain(dtype, causal, shape):
    B, S, Sk, H, Hkv, D = shape
    q, k, v = _qkv(B, S, Sk, H, Hkv, D, dtype)
    scale = 1.0 / D ** 0.5
    g_out = torch.randn(B, S, H, D, generator=torch.Generator().manual_seed(1)).to(dtype)
    out = TL.FlashAttention.apply(q, k, v, causal, scale)
    got = torch.autograd.grad(out, (q, k, v), g_out)
    plain = TL._attend(q, k, v, causal, scale)
    want = torch.autograd.grad(plain, (q, k, v), g_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol, atol=tol)
    # through sdpa: the head-dim padding (D 20 -> 24) stays outside the Function
    torch.testing.assert_close(TL.sdpa(q, k, v, causal).float(), out.float(), rtol=0, atol=0)


def test_chunked_recompute_equals_dense_gradient(monkeypatch):
    monkeypatch.setattr(TL, "CHUNK_THRESHOLD", 32)
    monkeypatch.setattr(TL, "ATTN_CHUNK", 16)
    q, k, v = _qkv(1, 64, 64, 4, 2, 8, torch.float32, seed=2)
    for causal in (True, False):
        out = TL.sdpa(q, k, v, causal)
        got = torch.autograd.grad(out.square().sum(), (q, k, v))
        dense = TL._sdpa_dense(q, k, v, causal, scale=8 ** -0.5)
        want = torch.autograd.grad(dense.square().sum(), (q, k, v))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_chunked_gradient_matches_reference():
    """Above CHUNK_THRESHOLD keys both packages take the chunked recompute."""
    q, k, v = _qkv(1, 3072, 3072, 2, 1, 8, torch.float32, seed=3)
    assert k.shape[1] > TL.CHUNK_THRESHOLD == JL.CHUNK_THRESHOLD
    w = torch.randn(1, 3072, 2, 8, generator=torch.Generator().manual_seed(4))
    got = torch.autograd.grad((TL.sdpa(q, k, v, True) * w).sum(), (q, k, v))
    jq, jk, jv = (jnp.asarray(t.detach().numpy()) for t in (q, k, v))
    want = jax.grad(lambda a, b, c: (JL.sdpa(a, b, c, True) * jnp.asarray(w.numpy())).sum(),
                    argnums=(0, 1, 2))(jq, jk, jv)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_remat_recomputes_each_attention_once(monkeypatch):
    """Per step: one kernel forward per layer, one more in the backward's
    recompute (the card's gate reads 22 + 22 for TinyLlama), the same
    gradient either way; without remat, one per layer."""
    cfg, _params, model = _pair("tinyllama_1_1b")
    _, _, tb = _batch(cfg)
    calls = []
    flash = TL._flash
    monkeypatch.setattr(TL, "_flash", lambda *a: calls.append(1) or flash(*a))
    grads = {}
    for remat in (True, False):
        calls.clear()
        model.requires_grad_(True)
        loss = tapi.loss_fn(model.cfg, model, tb, remat=remat)
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
        assert len(calls) == (2 if remat else 1) * cfg.n_layers
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


def test_a_parameter_without_gradient_raises(monkeypatch):
    """The kernel's output outside autograd (what a ctypes launch gives on
    the card without the Function) leaves q/k/v untrained: the step says so."""
    cfg, _params, model = _pair("tinyllama_1_1b")
    _, _, tb = _batch(cfg)
    monkeypatch.setattr(TL.FlashAttention, "apply",
                        lambda q, k, v, c, s: TL._flash(q, k, v, c, s).detach())
    with pytest.raises(RuntimeError, match=r"no gradient reaches .*attn\.q"):
        steps.value_and_grad(model.cfg, model, tb)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_train_step_matches_hand_composed_reference(opt_name):
    _check_train_step("tinyllama_1_1b", opt_name)


def test_adafactor_step_matches_reference_on_moe_layer_stacks():
    """The config that picks Adafactor: DeepSeek-V3's stacked MLA and MoE
    leaves (expert stacks of (L, E, d, f)) factored as the reference's."""
    _check_train_step("deepseek_v3_671b", "adafactor")


def _check_train_step(arch, opt_name):
    cfg, params, model = _pair(arch, seed=2)
    _, jb, tb = _batch(cfg, seed=3)
    lr, warmup, total, step = 3e-3, 5, 50, 7
    # the reference's step, composed by hand (compiled: op by op it takes
    # tens of seconds on the MoE config)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: japi.loss_fn(cfg, p, jb)))(params)
    jg, jn = joptim.clip_by_global_norm(jg, 1.0)
    jlr = joptim.cosine_schedule(step, lr, warmup, total)
    jopt = joptim.make_optimizer(opt_name)
    jnew, jstate = jax.jit(jopt.update)(params, jg, jopt.init(params), jlr)

    fn = steps.make_train_step(model.cfg, ShapeConfig("t", 16, 2, "train"), optimizer=opt_name,
                               lr=lr, warmup=warmup, total_steps=total)
    topt = steps.optim.make_optimizer(opt_name)
    new, state, metrics = fn(model, topt.init(model.tree()), tb, step)
    assert abs(float(metrics["loss"]) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert abs(float(metrics["grad_norm"]) - float(jn)) <= 1e-5 * float(jn)
    assert abs(float(metrics["lr"]) - float(jlr)) <= 1e-6 * float(jlr)
    assert int(state["step"]) == 1 and new is not model
    # a step moves a weight by lr times its normalised gradient (about +-1 per
    # element where |g| >> eps), and Adafactor's first moment is that
    # normalised gradient too; where |g| lies within the packages' fp32 noise
    # of 0 (under 1e-4 of the leaf's largest), the normalised value is noise
    # as well and is not compared. Elsewhere both agree within 1% of the
    # leaf's largest value. AdamW's first moment is linear in g: held as g is.
    # Both factor and RMS-clip each stacked (L, ...) layer leaf whole (a
    # per-layer vector stacks into an (L, d) matrix, which is factored), and
    # Adafactor's second moment, linear in g^2, is held as g is; it lies in
    # the reference's stacked layout in both packages.
    flat_g = {jax.tree_util.keystr(p): np.abs(np.asarray(g)) for p, g in
              jax.tree_util.tree_flatten_with_path(jg)[0]}
    moved = jax.tree_util.tree_map(lambda a, b: a - b, jnew, params)
    m = type(model)(state["m"], model.cfg)
    pairs = [(moved, lambda path: _port_leaf(new, path) - _port_leaf(model, path))]
    if opt_name == "adafactor":
        pairs.append((jstate["m"], lambda path: _port_leaf(m, path)))
        _assert_tree_close(lambda path: _tree_at(state["v"], path), jstate["v"], GRAD_REL)
    else:
        _assert_tree_close(lambda path: _port_leaf(m, path), jstate["m"], GRAD_REL)
    for jtree, port in pairs:
        for path, want in jax.tree_util.tree_flatten_with_path(jtree)[0]:
            key = jax.tree_util.keystr(path)
            got = port(path).detach().float().numpy()
            want = np.asarray(want, np.float32)
            keep = flat_g[key] >= 1e-4 * flat_g[key].max()
            assert keep.any(), key
            err = float(np.abs(got - want)[keep].max())
            assert err <= 1e-2 * float(np.abs(want).max()), (key, err)
    for p in new.parameters():
        assert p.requires_grad and p.dtype == torch.float32


def test_microbatches_average_the_gradient():
    cfg, _params, model = _pair("granite_8b", seed=4)
    _, _, tb = _batch(cfg, seed=5, B=4)
    shape = ShapeConfig("t", 16, 4, "train")
    one = steps.make_train_step(model.cfg, shape, lr=1e-3, warmup=0, total_steps=10,
                                microbatches=1)
    two = steps.make_train_step(model.cfg, shape, lr=1e-3, warmup=0, total_steps=10,
                                microbatches=2)
    init = steps.optim.make_optimizer("adamw").init(model.tree())
    _, _, m1 = one(model, init, tb, 3)
    _, _, m2 = two(model, init, tb, 3)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5 * float(m1["loss"])
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) <= 1e-4 * float(m1["grad_norm"])
    assert steps.default_microbatches(model.cfg, shape) == 1
    assert steps.pick_optimizer(tconfigs.get_config("deepseek_v3_671b")) == "adafactor"
    assert steps.pick_optimizer(tconfigs.get_config("tinyllama_1_1b")) == "adamw"


def test_batch_to_keeps_the_tokens():
    b = steps.batch_to({"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)},
                       torch.device("cpu"))
    assert b["tokens"].dtype == torch.int32 and b["tokens"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert len(tree_leaves({"a": [b["tokens"]]})) == 1
