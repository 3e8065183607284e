"""PyTorch port: recompute in backward where the reference checkpoints.

The reference wraps three regions in ``jax.checkpoint``: each chunk of
``SSM_CHUNK`` Mamba1 steps (``repro/models/ssm.py:92-110``), each MoE token
group of ``MOE_GROUP`` tokens (``repro/models/layers.py:394-405``) and each
Zamba2 group of ``attn_every`` SSM blocks plus the shared attention block
(``repro/models/lm.py:170-188``). The port recomputes the same regions
(``layers.recompute``). Values do not change; what autograd keeps does.

* Mamba1's ``mamba1_scan`` over two chunks (S = 512) and one (S = 300): the
  loss, y, the final state and the gradient of every parameter, of x and
  of h0 against ``jax.grad`` of the reference's, at 2e-4 (the bound of
  ``tests/test_torch_models.py`` for this scan: 512 dependent fp32 steps),
  gradients relative to their largest magnitude; in the port, chunks of
  256 and one chunk of S give bit-identical values and gradients.
* ``moe_ffn`` with ``MOE_GROUP`` = 64 in both packages (256 tokens: four
  groups, capacity dropping slots): output and every gradient at 1e-4.
* Zamba2 (smoke widths, five layers: two groups and a tail layer): the loss
  and every gradient against the reference's; each grouped SSM block runs
  three times (forward, the group's recompute, its own), the tail layer's
  twice, the shared attention twice a group; remat and no remat give
  bit-identical gradients.
* What autograd keeps outside the recomputed regions after a forward
  (``saved_tensors_hooks``, which a checkpoint's own hooks override inside
  it): no per-step (B, d_inner, N) state of the scan, only a state a chunk;
  no per-group (slots, D) dispatch tensor, (E * C + 1, D) buffer or
  (E, C, F) GLU intermediate of the MoE, on plain tensors and on a sharded
  layer's pieces (a fake 2x2 group, meta tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi, layers as JL, ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.launch import steps
from repro_torch.models import api as tapi, layers as TL, ssm as tssm

SCAN_TOL = 2e-4
MOE_TOL = 1e-4
GRAD_REL = 1e-3       # tests/test_torch_train.py's bound for a whole model's gradient


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of small ops: with several test workers on one host, the
    default intra-op pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, grad=False):
    """Within ``tol`` (relative and absolute); a gradient's absolute bound
    is ``tol`` times its largest magnitude (a sum over many positions)."""
    want = np.asarray(want, np.float32)
    atol = tol * max(float(np.abs(want).max()), 1e-30) if grad else tol
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol, atol=atol)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in tree.items()}


class _Kept:
    """Shapes of the tensors autograd keeps outside any recomputed region
    while it is entered (a DTensor by its local shape)."""

    def __init__(self):
        self.shapes = []
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, lambda t: t)

    def _pack(self, t):
        local = t.to_local() if hasattr(t, "to_local") else t
        self.shapes.append(tuple(local.shape))
        return t

    def __enter__(self):
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        return self._hooks.__exit__(*exc)

    def count(self, shape) -> int:
        return sum(s == tuple(shape) for s in self.shapes)


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------


def _scan_inputs(S, seed=4):
    cfg = jconfigs.get_smoke_config("falcon_mamba_7b")
    p = jssm.mamba1_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, cfg.d_inner)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.d_inner, cfg.ssm_state)).astype(np.float32)
    wy = rng.standard_normal((2, S, cfg.d_inner)).astype(np.float32)
    wh = rng.standard_normal((2, cfg.d_inner, cfg.ssm_state)).astype(np.float32)
    return cfg, p, x, h0, wy, wh


def _port_scan(p, x, h0, wy, wh):
    """(loss, y, h, {name: gradient}) of the port's scan, x and h0 among
    the names."""
    tp = _torch(p)
    tx, th0 = (torch.from_numpy(a).requires_grad_(True) for a in (x, h0))
    y, h = tssm.mamba1_scan(tp, tx, th0)
    loss = (y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()
    names = [*tp, "x", "h0"]
    grads = torch.autograd.grad(loss, [*tp.values(), tx, th0], allow_unused=True)
    return loss, y, h, dict(zip(names, grads))


@pytest.mark.parametrize("S", [512, 300], ids=["two_chunks", "one_chunk"])
def test_mamba1_scan_and_gradients_match_reference(S, monkeypatch):
    assert tssm.SSM_CHUNK == jssm.SSM_CHUNK == 256
    cfg, p, x, h0, wy, wh = _scan_inputs(S)

    def ref(p, x, h0):
        y, h = jssm.mamba1_scan(p, x, h0)
        return (y * wy).sum() + (h * wh).sum(), (y, h)

    (jl, (jy, jh)), jg = jax.value_and_grad(ref, argnums=(0, 1, 2), has_aux=True)(
        p, jnp.asarray(x), jnp.asarray(h0))
    want = {**jg[0], "x": jg[1], "h0": jg[2]}
    loss, y, h, grads = _port_scan(p, x, h0, wy, wh)
    _close(loss, jl, SCAN_TOL)
    _close(y, jy, SCAN_TOL)
    _close(h, jh, SCAN_TOL)
    used = {k for k, g in grads.items() if g is not None}
    assert used == {"x_proj", "dt_proj", "dt_bias", "A_log", "D", "x", "h0"}, used
    for k in used:
        _close(grads[k], want[k], SCAN_TOL, grad=True)
    # one chunk of S steps: the same steps in the same order, bit for bit
    monkeypatch.setattr(tssm, "SSM_CHUNK", S)
    one = _port_scan(p, x, h0, wy, wh)
    assert all(torch.equal(a, b) for a, b in zip((loss, y, h), one[:3]))
    assert all(torch.equal(grads[k], one[3][k]) for k in used)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def test_moe_groups_and_gradients_match_reference(monkeypatch):
    monkeypatch.setattr(JL, "MOE_GROUP", 64)
    monkeypatch.setattr(TL, "MOE_GROUP", 64)
    cfg = jconfigs.get_smoke_config("qwen3_moe_30b_a3b")
    p = JL.moe_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64, cfg.d_model)).astype(np.float32)      # 4 groups of 64
    w = rng.standard_normal(x.shape).astype(np.float32)

    def ref(p, x):
        y = JL.moe_ffn(cfg, p, x)
        return (y * w).sum(), y

    (jl, jy), jg = jax.value_and_grad(ref, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))

    tp, tx = _torch(p), torch.from_numpy(x).requires_grad_(True)
    calls = []
    group = TL._moe_group
    monkeypatch.setattr(TL, "_moe_group", lambda *a: calls.append(1) or group(*a))
    y = TL.moe_ffn(tconfigs.get_smoke_config("qwen3_moe_30b_a3b"), tp, tx)
    loss = (y * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, [*tp.values(), tx])
    assert len(calls) == 8      # four groups, each once more in backward
    _close(loss, jl, MOE_TOL)
    _close(y, jy, MOE_TOL)
    for got, want in zip(grads, [*(jg[0][k] for k in tp), jg[1]]):
        _close(got, want, MOE_TOL, grad=True)


# ---------------------------------------------------------------------------
# Zamba2
# ---------------------------------------------------------------------------


def test_zamba2_groups_recompute_and_match_reference(monkeypatch):
    """Five layers at attn_every 2: two groups and a tail layer."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("zamba2_7b"), n_layers=5)
    cfg = dataclasses.replace(tconfigs.get_smoke_config("zamba2_7b"), n_layers=5)
    assert cfg.attn_every == 2
    params = japi.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = tapi.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    batch = japi.make_train_batch(jcfg, 2, 16, np.random.default_rng(0))
    tb = {k: torch.from_numpy(np.array(v, np.int32)) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(lambda p: japi.loss_fn(jcfg, p, batch))(params)

    calls = {"ssm": 0, "attn": 0}
    block, flash = tssm.mamba2_block, TL._flash

    def ssm(*a):
        calls["ssm"] += 1
        return block(*a)

    def attn(*a):
        calls["attn"] += 1
        return flash(*a)

    monkeypatch.setattr(tssm, "mamba2_block", ssm)
    monkeypatch.setattr(TL, "_flash", attn)
    tl, tg = steps.value_and_grad(cfg, model, tb)
    assert calls == {"ssm": 3 * 4 + 2 * 1, "attn": 2 * 2}, calls
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    grads = type(model)(tg, cfg)
    for path, want in jax.tree_util.tree_flatten_with_path(jg)[0]:
        keys = [q.key for q in path]
        if keys[0] == "layers":
            got = torch.stack([_leaf(lp, keys[1:]) for lp in grads.tree()["layers"]])
        else:
            got = _leaf(grads.tree(), keys)
        _close(got, want, GRAD_REL, grad=True)
    # the same gradient without remat, bit for bit
    plain = torch.autograd.grad(tapi.loss_fn(cfg, model, tb, remat=False),
                                list(model.parameters()))
    model.requires_grad_(True)
    remat = torch.autograd.grad(tapi.loss_fn(cfg, model, tb), list(model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# what autograd keeps
# ---------------------------------------------------------------------------


def test_scan_keeps_one_state_a_chunk():
    cfg, p, x, h0, _, _ = _scan_inputs(512)
    tp = _torch(p)
    with _Kept() as kept:
        tssm.mamba1_scan(tp, torch.from_numpy(x).requires_grad_(True), torch.from_numpy(h0))
    state = (2, cfg.d_inner, cfg.ssm_state)
    # a chunk's starting state (the checkpoint's input) only: each step's
    # exp(dt A), dt B x and new state stay inside its chunk
    assert kept.count(state) == 512 // tssm.SSM_CHUNK, kept.shapes


def _moe_kept_shapes(cfg, T, E_loc, K):
    """A group's (or piece's) dispatch tensors, by shape: its gathered
    slots (T K, D), its buffer (E C + 1, D) and (E, C, D), its GLU
    intermediates (E, C, F)."""
    C = TL._capacity(cfg, T)
    return [(T * K, cfg.d_model), (E_loc * C + 1, cfg.d_model), (E_loc, C, cfg.d_model),
            (E_loc, C, cfg.d_expert_ff)]


def test_moe_keeps_no_group_dispatch_tensor(monkeypatch):
    monkeypatch.setattr(TL, "MOE_GROUP", 64)
    cfg = tconfigs.get_smoke_config("qwen3_moe_30b_a3b")
    p = JL.moe_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    x = np.random.default_rng(3).standard_normal((256, cfg.d_model)).astype(np.float32)
    with _Kept() as kept:
        TL.moe_ffn(cfg, _torch(p), torch.from_numpy(x).requires_grad_(True)[None])
    for shape in _moe_kept_shapes(cfg, 64, cfg.n_experts, cfg.top_k):
        assert kept.count(shape) == 0, (shape, kept.shapes)
    assert kept.count((64, cfg.d_model)) == 4       # each group's tokens, its input


def test_sharded_moe_pieces_keep_no_dispatch_tensor(monkeypatch):
    """A 2x2 fake group, meta tensors: 64 tokens over 2 data ranks, groups
    of 8, so 4 pieces a rank; experts split over 'model'."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import dryrun, sharding as shd
    from repro_torch.launch.mesh import make_mesh

    monkeypatch.setattr(TL, "MOE_GROUP", 8)
    cfg = tconfigs.get_smoke_config("qwen3_moe_30b_a3b")
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        p = TL.moe_params(cfg, torch.Generator().manual_seed(0))
        place = lambda t, pl: shd.place(t.to("meta"), pl, mesh).requires_grad_(True)
        p = {"router": place(p["router"], [Replicate(), Replicate()]),
             **{k: place(p[k], [Replicate(), Shard(0)]) for k in ("w_gate", "w_up", "w_down")}}
        x = place(torch.zeros(4, 16, cfg.d_model, dtype=torch.bfloat16), [Shard(0), Replicate()])
        calls = []
        dispatch = TL._dispatch
        monkeypatch.setattr(TL, "_dispatch", lambda *a: calls.append(1) or dispatch(*a))
        with implicit_replication(), TL.mesh_hints(mesh), _Kept() as kept:
            out = TL.moe_ffn(cfg, p, x)
        assert out.shape == (4, 16, cfg.d_model) and len(calls) == 4
    for shape in _moe_kept_shapes(cfg, 8, cfg.n_experts // 2, cfg.top_k):
        assert kept.count(shape) == 0, (shape, kept.shapes)
    assert kept.count((8, cfg.d_model)) == 4        # each piece's tokens, its input


def test_recompute_sees_the_forward_mesh_hints_on_another_thread():
    """Autograd runs a CUDA backward on a thread of its own, where context
    variables are unset; the recomputation still sees the forward's mesh
    hints (here the backward runs on a new thread)."""
    import threading

    hints = ("mesh", {"data": 2, "model": 2})
    seen = []

    def fn(x):
        seen.append(TL._MESH_HINTS.get())
        return x.sin() * 2

    token = TL._MESH_HINTS.set(hints)
    try:
        x = torch.linspace(-1, 1, 5, requires_grad=True)
        y = TL.recompute(fn, x)
    finally:
        TL._MESH_HINTS.reset(token)
    grads = []
    t = threading.Thread(target=lambda: grads.append(torch.autograd.grad(y.sum(), x)[0]))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert seen == [hints, hints]        # the forward and its recomputation
    torch.testing.assert_close(grads[0], 2 * torch.cos(x.detach()), rtol=0, atol=0)
