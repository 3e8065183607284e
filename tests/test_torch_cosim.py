"""PyTorch port: teacher task and training against the JAX reference.

``make_teacher_task`` labels agree with the reference's on at least 99% of
512 points (fp32 near-ties between classes may flip). ``train_app`` starts
from the same initial parameters and draws the same numpy minibatch
indices; after 30 steps the port's ideal accuracy on 128 points is within
0.05 of the reference's (fp32 sums in two frameworks drift a little over
the steps).
"""
import numpy as np
import pytest
import torch

from repro.core import apps as japps, cosim as jcosim, ir as jir
from repro_torch.core import apps as tapps, cosim as tcosim, ir as tir
from repro_torch.core.codegen import Executor as TExecutor


def _builder(mod):
    return lambda seed=0: mod.build_resmlp(seed=seed, layers=2)


@pytest.fixture(scope="module")
def task():
    Xj, yj = jcosim.make_teacher_task(_builder(japps), (16, 64), n=512)
    Xt, yt = tcosim.make_teacher_task(_builder(tapps), (16, 64), n=512, device="cpu")
    return Xj, yj, Xt, yt


def test_teacher_labels_agree(task):
    Xj, yj, Xt, yt = task
    np.testing.assert_array_equal(Xt, Xj)
    assert np.mean(yt == yj) >= 0.99


def _accuracy(mod, interp, expr, params, X, y, n=128, **kw):
    preds = [int(np.argmax(np.asarray(interp(expr, dict(params, x=X[i]), **kw)).reshape(-1)))
             for i in range(n)]
    return float(np.mean(np.asarray(preds) == y[:n]))


def test_training_tracks_reference(task):
    Xj, yj, _, _ = task
    expr_j, params = _builder(japps)()
    expr_t, params_t = _builder(tapps)()
    for k in params:
        np.testing.assert_array_equal(params_t[k], params[k])
    trained_j = jcosim.train_app(expr_j, params, Xj, yj, steps=30, lr=3e-3)
    trained_t = tcosim.train_app(expr_t, params, Xj, yj, steps=30, lr=3e-3, device="cpu")
    assert set(trained_t) == set(trained_j)
    acc_j = _accuracy(japps, jir.interpret, expr_j, trained_j, Xj, yj)
    acc_t = _accuracy(tapps, tir.interpret, expr_t, trained_t, Xj, yj, device="cpu")
    assert abs(acc_t - acc_j) <= 0.05, (acc_t, acc_j)
    # the parameters moved the same way: far closer to each other than to init
    for k in params:
        step = np.abs(trained_j[k] - params[k]).max()
        if step > 0:
            assert np.abs(trained_t[k] - trained_j[k]).max() <= 0.05 * step + 1e-6, k


def test_adam_update_matches_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32)}
    g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    sj, st = jcosim.adam_init(pj), tcosim.adam_init(pt)
    for _ in range(3):
        pj, sj = jcosim.adam_update(pj, {k: jnp.asarray(v) for k, v in g.items()}, sj, lr=1e-2)
        pt, st = tcosim.adam_update(pt, {k: torch.from_numpy(v) for k, v in g.items()}, st,
                                    lr=1e-2)
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6, atol=1e-7)


def test_eval_perplexity_runs_lstm_wlm():
    """The LSTM word-language-model path (embedding + perplexity) on the
    port's FlexASR co-simulation, against its own ideal column."""
    expr, params = tapps.build_lstm_wlm(seed=0, vocab=16, embed=16, hidden=16, T=8)
    Xtok, Ytok, _ = tcosim.make_char_task(vocab=16, T=8, n=4)
    trained = tcosim.train_app(expr, params, Xtok, Ytok, steps=2, bs=4, embed=(16, 16),
                               device="cpu")
    from repro_torch.core.compile import compile_program

    prog = compile_program(expr, targets=("flexasr",), flexible=True).program
    ppl_i, _ = tcosim.eval_perplexity(prog, trained, Xtok, Ytok, TExecutor("ideal", device="cpu"),
                                      n_eval=2)
    ppl_a, _ = tcosim.eval_perplexity(prog, trained, Xtok, Ytok, TExecutor("ila", device="cpu"),
                                      n_eval=2)
    assert np.isfinite(ppl_i) and np.isfinite(ppl_a)
    assert abs(ppl_a - ppl_i) / ppl_i < 0.2
