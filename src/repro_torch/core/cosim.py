"""Application-level co-simulation (Section 2.3.2 / Table 4).

Trains the Section-4.2 applications on deterministic synthetic tasks (no
WikiText-2 / CIFAR-10 offline — DESIGN.md §7), then evaluates the *compiled*
program three ways:

  reference  — fp32 on the host (the IR interpreter), Table 4 column 3
  original   — ILA co-simulation with the original numerics
               (HLSCNN 8-bit weights), column 4
  updated    — ILA co-simulation with the developers' fix
               (HLSCNN 16-bit weights), column 5

reproducing the paper's phenomenon: per-op errors of a few percent are fine
for FlexASR apps, but HLSCNN's 8-bit weight quantization collapses conv-net
accuracy, and the 16-bit update recovers it. Per-invocation statistics
(Executor.stats) provide the debugging data of the case study.

The IR interpreter is differentiable and ``torch.func.vmap``-able, so
training differentiates straight through the *same* program that is later
co-simulated. Parameters made by the JAX reference (numpy dicts) carry over
with :func:`params_to_torch`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve
from . import ir
from .codegen import Executor, to_numpy


def params_to_torch(
    params: Dict[str, np.ndarray], device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """Parameters as the reference makes them (``apps.build_*``,
    ``cosim.train_app``: name -> numpy array) as float32 tensors on
    ``device``."""
    dev = resolve(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev) for k, v in params.items()}


# ---------------------------------------------------------------------------
# tiny Adam (training substrate for the co-sim apps)
# ---------------------------------------------------------------------------


def adam_init(params):
    return {
        "m": {k: torch.zeros_like(v) for k, v in params.items()},
        "v": {k: torch.zeros_like(v) for k, v in params.items()},
        "t": 0,
    }


def adam_update(params, grads, state, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    t = state["t"] + 1
    m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in grads.items()}
    v = {k: b2 * state["v"][k] + (1 - b2) * g * g for k, g in grads.items()}
    new = {
        k: p - lr * (m[k] / (1 - b1 ** t)) / (torch.sqrt(v[k] / (1 - b2 ** t)) + eps)
        for k, p in params.items()
    }
    return new, {"m": m, "v": v, "t": t}


# ---------------------------------------------------------------------------
# synthetic tasks
# ---------------------------------------------------------------------------


def make_teacher_task(builder, input_shape, n=512, seed=7, teacher_seed=99, temp=0.5,
                      device: DeviceLike = None):
    """Teacher-student labels: a same-architecture random teacher guarantees
    the task is representable by the student (deterministic, no datasets)."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n,) + tuple(input_shape)).astype(np.float32)
    t_expr, t_params = builder(seed=teacher_seed)
    tp = params_to_torch(t_params, dev)

    def fwd(x):
        env = dict(tp)
        env["x"] = x
        return ir.interpret(t_expr, env, device=dev).reshape(-1)

    with torch.no_grad():
        logits = to_numpy(torch.func.vmap(fwd)(torch.from_numpy(X).to(dev)))
    # center per class over the dataset so the argmax labels are balanced
    # (a raw random teacher lets one class's bias dominate)
    logits = (logits - logits.mean(0)) / (logits.std(0) + 1e-6)
    y = np.argmax(logits / temp, axis=1)
    return X, y


def make_char_task(vocab=32, T=16, n=256, seed=7, order=1):
    """Deterministic-ish Markov text: learnable next-token prediction."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(vocab, 0.05), size=vocab)
    seqs = np.zeros((n, T + 1), np.int64)
    for i in range(n):
        s = rng.integers(vocab)
        for t in range(T + 1):
            seqs[i, t] = s
            s = rng.choice(vocab, p=trans[s])
    return seqs[:, :-1], seqs[:, 1:], trans


# ---------------------------------------------------------------------------
# training via the IR interpreter
# ---------------------------------------------------------------------------


def _xent(logits, y):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, y[..., None], dim=-1).mean()


def train_app(expr, params, X, y, steps=300, bs=32, lr=2e-3, seed=0, embed=None,
              device: DeviceLike = None):
    """Train by differentiating through the IR interpreter on ``device``.

    Minibatch indices (and the embedding init) are drawn from the same
    numpy generator, in the same order, as the reference; returns the
    trained parameters as numpy arrays."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)

    def fwd(p, x):
        env = dict(p)
        env["x"] = x
        return ir.interpret(expr, env, device=dev)

    def loss(p, xb, yb):
        if embed is not None:
            xe = p["_embed"][xb]                         # (bs, T, E)
            logits = torch.func.vmap(lambda s: fwd(p, s[:, None, :]))(xe)
            return _xent(logits, yb)
        logits = torch.func.vmap(lambda s: fwd(p, s))(xb)
        return _xent(logits.reshape(xb.shape[0], -1), yb)

    p = params_to_torch(params, dev)
    if embed is not None:
        p["_embed"] = torch.from_numpy(
            rng.standard_normal((embed[0], embed[1])).astype(np.float32) * 0.3
        ).to(dev)
    st = adam_init(p)
    grad = torch.func.grad(loss)
    n = len(X)
    for _ in range(steps):
        idx = rng.integers(0, n, bs)
        xb = torch.from_numpy(np.asarray(X[idx])).to(dev)
        yb = torch.from_numpy(np.asarray(y[idx], np.int64)).to(dev)
        g = grad(p, xb, yb)
        with torch.no_grad():
            p, st = adam_update(p, g, st, lr=lr)
    return {k: to_numpy(v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# co-simulation evaluation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CosimResult:
    application: str
    platform: str
    reference: float
    original: float
    updated: Optional[float]
    metric: str
    n_eval: int
    sim_seconds_per_point: float
    invocation_stats: Dict[str, float]


def _pipeline_batch(executor: Executor, batch_size: int) -> int:
    """Feed ``run_many`` through the pipelined/fused engines with at least
    two pack/sim chunks per minibatch — a single-chunk minibatch has nothing
    to overlap, so the pack worker would idle (the fused engine shares the
    pipelined prepare/dispatch split). No-op for synchronous engines
    (identical numerics either way: batch composition never changes
    per-sample results)."""
    if getattr(executor, "engine", None) in ("pipelined", "fused"):
        return max(batch_size, 2 * executor.pipeline_chunk)
    return batch_size


def _iter_batch_outputs(executor: Executor, program, env_batches):
    """Depth-1 minibatch lookahead over ``Executor.submit_many``: minibatch
    k+1 is submitted — its host packing starts on the pack worker — before
    minibatch k's deferred readback barrier is paid, so the pipeline never
    drains at minibatch boundaries. On synchronous engines ``submit_many``
    degenerates to ``run_many`` and this is a plain loop. Yields each
    minibatch's outputs in submission order (bit-identical to ``run_many``
    per minibatch)."""
    pending = None
    for envs in env_batches:
        sub = executor.submit_many(program, envs)
        if pending is not None:
            yield pending.result()
        pending = sub
    if pending is not None:
        yield pending.result()


def eval_classification(program, params, X, y, executor: Executor, n_eval=100, batch_size=16):
    """Co-simulated accuracy, evaluated in minibatches: each batch's
    accelerator invocations run through one batched simulator call per IR
    node (``Executor.run_many``), with per-sample numerics identical to
    sample-at-a-time evaluation. With a pipelined executor the minibatch is
    sized to keep its pack/sim pipeline full (host packing of one chunk
    overlaps simulation of the previous)."""
    correct = 0
    batch_size = _pipeline_batch(executor, batch_size)
    t0 = time.perf_counter()
    batches = [range(i0, min(i0 + batch_size, n_eval))
               for i0 in range(0, n_eval, batch_size)]
    env_batches = ([dict(params, x=X[i]) for i in idx] for idx in batches)
    for idx, outs in zip(batches, _iter_batch_outputs(executor, program, env_batches)):
        for out, i in zip(outs, idx):
            logits = to_numpy(out).reshape(-1)
            correct += int(np.argmax(logits) == y[i])
    dt = (time.perf_counter() - t0) / n_eval
    return correct / n_eval, dt


def eval_outputs(program, params, make_x, indices, executor: Executor,
                 batch_size=16):
    """Raw per-example output tensors for selected dataset rows.

    ``make_x(i)`` builds the input for dataset row ``i``; rows are evaluated
    in ``run_many`` minibatches (numerics identical to per-sample ``run``).
    Returns one ndarray per requested row, in ``indices`` order — the
    primitive under paired golden-vs-mutant statistics: both sides see the
    exact same rows, so every per-example delta is semantic, not sampling
    noise."""
    batch_size = _pipeline_batch(executor, batch_size)
    idx = list(indices)
    chunks = [idx[i0 : i0 + batch_size] for i0 in range(0, len(idx), batch_size)]
    env_batches = ([dict(params, x=make_x(i)) for i in chunk] for chunk in chunks)
    outs = []
    for batch_outs in _iter_batch_outputs(executor, program, env_batches):
        outs.extend(to_numpy(o) for o in batch_outs)
    return outs


def eval_perplexity(program, params, Xtok, Ytok, executor: Executor, n_eval=50, batch_size=16):
    emb = params["_embed"]
    nll, count = 0.0, 0
    batch_size = _pipeline_batch(executor, batch_size)
    t0 = time.perf_counter()
    model_params = {k: v for k, v in params.items() if k != "_embed"}
    batches = [range(i0, min(i0 + batch_size, n_eval))
               for i0 in range(0, n_eval, batch_size)]
    env_batches = ([dict(model_params, x=emb[Xtok[i]][:, None, :]) for i in idx]
                   for idx in batches)
    for idx, outs in zip(batches, _iter_batch_outputs(executor, program, env_batches)):
        for out, i in zip(outs, idx):
            logits = to_numpy(out)
            logp = logits - logits.max(-1, keepdims=True)
            logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
            nll += -logp[np.arange(len(Ytok[i])), Ytok[i]].sum()
            count += len(Ytok[i])
    dt = (time.perf_counter() - t0) / n_eval
    return float(np.exp(nll / count)), dt
