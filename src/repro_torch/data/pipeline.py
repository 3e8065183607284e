"""Deterministic, resumable, per-host-sharded token pipeline.

A copy of ``repro/data/pipeline.py`` (pure numpy, so the batches are the
reference's bit for bit); the port keeps its own copy because it imports
nothing of the JAX package. The training step moves each batch to its device.

Two backends:
  * ``SyntheticLM``    — seeded Markov-chain token stream (no dataset files
    offline; DESIGN.md §7). Fully deterministic given (seed, step, shard).
  * ``MemmapTokens``   — flat binary token file (np.memmap), strided per
    host shard; the production path.

Determinism contract: ``batch_at(step)`` is a pure function of
(seed, step, host_shard), so a restarted job that resumes from checkpoint
step k sees exactly the batches it would have seen — required for
fault-tolerant restart (runtime/trainer.py) and elastic re-sharding (a
host's stream depends only on its shard index, not on wall-clock history).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class ShardInfo:
    host_id: int = 0
    n_hosts: int = 1


class SyntheticLM:
    """Markov-chain synthetic text; vocabulary-sized transition table."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 shard: ShardInfo = ShardInfo()):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.shard = shard
        base = np.random.default_rng(seed)
        # shared transition structure so the task is learnable
        self._trans_logits = base.standard_normal((min(vocab, 512),)).astype(np.float32)

    @property
    def local_batch(self) -> int:
        assert self.batch % self.shard.n_hosts == 0
        return self.batch // self.shard.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """(local_batch, seq+1) tokens; pure function of (seed, step, shard)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4099 + self.shard.host_id
        )
        b = self.local_batch
        toks = np.zeros((b, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        # cheap structured stream: x_{t+1} = (a*x_t + noise) mod vocab
        a = 6364136223846793005 % self.vocab or 1
        noise = rng.integers(0, 7, (b, self.seq))
        for t in range(self.seq):
            toks[:, t + 1] = (toks[:, t] * a + noise[:, t] + 1) % self.vocab
        return {"tokens": toks}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    def state(self, step: int) -> Dict:
        return {"kind": "synthetic", "seed": self.seed, "step": step}


class MemmapTokens:
    """Flat int32 token file; host h reads contiguous stripes h, h+n, ..."""

    def __init__(self, path: str, batch: int, seq: int, shard: ShardInfo = ShardInfo()):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.batch, self.seq, self.shard = batch, seq, shard
        self.per_sample = seq + 1
        self.n_samples = len(self.tokens) // self.per_sample

    @property
    def local_batch(self) -> int:
        return self.batch // self.shard.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b = self.local_batch
        idx = (step * self.batch + self.shard.host_id * b + np.arange(b)) % self.n_samples
        out = np.stack([
            self.tokens[i * self.per_sample : (i + 1) * self.per_sample] for i in idx
        ])
        return {"tokens": out.astype(np.int32)}

    def iterate(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def write_token_file(path: str, tokens: np.ndarray):
    np.asarray(tokens, np.int32).tofile(path)
