"""PyTorch port: the token pipeline (``data/pipeline.py``).

``TestData`` of ``tests/test_substrate.py`` on the port, and its batches
held bit-equal to the reference's (``SyntheticLM`` at several seeds, steps
and host shards; ``MemmapTokens`` on one file), so a run of either package
sees the same tokens.
"""
import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data.pipeline import MemmapTokens, ShardInfo, SyntheticLM, write_token_file

rng = np.random.default_rng(0)


@pytest.mark.parametrize("seed,step,host,n_hosts", [(0, 0, 0, 1), (3, 10, 0, 1),
                                                    (1, 7, 2, 4), (5, 123, 1, 2)])
def test_synthetic_batches_equal_reference(seed, step, host, n_hosts):
    mine = SyntheticLM(300, 8, 24, seed=seed, shard=ShardInfo(host, n_hosts))
    ref = jpipe.SyntheticLM(300, 8, 24, seed=seed, shard=jpipe.ShardInfo(host, n_hosts))
    got, want = mine.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(next(mine.iterate(step))["tokens"], want)
    assert mine.state(step) == ref.state(step)


def test_memmap_batches_equal_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    write_token_file(path, rng.integers(0, 1000, (50 * 9,)))
    for host in (0, 1):
        mine = MemmapTokens(path, batch=4, seq=8, shard=ShardInfo(host, 2))
        ref = jpipe.MemmapTokens(path, batch=4, seq=8, shard=jpipe.ShardInfo(host, 2))
        for step in (0, 3, 11):
            np.testing.assert_array_equal(mine.batch_at(step)["tokens"],
                                          ref.batch_at(step)["tokens"])


def test_determinism_across_restart():
    b10 = SyntheticLM(vocab=64, batch=8, seq=16, seed=3).batch_at(10)
    np.testing.assert_array_equal(
        b10["tokens"], SyntheticLM(vocab=64, batch=8, seq=16, seed=3).batch_at(10)["tokens"])


def test_host_shards_disjoint_union():
    parts = [SyntheticLM(vocab=64, batch=8, seq=4, seed=3, shard=ShardInfo(h, 4))
             for h in range(4)]
    assert {p.local_batch for p in parts} == {2}


def test_memmap_backend(tmp_path):
    toks = rng.integers(0, 100, (40 * 17,)).astype(np.int32)
    path = str(tmp_path / "tokens.bin")
    write_token_file(path, toks)
    b = MemmapTokens(path, batch=4, seq=16).batch_at(0)
    assert b["tokens"].shape == (4, 17)
    np.testing.assert_array_equal(b["tokens"][0], toks[:17])
