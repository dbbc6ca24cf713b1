"""The port's Dataset core (``chambers_tpu_torch/data/core.py``) against the
JAX package's: every combinator streams the same elements, of the same
dtypes, in the same order, for the same numpy-seeded inputs and seeds
(exact equality), and reports the same cardinality."""

import numpy as np
import pytest

from chambers_tpu.data import core as jcore
from chambers_tpu_torch.data import core as tcore
from chambers_tpu_torch.data.core import (
    AUTOTUNE,
    INFINITE_CARDINALITY,
    UNKNOWN_CARDINALITY,
    Dataset,
)


def assert_same(a, b):
    """Equal values, types and dtypes, recursively through tuples."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (23, 4, 3), np.uint8),
            rng.randn(23).astype(np.float32), rng.randint(0, 5, 23))


def _child(D, x):
    n = int(np.asarray(x).ravel()[0]) % 4 + 1
    return D.from_tensor_slices(np.full(n, int(np.asarray(x).ravel()[0])))


PIPELINES = {
    "slices": lambda D: D.from_tensor_slices(_data()[0]),
    "slices_tuple": lambda D: D.from_tensor_slices(_data()),
    "range": lambda D: D.range(3, 17, 2),
    "map": lambda D: D.from_tensor_slices(_data()).map(
        lambda x, f, y: (x[::-1] + 1, f * 2, y)),
    "map_threads": lambda D: D.from_tensor_slices(_data()).map(
        lambda x, f, y: (x.sum(), y), num_parallel_calls=4),
    "map_autotune": lambda D: D.range(40).map(lambda x: x * x,
                                              num_parallel_calls=AUTOTUNE),
    "batch": lambda D: D.from_tensor_slices(_data()).batch(5),
    "batch_drop": lambda D: D.from_tensor_slices(_data()).batch(
        5, drop_remainder=True),
    "unbatch": lambda D: D.from_tensor_slices(_data()).batch(4).unbatch(),
    "shuffle": lambda D: D.from_tensor_slices(_data()).shuffle(
        8, seed=3).repeat(3),
    "shuffle_full": lambda D: D.range(50).shuffle(50, seed=42).repeat(2),
    "shuffle_no_reshuffle": lambda D: D.range(30).shuffle(
        30, seed=7, reshuffle_each_iteration=False).repeat(3),
    "shuffle_small_buffer": lambda D: D.range(100).shuffle(5, seed=0),
    "repeat_take_skip": lambda D: D.range(7).repeat().skip(3).take(20),
    "concatenate": lambda D: D.range(3).concatenate(D.range(10, 14)),
    "zip": lambda D: D.zip((D.range(5), D.from_tensor_slices(_data()[1]))),
    "enumerate": lambda D: D.from_tensor_slices(_data()[2]).enumerate(5),
    "shard": lambda D: D.from_tensor_slices(_data()).shard(3, 1),
    "flat_map": lambda D: D.range(6).flat_map(lambda x: D.range(int(x))),
    "interleave": lambda D: D.range(9).interleave(
        lambda x: _child(D, x), cycle_length=3, block_length=2),
    "interleave_shuffled": lambda D: D.range(12).shuffle(
        12, seed=1).interleave(lambda x: _child(D, x), cycle_length=4,
                               block_length=3).batch(6),
    "prefetch": lambda D: D.from_tensor_slices(_data()).map(
        lambda x, f, y: (x, y), num_parallel_calls=3).prefetch(2),
    "prefetch_autotune": lambda D: D.range(100).prefetch(),
    "filter": lambda D: D.range(30).filter(lambda x: x % 3 == 0),
    "cache": lambda D: D.range(5).map(lambda x: x + 1).cache().repeat(2),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_streams_equal_jax(name):
    make = PIPELINES[name]
    want_ds, got_ds = make(jcore.Dataset), make(Dataset)
    want, got = list(want_ds), list(got_ds)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert_same(a, b)
    assert got_ds.cardinality() == want_ds.cardinality()
    # re-iterable: a second pass is the next epoch, as in JAX
    for a, b in zip(list(got_ds), list(want_ds)):
        assert_same(a, b)


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_cardinality_is_what_streams_or_a_sentinel(name):
    ds = PIPELINES[name](Dataset)
    n = ds.cardinality()
    assert n >= 0 or n in (INFINITE_CARDINALITY, UNKNOWN_CARDINALITY)
    if n >= 0:
        assert sum(1 for _ in ds) == n


def test_sentinels_and_autotune_are_jax_values():
    assert (tcore.AUTOTUNE, tcore.INFINITE_CARDINALITY,
            tcore.UNKNOWN_CARDINALITY) == (jcore.AUTOTUNE,
                                           jcore.INFINITE_CARDINALITY,
                                           jcore.UNKNOWN_CARDINALITY)


def test_unseeded_shuffle_is_a_permutation():
    out = [int(x) for x in Dataset.range(20).shuffle(20)]
    assert sorted(out) == list(range(20))


def test_length_mismatch_raises():
    with pytest.raises(ValueError):
        Dataset.from_tensor_slices((np.arange(3), np.arange(4)))


def test_map_and_prefetch_propagate_errors():
    def bad(x):
        if x == 5:
            raise RuntimeError("boom")
        return x

    with pytest.raises(RuntimeError, match="boom"):
        list(Dataset.range(10).map(bad, num_parallel_calls=4))

    def gen():
        yield 1
        raise RuntimeError("producer failed")

    with pytest.raises(RuntimeError, match="producer failed"):
        list(Dataset.from_generator(gen).prefetch(2))


def test_abandoned_prefetch_releases_its_thread():
    import threading

    before = threading.active_count()
    it = iter(Dataset.range(10 ** 6).prefetch(2))
    assert next(it) == 0
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


def test_cache_commits_only_a_complete_pass():
    calls = []

    def gen():
        for i in range(3):
            calls.append(i)
            yield i

    ds = Dataset.from_generator(gen).cache()
    assert [int(x) for x in ds.take(2)] == [0, 1]
    assert [int(x) for x in ds] == [0, 1, 2]
    assert [int(x) for x in ds] == [0, 1, 2]
    assert calls == [0, 1, 0, 1, 2]  # the third pass came from the cache


def test_shard_and_zip_validate_arguments():
    with pytest.raises(ValueError):
        Dataset.range(4).shard(0, 0)
    with pytest.raises(ValueError):
        Dataset.range(4).shard(2, 2)
    with pytest.raises(ValueError, match="at least one"):
        Dataset.zip(())
