"""``chambers_tpu_torch.utils.data`` against ``chambers_tpu.utils.data``
(mirrors ``tests/test_eval_utils.py``): the Cartesian pair iteration and
the reshaping equal JAX's exactly; ``batch_predict_pairs`` scores within
1e-5 of JAX's in float32, on the CPU here (CUDA by default)."""

import numpy as np
import pytest
import torch

from chambers_tpu.layers import CosineSimilarity as JCosine
from chambers_tpu.utils import data as jdata
from chambers_tpu_torch.data import Dataset
from chambers_tpu_torch.data.core import UNKNOWN_CARDINALITY
from chambers_tpu_torch.layers import CosineSimilarity
from chambers_tpu_torch.utils import data
from chambers_tpu_torch.utils.ranking import score_matrix_to_binary_ranking
from test_torch_package import one_torch_thread  # noqa: F401


def _pair_cosine(inputs):
    a, b = inputs
    return CosineSimilarity()([a[:, None, :], b[None, :, :]])


def _jax_pair_cosine(inputs):
    a, b = inputs
    return JCosine()([a[:, None, :], b[None, :, :]])


@pytest.mark.parametrize("labels", [False, True])
@pytest.mark.parametrize("bq,bc", [(2, 3), (5, 7), (1, 1)])
def test_pair_iteration_equals_jax(bq, bc, labels):
    q, c = np.arange(5)[:, None], np.arange(7)[:, None]
    y = dict(yq=np.arange(5) % 2, yc=np.arange(7) % 3) if labels else {}
    got = list(data.pair_iteration_dataset(q, c, bq, bc, **y))
    want = list(jdata.pair_iteration_dataset(q, c, bq, bc, **y))
    assert len(got) == len(want) == -(-5 // bq) * -(-7 // bc)
    flat = lambda t: [a for part in t for a in (
        part if isinstance(part, tuple) else (part,))]
    for g, w in zip(got, want):
        for a, b in zip(flat(g), flat(w)):
            assert np.array_equal(a, b)
    assert isinstance(data.pair_iteration_dataset(q, c, bq, bc), Dataset)


def test_reshape_pair_predictions_equals_jax():
    nq, nc, bq, bc = 5, 7, 2, 3
    rng = np.random.RandomState(0)
    x = rng.randn(3 * 3, bq, bc).astype(np.float32)
    assert np.array_equal(data.reshape_pair_predictions(x, bq, bc, nq, nc),
                          jdata.reshape_pair_predictions(x, bq, bc, nq, nc))
    y = (np.repeat(np.arange(6), 3), np.arange(9))
    got = data.reshape_pair_predictions(x, bq, bc, nq, nc, y=y)
    want = jdata.reshape_pair_predictions(x, bq, bc, nq, nc, y=y)
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        assert np.array_equal(a, b)


def test_valid_cardinality():
    d = Dataset.from_tensor_slices(np.arange(10))
    assert data.valid_cardinality(d)
    assert not data.valid_cardinality(d.repeat())
    assert d.filter(lambda x: True).cardinality() == UNKNOWN_CARDINALITY
    assert not data.valid_cardinality(d.filter(lambda x: True))


@pytest.mark.parametrize("bq,bc", [(4, 3), (10, 7), (3, 2)])
def test_batch_predict_pairs_equals_jax(bq, bc):
    rng = np.random.RandomState(0)
    q = rng.randn(10, 8).astype(np.float32)
    c = rng.randn(7, 8).astype(np.float32)
    got = data.batch_predict_pairs(_pair_cosine, q, bq=bq, c=c, bc=bc,
                                   verbose=False, device="cpu")
    want = jdata.batch_predict_pairs(_jax_pair_cosine, q, bq=bq, c=c, bc=bc,
                                     verbose=False)
    assert got.shape == want.shape == (10, 7) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    direct = _pair_cosine([torch.from_numpy(q), torch.from_numpy(c)])
    np.testing.assert_allclose(got, direct.numpy(), rtol=0, atol=1e-5)


def test_batch_predict_pairs_self_and_labels(capsys):
    rng = np.random.RandomState(0)
    q = rng.randn(6, 4).astype(np.float32)
    yq = np.array([0, 0, 1, 1, 2, 2])
    scores, (yq_out, yc_out) = data.batch_predict_pairs(
        _pair_cosine, q, bq=4, yq=yq, device="cpu")
    assert "4/4" in capsys.readouterr().out
    want, (jyq, jyc) = jdata.batch_predict_pairs(_jax_pair_cosine, q, bq=4,
                                                 yq=yq, verbose=False)
    np.testing.assert_allclose(scores, want, rtol=0, atol=1e-5)
    assert np.array_equal(yq_out, jyq) and np.array_equal(yc_out, jyc)
    ranking = score_matrix_to_binary_ranking(
        torch.from_numpy(scores), torch.from_numpy(yq), torch.from_numpy(yq),
        remove_top1=True)
    assert tuple(ranking.shape) == (6, 5)


def test_batch_predict_pairs_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data.batch_predict_pairs(_pair_cosine, np.zeros((2, 2), np.float32),
                                 bq=2, verbose=False)
