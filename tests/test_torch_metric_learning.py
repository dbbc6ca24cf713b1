"""The port's miners, metric-learning losses and the metric-learning train
step against the JAX package's, in float32 on the CPU.

Tolerances: miner masks equal; losses and their gradients with respect to
the embeddings within 1e-5 (float32 sums in another order); the ViT step
within 1e-5 on the loss and the gradients and 1e-6 on the updated
parameters (JAX's AdamW on the same gradients; JAX's whole step where a
gradient is above 1e-5, see the test); bf16 losses keep JAX's dtype and
agree to 2^-6 relative (one or two bf16 steps: the two frameworks round
the products and the logsumexp at other places)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chambers_tpu import losses as jlosses
from chambers_tpu import miners as jminers
from chambers_tpu.layers.normalization import l2_normalize as jax_l2
from chambers_tpu.losses import metric_learning as jml
from chambers_tpu.models.backbones.vision_transformer import (
    VisionTransformer as JaxViT,
)
from chambers_tpu.optimizers import AdamW as JaxAdamW
from chambers_tpu_torch import losses as tlosses
from chambers_tpu_torch import miners as tminers
from chambers_tpu_torch.layers.normalization import l2_normalize
from chambers_tpu_torch.losses import metric_learning as tml
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from chambers_tpu_torch.models.backbones.vision_transformer import (
    VisionTransformer,
)
from chambers_tpu_torch.optimizers import AdamW
from test_torch_package import one_torch_thread  # noqa: F401

N, D = 12, 8


def _embeddings(seed=0, n=N, normalize=True):
    x = np.random.RandomState(seed).randn(n, D).astype(np.float32)
    if normalize:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


# labels: pairs and triples, a singleton (a row with no positive), and -1
# (negative-only samples, masked as columns)
LABELS = {
    "groups": np.arange(N) % 4,
    "singleton_and_negatives": np.array([0, 0, 1, 1, 1, 2, -1, -1, 3, 3, 4,
                                         0]),
    "all_distinct": np.arange(N),
    "all_same": np.zeros(N, np.int64),
}


@pytest.mark.parametrize("labels", sorted(LABELS))
@pytest.mark.parametrize("margin", [0.1, 0.5])
def test_miner_masks_equal(labels, margin):
    y = LABELS[labels]
    x = _embeddings(1)
    sim = x @ x.T
    pos = (y[:, None] == y[None, :]) & ~np.eye(N, dtype=bool)
    neg = (y[:, None] != y[None, :])
    want = jminers.MultiSimilarityMiner(margin)(jnp.asarray(sim),
                                                jnp.asarray(pos),
                                                jnp.asarray(neg))
    got = tminers.MultiSimilarityMiner(margin)(torch.from_numpy(sim),
                                               torch.from_numpy(pos),
                                               torch.from_numpy(neg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    miner = tminers.MultiSimilarityMiner.from_config(
        tminers.MultiSimilarityMiner(margin).get_config())
    assert miner.get_config() == jminers.MultiSimilarityMiner(
        margin).get_config()


def test_masked_reductions_of_an_empty_row():
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    mask = torch.tensor([[True, False], [False, False]])
    assert tminers.masked_max(x, mask).tolist() == [1.0, -np.inf]
    assert tminers.masked_min(x, mask).tolist() == [1.0, np.inf]


def _loss_pairs():
    return {
        "ms": lambda m: m.MultiSimilarityLoss(),
        "ms_no_miner": lambda m: m.MultiSimilarityLoss(miner=None),
        "ms_scales": lambda m: m.MultiSimilarityLoss(
            pos_scale=1.0, neg_scale=10.0, threshold=0.2),
        "ms_keep_diag_and_negatives": lambda m: m.MultiSimilarityLoss(
            ignore_diag=False, ignore_negative_labels=False),
        "contrastive": lambda m: m.ContrastiveLoss(),
        "contrastive_exponent": lambda m: m.ContrastiveLoss(
            positive_margin=0.8, negative_margin=0.1, exponent=3),
        "ntxent": lambda m: m.NTXentLoss(temperature=0.5, from_logits=True),
        "ntxent_probabilities": lambda m: m.NTXentLoss(),
    }


def _value_and_grad(loss_fn, labels, x, **call):
    want, jgrad = jax.value_and_grad(
        lambda e: loss_fn(jnp.asarray(labels), e, **call))(jnp.asarray(x))
    return np.asarray(want), np.asarray(jgrad)


@pytest.mark.parametrize("labels", sorted(LABELS))
@pytest.mark.parametrize("loss", sorted(_loss_pairs()))
def test_losses_and_gradients_match_jax(loss, labels):
    make = _loss_pairs()[loss]
    y, x = LABELS[labels], _embeddings(2, normalize=loss != "ms_scales")
    want, want_grad = _value_and_grad(make(jlosses), y, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = make(tlosses)(torch.from_numpy(y), xt)
    got.backward()
    np.testing.assert_allclose(got.item(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, atol=1e-5,
                               rtol=1e-5)
    assert np.isfinite(xt.grad.numpy()).all()


WEIGHTS = {
    "none": None,
    "scalar": 0.5,
    "vector": np.linspace(0.0, 2.0, N).astype(np.float32),
    "column": np.linspace(0.0, 2.0, N).astype(np.float32)[:, None],
}


@pytest.mark.parametrize("weight", sorted(WEIGHTS))
@pytest.mark.parametrize("reduction", ["sum_over_batch_size", "sum", "none",
                                       None, "auto"])
@pytest.mark.parametrize("loss", ["ms", "contrastive", "ntxent"])
def test_reductions_and_sample_weights(loss, reduction, weight):
    make = _loss_pairs()[loss]
    y, x = LABELS["singleton_and_negatives"], _embeddings(3)
    w = WEIGHTS[weight]
    jfn = make(jlosses)
    jfn.reduction = jlosses.Loss(reduction=reduction).reduction
    want = jfn(jnp.asarray(y), jnp.asarray(x),
               sample_weight=None if w is None else jnp.asarray(w))
    tfn = make(tlosses)
    tfn.reduction = tlosses.Loss(reduction=reduction).reduction
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(torch.from_numpy(y), xt,
              sample_weight=None if w is None else torch.from_numpy(
                  np.asarray(w)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    got.sum().backward()
    jgrad = jax.grad(lambda e: jnp.sum(jfn(
        jnp.asarray(y), e,
        sample_weight=None if w is None else jnp.asarray(w))))(
            jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               atol=1e-5, rtol=1e-5)


def test_unknown_reduction_raises():
    with pytest.raises(ValueError, match="reduction"):
        tlosses.MultiSimilarityLoss(reduction="mean")


@pytest.mark.parametrize("with_diag", [True, False])
def test_matrix_losses_match_jax(with_diag):
    """The Matrix variant on a precomputed similarity matrix and a binary
    pair matrix."""
    x = _embeddings(4)
    sim = x @ x.T
    pairs = (np.arange(N)[:, None] % 3 == np.arange(N)[None, :] % 3)
    pairs = pairs.astype(np.float32)
    jfn = jml.MultiSimilarityLossMatrix(ignore_diag=with_diag)
    tfn = tml.MultiSimilarityLossMatrix(ignore_diag=with_diag)
    want, want_grad = jax.value_and_grad(
        lambda s: jfn(jnp.asarray(pairs), s))(jnp.asarray(sim))
    st = torch.from_numpy(sim).requires_grad_(True)
    got = tfn(torch.from_numpy(pairs), st)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_grad),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("from_logits", [True, False])
def test_categorical_crossentropy_matches_jax(from_logits):
    rng = np.random.RandomState(5)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 7)]
    p = rng.rand(7, 5).astype(np.float32) + 0.01
    want = jml.categorical_crossentropy_per_row(jnp.asarray(y),
                                                jnp.asarray(p), from_logits)
    got = tml.categorical_crossentropy_per_row(torch.from_numpy(y),
                                               torch.from_numpy(p),
                                               from_logits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(
        tml.categorical_crossentropy(torch.from_numpy(y), torch.from_numpy(p),
                                     from_logits).item(),
        float(jml.categorical_crossentropy(jnp.asarray(y), jnp.asarray(p),
                                           from_logits)), rtol=1e-6)


@pytest.mark.parametrize("loss", ["ms", "contrastive"])
def test_bf16_embeddings_keep_jax_dtypes(loss):
    """In the bf16 train step the embeddings, the similarity matrix and the
    row losses are bf16 in both packages."""
    make = _loss_pairs()[loss]
    y, x = LABELS["groups"], _embeddings(6)
    jx = jax_l2(jnp.asarray(x, jnp.bfloat16))
    tx = l2_normalize(torch.from_numpy(x).to(torch.bfloat16))
    assert tx.dtype == torch.bfloat16 and jx.dtype == jnp.bfloat16
    jfn, tfn = make(jlosses), make(tlosses)
    jsim, tsim = jfn.compute_similarity_matrix(jx), \
        tfn.compute_similarity_matrix(tx)
    assert tsim.dtype == torch.bfloat16 and jsim.dtype == jnp.bfloat16
    want = jfn(jnp.asarray(y), jx)
    got = tfn(torch.from_numpy(y), tx)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().item(), float(want),
                               rtol=2 ** -6)


def _port_name(path):
    """The port's name of a JAX parameter path."""
    return ".".join(re.sub(r"^layers_(\d+)$", r"layers.\1", k.key)
                    for k in path)


def test_vit_metric_learning_step_matches_jax():
    """``bench.py``'s config 4 at a small size: a 2-layer, width-64 ViT
    embedder, the MS loss on its L2-normalized features and one AdamW step
    with ``decay_exclude=["bias", "norm"]``: the loss, every gradient and
    every updated parameter against JAX's, float32."""
    kw = dict(patch_size=16, patch_dim=64, n_encoder_layers=2, n_heads=2,
              ff_dim=128, dropout_rate=0.0, include_top=False, pooling="cls",
              feature_dim=16)
    jvit = JaxViT(**kw)
    x = np.random.RandomState(7).rand(8, 32, 32, 3).astype(np.float32)
    labels = np.arange(8) % 2
    params = jvit.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    jloss_fn = jlosses.MultiSimilarityLoss()

    def loss_of(p):
        z = jvit.apply({"params": p}, jnp.asarray(x), deterministic=True)
        return jloss_fn(jnp.asarray(labels), jax_l2(z, axis=-1))

    want_loss, jgrads = jax.value_and_grad(loss_of)(params)
    jopt = JaxAdamW(weight_decay=1e-4, learning_rate=1e-3,
                    decay_exclude=["bias", "norm"])
    updates, _ = jopt.update(jgrads, jopt.init(params), params)
    want_params = state_dict_from_jax(jax.device_get(
        optax.apply_updates(params, updates)))
    want_grads = state_dict_from_jax(jax.device_get(jgrads))

    model = VisionTransformer(16, 64, 2, 2, 128, dropout_rate=0.0,
                              image_size=(32, 32), include_top=False,
                              pooling="cls", feature_dim=16, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    model.train()
    opt = AdamW(model.named_parameters(), weight_decay=1e-4,
                learning_rate=1e-3, decay_exclude=["bias", "norm"])
    z = model(torch.from_numpy(x), deterministic=True)
    loss = tlosses.MultiSimilarityLoss()(torch.from_numpy(labels),
                                         l2_normalize(z, axis=-1))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert float(want_loss) > 0.1
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    # the same AdamW step of JAX's on the port's own gradients
    port_grads = {name: p.grad.numpy() for name, p in model.named_parameters()}
    jgrads_port = jax.tree_util.tree_map_with_path(
        lambda path, _: port_grads[_port_name(path)], params)
    updates, _ = jopt.update(jgrads_port, jopt.init(params), params)
    same_grads = state_dict_from_jax(jax.device_get(
        optax.apply_updates(params, updates)))
    opt.step()
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, same_grads[name].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
        # Adam's first direction is g / (|g| + 1e-7): where |g| is near
        # 1e-7 it turns the gradients' ~3e-8 absolute differences into
        # visible ones; elsewhere the end-to-end step agrees to 1e-6
        live = np.abs(want_grads[name].numpy()) > 1e-5
        np.testing.assert_allclose(got[live], want_params[name].numpy()[live],
                                   atol=1e-6, rtol=1e-6, err_msg=name)
