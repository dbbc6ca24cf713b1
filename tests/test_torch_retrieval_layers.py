"""The port's retrieval layers against the JAX package's, in float32 on the
CPU on the same numpy inputs: GeM and RoI pooling, R-MAC, the distance
layers, the op layers, ``L2Normalization`` and ``scaled_attention`` /
``ScaledAttention``.

Tolerances: 1e-6 (float32 sums and powers in another order), GeM's
gradients with respect to ``p`` and ``x`` included; exact where a layer
only selects: the RoI and R-MAC maxima, ``rmac_regions`` and its masks,
the arg-reductions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.layers import attention as jatt
from chambers_tpu.layers import descriptors as jdesc
from chambers_tpu.layers import distance as jdist
from chambers_tpu.layers import normalization as jnorm
from chambers_tpu.layers import ops as jops
from chambers_tpu.layers import pooling as jpool
from chambers_tpu_torch.layers import attention as tatt
from chambers_tpu_torch.layers import descriptors as tdesc
from chambers_tpu_torch.layers import distance as tdist
from chambers_tpu_torch.layers import normalization as tnorm
from chambers_tpu_torch.layers import ops as tops
from chambers_tpu_torch.layers import pooling as tpool
from test_torch_package import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# GeM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [3.0, 1.0, 4.5])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("trainable", [True, False])
def test_gem_and_its_gradients_match_jax(trainable, shared, p):
    # a ReLU map: zeros below the clip, one maximum
    x = np.maximum(_rand((2, 5, 4, 6), 1), 0.0)
    mod = jpool.GlobalGeneralizedMean(p=p, shared=shared,
                                      trainable=trainable)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def f(params, x):
        y = mod.apply({"params": params}, x)
        return jnp.sum(y * jnp.arange(1, y.size + 1).reshape(y.shape)), y

    (_, want), (g_params, g_x) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    layer = tpool.GlobalGeneralizedMean(p=p, shared=shared,
                                        trainable=trainable,
                                        channels=x.shape[-1], device="cpu")
    assert layer.p.shape == params["p"].shape
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt)
    assert y.dtype == torch.float32 and y.shape == (2, 6)
    (y * torch.arange(1, y.numel() + 1).reshape(y.shape)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), _np(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), _np(g_x), **TOL)
    if trainable:
        np.testing.assert_allclose(layer.p.grad.numpy(), _np(g_params["p"]),
                                   **TOL)
    else:
        assert layer.p.grad is None and not _np(g_params["p"]).any()


def test_gem_computes_in_float32_and_resets_p():
    layer = tpool.GlobalGeneralizedMean(p=2.0, device="cpu")
    with torch.no_grad():
        layer.p.fill_(5.0)
    layer.reset_parameters()
    assert float(layer.p.detach()) == 2.0
    x = torch.rand(1, 3, 3, 2).to(torch.bfloat16)
    assert layer(x).dtype == torch.float32
    with pytest.raises(ValueError, match="channels"):
        tpool.GlobalGeneralizedMean(shared=False, device="cpu")


# ---------------------------------------------------------------------------
# RoI pooling and R-MAC
# ---------------------------------------------------------------------------

def _rois(seed, b=2, r=5, h=9, w=11):
    rng = np.random.RandomState(seed)
    x0 = rng.randint(0, w - 1, (b, r))
    y0 = rng.randint(0, h - 1, (b, r))
    bw = rng.randint(1, w + 3, (b, r))
    bh = rng.randint(1, h + 3, (b, r))
    return np.stack([x0, y0, bw, bh], -1).astype(np.int32)


def test_roi_max_pool_is_exact():
    x, rois = _rand((2, 9, 11, 3), 2), _rois(3)
    want = jpool.RoiPooling()([jnp.asarray(x), jnp.asarray(rois)])
    got = tpool.RoiPooling()([torch.from_numpy(x), torch.from_numpy(rois)])
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(
        tpool.roi_max_pool(torch.from_numpy(x), torch.from_numpy(rois))
        .numpy(), _np(want))


@pytest.mark.parametrize("pool_list", [[1], [1, 2, 4], [3]])
def test_spatial_pyramid_roi_pool_is_exact(pool_list):
    """Fractional boxes exercise the half-to-even rounding of the cell
    edges (2.5 -> 2, 3.5 -> 4); tiny boxes leave empty cells, which are
    0."""
    x = _rand((2, 9, 11, 3), 4)
    rois = _rois(5).astype(np.float32)
    rois[0, 0] = [0.5, 1.5, 5.0, 3.0]
    rois[0, 1] = [2.0, 2.0, 1.0, 1.0]
    rois[1, 2] = [1.25, 0.5, 7.5, 6.5]
    want = jpool.RoiPooling_OG(pool_list)([jnp.asarray(x),
                                            jnp.asarray(rois)])
    got = tpool.RoiPooling_OG(pool_list, num_rois=5)(
        [torch.from_numpy(x), torch.from_numpy(rois)])
    assert got.shape == (2, 5, 3 * sum(n * n for n in pool_list))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    if 4 in pool_list:
        assert (got.numpy()[0, 1] == 0).any()  # empty cells


@pytest.mark.parametrize("W,H,L", [(7, 7, 3), (14, 9, 3), (9, 20, 4),
                                   (3, 30, 5), (16, 12, 1), (1, 4, 3)])
def test_rmac_regions_and_masks_are_exact(W, H, L):
    want = jdesc.rmac_regions(W, H, L)
    got = tdesc.rmac_regions(W, H, L)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdesc._region_masks(got, H, W),
                                  jdesc._region_masks(want, H, W))


@pytest.mark.parametrize("shape", [(2, 7, 7, 4), (2, 6, 10, 3),
                                   (1, 12, 5, 2)])
@pytest.mark.parametrize("scales", [1, 3])
def test_rmac_is_exact(shape, scales):
    x = _rand(shape, 6)
    want = jdesc.RMAC(scales)(jnp.asarray(x))
    layer = tdesc.RMAC(scales)
    got = layer(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    # a second call reuses the masks; another spatial size remakes them
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(),
                                  _np(want))
    y = _rand((1, shape[2], shape[1], shape[3]), 7)
    np.testing.assert_array_equal(layer(torch.from_numpy(y)).numpy(),
                                  _np(jdesc.RMAC(scales)(jnp.asarray(y))))


# ---------------------------------------------------------------------------
# distances, op layers, L2 normalization
# ---------------------------------------------------------------------------

DISTANCES = ["L1Distance", "L2Distance", "CosineSimilarity",
             "AngularCosineSimilarity", "CubicCosineSimilarity",
             "SqrtCosineSimilarity"]


@pytest.mark.parametrize("axis,keepdims", [(-1, False), (1, True),
                                           (0, False)])
@pytest.mark.parametrize("name", DISTANCES)
def test_distances_match_jax(name, axis, keepdims):
    a, b = _rand((4, 5, 6), 8), _rand((4, 5, 6), 9)
    want = getattr(jdist, name)(axis=axis, keepdims=keepdims)(
        [jnp.asarray(a), jnp.asarray(b)])
    got = getattr(tdist, name)(axis=axis, keepdims=keepdims)(
        [torch.from_numpy(a), torch.from_numpy(b)])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_matmul_matches_jax(ta, tb):
    a, b = _rand((3, 4, 5), 10), _rand((3, 4, 5), 11)
    a = a if ta else a.swapaxes(-1, -2)
    b = b.swapaxes(-1, -2) if tb else b
    want = jops.Matmul(ta, tb)([jnp.asarray(a), jnp.asarray(b)])
    got = tops.Matmul(ta, tb)([torch.from_numpy(a), torch.from_numpy(b)])
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("axis", [None, 0, -1, (0, 2), (), (-1, 1)])
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("name", ["Sum", "Prod", "Max", "Min"])
def test_reductions_match_jax(name, keepdims, axis):
    x = 0.5 + np.abs(_rand((3, 4, 5), 12))
    want = getattr(jops, name)(axis=axis, keepdims=keepdims)(jnp.asarray(x))
    got = getattr(tops, name)(axis=axis, keepdims=keepdims)(
        torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6)


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
@pytest.mark.parametrize("name", ["Argmax", "Argmin"])
def test_arg_reductions_are_exact(name, axis):
    """Ties included: both return the first extremum."""
    x = np.round(_rand((4, 6), 13)).astype(np.float32)
    for output_type, jtype in ((torch.int32, jnp.int32),
                               (torch.int16, jnp.int16)):
        want = getattr(jops, name)(axis=axis, output_type=jtype)(
            jnp.asarray(x))
        got = getattr(tops, name)(axis=axis, output_type=output_type)(
            torch.from_numpy(x))
        assert got.dtype == output_type
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_reduce_function_wrappers_take_any_function():
    x = _rand((3, 4), 14)
    got = tops.ReduceFunctionWrapper(tops.reduce_sum, axis=1)(
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), x.sum(1), rtol=1e-6)
    got = tops.ArgReduceFunctionWrapper(tops.argmin, axis=0)(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), x.argmin(0))


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_l2_normalization_matches_jax(axis):
    x = _rand((3, 4, 5), 15)
    x[0, 0] = 0.0  # a zero vector stays zero
    want = jnorm.L2Normalization(axis)(jnp.asarray(x))
    got = tnorm.L2Normalization(axis)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ---------------------------------------------------------------------------
# scaled attention
# ---------------------------------------------------------------------------

def _qkv(seed, tq=5, tk=7):
    return (_rand((2, 3, tq, 8), seed), _rand((2, 3, tk, 8), seed + 1),
            _rand((2, 3, tk, 8), seed + 2))


@pytest.mark.parametrize("key_dim", [None, 16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masks", [False, True])
def test_scaled_attention_matches_jax(masks, causal, key_dim):
    q, v, k = _qkv(16)
    rng = np.random.RandomState(17)
    q_mask = rng.rand(2, 5) < 0.7 if masks else None
    v_mask = rng.rand(2, 7) < 0.7 if masks else None
    if masks:
        v_mask[:, 0] = True
    jm = None if not masks else [jnp.asarray(q_mask), jnp.asarray(v_mask)]
    tm = None if not masks else [torch.from_numpy(q_mask),
                                 torch.from_numpy(v_mask)]
    want = jatt.scaled_attention(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(k), key_dim=key_dim,
        causal=causal, q_mask=None if jm is None else jm[0],
        v_mask=None if jm is None else jm[1])
    got = tatt.scaled_attention(
        torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(k),
        key_dim=key_dim, causal=causal, q_mask=None if tm is None else tm[0],
        v_mask=None if tm is None else tm[1])
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # the layer: [q, v, k] and [q, v] (the key is the value)
    for n in (3, 2):
        jin = [jnp.asarray(a) for a in (q, v, k)[:n]]
        tin = [torch.from_numpy(a) for a in (q, v, k)[:n]]
        want = jatt.ScaledAttention(key_dim, causal, dropout=0.1)(
            jin, mask=jm)
        got = tatt.ScaledAttention(key_dim, causal, dropout=0.1)(
            tin, mask=tm)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_scaled_attention_dropout_needs_a_generator():
    q, v, k = (torch.from_numpy(a) for a in _qkv(18))
    layer = tatt.ScaledAttention(dropout=0.5)
    with pytest.raises(ValueError, match="generator"):
        layer([q, v, k], training=True)
    a = layer([q, v, k], training=True,
              generator=torch.Generator().manual_seed(0))
    b = layer([q, v, k], training=True,
              generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert not torch.allclose(a, layer([q, v, k]))
    # without dropout the generator is not needed
    assert torch.equal(tatt.ScaledAttention()([q, v, k], training=True),
                       layer([q, v, k]))
