"""The port's ViT stack against the JAX package's on the same weights: the
JAX package's seeded init, converted with ``state_dict_from_jax``.

Tolerances (float32) are the reference's sub-module parity gates
(BASELINE.md): 1e-5 for gelu, LayerNorm and MHA, 1e-4 for a whole encoder
layer, and max |logit Δ| < 1e-3 for the model. Sums run in another order
in the two frameworks, so float32 results agree to roundoff, not bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from chambers_tpu.activations import gelu as jax_gelu
from chambers_tpu.augmentations import ImageNetNormalization
from chambers_tpu.layers.attention import MultiHeadAttention as JaxMHA
from chambers_tpu.layers.normalization import FastLayerNorm as JaxFastLN
from chambers_tpu.layers.normalization import l2_normalize as jax_l2
from chambers_tpu.layers.transformer import EncoderLayer as JaxEncoderLayer
from chambers_tpu.models.backbones import vision_transformer as jvit
from chambers_tpu_torch.activations import gelu
from chambers_tpu_torch.layers.attention import MultiHeadAttention
from chambers_tpu_torch.layers.normalization import (
    FastLayerNorm,
    LayerNorm,
    l2_normalize,
)
from chambers_tpu_torch.layers.transformer import EncoderLayer
from chambers_tpu_torch.models.backbones import vision_transformer as tvit
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from test_torch_package import one_torch_thread  # noqa: F401

CPU = "cpu"
D, N_HEADS, FF = 48, 3, 96


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return module.eval()


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def test_gelu():
    x = _rand((4, 33), scale=3.0)
    assert _max_abs(jax_gelu(jnp.asarray(x)), gelu(torch.from_numpy(x))) \
        <= 1e-5
    assert _max_abs(jax_gelu(jnp.asarray(x), approximate=True),
                    gelu(torch.from_numpy(x), approximate=True)) <= 1e-5


def test_layer_norms():
    x = _rand((2, 5, D), scale=2.0) + 0.5
    params = {"scale": _rand((D,), 1), "bias": _rand((D,), 2)}
    want = nn.LayerNorm(epsilon=1e-6).apply({"params": params}, x)
    got = _load(LayerNorm(D, device=CPU), params)(torch.from_numpy(x))
    assert _max_abs(want, got.detach()) <= 1e-5
    want = JaxFastLN(stats_dtype=jnp.float32).apply({"params": params}, x)
    got = _load(FastLayerNorm(D, stats_dtype=torch.float32, device=CPU),
                params)(torch.from_numpy(x))
    assert _max_abs(want, got.detach()) <= 1e-5
    # bf16 output dtype contract: dtype given -> that dtype
    got = LayerNorm(D, dtype=torch.bfloat16, device=CPU)
    got.reset_parameters()
    assert got(torch.from_numpy(x)).dtype == torch.bfloat16


def test_l2_normalize():
    x = _rand((3, 7))
    assert _max_abs(jax_l2(jnp.asarray(x)),
                    l2_normalize(torch.from_numpy(x))) <= 1e-6


@pytest.mark.parametrize("kind", ["self", "cross_masked_causal"])
def test_multi_head_attention(kind):
    b, t, tv = 2, 9, 9
    q = _rand((b, t, D), 3)
    if kind == "self":
        inputs_j = [jnp.asarray(q)] * 3
        mask = None
    else:
        v, k = _rand((b, tv, D), 4), _rand((b, tv, D), 5)
        inputs_j = [jnp.asarray(q), jnp.asarray(v), jnp.asarray(k)]
        v_mask = np.ones((b, tv), bool)
        v_mask[1, 6:] = False
        mask = [None, v_mask]
    causal = kind != "self"
    jmod = JaxMHA(head_dim=D // N_HEADS, num_heads=N_HEADS, causal=causal)
    variables = jmod.init(jax.random.PRNGKey(0), inputs_j)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * _rand(a.shape, 6), variables["params"])
    want = jmod.apply({"params": params}, inputs_j, mask=mask)
    port = _load(MultiHeadAttention(D, D // N_HEADS, N_HEADS, causal=causal,
                                    device=CPU), params)
    inputs_t = [torch.tensor(np.asarray(a)) for a in inputs_j]
    if kind == "self":
        inputs_t = [inputs_t[0]] * 3
    mask_t = None if mask is None else [None, torch.from_numpy(mask[1])]
    got = port(inputs_t, mask=mask_t)
    assert _max_abs(want, got.detach()) <= 1e-5


@pytest.mark.parametrize("pre_norm", [True, False])
def test_encoder_layer(pre_norm):
    x = _rand((2, 9, D), 7)
    jmod = JaxEncoderLayer(embed_dim=D, num_heads=N_HEADS, ff_dim=FF,
                           pre_norm=pre_norm)
    params = jmod.init(jax.random.PRNGKey(1), x)["params"]
    want = jmod.apply({"params": params}, x)
    port = _load(EncoderLayer(D, N_HEADS, FF, pre_norm=pre_norm, device=CPU),
                 params)
    assert _max_abs(want, port(torch.from_numpy(x)).detach()) <= 1e-4


def _tiny_jax_vit(**kw):
    return jvit.VisionTransformer(
        patch_size=16, patch_dim=D, n_encoder_layers=2, n_heads=N_HEADS,
        ff_dim=FF, dropout_rate=0.0, classes=10, pooling="cls", **kw)


def _tiny_port_vit(**kw):
    return tvit.VisionTransformer(16, D, 2, N_HEADS, FF, image_size=(32, 32),
                                  classes=10, device=CPU, **kw)


@pytest.fixture(scope="module")
def tiny():
    """JAX seeded init of the tiny ViT, folded, and a uint8 batch."""
    variables = _tiny_jax_vit().init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 32, 32, 3)))
    folded = jvit.fold_imagenet_normalization(variables, mode="tf")
    x8 = np.random.RandomState(8).randint(0, 256, (4, 32, 32, 3), np.uint8)
    return variables, folded, x8


def test_vit_f32_logits(tiny):
    _, folded, x8 = tiny
    want = _tiny_jax_vit().apply(folded, jnp.asarray(x8), deterministic=True)
    port = _load(_tiny_port_vit(), folded["params"])
    with torch.inference_mode():
        got = port(torch.from_numpy(x8))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    assert _max_abs(want, got) < 1e-3


def test_vit_bf16_logits(tiny):
    """bf16 activations and bf16 scores on both sides. The two frameworks
    round at different places (matmul outputs, softmax sums, LayerNorm
    outputs), so each carries its own bf16 error: JAX's bf16 logits differ
    from its f32 ones by ~0.4% of the logit range on this model, and two
    such errors may add. The bound is 2% of the range."""
    _, folded, x8 = tiny
    jmod = _tiny_jax_vit(dtype=jnp.bfloat16, score_dtype=jnp.bfloat16)
    want = np.asarray(jmod.apply(folded, jnp.asarray(x8), deterministic=True))
    port = _load(_tiny_port_vit(dtype=torch.bfloat16,
                                score_dtype=torch.bfloat16), folded["params"])
    with torch.inference_mode():
        got = port(torch.from_numpy(x8))
    assert got.dtype == torch.float32
    assert _max_abs(want, got) <= 0.02 * float(np.ptp(want))


@pytest.mark.parametrize("mode", ["tf", "torch", "caffe"])
def test_fold_imagenet_normalization(tiny, mode):
    variables, _, x8 = tiny
    want = jvit.fold_imagenet_normalization(variables, mode=mode)
    sd = state_dict_from_jax(jax.device_get(variables["params"]))
    got = tvit.fold_imagenet_normalization(sd, mode=mode)
    # the kernel is a per-channel scale: 1e-6 relative. The bias adds a
    # p*p*3-term sum taken in another order than JAX's einsum: 1e-6 of the
    # sum of the terms' magnitudes
    pe = want["params"]["patch_embeddings"]
    np.testing.assert_allclose(got["patch_embeddings.kernel"].numpy(),
                               np.asarray(pe["kernel"]), rtol=1e-6, atol=0)
    offset = {"tf": [1.0] * 3, "torch": [2.2] * 3,
              "caffe": [124.0] * 3}[mode]  # bounds on |offset_c|
    terms = np.einsum("hwcd,c->d", np.abs(sd["patch_embeddings.kernel"]
                                          .numpy()), offset)
    err = np.abs(got["patch_embeddings.bias"].numpy() - np.asarray(pe["bias"]))
    assert np.all(err <= 1e-6 * terms), float(np.max(err / terms))
    assert torch.equal(sd["patch_embeddings.kernel"],
                       torch.tensor(np.asarray(
                           variables["params"]["patch_embeddings"]["kernel"])))
    # folded model on raw pixels == unfolded model on normalized pixels
    ref_in = np.asarray(ImageNetNormalization(mode=mode)(x8))
    model = _tiny_port_vit().eval()
    model.load_state_dict(sd)
    with torch.inference_mode():
        ref = model(torch.tensor(ref_in))
        model.load_state_dict(got)
        out = model(torch.from_numpy(x8).float())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-5)


def test_preset_seeded_init_is_deterministic():
    a = tvit.ViTS16(input_shape=(32, 32, 3), classes=5, seed=3, device=CPU)
    b = tvit.ViTS16(input_shape=(32, 32, 3), classes=5, seed=3, device=CPU)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert a.pos_embedding.embeddings.shape == (5, 384)
    assert float(a.encoder.layers[0].norm1.scale.detach().min()) == 1.0


def test_vit_dropout_rate_zero_matches_jax_in_train_mode(tiny):
    """At rate 0 every dropout is the identity, also in train mode (the
    port's default for a directly built model, JAX's ``deterministic=
    False``): the f32 logit gate, 1e-3."""
    _, folded, x8 = tiny
    want = _tiny_jax_vit().apply(folded, jnp.asarray(x8), deterministic=False)
    port = _tiny_port_vit(dropout_rate=0.0)
    port.load_state_dict(state_dict_from_jax(jax.device_get(
        folded["params"])))
    assert port.training
    with torch.inference_mode():
        got = port(torch.from_numpy(x8))
    assert _max_abs(want, got) < 1e-3


def test_vit_eval_mode_at_the_default_rate_matches_jax(tiny):
    """The default rate, 0.1 as in the JAX package, is inactive in eval
    mode and under ``deterministic=True``."""
    _, folded, x8 = tiny
    jmod = jvit.VisionTransformer(
        patch_size=16, patch_dim=D, n_encoder_layers=2, n_heads=N_HEADS,
        ff_dim=FF, classes=10, pooling="cls")
    assert jmod.dropout_rate == 0.1
    want = jmod.apply(folded, jnp.asarray(x8), deterministic=True)
    port = _load(_tiny_port_vit(), folded["params"])
    assert port.dropout_rate == 0.1
    assert port.encoder.layers[0].multi_head_attention.dropout_rate == 0.1
    assert port.encoder.layers[0].dense_dropout_rate == 0.1
    with torch.inference_mode():
        got = port(torch.from_numpy(x8))
        again = port.train()(torch.from_numpy(x8), deterministic=True)
    assert _max_abs(want, got) < 1e-3
    assert torch.equal(got, again)


def test_vit_train_mode_draws_from_the_generator(tiny):
    _, folded, x8 = tiny
    port = _tiny_port_vit()
    port.load_state_dict(state_dict_from_jax(jax.device_get(
        folded["params"])))
    x = torch.from_numpy(x8)
    with torch.inference_mode():
        a = port(x, generator=torch.Generator().manual_seed(3))
        b = port(x, generator=torch.Generator().manual_seed(3))
        c = port(x, generator=torch.Generator().manual_seed(4))
        ref = port.eval()(x)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, ref)



def _routed(k):
    return dict(moe_every_n=2, moe_n_experts=4, moe_n_selected_experts=k)


@pytest.mark.parametrize("k", [1, 2])
def test_routed_vit_matches_jax(tiny, k):
    """The 2-layer ViT with its second MLP routed (top-k of 4 experts):
    logits at the model gate, 1e-3, the aux loss within 1e-6 relative and
    the gradients of the logits' sum of squares plus the aux loss within
    1e-4."""
    from chambers_tpu.layers.moe import moe_aux_loss as jax_moe_aux_loss
    from chambers_tpu_torch.layers.moe import MoEEncoderLayer, moe_aux_loss

    _, _, x8 = tiny
    x = np.asarray(x8, np.float32) / 127.5 - 1.0
    jmod = _tiny_jax_vit(**_routed(k))
    params = jmod.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))[
        "params"]

    def loss(p):
        y, state = jmod.apply({"params": p}, x, mutable=["intermediates"])
        aux = jax_moe_aux_loss(state["intermediates"])
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (want, aux_want)), grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    port = _load(_tiny_port_vit(dropout_rate=0.0, **_routed(k)), params)
    assert isinstance(port.encoder.layers[1], MoEEncoderLayer)
    got = port(torch.from_numpy(x))
    assert _max_abs(want, got.detach()) < 1e-3
    aux = moe_aux_loss(port)
    np.testing.assert_allclose(aux.item(), float(aux_want), rtol=1e-6)
    (torch.sum(got ** 2) + aux).backward()
    want_grads = state_dict_from_jax(jax.device_get(grads))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("routed", [False, True])
def test_vit_remat_matches_plain(tiny, routed):
    """``remat=True`` against ``remat=False`` on the same weights in train
    mode, at the default dropout rate, 0.1, drawn from a seeded explicit
    generator: equal logits, aux loss and gradients, and the generator's
    state after backward as without remat."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.layers.moe import moe_aux_loss

    _, _, x8 = tiny
    kw = _routed(2) if routed else {}
    plain = initializers.init_module(_tiny_port_vit(**kw),
                                     torch.Generator().manual_seed(0))
    remat = _tiny_port_vit(remat=True, **kw)
    remat.load_state_dict(plain.state_dict())
    runs = []
    for model in (plain, remat):
        gen = torch.Generator().manual_seed(5)
        y = model(torch.from_numpy(x8), generator=gen)
        aux = moe_aux_loss(model)
        (torch.sum(y ** 2) + aux).backward()
        runs.append((y.detach(), aux.detach(), gen.get_state(),
                     {n: p.grad for n, p in model.named_parameters()}))
    (y0, a0, s0, g0), (y1, a1, s1, g1) = runs
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert torch.equal(s0, s1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    with torch.no_grad():
        assert not torch.equal(y0, plain.eval()(torch.from_numpy(x8)))


def test_vit_presets_take_moe_and_refuse_it_with_weights(tmp_path):
    model = tvit.ViTS16(input_shape=(32, 32, 3), classes=5, moe_every_n=2,
                        moe_n_experts=4, moe_capacity_factor=2.0,
                        device=CPU)
    routed = [layer.moe for layer in model.encoder.layers
              if layer.moe is not None]
    assert len(routed) == 6
    assert routed[0].n_experts == 4 and routed[0].capacity_factor == 2.0
    assert not model.training
    with torch.no_grad():
        assert model(torch.zeros(2, 32, 32, 3)).shape == (2, 5)
    # a released spec (as the JAX preset refuses it) or a file
    with pytest.raises(ValueError, match="moe_every_n"):
        jvit.ViTS16(weights="imagenet_224_deit", moe_every_n=2)
    for weights in ("imagenet_224_deit", str(tmp_path / "vits16.h5")):
        with pytest.raises(ValueError, match="moe_every_n"):
            tvit.ViTS16(weights=weights, moe_every_n=2, device=CPU)
