"""The port's mixture-of-experts layers (``chambers_tpu_torch.layers.moe``)
against the JAX package's on the same weights (its seeded init, converted
with ``state_dict_from_jax``) and the same numpy inputs, on the CPU.

One case for each test of ``tests/layers/test_moe.py`` that needs no mesh
(24 of its 29; the five expert-parallel ones wait for the port of
``parallel/``), each holding the port to the JAX output and to the
property that test checks, and the cases the port adds: routing on ties,
drops at rank 1, bf16, gradients, int8 expert banks and the weights'
conversion.

Tolerances, float32: outputs within 1e-5, the aux and z losses within 1e-6
relative, input and parameter gradients within 1e-4, top-k indices and the
dispatch mask exactly equal (read from inside the JAX module's call). bf16:
rtol 2^-7 with routing equal. Sums run in other orders in the two
frameworks, so float32 results agree to roundoff, not bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.layers import moe as jmoe
from chambers_tpu.layers.transformer import DecoderLayer as JaxDecoderLayer
from chambers_tpu.layers.transformer import Decoder as JaxDecoder
from chambers_tpu.layers.transformer import Encoder as JaxEncoder
from chambers_tpu.layers.transformer import EncoderLayer as JaxEncoderLayer
from chambers_tpu.quantization import quantize_variables
from chambers_tpu_torch.activations import gelu
from chambers_tpu_torch.layers import moe
from chambers_tpu_torch.layers.transformer import Decoder, Encoder
from chambers_tpu_torch.models.backbones.convert import (
    jax_path,
    state_dict_from_jax,
)
from chambers_tpu_torch.quantization import (
    dequantize_state_dict,
    load_quantized_state_dict,
    quantize_model,
)
from test_torch_package import one_torch_thread  # noqa: F401

CPU = "cpu"
BF16_RTOL = 2.0 ** -7


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return module.eval()


def _port_mlp(jmod, x, **kw):
    """The port's MoEMLP with the JAX module's settings, at ``x``'s width."""
    return moe.MoEMLP(
        x.shape[-1], jmod.ff_dim, jmod.n_experts,
        capacity_factor=jmod.capacity_factor,
        aux_loss_weight=jmod.aux_loss_weight,
        router_z_loss_weight=jmod.router_z_loss_weight,
        n_selected_experts=jmod.n_selected_experts,
        group_size=jmod.group_size, device=CPU, **kw)


def _jax_apply(jmod, variables, x):
    """JAX's output and summed aux loss, and what its call routed: the
    top-k indices and the dispatch tensor, read from inside the call."""
    seen = {}
    top_k, einsum = jax.lax.top_k, jnp.einsum

    def spy_top_k(probs, k):
        out = top_k(probs, k)
        seen["topk"] = np.asarray(out[1])
        return out

    def spy_einsum(eq, *ops, **kw):
        if eq == "gsec,gsd->gecd":
            seen["dispatch"] = np.asarray(ops[0], np.float32)
        return einsum(eq, *ops, **kw)

    jax.lax.top_k, jnp.einsum = spy_top_k, spy_einsum
    try:
        y, state = jmod.apply(variables, x, mutable=["intermediates"])
    finally:
        jax.lax.top_k, jnp.einsum = top_k, einsum
    aux = float(jmoe.moe_aux_loss(state.get("intermediates", {})))
    return np.asarray(y), aux, seen


def _port_routing(port, x):
    """The port's top-k indices and dispatch tensor for ``x``."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    s = tokens.shape[0] if port.group_size is None else min(
        port.group_size, tokens.shape[0])
    xg = tokens.reshape(-1, s, d)
    _, _, gates, experts = port.route(xg)
    dispatch, _, _ = port.dispatch_and_combine(gates, experts,
                                               port.capacity(s), xg.dtype)
    return experts.numpy(), dispatch.float().numpy()


def _compare_mlp(jmod, x, variables=None, seed=0, params=None):
    """Run both packages' MoEMLP on ``x`` and hold the port to JAX: output
    1e-5, aux 1e-6 relative, routing exactly. Returns the port's output,
    JAX's output and the port module."""
    if variables is None:
        variables = jmod.init(jax.random.PRNGKey(seed), x)
    if params is not None:
        variables = {"params": params}
    want, aux_want, seen = _jax_apply(jmod, variables, jnp.asarray(x))
    port = _load(_port_mlp(jmod, x), variables["params"])
    with torch.no_grad():
        got = port(_t(x)).numpy()
    experts, dispatch = _port_routing(port, _t(x))
    np.testing.assert_array_equal(experts, seen["topk"])
    np.testing.assert_array_equal(dispatch, seen["dispatch"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(port.aux_loss), aux_want, rtol=1e-6)
    return got, want, port


def _naive_topk(x, params, k):
    """Per-token reference with ample capacity (tests/layers/test_moe.py's
    ``_naive_topk``), in float64 with the port's gelu."""
    p = {name: np.asarray(v, np.float64) for name, v in params.items()}
    tokens = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = tokens @ p["w_router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(tokens)
    for i, t in enumerate(tokens):
        top = np.argsort(-probs[i], kind="stable")[:k]
        gates = probs[i, top]
        if k > 1:
            gates = gates / gates.sum()
        for e, gate in zip(top, gates):
            h = gelu(torch.from_numpy(t @ p["w1"][e] + p["b1"][e])).numpy()
            out[i] += gate * (h @ p["w2"][e] + p["b2"][e])
    return out.reshape(x.shape)


# --- MoEMLP: one case per test of tests/layers/test_moe.py -----------------

def test_single_expert_equals_dense_mlp():
    x = _rand((2, 5, 8), 0)
    got, _, port = _compare_mlp(
        jmoe.MoEMLP(ff_dim=16, n_experts=1, capacity_factor=1.0), x)
    xt = _t(x)
    with torch.no_grad():
        h = gelu(xt @ port.w1[0] + port.b1[0])
        want = (h @ port.w2[0] + port.b2[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_output_shape_and_dtype():
    x = np.zeros((3, 7, 12), np.float32)
    jmod = jmoe.MoEMLP(ff_dim=24, n_experts=4, dtype=jnp.bfloat16)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))
    port = _load(_port_mlp(jmod, x, dtype=torch.bfloat16),
                 variables["params"])
    y = port(_t(x).to(torch.bfloat16))
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    want = jmod.apply(variables, jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(y.float().detach().numpy(),
                                  np.asarray(want, np.float32))


def test_each_token_visits_exactly_one_expert():
    x = _rand((1, 16, 8), 1)
    got, _, port = _compare_mlp(
        jmoe.MoEMLP(ff_dim=16, n_experts=4, capacity_factor=4.0), x)
    params = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    np.testing.assert_allclose(got, _naive_topk(x, params, 1), rtol=1e-4,
                               atol=1e-5)


def test_capacity_drops_to_zero():
    x = _rand((1, 32, 8), 2)
    # capacity = ceil(32/2 * 0.25) = 4 an expert: at most 8 of 32 kept
    got, want, _ = _compare_mlp(
        jmoe.MoEMLP(ff_dim=8, n_experts=2, capacity_factor=0.25), x)
    zero = np.abs(got[0]).max(axis=-1) == 0.0
    assert zero.sum() >= 32 - 8
    np.testing.assert_array_equal(zero, np.abs(want[0]).max(axis=-1) == 0.0)


def test_aux_loss_sown_and_near_uniform_at_init():
    x = _rand((4, 64, 16), 3)
    _, _, port = _compare_mlp(
        jmoe.MoEMLP(ff_dim=8, n_experts=4, aux_loss_weight=1.0), x)
    assert 0.5 < float(moe.moe_aux_loss(port)) < 3.0
    assert float(jmoe.moe_aux_loss({})) == 0.0
    empty = moe.moe_aux_loss(torch.nn.Linear(2, 2))
    assert empty.shape == () and float(empty) == 0.0


def test_moe_encoder_layer_runs_and_routes():
    x = _rand((2, 10, 16), 4)
    kw = dict(embed_dim=16, num_heads=2, ff_dim=32, n_experts=4,
              pre_norm=True, attention_dropout_rate=0.0,
              dense_dropout_rate=0.0)
    jmod = jmoe.MoEEncoderLayer(**kw)
    variables = jmod.init(jax.random.PRNGKey(0), x)
    want, aux_want, _ = _jax_apply(jmod, variables, jnp.asarray(x))
    port = _load(moe.MoEEncoderLayer(device=CPU, **kw), variables["params"])
    xt = _t(x).requires_grad_(True)
    got = port(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    aux = float(moe.moe_aux_loss(port).detach())
    assert aux > 0.0
    np.testing.assert_allclose(aux, aux_want, rtol=1e-6)

    # gradients of sum(y²) reach the router, as in JAX, and equal JAX's
    def loss(p, x):
        return jnp.sum(jmod.apply({"params": p}, x) ** 2)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                                   jnp.asarray(x))
    (got ** 2).sum().backward()
    assert float(port.moe.w_router.grad.abs().sum()) > 0.0
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-4)
    want_grads = state_dict_from_jax(jax.device_get(g_params))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-4, err_msg=name)


def _jax_vit(**kw):
    from chambers_tpu.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    return VisionTransformer(
        patch_size=8, patch_dim=16, n_heads=2, ff_dim=32, dropout_rate=0.0,
        include_top=False, pooling="cls", **kw)


def _port_vit(n_layers, **kw):
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    return VisionTransformer(8, 16, n_layers, 2, 32, dropout_rate=0.0,
                             image_size=(16, 16), include_top=False,
                             pooling="cls", device=CPU, **kw)


def test_vit_moe_every_n():
    jdense = _jax_vit(n_encoder_layers=4)
    x0 = jnp.zeros((2, 16, 16, 3))
    enc = jdense.init(jax.random.PRNGKey(0), x0)["params"]["encoder"]
    assert all("moe" not in enc[f"layers_{i}"] for i in range(4))
    dense = _port_vit(4)
    assert not any("moe" in k for k in dense.state_dict())

    jmod = _jax_vit(n_encoder_layers=4, moe_every_n=2, moe_n_experts=4)
    variables = jmod.init(jax.random.PRNGKey(0), x0)
    port = _port_vit(4, moe_every_n=2, moe_n_experts=4)
    names = set(port.state_dict())
    # layers 1 and 3 (the 2nd and 4th) are routed, 0 and 2 stay dense
    assert {"encoder.layers.1.moe.w1", "encoder.layers.3.moe.w1",
            "encoder.layers.0.dense1.kernel",
            "encoder.layers.2.dense1.kernel"} <= names
    assert port.encoder.layers[1].moe.w1.shape == (4, 16, 32)
    assert isinstance(port.encoder.layers[1], moe.MoEEncoderLayer)
    assert set(state_dict_from_jax(jax.device_get(
        variables["params"]))) == names
    _load(port, variables["params"])
    imgs = _rand((2, 16, 16, 3), 7)
    want, aux_want, _ = _jax_apply(jmod, variables, jnp.asarray(imgs))
    with torch.no_grad():
        got = port(_t(imgs))
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    aux = float(moe.moe_aux_loss(port))
    assert np.isfinite(aux) and aux > 0.0
    np.testing.assert_allclose(aux, aux_want, rtol=1e-6)


def test_group_size_matches_ungrouped_when_capacity_ample():
    d = 16
    x = np.random.RandomState(0).randn(2, 32, d).astype(np.float32)
    m1 = jmoe.MoEMLP(ff_dim=32, n_experts=4, capacity_factor=8.0)
    v = m1.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, d)))
    got1, _, _ = _compare_mlp(m1, x, v)
    m2 = jmoe.MoEMLP(ff_dim=32, n_experts=4, capacity_factor=8.0,
                     group_size=16)
    got2, _, _ = _compare_mlp(m2, x, v)
    # the groups change the expert products' shapes, so their sums may
    # round apart by a step
    np.testing.assert_allclose(got1, got2, rtol=0, atol=1e-6)


def test_group_size_bounds_dispatch_memory_and_enforces_per_group_capacity():
    d = 8
    m = jmoe.MoEMLP(ff_dim=16, n_experts=2, capacity_factor=0.5,
                    group_size=8)
    v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, d)))
    x = np.random.RandomState(1).randn(1, 32, d).astype(np.float32)
    got, _, port = _compare_mlp(m, x, v)
    # 2 slots an expert in each 8-token group: at most 4 routed a group
    assert (np.abs(got[0]).max(axis=-1) == 0).sum() >= 32 - 4 * 4 - 1
    assert float(moe.moe_aux_loss(port)) > 0
    _, dispatch = _port_routing(port, _t(x))
    assert dispatch.shape == (4, 8, 2, 2)


def test_group_size_indivisible_raises():
    m = moe.MoEMLP(8, 16, 2, group_size=7, device=CPU)
    with pytest.raises(ValueError, match="group_size"):
        m(torch.zeros((1, 32, 8)))
    jm = jmoe.MoEMLP(ff_dim=16, n_experts=2, group_size=7)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 8)))
    with pytest.raises(ValueError, match="group_size"):
        jm.apply(v, jnp.zeros((1, 32, 8)))


def test_moe_encoder_layer_dropout_rates_match_encoder_layer():
    """The attention output's dropout runs at dense_dropout_rate in both
    layer kinds of both packages; the in-attention one at the attention
    rate."""
    kw = dict(embed_dim=16, num_heads=2, ff_dim=32,
              attention_dropout_rate=0.9, dense_dropout_rate=0.1)
    jm = jmoe.MoEEncoderLayer(n_experts=2, **kw)
    jr = JaxEncoderLayer(**kw)
    jm_b = jm.bind(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 16))))
    jr_b = jr.bind(jr.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 16))))
    port = moe.MoEEncoderLayer(n_experts=2, device=CPU, **kw)
    assert (port.dense_dropout_rate == jm_b.dropout1.rate
            == jr_b.dropout1.rate == jm_b.dropout2.rate == 0.1)
    assert (port.multi_head_attention.dropout_rate
            == jm_b.multi_head_attention.dropout_rate == 0.9)
    # at rates 0.1/0.9 in train mode the attention-output mask draws at 0.1:
    # the share of zeros the layer's dropout leaves
    ones = torch.ones(64, 64, 16)
    kept = port._drop(ones, False, torch.Generator().manual_seed(0)) != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.01


def test_moe_encoder_layer_accepts_norm_stats_dtype():
    from chambers_tpu_torch.layers.normalization import FastLayerNorm

    kw = dict(embed_dim=16, num_heads=2, ff_dim=32, n_experts=2,
              attention_dropout_rate=0.0, dense_dropout_rate=0.0)
    jmod = jmoe.MoEEncoderLayer(norm_stats_dtype=jnp.bfloat16, **kw)
    v = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 16)))
    x = _rand((2, 4, 16), 5)
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    port = _load(moe.MoEEncoderLayer(norm_stats_dtype=torch.bfloat16,
                                     device=CPU, **kw), v["params"])
    assert isinstance(port.norm1, FastLayerNorm)
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert got.shape == (2, 4, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_RTOL)


def test_top2_matches_naive_per_token_computation():
    x = _rand((2, 12, 8), 10)
    got, _, port = _compare_mlp(
        jmoe.MoEMLP(ff_dim=16, n_experts=4, n_selected_experts=2,
                    capacity_factor=4.0), x)
    params = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    np.testing.assert_allclose(got, _naive_topk(x, params, 2), rtol=1e-4,
                               atol=1e-5)


def test_topk_first_choices_outrank_second_choices_for_capacity():
    """One slot an expert: a later token's first choice wins it over an
    earlier token's second choice; the dropped share of the gates
    vanishes."""
    x = np.asarray([[[1.0, 2.0], [3.0, 0.0]]], np.float32)
    jmod = jmoe.MoEMLP(ff_dim=4, n_experts=2, n_selected_experts=2,
                       capacity_factor=0.2)
    v = jmod.init(jax.random.PRNGKey(0), x)
    params = dict(v["params"], w_router=jnp.eye(2, dtype=jnp.float32))
    got, _, port = _compare_mlp(jmod, x, params=params)

    probs = torch.softmax(_t(x[0]), -1).numpy()

    def expert(t, e):
        with torch.no_grad():
            h = gelu(_t(t) @ port.w1[e] + port.b1[e])
            return (h @ port.w2[e] + port.b2[e]).numpy()

    t0, t1 = x[0]
    g0 = probs[0, 1] / (probs[0, 1] + probs[0, 0])
    g1 = probs[1, 0] / (probs[1, 0] + probs[1, 1])
    np.testing.assert_allclose(got[0, 0], g0 * expert(t0, 1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[0, 1], g1 * expert(t1, 0), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("bad", [0, 5])
def test_topk_validates_k(bad):
    with pytest.raises(ValueError, match="n_selected_experts"):
        moe.MoEMLP(8, 8, 4, n_selected_experts=bad, device=CPU)
    jmod = jmoe.MoEMLP(ff_dim=8, n_experts=4, n_selected_experts=bad)
    with pytest.raises(ValueError, match="n_selected_experts"):
        jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8)))


def test_top2_grouped_matches_global_when_capacity_ample():
    d = 16
    x = np.random.RandomState(11).randn(2, 32, d).astype(np.float32)
    m1 = jmoe.MoEMLP(ff_dim=32, n_experts=4, n_selected_experts=2,
                     capacity_factor=8.0)
    v = m1.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, d)))
    got1, _, _ = _compare_mlp(m1, x, v)
    m2 = jmoe.MoEMLP(ff_dim=32, n_experts=4, n_selected_experts=2,
                     capacity_factor=8.0, group_size=16)
    got2, _, _ = _compare_mlp(m2, x, v)
    # the groups change the expert products' shapes, so their sums may
    # round apart by a step
    np.testing.assert_allclose(got1, got2, rtol=0, atol=1e-6)


def test_vit_accepts_moe_n_selected_experts():
    jmod = _jax_vit(n_encoder_layers=2, moe_every_n=2, moe_n_experts=4,
                    moe_n_selected_experts=2)
    x = _rand((2, 16, 16, 3), 13)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, aux_want, _ = _jax_apply(jmod, variables, jnp.asarray(x))
    port = _load(_port_vit(2, moe_every_n=2, moe_n_experts=4,
                           moe_n_selected_experts=2), variables["params"])
    assert port.encoder.layers[1].moe.n_selected_experts == 2
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert got.shape == (2, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(float(moe.moe_aux_loss(port)), aux_want,
                               rtol=1e-6)


def test_router_z_loss_default_off_is_identical():
    x = _rand((2, 8, 8), 14)
    m0 = jmoe.MoEMLP(ff_dim=16, n_experts=4)
    v = m0.init(jax.random.PRNGKey(0), x)
    y0, _, p0 = _compare_mlp(m0, x, v)
    y1, _, p1 = _compare_mlp(
        jmoe.MoEMLP(ff_dim=16, n_experts=4, router_z_loss_weight=0.0), x, v)
    np.testing.assert_array_equal(y0, y1)
    assert float(p0.aux_loss) == float(p1.aux_loss)


def test_router_z_loss_value_matches_numpy():
    x = _rand((2, 8, 8), 15)
    base = jmoe.MoEMLP(ff_dim=16, n_experts=4)
    v = base.init(jax.random.PRNGKey(0), x)
    y0, _, p0 = _compare_mlp(base, x, v)
    zw = 1e-3
    y1, _, p1 = _compare_mlp(
        jmoe.MoEMLP(ff_dim=16, n_experts=4, router_z_loss_weight=zw), x, v)
    got = float(p1.aux_loss) - float(p0.aux_loss)
    logits = x.reshape(-1, 8).astype(np.float64) @ np.asarray(
        v["params"]["w_router"], np.float64)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    np.testing.assert_allclose(got, zw * float(np.mean(lse ** 2)), rtol=1e-5)
    np.testing.assert_array_equal(y0, y1)


def _stack_kw(**kw):
    return dict(embed_dim=16, num_heads=2, ff_dim=32,
                dense_dropout_rate=0.0, attention_dropout_rate=0.0, **kw)


def test_encoder_plumbs_router_z_loss():
    x = _rand((2, 8, 16), 16)
    auxes = []
    for zw in (1e-3, 0.0):
        kw = _stack_kw(num_layers=2, moe_every_n=2, moe_n_experts=4,
                       moe_router_z_loss_weight=zw)
        jmod = JaxEncoder(**kw)
        v = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)))
        want, aux_want, _ = _jax_apply(jmod, v, jnp.asarray(x))
        port = _load(Encoder(device=CPU, **kw), v["params"])
        assert port.layers[1].moe.router_z_loss_weight == zw
        with torch.no_grad():
            got = port(_t(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        auxes.append(float(moe.moe_aux_loss(port)))
        np.testing.assert_allclose(auxes[-1], aux_want, rtol=1e-6)
    assert auxes[0] > auxes[1]


def test_moe_decoder_layer_shapes_and_aux():
    kw = dict(embed_dim=16, num_heads=2, ff_dim=32, n_experts=4,
              n_selected_experts=2, pre_norm=True,
              attention_dropout_rate=0.0, dense_dropout_rate=0.0)
    x, mem = _rand((2, 6, 16), 17), _rand((2, 9, 16), 18)
    jmod = jmoe.MoEDecoderLayer(**kw)
    v = jmod.init(jax.random.PRNGKey(0), [x, mem])
    want, aux_want, _ = _jax_apply(jmod, v, [jnp.asarray(x),
                                             jnp.asarray(mem)])
    port = _load(moe.MoEDecoderLayer(device=CPU, **kw), v["params"])
    with torch.no_grad():
        got = port([_t(x), _t(mem)]).numpy()
    assert got.shape == (2, 6, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert float(moe.moe_aux_loss(port)) > 0.0
    np.testing.assert_allclose(float(moe.moe_aux_loss(port)), aux_want,
                               rtol=1e-6)


def test_moe_decoder_layer_matches_dense_decoder_outside_mlp():
    """Two experts that both carry the dense MLP's weights, top-2, ample
    capacity: the gates sum to 1, so the routed decoder layer equals the
    dense one in both packages."""
    from chambers_tpu_torch.layers.transformer import DecoderLayer

    common = dict(embed_dim=16, num_heads=2, ff_dim=32, pre_norm=False,
                  attention_dropout_rate=0.0, dense_dropout_rate=0.0)
    jdense = JaxDecoderLayer(**common)
    x, mem = _rand((1, 6, 16), 18), _rand((1, 9, 16), 19)
    pd = dict(jdense.init(jax.random.PRNGKey(3), [x, mem])["params"])
    jmod = jmoe.MoEDecoderLayer(n_experts=2, n_selected_experts=2,
                                capacity_factor=4.0, **common)
    pm = dict(jmod.init(jax.random.PRNGKey(3), [x, mem])["params"])
    for name in ("multi_head_attention1", "multi_head_attention2",
                 "norm1", "norm2", "norm3"):
        pm[name] = pd[name]
    pm["moe"] = dict(pm["moe"],
                     w1=jnp.stack([pd["dense1"]["kernel"]] * 2),
                     b1=jnp.stack([pd["dense1"]["bias"]] * 2),
                     w2=jnp.stack([pd["dense2"]["kernel"]] * 2),
                     b2=jnp.stack([pd["dense2"]["bias"]] * 2))
    want = np.asarray(jmod.apply({"params": pm}, [x, mem]))
    port = _load(moe.MoEDecoderLayer(n_experts=2, n_selected_experts=2,
                                     capacity_factor=4.0, device=CPU,
                                     **common), pm)
    dense = _load(DecoderLayer(device=CPU, **common), pd)
    with torch.no_grad():
        got = port([_t(x), _t(mem)]).numpy()
        got_dense = dense([_t(x), _t(mem)]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, got_dense, rtol=1e-5, atol=1e-6)


def test_decoder_stack_moe_every_n():
    kw = _stack_kw(num_layers=4, moe_every_n=2, moe_n_experts=4,
                   moe_n_selected_experts=2)
    x, mem = _rand((2, 5, 16), 19), _rand((2, 7, 16), 20)
    jmod = JaxDecoder(**kw)
    v = jmod.init(jax.random.PRNGKey(0), [x, mem])
    assert "moe" in v["params"]["layers_1"] and "moe" in v["params"][
        "layers_3"]
    want, aux_want, _ = _jax_apply(jmod, v, [jnp.asarray(x),
                                             jnp.asarray(mem)])
    port = _load(Decoder(device=CPU, **kw), v["params"])
    assert [type(layer).__name__ for layer in port.layers] == [
        "DecoderLayer", "MoEDecoderLayer"] * 2
    with torch.no_grad():
        got = port([_t(x), _t(mem)]).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # one aux loss a routed layer
    assert sum(m.aux_loss is not None for m in port.modules()
               if isinstance(m, moe.MoEMLP)) == 2
    np.testing.assert_allclose(float(moe.moe_aux_loss(port)), aux_want,
                               rtol=1e-6)


def test_seq2seq_moe_trains_and_sows_aux():
    from chambers_tpu.models import Seq2SeqTransformer as JaxSeq2Seq
    from chambers_tpu_torch.models import Seq2SeqTransformer

    kw = dict(input_vocab_size=12, output_vocab_size=12, embed_dim=16,
              num_heads=2, dim_feedforward=32, num_encoder_layers=2,
              num_decoder_layers=2, dropout_rate=0.0, moe_every_n=2,
              moe_n_experts=4, moe_n_selected_experts=2)
    rng = np.random.default_rng(20)
    tokens = rng.integers(1, 12, (2, 7)).astype(np.int32)
    targets = rng.integers(1, 12, (2, 6)).astype(np.int32)
    jmod = JaxSeq2Seq(**kw)
    v = jmod.init(jax.random.PRNGKey(0), [tokens, targets])

    def loss_fn(params):
        logits, state = jmod.apply({"params": params}, [tokens, targets],
                                   mutable=["intermediates"])
        return (jnp.mean(logits.astype(jnp.float32) ** 2)
                + jmoe.moe_aux_loss(state["intermediates"]))

    loss_want, grads = jax.value_and_grad(loss_fn)(v["params"])
    port = _load(Seq2SeqTransformer(device=CPU, **kw), v["params"])
    logits = port([_t(tokens).long(), _t(targets).long()])
    routed = [name for name, m in port.named_modules()
              if isinstance(m, moe.MoEMLP)]
    assert routed == ["encoder.layers.1.moe", "decoder.layers.1.moe"]
    loss = torch.mean(logits.float() ** 2) + moe.moe_aux_loss(port)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_want), rtol=1e-6)
    want_grads = state_dict_from_jax(jax.device_get(grads))
    gsum = 0.0
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-4, err_msg=name)
        gsum += float(p.grad.abs().sum())
    assert np.isfinite(gsum) and gsum > 0


# --- what the port adds ----------------------------------------------------

def test_all_zero_router_ties_go_to_the_lower_index():
    """Every probability ties: JAX's top_k sends every first choice to
    expert 0 (and every second to expert 1), and capacity drops the rest;
    so does the port's stable sort."""
    x = _rand((1, 16, 8), 21)
    for k in (1, 2):
        jmod = jmoe.MoEMLP(ff_dim=8, n_experts=4, n_selected_experts=k)
        v = jmod.init(jax.random.PRNGKey(0), x)
        params = dict(v["params"], w_router=jnp.zeros((8, 4)))
        got, _, port = _compare_mlp(jmod, x, params=params)
        experts, dispatch = _port_routing(port, _t(x))
        c = port.capacity(16)                    # 5 (k=1) or 10 (k=2)
        # rank r fills expert r's queue with tokens 0..c-1; the rest drop
        for r in range(k):
            assert (experts[..., r] == r).all()
            assert (dispatch[0, :c, r, :] == np.eye(c)).all()
        assert dispatch.sum() == k * c
        assert (got[0, :c] != 0).any(-1).all()
        assert (got[0, c:] == 0).all()


def test_over_capacity_drops_at_rank_1():
    """capacity_factor small enough that the queues overflow at rank 1:
    each rank-1 position counts every rank-0 selection of its expert, kept
    or dropped, and the port drops exactly JAX's selections."""
    x = _rand((2, 24, 8), 22)
    jmod = jmoe.MoEMLP(ff_dim=16, n_experts=4, n_selected_experts=2,
                       capacity_factor=0.6)
    got, _, port = _compare_mlp(jmod, x)
    experts, dispatch = _port_routing(port, _t(x))
    c = port.capacity(48)                        # ceil(48·2/4·0.6) = 15
    assert c == 15
    kept = dispatch.sum(axis=(-1,))              # [g, s, E]
    rank0 = np.take_along_axis(kept, experts[..., :1], -1)[..., 0]
    rank1 = np.take_along_axis(kept, experts[..., 1:], -1)[..., 0]
    assert rank1.sum() < rank1.size              # second choices dropped
    # every expert fills rank 0 first; its rank-1 slots follow all of them
    for e in range(4):
        n0 = int((experts[0, :, 0] == e).sum())
        n1 = int((experts[0, :, 1] == e).sum())
        assert int(rank0[0][experts[0, :, 0] == e].sum()) == min(n0, c)
        assert int(rank1[0][experts[0, :, 1] == e].sum()) == max(
            0, min(n1, c - n0))


@pytest.mark.parametrize("k", [1, 2])
def test_bf16_matches_jax_with_equal_routing(k):
    x = _rand((2, 16, 32), 23)
    jmod = jmoe.MoEMLP(ff_dim=64, n_experts=4, n_selected_experts=k,
                       dtype=jnp.bfloat16, capacity_factor=1.0)
    v = jmod.init(jax.random.PRNGKey(1), x)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, aux_want, seen = _jax_apply(jmod, v, xb)
    port = _load(_port_mlp(jmod, x, dtype=torch.bfloat16), v["params"])
    xt = _t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        got = port(xt)
    experts, dispatch = _port_routing(port, xt)
    np.testing.assert_array_equal(experts, seen["topk"])
    np.testing.assert_array_equal(dispatch, seen["dispatch"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_RTOL, atol=BF16_RTOL)
    np.testing.assert_allclose(float(port.aux_loss), aux_want, rtol=1e-6)


@pytest.mark.parametrize("k,z", [(1, 0.0), (2, 1e-3)])
def test_gradients_match_jax(k, z):
    """Input and parameter gradients of sum(y·r) + aux, the router's
    through the gates and the aux and z losses: within 1e-4."""
    x = _rand((2, 12, 8), 24)
    r = _rand((2, 12, 8), 25)
    jmod = jmoe.MoEMLP(ff_dim=16, n_experts=4, n_selected_experts=k,
                       router_z_loss_weight=z, capacity_factor=1.0)
    v = jmod.init(jax.random.PRNGKey(2), x)

    def loss(p, x):
        y, state = jmod.apply({"params": p}, x, mutable=["intermediates"])
        return jnp.sum(y * r) + jmoe.moe_aux_loss(state["intermediates"])

    (g_p, g_x) = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    port = _load(_port_mlp(jmod, x), v["params"])
    xt = _t(x).requires_grad_(True)
    (torch.sum(port(xt) * _t(r)) + moe.moe_aux_loss(port)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-4)
    want = state_dict_from_jax(jax.device_get(g_p))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, err_msg=name)
    assert float(port.w_router.grad.abs().sum()) > 0


@pytest.mark.parametrize("k", [1, 2])
def test_int8_banks_match_jax(k):
    """quantize_model against quantize_variables + MoEMLP.apply: the int8
    banks and their scales bit-equal, the router float, and the output
    within tests/test_quantization.py's envelope of the float layer (0.03)
    and of JAX's int8 output."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(20), (2, 8, 16)))
    jmod = jmoe.MoEMLP(ff_dim=32, n_experts=4, capacity_factor=2.0,
                       n_selected_experts=k)
    v = jmod.init(jax.random.PRNGKey(21), x)
    qv = quantize_variables(v)
    port = _load(_port_mlp(jmod, x), v["params"])
    with torch.no_grad():
        y_float = port(_t(x)).numpy()
    quantize_model(port)
    for name in ("w1", "w2"):
        assert getattr(port, name).dtype == torch.int8
        assert not getattr(port, name).requires_grad
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(qv["params"][name]))
        np.testing.assert_array_equal(
            getattr(port, f"{name}_scale").numpy(),
            np.asarray(qv["quant"][f"{name}_scale"]))
    assert port.w1_scale.shape == (4, 1, 32)
    assert port.w2_scale.shape == (4, 1, 16)
    assert port.w_router.dtype == torch.float32
    want = np.asarray(jmod.apply(qv, x))
    with torch.no_grad():
        got = port(_t(x)).numpy()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(got, y_float) < 0.03
    assert rel(got, want) < 1e-3
    # JAX's int8 variables convert to the same port model
    again = _port_mlp(jmod, x)
    load_quantized_state_dict(again, state_dict_from_jax(
        jax.device_get(qv["params"]), quant=jax.device_get(qv["quant"])))
    with torch.no_grad():
        assert np.array_equal(again(_t(x)).numpy(), got)
    sd = dequantize_state_dict(port.state_dict())
    assert sd["w1"].dtype == torch.float32 and "w1_scale" not in sd


def test_int8_banks_quantize_together():
    from chambers_tpu_torch.quantization import quantize_state_dict

    m = moe.MoEMLP(8, 16, 2, device=CPU)
    m.reset_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="splits the quantization group"):
        quantize_state_dict(m.state_dict(), include=r"w1$")
    out = quantize_state_dict(m.state_dict(), include=r"w[12]$")
    assert set(out) == {"w_router", "w1", "b1", "w2", "b2", "w1_scale",
                        "w2_scale"}


def test_expert_banks_convert_as_they_are():
    """``state_dict_from_jax`` carries the router and the 3-D banks across
    untransposed, under JAX's names, and ``jax_path`` maps them back."""
    x = _rand((1, 4, 8), 26)
    jmod = JaxEncoder(embed_dim=8, num_heads=2, ff_dim=12, num_layers=2,
                      moe_every_n=2, moe_n_experts=3)
    v = jax.device_get(jmod.init(jax.random.PRNGKey(0), x)["params"])
    sd = state_dict_from_jax(v)
    routed = v["layers_1"]["moe"]
    for name, shape in (("w_router", (8, 3)), ("w1", (3, 8, 12)),
                        ("b1", (3, 12)), ("w2", (3, 12, 8)), ("b2", (3, 8))):
        key = f"layers.1.moe.{name}"
        assert tuple(sd[key].shape) == shape
        assert np.array_equal(sd[key].numpy(), routed[name])
        assert jax_path(key) == f"layers_1/moe/{name}"
    port = Encoder(8, 2, 12, 2, moe_every_n=2, moe_n_experts=3, device=CPU)
    port.load_state_dict(sd)
