"""The port's int8 serving path (``chambers_tpu_torch.quantization``)
against the JAX package's (``chambers_tpu.quantization``) on the same
seeded numpy inputs and the same quantized variables.

- Codes and scales are bit-equal: both round half to even and divide once.
- Accumulators are exact int32 on both sides (``torch._int_mm`` against
  ``jnp.einsum(..., preferred_element_type=int32)``).
- float32 outputs agree within 1e-6 of their largest value for QuantDense
  and attention, where the float work after the product is a rescale in
  the same order, and within 1e-5 for the two-layer encoder stack and the
  ViT, where LayerNorm, GELU and softmax sum in another order (BASELINE.md's
  sub-module gate is 1e-5). bf16 logits are held to
  ``tests/test_torch_vit.py``'s bf16 bound, 2% of the logit range.
- The port's int8 results stay within the JAX package's accuracy envelopes
  against float (``tests/test_quantization.py``: 0.02, 0.03, 0.05)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu import quantization as jq
from chambers_tpu.layers.attention import MultiHeadAttention as JaxMHA
from chambers_tpu.layers.transformer import Encoder as JaxEncoder
from chambers_tpu.models.backbones import vision_transformer as jvit
from chambers_tpu_torch import initializers
from chambers_tpu_torch import quantization as tq
from chambers_tpu_torch.layers.attention import MultiHeadAttention
from chambers_tpu_torch.layers.transformer import Encoder
from chambers_tpu_torch.models.backbones import vision_transformer as tvit
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from test_torch_package import one_torch_thread  # noqa: F401

CPU = "cpu"
D, N_HEADS, FF = 48, 3, 96


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _rel_max(got, want):
    """max |got - want| over max |want|."""
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


def _converted(qv):
    """The port's quantized state_dict of JAX's quantized variables."""
    return state_dict_from_jax(jax.device_get(qv["params"]),
                               quant=jax.device_get(qv["quant"]))


def _port(module, qv):
    return tq.load_quantized_state_dict(module, _converted(qv)).eval()


# ---------------------------------------------------------------------------
# codes and scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [
    ((64, 40), (0,)),          # a Dense kernel: scale [1, N]
    ((48, 3, 16), (0,)),       # w_query: scale [1, n, h]
    ((3, 48, 16), (0, 2)),     # w_projection: scale [1, d, 1]
])
def test_quantize_weight_bit_equal(shape, axes):
    w = _rand(shape, 1, 0.05)
    w.reshape(-1)[:3] = 0.0
    q_j, s_j = jq.quantize_weight(jnp.asarray(w), axes)
    q_t, s_t = tq.quantize_weight(torch.from_numpy(w), axes)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert tuple(s_t.shape) == tuple(s_j.shape)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_ties_round_half_to_even():
    """A column whose absmax is 127 has scale 1 exactly, so x.5 values are
    exact ties: both packages round them to the even neighbour."""
    w = np.array([[127.0, 127.0], [2.5, -3.5], [0.5, -0.5], [1.5, 126.5]],
                 np.float32)
    q_t, s_t = tq.quantize_weight(torch.from_numpy(w), (0,))
    q_j, _ = jq.quantize_weight(jnp.asarray(w), (0,))
    assert s_t.tolist() == [[1.0, 1.0]]
    assert q_t.tolist() == [[127, 127], [2, -4], [0, 0], [2, 126]]
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    x = np.array([[127.0, 2.5, -0.5, 0.0]], np.float32)
    xq_t, _ = tq.dynamic_quantize(torch.from_numpy(x))
    xq_j, _ = jq.dynamic_quantize(jnp.asarray(x))
    assert xq_t.tolist() == [[127, 2, 0, 0]]
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axes,shape", [((-1,), (2, 9, 48)),
                                        ((1, 3), (2, 3, 9, 16))])
def test_dynamic_quantize_bit_equal(dtype, axes, shape):
    x = _rand(shape, 2, 3.0)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-12 floor
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    q_j, s_j = jq.dynamic_quantize(xj, axes)
    q_t, s_t = tq.dynamic_quantize(xt, axes)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


# ---------------------------------------------------------------------------
# the contraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(8, 12, 10), (17, 16, 8), (40, 48, 144)])
def test_int_mm_is_exact(m, k, n):
    """Padded shapes (m <= 16, k or n not multiples of 8) and unpadded ones
    give the exact int32 product, with the weight operand column-major (as
    ``gemm_operand`` holds it) or row-major."""
    rng = np.random.RandomState(m)
    x = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.int8))
    operand = tq.gemm_operand(w)
    assert operand.shape == (k + -k % 8, n + -n % 8)
    assert operand.t().is_contiguous()
    for w_op in (operand, operand.contiguous()):
        acc = tq.int_mm(x, w_op, n)
        assert acc.dtype == torch.int32 and acc.shape == (m, n)
        assert torch.equal(acc, x.int() @ w.int())


def test_int_mm_refuses_a_short_weight():
    x = torch.zeros((20, 24), dtype=torch.int8)
    with pytest.raises(ValueError, match="columns"):
        tq.int_mm(x, tq.gemm_operand(torch.zeros((16, 8), dtype=torch.int8)),
                  8)


# ---------------------------------------------------------------------------
# the layers against the JAX package on the same quantized variables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_dtype,dtype", [
    ("float32", None), ("bfloat16", None), ("bfloat16", "bfloat16")])
def test_quant_dense_matches_jax(in_dtype, dtype):
    """Exact accumulators; outputs in the float branch's dtype (bf16 inputs
    with float32 parameters promote to float32), 1e-6 of the largest in
    float32 and bit-equal in bf16, where both round the same float32
    rescale once and add the bias in bf16."""
    x = _rand((3, 5, D), 3, 2.0)
    jdense = jq.QuantDense(10, dtype=dtype and getattr(jnp, dtype))
    qv = jq.quantize_variables(jdense.init(jax.random.PRNGKey(5),
                                           jnp.asarray(x)))
    xj = jnp.asarray(x).astype(getattr(jnp, in_dtype))
    want = jdense.apply(qv, xj)
    port = _port(tq.QuantDense(D, 10, dtype=dtype and getattr(torch, dtype),
                               device=CPU), qv)
    xt = torch.from_numpy(x).to(getattr(torch, in_dtype))
    got = port(xt)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)

    xq, _ = tq.dynamic_quantize(xt.reshape(-1, D))
    acc = tq.int_mm(xq, port._kernel_gemm, 10)
    xq_j, _ = jq.dynamic_quantize(xj)
    acc_j = jnp.einsum("...k,kf->...f", xq_j, qv["params"]["kernel"],
                       preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(),
                                  np.asarray(acc_j).reshape(-1, 10))
    if got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(want, np.float32))
    else:
        assert _rel_max(got.detach(), want) <= 1e-6


@pytest.mark.parametrize("kind", ["self", "cross", "cross_masked_causal"])
def test_attention_matches_jax(kind):
    """Self-attention through the stacked query/value/key operand, cross
    attention through each third of it, then the output projection over
    (n, h): exact accumulators, outputs within 1e-6 of the largest."""
    b, t, tv = 2, 9, 7
    q = _rand((b, t, D), 4)
    mem = _rand((b, tv, D), 5)
    causal = kind == "cross_masked_causal"
    mask = None
    if causal:
        v_mask = np.ones((b, tv), bool)
        v_mask[1, 4:] = False
        mask = [None, v_mask]
    jmod = JaxMHA(head_dim=D // N_HEADS, num_heads=N_HEADS, causal=causal,
                  dropout_rate=0.0)
    ins = ([jnp.asarray(q)] * 3 if kind == "self"
           else [jnp.asarray(q), jnp.asarray(mem), jnp.asarray(mem)])
    qv = jq.quantize_variables(jmod.init(jax.random.PRNGKey(0), ins))
    want = jmod.apply(qv, ins, mask=mask)
    port = _port(MultiHeadAttention(D, D // N_HEADS, N_HEADS, causal=causal,
                                    dropout_rate=0.0, device=CPU), qv)
    tins = ([torch.from_numpy(q)] * 3 if kind == "self"
            else [torch.from_numpy(q), torch.from_numpy(mem),
                  torch.from_numpy(mem)])
    tmask = None if mask is None else [None, torch.from_numpy(mask[1])]
    got = port(tins, mask=tmask)
    assert _rel_max(got.detach(), want) <= 1e-6

    if kind == "self":  # the stacked accumulator, btd,sdnh->sbnth
        xq, _ = tq.dynamic_quantize(torch.from_numpy(q).reshape(b * t, D))
        acc = tq.int_mm(xq, port._qkv_gemm, 3 * D)
        xq_j, _ = jq.dynamic_quantize(jnp.asarray(q))
        w = jnp.stack([qv["params"][f"w_{n}"] for n in
                       ("query", "value", "key")])
        acc_j = jnp.einsum("btd,sdnh->btsnh", xq_j, w,
                           preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(acc.numpy(),
                                      np.asarray(acc_j).reshape(b * t, -1))


def test_output_projection_accumulator_is_exact():
    """``bnth,ndh->btd`` with activations quantized over (n, h), through
    the operand a quantized layer derives."""
    b, n, t, h = 2, N_HEADS, 9, D // N_HEADS
    port = MultiHeadAttention(D, h, n, device=CPU)
    port.reset_parameters(torch.Generator().manual_seed(7))
    tq.quantize_model(port)
    a_q, _ = tq.dynamic_quantize(torch.from_numpy(_rand((b, n, t, h), 6)),
                                 (1, 3))
    acc = tq.int_mm(a_q.permute(0, 2, 1, 3).reshape(b * t, n * h),
                    port._projection_gemm, D)
    acc_j = jnp.einsum("bnth,ndh->btd", jnp.asarray(a_q.numpy()),
                       jnp.asarray(port.w_projection.numpy()),
                       preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(),
                                  np.asarray(acc_j).reshape(b * t, D))


@pytest.mark.parametrize("pre_norm", [True, False])
def test_encoder_stack_matches_jax(pre_norm):
    """Two EncoderLayers, int8 throughout: 1e-5 of the largest output."""
    x = _rand((2, 9, D), 8)
    jmod = JaxEncoder(embed_dim=D, num_heads=N_HEADS, ff_dim=FF, num_layers=2,
                      attention_dropout_rate=0.0, dense_dropout_rate=0.0,
                      pre_norm=pre_norm)
    qv = jq.quantize_variables(jmod.init(jax.random.PRNGKey(1), x))
    want = jmod.apply(qv, x)
    port = _port(Encoder(D, N_HEADS, FF, 2, attention_dropout_rate=0.0,
                         dense_dropout_rate=0.0, pre_norm=pre_norm,
                         device=CPU), qv)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert _rel_max(got, want) <= 1e-5


def _tiny_jax_vit(**kw):
    return jvit.VisionTransformer(
        patch_size=16, patch_dim=D, n_encoder_layers=2, n_heads=N_HEADS,
        ff_dim=FF, dropout_rate=0.0, classes=10, pooling="cls", **kw)


def _tiny_port_vit(**kw):
    return tvit.VisionTransformer(16, D, 2, N_HEADS, FF, dropout_rate=0.0,
                                  image_size=(32, 32), classes=10,
                                  device=CPU, **kw)


@pytest.fixture(scope="module")
def tiny():
    """JAX seeded init of a 2-layer ViT, folded as bench.py folds it, then
    quantized; and a uint8 batch."""
    variables = _tiny_jax_vit().init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 32, 32, 3)))
    folded = jvit.fold_imagenet_normalization(variables, mode="tf")
    x8 = np.random.RandomState(8).randint(0, 256, (4, 32, 32, 3), np.uint8)
    return folded, jq.quantize_variables(folded), x8


def test_vit_int8_f32_matches_jax(tiny):
    """End to end in float32, the head (10 classes, padded to 16 columns,
    4 rows padded to 17) included: 1e-5 of the largest logit."""
    _, qv, x8 = tiny
    want = _tiny_jax_vit().apply(qv, jnp.asarray(x8), deterministic=True)
    port = _port(_tiny_port_vit(), qv)
    with torch.inference_mode():
        got = port(torch.from_numpy(x8))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    assert _rel_max(got, want) <= 1e-5


def test_vit_int8_bf16_matches_jax(tiny):
    """bf16 activations and scores on both sides: 2% of the logit range,
    the bound of tests/test_torch_vit.py's bf16 model."""
    _, qv, x8 = tiny
    jmod = _tiny_jax_vit(dtype=jnp.bfloat16, score_dtype=jnp.bfloat16)
    want = np.asarray(jmod.apply(qv, jnp.asarray(x8), deterministic=True))
    port = _port(_tiny_port_vit(dtype=torch.bfloat16,
                                score_dtype=torch.bfloat16), qv)
    with torch.inference_mode():
        got = port(torch.from_numpy(x8)).numpy()
    assert np.max(np.abs(got - want)) <= 0.02 * float(np.ptp(want))


# ---------------------------------------------------------------------------
# accuracy envelopes: the port's int8 against its own float results
# ---------------------------------------------------------------------------

def _envelope_case(name):
    """(float module, input) of one of tests/test_quantization.py's
    envelope cases, built by the port's seeded init."""
    gen = torch.Generator().manual_seed(5)
    if name == "dense":
        module = tq.QuantDense(64, 48, device=CPU)
        x = [torch.from_numpy(_rand((32, 64), 4))]
    elif name == "mha_self":
        module = MultiHeadAttention(64, 16, 4, dropout_rate=0.0, device=CPU)
        x = torch.from_numpy(_rand((2, 10, 64), 8))
        x = [[x, x, x]]
    elif name == "mha_cross":
        module = MultiHeadAttention(16, 8, 2, dropout_rate=0.0, device=CPU)
        m = torch.from_numpy(_rand((2, 9, 16), 11))
        x = [[torch.from_numpy(_rand((2, 5, 16), 10)), m, m]]
    elif name == "encoder_layer":
        module = Encoder(32, 4, 64, 1, attention_dropout_rate=0.0,
                         dense_dropout_rate=0.0, pre_norm=True, device=CPU)
        x = [torch.from_numpy(_rand((2, 7, 32), 13))]
    else:  # a 3-layer ViT of width 64, its features
        module = tvit.VisionTransformer(8, 64, 3, 4, 128, dropout_rate=0.0,
                                        image_size=(32, 32),
                                        include_top=False, device=CPU)
        x = [torch.from_numpy(_rand((2, 32, 32, 3), 15))]
    return initializers.init_module(module, gen).eval(), x


@pytest.mark.parametrize("name,bound", [
    ("dense", 0.02), ("mha_self", 0.03), ("mha_cross", 0.03),
    ("encoder_layer", 0.03), ("vit", 0.05)])
def test_accuracy_envelope(name, bound):
    module, x = _envelope_case(name)
    with torch.inference_mode():
        want = module(*x)
        got = tq.quantize_model(copy.deepcopy(module))(*x)
    assert got.dtype == want.dtype
    assert _rel_err(got, want) < bound


# ---------------------------------------------------------------------------
# state_dict conversion and the model
# ---------------------------------------------------------------------------

def test_converted_quant_collection_equals_the_ports_quantization(tiny):
    folded, qv, _ = tiny
    from_jax = _converted(qv)
    ours = tq.quantize_state_dict(state_dict_from_jax(
        jax.device_get(folded["params"])))
    assert sorted(from_jax) == sorted(ours)
    for key, value in ours.items():
        assert value.dtype == from_jax[key].dtype, key
        assert torch.equal(value, from_jax[key]), key
    assert ours["encoder.layers.0.dense1.kernel_scale"].shape == (1, FF)
    assert ours["predictions.kernel_scale"].shape == (1, 10)
    assert ours["encoder.layers.1.multi_head_attention.w_key_scale"].shape \
        == (1, N_HEADS, D // N_HEADS)
    assert (ours["encoder.layers.1.multi_head_attention.w_projection_scale"]
            .shape == (1, D, 1))
    assert ours["patch_embeddings.kernel"].dtype == torch.float32


def test_quantize_model_holds_int8_kernels():
    model = _tiny_port_vit().eval()
    before = {k: v.shape for k, v in model.state_dict().items()}
    tq.quantize_model(model)
    sd = model.state_dict()
    int8 = {k for k, v in sd.items() if v.dtype == torch.int8}
    assert int8 == {k[:-len("_scale")] for k in sd if k.endswith("_scale")}
    assert len(int8) == 2 * 6 + 1  # 4 projections + 2 dense a layer, head
    for key in int8:
        prefix, _, name = key.rpartition(".")
        param = getattr(model.get_submodule(prefix), name)
        assert param.dtype == torch.int8 and not param.requires_grad
        assert before[key] == param.shape
    assert model.patch_embeddings.kernel.dtype == torch.float32
    assert isinstance(model.predictions.kernel_scale, torch.Tensor)
    assert "predictions.kernel_scale" in dict(model.named_buffers())
    # load_state_dict into the quantized model keeps int8 and re-derives
    # the GEMM operands
    sd2 = {k: (torch.zeros_like(v) if v.dtype == torch.int8 else v)
           for k, v in sd.items()}
    model.load_state_dict(sd2)
    assert model.predictions.kernel.dtype == torch.int8
    assert not model.predictions._kernel_gemm.any()


@pytest.mark.parametrize("include,quantized", [
    (r"predictions", {"predictions.kernel"}),
    (r"layers\.1\.dense", {"encoder.layers.1.dense1.kernel",
                           "encoder.layers.1.dense2.kernel"}),
])
def test_include_restricts_the_quantized_set(include, quantized):
    sd = _tiny_port_vit().state_dict()
    out = tq.quantize_state_dict(sd, include=include)
    assert {k for k, v in out.items() if v.dtype == torch.int8} == quantized


@pytest.mark.parametrize("case", [
    "already_quantized", "nothing_matches", "splits_projection",
    "splits_query_key"])
def test_quantize_state_dict_refuses(case):
    sd = MultiHeadAttention(16, 8, 2, device=CPU).state_dict()
    match, kw = {
        "already_quantized": ("already quantized", {}),
        "nothing_matches": ("no quantizable", {"include": "no_such_param"}),
        "splits_projection": ("splits the quantization group",
                              {"include": r"w_projection$"}),
        "splits_query_key": ("splits the quantization group",
                             {"include": r"w_(query|key)$"}),
    }[case]
    if case == "already_quantized":
        sd = tq.quantize_state_dict(sd)
    with pytest.raises(ValueError, match=match):
        tq.quantize_state_dict(sd, **kw)


def test_dequantize_round_trip():
    dense = tq.QuantDense(32, 16, device=CPU)
    dense.reset_parameters(torch.Generator().manual_seed(7))
    sd = dense.state_dict()
    back = tq.dequantize_state_dict(tq.quantize_state_dict(sd))
    assert sorted(back) == sorted(sd)
    assert back["kernel"].dtype == torch.float32
    assert _rel_err(back["kernel"], sd["kernel"]) < 0.005
    assert torch.equal(back["bias"], sd["bias"])
    with pytest.raises(ValueError, match="no quantization scales"):
        tq.dequantize_state_dict(sd)


def test_load_refuses_a_state_dict_of_another_model():
    qsd = tq.quantize_state_dict(tq.QuantDense(8, 8, device=CPU).state_dict())
    with pytest.raises(ValueError, match="no entries"):
        tq.load_quantized_state_dict(tq.QuantDense(8, 8, device=CPU),
                                     dict(qsd, extra=torch.zeros(1)))
