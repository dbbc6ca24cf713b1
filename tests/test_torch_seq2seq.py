"""The port's positional encoding, decoder blocks and Seq2SeqTransformer
against the JAX package's on the same weights (the JAX package's seeded
init, converted with ``state_dict_from_jax``) and the same numpy tokens, in
float32 on the CPU; the JAX flash kernels run in interpret mode.

Tolerances: 1e-4 for a decoder layer or stack (the reference's encoder-layer
gate; sums run in another order in the two frameworks), loss rtol 1e-5 and
gradients atol 1e-4 for the whole model (the JAX package's own flash-vs-dense
gates in ``tests/models/test_seq2seq.py``), and rtol 1e-4 on the losses of
three AdamW steps."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chambers_tpu.layers import embedding as jemb
from chambers_tpu.layers.transformer import Decoder as JaxDecoder
from chambers_tpu.layers.transformer import DecoderLayer as JaxDecoderLayer
from chambers_tpu.models import Seq2SeqTransformer as JaxSeq2Seq
from chambers_tpu_torch import initializers
from chambers_tpu_torch.layers import embedding as temb
from chambers_tpu_torch.layers.transformer import (
    Decoder,
    DecoderLayer,
    Encoder,
    EncoderLayer,
)
from chambers_tpu_torch.models import Seq2SeqTransformer
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax

CPU = "cpu"
D, N_HEADS, FF = 32, 2, 64
VOCAB = 16


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return module.eval()


def _perturbed(params, seed=5):
    """Biases and norm offsets start at zero: move every leaf so that each
    parameter matters."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        tree, [a + 0.05 * rng.randn(*a.shape).astype(np.float32)
               for a in leaves])


@pytest.mark.parametrize("seq_len,dim,temperature",
                         [(12, 32, 10000.0), (512, 512, 10000.0),
                          (7, 6, 50.0)])
def test_positional_encoding_1d_bit_equal(seq_len, dim, temperature):
    want = jemb.positional_encoding_1d(seq_len, dim, temperature)
    got = temb.positional_encoding_1d(seq_len, dim, temperature)
    assert got.dtype == np.float32 and got.shape == (1, seq_len, dim)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("add_to_input", [True, False])
def test_positional_encoding_module_bit_equal(dtype, add_to_input):
    x = _rand((2, 9, 16))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jemb.PositionalEncoding1D(add_to_input=add_to_input).apply(
        {}, jnp.asarray(x, jdt))
    module = temb.PositionalEncoding1D(add_to_input=add_to_input)
    got = module(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert not list(module.parameters())


def _masks(b, t, tm):
    q_mask = np.ones((b, t), bool)
    q_mask[0, t - 3:] = False
    v_mask = np.ones((b, tm), bool)
    v_mask[1, tm - 4:] = False
    return q_mask, v_mask


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("pre_norm", [False, True])
def test_decoder_layer(pre_norm, impl):
    x, mem = _rand((2, 9, D), 1), _rand((2, 11, D), 2)
    q_mask, v_mask = _masks(2, 9, 11)
    jmod = JaxDecoderLayer(embed_dim=D, num_heads=N_HEADS, ff_dim=FF,
                           pre_norm=pre_norm, attention_impl=impl)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), [x, mem])["params"])
    want = jmod.apply({"params": params}, [x, mem], mask=[q_mask, v_mask])
    port = _load(DecoderLayer(D, N_HEADS, FF, pre_norm=pre_norm,
                              attention_impl=impl, device=CPU), params)
    got = port([torch.from_numpy(x), torch.from_numpy(mem)],
               mask=[torch.from_numpy(q_mask), torch.from_numpy(v_mask)])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)


def test_decoder_layer_pre_norm_normalises_memory_with_norm2():
    """The quirk: scaling the memory leaves the pre-norm output unchanged
    (it is normalised by norm2 first) and changes the post-norm output."""
    x, mem = torch.from_numpy(_rand((1, 5, D), 3)), \
        torch.from_numpy(_rand((1, 6, D), 4))
    for pre_norm, same in ((True, True), (False, False)):
        layer = DecoderLayer(D, N_HEADS, FF, pre_norm=pre_norm, device=CPU)
        initializers.init_module(layer, torch.Generator().manual_seed(0))
        layer.eval()
        a, b = layer([x, mem]), layer([x, 3.0 * mem])
        assert bool(torch.allclose(a, b, atol=1e-4)) is same


@pytest.mark.parametrize("kind", ["post_norm", "pre_norm_output_norm",
                                  "return_sequence", "flash_not_causal"])
def test_decoder_stack(kind):
    x, mem = _rand((2, 9, D), 6), _rand((2, 11, D), 7)
    q_mask, v_mask = _masks(2, 9, 11)
    kw = {
        "post_norm": dict(),
        "pre_norm_output_norm": dict(pre_norm=True, norm_output=True),
        "return_sequence": dict(return_sequence=True, norm_output=True),
        "flash_not_causal": dict(attention_impl="flash", causal=False),
    }[kind]
    jmod = JaxDecoder(embed_dim=D, num_heads=N_HEADS, ff_dim=FF, num_layers=2,
                      **kw)
    params = _perturbed(jmod.init(jax.random.PRNGKey(1), [x, mem])["params"])
    want = jmod.apply({"params": params}, [x, mem], mask=[q_mask, v_mask])
    port = _load(Decoder(D, N_HEADS, FF, 2, device=CPU, **kw), params)
    got = port([torch.from_numpy(x), torch.from_numpy(mem)],
               mask=[torch.from_numpy(q_mask), torch.from_numpy(v_mask)])
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)


def test_stacks_refuse_moe():
    for cls in (Encoder, Decoder):
        with pytest.raises(NotImplementedError):
            cls(D, N_HEADS, FF, 2, moe_every_n=2, device=CPU)


def test_dense_dropout_keep_share_scaling_and_determinism():
    rate = 0.2
    layer = EncoderLayer(D, N_HEADS, FF, attention_dropout_rate=0.0,
                         dense_dropout_rate=rate, device=CPU)
    initializers.init_module(layer, torch.Generator().manual_seed(0))
    ones = torch.ones(64, 64, D)
    dropped = layer._drop(ones, False, torch.Generator().manual_seed(1))
    kept = dropped != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    assert bool(torch.allclose(dropped[kept],
                               torch.tensor(1.0 / (1 - rate))))
    assert torch.equal(layer._drop(ones, True, None), ones)
    x = torch.from_numpy(_rand((2, 9, D), 8))
    a = layer.train()(x, generator=torch.Generator().manual_seed(2))
    b = layer(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, layer.eval()(x))
    assert torch.equal(layer.train()(x, deterministic=True), layer.eval()(x))


def _tokens():
    """``[4, 12]`` ragged padded tokens, as tests/models/test_seq2seq.py."""
    rng = np.random.RandomState(0)
    src = rng.randint(1, VOCAB, (4, 12)).astype(np.int32)
    src[:, 9:] = 0
    src[0, 5:] = 0
    tgt = rng.randint(1, VOCAB, (4, 12)).astype(np.int32)
    tgt[:, 10:] = 0
    return src, tgt


def _models(impl):
    kw = dict(input_vocab_size=VOCAB, output_vocab_size=VOCAB, embed_dim=D,
              num_heads=N_HEADS, dim_feedforward=FF, num_encoder_layers=2,
              num_decoder_layers=2, dropout_rate=0.0, attention_impl=impl)
    return JaxSeq2Seq(**kw), Seq2SeqTransformer(device=CPU, **kw)


def _jax_loss(model, src, tgt):
    def loss(params):
        logits = model.apply({"params": params}, (src, tgt),
                             deterministic=True)
        labels = jnp.roll(tgt, -1, axis=1)
        mask = (labels != 0).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), labels)
        return jnp.sum(ce * mask) / jnp.sum(mask)
    return loss


def _torch_loss(model, src, tgt):
    logits = model([src, tgt], deterministic=True)
    labels = torch.roll(tgt, -1, dims=1)
    mask = (labels != 0).float()
    ce = torch.nn.functional.cross_entropy(
        logits.float().flatten(0, 1), labels.flatten().long(),
        reduction="none")
    return (ce * mask.flatten()).sum() / mask.sum()


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_seq2seq_logits_loss_and_gradients(impl):
    src, tgt = _tokens()
    jmodel, port = _models(impl)
    params = _perturbed(
        jmodel.init(jax.random.PRNGKey(0), (src, tgt))["params"])
    _load(port, params)
    tsrc, ttgt = torch.from_numpy(src), torch.from_numpy(tgt)

    want = jmodel.apply({"params": params}, (src, tgt))
    got = port([tsrc, ttgt])
    assert tuple(got.shape) == (4, 12, VOCAB)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    memory, input_mask = port.encode(tsrc)
    assert torch.equal(input_mask, tsrc != 0)
    assert torch.equal(port.decode(ttgt, memory, input_mask), got)

    loss_want, grads = jax.value_and_grad(_jax_loss(jmodel, src, tgt))(params)
    loss = _torch_loss(port, tsrc, ttgt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_want), rtol=1e-5)
    want_grads = state_dict_from_jax(jax.device_get(grads))
    named = dict(port.named_parameters())
    assert set(named) == set(want_grads)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("lr", [1e-4, 1e-2])
def test_seq2seq_adamw_steps_match_optax(lr):
    """lr 1e-4 is the train step's own; 1e-2 moves the weights enough in
    three steps for a wrong update to show."""
    src, tgt = _tokens()
    jmodel, port = _models("flash")
    params = jmodel.init(jax.random.PRNGKey(0), (src, tgt))["params"]
    _load(port, params).train()
    tsrc, ttgt = torch.from_numpy(src), torch.from_numpy(tgt)

    opt = optax.adamw(lr, weight_decay=1e-4)
    state = opt.init(params)
    want = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(_jax_loss(jmodel, src, tgt))(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))

    topt = torch.optim.AdamW(port.parameters(), lr=lr, weight_decay=1e-4,
                             betas=(0.9, 0.999), eps=1e-8)
    got = []
    for _ in range(3):
        topt.zero_grad(set_to_none=True)
        loss = _torch_loss(port, tsrc, ttgt)
        loss.backward()
        topt.step()
        got.append(loss.item())
    assert got[2] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_seq2seq_padding_and_causality():
    src, tgt = _tokens()
    _, port = _models("flash")
    initializers.init_module(port, torch.Generator().manual_seed(0)).eval()
    tsrc, ttgt = torch.from_numpy(src), torch.from_numpy(tgt)
    base = port([tsrc, ttgt])
    later = ttgt.clone()
    later[:, 8] = (later[:, 8] % (VOCAB - 1)) + 1
    changed = port([tsrc, later])
    assert bool(torch.allclose(base[:, :8], changed[:, :8], atol=1e-5))
    assert not bool(torch.allclose(base[:, 8], changed[:, 8], atol=1e-5))
    other = tsrc.clone()
    other[1, 2] = (other[1, 2] % (VOCAB - 1)) + 1
    assert not bool(torch.allclose(base[1], port([other, ttgt])[1],
                                   atol=1e-5))


def test_seq2seq_on_flash_refuses_active_attention_dropout():
    """The flash kernels have no dropout; the model raises instead of
    quietly running dense attention."""
    src, tgt = (torch.from_numpy(x) for x in _tokens())
    kw = dict(embed_dim=D, num_heads=N_HEADS, dim_feedforward=FF,
              num_encoder_layers=1, num_decoder_layers=1,
              attention_impl="flash", device=CPU)
    model = Seq2SeqTransformer(VOCAB, VOCAB, dropout_rate=0.1, **kw)
    initializers.init_module(model, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="dropout"):
        model.train()([src, tgt])
    assert bool(torch.isfinite(model.eval()([src, tgt])).all())
    assert bool(torch.isfinite(model.train()([src, tgt],
                                             deterministic=True)).all())


def test_seq2seq_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        Seq2SeqTransformer(VOCAB, VOCAB, D, N_HEADS, FF, 1, 1)
