"""The port's generation (``chambers_tpu_torch.models.generation``) and the
decode cache under it against the JAX package's, on the 2 + 2-layer,
width-32 model of ``tests/models/test_generation.py`` with the JAX
package's seeded init converted by ``state_dict_from_jax``, in float32 on
the CPU; the JAX flash kernels run in interpret mode, the port's through
their plain versions.

Tolerances: cached-step logits 1e-5 (float32 sums in another order);
tokens equal; beam scores 1e-5; ``apply_top_k_top_p`` equal to the bit
(the same float32 comparisons). Sampling is held by feeding the port the
Gumbel noise that ``jax.random.categorical`` draws."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.models import Seq2SeqTransformer as JaxSeq2Seq
from chambers_tpu.models import generation as jgen
from chambers_tpu_torch import quantization
from chambers_tpu_torch.models import (
    QuantizedDecodeWarning,
    Seq2SeqTransformer,
    apply_top_k_top_p,
    beam_search_decode,
    greedy_decode,
    sample_decode,
)
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from test_torch_package import one_torch_thread  # noqa: F401

BOS, VOCAB, MAX_LEN = 1, 16, 8
CONFIG = dict(input_vocab_size=VOCAB, output_vocab_size=VOCAB, embed_dim=32,
              num_heads=2, dim_feedforward=64, num_encoder_layers=2,
              num_decoder_layers=2, dropout_rate=0.0)


def _perturbed(params, seed=3):
    """Biases and norm offsets start at zero: move every leaf so that each
    parameter matters."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        tree, [a + 0.1 * rng.randn(*a.shape).astype(np.float32)
               for a in leaves])


@pytest.fixture(scope="module")
def params():
    dummy = (jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32))
    variables = JaxSeq2Seq(**CONFIG).init(jax.random.PRNGKey(0), dummy)
    return _perturbed(variables["params"])


def _models(params, impl):
    jmodel = JaxSeq2Seq(**CONFIG, attention_impl=impl)
    port = Seq2SeqTransformer(**CONFIG, attention_impl=impl, device="cpu")
    port.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return jmodel, {"params": params}, port.eval()


def _sources(seed, b=3, t=8):
    """Source tokens with trailing padding in some rows, none all padding."""
    src = np.random.default_rng(seed).integers(1, VOCAB, (b, t))
    src[0, t - 3:] = 0
    if b > 2:
        src[2, t - 1:] = 0
    return src.astype(np.int32)


def _port(x):
    return torch.from_numpy(np.asarray(x, np.int64))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_decode_step_logits_match_jax(params, impl):
    """Teacher-forced cached steps (one pad token among them): each step's
    logits against JAX's cached ``decode_step`` over its primed cache."""
    jmodel, variables, port = _models(params, impl)
    src = _sources(1)
    feed = np.random.default_rng(2).integers(1, VOCAB, (3, MAX_LEN))
    feed[:, 0] = BOS
    feed[1, 3] = 0
    step, cache = jgen._prime_cache(jmodel, variables, jnp.asarray(src),
                                    MAX_LEN)
    with torch.no_grad():
        x_enc, input_mask = port.encode(_port(src), deterministic=True)
        pcache = port.init_cache(x_enc, MAX_LEN)
        for i in range(MAX_LEN):
            want, cache = step(jnp.asarray(feed[:, i:i + 1]), i, cache)
            got, pcache = port.decode_step(_port(feed[:, i:i + 1]), i, x_enc,
                                           input_mask, MAX_LEN, pcache)
            assert got.shape == (3, 1, VOCAB)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)
    layer0 = pcache[0]["multi_head_attention1"]
    assert layer0["cache_index"] == MAX_LEN
    np.testing.assert_array_equal(layer0["valid_mask"].numpy(), feed != 0)


def test_primed_cache_equals_jax_priming(params):
    """JAX primes by running the decoder over a zero buffer; the port
    allocates the buffers and projects the memory once: the same cache."""
    jmodel, variables, port = _models(params, "xla")
    src = _sources(4)
    _, cache = jgen._prime_cache(jmodel, variables, jnp.asarray(src),
                                 MAX_LEN)
    with torch.no_grad():
        x_enc, _ = port.encode(_port(src), deterministic=True)
        pcache = port.init_cache(x_enc, MAX_LEN)
    jcache = cache["cache"]["decoder"]
    for i, layer in enumerate(pcache):
        for attn, entries in layer.items():
            for name, value in entries.items():
                want = np.asarray(jcache[f"layers_{i}"][attn][name])
                got = value if isinstance(value, int) else value.numpy()
                np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_greedy_matches_jax(params, impl, use_cache):
    jmodel, variables, port = _models(params, impl)
    src = _sources(5, b=4)
    want = jgen.greedy_decode(jmodel, variables, jnp.asarray(src),
                              max_len=MAX_LEN, bos_id=BOS,
                              use_cache=use_cache)
    got = greedy_decode(port, _port(src), max_len=MAX_LEN, bos_id=BOS,
                        use_cache=use_cache)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("beam", [
    dict(beam_size=3),
    dict(beam_size=4, eos_id=2, length_penalty=0.6),
    dict(beam_size=2, eos_id=5)])
@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_beam_search_matches_jax(params, impl, use_cache, beam):
    jmodel, variables, port = _models(params, impl)
    src = _sources(6)
    want, want_scores = jgen.beam_search_decode(
        jmodel, variables, jnp.asarray(src), max_len=MAX_LEN, bos_id=BOS,
        return_scores=True, use_cache=use_cache, **beam)
    got, scores = beam_search_decode(
        port, _port(src), max_len=MAX_LEN, bos_id=BOS, return_scores=True,
        use_cache=use_cache, **beam)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               atol=1e-5, rtol=1e-5)


def _jax_noise(key, b, steps):
    """The Gumbel noise ``jax.random.categorical`` adds at each step of
    ``sample_decode`` (its key folded with the step index)."""
    return [np.array(jax.random.gumbel(jax.random.fold_in(key, i),
                                       (b, VOCAB)))
            for i in range(steps)]


def test_categorical_is_argmax_of_gumbel_plus_logits():
    """What the port relies on: JAX's draw is the argmax of its Gumbel noise
    added to the logits."""
    key = jax.random.PRNGKey(11)
    logits = jnp.asarray(np.random.RandomState(0).randn(64, VOCAB),
                         jnp.float32)
    want = jax.random.categorical(key, logits, axis=-1)
    noise = jax.random.gumbel(key, logits.shape)
    np.testing.assert_array_equal(np.asarray(jnp.argmax(logits + noise, -1)),
                                  np.asarray(want))


@pytest.mark.parametrize("options", [
    dict(temperature=0.8),
    dict(temperature=0.8, top_k=5, top_p=0.9),
    dict(temperature=2.0, top_p=0.5, eos_id=3),
    dict(temperature=1.0, top_k=1)])
@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_sample_matches_jax_given_its_noise(params, impl, use_cache,
                                            options):
    jmodel, variables, port = _models(params, impl)
    src = _sources(7, b=4)
    key = jax.random.PRNGKey(3)
    want = jgen.sample_decode(jmodel, variables, jnp.asarray(src), key,
                              max_len=MAX_LEN, bos_id=BOS,
                              use_cache=use_cache, **options)
    got = sample_decode(port, _port(src), max_len=MAX_LEN, bos_id=BOS,
                        use_cache=use_cache,
                        gumbel_noise=_jax_noise(key, 4, MAX_LEN), **options)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_k,top_p", [(None, None), (3, None), (1, None),
                                         (40, None), (None, 0.3),
                                         (None, 1.0), (4, 0.8), (6, 0.05)])
def test_apply_top_k_top_p_matches_jax(top_k, top_p):
    """Seeded logits rounded to a coarse grid, so that values tie at the
    top-k threshold and inside the nucleus."""
    logits = np.round(np.random.RandomState(9).randn(6, 32) * 2) / 2
    logits = logits.astype(np.float32)
    want = jgen.apply_top_k_top_p(jnp.asarray(logits), top_k, top_p)
    got = apply_top_k_top_p(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.isfinite(got.numpy()).sum(-1) >= 1).all()


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_cached_equals_full_recompute(params, impl):
    _, _, port = _models(params, impl)
    src = _port(_sources(8, b=4))
    kw = dict(max_len=MAX_LEN, bos_id=BOS)
    for decode, extra in (
            (greedy_decode, {}),
            (greedy_decode, dict(eos_id=4)),
            (beam_search_decode, dict(beam_size=3, eos_id=2,
                                      length_penalty=0.6)),
            (sample_decode, dict(temperature=1.5, top_k=8, gumbel_noise=[
                torch.from_numpy(x) for x in
                _jax_noise(jax.random.PRNGKey(5), 4, MAX_LEN)]))):
        cached = decode(port, src, use_cache=True, **kw, **extra)
        full = decode(port, src, use_cache=False, **kw, **extra)
        assert torch.equal(cached, full), (decode.__name__, extra)


def test_sample_from_a_generator_is_seeded(params):
    _, _, port = _models(params, "xla")
    src = _port(_sources(9, b=4))

    def draw(seed):
        return sample_decode(port, src, torch.Generator().manual_seed(seed),
                             max_len=MAX_LEN, bos_id=BOS, temperature=2.0)

    assert torch.equal(draw(1), draw(1))
    assert not torch.equal(draw(1), draw(2))
    cold = sample_decode(port, src, torch.Generator().manual_seed(1),
                         max_len=MAX_LEN, bos_id=BOS, temperature=1e-4)
    assert torch.equal(cold, greedy_decode(port, src, max_len=MAX_LEN,
                                           bos_id=BOS))


def test_beam_size_1_equals_greedy(params):
    _, _, port = _models(params, "xla")
    src = _port(_sources(10))
    assert torch.equal(
        beam_search_decode(port, src, max_len=MAX_LEN, bos_id=BOS,
                           beam_size=1),
        greedy_decode(port, src, max_len=MAX_LEN, bos_id=BOS))


@pytest.mark.parametrize("use_cache", [True, False])
def test_eos_pads_the_tail(params, use_cache):
    _, _, port = _models(params, "xla")
    src = _port(_sources(11, b=4))
    plain = greedy_decode(port, src, max_len=MAX_LEN, bos_id=BOS,
                          use_cache=use_cache).numpy()
    eos = int(plain[0, 1])
    stopped = greedy_decode(port, src, max_len=MAX_LEN, bos_id=BOS,
                            eos_id=eos, use_cache=use_cache).numpy()
    for row_p, row_s in zip(plain, stopped):
        hits = np.nonzero(row_s == eos)[0]
        if hits.size:
            first = hits[0]
            np.testing.assert_array_equal(row_s[:first + 1],
                                          row_p[:first + 1])
            assert (row_s[first + 1:] == 0).all()
        else:
            np.testing.assert_array_equal(row_s, row_p)
    assert (stopped == eos).any()


def test_validation_errors(params):
    _, _, port = _models(params, "xla")
    src = _port(_sources(12))
    kw = dict(max_len=4, bos_id=BOS)
    with pytest.raises(ValueError, match="temperature"):
        sample_decode(port, src, temperature=0.0, **kw)
    with pytest.raises(ValueError, match="beam_size"):
        beam_search_decode(port, src, beam_size=0, **kw)
    with pytest.raises(ValueError, match="top_k"):
        apply_top_k_top_p(torch.zeros(2, 4), top_k=0)
    with pytest.raises(ValueError, match="top_p"):
        apply_top_k_top_p(torch.zeros(2, 4), top_p=1.5)

    class Plain(torch.nn.Module):
        """A module with the full forward only: no cache."""

        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, inputs, deterministic=None):
            return self.inner(inputs, deterministic=deterministic)

    plain = Plain(port)
    with pytest.raises(NotImplementedError, match="use_cache=False"):
        greedy_decode(plain, src, use_cache=True, **kw)
    assert torch.equal(greedy_decode(plain, src, **kw),
                       greedy_decode(port, src, use_cache=False, **kw))
    layer = port.decoder.layers[0].multi_head_attention1
    cache = layer.init_self_cache(3, 4, torch.float32, "cpu")
    x = torch.zeros(3, 2, 32)
    with pytest.raises(ValueError, match="one query position"):
        layer([x, x, x], cache=cache, index=0)


def test_quantized_decode_warns(params):
    _, _, port = _models(params, "xla")
    src = _port(_sources(13))
    with warnings.catch_warnings():
        warnings.simplefilter("error", QuantizedDecodeWarning)
        greedy_decode(port, src, max_len=2, bos_id=BOS)
    quantization.quantize_model(port)
    with pytest.warns(QuantizedDecodeWarning):
        out = greedy_decode(port, src, max_len=4, bos_id=BOS)
    with pytest.warns(QuantizedDecodeWarning):
        full = greedy_decode(port, src, max_len=4, bos_id=BOS,
                             use_cache=False)
    assert torch.equal(out, full)


def test_all_padding_source_is_a_known_difference(params):
    """A source row that is all padding leaves its encoder self-attention
    and its cross attention no valid key: the flash kernel returns zeros
    there, dense attention the uniform average (in a cached step JAX runs
    dense attention). The other rows agree; the padded row's dense logits
    are JAX's."""
    jmodel, variables, dense = _models(params, "xla")
    _, _, flash = _models(params, "flash")
    src = _sources(14)
    src[1] = 0
    feed = _port(np.full((3, 1), BOS))
    logits = {}
    with torch.no_grad():
        for name, port in (("xla", dense), ("flash", flash)):
            x_enc, mask = port.encode(_port(src), deterministic=True)
            cache = port.init_cache(x_enc, MAX_LEN)
            logits[name] = port.decode_step(feed, 0, x_enc, mask, MAX_LEN,
                                            cache)[0].numpy()
    step, cache = jgen._prime_cache(jmodel, variables, jnp.asarray(src),
                                    MAX_LEN)
    want = np.asarray(step(jnp.asarray(feed.numpy()), 0, cache)[0])
    np.testing.assert_allclose(logits["xla"], want, atol=1e-5, rtol=1e-5)
    for row in (0, 2):
        np.testing.assert_allclose(logits["flash"][row], want[row],
                                   atol=1e-5, rtol=1e-5)
    assert np.abs(logits["flash"][1] - want[1]).max() > 1e-2


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("pre_norm", [False, True])
def test_decoder_cache_steps_equal_the_full_length_decoder(pre_norm, impl):
    """A ``Decoder`` run one position at a time through its cache gives the
    full-length causal decoder's output at every position, padded target
    positions included, in both norm orders (pre-norm caches the memory
    after ``norm2``)."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.layers.transformer import Decoder

    decoder = Decoder(32, 2, 64, 2, pre_norm=pre_norm, norm_output=pre_norm,
                      attention_impl=impl, device="cpu")
    initializers.init_module(decoder, torch.Generator().manual_seed(0))
    decoder.eval()
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(3, 6, 32).astype(np.float32))
    memory = torch.from_numpy(rng.randn(3, 9, 32).astype(np.float32))
    target_mask = torch.ones(3, 6, dtype=torch.bool)
    target_mask[1, 2] = target_mask[2, 4:] = False
    memory_mask = torch.ones(3, 9, dtype=torch.bool)
    memory_mask[0, 6:] = False
    with torch.no_grad():
        full = decoder([x, memory], mask=[target_mask, memory_mask])
        cache = decoder.init_cache(memory, 6)
        for i in range(6):
            step = decoder([x[:, i:i + 1], memory],
                           mask=[target_mask[:, i:i + 1], memory_mask],
                           cache=cache, index=i)
            np.testing.assert_allclose(step[:, 0].numpy(),
                                       full[:, i].numpy(), atol=1e-5)


@pytest.mark.parametrize("decode,extra", [
    (greedy_decode, {}),
    (beam_search_decode, dict(beam_size=2)),
    (sample_decode, dict(temperature=1.5)),
], ids=["greedy", "beam", "sample"])
def test_decoding_records_no_autograd_graph(params, decode, extra):
    """Every decoder runs its steps with autograd off, so a module whose
    parameters require grad saves no activations while it decodes."""
    _, _, port = _models(params, "xla")
    assert all(p.requires_grad for p in port.parameters())
    seen = []
    hooks = [m.register_forward_hook(
        lambda *_: seen.append(torch.is_grad_enabled()))
        for m in port.modules()]
    try:
        out = decode(port, _port(_sources(12)), max_len=MAX_LEN, bos_id=BOS,
                     **extra)
    finally:
        for hook in hooks:
            hook.remove()
    assert torch.is_grad_enabled()
    assert not out.requires_grad
    assert seen and not any(seen)
