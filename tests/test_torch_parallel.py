"""``chambers_tpu_torch.parallel`` over gloo in spawned worlds of 2 and 4
processes (``torch_parallel_workers.run_world``), held against the JAX
package's ``parallel`` on the same seeded inputs and weights.

The references are JAX's own results, computed here on its 8 virtual CPU
devices (``tests/conftest.py``): single-device runs, which the JAX package's
own tests hold equal to its sharded ones. One world a size runs every
check (``torch_parallel_workers.CHECKS``); each test reads one result. The
equalities are those of ``__graft_entry__.dryrun_multichip`` and the cases
of ``tests/test_parallel.py``, ``test_distributed.py``, ``test_fsdp.py``,
``test_pipeline_parallel.py``, ``test_parallel_composition.py`` and the
five expert-parallel cases of ``tests/layers/test_moe.py``.

Tolerances: float32 results that sum partial products in another order
(all-reduced tensor-parallel products, gathered gradients) to the JAX
tests' own 1e-5 (relative for losses, absolute for activations); integer
tokens exactly. Where dropout is on in the JAX test (the ViT step of
``dryrun_multichip``), both packages run it deterministic: their random
streams differ.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import linen as nn

from chambers_tpu import optimizers as jopt
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax

import torch_parallel_workers as W

BOS = 1


def _state(params):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.device_get(params)).items()}


def _apply_updates(opt, params, grads, state):
    updates, state = opt.update(grads, state, params)
    return optax.apply_updates(params, updates), state


# ---------------------------------------------------------------------------
# JAX references, one builder a check: (worker kwargs, expected)
# ---------------------------------------------------------------------------

def ref_mesh_api(n):
    z = np.zeros
    tp_params = {"encoder": {"layers_0": {
        "multi_head_attention": {
            "w_query": z((16, 4, 4), np.float32),
            "b_query": z((4, 1, 4), np.float32),
            "w_projection": z((4, 16, 4), np.float32),
            "b_projection": z((1, 16), np.float32)},
        "dense1": {"kernel": z((16, 32), np.float32),
                   "bias": z(32, np.float32)},
        "dense2": {"kernel": z((32, 16), np.float32),
                   "bias": z(16, np.float32)},
        "norm1": {"scale": np.ones(16, np.float32),
                  "bias": z(16, np.float32)}}}}
    return dict(tp_params=tp_params), None


def ref_dp_grad(n):
    w = np.ones((4, 1), np.float32)
    x = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    y = np.random.RandomState(1).randn(16, 1).astype(np.float32)
    grad = jax.grad(lambda w: jnp.mean((x @ w - y) ** 2))(jnp.asarray(w))
    return dict(w=w, x=x, y=y), np.asarray(grad)


def ref_tp_mha(n):
    from chambers_tpu.layers import MultiHeadAttention

    mha = MultiHeadAttention(head_dim=8, num_heads=4, dropout_rate=0.0)
    x = np.random.RandomState(0).randn(4, 6, 32).astype(np.float32)
    variables = mha.init(jax.random.PRNGKey(0), [x, x])
    return (dict(state=_state(variables["params"]), x=x, model=min(4, n)),
            np.asarray(mha.apply(variables, [x, x])))


def ref_dp_tp_vit(n):
    from chambers_tpu.layers import l2_normalize
    from chambers_tpu.losses import MultiSimilarityLoss
    from chambers_tpu.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    vit = VisionTransformer(patch_size=8, patch_dim=32, n_encoder_layers=2,
                            n_heads=4, ff_dim=64, dropout_rate=0.1,
                            include_top=False, pooling="cls")
    model, batch = 2, 8
    images = np.random.RandomState(0).rand(batch, 16, 16, 3).astype(
        np.float32)
    labels = np.arange(batch, dtype=np.int64) % max(batch // 2, 1)
    params = vit.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, 3)))["params"]
    opt = jopt.AdamW(weight_decay=1e-4, learning_rate=1e-3,
                  decay_exclude=["bias", "norm"])
    loss_fn = MultiSimilarityLoss()

    @jax.jit
    def step(params, state):
        def loss_of(p):
            z = vit.apply({"params": p}, images, deterministic=True)
            return loss_fn(labels, l2_normalize(z, axis=-1))

        loss, grads = jax.value_and_grad(loss_of)(params)
        params, state = _apply_updates(opt, params, grads, state)
        return params, state, loss, grads

    state = opt.init(params)
    p1, state, l1, grads = step(params, state)
    _, _, l2, _ = step(p1, state)
    return (dict(state=_state(params), images=images, labels=labels,
                 model=model),
            {"losses": [float(l1), float(l2)], "grads": _state(grads)})


def _encoder_layer(d, heads, ff):
    from chambers_tpu.layers.transformer import EncoderLayer

    return EncoderLayer(embed_dim=d, num_heads=heads, ff_dim=ff,
                        pre_norm=True, attention_dropout_rate=0.0,
                        dense_dropout_rate=0.0)


def ref_pp_step(n):
    layer = _encoder_layer(16, 2, 32)
    layers = [layer.init(jax.random.PRNGKey(i), jnp.zeros((1, 4, 16)))[
        "params"] for i in range(4)]
    x = np.random.RandomState(1).randn(8, 4, 16).astype(np.float32)

    def loss_of(layers):
        h = x
        for p in layers:
            h = layer.apply({"params": p}, h, deterministic=True)
        return jnp.mean(h ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(layers)
    return (dict(states=[_state(p) for p in layers], x=x),
            {"loss": float(loss), "grads": [_state(g) for g in grads]})


def _moe_layer(d, heads, ff):
    from chambers_tpu.layers.moe import MoEEncoderLayer

    return MoEEncoderLayer(
        embed_dim=d, num_heads=heads, ff_dim=ff, n_experts=4, pre_norm=True,
        n_selected_experts=2, router_z_loss_weight=1e-3,
        attention_dropout_rate=0.0, dense_dropout_rate=0.0)


def _moe_reference(layer, x, update):
    from chambers_tpu.layers.moe import moe_aux_loss

    params = layer.init(jax.random.PRNGKey(0), x)["params"]

    def loss_of(p):
        y, state = layer.apply({"params": p}, x, mutable=["intermediates"])
        return jnp.mean(y ** 2) + moe_aux_loss(state["intermediates"])

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    return params, float(loss), _state(update(params, grads))


def ref_ep_dp_step(n):
    x = np.random.RandomState(2).randn(8, 6, 16).astype(np.float32)
    params, loss, new = _moe_reference(
        _moe_layer(16, 2, 32), x,
        lambda p, g: jax.tree.map(lambda a, b: a - 1e-3 * b, p, g))
    return dict(state=_state(params), x=x), {"loss": loss, "params": new}


def ref_dp_tp_ep_step(n):
    x = np.random.default_rng(0).normal(size=(8, 6, 32)).astype(np.float32)
    opt = jopt.AdamW(weight_decay=1e-4, learning_rate=1e-3)
    params, loss, new = _moe_reference(
        _moe_layer(32, 4, 64), x,
        lambda p, g: _apply_updates(opt, p, g, opt.init(p))[0])
    return dict(state=_state(params), x=x), {"loss": loss, "params": new}


def _dense_attention(q, v, k):
    s = jnp.einsum("bnqh,bnkh->bnqk", q, k) / math.sqrt(q.shape[-1])
    return jnp.einsum("bnqk,bnkh->bnqh", jax.nn.softmax(s, axis=-1), v)


def ref_cp_dryrun(n):
    """dryrun_multichip's CP: q tokens over every rank, forward and grad,
    against JAX's dense attention (which the JAX package's tests hold its
    context-parallel attention to)."""
    rng = np.random.RandomState(3)
    q = rng.randn(1, 2, 64, 16).astype(np.float32)
    v = rng.randn(1, 2, 64, 16).astype(np.float32)

    def loss(q):
        return jnp.sum(_dense_attention(q, v, v) ** 2)

    value, grad = jax.value_and_grad(loss)(jnp.asarray(q))
    return dict(q=q, v=v), {"value": float(value), "grad": np.asarray(grad),
                            "out": np.asarray(_dense_attention(q, v, v))}


def ref_cp_dense(n):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 4, 64, 32).astype(np.float32) for _ in range(3))
    return dict(q=q, v=v, k=k), {"out": np.asarray(_dense_attention(q, v, k))}


def ref_decode(n):
    from chambers_tpu.models import (
        Seq2SeqTransformer,
        beam_search_decode,
        greedy_decode,
    )

    module = Seq2SeqTransformer(
        input_vocab_size=24, output_vocab_size=24, embed_dim=32,
        num_heads=4, dim_feedforward=64, num_encoder_layers=2,
        num_decoder_layers=2, dropout_rate=0.0)
    dummy = (jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32))
    variables = module.init(jax.random.PRNGKey(0), dummy)
    src_dp = np.random.default_rng(11).integers(1, 24, (8, 8)).astype(
        np.int32)
    src_beam = np.random.default_rng(12).integers(1, 24, (8, 8)).astype(
        np.int32)
    src_tp = np.random.default_rng(13).integers(1, 24, (4, 8)).astype(
        np.int32)
    greedy = lambda s, cache: np.asarray(jax.jit(
        lambda v, s: greedy_decode(module, v, s, max_len=8, bos_id=BOS,
                                   use_cache=cache))(variables, s))
    beam, scores = jax.jit(lambda v, s: beam_search_decode(
        module, v, s, max_len=8, bos_id=BOS, beam_size=3, eos_id=2,
        return_scores=True, use_cache=True))(variables, src_beam)
    return (dict(state=_state(variables["params"]), src_dp=src_dp,
                 src_beam=src_beam, src_tp=src_tp),
            {"greedy": greedy(src_dp, True), "beam": np.asarray(beam),
             "beam_scores": np.asarray(scores),
             "tp_cache_True": greedy(src_tp, True),
             "tp_cache_False": greedy(src_tp, False)})


def ref_fsdp_step(n):
    layer = _encoder_layer(16, 2, 32)
    x = np.random.RandomState(6).randn(8, 4, 16).astype(np.float32)
    params = layer.init(jax.random.PRNGKey(0), x)["params"]

    def loss_of(p):
        return jnp.mean(layer.apply({"params": p}, x,
                                    deterministic=True) ** 2)

    loss, grads = jax.value_and_grad(loss_of)(params)
    return dict(state=_state(params), x=x), {"loss": float(loss),
                                             "grads": _state(grads)}


def ref_lora(n):
    from chambers_tpu.layers.attention import MultiHeadAttention

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x, deterministic=True):
            x = nn.Dense(16, name="embed")(x)
            x = MultiHeadAttention(head_dim=8, num_heads=2, dropout_rate=0.0,
                                   name="attn")([x, x])
            return nn.Dense(1, name="head")(x[:, 0])

    rng = np.random.RandomState(9)
    x = rng.randn(8, 4, 8).astype(np.float32)
    y = rng.randn(8, 1).astype(np.float32)
    params = Net().init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8)))["params"]
    return dict(state=_state(params), x=x, y=y), _state(params)


def ref_wide(n):
    layer = _encoder_layer(256, 8, 1024)
    x = np.random.RandomState(12).randn(4, 16, 256).astype(np.float32)
    params = layer.init(jax.random.PRNGKey(0), x)["params"]

    def loss_of(p):
        return jnp.mean(layer.apply({"params": p}, x,
                                    deterministic=True) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    new = jax.tree.map(lambda a, b: a - 1e-3 * b, params, grads)
    return dict(state=_state(params), x=x), {"loss": float(loss),
                                             "params": _state(new)}


class _JNet(nn.Module):
    @nn.compact
    def __call__(self, x, deterministic=True):
        return nn.Dense(1)(nn.relu(nn.Dense(16)(x)))


class _JWide(nn.Module):
    @nn.compact
    def __call__(self, x, deterministic=True):
        x = nn.relu(nn.Dense(64)(x))
        x = nn.relu(nn.Dense(64)(x))
        return nn.Dense(1)(x)


class _JAttn(nn.Module):
    @nn.compact
    def __call__(self, x, deterministic=True):
        from chambers_tpu.layers import MultiHeadAttention

        h = MultiHeadAttention(head_dim=4, num_heads=4, dropout_rate=0.0,
                               name="multi_head_attention")([x, x])
        return nn.Dense(1)(h[:, 0])


class _JLinear(nn.Module):
    sigmoid: bool = False

    @nn.compact
    def __call__(self, x, deterministic=True):
        y = nn.Dense(1)(x)
        return nn.sigmoid(y) if self.sigmoid else y


def _jmse(a, b):
    return jnp.mean((a - b) ** 2)


def ref_trainer(n):
    from chambers_tpu.metrics import AUC, F1
    from chambers_tpu.models import Model
    from chambers_tpu.training import Trainer

    def init(module, shape):
        return module.init(jax.random.PRNGKey(0), jnp.zeros(shape))

    rng = np.random.RandomState(0)
    w = rng.randn(4, 1).astype(np.float32)
    data = []
    for _ in range(6):
        x = rng.randn(16, 4).astype(np.float32)
        data.append((x, x @ w))
    net = init(_JNet(), (1, 4))
    history = Trainer(Model(_JNet(), net), loss=_jmse,
                      optimizer=jopt.AdamW(weight_decay=0.0, learning_rate=1e-2)
                      ).fit(data, epochs=15, verbose=False)

    rng = np.random.RandomState(0)
    wide_data = [(rng.randn(16, 8).astype(np.float32),
                  rng.randn(16, 1).astype(np.float32)) for _ in range(4)]
    wide = init(_JWide(), (1, 8))
    ref = Trainer(Model(_JWide(), wide), loss=_jmse,
                  optimizer=jopt.AdamW(weight_decay=0.0, learning_rate=1e-2,
                                    epsilon=1e-8), seed=3)
    wide_history = ref.fit(wide_data, epochs=3, verbose=False)

    attn = init(_JAttn(), (1, 6, 16))
    rng = np.random.RandomState(0)
    attn_data = [(rng.randn(8, 6, 16).astype(np.float32),
                  rng.randn(8, 1).astype(np.float32)) for _ in range(3)]

    metrics = {}
    for key, seed, n_batches, module, metric in (
            ("f1", 0, 4, _JLinear(), lambda: F1(thresholds=0.0)),
            ("auc", 1, 3, _JLinear(sigmoid=True),
             lambda: AUC(num_thresholds=32))):
        variables = init(module, (1, 4))
        rng = np.random.RandomState(seed)
        batches = [(rng.randn(16, 4).astype(np.float32),
                    (rng.rand(16, 1) > 0.5).astype(np.float32))
                   for _ in range(n_batches)]
        host = metric()
        for x, y in batches:
            host.update_state(y, np.asarray(module.apply(variables, x)))
        metrics[key] = (_state(variables["params"]), batches,
                        float(host.result()))
    kwargs = dict(net_state=_state(net["params"]), data=data,
                  wide_state=_state(wide["params"]), wide_data=wide_data,
                  attn_state=_state(attn["params"]), attn_data=attn_data,
                  f1_state=metrics["f1"][0], f1_data=metrics["f1"][1],
                  auc_state=metrics["auc"][0], auc_data=metrics["auc"][1])
    return kwargs, {
        "dp_history": [h["loss"] for h in history],
        "fsdp_history": [h["loss"] for h in wide_history],
        "fsdp_params": _state(ref.variables["params"]),
        "f1": metrics["f1"][2], "auc": metrics["auc"][2]}


def ref_quantized_tp(n):
    from chambers_tpu.quantization import quantize_variables

    layer = _encoder_layer(32, 4, 64)
    x = np.random.RandomState(0).randn(4, 6, 32).astype(np.float32)
    qv = quantize_variables(layer.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 6, 32))))
    qv = jax.device_get(qv)
    state = {k: v.numpy() for k, v in state_dict_from_jax(
        qv["params"], quant=qv["quant"]).items()}
    variables = {"params": jax.tree.map(np.asarray, qv["params"]),
                 "quant": jax.tree.map(np.asarray, qv["quant"])}
    return (dict(state=state, x=x, variables=variables),
            np.asarray(layer.apply(qv, x)))


def ref_collective_eval(n):
    from chambers_tpu.utils.ranking import (
        recall_at_k,
        score_matrix_to_binary_ranking,
    )

    rng = np.random.RandomState(0)
    q = rng.randn(16, 8).astype(np.float32)
    c = rng.randn(24, 8).astype(np.float32)
    rng = np.random.RandomState(0)
    z = rng.randn(32, 16).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    y = np.repeat(np.arange(8), 4).astype(np.int32)
    ranking = score_matrix_to_binary_ranking(
        jnp.asarray(z @ z.T), jnp.asarray(y), jnp.asarray(y),
        remove_top1=True)
    return (dict(q=q, c=c, z=z, y=y),
            {"scores": q @ c.T, "recall": float(recall_at_k(ranking, 3))})


def _stage_params(rng, n_stages, d):
    return [{"w": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal((d,)) * 0.1).astype(np.float32)}
            for _ in range(n_stages)]


def _sequential(stages, x):
    for p in stages:
        x = jnp.tanh(x @ p["w"] + p["b"])
    return x


def ref_pipeline(n):
    from chambers_tpu.layers.transformer import Encoder

    rng = np.random.default_rng(0)
    stages = _stage_params(rng, n, 16)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    rng = np.random.default_rng(1)
    dp_stages = _stage_params(rng, max(n // 2, 1), 8)
    dp_x = rng.standard_normal((16, 8)).astype(np.float32)
    rng = np.random.default_rng(2)
    grad_stages = _stage_params(rng, n, 8)
    grad_x = rng.standard_normal((8, 8)).astype(np.float32)
    target = rng.standard_normal((8, 8)).astype(np.float32)

    def loss(stages, x):
        return jnp.mean((_sequential(stages, x) - target) ** 2)

    value, (grads, gx) = jax.value_and_grad(loss, argnums=(0, 1))(
        grad_stages, grad_x)
    encoder = Encoder(embed_dim=16, num_heads=2, ff_dim=32, num_layers=2 * n,
                      attention_dropout_rate=0.0, dense_dropout_rate=0.0,
                      pre_norm=True, norm_output=False)
    enc_x = np.random.default_rng(3).standard_normal((4, 6, 16)).astype(
        np.float32)
    variables = encoder.init(jax.random.PRNGKey(0), enc_x)
    kwargs = dict(stages=stages, x=x, grad_stages=grad_stages, grad_x=grad_x,
                  target=target, dp_stages=dp_stages, dp_x=dp_x,
                  enc_states=[_state(variables["params"][f"layers_{i}"])
                              for i in range(2 * n)],
                  enc_x=enc_x)
    return kwargs, {
        "forward": np.asarray(_sequential(stages, x)),
        "dp_pp": np.asarray(_sequential(dp_stages, dp_x)),
        "loss": float(value), "grads": jax.device_get(grads),
        "x_grad": np.asarray(gx),
        "encoder": np.asarray(encoder.apply(variables, enc_x,
                                            deterministic=True))}


def ref_ep_cases(n):
    from chambers_tpu.layers.moe import MoEDecoderLayer, MoEMLP
    from chambers_tpu.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    def run(module, seed, *inputs):
        variables = jax.jit(module.init)(jax.random.PRNGKey(seed), *inputs)
        return _state(variables["params"]), np.asarray(
            jax.jit(module.apply)(variables, *inputs))

    kwargs, want = {}, {}
    x = np.random.default_rng(5).standard_normal((4, 16, 8)).astype(
        np.float32)
    kwargs["mlp"], want["mlp"] = run(
        MoEMLP(ff_dim=16, n_experts=8, capacity_factor=2.0), 0, x)
    kwargs["mlp_x"] = x
    x = np.random.default_rng(6).standard_normal((8, 8, 8)).astype(
        np.float32)
    kwargs["dp"], want["dp"] = run(
        MoEMLP(ff_dim=8, n_experts=4, capacity_factor=2.0), 0, x)
    kwargs["dp_x"] = x
    x = np.random.default_rng(8).standard_normal((4, 16, 16, 3)).astype(
        np.float32)
    kwargs["vit"], want["vit"] = run(VisionTransformer(
        patch_size=8, patch_dim=16, n_encoder_layers=2, n_heads=2, ff_dim=32,
        dropout_rate=0.0, include_top=False, pooling="cls", moe_every_n=2,
        moe_n_experts=8), 1, x)
    kwargs["vit_x"] = x
    x = np.random.default_rng(12).standard_normal((4, 16, 8)).astype(
        np.float32)
    kwargs["top2"], want["top2"] = run(MoEMLP(
        ff_dim=16, n_experts=8, n_selected_experts=2, capacity_factor=2.0),
        0, x)
    kwargs["top2_x"] = x
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    mem = rng.standard_normal((2, 8, 16)).astype(np.float32)
    kwargs["dec"], want["decoder"] = run(MoEDecoderLayer(
        embed_dim=16, num_heads=2, ff_dim=32, n_experts=8,
        n_selected_experts=2, capacity_factor=2.0, pre_norm=True,
        attention_dropout_rate=0.0, dense_dropout_rate=0.0), 0, [x, mem])
    kwargs["dec_x"], kwargs["dec_mem"] = x, mem
    return kwargs, want


def ref_tail_batch(n):
    """The JAX package's array-form fit on a data mesh whose last batch
    (5 of 21 samples) does not divide over the axis: its ValueError."""
    from chambers_tpu.models import Model
    from chambers_tpu.parallel import create_mesh

    rng = np.random.RandomState(4)
    x = rng.randn(21, 4).astype(np.float32)
    y = rng.randn(21, 1).astype(np.float32)
    variables = _JNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    model = Model(_JNet(), variables)
    model.compile("adam", _jmse, mesh=create_mesh({"data": 8}))
    try:
        model.fit(x, y, batch_size=8, epochs=1, shuffle=False, verbose=False)
        error = None
    except ValueError as e:
        error = str(e)
    return dict(state=_state(variables["params"]), x=x, y=y), error


def _seq2seq_module():
    from chambers_tpu.models import Seq2SeqTransformer

    return Seq2SeqTransformer(
        input_vocab_size=24, output_vocab_size=24, embed_dim=32,
        num_heads=4, dim_feedforward=64, num_encoder_layers=2,
        num_decoder_layers=2, dropout_rate=0.0)


def _seq2seq_batches(seed, count):
    """``count`` batches ``((src, tgt), y)`` of 8 rows of 8 tokens (ids
    1-23, some rows ending in padding) and float targets for the logits:
    int64 tokens for the port, int32 for JAX."""
    rng = np.random.RandomState(seed)
    port, jax_batches = [], []
    for _ in range(count):
        src, tgt = (rng.randint(1, 24, (8, 8)) for _ in range(2))
        src[::3, 6:] = 0
        tgt[1::3, 5:] = 0
        y = rng.randn(8, 8, 24).astype(np.float32)
        port.append(((src.astype(np.int64), tgt.astype(np.int64)), y))
        jax_batches.append(((src.astype(np.int32), tgt.astype(np.int32)), y))
    return port, jax_batches


def ref_clipped_mesh(n):
    """The JAX package's meshless clipped run: 3 SGDW steps (momentum 0.9)
    of the seq2seq model through its Trainer, with ``clipnorm`` at the
    median of the first step's per-parameter gradient norms and with
    ``global_clipnorm`` at half their joint norm, so both trigger."""
    from chambers_tpu.models import Model
    from chambers_tpu.training import Trainer

    module = _seq2seq_module()
    port, batches = _seq2seq_batches(21, 3)
    variables = module.init(jax.random.PRNGKey(0), batches[0][0])
    (x, y) = batches[0]
    grads = jax.grad(lambda p: _jmse(y, module.apply({"params": p}, x)))(
        variables["params"])
    norms = [float(jnp.linalg.norm(g)) for g in jax.tree.leaves(grads)]
    total = math.sqrt(sum(v * v for v in norms))
    clip = {"clipnorm": float(np.median(norms)),
            "global_clipnorm": 0.5 * total}
    want = {}
    for mode, limit in clip.items():
        opt = jopt.SGDW(weight_decay=0.0, learning_rate=0.05, momentum=0.9,
                        **{mode: limit})
        trainer = Trainer(Model(module, variables), loss=_jmse,
                          optimizer=opt)
        trainer.fit(batches, epochs=1, verbose=False)
        want[mode] = _state(trainer.variables["params"])
    return (dict(state=_state(variables["params"]), batches=port, clip=clip),
            {"params": want, "norms": norms, "total": total, "clip": clip})


def ref_checkpoint_mesh(n):
    """Port to port: the seq2seq model's weights and 4 batches."""
    module = _seq2seq_module()
    port, batches = _seq2seq_batches(22, 4)
    variables = module.init(jax.random.PRNGKey(1), batches[0][0])
    return dict(state=_state(variables["params"]), batches=port), None


def ref_export_mesh(n):
    """Port to port: the seq2seq model's weights and 2 batches."""
    module = _seq2seq_module()
    port, batches = _seq2seq_batches(23, 2)
    variables = module.init(jax.random.PRNGKey(2), batches[0][0])
    return dict(state=_state(variables["params"]), batches=port), None


def _once(ref):
    """A reference that does not depend on the world size, computed once
    for every size."""
    cached = functools.lru_cache(maxsize=None)(lambda: ref(None))
    return lambda n: cached()


def ref_dropout_and_batchnorm(n):
    """Port-to-port: the same steps without a mesh run in the world."""
    from chambers_tpu.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    vit = VisionTransformer(patch_size=8, patch_dim=32, n_encoder_layers=2,
                            n_heads=4, ff_dim=64, dropout_rate=0.1,
                            include_top=False, pooling="cls")
    params = vit.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, 3)))["params"]
    rng = np.random.RandomState(5)
    images = rng.rand(2 * n, 16, 16, 3).astype(np.float32)
    x = rng.randn(2 * n, 6, 6, 3).astype(np.float32)
    bn_state = {"Conv_0.kernel": (rng.randn(3, 3, 3, 8) * 0.3).astype(
                    np.float32),
                "BatchNorm_0.scale": (1 + 0.1 * rng.randn(8)).astype(
                    np.float32),
                "BatchNorm_0.bias": (0.1 * rng.randn(8)).astype(np.float32),
                "BatchNorm_0.mean": np.zeros(8, np.float32),
                "BatchNorm_0.var": np.ones(8, np.float32)}
    return dict(vit_state=_state(params), images=images, bn_state=bn_state,
                x=x), None


REFERENCES = {
    "dropout_and_batchnorm": ref_dropout_and_batchnorm,
    "mesh_api": ref_mesh_api, "dp_grad": _once(ref_dp_grad),
    "tp_mha": ref_tp_mha, "dp_tp_vit": _once(ref_dp_tp_vit),
    "pp_step": _once(ref_pp_step), "ep_dp_step": _once(ref_ep_dp_step),
    "cp_dryrun": _once(ref_cp_dryrun), "cp_dense": _once(ref_cp_dense),
    "decode": _once(ref_decode), "fsdp_step": _once(ref_fsdp_step),
    "lora_freeze": _once(ref_lora), "nondivisible": lambda n: ({}, None),
    "wide_dp_tp": _once(ref_wide), "trainer_dp": _once(ref_trainer),
    "quantized_tp": _once(ref_quantized_tp),
    "collective_eval": _once(ref_collective_eval),
    "pipeline_cases": ref_pipeline, "ep_cases": _once(ref_ep_cases),
    "tail_batch": _once(ref_tail_batch),
    "fsdp_rule_cases": lambda n: ({}, None),
    "dp_tp_ep_step": ref_dp_tp_ep_step,
    "clipped_mesh": _once(ref_clipped_mesh),
    "checkpoint_mesh": _once(ref_checkpoint_mesh),
    "export_mesh": _once(ref_export_mesh),
}
# a label runs the worker check of another name
CHECK_OF = {"cp_dryrun": "context_parallel", "cp_dense": "context_parallel"}


def run_checks(n, labels, timeout):
    """Every check of ``labels`` in one world of ``n`` ranks: the ranks'
    results and the JAX references, by label."""
    refs, args = {}, []
    for label in labels:
        kwargs, refs[label] = REFERENCES[label](n)
        args.append((label, CHECK_OF.get(label, label), kwargs))
    return W.run_world(n, "checks", args, timeout=timeout), refs


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    # the three-axis step needs 8 ranks (test_torch_parallel_eight.py)
    labels = [label for label in REFERENCES if label != "dp_tp_ep_step"]
    results, refs = run_checks(n, labels, timeout=600)
    return n, results, refs


def _result(world, label, rank=0):
    out = world[1][rank][label]
    if isinstance(out, dict) and "error" in out:
        pytest.fail(f"{label} on {world[0]} ranks:\n{out['error']}")
    return out


def _close_params(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# tests/test_parallel.py and test_distributed.py
# ---------------------------------------------------------------------------

def test_create_mesh_default_2d_and_wildcard(world):
    n = world[0]
    out = _result(world, "mesh_api")
    assert out["default"] == (("data",), (n,))
    assert out["wildcard"] == (("data", "model"), (n // 2, 2))
    assert all(e is not None for e in out["errors"])


def test_shard_batch_and_host_local_batch(world):
    n = world[0]
    out = _result(world, "mesh_api")
    assert out["shard_batch"] == ((2, 4), (2 * n, 4), True)
    # every rank's local rows become its shard of the global batch
    assert out["host_local"][:2] == ((2 * n, 3), (2, 3))
    assert out["host_local"][2] == [float(r) for r in range(n)
                                    for _ in range(2)]


def test_device_prefetch_places_each_ranks_rows(world):
    n = world[0]
    batch = np.arange(4 * n, dtype=np.float32).reshape(2 * n, 2)
    for rank in range(n):
        shape, rows = _result(world, "mesh_api", rank)["prefetch"]
        assert shape == (2 * n, 2)
        assert rows == batch[2 * rank:2 * rank + 2].tolist()


def test_tp_rules_shard_attention_heads(world):
    out = _result(world, "mesh_api")
    assert out["specs"] == {
        "w_query": (None, "model", None), "w_projection": ("model", None,
                                                           None),
        "dense1": (None, "model"), "dense2": ("model", None),
        "norm1": (), "b_projection": ()}
    assert out["w_query_local"] == (16, 2, 4)


def test_nondivisible_sharding_rejected_with_named_error(world):
    message = _result(world, "mesh_api")["nondivisible"]
    assert message is not None
    assert "w_query" in message and "axis 1" in message
    assert "'model'" in message
    # dryrun_multichip's: an encoder layer of 3 heads on 2-way model
    message = _result(world, "nondivisible")["error_message"]
    assert ("multi_head_attention" in message and "model" in message
            and "divide" in message)


def test_init_distributed_in_a_world(world):
    n = world[0]
    for rank in range(n):
        info = _result(world, "mesh_api", rank)["init"]
        assert info == {"process_index": rank, "process_count": n,
                        "local_device_count": 1, "global_device_count": n}


def test_init_distributed_single_process():
    from chambers_tpu_torch.parallel import init_distributed

    info = init_distributed(device="cpu")
    assert info["process_count"] == 1 and info["process_index"] == 0


def test_data_parallel_train_step_math(world):
    np.testing.assert_allclose(_result(world, "dp_grad")["grad"],
                               world[2]["dp_grad"], rtol=1e-5)


def test_tensor_parallel_forward_matches_single_device(world):
    out = _result(world, "tp_mha")
    assert out["tp"] and out["local_heads"] == 4 // min(4, world[0])
    np.testing.assert_allclose(out["out"], world[2]["tp_mha"], atol=1e-5)


def test_context_parallel_attention_matches_dense(world):
    np.testing.assert_allclose(_result(world, "cp_dense")["out"],
                               world[2]["cp_dense"]["out"], atol=2e-5,
                               rtol=2e-5)


def test_context_parallel_attention_is_differentiable(world):
    out, want = _result(world, "cp_dryrun"), world[2]["cp_dryrun"]
    np.testing.assert_allclose(out["out"], want["out"], atol=1e-5)
    np.testing.assert_allclose(out["value"], want["value"], rtol=1e-5)
    np.testing.assert_allclose(out["grad"], want["grad"], atol=1e-5)


def test_streaming_metric_inside_mesh_eval(world):
    np.testing.assert_allclose(_result(world, "trainer_dp")["f1"],
                               world[2]["trainer_dp"]["f1"], rtol=1e-6)


def test_auc_metric_inside_mesh_eval(world):
    np.testing.assert_allclose(_result(world, "trainer_dp")["auc"],
                               world[2]["trainer_dp"]["auc"], rtol=1e-5)


def test_quantized_tensor_parallel_forward_matches_single_device(world):
    out = _result(world, "quantized_tp")
    np.testing.assert_allclose(out["out"], world[2]["quantized_tp"],
                               atol=1e-5)
    # the int8 weights gather whole before the forward: the single-device
    # products exactly
    np.testing.assert_array_equal(out["out"], out["single"])
    model = min(4, world[0])
    assert out["local_kernel"] == (32, 64 // model)
    # the sharded dimension of each scale along (data, model), None where
    # replicated: the qkv scales [1, n, h] ride the heads axis, the
    # projection's [1, d, 1] replicates
    specs = out["specs"]
    assert specs["w_query_scale"] == [None, 1]
    assert specs["w_projection_scale"] == [None, None]
    assert specs["kernel_scale"] == [None, 1]


def test_distributed_pairwise_scores_matches_dense(world):
    out = _result(world, "collective_eval")
    np.testing.assert_allclose(out["scores"],
                               world[2]["collective_eval"]["scores"],
                               atol=1e-5)
    assert out["local"] == (16 // world[0], 24)


def test_distributed_recall_matches_local(world):
    np.testing.assert_allclose(_result(world, "collective_eval")["recall"],
                               world[2]["collective_eval"]["recall"],
                               atol=1e-6)


def test_trainer_data_parallel_fit(world):
    out, want = _result(world, "trainer_dp"), world[2]["trainer_dp"]
    assert out["dp_history"][-1] < out["dp_history"][0] * 0.5
    assert out["dp_kernel_local"] == (4, 16)  # replicated
    np.testing.assert_allclose(out["dp_history"][-1], want["dp_history"][-1],
                               rtol=1e-4)


def test_trainer_mesh_with_tp_rules(world):
    out = _result(world, "trainer_dp")
    assert out["tp_spec"] == (None, "model", None)
    assert out["tp_local"] == (16, 2, 4)
    assert np.isfinite(out["tp_history"]).all()
    np.testing.assert_allclose(out["tp_history"], out["tp_history_ref"],
                               rtol=1e-5)


CLIPPED = [f"{kind}-{mode}" for kind in ("tp", "fsdp")
           for mode in ("clipnorm", "global_clipnorm")]


@pytest.mark.parametrize("case", CLIPPED)
def test_trainer_mesh_clips_by_whole_parameter_norms(world, case):
    """Clipping under a mesh takes the norms of whole parameters, as optax
    does on JAX's global arrays: after 3 clipped SGD steps under the seq2seq
    TP rules or fsdp_rules the gathered parameters equal the JAX package's
    meshless run to 1e-5 (float32 sums in another order), and every rank
    holds the same bits of each replicated parameter."""
    n, mode = world[0], case.split("-", 1)[1]
    want = world[2]["clipped_mesh"]
    limit = want["clip"][mode]
    if mode == "clipnorm":  # some parameters are clipped, some not
        assert min(want["norms"]) < limit < max(want["norms"])
    else:
        assert want["total"] > limit
    out = _result(world, "clipped_mesh")[case]
    assert out["sharded"]
    _close_params(out["params"], want["params"][mode], atol=1e-5)
    for rank in range(1, n):
        other = _result(world, "clipped_mesh", rank)[case]["replicated"]
        assert set(other) == set(out["replicated"]) and other
        for name, value in other.items():
            np.testing.assert_array_equal(value, out["replicated"][name],
                                          err_msg=name)


def test_trainer_mesh_checkpoint_resumes_bit_equal(world):
    """Under the seq2seq TP rules, CheckpointCallback saves at step 2 and a
    fresh Trainer restores it: steps 3-4 give the uninterrupted run's
    losses and parameters to the bit."""
    out = _result(world, "checkpoint_mesh")
    whole, saved, resumed = out["whole"], out["saved"], out["resumed"]
    assert (saved["step"], resumed["step"], whole["step"]) == (2, 4, 4)
    assert saved["losses"] == whole["losses"][:2]
    assert resumed["losses"] == whole["losses"][2:]
    assert set(resumed["params"]) == set(whole["params"])
    for name, value in whole["params"].items():
        np.testing.assert_array_equal(resumed["params"][name], value,
                                      err_msg=name)


def test_trainer_mesh_checkpoint_holds_whole_tensors(world):
    """The TP run's checkpoint holds the tensors a meshless run's does,
    name for name and shape for shape (parameters, optimizer moments,
    generator state), and its parameters agree with the meshless ones to
    float32 rounding."""
    files = _result(world, "checkpoint_mesh")["files"]
    assert files["tp"] == files["plain"]
    assert any("opt_state/state" in k for k in files["tp"])
    _close_params(files["tp_params"], files["plain_params"], atol=1e-5)


def test_meshless_trainer_resumes_a_mesh_checkpoint(world):
    """A Trainer without a mesh restores the TP checkpoint and continues
    within 1e-6 of the TP run's steps 3-4."""
    out = _result(world, "checkpoint_mesh")
    got, want = out["meshless_resumed"], out["resumed"]
    assert got["step"] == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    _close_params(got["params"], want["params"], atol=1e-6)


@pytest.mark.parametrize("kind", ["tp", "fsdp"])
def test_trainer_mesh_exports_whole_weights(world, kind):
    """After 2 AdamW steps with EMA under the seq2seq TP rules or
    fsdp_rules, the callbacks' ``save_weights``, ``export``'s
    ``model.msgpack`` and ``Model.save_weights`` write the bytes a meshless
    Trainer holding the same gathered train state writes; ``export``'s
    ``opt_state.pt`` holds its whole moments, value for value, and
    ``ema_variables`` its whole EMA shadow, as JAX's global arrays are."""
    out = _result(world, "export_mesh")[kind]
    assert out["files"] == {"save_weights": True, "export": True,
                            "model_save_weights": True}
    assert out["opt_keys"] and out["opt_equal"]
    assert out["opt_moment_shapes"] == out["whole_shapes"]
    assert set(out["ema"]) == set(out["ema_want"])
    for name, value in out["ema_want"].items():
        np.testing.assert_array_equal(out["ema"][name], value, err_msg=name)


@pytest.mark.parametrize("kind", ["tp", "fsdp"])
def test_placed_model_loads_whole_weights(world, kind):
    """``Model.load_weights`` of that file into a freshly placed module cuts
    each whole value to the rank's shard: the gathered parameters equal
    the meshless twin's to the bit, and the next forward (data-parallel
    over the mesh) equals the twin's to 1e-5 (TP sums its products in
    another order)."""
    out = _result(world, "export_mesh")[kind]
    assert out["sharded"]
    assert set(out["loaded"]) == set(out["twin"])
    for name, value in out["twin"].items():
        np.testing.assert_array_equal(out["loaded"][name], value,
                                      err_msg=name)
    np.testing.assert_allclose(out["forward"], out["forward_want"],
                               atol=1e-5)


# ---------------------------------------------------------------------------
# dryrun_multichip's equalities
# ---------------------------------------------------------------------------

def test_dryrun_dp_tp_step_matches_single_device(world):
    out, want = _result(world, "dp_tp_vit"), world[2]["dp_tp_vit"]
    assert all(out["tp"])
    np.testing.assert_allclose(out["losses"][0], want["losses"][0], rtol=1e-5)
    # the gradients, not the parameters after Adam: its first direction
    # g / (|g| + eps) turns float noise in the key biases' (mathematically
    # zero) gradients into whole steps
    _close_params(out["grads"], want["grads"], atol=1e-6)
    # the second step runs the updated state
    np.testing.assert_allclose(out["losses"][1], want["losses"][1], rtol=1e-5)


def test_dryrun_pp_dp_gradient_matches_sequential(world):
    want = world[2]["pp_step"]
    stages = {}
    for rank in range(world[0]):
        out = _result(world, "pp_step", rank)
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-5)
        stages[out["stage"]] = out["grads"]
    assert sorted(stages) == [0, 1]
    for stage, grads in stages.items():
        for i in range(2):
            layer = want["grads"][2 * stage + i]
            for k in layer:
                np.testing.assert_allclose(grads[k][i], layer[k], atol=1e-6,
                                           rtol=1e-5, err_msg=k)


def test_dryrun_ep_dp_step_matches_single_device(world):
    out, want = _result(world, "ep_dp_step"), world[2]["ep_dp_step"]
    assert out["ep"] == "expert" and out["expert_local"][0] == 2
    np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-5)
    _close_params(out["params"], want["params"], atol=1e-6)


def test_dryrun_fsdp_step_with_moments_one_nth(world):
    n = world[0]
    out, want = _result(world, "fsdp_step"), world[2]["fsdp_step"]
    np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-5)
    # whichever axis fsdp_rules picked, the stored moment is 1/N
    assert (int(np.prod(out["mu_local"])) * n
            == int(np.prod(out["kernel_global"])))
    # the reduce-scattered gradients (Adam's first step would amplify
    # float noise in the key biases' zero gradients)
    _close_params(out["grads"], want["grads"], atol=1e-6)


def test_dryrun_lora_freeze_on_a_mesh(world):
    out = _result(world, "lora_freeze")
    ref, mesh = out["ref"], out["mesh"]
    base = world[2]["lora_freeze"]
    np.testing.assert_allclose(mesh["loss"], ref["loss"], rtol=1e-6)
    adapters = [k for k in ref["params"] if k.endswith(("_lora_a",
                                                        "_lora_b"))]
    assert adapters and set(ref["params"]) == set(base) | set(adapters)
    for k in adapters:
        np.testing.assert_allclose(mesh["params"][k], ref["params"][k],
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for k in base:
        # the frozen base stays bit for bit what it was loaded as
        np.testing.assert_array_equal(mesh["params"][k], base[k], err_msg=k)
        np.testing.assert_array_equal(ref["params"][k], base[k], err_msg=k)


def test_dryrun_wide_dp_tp_matches_single_device(world):
    out, want = _result(world, "wide_dp_tp"), world[2]["wide_dp_tp"]
    np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-5)
    _close_params(out["params"], want["params"], atol=1e-6)


# ---------------------------------------------------------------------------
# test_parallel_composition.py
# ---------------------------------------------------------------------------

def test_greedy_decode_dp_sharded_matches_single_device(world):
    np.testing.assert_array_equal(_result(world, "decode")["greedy"],
                                  world[2]["decode"]["greedy"])


def test_beam_decode_dp_sharded_matches_single_device(world):
    out, want = _result(world, "decode"), world[2]["decode"]
    np.testing.assert_array_equal(out["beam"], want["beam"])
    np.testing.assert_allclose(out["beam_scores"], want["beam_scores"],
                               atol=1e-5)


@pytest.mark.parametrize("use_cache", [True, False])
def test_greedy_decode_tp_sharded_matches_single_device(world, use_cache):
    out, want = _result(world, "decode"), world[2]["decode"]
    assert out["specs"] == {
        "decoder.layers.0.multi_head_attention1.w_query":
            (None, "model", None),
        "decoder.layers.0.multi_head_attention2.w_projection":
            ("model", None, None)}
    assert out["local_heads"] == 2   # 4 heads over model = 2
    np.testing.assert_array_equal(out[f"tp_cache_{use_cache}"],
                                  want[f"tp_cache_{use_cache}"])


# ---------------------------------------------------------------------------
# test_fsdp.py
# ---------------------------------------------------------------------------

def test_fsdp_rules_pick_the_largest_divisible_axis(world):
    out = _result(world, "fsdp_rule_cases")
    assert out["largest"] == {"w": (None, "data"), "tall": ("data", None)}
    assert out["small"] == {"bias": (), "odd": ()}
    assert out["claimed"] == {"w": ("data", None)}
    assert "no axis" in out["unknown"]


def test_fsdp_rules_compose_with_tp_and_joint_axes(world):
    n = world[0]
    out = _result(world, "fsdp_rule_cases")
    assert out["tp"] == {
        "block/dense1/kernel": ("data", "model"),
        "block/dense1/bias": ("model",),
        "block/dense2/kernel": ("model", "data"),
        "block/multi_head_attention/w_query": ("data", "model", None)}
    assert out["joint"] == {"w": (("replica", "fsdp"), None)}
    assert out["joint_local"] == (64 // n, 16)


def test_fsdp_training_matches_single_device(world):
    out, want = _result(world, "trainer_dp"), world[2]["trainer_dp"]
    np.testing.assert_allclose(out["fsdp_history"], want["fsdp_history"],
                               rtol=1e-5, atol=1e-6)
    want_params = {k: v for k, v in want["fsdp_params"].items()}
    _close_params(out["fsdp_params"], want_params, rtol=1e-4, atol=1e-5)


def test_optimizer_state_is_sharded(world):
    n = world[0]
    out = _result(world, "trainer_dp")
    # Dense_0 kernel (8, 64): sharded over its 64 axis, moments too
    assert out["fsdp_kernel_local"] == (8, 64 // n)
    assert out["fsdp_mu_local"] == (8, 64 // n)


# ---------------------------------------------------------------------------
# test_pipeline_parallel.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("micro", ["n", "1", "2n"])
def test_forward_matches_sequential(world, micro):
    n = world[0]
    m = {"n": n, "1": 1, "2n": 2 * n}[micro]
    np.testing.assert_allclose(
        _result(world, "pipeline_cases")[f"forward_{m}"],
        world[2]["pipeline_cases"]["forward"], rtol=1e-6, atol=1e-6)


def test_stage_params_sharded_over_pipe(world):
    out = _result(world, "pipeline_cases")
    assert out["sharded_local"] == (1, 16, 16)
    np.testing.assert_allclose(out["sharded_forward"],
                               world[2]["pipeline_cases"]["forward"],
                               rtol=1e-6, atol=1e-6)


def test_dp_times_pp_mesh(world):
    np.testing.assert_allclose(_result(world, "pipeline_cases")["dp_pp"],
                               world[2]["pipeline_cases"]["dp_pp"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_sequential(world, remat):
    want = world[2]["pipeline_cases"]
    for rank in range(world[0]):
        out = _result(world, "pipeline_cases", rank)[f"grads_{remat}"]
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(out["x"], want["x_grad"], rtol=1e-5,
                                   atol=1e-6)
        stage = want["grads"][out["stage"]]
        for k in ("w", "b"):
            np.testing.assert_allclose(out[k], stage[k], rtol=1e-5,
                                       atol=1e-6)


def test_encoder_layers_pipelined(world):
    np.testing.assert_allclose(_result(world, "pipeline_cases")["encoder"],
                               world[2]["pipeline_cases"]["encoder"],
                               rtol=1e-5, atol=1e-5)


def test_uneven_microbatches_and_stage_count_raise(world):
    out = _result(world, "pipeline_cases")
    assert "not divisible" in out["uneven"]
    assert "leading axis" in out["stages"]


# ---------------------------------------------------------------------------
# tests/layers/test_moe.py's expert-parallel cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mlp", "dp", "vit", "top2", "decoder"])
def test_expert_parallel_matches_replicated(world, case):
    out, want = _result(world, "ep_cases"), world[2]["ep_cases"]
    tol = dict(rtol=1e-5, atol=1e-5 if case == "vit" else 1e-6)
    np.testing.assert_allclose(out[case], want[case], **tol)


def test_expert_parallel_moves_tokens_not_expert_banks(world):
    n = world[0]
    out = _result(world, "ep_cases")
    assert out["specs"] == (("expert", None, None), ())
    assert out["bank_local"] == (8 // n, 8, 16)
    moved = out["collectives"]
    a2a = [shape for name, shape in moved if name == "all_to_all_single"]
    # one dispatch and one return, each [owners, E/owners, slots, d]
    assert len(a2a) == 2 and all(s[:2] == (n, 8 // n) and s[-1] == 8
                                 for s in a2a)
    banks = {(8 // n, 8, 16), (8 // n, 16, 8), (8, 8, 16), (8, 16, 8)}
    assert not [s for _, s in moved if s in banks]


# ---------------------------------------------------------------------------
# the tail batch (the JAX fault of models/model.py's array-form fit)
# ---------------------------------------------------------------------------

def test_tail_batch_counts_as_without_a_mesh(world):
    # JAX: a DP mesh rejects the 5-sample tail batch
    assert "divisible" in world[2]["tail_batch"]
    out = _result(world, "tail_batch")
    ref, mesh = out["ref"], out["mesh"]
    np.testing.assert_allclose(mesh["history"], ref["history"], rtol=1e-6)
    np.testing.assert_allclose(mesh["evaluate"], ref["evaluate"], rtol=1e-6)
    np.testing.assert_allclose(mesh["predict"], ref["predict"], atol=1e-6)
    _close_params(mesh["params"], ref["params"], atol=1e-6)


# ---------------------------------------------------------------------------
# random draws and batch statistics over the global batch
# ---------------------------------------------------------------------------

def test_dropout_under_a_mesh_draws_the_meshless_masks(world):
    # the masks of the whole batch, each rank its rows and (tensor-parallel)
    # heads: the same step as without a mesh, to float reordering
    out = _result(world, "dropout_and_batchnorm")
    ref, mesh = out["dropout_ref"], out["dropout_mesh"]
    np.testing.assert_allclose(mesh["z"], ref["z"], atol=1e-5)
    _close_params(mesh["grads"], ref["grads"], atol=1e-6)


def test_batchnorm_statistics_are_the_global_batch(world):
    out = _result(world, "dropout_and_batchnorm")
    ref, mesh = out["batchnorm_ref"], out["batchnorm_mesh"]
    np.testing.assert_allclose(mesh["y"], ref["y"], atol=1e-5)
    _close_params(mesh["grads"], ref["grads"], atol=1e-5)
    _close_params(mesh["running"], ref["running"], atol=1e-6)
