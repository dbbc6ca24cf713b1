"""LoRA of the port (``chambers_tpu_torch.training.lora``) against the JAX
package's (``chambers_tpu.training.lora``): factor shapes (the attention's
``(d, n, h)`` projections and the ``(n, d, h)`` ``w_projection`` among
them), the exact identity at init, the adapted forward and ``merge_lora``
on the same adapters, adapter-only training, and the adapter subtree's
round trip."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from flax.traverse_util import flatten_dict

from chambers_tpu.layers.attention import MultiHeadAttention as JMHA
from chambers_tpu.models import Model as JModel
from chambers_tpu.training import Trainer as JTrainer
from chambers_tpu.training import lora as jlora
from chambers_tpu_torch.layers.attention import MultiHeadAttention as TMHA
from chambers_tpu_torch.models import Model
from chambers_tpu_torch.models.backbones.convert import (
    jax_path,
    state_dict_from_jax,
)
from chambers_tpu_torch.optimizers import SGDW
from chambers_tpu_torch.quantization import QuantDense
from chambers_tpu_torch.training import Trainer
from chambers_tpu_torch.training import lora
from test_torch_package import one_torch_thread  # noqa: F401


class _JNet(nn.Module):
    @nn.compact
    def __call__(self, x, deterministic=True):
        x = nn.Dense(16, name="embed")(x)
        x = JMHA(head_dim=8, num_heads=2, dropout_rate=0.0, name="attn")(
            [x, x])
        return nn.Dense(1, name="head")(x[:, 0])


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.embed = QuantDense(4, 16, device="cpu")
        self.attn = TMHA(16, head_dim=8, num_heads=2, dropout_rate=0.0,
                         device="cpu")
        self.head = QuantDense(16, 1, device="cpu")

    def forward(self, x, deterministic=None):
        x = self.embed(x)
        x = self.attn([x, x], deterministic=True)
        return self.head(x[:, 0])


def _pair(seed=0):
    module = _JNet()
    variables = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 5, 4)))
    net = _TNet()
    net.load_state_dict(state_dict_from_jax(jax.device_get(
        variables["params"])))
    return module, variables, net.eval()


def _x(batch=8, seed=0):
    return np.random.RandomState(seed).randn(batch, 5, 4).astype(np.float32)


def _jax_adapters(variables, rank=4, seed=1, b_scale=0.1):
    """JAX's adapters with a nonzero ``b`` (drawn here), so the deltas are
    not zero."""
    params = jlora.add_lora(variables["params"], rank=rank,
                            rng=jax.random.PRNGKey(seed))
    flat = dict(flatten_dict(params))
    rng = np.random.RandomState(seed)
    for key, leaf in flat.items():
        if str(key[-1]).endswith("_lora_b"):
            flat[key] = jnp.asarray(b_scale * rng.randn(*leaf.shape),
                                    leaf.dtype)
    from flax.traverse_util import unflatten_dict

    return unflatten_dict(flat)


def test_factor_shapes_equal_jax():
    _, variables, net = _pair()
    params = jlora.add_lora(variables["params"], rank=4,
                            rng=jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(
        jax.device_get(params)).items() if "_lora_" in k}
    lora.add_lora(net, rank=4, generator=torch.Generator().manual_seed(0))
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()
           if "_lora_" in k}
    assert got == want
    # w_projection (n, d, h) = (2, 16, 8): A [n*h, r], B [r, d]
    assert got["attn.w_projection_lora_a"] == (16, 4)
    assert got["attn.w_projection_lora_b"] == (4, 16)
    assert got["attn.w_query_lora_b"] == (4, 2, 8)


def test_identity_at_init_is_exact():
    _, _, net = _pair()
    x = torch.from_numpy(_x())
    with torch.no_grad():
        base = net(x)
        lora.apply_to_model(net, rank=4,
                            generator=torch.Generator().manual_seed(0))
        adapted = net(x)
    assert torch.equal(base, adapted)
    assert all(float(p.abs().sum()) == 0 for n, p in net.named_parameters()
               if n.endswith("_lora_b"))


@pytest.mark.parametrize("scale", [1.0, 0.5, 2.0])
def test_adapted_forward_and_merge_equal_jax(scale):
    module, variables, net = _pair()
    params = _jax_adapters(variables)
    lora.add_lora(net, rank=4)
    net.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    lora.wrap_apply(net, scale=scale)
    x = _x()
    want = np.asarray(jlora.wrap_apply(module, scale=scale)(
        {"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    merged_j = state_dict_from_jax(jax.device_get(
        jlora.merge_lora(params, scale=scale)))
    merged_t = lora.merge_lora(net.state_dict(), scale=scale)
    assert set(merged_t) == set(merged_j)
    for k, v in merged_j.items():
        np.testing.assert_allclose(merged_t[k].numpy(), v.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    base = _TNet().eval()
    base.load_state_dict(merged_t)
    with torch.no_grad():
        np.testing.assert_allclose(base(torch.from_numpy(x)).numpy(), got,
                                   rtol=1e-5, atol=1e-6)


def test_wrap_apply_rewrap_and_unwrap():
    _, variables, net = _pair()
    params = _jax_adapters(variables)
    lora.add_lora(net, rank=4)
    net.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    x = torch.from_numpy(_x())
    with torch.no_grad():
        base = net(x)
        lora.wrap_apply(net, scale=1.0)
        one = net(x)
        lora.wrap_apply(net, scale=1.0)     # replaces, never stacks
        again = net(x)
        lora.unwrap(net)
        back = net(x)
    assert torch.equal(one, again) and torch.equal(back, base)
    assert not torch.equal(one, base)
    # the shadowed weights are gone after the forward
    assert "w_query" not in vars(net.attn)


def test_training_moves_only_adapters_and_matches_jax():
    module, variables, net = _pair()
    params = _jax_adapters(variables, b_scale=0.0)
    jmodel = JModel(module, {"params": params}).with_apply_fn(
        jlora.wrap_apply(module))
    lora.add_lora(net, rank=4)
    net.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    lora.wrap_apply(net)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    rng = np.random.RandomState(3)
    data = [(_x(8, i), rng.randn(8, 1).astype(np.float32)) for i in range(4)]
    jt = JTrainer(jmodel, loss=lambda a, b: jnp.mean((a - b) ** 2),
                  optimizer=optax.sgd(0.1), trainable=jlora.TRAINABLE)
    tt = Trainer(Model(net), loss=lambda a, b: torch.mean((a - b) ** 2),
                 optimizer=functools.partial(SGDW, weight_decay=0.0,
                                             learning_rate=0.1),
                 trainable=lora.TRAINABLE)
    jh = jt.fit(data, epochs=2, verbose=False)
    th = tt.fit(data, epochs=2, verbose=False)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-5)
    after = net.state_dict()
    want = state_dict_from_jax(jax.device_get(jt.state.params))
    for k, v in after.items():
        if "_lora_" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            assert torch.equal(v, before[k]), k
    assert any(not torch.equal(after[k], before[k]) for k in after
               if k.endswith("_lora_b"))
    # the optimizer holds the adapters' state only
    named = dict(net.named_parameters())
    held = {id(p) for g in tt.optimizer.param_groups for p in g["params"]}
    assert {n for n, p in named.items() if id(p) in held} == {
        n for n in named if "_lora_" in n}
    # merged, the base module serves the adapted function
    x = torch.from_numpy(_x(4, 9))
    with torch.no_grad():
        adapted = net(x)
        base = _TNet().eval()
        base.load_state_dict(lora.merge_lora(net.state_dict()))
        np.testing.assert_allclose(base(x).numpy(), adapted.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_extract_insert_roundtrip_equals_jax():
    _, variables, net = _pair()
    params = _jax_adapters(variables)
    lora.add_lora(net, rank=4)
    net.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    adapters = lora.extract_lora(net.state_dict())
    want = state_dict_from_jax(jax.device_get(jlora.extract_lora(params)))
    assert set(adapters) == set(want)
    _, _, fresh = _pair()
    combined = lora.insert_lora(fresh.state_dict(), adapters)
    for k, v in net.state_dict().items():
        assert torch.equal(combined[k], v), k


def test_targets_skip_conv_kernels_and_adapters():
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    vit = VisionTransformer(16, 32, 1, 2, 64, image_size=(32, 32),
                            classes=3, device="cpu")
    lora.add_lora(vit, rank=2)
    names = [n for n, _ in vit.named_parameters() if "_lora_" in n]
    assert not any("patch_embeddings" in n for n in names)
    assert "predictions.kernel_lora_a" in names
    # a second add_lora never adapts an adapter
    before = len(names)
    lora.add_lora(vit, rank=2)
    assert len([n for n, _ in vit.named_parameters()
                if "_lora_" in n]) == before
    assert all(jax_path(n).endswith(("_lora_a", "_lora_b")) for n in names)


@pytest.mark.parametrize("case", ["rank", "no_match", "orphan", "no_base",
                                  "bad_shape", "not_adapter", "no_adapters"])
def test_errors(case):
    _, _, net = _pair()
    if case == "rank":
        with pytest.raises(ValueError, match="rank"):
            lora.add_lora(net, rank=0)
    elif case == "no_match":
        with pytest.raises(ValueError, match="matched no"):
            lora.add_lora(net, rank=2, targets=(r"/nothing$",))
    elif case == "no_adapters":
        with pytest.raises(ValueError, match="no LoRA adapters"):
            lora.extract_lora(net.state_dict())
        with pytest.raises(ValueError, match="add_lora first"):
            lora.wrap_apply(net)
    else:
        lora.add_lora(net, rank=2)
        state = net.state_dict()
        if case == "orphan":
            del state["head.kernel_lora_b"]
            with pytest.raises(ValueError, match="orphan"):
                lora.merge_lora(state)
        elif case == "no_base":
            del state["head.kernel"]
            with pytest.raises(ValueError, match="no base weight"):
                lora.merge_lora(state)
        elif case == "bad_shape":
            adapters = lora.extract_lora(state)
            adapters["head.kernel_lora_a"] = torch.zeros(3, 2)
            with pytest.raises(ValueError, match="does not factor"):
                lora.insert_lora(_TNet().state_dict(), adapters)
        else:
            with pytest.raises(ValueError, match="not an adapter"):
                lora.insert_lora(_TNet().state_dict(),
                                 {"head.kernel_lora_a": torch.zeros(16, 2),
                                  "head.kernel_lora_b": torch.zeros(2, 1),
                                  "head.kernel": torch.zeros(16, 1)})
