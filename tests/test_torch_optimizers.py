"""The port's optimizers (``chambers_tpu_torch.optimizers``) and schedules
(``chambers_tpu_torch.schedules``) against the JAX package's, in float32 on
the CPU.

Five steps of each optimizer on a small parameter tree whose paths carry
the JAX package's names, with the same seeded gradients given to both:
parameters within 1e-6 absolute and relative after every step (float32
arithmetic in another order; the bias corrections and a scheduled rate are
computed in float64 here and in float32 there). Decay masks equal.
Schedules within 1e-6 relative or 1e-8 absolute, a tenth of a float32
step of their 0.1 peak (the port computes in float64, JAX in float32,
where ``1 + cos`` near its zero keeps few digits)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chambers_tpu import optimizers as jopt
from chambers_tpu import schedules as jsched
from chambers_tpu.models.backbones.vision_transformer import (
    VisionTransformer as JaxViT,
)
from chambers_tpu_torch import optimizers as topt
from chambers_tpu_torch import schedules as tsched
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from chambers_tpu_torch.models.backbones.vision_transformer import (
    VisionTransformer,
)
from test_torch_package import one_torch_thread  # noqa: F401

STEPS = 5


def _tree(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)

    def a(*shape):
        return (scale * rng.randn(*shape)).astype(np.float32)

    layer = {"dense1": {"kernel": a(4, 6), "bias": a(6)},
             "norm1": {"scale": a(4), "bias": a(4)},
             "multi_head_attention": {"w_query": a(4, 2, 3),
                                      "b_query": a(2, 1, 3)}}
    return {"encoder": {"layers_0": layer,
                        "layers_1": jax.tree.map(lambda x: 2 * x, layer)},
            "head": {"kernel": a(4, 5)}}


def _torch_params(tree):
    return {k: v.clone().requires_grad_(True)
            for k, v in state_dict_from_jax(tree).items()}


def _run_both(jax_opt, make_port, grad_scale=1.0):
    """``STEPS`` updates of both optimizers; yields (port, JAX) parameters
    after each, as ``{port name: array}``."""
    params = _tree()
    port_params = _torch_params(params)
    port = make_port(port_params)
    state = jax_opt.init(params)
    for step in range(STEPS):
        grads = _tree(seed=100 + step, scale=grad_scale)
        updates, state = jax_opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for name, g in state_dict_from_jax(grads).items():
            port_params[name].grad = g
        port.step()
        want = state_dict_from_jax(jax.device_get(params))
        yield ({k: v.detach().numpy() for k, v in port_params.items()},
               {k: v.numpy() for k, v in want.items()})


ADAMW_CASES = {
    "defaults": dict(weight_decay=1e-2),
    "bench_config_4": dict(weight_decay=1e-4, learning_rate=1e-3,
                           decay_exclude=["bias", "norm"]),
    "decay_include": dict(weight_decay=0.1, decay_include=[r"kernel$"]),
    "layer_path": dict(weight_decay=0.1, decay_include=["layers_1/"]),
    "amsgrad": dict(weight_decay=1e-2, amsgrad=True, learning_rate=0.05),
    "clipnorm": dict(weight_decay=1e-2, clipnorm=0.5),
    "clipvalue": dict(weight_decay=1e-2, clipvalue=0.3),
    "clipnorm_clipvalue": dict(weight_decay=1e-2, clipnorm=1.0,
                               clipvalue=0.2),
    "global_clipnorm": dict(weight_decay=1e-2, global_clipnorm=2.0),
    "global_clipnorm_idle": dict(weight_decay=1e-2, global_clipnorm=1e4),
    "betas_epsilon": dict(weight_decay=1e-2, beta_1=0.5, beta_2=0.9,
                          epsilon=1e-3),
    "lr_schedule": dict(weight_decay=1e-2, learning_rate="cosine"),
    "wd_schedule": dict(weight_decay="exponential", learning_rate=0.01),
    "time_decay": dict(weight_decay=1e-2, learning_rate=0.01, decay=0.5),
    "lr_alias": dict(weight_decay=1e-2, lr=0.02),
    "no_decay": dict(weight_decay=0.0, learning_rate=0.01),
}

SGDW_CASES = {
    "plain": dict(weight_decay=1e-2, learning_rate=0.05),
    "momentum": dict(weight_decay=1e-2, learning_rate=0.05, momentum=0.9),
    "nesterov": dict(weight_decay=1e-2, learning_rate=0.05, momentum=0.9,
                     nesterov=True),
    "decay_exclude": dict(weight_decay=0.1, learning_rate=0.05,
                          momentum=0.5, decay_exclude=["bias", "norm"]),
    "clipnorm": dict(weight_decay=1e-2, clipnorm=0.5, momentum=0.9),
    "clipvalue": dict(weight_decay=1e-2, clipvalue=0.3),
    "global_clipnorm": dict(weight_decay=1e-2, global_clipnorm=2.0,
                            momentum=0.9),
    "lr_schedule": dict(weight_decay=1e-2, learning_rate="warmup",
                        momentum=0.9),
    "time_decay": dict(weight_decay=1e-2, learning_rate=0.1, decay=0.5),
    "lr_alias": dict(weight_decay=1e-2, lr=0.02),
}


def _schedules(kwargs, pkg):
    """Replace the names of schedules by the package's own instances."""
    made = {"cosine": lambda: pkg.CosineDecay(0.05, 4, alpha=0.1),
            "exponential": lambda: pkg.ExponentialDecay(0.1, 2, 0.5),
            "warmup": lambda: pkg.LinearWarmup(
                pkg.PolynomialDecay(0.1, 6, power=2.0), 2)}
    return {k: made[v]() if isinstance(v, str) else v
            for k, v in kwargs.items()}


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_five_steps_match_jax(case):
    kwargs = ADAMW_CASES[case]
    jax_opt = jopt.AdamW(**_schedules(kwargs, jsched))
    for got, want in _run_both(jax_opt, lambda p: topt.AdamW(
            p, **_schedules(kwargs, tsched))):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=1e-6,
                                       rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", sorted(SGDW_CASES))
def test_sgdw_five_steps_match_jax(case):
    kwargs = SGDW_CASES[case]
    jax_opt = jopt.SGDW(**_schedules(kwargs, jsched))
    for got, want in _run_both(jax_opt, lambda p: topt.SGDW(
            p, **_schedules(kwargs, tsched))):
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=1e-6,
                                       rtol=1e-6, err_msg=name)


def test_adamw_decay_is_not_scaled_by_the_learning_rate():
    """With zero gradients Adam's direction is 0, and the step is the decay
    alone: ``p - wd · p``, where ``torch.optim.AdamW`` takes ``p - lr · wd
    · p``."""
    p = torch.tensor([1.0, -2.0, 0.5], requires_grad=True)
    q = p.detach().clone().requires_grad_(True)
    opt = topt.AdamW([("kernel", p)], weight_decay=0.1, learning_rate=1e-3)
    ref = torch.optim.AdamW([q], lr=1e-3, weight_decay=0.1)
    p.grad, q.grad = torch.zeros(3), torch.zeros(3)
    opt.step()
    ref.step()
    want = np.float32(1.0) - np.float32(0.1)
    np.testing.assert_allclose(p.detach().numpy(),
                               [want, -2 * want, 0.5 * want], rtol=1e-7)
    np.testing.assert_allclose(q.detach().numpy(),
                               np.array([1.0, -2.0, 0.5]) * (1 - 1e-4),
                               rtol=1e-7)


def _vit_params():
    """The JAX ViT-S/16 embedder's parameter tree, shapes only."""
    vit = JaxViT(patch_size=16, patch_dim=384, n_encoder_layers=12,
                 n_heads=6, ff_dim=1536, dropout_rate=0.0, include_top=False,
                 pooling="cls", feature_dim=128)
    return jax.eval_shape(lambda: vit.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))["params"]


@pytest.mark.parametrize("patterns", [
    dict(decay_exclude=["bias", "norm"]),
    dict(decay_include=[r"kernel$", "w_"]),
    dict(decay_include=["layers_1/", "^feature"]),
    dict(decay_exclude=["^encoder/layers_1[01]/"]),
    dict()])
def test_decay_mask_on_the_vit_paths(patterns):
    params = _vit_params()
    paths = jopt._param_paths(params)
    want = dict(zip(paths, jax.tree_util.tree_leaves(
        jopt.decay_mask(params, **patterns))))
    model = VisionTransformer(16, 384, 12, 6, 1536, dropout_rate=0.0,
                              include_top=False, feature_dim=128,
                              device="meta")
    got = {topt.jax_path(name): decays
           for name, decays in topt.decay_mask(model, **patterns).items()}
    assert got == want
    assert 0 < sum(want.values()) or not patterns


def test_chip_smoke_lists_the_jax_decay_set():
    """The metric-learning phase of ``chip_smoke.py`` holds the port's
    decayed parameters to a list it carries as data: that list is the JAX
    package's."""
    import chip_smoke

    params = _vit_params()
    mask = jopt.decay_mask(params, decay_exclude=["bias", "norm"])
    want = {path for path, decays in zip(
        jopt._param_paths(params), jax.tree_util.tree_leaves(mask))
        if decays}
    assert set(chip_smoke.vits16_decayed_paths()) == want


def test_config_round_trip_and_refusals():
    params = _torch_params(_tree())
    opt = topt.AdamW(params, weight_decay=1e-4, decay_exclude=["bias"],
                     clipnorm=1.0)
    config = opt.get_config()
    assert config == jopt.AdamW(weight_decay=1e-4, decay_exclude=["bias"],
                                clipnorm=1.0).get_config()
    again = topt.AdamW.from_config(config, params)
    assert again.get_config() == config
    assert [len(g["params"]) for g in again.param_groups] == [9, 4]
    sgdw = topt.SGDW(params, weight_decay=1e-4, momentum=0.9)
    assert (sgdw.get_config()
            == jopt.SGDW(weight_decay=1e-4, momentum=0.9).get_config())
    # mutable_lr came with the callbacks: the config round-trips as JAX's
    # and the scale starts at 1 in every parameter group
    for cls, jcls in ((topt.AdamW, jopt.AdamW), (topt.SGDW, jopt.SGDW)):
        mut = cls(params, weight_decay=1e-4, mutable_lr=True)
        assert mut.get_config() == jcls(weight_decay=1e-4,
                                        mutable_lr=True).get_config()
        assert all(g["lr_scale"] == 1.0 for g in mut.param_groups)
    with pytest.raises(ValueError, match="decay_include"):
        topt.AdamW(params, weight_decay=1e-4, decay_include=["a"],
                   decay_exclude=["b"])
    with pytest.raises(ValueError, match="global_clipnorm"):
        topt.AdamW(params, weight_decay=1e-4, clipnorm=1.0,
                   global_clipnorm=1.0)
    with pytest.raises(ValueError, match="legacy"):
        topt.AdamW(params, weight_decay=1e-4, learning_rate=0.1, lr=0.2)
    with pytest.raises(ValueError, match="named_parameters"):
        topt.AdamW(list(params.values()), weight_decay=1e-4,
                   decay_exclude=["bias"])


def test_clip_functions_match_optax():
    grads = [torch.from_numpy(x) for x in jax.tree_util.tree_leaves(
        _tree(seed=3))]
    jgrads = [jnp.asarray(g.numpy()) for g in grads]
    for max_norm in (0.5, 1e4):
        want, _ = jopt.clip_by_norm(max_norm).update(jgrads, None)
        for got, w in zip(topt.clip_by_norm(grads, max_norm), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6)
        want, _ = optax.clip_by_global_norm(max_norm).update(jgrads, None)
        for got, w in zip(topt.clip_by_global_norm(grads, max_norm), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6)


def _schedule_pairs():
    return [
        ("cosine", lambda m: m.CosineDecay(0.1, 50)),
        ("cosine_alpha", lambda m: m.CosineDecay(0.1, 50, alpha=0.2)),
        ("exponential", lambda m: m.ExponentialDecay(0.1, 7, 0.6)),
        ("exponential_staircase",
         lambda m: m.ExponentialDecay(0.1, 7, 0.6, staircase=True)),
        ("piecewise", lambda m: m.PiecewiseConstantDecay([10, 30],
                                                          [0.1, 0.01, 1e-3])),
        ("polynomial", lambda m: m.PolynomialDecay(0.1, 40)),
        ("polynomial_power", lambda m: m.PolynomialDecay(
            0.1, 40, end_learning_rate=0.01, power=0.5)),
        ("polynomial_cycle", lambda m: m.PolynomialDecay(0.1, 15,
                                                         cycle=True)),
        ("warmup_scalar", lambda m: m.LinearWarmup(0.1, 10)),
        ("warmup_no_ramp", lambda m: m.LinearWarmup(
            m.CosineDecay(0.1, 50), 10, ramp=False)),
        ("warmup_cosine", lambda m: m.LinearWarmup(m.CosineDecay(0.1, 50),
                                                   10)),
        ("warmup_callable", lambda m: m.LinearWarmup(lambda: 0.05, 5)),
    ]


@pytest.mark.parametrize("name,make", _schedule_pairs(),
                         ids=[n for n, _ in _schedule_pairs()])
def test_schedules_match_jax(name, make):
    want_schedule, got_schedule = make(jsched), make(tsched)
    for step in range(0, 80):
        want = float(want_schedule(step))
        got = got_schedule(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8,
                                   err_msg=f"{name} step {step}")

    def plain(config):  # a wrapped schedule is each package's own object
        return {k: v for k, v in config.items() if not callable(v)}

    assert (plain(got_schedule.get_config())
            == plain(want_schedule.get_config()))


def test_piecewise_refuses_mismatched_lengths():
    with pytest.raises(ValueError, match="len"):
        tsched.PiecewiseConstantDecay([1, 2], [0.1])
