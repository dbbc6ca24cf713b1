"""The port's DETR, its matchers and its set-prediction loss against the
JAX package's, in float32 on the CPU, on the same numpy inputs and the JAX
package's seeded weights (converted with ``state_dict_from_jax``).

Tolerances: 2D positional tables bit-equal (both are numpy float64 cast to
float32); the float32 angle helpers within one float32 step (XLA's own
jitted and op-by-op results differ by as much); DETR's logits and boxes
within 1e-4 (BASELINE.md's per-module gate), bf16 within 2% of the logit
range; matching costs within 1e-5 relative; assignments exactly equal,
the auction's included; the loss and its gradients with respect to logits
and boxes within 1e-5; one AdamW step of the small DETR within 1e-5 on
the loss and the gradients and 1e-6 on the parameters (JAX's AdamW on the
port's gradients, JAX's whole step where a gradient is above 1e-5)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chambers_tpu.layers import embedding as jemb
from chambers_tpu.losses import detection as jdet
from chambers_tpu.models.detection import DETR as JaxDETR
from chambers_tpu.optimizers import AdamW as JaxAdamW
from chambers_tpu.optimizers import decay_mask as jax_decay_mask
from chambers_tpu.optimizers import _param_paths
from chambers_tpu_torch.layers import embedding as temb
from chambers_tpu_torch.losses import detection as tdet
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from chambers_tpu_torch.models.detection import DETR, build_detr
from chambers_tpu_torch.optimizers import AdamW, decay_mask, jax_path
from test_torch_package import one_torch_thread  # noqa: F401

# the small DETR: 64 px, width 32, 4 heads, MLP 64, 1 + 2 layers, 10 queries
SMALL = dict(num_classes=7, num_queries=10, embed_dim=32, num_heads=4,
             ff_dim=64, num_encoder_layers=1, num_decoder_layers=2)
B, T, SIZE = 3, 4, 64


def _f(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# positional encodings and embeddings
# ---------------------------------------------------------------------------

PE2D_CASES = {
    "plain": dict(),
    "normalize": dict(normalize=True),
    "normalize_scale": dict(normalize=True, scale=3.0),
    "normalize_scale_eps": dict(normalize=True, scale=1.0, eps=1e-3),
    "temperature": dict(temperature=20.0),
}


@pytest.mark.parametrize("shape", [(4, 4, 32), (3, 7, 16), (1, 5, 8),
                                   (14, 14, 256)])
@pytest.mark.parametrize("case", sorted(PE2D_CASES))
def test_positional_encoding_2d_tables_are_bit_equal(case, shape):
    kw = PE2D_CASES[case]
    want = jemb.positional_encoding_2d(*shape, **kw)
    got = temb.positional_encoding_2d(*shape, **kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["plain", "normalize_scale"])
def test_positional_encoding_2d_module_matches_jax(case, dtype):
    """The table is cast float32 -> the input's dtype, then added."""
    kw = PE2D_CASES[case]
    x = np.random.RandomState(0).randn(2, 3, 5, 16).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for add in (True, False):
        mod = jemb.PositionalEncoding2D(add_to_input=add, **kw)
        want = mod.apply({}, jx)
        got = temb.PositionalEncoding2D(add_to_input=add, **kw)(tx)
        assert got.dtype == tx.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.float().numpy(), _f(want))


def test_positional_encoding_2d_scale_needs_normalize():
    with pytest.raises(ValueError, match="normalize"):
        temb.positional_encoding_2d(2, 2, 4, scale=2.0)


@pytest.mark.parametrize("dim", [8, 32, 256, 512])
def test_angle_helpers_match_jax(dim):
    ulp = 2.0 ** -23
    seq = (np.arange(50, dtype=np.float32) * np.float32(1.37))[:, None]
    rates = temb.angle_rates(np.arange(dim), dim)
    assert rates.dtype == torch.float32 and rates.shape == (1, dim)
    np.testing.assert_allclose(rates.numpy(), _f(jemb.angle_rates(
        np.arange(dim), dim)), rtol=ulp, atol=0)
    got = temb.sequence_sin_cos_angles(seq, dim).numpy()
    assert got.shape == (1, 50, dim)
    eager = _f(jemb.sequence_sin_cos_angles(seq, dim))
    np.testing.assert_allclose(got, eager, rtol=0, atol=ulp)
    # jitted, XLA's fused sin and cos move a few entries by a few steps
    jitted = _f(jax.jit(jemb.sequence_sin_cos_angles, static_argnums=1)(
        seq, dim))
    np.testing.assert_allclose(got, jitted, rtol=0,
                               atol=np.abs(eager - jitted).max() + ulp)


@pytest.mark.parametrize("add_to_input", [True, False])
def test_learned_embedding_0d_matches_jax(add_to_input):
    x = np.random.RandomState(1).randn(2, 5, 6).astype(np.float32)
    mod = jemb.LearnedEmbedding0D(add_to_input=add_to_input)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    layer = temb.LearnedEmbedding0D(6, add_to_input=add_to_input,
                                    device="cpu")
    layer.load_state_dict(state_dict_from_jax(jax.device_get(
        variables["params"])))
    np.testing.assert_array_equal(
        layer(torch.from_numpy(x)).detach().numpy(),
        _f(mod.apply(variables, jnp.asarray(x))))


# ---------------------------------------------------------------------------
# DETR
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_detr(aux_loss=True, dtype=None, dropout_rate=0.0):
    """The small JAX DETR and its seeded parameters (made once)."""
    module = JaxDETR(aux_loss=aux_loss, dtype=dtype,
                     dropout_rate=dropout_rate, **SMALL)
    params = module.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    return module, params


def _port_detr(params, aux_loss=True, dtype=None):
    model = DETR(aux_loss=aux_loss, dtype=dtype, dropout_rate=0.0,
                 device="cpu", **SMALL)
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return model.eval()


def _images(seed=0, b=B):
    return np.random.RandomState(seed).rand(b, SIZE, SIZE, 3).astype(
        np.float32)


def _targets(seed=1, b=B, t=T, n_classes=SMALL["num_classes"]):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, (b, t))
    boxes = rng.rand(b, t, 4).astype(np.float32)
    mask = rng.rand(b, t) < 0.6
    mask[:, 0] = True
    mask[-1] = False  # an image without targets
    return {"labels": labels, "boxes": boxes, "mask": mask}


def _jt(targets):
    return {k: jnp.asarray(v) for k, v in targets.items()}


def _tt(targets):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in targets.items()}


@pytest.mark.parametrize("aux_loss", [True, False])
def test_detr_float32_matches_jax(aux_loss):
    module, params = _jax_detr(aux_loss)
    x = _images()
    want = jax.jit(module.apply)({"params": params}, jnp.asarray(x))
    got = _port_detr(params, aux_loss)(torch.from_numpy(x))
    layers = (SMALL["num_decoder_layers"],) if aux_loss else ()
    q = SMALL["num_queries"]
    assert got["logits"].shape == (B,) + layers + (q,
                                                   SMALL["num_classes"] + 1)
    assert got["boxes"].shape == (B,) + layers + (q, 4)
    for k in ("logits", "boxes"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].detach().numpy(), _f(want[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_detr_bf16_follows_jax():
    module, params = _jax_detr(dtype=jnp.bfloat16)
    x = _images(2)
    want = jax.jit(module.apply)({"params": params}, jnp.asarray(x))
    got = _port_detr(params, dtype=torch.bfloat16)(torch.from_numpy(x))
    span = float(jnp.max(want["logits"]) - jnp.min(want["logits"]))
    for k, bound in (("logits", 0.02 * span), ("boxes", 0.02)):
        assert got[k].dtype == torch.float32
        diff = np.abs(got[k].detach().numpy() - _f(want[k])).max()
        assert diff <= bound, (k, diff, bound)


def test_build_detr_is_seeded_in_eval_mode_with_jax_names():
    a = build_detr(input_shape=(SIZE, SIZE, 3), device="cpu", seed=3,
                   **SMALL)
    b = build_detr(input_shape=(SIZE, SIZE, 3), device="cpu", seed=3,
                   **SMALL)
    assert not a.training
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    _, params = _jax_detr()
    want = state_dict_from_jax(jax.device_get(params))
    got = a.state_dict()
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
    # query_embed is normal(1.0), the backbone's bias zeros
    assert 0.5 < float(a.query_embed.detach().std()) < 1.5
    assert not a.backbone.bias.any()


@pytest.mark.parametrize("patterns", [dict(decay_exclude=["bias", "norm"]),
                                      dict(decay_include=["^bbox_head_1/"]),
                                      dict()])
def test_decay_mask_matches_jax(patterns):
    _, params = _jax_detr()
    want = dict(zip(_param_paths(params), jax.tree_util.tree_leaves(
        jax_decay_mask(params, **patterns))))
    model = DETR(dropout_rate=0.0, device="meta", **SMALL)
    got = {jax_path(name): decays
           for name, decays in decay_mask(model, **patterns).items()}
    assert got == want


# ---------------------------------------------------------------------------
# costs and matchers
# ---------------------------------------------------------------------------

def _predictions(seed=3, b=B, q=SMALL["num_queries"],
                 c=SMALL["num_classes"] + 1, layers=None):
    rng = np.random.RandomState(seed)
    lead = (b,) if layers is None else (b, layers)
    logits = (rng.randn(*lead, q, c) * 2).astype(np.float32)
    boxes = (1 / (1 + np.exp(-rng.randn(*lead, q, 4)))).astype(np.float32)
    return logits, boxes


def test_box_utilities_match_jax():
    rng = np.random.RandomState(4)
    a = rng.rand(6, 4).astype(np.float32)
    b = rng.rand(5, 4).astype(np.float32)
    ja, jb = jdet.box_cxcywh_to_xyxy(a), jdet.box_cxcywh_to_xyxy(b)
    ta = tdet.box_cxcywh_to_xyxy(torch.from_numpy(a))
    tb = tdet.box_cxcywh_to_xyxy(torch.from_numpy(b))
    np.testing.assert_allclose(ta.numpy(), _f(ja), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tdet.box_area(ta).numpy(),
                               _f(jdet.box_area(ja)), rtol=1e-6, atol=1e-7)
    for got, want in zip(tdet.box_iou(ta, tb), jdet.box_iou(ja, jb)):
        np.testing.assert_allclose(got.numpy(), _f(want), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(
        tdet.generalized_box_iou(ta, tb).numpy(),
        _f(jdet.generalized_box_iou(ja, jb)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tdet.paired_generalized_box_iou(ta[:5], tb).numpy(),
        _f(jdet.paired_generalized_box_iou(ja[:5], jb)), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("weights", [(1.0, 5.0, 2.0), (0.5, 1.0, 3.0)])
def test_matching_costs_match_jax(weights):
    logits, boxes = _predictions()
    tg = _targets()
    kw = dict(zip(("cost_class", "cost_bbox", "cost_giou"), weights))
    want = jdet.matching_cost_matrix(jnp.asarray(logits), jnp.asarray(boxes),
                                     *_jt(tg).values(), **kw)
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = tdet.matching_cost_matrix(lt, torch.from_numpy(boxes),
                                    *_tt(tg).values(), **kw)
    assert got.shape == (B, T, SMALL["num_queries"])
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), _f(want), rtol=1e-5)
    assert (got.numpy()[~tg["mask"]] == 1e6).all()


def _auction_costs():
    """Cost matrices ``[p, n, m]`` on which both packages' auctions run."""
    rng = np.random.RandomState(5)
    cases = {
        "random": rng.randn(6, 5, 9),
        "well_separated": np.round(rng.rand(4, 6, 8) * 100),
        "square": rng.rand(5, 7, 7),
        "one_column": rng.randn(3, 1, 1),
        "one_row": rng.randn(3, 1, 6),
        "ties": np.round(rng.rand(4, 5, 6) * 2),
    }
    padded = rng.randn(5, 8, 12)
    padded[:, 4:] = 1e6  # padded target slots, as the costs make them
    padded[0, 1:] = 1e6
    cases["padded_rows"] = padded
    return {k: v.astype(np.float32) for k, v in cases.items()}


@pytest.mark.parametrize("eps,max_iters", [(1e-2, 200), (1e-3, 200),
                                           (1e-2, 3)])
@pytest.mark.parametrize("case", sorted(_auction_costs()))
def test_auction_equals_jax_on_its_costs(case, eps, max_iters):
    """Exact equality on JAX's own matrices; ``max_iters=3`` leaves rows
    unassigned, so the fallback's free columns are held as well."""
    cost = _auction_costs()[case]
    want = np.asarray(jdet.auction_assignment(jnp.asarray(cost), eps=eps,
                                              max_iters=max_iters))
    got = tdet.auction_assignment(torch.from_numpy(cost), eps=eps,
                                  max_iters=max_iters)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    for row in got.numpy():
        assert len(set(row)) == len(row)


def test_auction_fallback_is_reached():
    """With three iterations some padded problem is still unassigned (the
    case above then holds the fallback, not the loop alone)."""
    cost = torch.from_numpy(_auction_costs()["padded_rows"])
    row2col, iterations = tdet._auction_rows(-cost, 1e-2, 3, 1)
    assert iterations == 3 and bool((row2col < 0).any())
    _, iterations = tdet._auction_rows(-cost, 1e-2, 200, 1)
    assert 3 < iterations < 200


@pytest.mark.parametrize("check_every", [1, 5, 8, 200])
def test_auction_result_does_not_depend_on_the_check_interval(check_every):
    cost = torch.from_numpy(_auction_costs()["padded_rows"])
    want, _ = tdet._auction_rows(-cost, 1e-2, 200, 1)
    got, iterations = tdet._auction_rows(-cost, 1e-2, 200, check_every)
    assert torch.equal(got, want) and iterations <= 200


def test_auction_is_near_the_optimum():
    from scipy.optimize import linear_sum_assignment

    cost = _auction_costs()["random"]
    got = tdet.auction_assignment(torch.from_numpy(cost), eps=1e-3).numpy()
    for c, cols in zip(cost.astype(np.float64), got):
        r, best = linear_sum_assignment(c)
        total = c[np.arange(len(cols)), cols].sum()
        assert total - c[r, best].sum() <= len(cols) * 1e-3 + 1e-9


def test_matchers_refuse_more_rows_than_columns():
    cost = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError, match="rows"):
        tdet.auction_assignment(cost)
    with pytest.raises(ValueError, match="num_queries"):
        tdet.linear_sum_assignment(cost)
    with pytest.raises(ValueError, match="matcher"):
        tdet.DETRLoss(3, matcher="greedy")


def test_hungarian_matcher_equals_jax():
    logits, boxes = _predictions(6)
    tg = _targets(7)
    want = jdet.hungarian_matcher(jnp.asarray(logits), jnp.asarray(boxes),
                                  *_jt(tg).values())
    args = (torch.from_numpy(logits), torch.from_numpy(boxes),
            *_tt(tg).values())
    for fn in (tdet.hungarian_matcher, tdet.hungarian_matcher_host):
        got = fn(*args)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def _jax_loss_and_grads(loss_fn, logits, boxes, tg, assignment=None):
    def f(lg, bx):
        return loss_fn({"logits": lg, "boxes": bx}, _jt(tg),
                       assignment=assignment)

    value, grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jnp.asarray(logits), jnp.asarray(boxes))
    return float(value), [np.asarray(g) for g in grads]


def _port_loss_and_grads(loss_fn, logits, boxes, tg, assignment=None):
    lt = torch.from_numpy(logits).requires_grad_(True)
    bt = torch.from_numpy(boxes).requires_grad_(True)
    value = loss_fn({"logits": lt, "boxes": bt}, _tt(tg),
                    assignment=assignment)
    value.backward()
    return value.item(), [lt.grad.numpy(), bt.grad.numpy()]


@pytest.mark.parametrize("eos_coef", [0.1, 1.0])
@pytest.mark.parametrize("layers", [None, 3])
def test_loss_given_the_same_assignment_matches_jax(layers, eos_coef):
    logits, boxes = _predictions(8, layers=layers)
    tg = _targets(9)
    kw = dict(num_classes=SMALL["num_classes"], eos_coef=eos_coef)
    outputs = {"logits": jnp.asarray(logits), "boxes": jnp.asarray(boxes)}
    assignment = np.array(jdet.DETRLoss(**kw).match(outputs, _jt(tg)))
    assert assignment.shape == ((layers,) if layers else ()) + (B, T)
    want, want_grads = _jax_loss_and_grads(
        jdet.DETRLoss(**kw), logits, boxes, tg, jnp.asarray(assignment))
    got, grads = _port_loss_and_grads(
        tdet.DETRLoss(**kw), logits, boxes, tg,
        torch.from_numpy(assignment))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("matcher", ["auction", "hungarian"])
@pytest.mark.parametrize("layers", [None, 3])
def test_loss_with_each_sides_matcher_matches_jax(layers, matcher):
    """Each package matches with its own matcher: the assignments, the
    loss and its gradients agree."""
    logits, boxes = _predictions(10, layers=layers)
    tg = _targets(11)
    kw = dict(num_classes=SMALL["num_classes"], matcher=matcher)
    jloss, tloss = jdet.DETRLoss(**kw), tdet.DETRLoss(**kw)
    outputs = {"logits": jnp.asarray(logits), "boxes": jnp.asarray(boxes)}
    toutputs = {"logits": torch.from_numpy(logits),
                "boxes": torch.from_numpy(boxes)}
    if matcher == "auction" and layers:
        want = jloss._auction_all_layers(outputs["logits"],
                                         outputs["boxes"], _jt(tg))
        got = tloss._auction_all_layers(toutputs["logits"],
                                        toutputs["boxes"], _tt(tg))
    else:
        want, got = jloss.match(outputs, _jt(tg)), tloss.match(toutputs,
                                                               _tt(tg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_value, want_grads = _jax_loss_and_grads(jloss, logits, boxes, tg)
    value, grads = _port_loss_and_grads(tloss, logits, boxes, tg)
    np.testing.assert_allclose(value, want_value, rtol=1e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def _port_name(path):
    """The port's name of a JAX parameter path (``layers_0`` ->
    ``layers.0`` for each element, as the converter names it)."""
    return ".".join(next(iter(state_dict_from_jax({k.key: np.zeros(1)})))
                    for k in path)


def test_detr_adamw_step_matches_jax():
    """``bench.py``'s config 5 at the small size: the DETR forward (aux
    layers, deterministic), the auction-matched loss summed over the
    layers and one AdamW step with ``decay_exclude=["bias", "norm"]``: the
    loss, the assignment, every gradient and every updated parameter
    against JAX's, float32."""
    module, params = _jax_detr()
    x, tg = _images(12), _targets(13)
    jloss = jdet.DETRLoss(num_classes=SMALL["num_classes"], matcher="auction")

    def loss_of(p):
        out = module.apply({"params": p}, jnp.asarray(x), deterministic=True)
        return jloss(out, _jt(tg))

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    jopt = JaxAdamW(weight_decay=1e-4, learning_rate=1e-4,
                    decay_exclude=["bias", "norm"])
    updates, _ = jopt.update(jgrads, jopt.init(params), params)
    want_params = state_dict_from_jax(jax.device_get(
        optax.apply_updates(params, updates)))
    want_grads = state_dict_from_jax(jax.device_get(jgrads))

    model = _port_detr(params).train()
    opt = AdamW(model.named_parameters(), weight_decay=1e-4,
                learning_rate=1e-4, decay_exclude=["bias", "norm"])
    tloss = tdet.DETRLoss(num_classes=SMALL["num_classes"], matcher="auction")
    out = model(torch.from_numpy(x), deterministic=True)
    loss = tloss(out, _tt(tg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want_grads[name].numpy()
        live = np.abs(w) > 1e-5
        np.testing.assert_allclose(g[live], w[live], atol=1e-5, rtol=1e-5,
                                   err_msg=name)
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
        live = np.abs(want_grads[name].numpy()) > 1e-5
        np.testing.assert_allclose(got[live], want_params[name].numpy()[live],
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_chip_smoke_lists_the_jax_detr_decay_set():
    """The DETR phase of ``chip_smoke.py`` holds the port's decayed
    parameters to a list it carries as data: that list is the JAX
    package's, for bench.py's config 5 (shapes only, nothing is made)."""
    import chip_smoke

    cfg = chip_smoke.DETR
    module = JaxDETR(num_classes=cfg["classes"], num_queries=cfg["queries"],
                     embed_dim=cfg["width"], num_heads=cfg["heads"],
                     ff_dim=cfg["mlp"], num_encoder_layers=cfg["layers"],
                     num_decoder_layers=cfg["layers"], aux_loss=True)
    params = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, cfg["size"], cfg["size"], 3))))["params"]
    mask = jax_decay_mask(params, decay_exclude=["bias", "norm"])
    want = {path for path, decays in zip(
        _param_paths(params), jax.tree_util.tree_leaves(mask)) if decays}
    assert set(chip_smoke.detr_decayed_paths()) == want
