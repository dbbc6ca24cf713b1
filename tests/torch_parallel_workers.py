"""Worker functions for the port's multi-process tests
(``tests/test_torch_parallel*.py``), and :func:`run_world`, which runs one
in ``world`` spawned processes over gloo.

Spawned children re-import this module, so it imports only torch, numpy
and the port, never JAX. The parent computes JAX's references and hands
every input over as numpy arrays; each worker returns a dict of numpy
arrays (and plain values) from every rank.
"""

import os
import pickle
import sys
import tempfile
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(world, name, args=None, timeout=240):
    """Run ``name(rank, world, args)`` of this module in ``world`` spawned
    processes joined by a gloo group over a ``FileStore``; returns the
    ranks' results in rank order. A world that does not finish within
    ``timeout`` seconds is killed and fails."""
    import multiprocessing as mp

    context = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        procs = [context.Process(target=_entry,
                                 args=(rank, world, name, tmp))
                 for rank in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        if hung:
            raise TimeoutError(f"{name} on {world} ranks did not finish in "
                               f"{timeout} s")
        results = []
        for rank in range(world):
            path = os.path.join(tmp, f"out{rank}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"{name}: rank {rank} exited with code "
                                   f"{procs[rank].exitcode} and no result")
            with open(path, "rb") as f:
                ok, value = pickle.load(f)
            if not ok:
                raise RuntimeError(f"{name}: rank {rank} failed:\n{value}")
            results.append(value)
        return results


def _entry(rank, world, name, tmp):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    import torch.distributed as dist

    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    try:
        out = (True, globals()[name](rank, world, args))
    except Exception:
        out = (False, traceback.format_exc())
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    try:
        dist.destroy_process_group()
    except Exception:
        pass


def _np(t):
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# helpers of the checks
# ---------------------------------------------------------------------------

def checks(rank, world, args):
    """Run the checks ``args``, ``(label, name, kwargs)`` each, in this
    world; a check that raises gives its traceback in place of its
    result."""
    out = {}
    for label, name, kwargs in args:
        try:
            out[label] = CHECKS[name](world, **kwargs)
        except Exception:
            out[label] = {"error": traceback.format_exc()}
    return out


def _mesh(axes):
    from chambers_tpu_torch.parallel import create_mesh

    return create_mesh(axes, device="cpu")


def _load(module, state):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state.items()})
    return module


def _t(x):
    return torch.from_numpy(np.array(x))


def _whole(module):
    """Every parameter whole (the shards of a placed module gathered)."""
    from chambers_tpu_torch.parallel.sharding import full_tensor

    return {n: _np(full_tensor(p)) for n, p in module.named_parameters()}


def _whole_grads(module):
    from chambers_tpu_torch.parallel.sharding import full_tensor

    return {n: _np(full_tensor(p.grad, getattr(p, "sharding", None)))
            for n, p in module.named_parameters() if p.grad is not None}


def _sharded_forward(module, mesh, x, **kwargs):
    """``module`` on this rank's rows of ``x``, the outputs gathered."""
    from chambers_tpu_torch.parallel.distributed import (
        data_parallel,
        gather_rows,
        local_rows,
    )

    with data_parallel(module, mesh):
        y = module(_t(local_rows(np.asarray(x), mesh)), **kwargs)
    return gather_rows(y, mesh, len(x))


def _sgd(module, lr):
    with torch.no_grad():
        for p in module.parameters():
            if p.grad is not None:
                p -= lr * p.grad


def _adamw(module, **kwargs):
    from chambers_tpu_torch.optimizers import AdamW

    return AdamW(list(module.named_parameters()), **kwargs)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def mesh_api(n, tp_params):
    """create_mesh's rules, shard_batch, host_local_batch_to_global,
    make_param_shardings / shard_params of the TP rules, the named
    non-divisible error and init_distributed's summary."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from chambers_tpu_torch.parallel import (
        VIT_TENSOR_PARALLEL_RULES,
        create_mesh,
        host_local_batch_to_global,
        init_distributed,
        make_param_shardings,
        shard_batch,
        shard_params,
    )

    out = {}
    mesh = create_mesh(device="cpu")
    out["default"] = (mesh.mesh_dim_names, tuple(mesh.mesh.shape))
    mesh = create_mesh({"data": -1, "model": 2}, device="cpu")
    out["wildcard"] = (mesh.mesh_dim_names, tuple(mesh.mesh.shape))
    errors = []
    for axes in ({"data": 3, "model": 2}, {"data": -1, "model": -1}):
        try:
            create_mesh(axes, device="cpu")
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    dp = create_mesh({"data": n}, device="cpu")
    xs = shard_batch(np.zeros((2 * n, 4), np.float32), dp)
    out["shard_batch"] = (tuple(xs.to_local().shape), tuple(xs.shape),
                          xs.placements == (Shard(0),))
    placed = host_local_batch_to_global(
        {"x": np.full((2, 3), dist.get_rank(), np.float32),
         "y": np.zeros(2, np.int64)}, dp)
    out["host_local"] = (tuple(placed["x"].shape),
                         tuple(placed["x"].to_local().shape),
                         _np(placed["x"])[:, 0].tolist())
    from chambers_tpu_torch.data import device_prefetch
    from chambers_tpu_torch.parallel import batch_sharding

    # every rank passes the global batch; only its rows are copied
    batch = np.arange(4 * n, dtype=np.float32).reshape(2 * n, 2)
    (got,) = list(device_prefetch([batch], sharding=batch_sharding(dp)))
    out["prefetch"] = (tuple(got.shape), _np(got.to_local()).tolist())
    shardings = make_param_shardings(tp_params, mesh,
                                     VIT_TENSOR_PARALLEL_RULES)
    layer = shardings["encoder"]["layers_0"]
    out["specs"] = {
        "w_query": tuple(layer["multi_head_attention"]["w_query"].spec),
        "w_projection": tuple(
            layer["multi_head_attention"]["w_projection"].spec),
        "dense1": tuple(layer["dense1"]["kernel"].spec),
        "dense2": tuple(layer["dense2"]["kernel"].spec),
        "norm1": tuple(layer["norm1"]["scale"].spec),
        "b_projection": tuple(
            layer["multi_head_attention"]["b_projection"].spec)}
    placed = shard_params(tp_params, mesh, VIT_TENSOR_PARALLEL_RULES)
    wq = placed["encoder"]["layers_0"]["multi_head_attention"]["w_query"]
    out["w_query_local"] = tuple(wq.to_local().shape)
    try:
        make_param_shardings(
            {"multi_head_attention": {"w_query": np.zeros((16, 3, 4))}},
            mesh, VIT_TENSOR_PARALLEL_RULES)
        out["nondivisible"] = None
    except ValueError as e:
        out["nondivisible"] = str(e)
    out["init"] = init_distributed(device="cpu")
    return out


def dp_grad(n, w, x, y):
    """The gradient of ``mean((x w - y)^2)`` with ``w`` replicated and the
    batch sharded over ``data``."""
    from chambers_tpu_torch.parallel import shard_params
    from chambers_tpu_torch.parallel.sharding import reduce_gradients
    from chambers_tpu_torch.quantization import QuantDense

    mesh = _mesh({"data": n})
    net = QuantDense(4, 1, use_bias=False, device="cpu")
    _load(net, {"kernel": w})
    shard_params(net, mesh)
    pred = _sharded_forward(net, mesh, x)
    torch.mean((pred - _t(y)) ** 2).backward()
    reduce_gradients(net)
    return {"grad": _np(net.kernel.grad)}


def tp_mha(n, state, x, model):
    """A tensor-parallel MultiHeadAttention forward (heads over
    ``model``)."""
    from chambers_tpu_torch.layers.attention import MultiHeadAttention
    from chambers_tpu_torch.parallel import shard_params
    from chambers_tpu_torch.parallel.sharding import P

    mesh = _mesh({"data": n // model, "model": model})
    mha = _load(MultiHeadAttention(32, head_dim=8, num_heads=4,
                                   dropout_rate=0.0, device="cpu"), state)
    rules = [(r"w_(query|key|value)$", P(None, "model", None)),
             (r"b_(query|key|value)$", P("model", None, None)),
             (r"w_projection$", P("model", None, None))]
    shard_params(mha, mesh, rules)

    class Self(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mha = mha

        def forward(self, h):
            return self.mha([h, h])

    with torch.no_grad():
        out = _sharded_forward(Self(), mesh, x)
    return {"out": _np(out), "local_heads": mha.w_query.shape[1],
            "tp": mha._tp_group is not None}


def dp_tp_vit(n, state, images, labels, model):
    """dryrun_multichip's DP x TP step: a ViT with the TP rules, the
    multi-similarity loss on the global batch's embeddings, AdamW; two
    steps."""
    from chambers_tpu_torch.layers.normalization import l2_normalize
    from chambers_tpu_torch.losses import MultiSimilarityLoss
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )
    from chambers_tpu_torch.parallel import (
        VIT_TENSOR_PARALLEL_RULES,
        shard_params,
    )
    from chambers_tpu_torch.parallel.sharding import reduce_gradients

    mesh = _mesh({"data": n // model, "model": model})
    vit = _load(VisionTransformer(
        patch_size=8, patch_dim=32, n_encoder_layers=2, n_heads=4,
        ff_dim=64, dropout_rate=0.1, image_size=(16, 16), include_top=False,
        pooling="cls", device="cpu"), state)
    shard_params(vit, mesh, VIT_TENSOR_PARALLEL_RULES)
    opt = _adamw(vit, weight_decay=1e-4, learning_rate=1e-3,
                 decay_exclude=["bias", "norm"])
    loss_fn = MultiSimilarityLoss()
    losses = []
    for _ in range(2):
        opt.zero_grad()
        z = _sharded_forward(vit, mesh, images, deterministic=True)
        loss = loss_fn(_t(labels), l2_normalize(z, axis=-1))
        loss.backward()
        reduce_gradients(vit)
        if not losses:
            grads = _whole_grads(vit)
        opt.step()
        losses.append(loss.item())
    return {"losses": losses, "grads": grads,
            "tp": [m._tp_group is not None for m in vit.modules()
                   if hasattr(m, "_tp_group")]}


def pp_step(n, states, x):
    """dryrun_multichip's PP x DP gradient: 4 encoder layers in 2 stages over
    ``pipe``, batch over ``data``, 2 microbatches a data shard."""
    from torch.func import functional_call

    from chambers_tpu_torch.layers.transformer import EncoderLayer
    from chambers_tpu_torch.parallel import (
        group_layers_into_stages,
        pipeline_apply,
    )
    from chambers_tpu_torch.parallel.distributed import axis_index

    mesh = _mesh({"data": n // 2, "pipe": 2})
    layer = EncoderLayer(16, 2, 32, attention_dropout_rate=0.0,
                         dense_dropout_rate=0.0, pre_norm=True, device="cpu")
    stacked = group_layers_into_stages(
        [{k: _t(v) for k, v in s.items()} for s in states], 2)
    for v in stacked.values():
        v.requires_grad_(True)

    def stage_fn(params, h):
        for i in range(2):
            h = functional_call(layer, {k: v[i] for k, v in params.items()},
                                (h,), {"deterministic": True})
        return h

    y = pipeline_apply(stage_fn, stacked, _t(x), mesh=mesh, axis="pipe",
                       n_microbatches=2, batch_axis="data")
    loss = torch.mean(y ** 2)
    loss.backward()
    stage = axis_index(mesh, "pipe")
    return {"loss": loss.item(), "stage": stage,
            "grads": {k: _np(v.grad[stage]) for k, v in stacked.items()}}


def _moe_step(n, state, x, axes, rules, kind, lr):
    from chambers_tpu_torch.layers.moe import MoEEncoderLayer, moe_aux_loss
    from chambers_tpu_torch.parallel import shard_params
    from chambers_tpu_torch.parallel.sharding import reduce_gradients

    width = {"small": (16, 2, 32), "composition": (32, 4, 64)}[kind]
    mesh = _mesh(axes)
    layer = _load(MoEEncoderLayer(
        *width, n_experts=4, pre_norm=True, n_selected_experts=2,
        router_z_loss_weight=1e-3, attention_dropout_rate=0.0,
        dense_dropout_rate=0.0, device="cpu"), state)
    shard_params(layer, mesh, rules)
    y = _sharded_forward(layer, mesh, x)
    loss = torch.mean(y ** 2) + moe_aux_loss(layer)
    loss.backward()
    reduce_gradients(layer)
    if lr is None:
        opt = _adamw(layer, weight_decay=1e-4, learning_rate=1e-3)
        opt.step()
    else:
        _sgd(layer, lr)
    return {"loss": loss.item(), "params": _whole(layer),
            "expert_local": tuple(layer.moe.w1.shape),
            "ep": layer.moe._expert_axis}


def ep_dp_step(n, state, x):
    """dryrun_multichip's EP x DP step: experts over ``expert``, batch over
    ``data``."""
    from chambers_tpu_torch.parallel import moe_expert_parallel_rules

    return _moe_step(n, state, x, {"data": n // 2, "expert": 2},
                     moe_expert_parallel_rules("expert"), "small", 1e-3)


def dp_tp_ep_step(n, state, x):
    """The three-axis step: heads over ``model``, experts over ``expert``,
    batch over ``data``, AdamW."""
    from chambers_tpu_torch.parallel import (
        SEQ2SEQ_TENSOR_PARALLEL_RULES,
        moe_expert_parallel_rules,
        make_param_shardings,
    )

    rules = (list(SEQ2SEQ_TENSOR_PARALLEL_RULES)
             + moe_expert_parallel_rules("expert"))
    axes = {"data": n // 4, "model": 2, "expert": 2}
    out = _moe_step(n, state, x, axes, rules, "composition", None)
    from chambers_tpu_torch.layers.moe import MoEEncoderLayer

    specs = make_param_shardings(MoEEncoderLayer(
        32, 4, 64, n_experts=4, device="cpu"), _mesh(axes), rules)
    out["specs"] = {k: tuple(specs[k].spec) for k in (
        "multi_head_attention.w_query", "moe.w1")}
    return out


def context_parallel(n, q, v, k=None):
    """Flash attention with the query tokens over ``data``: the output,
    ``sum(out^2)`` and its gradient in the query."""
    from chambers_tpu_torch.parallel import context_parallel_attention

    mesh = _mesh({"data": n})
    q = _t(q).requires_grad_(True)
    out = context_parallel_attention(q, _t(v), None if k is None else _t(k),
                                     mesh=mesh)
    value = torch.sum(out ** 2)
    value.backward()
    return {"out": _np(out), "value": value.item(), "grad": _np(q.grad)}


def decode(n, state, src_dp, src_beam, src_tp):
    """Greedy and beam decode with the batch over ``data``, and greedy
    decode of a TP-placed model (with and without the cache)."""
    from chambers_tpu_torch.models import (
        Seq2SeqTransformer,
        beam_search_decode,
        greedy_decode,
    )
    from chambers_tpu_torch.parallel import (
        SEQ2SEQ_TENSOR_PARALLEL_RULES,
        make_param_shardings,
        shard_batch,
        shard_params,
    )

    def model():
        return _load(Seq2SeqTransformer(24, 24, 32, 4, 64, 2, 2,
                                        dropout_rate=0.0, device="cpu"),
                     state).eval()

    out = {}
    dp = _mesh({"data": n})
    m = model()
    out["greedy"] = _np(greedy_decode(m, shard_batch(src_dp, dp), max_len=8,
                                      bos_id=1, use_cache=True))
    tokens, scores = beam_search_decode(
        m, shard_batch(src_beam, dp), max_len=8, bos_id=1, beam_size=3,
        eos_id=2, return_scores=True, use_cache=True)
    out["beam"], out["beam_scores"] = _np(tokens), _np(scores)
    tp = _mesh({"data": n // 2, "model": 2})
    specs = make_param_shardings(m, tp, SEQ2SEQ_TENSOR_PARALLEL_RULES)
    out["specs"] = {k: tuple(specs[k].spec) for k in (
        "decoder.layers.0.multi_head_attention1.w_query",
        "decoder.layers.0.multi_head_attention2.w_projection")}
    for cache in (True, False):
        m = shard_params(model(), tp, SEQ2SEQ_TENSOR_PARALLEL_RULES)
        out[f"tp_cache_{cache}"] = _np(greedy_decode(
            m, shard_batch(src_tp, tp), max_len=8, bos_id=1,
            use_cache=cache))
    out["local_heads"] = m.decoder.layers[0].multi_head_attention1 \
        .w_query.shape[1]
    return out


def fsdp_step(n, state, x):
    """dryrun_multichip's FSDP step: an encoder layer placed by fsdp_rules,
    Adam (the moments 1/N), the loss on the global batch."""
    from chambers_tpu_torch.layers.transformer import EncoderLayer
    from chambers_tpu_torch.parallel import fsdp_rules, shard_params
    from chambers_tpu_torch.parallel.sharding import reduce_gradients

    mesh = _mesh({"data": n})
    layer = _load(EncoderLayer(16, 2, 32, attention_dropout_rate=0.0,
                               dense_dropout_rate=0.0, pre_norm=True,
                               device="cpu"), state)
    rules = fsdp_rules(layer, mesh, min_weight_size=16 * 32)
    shard_params(layer, mesh, rules)
    opt = _adamw(layer, weight_decay=0.0, learning_rate=1e-3, epsilon=1e-8)
    loss = torch.mean(_sharded_forward(layer, mesh, x,
                                       deterministic=True) ** 2)
    loss.backward()
    reduce_gradients(layer)
    grads = _whole_grads(layer)
    opt.step()
    mu = opt.state[layer.dense1.kernel]["mu"]
    return {"loss": loss.item(), "mu_local": tuple(mu.shape),
            "kernel_global": layer.dense1.kernel.global_shape,
            "grads": grads}


def lora_freeze(n, state, x, y):
    """LoRA adapters trained by Trainer(mesh=) over ``data``: the adapters'
    update equals the meshless one, the frozen base stays bit for bit."""
    from chambers_tpu_torch.layers.attention import MultiHeadAttention
    from chambers_tpu_torch.models import Model
    from chambers_tpu_torch.optimizers import AdamW
    from chambers_tpu_torch.quantization import QuantDense
    from chambers_tpu_torch.training import Trainer, lora

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = QuantDense(8, 16, device="cpu")
            self.attn = MultiHeadAttention(16, head_dim=8, num_heads=2,
                                           dropout_rate=0.0, device="cpu")
            self.head = QuantDense(16, 1, device="cpu")

        def forward(self, x, deterministic=None):
            h = self.embed(x)
            return self.head(self.attn([h, h])[:, 0])

    def build():
        model = lora.apply_to_model(Model(_load(Net(), state)), rank=2,
                                    generator=torch.Generator().manual_seed(1))
        return model

    mse = lambda a, b: torch.mean((a - b) ** 2)
    runs = {}
    for key, mesh in (("ref", None), ("mesh", _mesh({"data": n}))):
        model = build()
        trainer = Trainer(model, loss=mse, optimizer=lambda named: AdamW(
            named, weight_decay=0.0, learning_rate=1e-2), mesh=mesh,
            trainable=lora.TRAINABLE)
        history = trainer.fit([(x, y)], epochs=1, verbose=False)
        runs[key] = {"loss": history[0]["loss"],
                     "params": _whole(model.module)}
    return runs


def nondivisible(n):
    """3 heads over a 2-way ``model`` axis: the named error."""
    from chambers_tpu_torch.layers.transformer import EncoderLayer
    from chambers_tpu_torch.parallel import (
        VIT_TENSOR_PARALLEL_RULES,
        make_param_shardings,
    )

    layer = EncoderLayer(48, 3, 96, pre_norm=True, device="cpu")
    try:
        make_param_shardings(layer, _mesh({"data": n // 2, "model": 2}),
                             VIT_TENSOR_PARALLEL_RULES)
    except ValueError as e:
        return {"error_message": str(e)}
    return {"error_message": None}


def wide_dp_tp(n, state, x):
    """DP x TP at width 256, 8 heads, ff 1024: one gradient step."""
    from chambers_tpu_torch.layers.transformer import EncoderLayer
    from chambers_tpu_torch.parallel import (
        VIT_TENSOR_PARALLEL_RULES,
        shard_params,
    )
    from chambers_tpu_torch.parallel.sharding import reduce_gradients

    mesh = _mesh({"data": n // 2, "model": 2})
    layer = _load(EncoderLayer(256, 8, 1024, attention_dropout_rate=0.0,
                               dense_dropout_rate=0.0, pre_norm=True,
                               device="cpu"), state)
    shard_params(layer, mesh, VIT_TENSOR_PARALLEL_RULES)
    loss = torch.mean(_sharded_forward(layer, mesh, x,
                                       deterministic=True) ** 2)
    loss.backward()
    reduce_gradients(layer)
    _sgd(layer, 1e-3)
    return {"loss": loss.item(), "params": _whole(layer)}


class _Net(torch.nn.Module):
    """Flax's ``Dense(1)(relu(Dense(16)(x)))``: the outer Dense is
    ``Dense_0``."""

    def __init__(self, d_in=4, hidden=16, act=torch.relu):
        from chambers_tpu_torch.quantization import QuantDense

        super().__init__()
        self.Dense_0 = QuantDense(hidden, 1, device="cpu")
        self.Dense_1 = QuantDense(d_in, hidden, device="cpu")
        self.act = act

    def forward(self, x, deterministic=None):
        return self.Dense_0(self.act(self.Dense_1(x)))


class _Wide(torch.nn.Module):
    def __init__(self):
        from chambers_tpu_torch.quantization import QuantDense

        super().__init__()
        self.Dense_0 = QuantDense(8, 64, device="cpu")
        self.Dense_1 = QuantDense(64, 64, device="cpu")
        self.Dense_2 = QuantDense(64, 1, device="cpu")

    def forward(self, x, deterministic=None):
        x = torch.relu(self.Dense_0(x))
        return self.Dense_2(torch.relu(self.Dense_1(x)))


class _Linear(torch.nn.Module):
    def __init__(self, act=None):
        from chambers_tpu_torch.quantization import QuantDense

        super().__init__()
        self.Dense_0 = QuantDense(4, 1, device="cpu")
        self.act = act

    def forward(self, x, deterministic=None):
        y = self.Dense_0(x)
        return y if self.act is None else self.act(y)


def _mse(a, b):
    return torch.mean((a - b) ** 2)


def _adam(lr, eps=1e-8):
    from chambers_tpu_torch.optimizers import AdamW

    return lambda named: AdamW(named, weight_decay=0.0, learning_rate=lr,
                               epsilon=eps)


def trainer_dp(n, net_state, data, wide_state, wide_data, attn_state,
               attn_data, f1_state, f1_data, auc_state, auc_data):
    """Trainer(mesh=): data-parallel fit, FSDP fit with its 1/N moments,
    TP rules on an attention net, streaming F1 and AUC in a mesh
    evaluation."""
    from chambers_tpu_torch.layers.attention import MultiHeadAttention
    from chambers_tpu_torch.metrics import AUC, F1
    from chambers_tpu_torch.parallel import (
        VIT_TENSOR_PARALLEL_RULES,
        fsdp_rules,
    )
    from chambers_tpu_torch.quantization import QuantDense
    from chambers_tpu_torch.training import Trainer

    out = {}
    mesh = _mesh({"data": n})
    net = _load(_Net(), net_state)
    trainer = Trainer(net, loss=_mse, optimizer=_adam(1e-2, 1e-7),
                      mesh=mesh)
    out["dp_history"] = [h["loss"] for h in trainer.fit(
        data, epochs=15, verbose=False)]
    out["dp_kernel_local"] = tuple(net.Dense_1.kernel.shape)

    wide = _load(_Wide(), wide_state)
    rules = fsdp_rules(wide, mesh, min_weight_size=64)
    trainer = Trainer(wide, loss=_mse, optimizer=_adam(1e-2), seed=3,
                      mesh=mesh, param_sharding_rules=rules)
    out["fsdp_history"] = [h["loss"] for h in trainer.fit(
        wide_data, epochs=3, verbose=False)]
    out["fsdp_mu_local"] = tuple(
        trainer.optimizer.state[wide.Dense_0.kernel]["mu"].shape)
    out["fsdp_kernel_local"] = tuple(wide.Dense_0.kernel.shape)
    out["fsdp_params"] = _whole(wide)

    class AttnNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.multi_head_attention = MultiHeadAttention(
                16, head_dim=4, num_heads=4, dropout_rate=0.0, device="cpu")
            self.Dense_0 = QuantDense(16, 1, device="cpu")

        def forward(self, x, deterministic=None):
            h = self.multi_head_attention([x, x])
            return self.Dense_0(h[:, 0])

    histories = []
    for mesh_tp in (_mesh({"data": n // 2, "model": 2}), None):
        attn = _load(AttnNet(), attn_state)
        trainer = Trainer(
            attn, loss=_mse, optimizer=_adam(1e-2), mesh=mesh_tp,
            param_sharding_rules=VIT_TENSOR_PARALLEL_RULES if mesh_tp
            else None)
        if mesh_tp is not None:
            wq = attn.multi_head_attention.w_query
            out["tp_spec"] = tuple(wq.sharding.spec)
            out["tp_local"] = tuple(wq.shape)
        histories.append([h["loss"] for h in trainer.fit(
            attn_data, epochs=2, verbose=False)])
    out["tp_history"], out["tp_history_ref"] = histories

    for key, state, act, metric, batches in (
            ("f1", f1_state, None, lambda: F1(thresholds=0.0, device="cpu"),
             f1_data),
            ("auc", auc_state, torch.sigmoid,
             lambda: AUC(num_thresholds=32, device="cpu"), auc_data)):
        trainer = Trainer(_load(_Linear(act), state), loss=_mse,
                          optimizer=lambda named: torch.optim.SGD(
                              [p for _, p in named], lr=0.0),
                          mesh=mesh, metrics={key: metric()})
        out[key] = trainer.evaluate(batches, verbose=False)[key]
    return out


def quantized_tp(n, state, x, variables):
    """An int8 encoder layer placed by shard_quantized over ``model``: the
    forward, and the dict form's scale specs."""
    from chambers_tpu_torch.layers.transformer import EncoderLayer
    from chambers_tpu_torch.parallel import shard_quantized
    from chambers_tpu_torch.parallel.sharding import P
    from chambers_tpu_torch.quantization import load_quantized_state_dict

    model = min(4, n)
    mesh = _mesh({"data": n // model, "model": model})
    rules = [
        (r"w_(query|key|value)$", P(None, "model", None)),
        (r"b_(query|key|value)$", P("model", None, None)),
        (r"w_projection$", P("model", None, None)),
        (r"dense1/kernel$", P(None, "model")),
        (r"dense1/bias$", P("model")),
        (r"dense2/kernel$", P("model", None)),
    ]
    layer = load_quantized_state_dict(EncoderLayer(
        32, 4, 64, attention_dropout_rate=0.0, dense_dropout_rate=0.0,
        pre_norm=True, device="cpu"), {k: _t(v) for k, v in state.items()})
    layer.eval()
    with torch.no_grad():
        single = layer(_t(x))
    shard_quantized(layer, mesh, rules)
    with torch.no_grad():
        out = _sharded_forward(layer, mesh, x)
    placed = shard_quantized(variables, mesh, rules)
    specs = {
        "w_query_scale": placed["quant"]["multi_head_attention"][
            "w_query_scale"].placements,
        "w_projection_scale": placed["quant"]["multi_head_attention"][
            "w_projection_scale"].placements,
        "kernel_scale": placed["quant"]["dense1"]["kernel_scale"].placements,
    }
    return {"out": _np(out), "single": _np(single),
            "local_kernel": tuple(layer.dense1.kernel.shape),
            "specs": {k: [getattr(p, "dim", None) for p in v]
                      for k, v in specs.items()}}


def collective_eval(n, q, c, z, y):
    from chambers_tpu_torch.parallel import (
        distributed_pairwise_scores,
        distributed_recall_at_k,
    )

    mesh = _mesh({"data": n})
    scores = distributed_pairwise_scores(q, c, mesh)
    recall = distributed_recall_at_k(z, z, y, y, k=3, mesh=mesh,
                                     remove_top1=True)
    return {"scores": _np(scores), "local": tuple(scores.to_local().shape),
            "recall": float(recall)}


def _dense_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def pipeline_cases(n, stages, x, grad_stages, grad_x, target, dp_stages,
                   dp_x, enc_states, enc_x):
    """test_pipeline_parallel's cases at ``pipe = n`` (and DP x PP)."""
    from torch.func import functional_call

    from chambers_tpu_torch.layers.transformer import EncoderLayer
    from chambers_tpu_torch.parallel import (
        group_layers_into_stages,
        pipeline_apply,
        shard_pipeline_params,
        stack_pipeline_stages,
    )
    from chambers_tpu_torch.parallel.distributed import axis_index

    def stack(params):
        return stack_pipeline_stages(
            [{k: _t(v) for k, v in p.items()} for p in params])

    out = {}
    pipe = _mesh({"pipe": n})
    for m in (n, 1, 2 * n):
        out[f"forward_{m}"] = _np(pipeline_apply(
            _dense_stage, stack(stages), _t(x), mesh=pipe,
            n_microbatches=m))
    # each rank holding only its stage, as DTensor shards
    sharded = shard_pipeline_params(stack(stages), pipe)
    out["sharded_local"] = tuple(sharded["w"].to_local().shape)
    out["sharded_forward"] = _np(pipeline_apply(
        _dense_stage, sharded, _t(x), mesh=pipe, n_microbatches=n))
    if n % 2 == 0:
        out["dp_pp"] = _np(pipeline_apply(
            _dense_stage, stack(dp_stages), _t(dp_x),
            mesh=_mesh({"data": 2, "pipe": n // 2}), n_microbatches=2,
            batch_axis="data"))
    for remat in (False, True):
        stacked = stack(grad_stages)
        for v in stacked.values():
            v.requires_grad_(True)
        xg = _t(grad_x).requires_grad_(True)
        y = pipeline_apply(_dense_stage, stacked, xg, mesh=pipe,
                           n_microbatches=4, remat=remat)
        loss = torch.mean((y - _t(target)) ** 2)
        loss.backward()
        stage = axis_index(pipe, "pipe")
        out[f"grads_{remat}"] = {
            "loss": loss.item(), "stage": stage, "x": _np(xg.grad),
            **{k: _np(v.grad[stage]) for k, v in stacked.items()}}
    layer = EncoderLayer(16, 2, 32, attention_dropout_rate=0.0,
                         dense_dropout_rate=0.0, pre_norm=True, device="cpu")
    stacked = group_layers_into_stages(
        [{k: _t(v) for k, v in s.items()} for s in enc_states], n)

    def stage_fn(params, h):
        for i in range(next(iter(params.values())).shape[0]):
            h = functional_call(layer, {k: v[i] for k, v in params.items()},
                                (h,), {"deterministic": True})
        return h

    out["encoder"] = _np(pipeline_apply(stage_fn, stacked, _t(enc_x),
                                        mesh=pipe, n_microbatches=2))
    try:
        pipeline_apply(_dense_stage, stack(stages), torch.zeros(6, 16),
                       mesh=pipe, n_microbatches=4)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    try:
        pipeline_apply(_dense_stage, stack(stages * 2), _t(x), mesh=pipe,
                       n_microbatches=1)
        out["stages"] = None
    except ValueError as e:
        out["stages"] = str(e)
    return out


def ep_cases(n, mlp, mlp_x, dp, dp_x, vit, vit_x, top2, top2_x, dec,
             dec_x, dec_mem):
    """tests/layers/test_moe.py's five expert-parallel cases, with the
    collectives counted: tokens cross ranks by all_to_all, expert banks
    never."""
    import torch.distributed as dist

    from chambers_tpu_torch.layers.moe import MoEDecoderLayer, MoEMLP
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )
    from chambers_tpu_torch.parallel import (
        make_param_shardings,
        moe_expert_parallel_rules,
        shard_params,
    )

    rules = moe_expert_parallel_rules("expert")
    sent = []
    originals = {name: getattr(dist, name) for name in (
        "all_to_all_single", "all_gather_into_tensor", "all_reduce",
        "all_gather", "broadcast")}

    def spy(name):
        def call(*args, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            sent.append((name, tuple(tensors[-1].shape) if tensors else ()))
            return originals[name](*args, **kwargs)
        return call

    out = {}
    ep = _mesh({"expert": n})
    with torch.no_grad():
        m = _load(MoEMLP(8, 16, 8, capacity_factor=2.0, device="cpu"), mlp)
        specs = make_param_shardings(m, ep, rules)
        out["specs"] = (tuple(specs["w1"].spec), tuple(specs["w_router"].spec))
        shard_params(m, ep, rules)
        for name in originals:
            setattr(dist, name, spy(name))
        try:
            out["mlp"] = _np(m(_t(mlp_x)))
        finally:
            for name, fn in originals.items():
                setattr(dist, name, fn)
        out["collectives"] = sent
        out["bank_local"] = tuple(m.w1.shape)

        mesh = _mesh({"data": 2, "expert": n // 2})
        m = shard_params(_load(MoEMLP(8, 8, 4, capacity_factor=2.0,
                                      device="cpu"), dp), mesh, rules)
        out["dp"] = _np(_sharded_forward(m, mesh, dp_x))

        v = _load(VisionTransformer(
            patch_size=8, patch_dim=16, n_encoder_layers=2, n_heads=2,
            ff_dim=32, dropout_rate=0.0, image_size=(16, 16),
            include_top=False, pooling="cls", moe_every_n=2, moe_n_experts=8,
            device="cpu"), vit).eval()
        shard_params(v, ep, rules)
        out["vit"] = _np(v(_t(vit_x)))

        m = shard_params(_load(MoEMLP(8, 16, 8, n_selected_experts=2,
                                      capacity_factor=2.0, device="cpu"),
                               top2), ep, rules)
        out["top2"] = _np(m(_t(top2_x)))

        layer = _load(MoEDecoderLayer(
            16, 2, 32, n_experts=8, n_selected_experts=2, capacity_factor=2.0,
            pre_norm=True, attention_dropout_rate=0.0,
            dense_dropout_rate=0.0, device="cpu"), dec).eval()
        shard_params(layer, ep, rules)
        out["decoder"] = _np(layer([_t(dec_x), _t(dec_mem)]))
    return out


def tail_batch(n, state, x, y):
    """Array-form fit and evaluate whose last batch does not divide over
    ``data``: the padded tail counts exactly as without a mesh."""
    from chambers_tpu_torch.models import Model

    runs = {}
    for key, mesh in (("ref", None), ("mesh", _mesh({"data": n}))):
        model = Model(_load(_Net(), state))
        model.compile("adam", _mse, mesh=mesh)
        history = model.fit(x, y, batch_size=8, epochs=2, shuffle=False,
                            verbose=False)
        runs[key] = {"history": [h["loss"] for h in history],
                     "evaluate": model.evaluate(x, y, batch_size=8,
                                                verbose=False),
                     "predict": model.predict(x, batch_size=8),
                     "params": _whole(model.module)}
    return runs


def fsdp_rule_cases(n):
    """tests/test_fsdp.py's rule generation: the specs fsdp_rules picks."""
    from chambers_tpu_torch.parallel import (
        VIT_TENSOR_PARALLEL_RULES,
        fsdp_rules,
        make_param_shardings,
        shard_params,
    )
    from chambers_tpu_torch.parallel.sharding import P

    def specs(params, mesh, **kwargs):
        rules = fsdp_rules(params, mesh, **kwargs)
        shardings = make_param_shardings(params, mesh, rules)
        return {k: tuple(v.spec) for k, v in _flat(shardings).items()}

    z = np.zeros
    out = {}
    dp = _mesh({"data": n})
    out["largest"] = specs({"w": z((16, 64)), "tall": z((128, 24))}, dp,
                           min_weight_size=1)
    out["small"] = specs({"bias": z(64), "odd": z((7, 9))}, dp,
                         min_weight_size=128)
    tp = _mesh({"data": n // 2, "model": 2})
    out["tp"] = specs({"block": {
        "dense1": {"kernel": z((32, 64)), "bias": z(64)},
        "dense2": {"kernel": z((64, 32))},
        "multi_head_attention": {"w_query": z((32, 4, 8))}}}, tp,
        axis="data", base_rules=VIT_TENSOR_PARALLEL_RULES, min_weight_size=1)
    joint = _mesh({"replica": 2, "fsdp": n // 2})
    params = {"w": z((64, 16), np.float32)}
    out["joint"] = specs(params, joint, axis=("replica", "fsdp"),
                         min_weight_size=1)
    rules = fsdp_rules(params, joint, axis=("replica", "fsdp"),
                       min_weight_size=1)
    out["joint_local"] = tuple(
        shard_params(params, joint, rules)["w"].to_local().shape)
    try:
        fsdp_rules({"w": z((8, 8))}, dp, axis="fsdp")
        out["unknown"] = None
    except ValueError as e:
        out["unknown"] = str(e)
    out["claimed"] = specs({"w": z((8, 64))}, dp,
                           base_rules=[(r"w$", P("data", None))],
                           min_weight_size=1)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def dropout_and_batchnorm(n, vit_state, images, bn_state, x):
    """Under a mesh each rank draws the global batch's dropout masks and
    keeps its rows (and, tensor-parallel, its heads), and BatchNorm's batch
    statistics are the global batch's: a ViT step with dropout on and a
    ConvBN step in train mode equal their runs without a mesh."""
    from chambers_tpu_torch.layers.convolution import ConvBN
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )
    from chambers_tpu_torch.parallel import (
        VIT_TENSOR_PARALLEL_RULES,
        shard_params,
    )
    from chambers_tpu_torch.parallel.sharding import reduce_gradients

    out = {}
    for key, mesh in (("ref", None),
                      ("mesh", _mesh({"data": n // 2, "model": 2}))):
        vit = _load(VisionTransformer(
            patch_size=8, patch_dim=32, n_encoder_layers=2, n_heads=4,
            ff_dim=64, dropout_rate=0.1, image_size=(16, 16),
            include_top=False, pooling="cls", device="cpu"), vit_state)
        generator = torch.Generator().manual_seed(7)
        kwargs = dict(deterministic=False, generator=generator)
        if mesh is None:
            z = vit(_t(images), **kwargs)
        else:
            shard_params(vit, mesh, VIT_TENSOR_PARALLEL_RULES)
            z = _sharded_forward(vit, mesh, images, **kwargs)
        (z ** 2).mean().backward()
        if mesh is not None:
            reduce_gradients(vit)
        out[f"dropout_{key}"] = {"z": _np(z), "grads": _whole_grads(vit)}

        dp = None if mesh is None else _mesh({"data": n})
        net = _load(ConvBN(3, 8, 3, pad=1, device="cpu"), bn_state)
        if dp is None:
            y = net(_t(x), train=True)
        else:
            shard_params(net, dp)
            y = _sharded_forward(net, dp, x, train=True)
        (y ** 2).mean().backward()
        if dp is not None:
            reduce_gradients(net)
        out[f"batchnorm_{key}"] = {
            "y": _np(y), "grads": _whole_grads(net),
            "running": {k: _np(v) for k, v in net.named_buffers()}}
    return out


def _seq2seq(state):
    from chambers_tpu_torch.models import Seq2SeqTransformer

    return _load(Seq2SeqTransformer(24, 24, 32, 4, 64, 2, 2,
                                    dropout_rate=0.0, device="cpu"), state)


def _replicated(module):
    """This rank's copy of every parameter its placement replicates."""
    return {n: _np(p) for n, p in module.named_parameters()
            if not p.sharding.axes()}


def clipped_mesh(n, state, batches, clip):
    """Trainer(mesh=) with clipping: 3 SGD steps of a seq2seq model placed
    by the seq2seq TP rules and by fsdp_rules, with ``clipnorm`` and with
    ``global_clipnorm``: the whole parameters and this rank's replicated
    ones."""
    from chambers_tpu_torch.optimizers import SGDW
    from chambers_tpu_torch.parallel import (
        SEQ2SEQ_TENSOR_PARALLEL_RULES,
        fsdp_rules,
    )
    from chambers_tpu_torch.training import Trainer

    out = {}
    for kind in ("tp", "fsdp"):
        for mode, limit in clip.items():
            model = _seq2seq(state)
            if kind == "tp":
                mesh = _mesh({"data": n // 2, "model": 2})
                rules = SEQ2SEQ_TENSOR_PARALLEL_RULES
            else:
                mesh = _mesh({"data": n})
                rules = fsdp_rules(model, mesh, min_weight_size=512)
            trainer = Trainer(
                model, loss=_mse, mesh=mesh, param_sharding_rules=rules,
                optimizer=lambda named: SGDW(
                    named, weight_decay=0.0, learning_rate=0.05,
                    momentum=0.9, **{mode: limit}))
            trainer.fit(batches, epochs=1, verbose=False)
            out[f"{kind}-{mode}"] = {
                "params": _whole(model), "replicated": _replicated(model),
                "sharded": sorted(n for n, p in model.named_parameters()
                                  if p.sharding.axes())}
    return out


def _loss_recorder():
    """A callback that appends every step's loss to the list returned with
    it."""
    from chambers_tpu_torch.callbacks import Callback

    losses = []

    class Record(Callback):
        def on_train_batch_end(self, batch, logs=None):
            losses.append(float(logs["loss"]))

    return Record(), losses


def _flat_shapes(tree, prefix=""):
    """``{path: shape}`` of every tensor in a nested checkpoint object."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tuple(tree.shape)}
    out = {}
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    for k, v in items:
        out.update(_flat_shapes(v, f"{prefix}/{k}"))
    return out


def checkpoint_mesh(n, state, batches):
    """A checkpoint under the seq2seq TP rules: 4 uninterrupted SGDW steps
    (momentum 0.9: a trace a parameter, sharded as it is; Adam's first
    directions would turn float noise in the key biases' zero gradients
    into whole steps); 2 steps saved by CheckpointCallback and resumed by
    a fresh Trainer for steps 3-4; the checkpoint file against a meshless
    run's; a meshless Trainer resuming the TP checkpoint."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from chambers_tpu_torch.optimizers import SGDW
    from chambers_tpu_torch.parallel import SEQ2SEQ_TENSOR_PARALLEL_RULES
    from chambers_tpu_torch.training import Trainer
    from chambers_tpu_torch.training.checkpoint import CheckpointCallback

    box = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    root = box[0]

    def run(mesh, data, directory=None, restore=None):
        model = _seq2seq(state)
        trainer = Trainer(
            model, loss=_mse, mesh=mesh,
            param_sharding_rules=SEQ2SEQ_TENSOR_PARALLEL_RULES if mesh
            else None,
            optimizer=lambda named: SGDW(named, weight_decay=1e-4,
                                         learning_rate=0.05, momentum=0.9))
        if restore is not None:
            assert CheckpointCallback(restore, trainer).restore_into(trainer)
        record, losses = _loss_recorder()
        callbacks = [record]
        if directory is not None:
            callbacks.append(CheckpointCallback(directory, trainer))
        trainer.fit(data, epochs=1, verbose=False, callbacks=callbacks)
        return {"losses": losses, "params": _whole(model),
                "step": trainer.step}

    def tp():
        return _mesh({"data": n // 2, "model": 2})

    out = {"whole": run(tp(), batches)}
    tp_dir = os.path.join(root, "tp")
    out["saved"] = run(tp(), batches[:2], tp_dir)
    out["resumed"] = run(tp(), batches[2:], restore=tp_dir)
    plain_dir = os.path.join(root, f"plain{dist.get_rank()}")
    run(None, batches[:2], plain_dir)
    load = lambda d: torch.load(os.path.join(d, "2.pt"), weights_only=False)
    tp_file, plain_file = load(tp_dir), load(plain_dir)
    out["files"] = {"tp": _flat_shapes(tp_file),
                    "plain": _flat_shapes(plain_file),
                    "tp_params": {k: _np(v) for k, v in
                                  tp_file["params"].items()},
                    "plain_params": {k: _np(v) for k, v in
                                     plain_file["params"].items()}}
    out["meshless_resumed"] = run(None, batches[2:], restore=tp_dir)
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _flat_values(tree, prefix=""):
    """``{path: numpy array}`` of every tensor in a nested object."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    out = {}
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    for k, v in items:
        out.update(_flat_values(v, f"{prefix}/{k}"))
    return out


def export_mesh(n, state, batches):
    """Weight exports and loads under a mesh, with the seq2seq TP rules and
    with fsdp_rules: 2 AdamW steps with EMA, then the callbacks' facade's
    ``save_weights`` and ``export``, ``Model.save_weights`` and
    ``ema_variables``, each against what a meshless Trainer holding the
    same (gathered) train state writes; and the ``save_weights`` file
    loaded back into a freshly placed module by ``Model.load_weights``,
    its parameters and next forward against the meshless twin's."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from chambers_tpu_torch.models import Model
    from chambers_tpu_torch.optimizers import AdamW
    from chambers_tpu_torch.parallel import (
        SEQ2SEQ_TENSOR_PARALLEL_RULES,
        fsdp_rules,
    )
    from chambers_tpu_torch.parallel.sharding import shard_params
    from chambers_tpu_torch.training import Trainer
    from chambers_tpu_torch.training.trainer import _CallbackModel

    box = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    root, rank = box[0], dist.get_rank()

    def trainer_for(model, mesh, rules):
        return Trainer(model, loss=_mse, mesh=mesh, ema_decay=0.9,
                       param_sharding_rules=rules,
                       optimizer=lambda named: AdamW(
                           named, weight_decay=1e-4, learning_rate=1e-3))

    def write(trainer, model, stem):
        facade = _CallbackModel(trainer)
        facade.save_weights(stem + ".msgpack")
        facade.export(stem + "_export")
        Model(model).save_weights(stem + "_model.msgpack")
        return {"ema": {k: _np(v) for k, v in
                        trainer.ema_variables.items()}}

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    def opt_state(stem):
        return _flat_values(torch.load(
            os.path.join(stem + "_export", "opt_state.pt"),
            weights_only=False))

    x = batches[0][0]
    out = {}
    for kind in ("tp", "fsdp"):
        def placement():
            model = _seq2seq(state)
            if kind == "tp":
                return (model, _mesh({"data": n // 2, "model": 2}),
                        SEQ2SEQ_TENSOR_PARALLEL_RULES)
            mesh = _mesh({"data": n})
            return model, mesh, fsdp_rules(model, mesh, min_weight_size=512)

        model, mesh, rules = placement()
        trainer = trainer_for(model, mesh, rules)
        trainer.fit(batches, epochs=1, verbose=False)
        stem = os.path.join(root, kind)
        got = write(trainer, model, stem)
        # the meshless twin: the same train state, gathered
        twin = _seq2seq(state)
        twin_trainer = trainer_for(twin, None, None)
        twin_trainer.state = trainer.global_state()
        plain = os.path.join(root, f"{kind}_plain{rank}")
        want = write(twin_trainer, twin, plain)
        dist.barrier()
        files = {name: read(stem + suffix) == read(plain + suffix)
                 for name, suffix in (
                     ("save_weights", ".msgpack"),
                     ("export", "_export/model.msgpack"),
                     ("model_save_weights", "_model.msgpack"))}
        got_opt, want_opt = opt_state(stem), opt_state(plain)
        whole_shapes = {n: tuple(p.shape) for n, p in twin.named_parameters()}
        # a fresh module placed as the first one, the file loaded into it
        placed, mesh, rules = placement()
        with torch.no_grad():
            for p in placed.parameters():
                p.zero_()
        shard_params(placed, mesh, rules)
        Model(placed).load_weights(stem + ".msgpack")
        out[kind] = {
            "files": files,
            "opt_keys": (sorted(got_opt) == sorted(want_opt)),
            "opt_equal": all(np.array_equal(got_opt[k], want_opt[k])
                             for k in want_opt if k in got_opt),
            "opt_moment_shapes": sorted(
                v.shape for k, v in got_opt.items() if k.endswith("/mu")),
            "whole_shapes": sorted(whole_shapes.values()),
            "ema": got["ema"], "ema_want": want["ema"],
            "sharded": sorted(n for n, p in placed.named_parameters()
                              if p.sharding.axes()),
            "loaded": _whole(placed), "twin": _whole(twin),
            "forward": Model(placed).predict(x, mesh=mesh),
            "forward_want": Model(twin).predict(x)}
    dist.barrier()
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    return out


CHECKS = {f.__name__: f for f in (
    dropout_and_batchnorm,
    fsdp_rule_cases,
    mesh_api, dp_grad, tp_mha, dp_tp_vit, pp_step, ep_dp_step,
    dp_tp_ep_step, context_parallel, decode, fsdp_step, lora_freeze,
    nondivisible, wide_dp_tp, trainer_dp, quantized_tp, collective_eval,
    pipeline_cases, ep_cases, tail_batch, clipped_mesh, checkpoint_mesh,
    export_mesh)}
