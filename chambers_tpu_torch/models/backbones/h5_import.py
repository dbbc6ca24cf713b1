"""Checkpoint importers for the ViT and DeiT backbones (port of
``chambers_tpu/models/backbones/h5_import.py``).

Two sources are supported:

1. **Keras legacy ``.h5`` weight files**, the format of the chjort/chambers
   released ViT weights. ``load_keras_h5_weights`` parses the legacy HDF5
   layout (top-level ``layer_names`` attr, per-layer ``weight_names``) into
   a flat ``{name: array}`` dict; ``load_vit_h5_weights`` maps that into
   the JAX package's variable tree. The files keep the per-head ``(d,
   n_heads, head_dim)`` layout, which the port's attention also keeps, so
   MHA tensors copy through without reshaping.

2. **PyTorch ViT state dicts** with HuggingFace ``transformers`` or timm
   naming: ``[out, in]`` linears transpose into ``[in, out]``; fused or
   split q/k/v projections reshape head-major into ``(d, n, h)``.

Both work on the nested numpy dicts of ``convert.jax_variables(model)``
(the template the JAX package takes from Flax's init) and return new ones,
which ``convert.load_jax_variables`` installs; :func:`import_h5` does both
for the presets. ``h5py`` is imported only when a file is read.
"""

from __future__ import annotations

import copy
import re
from typing import Dict

import numpy as np

from chambers_tpu_torch.models.backbones.convert import (
    jax_variables,
    load_jax_variables,
)


def import_h5(model, path, loader, *args):
    """Load the weights file at ``path`` into ``model`` in place. A ``.h5``
    file goes through ``loader(path, jax_variables(model), *args)``, which
    maps it onto the model's variables; any other file is read as a
    ``Model.save_weights`` msgpack (Flax's format, of either package).
    Either way the variables then replace the model's parameters and
    statistics."""
    if not str(path).endswith(".h5"):
        from chambers_tpu_torch.utils import msgpack_io

        return load_jax_variables(model, msgpack_io.load(str(path)))
    return load_jax_variables(model, loader(str(path), jax_variables(model),
                                            *args))


def load_keras_h5_weights(path: str) -> Dict[str, np.ndarray]:
    """Parse a legacy Keras weights-only ``.h5`` into ``{name: array}``.

    Names are the full Keras weight names (e.g.
    ``encoder/encoder_layer_3/multi_head_attention_3/w_query:0``).
    """
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        group = f["model_weights"] if "model_weights" in f else f
        layer_names = [
            n.decode() if isinstance(n, bytes) else n
            for n in group.attrs["layer_names"]
        ]
        for layer_name in layer_names:
            g = group[layer_name]
            weight_names = [
                n.decode() if isinstance(n, bytes) else n
                for n in g.attrs.get("weight_names", [])
            ]
            for weight_name in weight_names:
                out[weight_name] = np.asarray(g[weight_name])
    return out


_MHA_PARAMS = (
    "w_query", "b_query", "w_value", "b_value",
    "w_key", "b_key", "w_projection", "b_projection",
)


def load_vit_h5_weights(path: str, variables):
    """Import reference ViT/DeiT ``.h5`` weights into a Flax variable tree.

    :param variables: the model's variables, ``jax_variables(model)``
        (the expected tree and shapes; every imported tensor is
        shape-checked). Returns ``{"params": ...}``; the input is not
        changed.
    """
    weights = load_keras_h5_weights(path)
    params = copy.deepcopy(variables["params"])

    def assign(tree_path, value):
        node = params
        for k in tree_path[:-1]:
            node = node[k]
        leaf = tree_path[-1]
        if node[leaf].shape != value.shape:
            raise ValueError(
                f"Shape mismatch for {'/'.join(tree_path)}: "
                f"expected {node[leaf].shape}, got {value.shape}"
            )
        node[leaf] = value.astype(np.asarray(node[leaf]).dtype)

    # accumulate per-encoder-layer norm (gamma, beta) and dense (kernel, bias)
    # pairs in file order; order disambiguates norm1 vs norm2, shape
    # disambiguates dense1 vs dense2.
    enc_layer_norms: Dict[int, list] = {}
    enc_layer_denses: Dict[int, list] = {}
    encoder_final_norm = {}

    for name, value in weights.items():
        base = name.split(":")[0]
        parts = base.split("/")

        m = re.search(r"encoder_layer(?:_(\d+))?/", base)
        if m:
            idx = int(m.group(1) or 0)
            layer_key = f"layers_{idx}"
            leaf = parts[-1]
            if leaf in _MHA_PARAMS:
                assign(("encoder", layer_key, "multi_head_attention", leaf), value)
            elif leaf in ("gamma", "beta"):
                enc_layer_norms.setdefault(idx, []).append((leaf, value))
            elif leaf in ("kernel", "bias"):
                enc_layer_denses.setdefault(idx, []).append((leaf, value))
            continue

        if "encoder" in base and parts[-1] in ("gamma", "beta"):
            encoder_final_norm[parts[-1]] = value
        elif "add_cls_token" in base:
            assign(("add_cls_token", "embeddings"), value)
        elif "add_dist_token" in base:
            assign(("add_dist_token", "embeddings"), value)
        elif "pos_embedding" in base:
            assign(("pos_embedding", "embeddings"), value)
        elif "patch_embeddings" in base or "/embedding/" in base or parts[0] == "embedding":
            if value.ndim == 4:
                assign(("patch_embeddings", "kernel"), value)
            else:
                assign(("patch_embeddings", "bias"), value)
        elif "predictions_dist" in base:
            assign(("predictions_dist", parts[-1]), value)
        elif "predictions" in base:
            assign(("predictions", parts[-1]), value)
        elif "feature" in base:
            assign(("feature", parts[-1]), value)

    for idx, pairs in enc_layer_norms.items():
        gammas = [v for k, v in pairs if k == "gamma"]
        betas = [v for k, v in pairs if k == "beta"]
        for norm_name, g, b in zip(("norm1", "norm2"), gammas, betas):
            assign(("encoder", f"layers_{idx}", norm_name, "scale"), g)
            assign(("encoder", f"layers_{idx}", norm_name, "bias"), b)

    for idx, pairs in enc_layer_denses.items():
        kernels = [v for k, v in pairs if k == "kernel"]
        biases = [v for k, v in pairs if k == "bias"]
        embed_dim = params["encoder"][f"layers_{idx}"]["dense2"]["kernel"].shape[1]
        for kernel, bias in zip(kernels, biases):
            dense = "dense1" if kernel.shape[1] != embed_dim else "dense2"
            assign(("encoder", f"layers_{idx}", dense, "kernel"), kernel)
            assign(("encoder", f"layers_{idx}", dense, "bias"), bias)

    if encoder_final_norm:
        assign(("encoder", "norm_layer", "scale"), encoder_final_norm["gamma"])
        assign(("encoder", "norm_layer", "bias"), encoder_final_norm["beta"])

    return {"params": params}


def _to_per_head(w, b, num_heads):
    """torch ``[out=n*h, in=d]`` linear -> ``(d, n, h)`` weight, ``(n, 1, h)`` bias."""
    out_dim, in_dim = w.shape
    h = out_dim // num_heads
    w_ = w.T.reshape(in_dim, num_heads, h)
    b_ = b.reshape(num_heads, 1, h)
    return w_, b_


def load_torch_vit_weights(state_dict, variables, num_heads: int, prefix: str = ""):
    """Import a PyTorch ViT state dict (HF ``transformers`` or timm naming).

    Maps into the Chambers per-head layout exactly as the reference's manual
    parity test does for timm (manual_test_vit_weights.py:27-76). ``heads``
    and MLP linears transpose ``[out, in] -> [in, out]``.
    """
    sd = {
        k[len(prefix):]: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
        for k, v in state_dict.items()
        if k.startswith(prefix)
    }
    params = copy.deepcopy(variables["params"])

    def assign(tree_path, value):
        node = params
        for k in tree_path[:-1]:
            node = node[k]
        leaf = tree_path[-1]
        expected = np.asarray(node[leaf]).shape
        if expected != value.shape:
            raise ValueError(
                f"Shape mismatch for {'/'.join(tree_path)}: "
                f"expected {expected}, got {value.shape}"
            )
        node[leaf] = value.astype(np.asarray(node[leaf]).dtype)

    def get(*names):
        for n in names:
            if n in sd:
                return sd[n]
        raise KeyError(f"None of {names} found in state dict")

    # --- embeddings ---
    assign(
        ("patch_embeddings", "kernel"),
        get(
            "embeddings.patch_embeddings.projection.weight",
            "patch_embed.proj.weight",
        ).transpose(2, 3, 1, 0),
    )
    assign(
        ("patch_embeddings", "bias"),
        get("embeddings.patch_embeddings.projection.bias", "patch_embed.proj.bias"),
    )
    assign(
        ("add_cls_token", "embeddings"),
        get("embeddings.cls_token", "cls_token").reshape(1, -1),
    )
    if "add_dist_token" in params:
        assign(
            ("add_dist_token", "embeddings"),
            get("embeddings.distillation_token", "dist_token").reshape(1, -1),
        )
    assign(
        ("pos_embedding", "embeddings"),
        get("embeddings.position_embeddings", "pos_embed")[0],
    )

    # --- encoder layers ---
    n_layers = sum(1 for k in params["encoder"] if k.startswith("layers_"))
    for i in range(n_layers):
        hf = f"encoder.layer.{i}."
        tm = f"blocks.{i}."
        tgt = ("encoder", f"layers_{i}")

        if hf + "attention.attention.query.weight" in sd or hf + "attention.attention.q_proj.weight" in sd:
            wq, bq = _to_per_head(
                get(hf + "attention.attention.query.weight",
                    hf + "attention.attention.q_proj.weight"),
                get(hf + "attention.attention.query.bias",
                    hf + "attention.attention.q_proj.bias"),
                num_heads,
            )
            wk, bk = _to_per_head(
                get(hf + "attention.attention.key.weight",
                    hf + "attention.attention.k_proj.weight"),
                get(hf + "attention.attention.key.bias",
                    hf + "attention.attention.k_proj.bias"),
                num_heads,
            )
            wv, bv = _to_per_head(
                get(hf + "attention.attention.value.weight",
                    hf + "attention.attention.v_proj.weight"),
                get(hf + "attention.attention.value.bias",
                    hf + "attention.attention.v_proj.bias"),
                num_heads,
            )
            wo = get(hf + "attention.output.dense.weight")
            bo = get(hf + "attention.output.dense.bias")
            w1 = get(hf + "intermediate.dense.weight")
            b1 = get(hf + "intermediate.dense.bias")
            w2 = get(hf + "output.dense.weight")
            b2 = get(hf + "output.dense.bias")
            g1 = get(hf + "layernorm_before.weight")
            be1 = get(hf + "layernorm_before.bias")
            g2 = get(hf + "layernorm_after.weight")
            be2 = get(hf + "layernorm_after.bias")
        else:  # timm: fused qkv
            qkv_w = get(tm + "attn.qkv.weight")  # [3*d, d]
            qkv_b = get(tm + "attn.qkv.bias")
            d = qkv_w.shape[1]
            wq, bq = _to_per_head(qkv_w[:d], qkv_b[:d], num_heads)
            wk, bk = _to_per_head(qkv_w[d: 2 * d], qkv_b[d: 2 * d], num_heads)
            wv, bv = _to_per_head(qkv_w[2 * d:], qkv_b[2 * d:], num_heads)
            wo = get(tm + "attn.proj.weight")
            bo = get(tm + "attn.proj.bias")
            w1 = get(tm + "mlp.fc1.weight")
            b1 = get(tm + "mlp.fc1.bias")
            w2 = get(tm + "mlp.fc2.weight")
            b2 = get(tm + "mlp.fc2.bias")
            g1 = get(tm + "norm1.weight")
            be1 = get(tm + "norm1.bias")
            g2 = get(tm + "norm2.weight")
            be2 = get(tm + "norm2.bias")

        mha = tgt + ("multi_head_attention",)
        assign(mha + ("w_query",), wq)
        assign(mha + ("b_query",), bq)
        assign(mha + ("w_key",), wk)
        assign(mha + ("b_key",), bk)
        assign(mha + ("w_value",), wv)
        assign(mha + ("b_value",), bv)
        # torch out-proj: y = att_flat @ W.T with W.T [(n h), d];
        # ours: y[d] = sum_{n,h} att[n,h] * w_projection[n, d, h]
        d_model = wo.shape[0]
        h = wo.shape[1] // num_heads
        assign(
            mha + ("w_projection",),
            wo.T.reshape(num_heads, h, d_model).transpose(0, 2, 1),
        )
        assign(mha + ("b_projection",), bo.reshape(1, -1))

        assign(tgt + ("norm1", "scale"), g1)
        assign(tgt + ("norm1", "bias"), be1)
        assign(tgt + ("norm2", "scale"), g2)
        assign(tgt + ("norm2", "bias"), be2)
        assign(tgt + ("dense1", "kernel"), w1.T)
        assign(tgt + ("dense1", "bias"), b1)
        assign(tgt + ("dense2", "kernel"), w2.T)
        assign(tgt + ("dense2", "bias"), b2)

    # --- final norm ---
    assign(("encoder", "norm_layer", "scale"), get("layernorm.weight", "norm.weight"))
    assign(("encoder", "norm_layer", "bias"), get("layernorm.bias", "norm.bias"))

    # --- heads (optional) ---
    if "predictions" in params and ("classifier.weight" in sd or "head.weight" in sd):
        assign(("predictions", "kernel"), get("classifier.weight", "head.weight").T)
        assign(("predictions", "bias"), get("classifier.bias", "head.bias"))
    if "predictions_dist" in params and (
        "distillation_classifier.weight" in sd or "head_dist.weight" in sd
    ):
        assign(
            ("predictions_dist", "kernel"),
            get("distillation_classifier.weight", "head_dist.weight").T,
        )
        assign(
            ("predictions_dist", "bias"),
            get("distillation_classifier.bias", "head_dist.bias"),
        )
    if "feature" in params and "pooler.dense.weight" in sd:
        assign(("feature", "kernel"), get("pooler.dense.weight").T)
        assign(("feature", "bias"), get("pooler.dense.bias"))

    return {"params": params}
