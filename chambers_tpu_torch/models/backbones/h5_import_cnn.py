"""Keras ``.h5`` weight import for the CNN backbones (port of
``chambers_tpu/models/backbones/h5_import_cnn.py``).

The released SENet weights are legacy Keras h5 files whose layers appear in
construction order. The reference builder and this one construct the
network in the same order, so import is an *order-based stream match*: h5
weights are flattened in (layer, weight) order and consumed against the
model's parameter leaves in construction order, with shape checking at
every step. The model side is ``convert.jax_variables(model)``, whose
nested dicts keep the port's registration order, Flax's creation order.

One structural difference is handled explicitly: the reference implements
grouped convolution as ``groups`` separate per-group ``Conv2D`` layers
whose kernels are ``[kh, kw, cin/g, cout/g]``; this build's single grouped
conv expects ``[kh, kw, cin/g, cout]``, so the importer concatenates ``g``
consecutive per-group kernels along the output-channel axis.

BN-Inception's auto-named conv/BN graph imports by creation order
(``load_convbn_h5_weights``) and keras-applications ResNeXt files by name
(``load_resnext_h5_weights``). Unlike the JAX importer, the ResNeXt one
loads the ``predictions`` head into ``QuantDense_0``.
"""

from __future__ import annotations

import copy
import re
from typing import List, Tuple

import numpy as np

from chambers_tpu_torch.models.backbones.h5_import import (
    load_keras_h5_weights,
)


def _natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


def _copy_variables(variables):
    """Deep copy of the variables dict the importers mutate in place."""
    return copy.deepcopy(dict(variables))


def _assign_checked(out, tree_path, value):
    """Write ``value`` at ``tree_path``, shape-checked against the leaf."""
    node = out[tree_path[0]]
    for k in tree_path[1:-1]:
        node = node[k]
    expected = np.asarray(node[tree_path[-1]]).shape
    if tuple(expected) != tuple(value.shape):
        raise ValueError(
            f"Shape mismatch at {'/'.join(tree_path)}: expected {expected}, "
            f"got {value.shape}"
        )
    node[tree_path[-1]] = value


def _ordered_param_leaves(variables) -> List[Tuple[Tuple[str, ...], tuple]]:
    """Flatten ``variables`` into construction order.

    Flax dicts preserve insertion (creation) order, which for these builders
    mirrors the reference's layer creation order. Within a module, Keras
    emits conv kernel(+bias) then BN gamma/beta/moving_mean/moving_variance —
    leaves are interleaved to match. Caveat: Keras saves *functional-model
    topological* order, which can diverge from creation order in branchy
    blocks; every consume is shape-checked, so a divergence fails loudly
    rather than silently mis-assigning.
    """
    leaves: List[Tuple[Tuple[str, ...], tuple]] = []
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def walk(p_node, s_node, path):
        if not isinstance(p_node, dict):
            leaves.append((("params",) + path, np.asarray(p_node).shape))
            return
        keys = list(p_node.keys())  # insertion order == creation order
        for key in keys:
            child = p_node[key]
            s_child = s_node.get(key, {}) if isinstance(s_node, dict) else {}
            if isinstance(child, dict) and "scale" in child and "bias" in child \
                    and isinstance(s_child, dict) and "mean" in s_child:
                # BatchNorm: gamma, beta, moving_mean, moving_variance
                leaves.append((("params",) + path + (key, "scale"),
                               np.asarray(child["scale"]).shape))
                leaves.append((("params",) + path + (key, "bias"),
                               np.asarray(child["bias"]).shape))
                leaves.append((("batch_stats",) + path + (key, "mean"),
                               np.asarray(s_child["mean"]).shape))
                leaves.append((("batch_stats",) + path + (key, "var"),
                               np.asarray(s_child["var"]).shape))
            elif isinstance(child, dict):
                if "kernel" in child:
                    leaves.append((("params",) + path + (key, "kernel"),
                                   np.asarray(child["kernel"]).shape))
                    if "bias" in child:
                        leaves.append((("params",) + path + (key, "bias"),
                                       np.asarray(child["bias"]).shape))
                    extra = [k for k in child
                             if k not in ("kernel", "bias")
                             and isinstance(child[k], dict)]
                    for k in extra:
                        walk(child[k], s_child.get(k, {}), path + (key, k))
                else:
                    walk(child, s_child, path + (key,))
            else:
                leaves.append((("params",) + path + (key,),
                               np.asarray(child).shape))

    walk(params, stats, ())
    return leaves


def _flat_h5_weights(path: str) -> List[np.ndarray]:
    weights = load_keras_h5_weights(path)
    return list(weights.values())  # h5py attrs preserve write order


def load_cnn_h5_weights(path: str, variables):
    """Import legacy Keras CNN weights by ordered stream matching."""
    stream = _flat_h5_weights(path)
    leaves = _ordered_param_leaves(variables)
    out = _copy_variables(variables)

    def assign(tree_path, value):
        _assign_checked(out, tree_path, value)

    pos = 0
    for tree_path, shape in leaves:
        if pos >= len(stream):
            raise ValueError(
                f"h5 stream exhausted at {'/'.join(tree_path)}; "
                "architecture mismatch."
            )
        w = stream[pos]
        if tuple(w.shape) == tuple(shape):
            assign(tree_path, w)
            pos += 1
            continue
        # grouped conv: concat g consecutive per-group kernels on out axis
        if (len(shape) == 4 and w.ndim == 4
                and w.shape[:3] == tuple(shape[:3])
                and shape[3] % w.shape[3] == 0):
            g = shape[3] // w.shape[3]
            parts = stream[pos: pos + g]
            if len(parts) == g and all(p.shape == w.shape for p in parts):
                assign(tree_path, np.concatenate(parts, axis=-1))
                pos += g
                continue
        raise ValueError(
            f"Shape mismatch at {'/'.join(tree_path)}: expected {shape}, "
            f"h5 provides {w.shape}."
        )

    if pos != len(stream):
        raise ValueError(
            f"{len(stream) - pos} unconsumed h5 weights; architecture "
            "mismatch."
        )
    return out


def load_convbn_h5_weights(path: str, variables):
    """Import an auto-named Keras conv/BN DAG by creation order.

    Keras saves functional DAGs in *depth-sorted* layer order, which
    interleaves parallel branches (an Inception module's 1x1 branch conv can
    land after another branch's). Auto-assigned layer names (``conv2d_N``,
    ``batch_normalization_N``) carry the creation order, which for builders
    that create conv and BN together (every ``_ConvBN``) equals this build's
    module creation order — so convs and BNs are recovered by natural-sorting
    their uids and streamed as paired units, shape-checked at every step.
    Custom-named files fail loudly rather than misassign.
    """
    import h5py

    convs: List[List[np.ndarray]] = []
    bns: List[List[np.ndarray]] = []
    with h5py.File(path, "r") as f:
        group = f["model_weights"] if "model_weights" in f else f
        layer_names = [n.decode() if isinstance(n, bytes) else n
                       for n in group.attrs["layer_names"]]
        for ln in sorted(layer_names, key=_natural_key):
            g = group[ln]
            wnames = [n.decode() if isinstance(n, bytes) else n
                      for n in g.attrs.get("weight_names", [])]
            if not wnames:
                continue
            arrays = [np.asarray(g[n]) for n in wnames]
            leaf = wnames[0].split("/")[-1].split(":")[0]
            if leaf in ("kernel", "depthwise_kernel"):
                convs.append(arrays)
            elif leaf in ("gamma", "beta", "moving_mean", "moving_variance"):
                bns.append(arrays)
            else:
                raise ValueError(
                    f"Unrecognized layer '{ln}' (weights {wnames}) — "
                    "load_convbn_h5_weights handles conv/BN graphs only."
                )

    # -- model side: conv(+bias)(+BN) units in construction order ----------
    leaves = _ordered_param_leaves(variables)
    units = []  # {conv, bias?, bn: [4 paths]}
    i = 0
    while i < len(leaves):
        path_i, shape = leaves[i]
        name = path_i[-2]
        if name.startswith("Conv"):
            unit = {"conv": path_i, "shape": tuple(shape), "bias": None,
                    "bn": None}
            i += 1
            if i < len(leaves) and leaves[i][0][-1] == "bias":
                unit["bias"] = leaves[i][0]
                i += 1
            units.append(unit)
        elif name.startswith("BatchNorm"):
            if not units or units[-1]["bn"] is not None:
                raise ValueError(f"BN {path_i} not preceded by a conv")
            # leaves order per _ordered_param_leaves: scale, bias, mean, var
            units[-1]["bn"] = [leaves[i + off][0] for off in range(4)]
            i += 4
        else:
            raise ValueError(f"Unexpected parameter {path_i} for a conv/BN "
                             "backbone")
    if len(convs) != len(units):
        raise ValueError(
            f"h5 file has {len(convs)} conv layers, model has {len(units)} "
            "— architecture mismatch."
        )
    n_model_bns = sum(1 for u in units if u["bn"] is not None)
    if len(bns) != n_model_bns:
        raise ValueError(
            f"h5 file has {len(bns)} BN layers, model has {n_model_bns} "
            "— architecture mismatch."
        )

    # -- h5 side: pair conv k with BN k (a _ConvBN-style builder creates
    # them together, so any permutation of conv creation order permutes the
    # BN stream identically) -----------------------------------------------
    if len(bns) == len(convs):
        h5_units = list(zip(convs, bns))
        pairing_sound = True
    else:
        # some convs lack BN: pair the BN stream to the model's BN-bearing
        # conv positions — only sound when the streams are in order
        bn_iter = iter(bns)
        h5_units = [(c, next(bn_iter) if u["bn"] is not None else None)
                    for c, u in zip(convs, units)]
        pairing_sound = False

    def signature(conv_arrays):
        return (tuple(conv_arrays[0].shape), len(conv_arrays) > 1)

    # exact stream order (both builders constructed identically) — the fast
    # path every validated fixture takes
    in_order = all(
        signature(h5c)[0] == u["shape"] and signature(h5c)[1] == (u["bias"] is not None)
        for (h5c, _), u in zip(h5_units, units)
    )
    if not in_order:
        if not pairing_sound:
            raise ValueError(
                f"h5 stream order does not match the model and conv/BN "
                f"counts differ ({len(convs)} vs {len(bns)}) — cannot "
                "re-pair a permuted stream without one BN per conv."
            )
        # name-aware signature fallback: the genuine
        # release file's construction order is unknown; re-match units by
        # (kernel shape, has-bias) signature. Units sharing a signature are
        # matched in relative natural-name order — correct whenever the
        # permutation preserves same-shape relative order (true for Keras
        # depth-sorted saves of creation-ordered names); a same-shaped swap
        # with no name evidence is undetectable and documented as a caveat.
        from collections import defaultdict, deque

        by_sig = defaultdict(deque)
        for h5c, h5b in h5_units:
            by_sig[signature(h5c)].append((h5c, h5b))
        reordered = []
        for u in units:
            sig = (u["shape"], u["bias"] is not None)
            if not by_sig[sig]:
                raise ValueError(
                    f"No h5 conv layer left with kernel shape {u['shape']} "
                    f"(bias={u['bias'] is not None}) for {u['conv']} — "
                    "architecture mismatch."
                )
            reordered.append(by_sig[sig].popleft())
        h5_units = reordered

    out = _copy_variables(variables)

    def assign(tree_path, value):
        _assign_checked(out, tree_path, value)

    for u, (h5c, h5b) in zip(units, h5_units):
        assign(u["conv"], h5c[0])
        if u["bias"] is not None:
            if len(h5c) < 2:
                raise ValueError(f"{u['conv']}: model expects a conv bias "
                                 "but the h5 layer has none")
            assign(u["bias"], h5c[1])
        elif len(h5c) > 1:
            raise ValueError(
                f"{u['conv']}: h5 conv layer carries {len(h5c) - 1} extra "
                "weight(s) (a bias?) but the model's conv has no bias "
                "leaf — refusing to drop them silently"
            )
        if u["bn"] is not None:
            if h5b is None:
                raise ValueError(f"{u['conv']}: model expects BN but the "
                                 "h5 stream has none left")
            for path, value in zip(u["bn"], h5b):
                assign(path, value)
    return out


def depthwise_to_grouped_kernel(dw: np.ndarray, groups: int) -> np.ndarray:
    """Keras ResNeXt grouped-conv kernel conversion.

    Keras ``block3`` emulates a grouped conv with
    ``DepthwiseConv2D(depth_multiplier=c)`` followed by a reshape +
    sum-over-within-group-inputs (tf_keras applications/resnet.py block3):
    output channel ``(g, m) = sum_j conv(in[g*c+j], D[:, :, g*c+j, m])``.
    The equivalent ``lax``/Flax grouped-conv kernel ``[kh, kw, c, groups*c]``
    (``feature_group_count=groups``) is ``K[:, :, j, g*c+m] = D[:, :, g*c+j, m]``.
    """
    kh, kw, cin, c = dw.shape
    assert cin % groups == 0 and cin // groups == c, (dw.shape, groups)
    return (dw.reshape(kh, kw, groups, c, c)
            .transpose(0, 1, 3, 2, 4)
            .reshape(kh, kw, c, groups * c))


def load_resnext_h5_weights(path: str, variables, stage_depths, groups=32):
    """Name-based import of Keras-applications ResNeXt ``.h5`` weights.

    The reference loads the keras-team release files through Keras's own
    by-layer loader (reference resnext.py:6-51); their layer names are the
    deterministic ``conv{stage}_block{i}_{j}_{conv,bn}`` scheme, so a
    name-keyed mapping is robust where order-based streaming is not (the
    residual branches interleave in topological save order).
    """
    weights = load_keras_h5_weights(path)
    out = _copy_variables(variables)

    def w(name):
        key = f"{name}:0"
        if key not in weights:
            raise KeyError(f"{key} missing from {path}")
        return weights[key]

    def assign(tree_path, value):
        _assign_checked(out, tree_path, value)

    def conv_bn(flax_prefix, keras_conv, keras_bn, kernel):
        assign(("params",) + flax_prefix + ("Conv_0", "kernel"), kernel)
        assign(("params",) + flax_prefix + ("BatchNorm_0", "scale"),
               w(f"{keras_bn}/gamma"))
        assign(("params",) + flax_prefix + ("BatchNorm_0", "bias"),
               w(f"{keras_bn}/beta"))
        assign(("batch_stats",) + flax_prefix + ("BatchNorm_0", "mean"),
               w(f"{keras_bn}/moving_mean"))
        assign(("batch_stats",) + flax_prefix + ("BatchNorm_0", "var"),
               w(f"{keras_bn}/moving_variance"))

    conv_bn(("_ConvBN_0",), "conv1_conv", "conv1_bn", w("conv1_conv/kernel"))

    k = 0  # global _Block3 index in creation order
    for stage, depth in enumerate(stage_depths):
        for block in range(depth):
            name = f"conv{stage + 2}_block{block + 1}"
            prefix = (f"_Block3_{k}",)
            # creation order: shortcut (block 0 only), then 1/2/3
            idx = 0
            if block == 0:
                conv_bn(prefix + (f"_ConvBN_{idx}",), f"{name}_0_conv",
                        f"{name}_0_bn", w(f"{name}_0_conv/kernel"))
                idx += 1
            conv_bn(prefix + (f"_ConvBN_{idx}",), f"{name}_1_conv",
                    f"{name}_1_bn", w(f"{name}_1_conv/kernel"))
            grouped = depthwise_to_grouped_kernel(
                w(f"{name}_2_conv/depthwise_kernel"), groups)
            conv_bn(prefix + (f"_ConvBN_{idx + 1}",), f"{name}_2_conv",
                    f"{name}_2_bn", grouped)
            conv_bn(prefix + (f"_ConvBN_{idx + 2}",), f"{name}_3_conv",
                    f"{name}_3_bn", w(f"{name}_3_conv/kernel"))
            k += 1

    # the head's Flax name is QuantDense_0; the JAX importer tests for
    # "Dense_0" and so never loads it
    if "QuantDense_0" in out["params"]:
        assign(("params", "QuantDense_0", "kernel"), w("predictions/kernel"))
        assign(("params", "QuantDense_0", "bias"), w("predictions/bias"))
    return out
