"""Post-training int8 quantization for serving (port of
``chambers_tpu/quantization.py``).

The scheme is the JAX package's, value for value:

- **Weights**: symmetric per-output-channel int8, ``scale = max(absmax /
  127, 1e-12)`` over the contraction axes, kept as float32 with those axes
  as size-1 dims. A quantized kernel keeps its shape and its ``state_dict``
  key (only the dtype becomes int8); its scale is the entry
  ``<key>_scale``: ``kernel_scale`` ``[1, N]``, ``w_{query,key,value}_scale``
  ``[1, n, h]``, ``w_projection_scale`` ``[1, d, 1]``, and the MoE expert
  banks' ``w1_scale``/``w2_scale`` ``[E, 1, out]`` (per expert and output
  channel).
- **Activations**: symmetric per-row int8 computed on the fly, absmax over
  the contraction axes of each row.
- **Compute**: ``int8 @ int8 -> int32``, rescaled by ``s_x * s_w`` in
  float32 in the JAX package's order, then cast to the compute dtype.
  Biases, norms, softmax and the patch embedding stay in their dtypes.

Both packages round half to even (``jnp.round``, ``torch.round``) and
divide once, so codes and scales are bit-equal. Every division here is a
tensor over a tensor on the operands' device: on the card a tensor over a
Python scalar is computed as a multiply by the reciprocal, which rounds
twice.

**The contraction.** The JAX package leaves ``int8 @ int8 -> int32`` to XLA;
the port hands it to ``torch._int_mm`` (cuBLASLt on the card), through 2-D
operands for the four layouts the package uses (``...k,kf->...f`` in
:class:`QuantDense`; the stacked ``btd,sdnh->sbnth``, ``btd,dnh->bnth`` and
``bnth,ndh->btd`` in ``layers/attention.py``; one product an expert for
``gecd,edf->gecf`` in ``layers/moe.py``). On the card ``_int_mm``
takes ``m > 16`` rows and ``k``, ``n`` that are multiples of 8, so
:func:`int_mm` pads with zero rows and columns, which changes no sum, and
slices the result; it never falls back to a float product. The weight
operand is derived once, when a model is quantized or loaded
(:func:`gemm_operand`), padded and column-major; the ``state_dict`` keeps
the JAX package's shapes.

What gets quantized: 2-D ``kernel`` entries (:class:`QuantDense`), the
``MultiHeadAttention`` projections ``w_query``, ``w_key``, ``w_value``
``(d, n, h)`` and ``w_projection`` ``(n, d, h)``, and the ``MoEMLP`` expert
banks ``w1`` ``(E, d, F)`` and ``w2`` ``(E, F, d)`` (activations quantized
per dispatched row). The patch embedding's 4-D kernel, biases, norms,
embeddings and the MoE router ``w_router`` stay float.

Use::

    model = ViTB16(dtype=torch.bfloat16, score_dtype=torch.bfloat16)
    model.load_state_dict(fold_imagenet_normalization(model.state_dict()))
    quantize_model(model)          # in place: int8 kernels, float scales
    logits = model(images)

Quantized models are inference-only: their kernels are int8 tensors with
``requires_grad=False``.
"""

import re

import torch
from torch import nn
from torch.nn import functional as F

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device

INT8_MAX = 127.0
_EPS = 1e-12

_MIN_ROWS = 17  # _int_mm on the card takes m > 16

_MHA_QKV = ("w_query", "w_key", "w_value")  # (d, n, h): contract d
_MHA_PROJ = "w_projection"                  # (n, d, h): contract (n, h)
_MHA_GROUP = (*_MHA_QKV, _MHA_PROJ)
_MOE_BANKS = ("w1", "w2")                   # (E, d, F)/(E, F, d): contract 1
# weights one layer consumes together: they quantize all or none
_GROUPS = (_MHA_GROUP, _MOE_BANKS)


def promote_dtype(*tensors, dtype=None):
    """flax ``promote_dtype``: ``dtype`` if given, else the promotion of the
    operands' dtypes."""
    if dtype is None:
        dtype = tensors[0].dtype
        for t in tensors[1:]:
            if t is not None:
                dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def _symmetric_int8(x, reduce_axes):
    """``(q int8, scale float32)``: ``scale = max(absmax / 127, eps)`` over
    ``reduce_axes`` (kept as size-1 dims) and ``q = clip(round(x / scale),
    -127, 127)`` with ``x`` in float32. ``|x| <= absmax`` and ``scale >=
    absmax / 127`` up to one rounding, so ``|x / scale| < 127.5`` and the
    clip never binds: the codes come from three passes over ``x`` (the
    absmax, the divide, the rounding) and the cast."""
    absmax = torch.linalg.vector_norm(x, float("inf"), dim=reduce_axes,
                                      keepdim=True, dtype=torch.float32)
    scale = torch.clamp_min(absmax / torch.full_like(absmax, INT8_MAX), _EPS)
    q = torch.round(x / scale).to(torch.int8)  # x / scale is float32
    return q, scale


def quantize_weight(w, reduce_axes):
    """Symmetric per-output-channel int8 quantization.

    :param reduce_axes: contraction axes; the absmax is taken over them.
    :returns: ``(w_q int8, scale float32)``, ``w ≈ w_q * scale``; ``scale``
        keeps the reduced axes as size-1 dims.
    """
    return _symmetric_int8(w, reduce_axes)


def dynamic_quantize(x, reduce_axes=(-1,)):
    """Per-row symmetric int8 for activations: absmax over the contraction
    axes. :returns: ``(x_q int8, scale float32)``, reduced axes kept as
    size-1 dims in ``scale``."""
    return _symmetric_int8(x, reduce_axes)


def gemm_operand(w):
    """An int8 ``[..., k, n]`` weight as ``_int_mm``'s second operand (each
    ``[k, n]`` matrix of a stack): padded with zero rows and columns to
    multiples of 8 and held column-major, the transpose of a row-major
    ``[n8, k8]`` (cuBLASLt's "TN" int8 layout). On an H100 it ran 4-7x
    faster than a row-major ``[k8, n8]`` at every shape of the int8 ViT
    paths (``chip_smoke.py`` phase 15 times both). Derived once per weight,
    never per call."""
    k, n = w.shape[-2:]
    return F.pad(w, (0, -n % 8, 0, -k % 8)).mT.contiguous().mT


def int_mm(x_q, w, n):
    """Exact ``int32`` product of int8 ``x_q`` ``[m, k]`` and a weight
    operand from :func:`gemm_operand` (``k`` rows padded to ``k8``), sliced
    to ``[m, n]``. Pads ``x_q`` with zero rows to 17 when ``m <= 16`` and
    with zero columns to ``k8``: the padding adds nothing to any sum."""
    m, k = x_q.shape
    pad_k, pad_m = w.shape[0] - k, max(0, _MIN_ROWS - m)
    if pad_k < 0:
        raise ValueError(f"activations have {k} columns, the weight "
                         f"{w.shape[0]} rows")
    if pad_k or pad_m:
        x_q = F.pad(x_q, (0, pad_k, 0, pad_m))
    return torch._int_mm(x_q, w)[:m, :n]


class QuantDense(nn.Module):
    """``flax.linen.Dense`` with the JAX package's parameter names and
    layout — ``kernel`` ``[in, out]``, ``bias`` ``[out]`` — that runs the
    int8 path once its ``kernel_scale`` is set (:func:`quantize_model`).

    A row-parallel layer of a module placed on a mesh
    (``parallel.sharding``) holds its kernel's rows for this rank and sums
    the ranks' products over ``_reduce_group`` before the bias."""

    _reduce_group = None

    def __init__(self, in_features, features, use_bias=True, dtype=None,
                 param_dtype=torch.float32, kernel_init=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.features = features
        self.kernel_init = kernel_init or initializers.lecun_normal
        self.kernel = initializers.new_param((in_features, features),
                                             param_dtype, device)
        self.bias = (initializers.new_param((features,), param_dtype, device)
                     if use_bias else None)
        self.register_buffer("kernel_scale", None)
        self.register_buffer("_kernel_gemm", None, persistent=False)
        self.register_load_state_dict_post_hook(
            lambda module, keys: module.prepare_int8())

    def reset_parameters(self, generator=None):
        self.kernel_init(self.kernel, generator)
        if self.bias is not None:
            initializers.zeros(self.bias)

    def prepare_int8(self):
        """Derive the GEMM operand of an int8 ``kernel`` (a no-op on a float
        layer)."""
        if self.kernel_scale is not None:
            self._kernel_gemm = gemm_operand(self.kernel.detach())

    def forward(self, x):
        if self.kernel_scale is None:
            dtype = promote_dtype(x, self.kernel, self.bias, dtype=self.dtype)
            y = torch.matmul(x.to(dtype), self.kernel.to(dtype))
            if self._reduce_group is not None:
                # row-parallel: the ranks' partial products summed
                from chambers_tpu_torch.parallel.distributed import (
                    reduce_forward,
                )

                y = reduce_forward(y, self._reduce_group)
            if self.bias is not None:
                y = y + self.bias.to(dtype)
            return y
        # the float branch's output dtype: the kernel's logical dtype is
        # param_dtype (it is stored int8), as in the JAX package
        dtype = self.dtype or torch.promote_types(x.dtype, self.param_dtype)
        lead, k = x.shape[:-1], x.shape[-1]
        x_q, s_x = dynamic_quantize(x.reshape(-1, k))
        acc = int_mm(x_q, self._kernel_gemm, self.features)
        y = (acc * s_x * self.kernel_scale).to(dtype)
        y = y.reshape(*lead, self.features)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


# ---------------------------------------------------------------------------
# state_dict and model conversion
# ---------------------------------------------------------------------------

def _reduce_axes(name, value):
    """Contraction axes of a quantizable entry, or None."""
    if name == "kernel" and value.ndim == 2:
        return (0,)                       # scale [1, N]
    if name in _MHA_QKV and value.ndim == 3:
        return (0,)                       # scale [1, n, h]
    if name == _MHA_PROJ and value.ndim == 3:
        return (0, 2)                     # scale [1, d, 1]
    if name in _MOE_BANKS and value.ndim == 3:
        return (1,)                       # scale [E, 1, out]
    return None


def quantize_state_dict(state_dict, include=None):
    """Quantize a model's ``state_dict`` for int8 serving (the port of
    ``quantize_variables``).

    :param include: optional regex searched in each dotted ``state_dict``
        key (``encoder.layers.0.dense1.kernel``, where the JAX package
        matches ``/``-joined paths); only matching entries are quantized.
    :returns: a new ``state_dict``: eligible entries become int8 tensors of
        the same shape, each with a float32 ``<key>_scale`` entry. Other
        entries are passed on as they are.
    :raises ValueError: if the ``state_dict`` is already quantized, if
        nothing is quantizable, or if ``include`` splits the four projections
        of one attention layer or the two banks of one ``MoEMLP``, which are
        consumed together.
    """
    if any(key.endswith("_scale") and key[:-len("_scale")] in state_dict
           for key in state_dict):
        raise ValueError("state_dict is already quantized")
    pattern = re.compile(include) if include else None
    out, groups = {}, {}
    for key, value in state_dict.items():
        prefix, _, name = key.rpartition(".")
        axes = _reduce_axes(name, value)
        group = next((g for g in _GROUPS if name in g), None)
        if group is not None and value.ndim == 3:
            groups.setdefault((prefix, group), {})[name] = False
        if axes is None or (pattern is not None and not pattern.search(key)):
            out[key] = value
            continue
        out[key], out[key + "_scale"] = quantize_weight(value, axes)
        if group is not None:
            groups[prefix, group][name] = True
    for (prefix, _), done in groups.items():
        if any(done.values()) and not all(done.values()):
            yes = sorted(n for n, d in done.items() if d)
            no = sorted(n for n, d in done.items() if not d)
            raise ValueError(
                f"include pattern splits the quantization group at "
                f"{prefix or '<root>'!r}: {yes} quantized but {no} not — "
                "these weights are consumed by one layer and must quantize "
                "together")
    if len(out) == len(state_dict):
        raise ValueError(
            "no quantizable parameters matched; expected 2-D Dense kernels "
            "or MultiHeadAttention projection tensors"
            + (f" under include={include!r}" if include else ""))
    return out


def dequantize_state_dict(state_dict):
    """Inverse of :func:`quantize_state_dict` up to the quantization error:
    float32 ``q * scale`` for every entry with a ``<key>_scale``, which is
    dropped."""
    scales = {key[:-len("_scale")] for key in state_dict
              if key.endswith("_scale") and key[:-len("_scale")] in state_dict}
    if not scales:
        raise ValueError("state_dict carries no quantization scales")
    return {key: (value.to(torch.float32) * state_dict[key + "_scale"]
                  if key in scales else value)
            for key, value in state_dict.items()
            if not (key.endswith("_scale") and key[:-len("_scale")] in scales)}


def load_quantized_state_dict(model, state_dict):
    """Install a quantized ``state_dict`` (from :func:`quantize_state_dict`
    or converted from the JAX package) in ``model``, in place: every
    quantized entry becomes an int8 tensor with ``requires_grad=False`` in
    place of the float parameter, its scale the layer's buffer, and the
    layer derives its GEMM operands. ``load_state_dict`` alone would copy
    the int8 values into the float parameters. Returns ``model``."""
    quantized = {key[:-len("_scale")] for key in state_dict
                 if key.endswith("_scale") and key[:-len("_scale")] in state_dict}
    plain = {k: v for k, v in state_dict.items()
             if k not in quantized and k[:-len("_scale")] not in quantized}
    unexpected = model.load_state_dict(plain, strict=False).unexpected_keys
    if unexpected:
        raise ValueError(f"model has no entries {sorted(unexpected)}")
    touched = {}
    for key in sorted(quantized):
        prefix, _, name = key.rpartition(".")
        module = model.get_submodule(prefix)
        old = getattr(module, name)
        setattr(module, name, nn.Parameter(
            state_dict[key].to(device=old.device, dtype=torch.int8),
            requires_grad=False))
        setattr(module, name + "_scale",
                state_dict[key + "_scale"].to(device=old.device,
                                              dtype=torch.float32))
        touched[prefix] = module
    for module in touched.values():
        module.prepare_int8()
    missing = set(model.state_dict()) - set(state_dict)
    if missing:
        raise ValueError(f"quantized state_dict lacks {sorted(missing)}")
    return model


def quantize_model(model, include=None):
    """Quantize ``model`` for int8 serving, in place (see
    :func:`quantize_state_dict` for ``include``). Returns ``model``."""
    return load_quantized_state_dict(
        model, quantize_state_dict(model.state_dict(), include))
