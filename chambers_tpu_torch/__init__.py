"""PyTorch / CUDA port of ``chambers_tpu`` for NVIDIA Hopper (H100).

Module names mirror ``chambers_tpu`` so each port module sits at the same
path as its JAX counterpart. The package imports ``torch`` and numpy only —
never ``jax`` and nothing of ``chambers_tpu``.

Entry points take a ``device`` argument that defaults to CUDA and raise when
no card is present, unless the caller asks for ``device="cpu"``
(:func:`chambers_tpu_torch.resolve_device`). Hand-written CUDA kernels live
in ``ops/csrc`` and are built with ``nvcc`` at first use
(``chambers_tpu_torch.ops._build``); on CPU tensors every kernel wrapper
runs its plain PyTorch version instead.

Slice 1 covers the serving main path: per-image ``RandAugment(2, 10)`` into
ViT-B/16 inference in bf16. Slice 2 covers a training path: blockwise flash
attention, forward and backward (``ops/flash_attention.py``), and the padded
``Seq2SeqTransformer`` train step that runs on it (``models/transformer.py``).
"""

from chambers_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
