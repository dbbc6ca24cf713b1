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

Submodules load on first attribute access, as the JAX package's do
(``chambers_tpu_torch.losses``).
"""

from chambers_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]

_SUBMODULES = (
    "activations", "augmentations", "callbacks", "data", "initializers",
    "layers", "losses", "metrics", "miners", "models", "ops", "optimizers",
    "parallel", "quantization", "schedules", "serialization", "serving",
    "training", "utils",
)


def __getattr__(name):
    """Lazy subpackage import: ``import chambers_tpu_torch;
    chambers_tpu_torch.losses`` imports ``losses`` on first use."""
    if name in _SUBMODULES:
        import importlib

        module = importlib.import_module(f"chambers_tpu_torch.{name}")
        globals()[name] = module
        return module
    raise AttributeError(
        f"module 'chambers_tpu_torch' has no attribute '{name}'")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
