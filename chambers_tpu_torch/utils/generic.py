"""Generic utilities (port of ``chambers_tpu/utils/generic.py``).

``set_dtype_policy_deep`` sets the compute ``dtype`` of every submodule
that has one, in place: the port's layers keep float32 parameters and cast
at use, as the JAX package's do under a ``dtype`` clone.
"""

import inspect
import os
import random
import sys
import time

import numpy as np
import torch


def deserialize_object(identifier, module_objects, module_name, **kwargs):
    """String -> object resolution against a registry dict."""
    if isinstance(identifier, str):
        obj = module_objects.get(identifier)
        if obj is None:
            raise ValueError("Unknown " + module_name + ":" + identifier)
        if inspect.isclass(obj) or callable(obj):
            return obj(**kwargs)
        return obj
    raise ValueError(
        "Could not interpret serialized " + module_name + ": " + str(identifier)
    )


def effective_cpu_count() -> int:
    """Usable core count: respects affinity pinning, where
    ``os.cpu_count()`` reports the whole machine."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


def set_random_seed(seed: int) -> torch.Generator:
    """Seed Python's ``random``, numpy and torch (every device); return a
    CPU ``torch.Generator`` seeded the same, to pass on explicitly."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


_POLICIES = {
    "bfloat16": torch.bfloat16, "mixed_bfloat16": torch.bfloat16,
    "float16": torch.float16, "mixed_float16": torch.float16,
    "float32": torch.float32,
}


def use_mixed_precision(dtype="bfloat16"):
    """The activation dtype of a precision policy name: pass it as the
    ``dtype=`` of models and layers (parameters stay float32)."""
    if dtype not in _POLICIES:
        raise ValueError(f"Unknown precision policy '{dtype}'")
    print("Computation dtype:", dtype)
    print("Variable dtype: float32")
    return _POLICIES[dtype]


def set_dtype_policy_deep(module, dtype):
    """Set the compute ``dtype`` of ``module`` and of every submodule that
    has a ``dtype`` attribute, in place; returns ``module``. ``dtype`` is a
    torch dtype or a policy name (``"bfloat16"``, ``"mixed_bfloat16"``,
    ...). Parameters keep their float32 storage."""
    if isinstance(dtype, str):
        dtype = use_mixed_precision(dtype)
    if not hasattr(module, "dtype"):
        raise ValueError(
            f"{type(module).__name__} takes no `dtype` attribute; pass dtype "
            "to its submodules at construction instead")
    for sub in module.modules():
        if "dtype" in vars(sub):
            sub.dtype = dtype
    return module


def get_model_memory_usage(batch_size: int, model, input_shape=None,
                           dtype_bytes: int = 4) -> float:
    """Memory estimate in GB: parameters and buffers, plus, with
    ``input_shape``, the outputs of every leaf module in a forward of one
    zero sample, times ``batch_size``."""
    module = getattr(model, "module", model)
    n = sum(t.numel() for t in list(module.parameters())
            + list(module.buffers()))
    total = n * dtype_bytes
    if input_shape is not None:
        elems = [0]

        def count(_, __, out):
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    elems[0] += t[0].numel() if t.ndim else 1

        leaves = [m for m in module.modules() if not list(m.children())]
        hooks = [m.register_forward_hook(count) for m in leaves]
        device = next(module.parameters()).device
        try:
            with torch.no_grad():
                module(torch.zeros((1,) + tuple(input_shape), device=device))
        finally:
            for h in hooks:
                h.remove()
        total += elems[0] * batch_size * dtype_bytes
    return round(total / 1024.0 ** 3, 3)


class Timer:
    """Context-manager wall-clock timer; with ``sync`` (a tensor, or
    anything with a ``device``) it synchronizes that tensor's card before
    reading the clock."""

    def __init__(self, sync=None):
        self._sync = sync

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        device = getattr(self._sync, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        self.elapsed = time.perf_counter() - self.start


class ProgressBar:
    """Host-side progress bar on a stream (stderr by default)."""

    def __init__(self, total: int, cols: int = 30, stream=None):
        self.total = int(total)
        self.cols = cols
        self.stream = stream or sys.stderr
        self._steps = 0
        self._start_time = time.time()

    def update(self, n):
        self._steps = int(n)
        self._report()

    def add(self, n):
        self._steps += int(n)
        self._report()

    def _report(self):
        frac = self._steps / max(self.total, 1)
        n_complete = int(frac * self.cols)
        n_current = 1 if self.cols - n_complete > 0 else 0
        bar = "=" * n_complete + ">" * n_current
        bar = bar + "." * (self.cols - len(bar))
        elapsed = time.time() - self._start_time
        per_step = elapsed / max(self._steps, 1)
        self.stream.write(
            f"\r{self._steps}/{self.total} [{bar}] - {per_step:.2f}s/step"
        )
        self.stream.flush()

    def dataset_apply_fn(self, dataset):
        """``dataset`` as a :class:`~chambers_tpu_torch.data.Dataset` that
        advances the bar by one for each element it yields."""
        bar = self

        def gen():
            for el in dataset:
                bar.add(1)
                yield el

        from chambers_tpu_torch.data.core import Dataset

        return Dataset(gen)
