"""Profiling and timing helpers (port of ``chambers_tpu/utils/profiling.py``).

- :func:`trace`: ``torch.profiler`` over the CPU and, when present, the
  card, writing a Chrome trace (``trace.json``) into ``log_dir``;
- :func:`annotate`: a named range (``torch.profiler.record_function``);
- :func:`benchmark`: per-call times with a device synchronization after
  every call (CUDA events on the card, the host clock on the CPU);
- :func:`device_memory_stats`: ``torch.cuda.memory_stats``.
"""

import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace("logs/profile"): step()``; the Chrome
    trace lands in ``log_dir/trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range inside a trace."""
    return torch.profiler.record_function(name)


def _on_card(out):
    leaves = out if isinstance(out, (tuple, list)) else [out]
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves)


def benchmark(fn: Callable, *args, warmup: int = 3, iters: int = 10,
              sync: bool = True):
    """Time ``fn(*args)``: p50/mean/min/max seconds and the per-call times.
    A call whose output lies on the card is timed with CUDA events and
    synchronized; one on the CPU with the host clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    cuda = sync and torch.cuda.is_available() and (
        out is None or _on_card(out))
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {"p50_s": float(np.median(times)), "mean_s": float(times.mean()),
            "min_s": float(times.min()), "max_s": float(times.max()),
            "times_s": times.tolist()}


def device_memory_stats(device=None) -> Optional[dict]:
    """The card's allocator statistics (``torch.cuda.memory_stats``), or
    None without a card."""
    if not torch.cuda.is_available():
        return None
    return dict(torch.cuda.memory_stats(device))
