"""Device feeding: overlap the host -> device copy with compute (port of
``chambers_tpu/data/loader.py``).

The JAX package keeps ``size`` ``device_put`` transfers in flight (they are
asynchronous there). On a CUDA card a copy overlaps the step only from
pinned host memory and on a stream of its own, so :func:`device_prefetch`
and the Trainer share one prefetcher, :class:`_DevicePrefetcher`: pinned
memory, ``non_blocking`` copies on a copy stream, an event a batch, and
``record_stream`` on delivery. Host-side production is ``Dataset.prefetch``'s
thread.
"""

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from chambers_tpu_torch._device import resolve_device


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def _host_tensor(x):
    """A batch leaf as a CPU tensor: numpy float64 becomes float32, as in
    the JAX package (which runs with 64-bit types off)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _to_device(x, device):
    """A batch leaf on ``device``; to a card from pinned memory with a
    ``non_blocking`` copy (on the caller's current stream)."""
    t = _host_tensor(x)
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class _DevicePrefetcher:
    """Host -> device prefetching over a batch iterator.

    ``place(*batch)`` moves a batch to the device; with a CUDA copy
    ``stream`` it runs on that stream (pinned memory, ``non_blocking``
    copies), an event marks the batch's copies, and on delivery the
    consuming stream waits for that event and every tensor of the batch
    is recorded on it (``record_stream``), so its memory is never reused
    while the step still reads it. Keeps at most ``depth`` batches placed
    ahead of the consumer. Lazy: constructing it pulls no batch.
    """

    def __init__(self, it, place, depth: int = 2, stream=None):
        self._it = it
        self._place = place
        self._queue = deque()
        self._depth = depth
        self._stream = stream
        self._started = False

    def _fill(self, n):
        for _ in range(n):
            try:
                batch = next(self._it)
            except StopIteration:
                return
            if self._stream is None:
                self._queue.append((self._place(*batch), None))
                continue
            with torch.cuda.stream(self._stream):
                placed = self._place(*batch)
                event = torch.cuda.Event()
                event.record(self._stream)
            self._queue.append((placed, event))

    def __iter__(self):
        return self

    def __next__(self):
        if not self._started:
            self._started = True
            self._fill(self._depth)
        if not self._queue:
            raise StopIteration
        out, event = self._queue.popleft()
        if event is not None:
            current = torch.cuda.current_stream()
            current.wait_event(event)
            for t in _leaves(out):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(current)
        self._fill(1)
        return out


def _sharded(x, sharding, device):
    """This rank's rows of the global batch leaf ``x`` copied to ``device``
    and wrapped as the global ``DTensor`` under ``sharding``."""
    from torch.distributed.tensor import DTensor

    from chambers_tpu_torch.parallel.sharding import _validated, _local_shard

    _validated("batch", x, sharding.spec, sharding.mesh)
    rows = _local_shard(_host_tensor(x), sharding.mesh, sharding.spec)
    return DTensor.from_local(_to_device(rows, device), sharding.mesh,
                              sharding.placements)


def device_prefetch(iterable: Iterable, size: int = 2, device=None,
                    sharding=None) -> Iterator:
    """Iterate batches (arrays, tensors, or tuples, lists and dicts of
    them) placed on ``device`` — CUDA unless the caller says otherwise —
    with at most ``size`` batches copied ahead of use, on a copy stream of
    their own. Raises without a card unless ``device="cpu"``.

    :param sharding: a ``parallel.sharding.NamedSharding`` (e.g.
        ``batch_sharding(mesh)``): every leaf is a global batch, of which
        only this rank's rows are copied, and comes out as a ``DTensor``
        sharded so (the JAX package's sharded ``jax.Array``). The device is
        then the mesh's. The rows must divide over the mesh axis.
    """
    if size < 1:
        raise ValueError("size must be >= 1")
    if sharding is not None:
        from chambers_tpu_torch.parallel.distributed import mesh_device

        device = mesh_device(sharding.mesh)
    device = resolve_device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def place(batch):
        if sharding is not None:
            return _tree_map(lambda x: _sharded(x, sharding, device), batch)
        return _tree_map(lambda x: _to_device(x, device), batch)

    return _DevicePrefetcher(((batch,) for batch in iterable), place,
                             depth=size, stream=stream)
