"""Host-side dataset abstraction (port of ``chambers_tpu/data/core.py``).

A minimal Dataset core with the combinator surface of ``tf.data.Dataset``
— ``from_tensor_slices`` / ``map`` / ``batch`` / ``shuffle`` / ``repeat`` /
``take`` / ``interleave`` / ``flat_map`` / ``prefetch`` — as composable
Python iterables with NumPy elements, feeding augmentation on the card.
The code is the JAX package's, line for line: the same seed gives the same
element stream in both packages.

Semantics mirror tf.data where the golden-sequence tests observe them
(``tests/data/test_dataset.py``):

- ``interleave(cycle_length=C, block_length=B)``: C concurrently-open child
  iterators served round-robin, up to B elements per visit; an exhausted child
  ends its block immediately and its slot is refilled from the next input
  *before* the next visit.
- ``shuffle(buffer_size, seed, reshuffle_each_iteration)``: buffered
  reservoir shuffle; with ``reshuffle_each_iteration=False`` every epoch
  replays the same order. Randomness is numpy-seeded — deterministic across
  runs, though not bit-identical to TF's Philox sequence for the same seed.
- ``map(num_parallel_calls=N)``: thread-pool map that preserves order
  (deterministic like tf.data's default).

Every dataset is re-iterable: each ``iter()`` restarts the pipeline (epoch
counters advance shuffle reseeding exactly like tf.data).
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

AUTOTUNE = -1


# tf.data cardinality sentinels (utils/data.py's valid_cardinality branches
# on them)
INFINITE_CARDINALITY = -1
UNKNOWN_CARDINALITY = -2


class Dataset:
    """A re-iterable pipeline of NumPy-element tuples."""

    def __init__(self, gen_fn: Callable[[], Iterator], element_spec=None,
                 cardinality: int = UNKNOWN_CARDINALITY):
        self._gen_fn = gen_fn
        self.element_spec = element_spec
        self._cardinality = cardinality

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_tensor_slices(tensors) -> "Dataset":
        """Slice a (possibly nested tuple of) array(s) along axis 0."""
        if isinstance(tensors, tuple):
            arrays = tuple(np.asarray(t) for t in tensors)
            n = len(arrays[0])
            for a in arrays:
                if len(a) != n:
                    raise ValueError("All inputs must have the same length.")

            def gen():
                for i in range(n):
                    yield tuple(a[i] for a in arrays)

        else:
            array = np.asarray(tensors)
            n = len(array)

            def gen():
                yield from array

        return Dataset(gen, cardinality=n)

    @staticmethod
    def from_generator(gen_fn: Callable[[], Iterator]) -> "Dataset":
        return Dataset(gen_fn)

    @staticmethod
    def range(*args) -> "Dataset":
        return Dataset(lambda: iter(np.arange(*args)),
                       cardinality=len(np.arange(*args)))

    # -- combinators --------------------------------------------------------
    def map(self, fn: Callable, num_parallel_calls: Optional[int] = None) -> "Dataset":
        def gen():
            from chambers_tpu_torch.utils.generic import effective_cpu_count

            it = self._iter_elements()
            cores = effective_cpu_count()
            # cap AUTOTUNE: beyond ~32 threads a GIL-bound map fn gains
            # nothing and the 2x in-flight window starts costing memory on
            # big hosts; explicit num_parallel_calls is honored unclamped
            workers = (min(max(cores, 2), 32)
                       if num_parallel_calls == AUTOTUNE
                       else num_parallel_calls)
            # single-core hosts gain nothing from a CPU-bound thread pool;
            # the per-element future overhead just slows the stream down
            if cores == 1 and num_parallel_calls == AUTOTUNE:
                workers = 0
            if not workers:
                for el in it:
                    yield _apply(fn, el)
                return
            with ThreadPoolExecutor(max_workers=workers) as pool:
                window = workers * 2
                futures = []
                try:
                    for el in itertools.islice(it, window):
                        futures.append(pool.submit(_apply, fn, el))
                    for el in it:
                        done = futures.pop(0)
                        futures.append(pool.submit(_apply, fn, el))
                        yield done.result()
                    for f in futures:
                        yield f.result()
                finally:
                    for f in futures:
                        f.cancel()

        return Dataset(gen, cardinality=self._cardinality)

    def batch(self, batch_size: int, drop_remainder: bool = False) -> "Dataset":
        def gen():
            buf = []
            for el in self._iter_elements():
                buf.append(el)
                if len(buf) == batch_size:
                    yield _stack(buf)
                    buf = []
            if buf and not drop_remainder:
                yield _stack(buf)

        n = self._cardinality
        if n >= 0:
            card = (n // batch_size if drop_remainder
                    else -(-n // batch_size))
        else:
            card = n  # infinite stays infinite, unknown unknown
        return Dataset(gen, cardinality=card)

    def unbatch(self) -> "Dataset":
        def gen():
            for el in self._iter_elements():
                if isinstance(el, tuple):
                    n = len(el[0])
                    for i in range(n):
                        yield tuple(np.asarray(part)[i] for part in el)
                else:
                    yield from np.asarray(el)

        card = (INFINITE_CARDINALITY
                if self._cardinality == INFINITE_CARDINALITY
                else UNKNOWN_CARDINALITY)
        return Dataset(gen, cardinality=card)

    def shuffle(self, buffer_size: int, seed: Optional[int] = None,
                reshuffle_each_iteration: bool = True) -> "Dataset":
        epoch_counter = itertools.count()

        def gen():
            epoch = next(epoch_counter)
            if seed is None:
                rng = np.random.RandomState()
            elif reshuffle_each_iteration:
                rng = np.random.RandomState((seed + epoch) % (2 ** 31))
            else:
                rng = np.random.RandomState(seed)

            buf = []
            for el in self._iter_elements():
                buf.append(el)
                if len(buf) >= buffer_size:
                    idx = rng.randint(len(buf))
                    buf[idx], buf[-1] = buf[-1], buf[idx]
                    yield buf.pop()
            while buf:
                idx = rng.randint(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield buf.pop()

        return Dataset(gen, cardinality=self._cardinality)

    def repeat(self, count: Optional[int] = None) -> "Dataset":
        def gen():
            if count is None or count == -1:
                while True:
                    yield from self._iter_elements()
            else:
                for _ in range(count):
                    yield from self._iter_elements()

        n = self._cardinality
        if count is None or count == -1:
            card = (0 if n == 0
                    else INFINITE_CARDINALITY if n > 0
                    else n)  # empty stays empty; unknown could be empty
        elif n >= 0:
            card = n * count
        else:
            card = n
        return Dataset(gen, cardinality=card)

    def take(self, count: int) -> "Dataset":
        def gen():
            yield from itertools.islice(self._iter_elements(), count)

        n = self._cardinality
        card = (min(n, count) if n >= 0
                else count if n == INFINITE_CARDINALITY
                else n)
        return Dataset(gen, cardinality=card)

    def skip(self, count: int) -> "Dataset":
        def gen():
            it = self._iter_elements()
            next(itertools.islice(it, count, count), None)
            yield from it

        n = self._cardinality
        card = max(n - count, 0) if n >= 0 else n
        return Dataset(gen, cardinality=card)

    def concatenate(self, other: "Dataset") -> "Dataset":
        def gen():
            yield from self._iter_elements()
            yield from other._iter_elements()

        a, b = self._cardinality, other._cardinality
        if INFINITE_CARDINALITY in (a, b):
            card = INFINITE_CARDINALITY
        elif a >= 0 and b >= 0:
            card = a + b
        else:
            card = UNKNOWN_CARDINALITY
        return Dataset(gen, cardinality=card)

    @staticmethod
    def zip(datasets) -> "Dataset":
        """Element-wise zip of a tuple/list of datasets (tf.data
        ``Dataset.zip`` semantics: stops at the shortest)."""
        datasets = tuple(datasets)
        if not datasets:
            raise ValueError("Dataset.zip needs at least one dataset")

        def gen():
            iterators = [d._iter_elements() for d in datasets]
            while True:
                try:
                    yield tuple(next(it) for it in iterators)
                except (StopIteration, RuntimeError) as e:
                    # PEP 479: a StopIteration inside the genexp surfaces
                    # as RuntimeError — both mean "shortest input drained"
                    if isinstance(e, RuntimeError) and not isinstance(
                            e.__cause__, StopIteration):
                        raise
                    return

        cards = [d._cardinality for d in datasets]
        if any(c == UNKNOWN_CARDINALITY for c in cards):
            card = UNKNOWN_CARDINALITY
        elif all(c == INFINITE_CARDINALITY for c in cards):
            card = INFINITE_CARDINALITY
        else:
            card = min(c for c in cards if c != INFINITE_CARDINALITY)
        return Dataset(gen, cardinality=card)

    def enumerate(self, start: int = 0) -> "Dataset":
        """``(index, element)`` pairs (tf.data ``Dataset.enumerate``)."""

        def gen():
            for i, el in zip(itertools.count(start), self._iter_elements()):
                yield i, el

        return Dataset(gen, cardinality=self._cardinality)

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """Every ``num_shards``-th element starting at ``index`` (tf.data
        ``Dataset.shard`` semantics). The multi-process input-pipeline
        primitive: each process takes ``shard(world_size, rank)`` before
        batching."""
        if num_shards <= 0:
            raise ValueError(f"num_shards must be positive, got {num_shards}")
        if not 0 <= index < num_shards:
            raise ValueError(
                f"shard index {index} out of range for {num_shards} shards")

        def gen():
            yield from itertools.islice(
                self._iter_elements(), index, None, num_shards)

        n = self._cardinality
        card = (len(range(index, n, num_shards)) if n >= 0 else n)
        return Dataset(gen, cardinality=card)

    def flat_map(self, fn: Callable[..., "Dataset"]) -> "Dataset":
        def gen():
            for el in self._iter_elements():
                yield from _apply(fn, el)._iter_elements()

        return Dataset(gen)

    def interleave(self, fn: Callable[..., "Dataset"], cycle_length: int,
                   block_length: int = 1,
                   num_parallel_calls: Optional[int] = None) -> "Dataset":
        """tf.data interleave semantics (see module docstring).

        ``num_parallel_calls`` is accepted for API parity; child pipelines are
        driven eagerly enough by ``prefetch`` that separate worker scheduling
        is unnecessary here.
        """

        def gen():
            inputs = self._iter_elements()
            slots: list = []  # open child iterators
            exhausted_inputs = False

            def refill():
                nonlocal exhausted_inputs
                while len(slots) < cycle_length and not exhausted_inputs:
                    try:
                        el = next(inputs)
                    except StopIteration:
                        exhausted_inputs = True
                        return
                    slots.append(_apply(fn, el)._iter_elements())

            refill()
            pos = 0
            while slots:
                if pos >= len(slots):
                    pos = 0
                child = slots[pos]
                emitted = 0
                dead = False
                while emitted < block_length:
                    try:
                        yield next(child)
                        emitted += 1
                    except StopIteration:
                        dead = True
                        break
                if dead:
                    # pop shifts the next child into this index; a refill
                    # appends the fresh iterator at the cycle's tail (it waits
                    # its turn, matching tf.data's slot replacement order)
                    slots.pop(pos)
                    refill()
                else:
                    pos += 1

        return Dataset(gen)

    def prefetch(self, buffer_size: int = AUTOTUNE) -> "Dataset":
        depth = 8 if buffer_size in (None, AUTOTUNE) else buffer_size

        def gen():
            q: queue.Queue = queue.Queue(maxsize=depth)
            sentinel = object()
            error_holder = []
            stop = threading.Event()

            def producer():
                try:
                    for el in self._iter_elements():
                        # bounded put with a stop check so an abandoned
                        # consumer (break/take) releases the thread instead
                        # of leaking it blocked on a full queue forever
                        while not stop.is_set():
                            try:
                                q.put(el, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                except BaseException as e:  # propagate to consumer
                    error_holder.append(e)
                finally:
                    while not stop.is_set():
                        try:
                            q.put(sentinel, timeout=0.1)
                            break
                        except queue.Full:
                            continue

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            try:
                while True:
                    el = q.get()
                    if el is sentinel:
                        if error_holder:
                            raise error_holder[0]
                        return
                    yield el
            finally:
                stop.set()

        return Dataset(gen, cardinality=self._cardinality)

    def filter(self, predicate: Callable) -> "Dataset":
        def gen():
            for el in self._iter_elements():
                if _apply(predicate, el):
                    yield el

        return Dataset(gen)

    def cache(self) -> "Dataset":
        storage: list = []
        done = threading.Event()

        def gen():
            if done.is_set():
                yield from storage
                return
            # buffer locally; only a COMPLETE pass commits to the cache —
            # a partial iteration (downstream .take / break) must not
            # poison later epochs (tf.data discards incomplete caches too)
            local: list = []
            for el in self._iter_elements():
                local.append(el)
                yield el
            if not done.is_set():
                storage.extend(local)
                done.set()

        return Dataset(gen, cardinality=self._cardinality)

    # -- consumption --------------------------------------------------------
    def _iter_elements(self) -> Iterator:
        return iter(self._gen_fn())

    def __iter__(self) -> Iterator:
        return self._iter_elements()

    def as_numpy_iterator(self) -> Iterator:
        return self._iter_elements()

    def cardinality(self) -> int:
        """Element count when statically known, else the tf.data sentinels
        ``INFINITE_CARDINALITY`` (−1) / ``UNKNOWN_CARDINALITY`` (−2).
        Known for sized sources (``from_tensor_slices``/``range``) through
        count-preserving or count-transforming combinators; ``filter`` /
        ``flat_map`` / ``interleave`` / ``from_generator`` are unknown,
        as in tf.data."""
        return self._cardinality


def _apply(fn, el):
    if isinstance(el, tuple):
        return fn(*el)
    return fn(el)


def _stack(elements: Sequence[Any]):
    first = elements[0]
    if isinstance(first, tuple):
        return tuple(
            np.stack([np.asarray(e[i]) for e in elements]) for i in range(len(first))
        )
    return np.stack([np.asarray(e) for e in elements])
