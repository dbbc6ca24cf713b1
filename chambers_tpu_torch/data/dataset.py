"""P×K interleaved image datasets for metric learning (port of
``chambers_tpu/data/dataset.py``).

The constructors build class-interleaved streams — ``cycle_length=P``
classes open at once, ``block_length=K`` images per class per visit — so
that ``batch(P*K)`` yields metric-learning batches with K samples per
class.

Behavioural contract (the golden-sequence tests of
``tests/data/test_dataset.py``, which ``tests/test_torch_data_dataset.py``
holds the port to):
- classes with fewer than K files are upsampled with replacement
  (``_random_upsample``);
- ``block_bound=True`` caps each class visit at K images;
- triplet dirs yield ⌊K/2⌋ anchor+positive images with the real label
  followed by ⌈K/2⌉ negatives with label **−1**;
- the mixed dataset dispatches per directory: dirs with images are class
  dirs, dirs without are triplet dirs.
"""

import itertools
import math
from functools import partial
from typing import Optional

import numpy as np

from chambers_tpu_torch.data.core import AUTOTUNE, Dataset
from chambers_tpu_torch.data.io import (
    match_img_files,
    match_img_files_triplet,
    read_and_decode_image,
    read_and_decode_image_batch,
    read_and_decode_images,
)

__CONFIG = {"N_PARALLEL": AUTOTUNE}


def set_n_parallel(n):
    """Module-global parallelism knob for map/interleave."""
    __CONFIG["N_PARALLEL"] = n


def get_n_parallel():
    return __CONFIG["N_PARALLEL"]


def _shuffle_repeat(dataset: Dataset, shuffle=False, buffer_size=None,
                    reshuffle_iteration=True, seed=None, repeats=None) -> Dataset:
    if shuffle:
        dataset = dataset.shuffle(
            buffer_size=buffer_size, seed=seed,
            reshuffle_each_iteration=reshuffle_iteration,
        )
    if repeats is not None:
        if repeats == -1 or repeats > 0:
            dataset = dataset.repeat(repeats if repeats != -1 else None)
        else:
            raise ValueError("'repeats' must be greater than zero or equal to -1.")
    return dataset


def _get_input_len(inputs):
    ndims = np.ndim(inputs)
    if ndims == 1:
        return len(inputs)
    if ndims > 1:
        return len(inputs[0])
    raise ValueError("Input with 0 dimensions has no length.")


def _sequential_dataset(inputs, shuffle=False, reshuffle_iteration=True,
                        buffer_size=None, seed=None, repeats=None) -> Dataset:
    if buffer_size is None:
        buffer_size = _get_input_len(inputs)
    td = Dataset.from_tensor_slices(inputs)
    return _shuffle_repeat(
        td, shuffle=shuffle, buffer_size=buffer_size,
        reshuffle_iteration=reshuffle_iteration, seed=seed, repeats=repeats,
    )


def _random_upsample(x, n, seed=None):
    """Pad a list to length ``n`` by sampling extra items with replacement."""
    x = list(x)
    n_x = len(x)
    if n <= n_x:
        return x
    rng = np.random.RandomState(seed)
    extra = rng.randint(0, n_x, size=n - n_x)
    return x + [x[i] for i in extra]


def _block_iter(block_tensor, label, block_length, block_bound=True,
                sample_block_random=False, seed=None) -> Dataset:
    files = list(block_tensor)
    if len(files) < block_length:
        files = _random_upsample(files, block_length, seed=seed)
    labels = [np.int64(label)] * len(files)

    block = Dataset.from_tensor_slices(
        (np.asarray(files, object), np.asarray(labels))
    )
    if sample_block_random:
        block = block.shuffle(len(files), seed=seed)
    if block_bound:
        block = block.take(block_length)
    return block


def _block_iter_triplet(triplets, label, block_length, block_bound=True,
                        sample_block_random=False, seed=None) -> Dataset:
    anch, pos, neg = triplets
    pos = list(anch) + list(pos)

    n_pos_block = int(math.floor(block_length / 2))
    n_neg_block = int(math.ceil(block_length / 2))

    block_pos = _block_iter(
        pos, label, n_pos_block, block_bound=block_bound,
        sample_block_random=sample_block_random, seed=seed,
    )
    block_neg = _block_iter(
        neg, -1, n_neg_block, block_bound=block_bound,
        sample_block_random=sample_block_random, seed=seed,
    )
    return block_pos.concatenate(block_neg)


def _interleave_fn_image_files(input_dir, label, block_length, block_bound=True,
                               sample_block_random=False, seed=None) -> Dataset:
    img_files = match_img_files(input_dir)
    return _block_iter(
        img_files, label, block_length=block_length, block_bound=block_bound,
        sample_block_random=sample_block_random, seed=seed,
    )


def _interleave_fn_triplet_files(input_dir, label, block_length,
                                 block_bound=True, sample_block_random=False,
                                 seed=None) -> Dataset:
    triplets = match_img_files_triplet(input_dir)
    return _block_iter_triplet(
        triplets, label, block_length=block_length, block_bound=block_bound,
        sample_block_random=sample_block_random, seed=seed,
    )


def _interleave_fn_image_triplet_files(input_dir, label, block_length,
                                       block_bound=True,
                                       sample_block_random=False,
                                       seed=None) -> Dataset:
    img_files = match_img_files(input_dir)
    if len(img_files) == 0:
        # no images directly in the folder -> assume a triplet folder
        return _interleave_fn_triplet_files(
            input_dir, label, block_length, block_bound=block_bound,
            sample_block_random=sample_block_random, seed=seed,
        )
    return _block_iter(
        img_files, label, block_length=block_length, block_bound=block_bound,
        sample_block_random=sample_block_random, seed=seed,
    )


def _interleave_dataset(inputs, interleave_fn, cycle_length, block_length,
                        shuffle=False, reshuffle_iteration=True,
                        buffer_size=None, seed=None, repeats=None) -> Dataset:
    td = _sequential_dataset(
        inputs, shuffle=shuffle, reshuffle_iteration=reshuffle_iteration,
        buffer_size=buffer_size, seed=seed, repeats=repeats,
    )
    return td.interleave(
        interleave_fn, cycle_length=cycle_length, block_length=block_length,
        num_parallel_calls=__CONFIG["N_PARALLEL"],
    )


class _DecodedImageDataset(Dataset):
    """Dataset of decoded ``(image, label)`` elements with batch-fused decode.

    Python-side pipeline work is O(batches), not O(elements):

    - ``.batch(B)`` REWRITES the pipeline to ``paths.batch(B) → native
      whole-batch decode``: the C thread pool decodes every image of the
      batch directly into one ``[B, h, w, c]`` buffer under a single GIL
      release (``io.read_and_decode_image_batch``), identical output to
      per-element decode + stack.
    - per-element iteration decodes ahead in chunks through the same native
      batch call, yielding elements from the decoded chunk (order
      preserved; read-ahead is bounded by the chunk size).
    """

    _CHUNK = 32

    def __init__(self, paths_ds: Dataset, image_channels: int):
        self._paths_ds = paths_ds
        self._image_channels = image_channels
        super().__init__(self._chunked_gen, cardinality=paths_ds._cardinality)

    def _chunked_gen(self):
        it = self._paths_ds._iter_elements()
        while True:
            block = list(itertools.islice(it, self._CHUNK))
            if not block:
                return
            imgs = read_and_decode_images(
                [f for f, _ in block], channels=self._image_channels)
            for img, (_, y) in zip(imgs, block):
                yield img, y

    def batch(self, batch_size: int, drop_remainder: bool = False) -> Dataset:
        channels = self._image_channels

        def decode_batch(files, labels):
            return (read_and_decode_image_batch(files, channels=channels),
                    np.asarray(labels))

        return self._paths_ds.batch(batch_size, drop_remainder).map(
            decode_batch)


def _decode_map(td: Dataset, image_channels: int) -> Dataset:
    from chambers_tpu_torch.data import native

    if native.available():
        decoded: Dataset = _DecodedImageDataset(td, image_channels)
    else:
        # no native library: keep the per-element thread-pool map so decode
        # still parallelizes across cores through the Python pool
        decoded = td.map(
            lambda x, y: (read_and_decode_image(x, channels=image_channels),
                          y),
            num_parallel_calls=__CONFIG["N_PARALLEL"],
        )
    decoded._num_parallel_calls = __CONFIG["N_PARALLEL"]  # introspection parity
    return decoded


def InterleaveImageClassDataset(
    class_dirs: list,
    labels: list,
    class_cycle_length: int,
    images_per_block: int,
    image_channels=3,
    block_bound=True,
    sample_block_random=False,
    shuffle=False,
    reshuffle_iteration=True,
    buffer_size=None,
    seed=None,
    repeats=None,
    decode=True,
) -> Dataset:
    """P×K sampling: interleave class dirs with ``cycle_length=P`` classes ×
    ``block_length=K`` images, then decode.

    ``decode=False`` yields raw ``(file_path, label)`` elements so callers
    can batch first and decode whole batches natively
    (``io.read_and_decode_images`` → C++ thread pool, one GIL release per
    batch instead of per element)."""
    if images_per_block is None or images_per_block == -1:
        images_per_block = 1

    interleave_fn = partial(
        _interleave_fn_image_files,
        block_length=images_per_block,
        block_bound=block_bound,
        sample_block_random=sample_block_random,
        seed=seed,
    )
    td = _interleave_dataset(
        inputs=(class_dirs, labels),
        interleave_fn=interleave_fn,
        cycle_length=class_cycle_length,
        block_length=images_per_block,
        shuffle=shuffle,
        reshuffle_iteration=reshuffle_iteration,
        buffer_size=buffer_size,
        seed=seed,
        repeats=repeats,
    )
    if not decode:
        return td
    return _decode_map(td, image_channels)


def InterleaveImageTripletDataset(
    class_dirs: list,
    labels: list,
    class_cycle_length: int,
    images_per_block: int,
    image_channels=3,
    block_bound=True,
    sample_block_random=False,
    shuffle=False,
    reshuffle_iteration=True,
    buffer_size=None,
    seed=None,
    repeats=None,
) -> Dataset:
    """Interleave over anchor/positive/negative triplet dirs."""
    if images_per_block is None or images_per_block == -1:
        images_per_block = 1

    interleave_fn = partial(
        _interleave_fn_triplet_files,
        block_length=images_per_block,
        block_bound=block_bound,
        sample_block_random=sample_block_random,
        seed=seed,
    )
    td = _interleave_dataset(
        inputs=(class_dirs, labels),
        interleave_fn=interleave_fn,
        cycle_length=class_cycle_length,
        block_length=images_per_block,
        shuffle=shuffle,
        reshuffle_iteration=reshuffle_iteration,
        buffer_size=buffer_size,
        seed=seed,
        repeats=repeats,
    )
    return _decode_map(td, image_channels)


def InterleaveImageClassTripletDataset(
    class_dirs: list,
    labels: list,
    class_cycle_length: int,
    images_per_block: int,
    image_channels=3,
    block_bound=True,
    sample_block_random=False,
    shuffle=False,
    reshuffle_iteration=True,
    buffer_size=None,
    seed=None,
    repeats=None,
) -> Dataset:
    """Mixed class + triplet dirs with per-dir dispatch."""
    if images_per_block is None or images_per_block == -1:
        images_per_block = 1

    interleave_fn = partial(
        _interleave_fn_image_triplet_files,
        block_length=images_per_block,
        block_bound=block_bound,
        sample_block_random=sample_block_random,
        seed=seed,
    )
    td = _interleave_dataset(
        inputs=(class_dirs, labels),
        interleave_fn=interleave_fn,
        cycle_length=class_cycle_length,
        block_length=images_per_block,
        shuffle=shuffle,
        reshuffle_iteration=reshuffle_iteration,
        buffer_size=buffer_size,
        seed=seed,
        repeats=repeats,
    )
    return _decode_map(td, image_channels)


def SequentialImageDataset(
    class_dirs: list,
    labels: list,
    image_channels=3,
    shuffle=False,
    reshuffle_iteration=True,
    buffer_size=None,
    seed=None,
    repeats=None,
) -> Dataset:
    """Sequentially load all images per class dir."""
    td = _sequential_dataset(
        inputs=(class_dirs, labels),
        shuffle=shuffle,
        reshuffle_iteration=reshuffle_iteration,
        buffer_size=buffer_size,
        seed=seed,
        repeats=repeats,
    )

    def flat_map_fn(input_dir, label):
        files = match_img_files(input_dir)
        ys = [np.int64(label)] * len(files)
        return Dataset.from_tensor_slices(
            (np.asarray(files, object), np.asarray(ys, np.int64))
        )

    td = td.flat_map(flat_map_fn)
    return _decode_map(td, image_channels)
