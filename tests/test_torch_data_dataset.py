"""The port's P×K image datasets (``chambers_tpu_torch/data/dataset.py``):
the golden label sequences of ``tests/data/test_dataset.py`` hold, and for
every constructor, with and without ``sample_block_random``, ``shuffle``
and a seed, the port streams the same decoded bytes and labels as the JAX
package, element by element and batched (exact)."""

import numpy as np
import pytest
from PIL import Image

from chambers_tpu.data import dataset as jdataset
from chambers_tpu_torch.data import (
    Dataset,
    InterleaveImageClassDataset,
    InterleaveImageClassTripletDataset,
    InterleaveImageTripletDataset,
    SequentialImageDataset,
    match_img_files,
    match_nested_set,
    native,
    set_n_parallel,
)
from chambers_tpu_torch.data import dataset as tdataset
from chambers_tpu_torch.data.dataset import (
    _block_iter,
    _block_iter_triplet,
    _get_input_len,
    _random_upsample,
    _shuffle_repeat,
)

NC, NB = 5, 2  # class_cycle_length, images_per_block


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    """10 class dirs x 3 tiny PNGs, as tests/data/test_dataset.py's."""
    root = tmp_path_factory.mktemp("mnist") / "train"
    rng = np.random.RandomState(0)
    for digit in range(10):
        d = root / str(digit)
        d.mkdir(parents=True)
        for i in range(3):
            arr = rng.randint(0, 256, (8, 8, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"img_{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def triplets_dir(tmp_path_factory):
    """5 triplet dirs with 2 anchor, 2 positive, 4 negative images each."""
    root = tmp_path_factory.mktemp("triplets") / "train"
    rng = np.random.RandomState(1)
    for t in range(5):
        base = root / f"triplet_{t}"
        for sub, count in (("anchor", 2), ("positive", 2), ("negative", 4)):
            d = base / sub
            d.mkdir(parents=True)
            for i in range(count):
                arr = rng.randint(0, 256, (8, 8, 3), dtype=np.uint8)
                Image.fromarray(arr).save(d / f"{sub}_{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def jpeg_dirs(tmp_path_factory):
    """4 classes of 16x24 JPEGs (uneven counts: upsampling runs)."""
    root = tmp_path_factory.mktemp("jpeg_classes")
    rng = np.random.RandomState(7)
    dirs = []
    for c in range(4):
        d = root / f"class_{c}"
        d.mkdir()
        for i in range(3 + c):
            arr = rng.randint(0, 256, (16, 24, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{i}.jpg", quality=95)
        dirs.append(str(d))
    return dirs


def _labels(dataset, batched=False):
    if batched:
        return [int(y) for _, yb in dataset for y in yb]
    return [int(y) for _, y in dataset]


def _build(ctor, dirs, **kwargs):
    defaults = dict(
        class_dirs=dirs, labels=list(range(len(dirs))),
        class_cycle_length=NC, images_per_block=NB, image_channels=3,
        block_bound=True, sample_block_random=False, shuffle=False,
        reshuffle_iteration=False, buffer_size=1024, seed=None, repeats=None)
    defaults.update(kwargs)
    return ctor(**defaults)


def _class_dirs(root):
    return sorted(match_nested_set(root))


# --- the golden label sequences ------------------------------------------------

GOLDEN_CLASS = [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9]


def test_class_golden_block_bound_on(mnist_dir):
    td = _build(InterleaveImageClassDataset, _class_dirs(mnist_dir))
    assert _labels(td) == GOLDEN_CLASS
    assert _labels(td.batch(NC * NB), batched=True) == GOLDEN_CLASS


def test_class_golden_block_bound_off(mnist_dir):
    """3 files a class with K=2 leave a 1-image tail round."""
    td = _build(InterleaveImageClassDataset, _class_dirs(mnist_dir),
                block_bound=False)
    golden = [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 0, 1, 2, 3, 4,
              5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 5, 6, 7, 8, 9]
    assert _labels(td) == golden
    assert _labels(td.batch(NC * NB), batched=True) == golden


def test_triplet_golden(triplets_dir):
    td = _build(InterleaveImageTripletDataset, _class_dirs(triplets_dir))
    golden = [0, -1, 1, -1, 2, -1, 3, -1, 4, -1]
    assert _labels(td) == golden
    assert _labels(td.batch(NC * NB), batched=True) == golden


def test_class_triplet_golden(mnist_dir, triplets_dir):
    dirs = _class_dirs(mnist_dir) + _class_dirs(triplets_dir)
    td = _build(InterleaveImageClassTripletDataset, dirs)
    golden = GOLDEN_CLASS + [10, -1, 11, -1, 12, -1, 13, -1, 14, -1]
    assert _labels(td) == golden
    assert _labels(td.batch(NC * NB), batched=True) == golden


def test_sequential_golden(mnist_dir):
    td = SequentialImageDataset(class_dirs=_class_dirs(mnist_dir),
                                labels=list(range(10)))
    assert _labels(td) == [c for c in range(10) for _ in range(3)]


def test_shard_partitions_the_golden_sequence(mnist_dir):
    dirs = _class_dirs(mnist_dir)
    shards = [_labels(_build(InterleaveImageClassDataset, dirs).shard(2, i))
              for i in (0, 1)]
    assert shards == [GOLDEN_CLASS[0::2], GOLDEN_CLASS[1::2]]


# --- the port's streams equal JAX's ---------------------------------------------

CTORS = {
    "class": ("InterleaveImageClassDataset", "mnist"),
    "triplet": ("InterleaveImageTripletDataset", "triplets"),
    "class_triplet": ("InterleaveImageClassTripletDataset", "both"),
    "class_jpeg": ("InterleaveImageClassDataset", "jpeg"),
}
OPTIONS = {
    "plain": {},
    "block_random": dict(sample_block_random=True, seed=3),
    "shuffle": dict(shuffle=True, seed=42, buffer_size=4),
    "all_seeded": dict(sample_block_random=True, shuffle=True, seed=11,
                       repeats=2),
    "reshuffle": dict(sample_block_random=True, shuffle=True, seed=5,
                      reshuffle_iteration=True, repeats=3),
    "unbounded": dict(block_bound=False, sample_block_random=True, seed=2,
                      images_per_block=3),
}


def _dirs(kind, mnist_dir, triplets_dir, jpeg_dirs):
    return {"mnist": _class_dirs(mnist_dir),
            "triplets": _class_dirs(triplets_dir),
            "both": _class_dirs(mnist_dir) + _class_dirs(triplets_dir),
            "jpeg": jpeg_dirs}[kind]


def _assert_streams_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and np.array_equal(gx, wx)
        assert np.asarray(gy).dtype == np.asarray(wy).dtype
        assert np.array_equal(gy, wy)


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("ctor", sorted(CTORS))
def test_streams_equal_jax(ctor, option, mnist_dir, triplets_dir,
                           jpeg_dirs):
    name, kind = CTORS[ctor]
    dirs = _dirs(kind, mnist_dir, triplets_dir, jpeg_dirs)
    kwargs = dict(OPTIONS[option])
    if kind == "jpeg":
        kwargs.setdefault("class_cycle_length", 3)
    got = _build(getattr(tdataset, name), dirs, **kwargs)
    want = _build(getattr(jdataset, name), dirs, **kwargs)
    _assert_streams_equal(got, want)
    # the fused batch decode gives the same batches, and a second pass
    # (the next epoch) the same stream
    _assert_streams_equal(got.batch(4), want.batch(4))
    _assert_streams_equal(got, want)


@pytest.mark.parametrize("shuffle", [False, True])
def test_sequential_stream_equals_jax(mnist_dir, shuffle):
    kwargs = dict(class_dirs=_class_dirs(mnist_dir), labels=list(range(10)),
                  shuffle=shuffle, seed=9, repeats=2)
    _assert_streams_equal(SequentialImageDataset(**kwargs),
                          jdataset.SequentialImageDataset(**kwargs))


def test_p_by_k_batches(jpeg_dirs):
    """Every batch of P*K holds P classes, K images each."""
    ds = _build(InterleaveImageClassDataset, jpeg_dirs, class_cycle_length=4,
                images_per_block=2, sample_block_random=True, shuffle=True,
                seed=42, repeats=-1).batch(8, drop_remainder=True)
    for _, (x, y) in zip(range(6), ds):
        assert x.shape == (8, 16, 24, 3) and x.dtype == np.uint8
        assert sorted(np.unique(y, return_counts=True)[1]) == [2] * 4


def test_fused_batch_decode_equals_element_decode(jpeg_dirs):
    """``.batch`` on a decoded dataset decodes whole batches (natively
    where the decoder builds): the bytes per-element decoding gives."""
    kwargs = dict(class_cycle_length=2, images_per_block=3)
    batches = list(_build(InterleaveImageClassDataset, jpeg_dirs,
                          **kwargs).batch(5))
    elements = list(_build(InterleaveImageClassDataset, jpeg_dirs, **kwargs))
    flat = [(x, y) for xb, yb in batches for x, y in zip(xb, yb)]
    assert len(flat) == len(elements)
    for (bx, by), (ex, ey) in zip(flat, elements):
        assert np.array_equal(bx, ex) and by == ey
    paths = list(_build(InterleaveImageClassDataset, jpeg_dirs, decode=False,
                        **kwargs))
    for (img, _), (path, _) in zip(elements, paths):
        assert np.array_equal(img, np.asarray(Image.open(path).convert("RGB")))
    assert isinstance(_build(InterleaveImageClassDataset, jpeg_dirs),
                      tdataset._DecodedImageDataset) == native.available()


# --- the building blocks --------------------------------------------------------

def test_get_input_len():
    assert _get_input_len(("a", "b")) == 2
    assert _get_input_len((["a", "b", "c"], [1, 2, 3])) == 3
    with pytest.raises(ValueError):
        _get_input_len(5)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_upsample_equals_jax(seed):
    up = _random_upsample(list(range(10)), 23, seed=seed)
    assert up == jdataset._random_upsample(list(range(10)), 23, seed=seed)
    assert up[:10] == list(range(10)) and len(up) == 23
    assert _random_upsample(list(range(10)), 10) == list(range(10))


@pytest.mark.parametrize("kwargs", [
    dict(block_length=2, block_bound=False),
    dict(block_length=2),
    dict(block_length=7, seed=0),
    dict(block_length=3, sample_block_random=True, seed=1),
    dict(block_length=3, sample_block_random=True, seed=2),
])
def test_block_iter_equals_jax(mnist_dir, kwargs):
    files = match_img_files(f"{mnist_dir}/0")
    got = [(str(f), int(y)) for f, y in _block_iter(files, 0, **kwargs)]
    want = [(str(f), int(y))
            for f, y in jdataset._block_iter(files, 0, **kwargs)]
    assert got == want
    n = kwargs["block_length"]
    assert len(got) == (len(files) if not kwargs.get("block_bound", True)
                        else n)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_block_iter_triplet_equals_jax(triplets_dir, k):
    from chambers_tpu_torch.data.io import match_img_files_triplet

    trip = match_img_files_triplet(_class_dirs(triplets_dir)[0])
    got = [(str(f), int(y)) for f, y in _block_iter_triplet(
        trip, 4, k, sample_block_random=True, seed=3)]
    want = [(str(f), int(y)) for f, y in jdataset._block_iter_triplet(
        trip, 4, k, sample_block_random=True, seed=3)]
    assert got == want
    assert [y for _, y in got] == [4] * (k // 2) + [-1] * (k - k // 2)


def test_shuffle_repeat():
    ds = Dataset.from_tensor_slices(np.arange(10))
    assert [int(x) for x in _shuffle_repeat(ds)] == list(range(10))
    assert len(list(_shuffle_repeat(ds, repeats=3))) == 30
    with pytest.raises(ValueError):
        _shuffle_repeat(ds, repeats=0)
    same = [int(x) for x in _shuffle_repeat(
        ds, shuffle=True, buffer_size=10, reshuffle_iteration=False, seed=1,
        repeats=2)]
    assert same[:10] == same[10:]
    moved = [int(x) for x in _shuffle_repeat(
        ds, shuffle=True, buffer_size=10, reshuffle_iteration=True, seed=1,
        repeats=2)]
    assert moved[:10] != moved[10:]
    assert sorted(moved[:10]) == sorted(moved[10:]) == list(range(10))


def test_set_n_parallel(mnist_dir):
    try:
        set_n_parallel(3)
        assert _build(InterleaveImageClassDataset,
                      _class_dirs(mnist_dir))._num_parallel_calls == 3
    finally:
        set_n_parallel(-1)
    assert _build(InterleaveImageClassDataset,
                  _class_dirs(mnist_dir))._num_parallel_calls == -1
