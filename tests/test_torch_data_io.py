"""The port's file matching and decoding (``chambers_tpu_torch/data/io.py``,
``native.py``) against the JAX package's: the same file lists, and the same
decoded bytes for PNG, BMP, GIF, grayscale and JPEG files, per element and
through the native batch decoder (exact). The native cases skip where the
decoder cannot be built (no ``g++`` or no libjpeg), as the JAX package's
do."""

import os
import time

import numpy as np
import pytest
from PIL import Image

from chambers_tpu.data import io as jio
from chambers_tpu.data import native as jnative
from chambers_tpu_torch.data import io as tio
from chambers_tpu_torch.data import native


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (24, 32, 3), np.uint8)
    gray = rng.randint(0, 256, (24, 32), np.uint8)
    Image.fromarray(rgb).save(d / "b.png")
    Image.fromarray(rgb).save(d / "a.jpg", quality=95)
    Image.fromarray(rgb).save(d / "c.bmp")
    Image.fromarray(gray).save(d / "gray.png")
    Image.fromarray(gray, mode="L").save(d / "gray.jpg", quality=90)
    frames = [Image.fromarray(rng.randint(0, 256, (24, 32, 3), np.uint8))
              for _ in range(3)]
    frames[0].save(d / "anim.gif", save_all=True, append_images=frames[1:])
    (d / "notes.txt").write_text("not an image")
    arr16 = (np.arange(24 * 32, dtype=np.uint32) * 7 % 65536).astype(
        np.uint16).reshape(24, 32)
    Image.fromarray(arr16).save(d / "deep.png")
    Image.fromarray(rgb).save(d / "actually_png.jpg", format="PNG")
    return d


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Six 16x24 JPEGs (uniform) and four of ragged heights."""
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(1)
    uniform, ragged = [], []
    for i in range(6):
        p = d / f"u{i}.jpg"
        Image.fromarray(rng.randint(0, 256, (16, 24, 3), np.uint8)).save(
            p, quality=90)
        uniform.append(str(p))
    for i in range(4):
        p = d / f"r{i}.jpg"
        Image.fromarray(rng.randint(0, 256, (8 + i, 24, 3), np.uint8)).save(
            p, quality=75)
        ragged.append(str(p))
    return uniform, ragged


@pytest.fixture
def decoder():
    if not native.available():
        pytest.skip("native decoder not buildable here (needs g++ and "
                    "libjpeg); the per-element path is the contract")
    return native


@pytest.fixture
def jax_decoder():
    """The JAX package's native decoder, which the comparisons below read.
    Every test worker imports ``tests/data/test_native_decode.py``, whose
    collection builds that decoder into one file of a shared cache; a
    worker whose build loses the race to another's keeps it marked as
    failed for the rest of its run, though the other worker's library is
    there. So where the library exists, or appears within a few seconds,
    clear the mark and load it again. A decoder that still cannot be
    loaded is handed over as it is, and the comparisons fail."""
    so_path = os.path.join(jnative._cache_dir(), "libfastjpeg.so")
    deadline = time.monotonic() + 10.0
    while not jnative.available() and time.monotonic() < deadline:
        time.sleep(0.2)
        if os.path.exists(so_path):
            jnative._LOAD_FAILED = False
    return jnative


def test_matching_equals_jax(image_dir, tmp_path):
    got = tio.match_img_files(str(image_dir))
    assert got == jio.match_img_files(str(image_dir))
    assert "notes.txt" not in {os.path.basename(f) for f in got}
    assert tio.validate_dir_path("a/b") == jio.validate_dir_path("a/b") == \
        "a/b/"
    assert tio.VALID_IMAGE_EXTENSIONS == jio.VALID_IMAGE_EXTENSIONS
    for sub in ("anchor", "positive", "negative"):
        (tmp_path / "t" / sub).mkdir(parents=True)
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
            tmp_path / "t" / sub / "x.png")
    assert tio.match_img_files_triplet(str(tmp_path / "t")) == \
        jio.match_img_files_triplet(str(tmp_path / "t"))
    assert sorted(tio.match_nested_set(str(tmp_path))) == sorted(
        jio.match_nested_set(str(tmp_path)))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("name", ["a.jpg", "b.png", "c.bmp", "gray.png",
                                  "gray.jpg", "anim.gif", "deep.png",
                                  "actually_png.jpg"])
def test_decode_equals_jax(image_dir, name, channels):
    got = tio.read_and_decode_image(str(image_dir / name), channels=channels)
    want = jio.read_and_decode_image(str(image_dir / name),
                                     channels=channels)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (24, 32, channels)
    assert np.array_equal(got, want)


def test_lossless_decodes_equal_pil(image_dir):
    for name in ("b.png", "c.bmp", "actually_png.jpg"):
        want = np.asarray(Image.open(image_dir / name).convert("RGB"))
        assert np.array_equal(tio.read_and_decode_image(
            str(image_dir / name)), want)


def test_batch_helpers_equal_jax_with_and_without_native(image_dir, jpegs):
    uniform, ragged = jpegs
    mixed = [uniform[0], str(image_dir / "b.png"), ragged[1]]
    for files in (uniform, ragged, mixed):
        got = tio.read_and_decode_images(files)
        want = jio.read_and_decode_images(files)
        assert len(got) == len(want) == len(files)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    for files in (uniform, [str(image_dir / "b.png")] * 2):
        got = tio.read_and_decode_image_batch(files)
        assert np.array_equal(got, jio.read_and_decode_image_batch(files))
        assert np.array_equal(got, np.stack(
            [tio.read_and_decode_image(f) for f in files]))


def test_url_to_img_decodes_what_urlopen_returns(image_dir, monkeypatch):
    """Nothing is fetched: ``urlopen`` is replaced by a reader of a file."""
    data = (image_dir / "b.png").read_bytes()

    class Response:
        def read(self):
            return data

    monkeypatch.setattr(tio, "urlopen", lambda request: Response())
    monkeypatch.setattr(jio, "urlopen", lambda request: Response())
    for channels in (1, 3):
        got = tio.url_to_img("http://example.invalid/b.png", channels)
        assert np.array_equal(got, jio.url_to_img(
            "http://example.invalid/b.png", channels))


def test_listing_cache_updates_when_the_dir_changes(tmp_path):
    arr = np.zeros((8, 8, 3), np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.jpg", quality=90)
    old = os.path.getmtime(tmp_path) - 10
    os.utime(tmp_path, (old, old))  # settled: cached
    first = tio.match_img_files(str(tmp_path))
    assert str(tmp_path) + "/" in tio._MATCH_CACHE
    first.append("mutated")  # a copy, not the cached list
    Image.fromarray(arr).save(tmp_path / "b.jpg", quality=90)
    assert [os.path.basename(f) for f in tio.match_img_files(
        str(tmp_path))] == ["a.jpg", "b.jpg"]
    tio.clear_match_cache()
    assert not tio._MATCH_CACHE


# --- the native decoder -----------------------------------------------------

def test_native_batch_equals_jax_and_pil(decoder, jax_decoder, jpegs):
    uniform, ragged = jpegs
    for files in (uniform, ragged):
        got = decoder.decode_jpeg_batch(files, num_threads=3)
        want = jax_decoder.decode_jpeg_batch(files, num_threads=3)
        for path, g, w in zip(files, got, want):
            assert np.array_equal(g, w)
            assert np.array_equal(g, np.asarray(
                Image.open(path).convert("RGB")))
    stacked = decoder.decode_jpeg_batch(uniform, stack=True)
    assert stacked.shape == (6, 16, 24, 3)
    assert np.array_equal(stacked, jax_decoder.decode_jpeg_batch(
        uniform, stack=True))
    assert np.array_equal(decoder.decode_jpeg(uniform[2]), stacked[2])


def test_native_grayscale_expands_to_rgb(decoder, jax_decoder, image_dir):
    got = decoder.decode_jpeg(str(image_dir / "gray.jpg"))
    assert np.array_equal(got, jax_decoder.decode_jpeg(str(image_dir /
                                                           "gray.jpg")))
    assert np.array_equal(got, np.asarray(
        Image.open(image_dir / "gray.jpg").convert("RGB")))


def test_native_ifast_equals_jax(decoder, jax_decoder, jpegs):
    uniform, _ = jpegs
    got = decoder.decode_jpeg_batch(uniform, dct_method="ifast")
    want = jax_decoder.decode_jpeg_batch(uniform, dct_method="ifast")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    with pytest.raises(ValueError, match="dct_method"):
        decoder.decode_jpeg_batch(uniform, dct_method="float")


def test_native_errors(decoder, jpegs, tmp_path):
    uniform, ragged = jpegs
    with pytest.raises(RuntimeError, match="header"):
        decoder.decode_jpeg_batch([str(tmp_path / "nope.jpg")])
    bad = tmp_path / "zeros.jpg"
    bad.write_bytes(b"\x00" * 512)
    with pytest.raises(RuntimeError, match="header"):
        decoder.decode_jpeg_batch([str(bad)])
    with pytest.raises(ValueError, match="uniform"):
        decoder.decode_jpeg_batch(ragged, stack=True)
    with pytest.raises(ValueError, match="at least one path"):
        decoder.decode_jpeg_batch([], stack=True)
    assert decoder.decode_jpeg_batch([]) == []


def test_native_stale_dims_cache_retries(decoder, jpegs):
    uniform, _ = jpegs
    decoder.decode_jpeg_batch([uniform[0]])
    key = os.fsencode(uniform[0])
    stamp, h, w = decoder._DIMS_CACHE[key]
    decoder._DIMS_CACHE[key] = (stamp, h + 8, w + 8)
    out = decoder.decode_jpeg_batch([uniform[0]])[0]
    assert np.array_equal(out, np.asarray(Image.open(uniform[0])
                                          .convert("RGB")))
    assert decoder._DIMS_CACHE[key][1:] == (h, w)


def test_native_library_is_built_into_the_checkout(decoder):
    """Built with g++ into ``build/`` under a name keyed by a hash of the
    source and the flags, with the compiler's report beside it."""
    from chambers_tpu_torch.ops import _build

    names = [p.name for p in _build.BUILD_DIR.glob("fastjpeg-*.so")]
    assert names
    log = (_build.BUILD_DIR / names[0]).with_suffix(".log").read_text()
    assert "g++" in log.splitlines()[0] and "-ljpeg" in log
    assert decoder.default_threads() >= 1
