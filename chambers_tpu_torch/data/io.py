"""Image file matching and decoding on the host (port of
``chambers_tpu/data/io.py``).

File matching reproduces ``tf.io.matching_files`` over per-extension
patterns: results are grouped by extension in ``VALID_IMAGE_EXTENSIONS``
order, sorted within each pattern. Decoding uses OpenCV or PIL, dispatched
as in the JAX package, so both packages decode a file to the same bytes.
"""

import glob
import os
import time
from io import BytesIO
from urllib.request import Request, urlopen

import numpy as np

VALID_IMAGE_EXTENTIONS = [
    "jpg", "jpeg", "png", "bmp", "gif",
    "JPG", "JPEG", "PNG", "BMP", "GIF",
]
# Keep the JAX package's (misspelled) public name and a corrected alias.
VALID_IMAGE_EXTENSIONS = VALID_IMAGE_EXTENTIONS


def validate_dir_path(dir_path):
    """Ensure ``dir_path`` ends with ``/``."""
    if not dir_path.endswith("/"):
        dir_path = dir_path + "/"
    return dir_path


def match_nested_set(path):
    """Glob the class subdirectories of ``path``."""
    return glob.glob(os.path.join(path, "*/"))


# Directory-listing cache for match_img_files, validated by the directory's
# mtime (one stat syscall instead of 10 glob patterns over the entry list).
# Interleave pipelines re-glob every class dir once per epoch refill —
# measured ~9% of the whole single-core input pipeline (tf.data pays the
# same listing in C++). A file added/removed/renamed in the directory bumps
# its mtime and invalidates the entry; file *content* changes don't matter
# (only names are listed).
_MATCH_CACHE: dict = {}
_MATCH_CACHE_MAX = 65536


def clear_match_cache():
    """Drop all cached directory listings (match_img_files)."""
    _MATCH_CACHE.clear()


def match_img_files(dir_path):
    """All image files in a directory, grouped by extension pattern, each
    group sorted (tf.io.matching_files semantics).

    :return: list of file-path strings.
    """
    dir_path = str(dir_path)
    if not dir_path.endswith("/"):
        dir_path = dir_path + "/"
    try:
        mtime = os.stat(dir_path).st_mtime_ns
    except OSError:
        mtime = None
    if mtime is not None:
        hit = _MATCH_CACHE.get(dir_path)
        if hit is not None and hit[0] == mtime:
            return list(hit[1])
    files = []
    for ext in VALID_IMAGE_EXTENTIONS:
        files.extend(sorted(glob.glob(dir_path + f"*.{ext}")))
    # Only cache "settled" directories (mtime ≥2s old): filesystem mtime has
    # coarse tick granularity, so a file added in the same tick as this
    # listing would otherwise leave an undetectably stale entry. A directory
    # being written right now is re-listed every call (correct, and what the
    # uncached code always did); a static training set caches from the
    # second epoch on.
    if mtime is not None and time.time_ns() - mtime >= 2_000_000_000:
        if len(_MATCH_CACHE) >= _MATCH_CACHE_MAX:
            _MATCH_CACHE.clear()
        _MATCH_CACHE[dir_path] = (mtime, files)
    return list(files)


def match_img_files_triplet(dir_path):
    """Image files of the ``anchor/``, ``positive/``, ``negative/`` subdirs.

    :return: (anchor_files, positive_files, negative_files) lists.
    """
    dir_path = str(dir_path)
    if not dir_path.endswith("/"):
        dir_path = dir_path + "/"
    return (
        match_img_files(dir_path + "anchor"),
        match_img_files(dir_path + "positive"),
        match_img_files(dir_path + "negative"),
    )


_HAS_CV2 = None


def _cv2_available():
    global _HAS_CV2
    if _HAS_CV2 is None:
        try:
            import cv2  # noqa: F401

            _HAS_CV2 = True
        except ImportError:
            _HAS_CV2 = False
    return _HAS_CV2


def _is_jpeg(path):
    """Sniff the JPEG SOI marker (FFD8) — content, not extension."""
    try:
        with open(path, "rb") as f:
            return f.read(2) == b"\xff\xd8"
    except OSError:
        return False


def read_and_decode_image(file, channels=3):
    """Read + decode an image file to a uint8 ``[h, w, channels]`` array.

    Supports png/jpeg/bmp/gif (first frame, as
    ``tf.image.decode_image(expand_animations=False)``). JPEGs decode through OpenCV's C++ loader
    when available (~20% faster than PIL on libjpeg-turbo) with
    EXIF auto-rotation disabled (neither PIL here nor
    ``tf.io.decode_jpeg`` applies orientation tags); everything else — and
    the L/RGBA channel requests — takes the PIL path, so formats where the
    two libraries disagree (16-bit PNGs: cv2 keeps the high byte, PIL
    clips) decode identically with or without cv2 installed. Dispatch is by
    content (the JPEG FFD8 magic), not extension, so a mislabeled ``.jpg``
    can't silently take a divergent decoder. Note: cv2 and PIL JPEG output
    can differ by ±1 LSB depending on the libjpeg build, so pixel values are
    install-dependent on the fast path; ``tests/test_torch_data_io.py``
    holds both packages to the same bytes on one install.
    """
    path = os.fspath(file)
    # cv2 availability first: without it the magic-byte sniff would add a
    # wasted open()+read per element on the map hot path
    if channels == 3 and _cv2_available() and _is_jpeg(path):
        try:
            import cv2

            # decode straight to RGB when cv2 supports it (OpenCV >= 4.10);
            # else cvtColor — both in C++. A numpy [..., ::-1] copy here
            # costs more than 1 ms per 500x375 image (a third of the whole
            # decode), dominating the Python-side overhead vs tf.data.
            if hasattr(cv2, "IMREAD_COLOR_RGB"):
                img = cv2.imread(
                    path,
                    cv2.IMREAD_COLOR_RGB | cv2.IMREAD_IGNORE_ORIENTATION,
                )
                if img is not None:
                    return img
            else:
                img = cv2.imread(
                    path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
                )
                if img is not None:
                    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        except ImportError:
            pass

    from PIL import Image

    with Image.open(path) as img:
        if getattr(img, "is_animated", False):
            img.seek(0)
        if channels == 3:
            img = img.convert("RGB")
        elif channels == 1:
            img = img.convert("L")
        elif channels == 4:
            img = img.convert("RGBA")
        arr = np.asarray(img, np.uint8)
    if channels == 1 and arr.ndim == 2:
        arr = arr[..., None]
    return arr


def read_and_decode_images(files, channels=3, num_threads=None):
    """Decode a batch of image files → list of uint8 ``[h, w, c]`` arrays.

    RGB JPEG batches route through the native C++ decoder
    (``chambers_tpu_torch.data.native``: libjpeg + pthread pool, GIL released for
    the whole batch — byte-identical to the PIL path); anything else falls
    back to per-element :func:`read_and_decode_image`. Use after an early
    ``Dataset.batch`` to amortize per-element Python overhead::

        ds.batch(16).map(lambda f, y: (io.read_and_decode_images(f), y))
    """
    files = list(files)
    if channels == 3 and files:
        from chambers_tpu_torch.data import native

        if native.available():
            try:
                # no per-file magic sniff needed: the batch call probes every
                # header before decoding anything, so a non-JPEG in the batch
                # fails fast and cheap into the per-element fallback
                return native.decode_jpeg_batch(files,
                                                num_threads=num_threads)
            except RuntimeError:
                pass  # non-JPEG / odd colorspace — per-element fallback below
    return [read_and_decode_image(f, channels=channels) for f in files]


def read_and_decode_image_batch(files, channels=3, num_threads=None):
    """Decode a uniform-size batch straight into ONE ``[B, h, w, c]`` array.

    The native decoder writes each image directly into its slice of the
    batch buffer (``stack=True``), so no per-image arrays or ``np.stack``
    copy exist; non-JPEG / no-native / ragged batches fall back to
    per-element decode + ``np.stack`` (same output, one extra copy).
    This is the fused ``decode → batch`` hot path used by the dataset
    constructors' ``.batch()`` (``data/dataset.py``).
    """
    files = list(files)
    if channels == 3 and files:
        from chambers_tpu_torch.data import native

        if native.available():
            try:
                return native.decode_jpeg_batch(files, num_threads=num_threads,
                                                stack=True)
            except (RuntimeError, ValueError):
                pass  # non-JPEG / odd colorspace / ragged dims — fallback
    return np.stack(
        [read_and_decode_image(f, channels=channels) for f in files])


def open_url(url):
    headers = {
        "User-Agent": "Mozilla/5.0 (Windows NT 6.1) AppleWebKit/537.36 "
                      "(KHTML, like Gecko) Chrome/41.0.2228.0 Safari/537.3"
    }
    return urlopen(Request(url, headers=headers))


def read_url_bytes(url):
    return open_url(url).read()


def url_to_img(url, channels=3):
    """Fetch an image over HTTP and decode it."""
    from PIL import Image

    img = Image.open(BytesIO(read_url_bytes(url)))
    if channels == 3:
        img = img.convert("RGB")
    elif channels == 1:
        img = img.convert("L")
    arr = np.asarray(img, np.uint8)
    if channels == 1 and arr.ndim == 2:
        arr = arr[..., None]
    return arr
