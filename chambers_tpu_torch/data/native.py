"""ctypes loader for the native batch JPEG decoder (``_native/fastjpeg.cpp``;
port of ``chambers_tpu/data/native.py``).

The shared library is compiled at first use with the system toolchain
(``g++ -O3 -shared -fPIC -std=c++17 ... -ljpeg -lpthread``) into the
checkout's ``build/``, under a name keyed by a hash of the source and the
flags (``chambers_tpu_torch.ops._build.compile_library``), then loaded
through ctypes: the C ABI and ctypes are the binding layer.

Public surface:

- :func:`available` — whether the native decoder could be built/loaded
  (it needs ``g++`` and libjpeg's headers and library).
- :func:`decode_jpeg` — one file → uint8 ``[h, w, 3]`` RGB array.
- :func:`decode_jpeg_batch` — N files decoded by a C thread pool (the GIL
  is released for the whole batch; Python threads never see per-element
  work). Linked against the system libjpeg-turbo, as PIL is, so its output
  is byte-identical to the PIL path (``tests/test_torch_data_io.py``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional, Sequence

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                    "fastjpeg.cpp")
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LIB = None
_LOAD_FAILED = False


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native decoders build with it")
    return found


def build_host_library(name: str, source: str, libraries=()):
    """Build ``source`` with ``g++`` into ``build/`` (unless built) and load
    it; None when it cannot be built or loaded (no ``g++``, no library to
    link), so callers fall back to their Python path."""
    from chambers_tpu_torch.ops._build import compile_library

    try:
        return ctypes.CDLL(str(compile_library(name, [source], HOST_FLAGS,
                                               _gxx, libraries)))
    except (OSError, RuntimeError):
        return None


def _build_and_load():
    """Compile (if not built) and dlopen the shared library; None on
    failure."""
    lib = build_host_library("fastjpeg", _SRC, ["-ljpeg", "-lpthread"])
    if lib is None:
        return None
    lib.cj_jpeg_dims.restype = ctypes.c_int
    lib.cj_jpeg_dims.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.cj_decode_into.restype = ctypes.c_int
    lib.cj_decode_into.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.cj_decode_batch.restype = ctypes.c_int
    lib.cj_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    return lib


def _get_lib():
    global _LIB, _LOAD_FAILED
    if _LIB is None and not _LOAD_FAILED:
        with _LOCK:
            if _LIB is None and not _LOAD_FAILED:
                _LIB = _build_and_load()
                _LOAD_FAILED = _LIB is None
    return _LIB


def available() -> bool:
    return _get_lib() is not None


def default_threads() -> int:
    """The decode threads of a batch call: the usable cores, at most 32."""
    from chambers_tpu_torch.utils.generic import effective_cpu_count

    return min(effective_cpu_count(), 32)


def decode_jpeg(path) -> np.ndarray:
    """Decode one JPEG to an RGB uint8 ``[h, w, 3]`` array (native)."""
    return decode_jpeg_batch([path])[0]


# path -> (mtime_ns, size, h, w). Probing dimensions costs a full file read
# + header parse per image (~8% of the decode); in a repeats=-1 training
# pipeline the same files are re-decoded every epoch, so a stat-validated
# cache turns the probe into one syscall from epoch 2 on. A stale entry
# (file rewritten within a timestamp tick with different dims) is caught by
# the decoder itself: cj_decode_into re-checks dims and returns -3, which
# triggers a re-probe + one retry below.
_DIMS_CACHE: dict = {}
_DIMS_CACHE_MAX = 1 << 20


def clear_dims_cache():
    _DIMS_CACHE.clear()


def _fast_dct(dct_method: str) -> int:
    if dct_method not in ("islow", "ifast"):
        raise ValueError(f"dct_method must be 'islow' or 'ifast', "
                         f"got {dct_method!r}")
    return int(dct_method == "ifast")


def _probe_dims(lib, encoded_path, display_path):
    try:
        st = os.stat(encoded_path)
        stamp = (st.st_mtime_ns, st.st_size)
    except OSError:
        stamp = None
    if stamp is not None:
        hit = _DIMS_CACHE.get(encoded_path)
        if hit is not None and hit[0] == stamp:
            return hit[1], hit[2]
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.cj_jpeg_dims(encoded_path, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise RuntimeError(
            f"cannot read JPEG header of {display_path!r} (code {rc})")
    if stamp is not None:
        if len(_DIMS_CACHE) >= _DIMS_CACHE_MAX:
            _DIMS_CACHE.clear()
        _DIMS_CACHE[encoded_path] = (stamp, h.value, w.value)
    return h.value, w.value


def decode_jpeg_batch(paths: Sequence, num_threads: Optional[int] = None,
                      stack: bool = False, dct_method: str = "islow",
                      _retry: bool = True):
    """Decode JPEG files with the native thread pool.

    :param stack: with uniform image dimensions, decode straight into ONE
        ``[n, h, w, 3]`` batch buffer and return it — no per-image arrays,
        no ``np.stack`` copy afterwards. Raises ValueError if dims differ.
    :param dct_method: ``"islow"`` (default; byte-identical to the PIL
        path) or ``"ifast"`` (libjpeg's fast integer DCT — what
        ``tf.io.decode_jpeg`` defaults to, ~10% faster, ±few LSB pixel
        differences).
    :raises RuntimeError: if the native library is unavailable or any file
        fails to decode (fall back to ``io.read_and_decode_image`` for
        non-JPEG inputs).
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(
            "native JPEG decoder unavailable (no g++/libjpeg at build "
            "time?) — use chambers_tpu_torch.data.io.read_and_decode_image"
        )
    fast_dct = _fast_dct(dct_method)
    n = len(paths)
    if n == 0:
        if stack:
            raise ValueError(
                "decode_jpeg_batch(stack=True) needs at least one path: the "
                "batch dims [n, h, w, 3] are unknowable for an empty list"
            )
        return []
    encoded = [os.fsencode(os.fspath(p)) for p in paths]
    c_paths = (ctypes.c_char_p * n)(*encoded)
    hs = (ctypes.c_int * n)()
    ws = (ctypes.c_int * n)()
    for i, p in enumerate(encoded):
        hs[i], ws[i] = _probe_dims(lib, p, paths[i])

    if stack:
        h0, w0 = hs[0], ws[0]
        for i in range(n):
            if hs[i] != h0 or ws[i] != w0:
                raise ValueError(
                    f"stack=True requires uniform dimensions; "
                    f"{os.fspath(paths[i])!r} is {hs[i]}x{ws[i]}, "
                    f"expected {h0}x{w0}")
        batch = np.empty((n, h0, w0, 3), np.uint8)
        stride = h0 * w0 * 3
        base = batch.ctypes.data
        outs = (ctypes.c_void_p * n)(*[base + i * stride for i in range(n)])
        arrays = batch
    else:
        arrays = [np.empty((hs[i], ws[i], 3), np.uint8) for i in range(n)]
        outs = (ctypes.c_void_p * n)(*[arr.ctypes.data for arr in arrays])
    results = (ctypes.c_int * n)()
    failures = lib.cj_decode_batch(
        c_paths, outs, hs, ws, results, n,
        num_threads if num_threads else default_threads(), fast_dct,
    )
    if failures:
        stale = [i for i in range(n) if results[i] == -3]
        if stale and _retry:
            # file mutated under the dims cache — drop and re-probe once
            for i in stale:
                _DIMS_CACHE.pop(encoded[i], None)
            return decode_jpeg_batch(paths, num_threads=num_threads,
                                     stack=stack, dct_method=dct_method,
                                     _retry=False)
        bad = [(os.fspath(paths[i]), results[i]) for i in range(n)
               if results[i] != 0]
        raise RuntimeError(f"native JPEG decode failed for {bad}")
    return arrays
