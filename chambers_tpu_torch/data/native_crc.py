"""ctypes loader for the native CRC32C (``_native/crc32c.cpp``; port of
``chambers_tpu/data/native_crc.py``).

TFRecord framing checksums (``tfrecord.py``) are verified on every read;
the pure-Python table loop runs ~25 MB/s, far too slow for image records.
The native function uses the SSE4.2 ``crc32`` instruction where the CPU
has it, slice-by-8 tables otherwise. It is built at first use with
``g++`` into the checkout's ``build/``, as the JPEG decoder is
(:func:`chambers_tpu_torch.data.native.build_host_library`); pure Python
remains the fallback when no toolchain is present.
"""

from __future__ import annotations

import ctypes
import os
import threading

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                    "crc32c.cpp")
_LOCK = threading.Lock()
_LIB = None
_LOAD_FAILED = False


def _build_and_load():
    from chambers_tpu_torch.data.native import build_host_library

    lib = build_host_library("crc32c", _SRC)
    if lib is None:
        return None
    lib.chtpu_crc32c.restype = ctypes.c_uint32
    lib.chtpu_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
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


def crc32c(data: bytes) -> int:
    """Finalized CRC32C of ``data`` (init 0xFFFFFFFF, final xor) — the
    value tfrecord.py's ``_crc32c_py`` computes. ctypes releases the GIL
    for the call."""
    return int(_get_lib().chtpu_crc32c(data, len(data)))
