"""Build the port's CUDA sources with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes``.

The library is built at first use into ``build/`` at the root of the
checkout, under a name keyed by a hash of the sources and the flags, so an
edited source rebuilds and an unchanged one loads at once. Only sources in
the repository are compiled. Flags are per library: ``NVCC_FLAGS`` holds
``--fmad=false``, which keeps every float multiply rounded on its own, as
the JAX package's image blends require (the ``warp`` library);
``FMA_FLAGS`` is the same list without it, for kernels whose inner products
are FMAs or tensor-core products (the ``flash_attention`` library).
``--threads 0`` lets ``nvcc`` compile a library's sources side by side. Its
register and spill report (``-Xptxas -v``) is kept beside the library as
``<name>-<hash>.log``. The host input pipeline's C++ sources
(``chambers_tpu_torch/data/_native``) build the same way with ``g++``
(:func:`compile_library`).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--threads", "0", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
FMA_FLAGS = [f for f in NVCC_FLAGS if f != "--fmad=false"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def build(name: str, sources, flags=None) -> Path:
    """Compile ``sources`` (names under ``csrc/``) with ``flags``
    (``NVCC_FLAGS`` if None) into ``build/<name>-<hash>.so`` unless it
    exists; return its path. The compiler's report goes beside it as
    ``.log``. A ``.cuh`` among the sources is a header the others include:
    it counts in the hash and is not handed to the compiler."""
    flags = NVCC_FLAGS if flags is None else list(flags)
    return compile_library(name, [CSRC / s for s in sources], flags, _nvcc)


def compile_library(name: str, paths, flags, compiler, libraries=()) -> Path:
    """Compile the source files ``paths`` with ``compiler()`` (a function
    that returns the compiler's path, called only when a build is needed)
    and ``flags``, linking ``libraries``, into ``build/<name>-<hash>.so``
    unless it exists, the hash taken over the sources, the flags and the
    libraries; return its path. The compiler's report goes beside it as
    ``.log``; a failed build raises ``RuntimeError`` with it. The host
    input pipeline builds its C++ sources with ``g++`` through this too
    (``chambers_tpu_torch.data.native``)."""
    digest = hashlib.sha256(" ".join([*flags, *libraries]).encode())
    for p in paths:
        digest.update(Path(p).read_bytes())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *flags, "-o", str(tmp),
           *(str(p) for p in paths if Path(p).suffix != ".cuh"), *libraries]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"\n[{time.perf_counter() - t0:.1f} s, exit {proc.returncode}]\n")
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cmd[0]).name} failed building {name}:\n"
                           f"{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load(name: str, sources, flags=None) -> ctypes.CDLL:
    """Build if needed and load; every library exports
    ``cuda_error_string(int) -> const char*`` for :func:`check_launch`."""
    lib = ctypes.CDLL(str(build(name, sources, flags)))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def ptr(tensor) -> ctypes.c_void_p:
    """A tensor's address as a launcher argument; None is a null pointer."""
    return ctypes.c_void_p(None if tensor is None else tensor.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device`` as a launcher argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(lib, code, name):
    """Raise if a launcher returned anything but ``cudaSuccess``: a refused
    launch never runs and a later synchronize does not report it."""
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code} "
                           f"({lib.cuda_error_string(code).decode()})")

