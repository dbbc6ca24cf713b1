"""Build the port's CUDA sources with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes``.

The library is built at first use into ``build/`` at the root of the
checkout, under a name keyed by a hash of the sources and the flags, so an
edited source rebuilds and an unchanged one loads at once. Only sources in
the repository are compiled. ``--fmad=false`` keeps every float multiply
rounded on its own, as the JAX package's blends require. ``nvcc``'s
register and spill report (``-Xptxas -v``) is kept beside the library as
``<name>-<hash>.log``.
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
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def build(name: str, sources) -> Path:
    """Compile ``sources`` (names under ``csrc/``) into
    ``build/<name>-<hash>.so`` unless it exists; return its path. The
    compiler's report goes beside it as ``.log``."""
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"\n[{time.perf_counter() - t0:.1f} s, exit {proc.returncode}]\n")
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load(name: str, sources) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name, sources)))

