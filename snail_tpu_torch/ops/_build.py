"""Build and bind the CUDA kernels of ``snail_tpu_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The build goes
to ``snail_tpu_torch/build/`` (listed in ``.gitignore``) at first use, named
by a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing is built when the package is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("worklist.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # products and sums rounded one by one, as in the plain versions
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "snail_words_camera": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "snail_words_shared": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                           _P, _P],
    "snail_camera_wl": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P,
                        _P, _P, _P, _P, _P, _P],
    "snail_shadow_wl": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                        _I, _I, _P, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of snail_tpu_torch "
                       "are built with the CUDA toolkit at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libsnail_kernels_{_digest()}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if their library is missing. Returns (path,
    seconds spent compiling). The compiler output, with ptxas's register
    and shared-memory report, is kept beside the library as ``.log``."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(CSRC / name) for name in SOURCES]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    text = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{text}")
    log.write_text(text)
    os.replace(tmp, out)
    return out, secs


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes set
    for every entry point."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib
