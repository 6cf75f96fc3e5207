"""Build and bind the CUDA kernels of ``snail_tpu_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
source, all started together, and linked into a shared library with a
plain C interface, loaded with ``ctypes``. The build goes
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
SOURCES = ("worklist.cu", "walk.cu", "fat.cu", "volume.cu", "shade.cu")
# included by the sources; part of the build's hash
HEADERS = ("rays.cuh", "walk.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # products and sums rounded one by one, as in the plain versions
    "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_SIGNATURES = {
    "snail_words_camera": [_P] * 3 + [_I] * 5 + [_P] * 4,
    "snail_words_shared": [_P] * 7 + [_I] * 5 + [_P] * 4,
    "snail_camera_wl": [_P] * 5 + [_I] + [_P] * 3 + [_I] * 2 + [_P] * 9,
    "snail_shadow_wl": [_P] * 11 + [_I] + [_P] * 3 + [_I] * 2 + [_P] * 3,
    "snail_words_general": [_P] * 9 + [_I] * 5 + [_P] * 4,
    "snail_closest_wl_g": [_P] * 14 + [_I] + [_P] * 3 + [_I] * 2 + [_P] * 5,
    "snail_shadow_wl_g": [_P] * 14 + [_I] + [_P] * 3 + [_I] * 2 + [_P] * 2,
    "snail_walk_camera": [_P] * 3 + [_I] * 4 + [_P] * 9,
    "snail_walk_shadow": [_P] * 7 + [_I] * 4 + [_P] * 3,
    "snail_walk_closest_g": [_P] * 9 + [_I] * 4 + [_P] * 5,
    "snail_walk_shadow_g": [_P] * 9 + [_I] * 4 + [_P] * 2,
    "snail_fat_camera": [_P] * 4 + [_I] * 4 + [_P] * 8,
    "snail_fat_closest": [_P] * 10 + [_I] * 4 + [_P] * 5,
    "snail_fat_shadow": [_P] * 8 + [_I] * 4 + [_P] * 2,
    "snail_fat_shadow_g": [_P] * 10 + [_I] * 4 + [_P] * 2,
    "snail_march": [_P] * 5 + [_I] + [_P] * 3 + [_F] + [_I] * 6
    + [_P] * 6,
    "snail_march_mip_extra": [_P] * 5 + [_I, _P] + [_I] * 4 + [_P] * 5,
    "snail_surface_gather": [_P, _I, _P, _P, _I, _U, _P, _P],
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
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libsnail_kernels_{_digest()}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if their library is missing: every source at
    once, each by its own ``nvcc``, then one link. Returns (path, seconds
    spent compiling). The compiler output, with ptxas's register and
    shared-memory report, is kept beside the library as ``.log``."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{name}.o" for name in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)]
        texts = [f"== {name}\n{proc.communicate()[0]}"
                 for name, proc in zip(SOURCES, procs)]
        failed = [proc.returncode for proc in procs if proc.returncode]
        if not failed:
            so = Path(tmp) / "lib.so"
            res = subprocess.run([nvcc, "-shared", "-o", str(so),
                                  *map(str, objs)],
                                 capture_output=True, text=True)
            texts.append(f"== link\n{res.stdout}{res.stderr}")
            failed = [res.returncode] if res.returncode else []
        text = "".join(texts)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{text}")
        log.write_text(text)
        os.replace(so, out)
    return out, time.perf_counter() - t0


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
