"""Tile codec: planar RGB-delta transform + LZ byte compression; a copy of
``snail_tpu.net.codec`` (the same bytes for the same tile).

Rebuild of the reference's tile pipeline (render.cpp:157-163 planar
RGB-delta; extern/quicklz + compression.cpp for the byte codec;
negative size = uncompressed passthrough, compression.cpp:50-78).

The byte codec is the native C++ LZSS of the repository's
``native/codec.cpp``, the JAX package's source, compiled at first use
with g++ into ``snail_tpu_torch/build/`` (gitignored) and loaded through
ctypes. When no compiler or .so is available, it falls back to zlib: the
wire format stays the same, because the part header tags which codec
wrote a payload.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import zlib
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "codec.cpp")
_BUILD = os.path.join(_PKG, "build")

CODEC_RAW = 0
CODEC_LZ = 1
CODEC_ZLIB = 2

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lib_lock = threading.Lock()


def _so_path() -> str:
    """The build's path, keyed on a hash of the source, so a stale or
    tampered binary can never shadow the current codec.cpp (mtimes are
    unreliable after checkout). Never a repo file: the build directory is
    gitignored."""
    import hashlib

    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD, exist_ok=True)
    return os.path.join(_BUILD, f"libsnailcodec-{h}.so")


def _load() -> Optional[ctypes.CDLL]:
    # one thread builds and binds; another (a server's encoder beside its
    # client's decoder) waits for it rather than take the zlib path
    global _lib, _lib_tried
    with _lib_lock:
        if not _lib_tried:
            _lib = _build_and_bind()
            _lib_tried = True
    return _lib


def _build_and_bind() -> Optional[ctypes.CDLL]:
    try:
        so = _so_path()
        if not os.path.exists(so):
            # built under a name of its own, then moved into place: several
            # processes (test workers) may build at once, and none may load
            # a half-written library
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(so)
        for fn in ("snail_compress", "snail_decompress"):
            getattr(lib, fn).restype = ctypes.c_long
            getattr(lib, fn).argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ]
        for fn in ("snail_rgb_delta", "snail_rgb_undelta"):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint8),
            ]
        return lib
    except Exception:
        return None


def native_available() -> bool:
    return _load() is not None


def _as_u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def compress(data: bytes) -> tuple[int, bytes]:
    """Returns (codec_id, payload). Falls back to raw if incompressible
    (the reference's negative-size path, compression.cpp:50-78)."""
    lib = _load()
    if lib is not None:
        cap = len(data) + len(data) // 8 + 64
        dst = np.empty(cap, np.uint8)
        n = lib.snail_compress(data, len(data), _as_u8ptr(dst), cap)
        if 0 < n < len(data):
            return CODEC_LZ, dst[:n].tobytes()
        return CODEC_RAW, data
    z = zlib.compress(data, 1)
    if len(z) < len(data):
        return CODEC_ZLIB, z
    return CODEC_RAW, data


def decompress(codec_id: int, payload: bytes, raw_len: int) -> bytes:
    if codec_id == CODEC_RAW:
        return payload
    if codec_id == CODEC_ZLIB:
        return zlib.decompress(payload)
    if codec_id == CODEC_LZ:
        lib = _load()
        if lib is None:
            raise RuntimeError("native codec unavailable for CODEC_LZ data")
        dst = np.empty(raw_len, np.uint8)
        n = lib.snail_decompress(payload, len(payload), _as_u8ptr(dst),
                                 raw_len)
        if n != raw_len:
            raise ValueError(f"corrupt LZ stream ({n} != {raw_len})")
        return dst.tobytes()
    raise ValueError(f"unknown codec {codec_id}")


def rgb_delta(rgb8: np.ndarray) -> np.ndarray:
    """[H, W, 3] u8 -> planar (3, H*W) u8 with G/B as deltas from R
    (render.cpp:157-163)."""
    flat = np.ascontiguousarray(rgb8.reshape(-1, 3), np.uint8)
    npix = flat.shape[0]
    out = np.empty(3 * npix, np.uint8)
    lib = _load()
    if lib is not None:
        lib.snail_rgb_delta(_as_u8ptr(flat), npix, _as_u8ptr(out))
    else:
        r = flat[:, 0]
        out[:npix] = r
        out[npix:2 * npix] = flat[:, 1] - r
        out[2 * npix:] = flat[:, 2] - r
    return out


def rgb_undelta(planar: np.ndarray, h: int, w: int) -> np.ndarray:
    npix = h * w
    planar = np.ascontiguousarray(planar, np.uint8)
    rgb = np.empty(npix * 3, np.uint8)
    lib = _load()
    if lib is not None:
        lib.snail_rgb_undelta(_as_u8ptr(planar), npix, _as_u8ptr(rgb))
    else:
        r = planar[:npix]
        rgb[0::3] = r
        rgb[1::3] = planar[npix:2 * npix] + r
        rgb[2::3] = planar[2 * npix:] + r
    return rgb.reshape(h, w, 3)


def encode_tile(rgb8: np.ndarray) -> tuple[int, int, bytes]:
    """-> (codec_id, raw_len, payload) for one [h, w, 3] u8 tile."""
    planar = rgb_delta(rgb8)
    data = planar.tobytes()
    cid, payload = compress(data)
    return cid, len(data), payload


def decode_tile(cid: int, raw_len: int, payload: bytes, h: int,
                w: int) -> np.ndarray:
    planar = np.frombuffer(decompress(cid, payload, raw_len), np.uint8)
    return rgb_undelta(planar, h, w)
