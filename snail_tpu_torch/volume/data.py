"""Volume data container and loaders (``snail_tpu.volume.data``, a NumPy
copy held equal to it by ``tests/test_torch_volume.py``): the rebuild of
src/volume_data.* and the DICOM slice loading of src/dicom_viewer.cpp.

The minimal DICOM reader handles what CT slice stacks actually use:
explicit- and implicit-VR little-endian, uncompressed 16-bit pixel data
(tag 7FE0,0010), rows/cols (0028,0010/0011), pixel spacing (0028,0030),
slice location (0020,1041). It needs no DICOM library: the reference
parses DICOM by hand too.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class VolumeData:
    """u16 voxel volume (reference VolumeData: u16 data + dims)."""

    data: np.ndarray            # [D, H, W] u16
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # z, y, x

    @property
    def shape(self):
        return self.data.shape


def load_raw(path: str, shape: Tuple[int, int, int],
             dtype=np.uint16) -> VolumeData:
    data = np.fromfile(path, dtype=dtype).reshape(shape)
    return VolumeData(data=data.astype(np.uint16))


# ---------------------------------------------------------------------------
# Minimal DICOM parser
# ---------------------------------------------------------------------------

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}


def _parse_dicom(buf: bytes) -> dict:
    """Returns {(group, elem): bytes} for top-level tags."""
    tags = {}
    pos = 0
    if len(buf) > 132 and buf[128:132] == b"DICM":
        pos = 132
    explicit = None
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        if explicit is None:
            # sniff VR: two uppercase letters -> explicit
            vr = buf[pos:pos + 2]
            explicit = vr.isalpha() and vr.isupper()
        if explicit:
            vr = buf[pos:pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                (length,) = struct.unpack_from("<I", buf, pos + 4)
                pos += 8
            else:
                (length,) = struct.unpack_from("<H", buf, pos + 2)
                pos += 4
        else:
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4
        if length == 0xFFFFFFFF:  # undefined length (sequences) — skip
            break
        tags[(group, elem)] = buf[pos:pos + length]
        pos += length
    return tags


def load_dicom_file(path: str) -> Tuple[np.ndarray, dict]:
    """One slice -> ([H, W] u16 pixels, meta dict)."""
    with open(path, "rb") as f:
        buf = f.read()
    tags = _parse_dicom(buf)
    rows = struct.unpack("<H", tags[(0x0028, 0x0010)][:2])[0]
    cols = struct.unpack("<H", tags[(0x0028, 0x0011)][:2])[0]
    pix = np.frombuffer(tags[(0x7FE0, 0x0010)][: rows * cols * 2],
                        np.uint16).reshape(rows, cols)
    meta = {}
    if (0x0028, 0x0030) in tags:
        sp = tags[(0x0028, 0x0030)].decode(errors="replace").split("\\")
        meta["pixel_spacing"] = (float(sp[0]), float(sp[1]))
    if (0x0020, 0x1041) in tags:
        meta["slice_location"] = float(
            tags[(0x0020, 0x1041)].decode(errors="replace"))
    return pix.copy(), meta


def load_dicom_dir(path: str) -> VolumeData:
    """Stack every parseable DICOM slice in a directory, ordered by slice
    location when present (dicom_viewer.cpp load loop)."""
    slices: List[Tuple[float, np.ndarray]] = []
    sy = sx = 1.0
    for i, name in enumerate(sorted(os.listdir(path))):
        p = os.path.join(path, name)
        if not os.path.isfile(p):
            continue
        try:
            pix, meta = load_dicom_file(p)
        except Exception:
            continue
        loc = meta.get("slice_location", float(i))
        if "pixel_spacing" in meta:
            sy, sx = meta["pixel_spacing"]
        slices.append((loc, pix))
    if not slices:
        raise ValueError(f"no DICOM slices in {path}")
    slices.sort(key=lambda t: t[0])
    locs = [l for l, _ in slices]
    sz = (abs(locs[-1] - locs[0]) / max(len(locs) - 1, 1)) or 1.0
    vol = np.stack([s for _, s in slices])
    return VolumeData(data=vol.astype(np.uint16), spacing=(sz, sy, sx))


def write_dicom_file(path: str, pixels: np.ndarray,
                     slice_location: float = 0.0,
                     pixel_spacing=(1.0, 1.0)) -> None:
    """Tiny explicit-VR LE writer for tests (synthetic fixtures only)."""
    h, w = pixels.shape
    out = bytearray(b"\x00" * 128 + b"DICM")

    def tag(group, elem, vr, val: bytes):
        out.extend(struct.pack("<HH", group, elem))
        if vr in (b"OB", b"OW"):
            out.extend(vr + b"\x00\x00" + struct.pack("<I", len(val)))
        else:
            out.extend(vr + struct.pack("<H", len(val)))
        out.extend(val)

    loc = f"{slice_location:.4f}".encode()
    if len(loc) % 2:
        loc += b" "
    sp = f"{pixel_spacing[0]:.4f}\\{pixel_spacing[1]:.4f}".encode()
    if len(sp) % 2:
        sp += b" "
    tag(0x0020, 0x1041, b"DS", loc)
    tag(0x0028, 0x0010, b"US", struct.pack("<H", h))
    tag(0x0028, 0x0011, b"US", struct.pack("<H", w))
    tag(0x0028, 0x0030, b"DS", sp)
    tag(0x7FE0, 0x0010, b"OW",
        np.ascontiguousarray(pixels, np.uint16).tobytes())
    with open(path, "wb") as f:
        f.write(bytes(out))


def synthetic_sphere(n: int = 64, radius: float = 0.35,
                     value: int = 4000) -> VolumeData:
    """Test volume: a dense sphere in empty space."""
    g = (np.arange(n) + 0.5) / n - 0.5
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    vol = np.where(x * x + y * y + z * z < radius * radius, value, 0)
    return VolumeData(data=vol.astype(np.uint16))
