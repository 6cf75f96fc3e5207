"""Desperados 2 ``.v3o`` mesh loader — rebuild of the reference's
``LoadV3O`` (src/formats/desperados2.cpp:66-187), a NumPy copy of
``snail_tpu.scene.desperados2``.

Format (line-oriented, tokens split on spaces AND commas, ``//`` comments):

- ``D x y z ...``       vertex; stored as ``(x, -z, y) * scale`` with
  ``scale = user_scale * 0.001`` (desperados2.cpp:100-104).
- ``SRF name _ _ _ tex _ _ _ _ _ twoSided`` material: only the name,
  texture and the two-sided flag are read (desperados2.cpp:106-109).
- ``P 3 a b c _ _ _ _ mat`` polygon: 1-based vertex ids offset by the
  running ``idxAdd``; two-sided materials emit a second flipped triangle
  (desperados2.cpp:110-121).
- ``TLS n i0 i1 i2 ...`` triangle list of ``n/3`` triples
  (desperados2.cpp:122-129).
- ``HMAP file``         binary heightmap: u16 width, u16 height, 15 skip
  bytes, u16[w*h] samples (desperados2.cpp:166-183); resets ``idxAdd``.
- ``HF a b c d hscale _ _ _ _ x1 y1 x2 y2`` heightfield patch: the
  reference's live path builds ONE quad from the four corner heights
  ``-hmap * hscale*255/32767 + 512`` added to the Y of four existing
  vertices (the dense-grid code after it is unreachable,
  desperados2.cpp:131-146) and leaves ``idxAdd`` at the pre-quad vertex
  count — both quirks preserved.

Output winding matches the reference's final re-ordering
``Triangle(verts[i1], verts[i0], verts[i2])`` (desperados2.cpp:181-183),
and shading normals are the per-face negated geometric normals with zero
uvs (GenShadingData with generate=0, desperados2.cpp:42-59).
"""

from __future__ import annotations

import os
import re
import struct
from typing import List, Optional

import numpy as np

from .base_scene import BaseScene, SceneObject

_SPLIT = re.compile(r"[ ,]+")


def _tokens(line: str) -> List[str]:
    return [t for t in _SPLIT.split(line.strip()) if t]


def _atoi(s: str) -> int:
    m = re.match(r"\s*[-+]?\d+", s)
    return int(m.group()) if m else 0


def _atof(s: str) -> float:
    m = re.match(r"\s*[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", s)
    return float(m.group()) if m else 0.0


def _load_hmap(path: str):
    """u16 width, u16 height, 15 bytes skipped, u16[w*h] little-endian
    (the reference's Loader reads, desperados2.cpp:170-180)."""
    with open(path, "rb") as f:
        head = f.read(4)
        if len(head) < 4:
            raise ValueError(f"truncated heightmap {path}")
        w, h = struct.unpack("<HH", head)
        f.seek(15, os.SEEK_CUR)
        data = np.frombuffer(f.read(w * h * 2), dtype="<u2")
        if data.size < w * h:
            raise ValueError(f"truncated heightmap {path}")
    return data.astype(np.int64), w, h


def load_v3o(path: str, scale: float = 1.0,
             hmap_dir: Optional[str] = None) -> BaseScene:
    """Load a ``.v3o`` file into a one-object :class:`BaseScene`."""
    scale = scale * 0.001
    verts: List[np.ndarray] = []
    tris: List[tuple] = []  # (i0, i1, i2) in FILE order (pre-swap)
    mats = [("default", "", False)]
    idx_add = 0
    hmap = None
    hmap_w = 0
    base_dir = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("//"):
                continue
            t = _tokens(line)
            if not t:
                continue
            op = t[0]
            if op == "D":
                # enum {A=0, B=2, C=1}: (x, -z, y) (desperados2.cpp:100-103)
                if len(t) < 13:
                    continue
                verts.append(np.array(
                    [_atof(t[1]), -_atof(t[3]), _atof(t[2])],
                    np.float64) * scale)
            elif op == "SRF":
                if len(t) < 12:
                    continue
                mats.append((t[1], t[5], bool(_atoi(t[11]))))
            elif op == "P":
                if len(t) < 5 or _atoi(t[1]) != 3:
                    continue
                v = tuple(_atoi(t[2 + k]) - 1 + idx_add for k in range(3))
                n_mat = _atoi(t[9]) if len(t) > 9 else 0
                mat = mats[n_mat if 1 <= n_mat < len(mats) else 0]
                tris.append(v)
                if mat[2]:  # twoSided -> flipped duplicate
                    tris.append((v[1], v[0], v[2]))
            elif op == "TLS":
                n = _atoi(t[1]) // 3 if len(t) > 1 else 0
                for k in range(n):
                    if len(t) < 5 + k * 3:
                        break
                    tris.append(tuple(
                        _atoi(t[2 + k * 3 + j]) - 1 + idx_add
                        for j in range(3)))
            elif op == "HMAP":
                name = t[1].replace("\\", "/") if len(t) > 1 else ""
                cands = [os.path.join(hmap_dir, name)] if hmap_dir else []
                cands += [os.path.join(base_dir, "desperados", name),
                          os.path.join(base_dir, name)]
                for cand in cands:
                    if os.path.exists(cand):
                        try:
                            hmap, hmap_w, _ = _load_hmap(cand)
                            idx_add = len(verts)
                        except ValueError:
                            pass
                        break
            elif op == "HF" and hmap is not None:
                if len(t) < 14:
                    continue
                p = [_atoi(t[1 + k]) - 1 for k in range(4)]
                hscale = _atof(t[5]) * 255.0 / 32767.0
                x1, y1, x2, y2 = (_atoi(t[10]), _atoi(t[11]),
                                  _atoi(t[12]), _atoi(t[13]))
                h = [-float(hmap[x1 + y1 * hmap_w]) * hscale + 512.0,
                     -float(hmap[x1 + y2 * hmap_w]) * hscale + 512.0,
                     -float(hmap[x2 + y2 * hmap_w]) * hscale + 512.0,
                     -float(hmap[x2 + y1 * hmap_w]) * hscale + 512.0]
                idx_add = len(verts)
                for k in range(4):
                    verts.append(verts[p[k]] + np.array([0.0, h[k], 0.0]))
                tris.append((idx_add + 0, idx_add + 1, idx_add + 2))
                tris.append((idx_add + 0, idx_add + 2, idx_add + 3))
                # quirk: idxAdd stays at the pre-quad count
                # (desperados2.cpp:138 sets it BEFORE the 4 pushes and the
                # dense-grid re-set at :161 is unreachable)

    v = (np.stack(verts).astype(np.float32) if verts
         else np.zeros((0, 3), np.float32))
    ti = (np.array(tris, np.int32) if tris
          else np.zeros((0, 3), np.int32))

    # final winding swap: Triangle(verts[i1], verts[i0], verts[i2])
    # (desperados2.cpp:181-183)
    tri_v = ti[:, [1, 0, 2]] if len(ti) else ti

    # per-face shading normals: -((v1-v0) x (v2-v0)) normalized in FILE
    # order (Tri ctor with neg=1, desperados2.cpp:17-24; generate=0 keeps
    # the face normal for every corner, desperados2.cpp:48-57)
    if len(ti):
        a = v[ti[:, 0]]
        n = -np.cross(v[ti[:, 1]] - a, v[ti[:, 2]] - a)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        normals = (n / np.maximum(ln, 1e-30)).astype(np.float32)
        tri_vn = np.repeat(np.arange(len(ti), dtype=np.int32)[:, None],
                           3, axis=1)
    else:
        normals = np.zeros((0, 3), np.float32)
        tri_vn = np.zeros((0, 3), np.int32)

    obj = SceneObject(
        verts=v,
        uvs=np.zeros((0, 2), np.float32),
        normals=normals,
        tri_v=tri_v.astype(np.int32),
        tri_vt=np.full_like(tri_v, -1),
        tri_vn=tri_vn,
        tri_mat=np.zeros(len(tri_v), np.int32),
        name=os.path.basename(path),
    )
    scene = BaseScene()
    scene.objects.append(obj)
    return scene
