"""BVH disk cache — the rebuild of the reference's ``dump/<scene>`` artifact
cache (reference BVH::save/load, src/bvh/tree.cpp:331-364; used by
server.cpp:269-272 and rtracer.cpp:505-513 to skip rebuilds).

Stored as a single ``.npz`` holding the flat node arrays, the triangle
permutation, and a content hash of the inputs so stale caches self-invalidate
(the reference had no hash — its load path was even disabled with ``&& false``
because of staleness, rtracer.cpp:509). A copy of ``snail_tpu.bvh.cache``: the
same ``.npz`` format and content key, so a file written by either package
loads in the other to an identical BVH.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

from .build import BVH, build_bvh


def _content_key(tri_lo: np.ndarray, tri_hi: np.ndarray, leaf_size: int, method: str) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(tri_lo, np.float32).tobytes())
    h.update(np.ascontiguousarray(tri_hi, np.float32).tobytes())
    h.update(f"{leaf_size}:{method}:v2".encode())
    return h.hexdigest()[:24]


def save_bvh(path: str, bvh: BVH, key: str = "") -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        node_lo=bvh.node_lo,
        node_hi=bvh.node_hi,
        child=bvh.child,
        count=bvh.count,
        axis=bvh.axis,
        first_node=bvh.first_node,
        order=bvh.order,
        depth=np.int32(bvh.depth),
        key=np.frombuffer(key.encode().ljust(24), dtype=np.uint8),
    )


def load_bvh(path: str, key: Optional[str] = None) -> Optional[BVH]:
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path)
    except Exception:
        return None
    if key is not None:
        stored = bytes(z["key"]).decode(errors="replace").strip()
        if stored != key:
            return None
    return BVH(
        node_lo=z["node_lo"],
        node_hi=z["node_hi"],
        child=z["child"],
        count=z["count"],
        axis=z["axis"],
        first_node=z["first_node"],
        order=z["order"],
        depth=int(z["depth"]),
    )


def build_or_load(
    tri_lo: np.ndarray,
    tri_hi: np.ndarray,
    cache_dir: Optional[str] = None,
    name: str = "scene",
    leaf_size: int = 8,
    method: str = "binned",
) -> BVH:
    """Build with cache lookaside (the ``dump/`` pattern, server.cpp:267-310)."""
    key = _content_key(tri_lo, tri_hi, leaf_size, method)
    path = None
    if cache_dir:
        path = os.path.join(cache_dir, f"{name}.bvh.npz")
        cached = load_bvh(path, key)
        if cached is not None:
            return cached
    bvh = build_bvh(tri_lo, tri_hi, leaf_size=leaf_size, method=method)
    if path:
        save_bvh(path, bvh, key)
    return bvh
