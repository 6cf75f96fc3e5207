"""Host-side scene assembly in NumPy: a copy of the parts of
``snail_tpu.scene.base_scene`` that the port uses.

The JAX package's ``snail_tpu.scene`` imports JAX through its package
``__init__`` (``lights.py`` -> ``core/types.py``), so the port keeps its
own copy. The arrays it produces are identical to the JAX package's
(checked by ``tests/test_torch_scene.py``).

A :class:`BaseScene` is a list of :class:`SceneObject` mesh soups
(reference src/base_scene.h:30-101); flattening produces
:class:`FlatGeometry`, SoA float32/int32 arrays (vertex ``a``, edges
``ba``/``ca``, unit normal, shading deltas, material id).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class SceneObject:
    """One mesh: indexed triangles over shared vertex/uv/normal pools
    (reference BaseScene::Object, src/base_scene.h:49-101)."""

    verts: np.ndarray  # float32[V, 3]
    uvs: np.ndarray  # float32[U, 2] (possibly empty)
    normals: np.ndarray  # float32[Nn, 3] (possibly empty)
    tri_v: np.ndarray  # int32[T, 3] vertex indices
    tri_vt: np.ndarray  # int32[T, 3] uv indices, -1 = unused
    tri_vn: np.ndarray  # int32[T, 3] normal indices, -1 = unused
    tri_mat: np.ndarray  # int32[T] material ids
    name: str = ""

    @property
    def num_tris(self) -> int:
        return len(self.tri_v)

    def face_normals(self) -> np.ndarray:
        """Unit geometric normals, (v1-v0)x(v2-v0) normalized
        (reference GetTriangle fnrm, src/base_scene.cpp:313-314)."""
        v0 = self.verts[self.tri_v[:, 0]]
        v1 = self.verts[self.tri_v[:, 1]]
        v2 = self.verts[self.tri_v[:, 2]]
        n = np.cross(v1 - v0, v2 - v0)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(ln, 1e-30)

    def gen_normals(self) -> None:
        """Give faces with any missing corner normal their flat geometric
        normal (reference Object::GenNormals, src/base_scene.cpp:517-529 —
        note the reference assigns the *face* normal, not a smoothed one)."""
        fn = self.face_normals()
        missing = np.any(self.tri_vn < 0, axis=-1)
        if not missing.any():
            return
        n_old = len(self.normals) if len(self.normals) else 0
        new_ids = n_old + np.arange(missing.sum(), dtype=np.int32)
        normals = (
            np.concatenate([self.normals.reshape(-1, 3), fn[missing]], axis=0)
            if n_old
            else fn[missing].astype(np.float32)
        )
        tri_vn = self.tri_vn.copy()
        rows = np.where(missing)[0]
        for k in range(3):
            unset = tri_vn[rows, k] < 0
            tri_vn[rows[unset], k] = new_ids[unset]
        self.normals = normals.astype(np.float32)
        self.tri_vn = tri_vn


@dataclasses.dataclass
class FlatGeometry:
    """Flattened SoA triangle arrays — the device-friendly replacement for
    the reference's ``ATriVector`` + ``AShTriVector``
    (src/base_scene.cpp:39-77 flattening; src/triangle.h:123-136 precompute).

    Geometry (for intersection kernels):
      a, ba, ca : float32[T, 3]  vertex 0 and edges (Triangle::a/ba/ca)
      nrm       : float32[T, 3]  unit geometric normal (Triangle::plane.xyz)
      t0        : float32[T]     |ba x ca| (Triangle::t0)

    Shading (ShTriangle layout, deltas from corner 0 — src/triangle.h:199-203):
      uv0   : float32[T, 2]; uv_e1, uv_e2 : float32[T, 2]
      n0    : float32[T, 3]; n_e1, n_e2   : float32[T, 3]
      mat_id: int32[T]   (flat-normal handled by zero deltas, not a sign bit)
    """

    a: np.ndarray
    ba: np.ndarray
    ca: np.ndarray
    nrm: np.ndarray
    t0: np.ndarray
    uv0: np.ndarray
    uv_e1: np.ndarray
    uv_e2: np.ndarray
    n0: np.ndarray
    n_e1: np.ndarray
    n_e2: np.ndarray
    mat_id: np.ndarray

    @property
    def num_tris(self) -> int:
        return len(self.a)

    def bounds(self):
        """Per-triangle AABBs: min/max over the three vertices
        (Triangle::BoundMin/BoundMax, src/triangle.h:61-66)."""
        p1 = self.a
        p2 = self.a + self.ba
        p3 = self.a + self.ca
        lo = np.minimum(p1, np.minimum(p2, p3))
        hi = np.maximum(p1, np.maximum(p2, p3))
        return lo, hi

    def permuted(self, order: np.ndarray) -> "FlatGeometry":
        """Reorder all per-triangle arrays (the BVH build physically reorders
        triangles so leaves cover contiguous ranges — src/bvh/tree.cpp:245-253)."""
        return FlatGeometry(
            **{
                f.name: getattr(self, f.name)[order]
                for f in dataclasses.fields(self)
            }
        )

    def padded(self, pad: int) -> "FlatGeometry":
        """Append ``pad`` degenerate never-hit triangles. The port's kernels
        never read past a leaf; the padding keeps the triangle arrays equal
        row for row to the JAX package's, whose fixed-size leaf loads
        over-read past the last leaf."""

        def ext(x, fill=0.0):
            shape = (pad,) + x.shape[1:]
            return np.concatenate([x, np.full(shape, fill, x.dtype)], axis=0)

        out = {
            f.name: ext(getattr(self, f.name)) for f in dataclasses.fields(self)
        }
        # Degenerate tris: zero edges => det==0 and u+v<=det*t0 fails => miss.
        out["mat_id"] = ext(self.mat_id, 0).astype(np.int32)
        return FlatGeometry(**out)


class BaseScene:
    """Loader-facing scene container (reference BaseScene,
    src/base_scene.h:9-101)."""

    def __init__(self) -> None:
        self.objects: List[SceneObject] = []
        # "" is always material 0 (reference wavefront_obj.cpp:82-83)
        self.mat_names: Dict[str, int] = {"": 0}

    def gen_normals(self) -> None:
        for o in self.objects:
            o.gen_normals()

    def flatten(self) -> FlatGeometry:
        """Flatten all objects into one SoA triangle array set, resolving
        per-corner uvs/normals the same way the reference's GetTriangle does
        (missing uv -> (0,0); missing normal -> face normal;
        src/base_scene.cpp:308-323)."""
        parts = {k: [] for k in [f.name for f in dataclasses.fields(FlatGeometry)]}
        for obj in self.objects:
            if obj.num_tris == 0:
                continue
            v0 = obj.verts[obj.tri_v[:, 0]].astype(np.float32)
            v1 = obj.verts[obj.tri_v[:, 1]].astype(np.float32)
            v2 = obj.verts[obj.tri_v[:, 2]].astype(np.float32)
            ba = v1 - v0
            ca = v2 - v0
            n = np.cross(ba, ca)
            t0 = np.linalg.norm(n, axis=-1)
            nrm = n / np.maximum(t0, 1e-30)[:, None]

            def corner_uv(k):
                idx = obj.tri_vt[:, k]
                if len(obj.uvs) == 0:
                    return np.zeros((obj.num_tris, 2), np.float32)
                safe = np.clip(idx, 0, len(obj.uvs) - 1)
                uv = obj.uvs[safe].astype(np.float32)
                return np.where((idx >= 0)[:, None], uv, 0.0)

            def corner_n(k):
                idx = obj.tri_vn[:, k]
                if len(obj.normals) == 0:
                    return nrm
                safe = np.clip(idx, 0, len(obj.normals) - 1)
                vn = obj.normals[safe].astype(np.float32)
                return np.where((idx >= 0)[:, None], vn, nrm)

            uv = [corner_uv(k) for k in range(3)]
            cn = [corner_n(k) for k in range(3)]

            parts["a"].append(v0)
            parts["ba"].append(ba)
            parts["ca"].append(ca)
            parts["nrm"].append(nrm.astype(np.float32))
            parts["t0"].append(t0.astype(np.float32))
            parts["uv0"].append(uv[0])
            parts["uv_e1"].append(uv[1] - uv[0])
            parts["uv_e2"].append(uv[2] - uv[0])
            parts["n0"].append(cn[0])
            parts["n_e1"].append(cn[1] - cn[0])
            parts["n_e2"].append(cn[2] - cn[0])
            parts["mat_id"].append(obj.tri_mat.astype(np.int32))

        return FlatGeometry(
            **{k: np.concatenate(v, axis=0) for k, v in parts.items()}
        )
