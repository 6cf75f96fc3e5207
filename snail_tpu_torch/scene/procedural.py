"""Procedural scenes (no file IO): a NumPy copy of
``snail_tpu.scene.procedural``, which cannot be imported without JAX.

The generators give arrays identical to the JAX package's for the same
arguments (checked by ``tests/test_torch_scene.py``), so both packages
render the same scene from the same seed.
"""

from __future__ import annotations

import numpy as np

from .base_scene import BaseScene, SceneObject


def _obj_from_tris(tri: np.ndarray, mat: int = 0) -> SceneObject:
    """SceneObject from a [N, 3, 3] float32 triangle soup (flat normals)."""
    n = tri.shape[0]
    return SceneObject(
        verts=tri.reshape(-1, 3).astype(np.float32),
        uvs=np.zeros((0, 2), np.float32),
        normals=np.zeros((0, 3), np.float32),
        tri_v=np.arange(n * 3, dtype=np.int32).reshape(n, 3),
        tri_vt=np.full((n, 3), -1, np.int32),
        tri_vn=np.full((n, 3), -1, np.int32),
        tri_mat=np.full(n, mat, np.int32),
    )


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise)."""
    return np.asarray([[a, b, c], [a, c, d]], np.float32)


def box_tris(lo=(-1, -1, -1), hi=(1, 1, 1)) -> np.ndarray:
    """12 triangles of an axis-aligned box (the box.obj shape)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    p = lambda x, y, z: (x, y, z)
    quads = [
        _quad(p(x0, y0, z0), p(x1, y0, z0), p(x1, y1, z0), p(x0, y1, z0)),
        _quad(p(x1, y0, z1), p(x0, y0, z1), p(x0, y1, z1), p(x1, y1, z1)),
        _quad(p(x0, y0, z1), p(x0, y0, z0), p(x0, y1, z0), p(x0, y1, z1)),
        _quad(p(x1, y0, z0), p(x1, y0, z1), p(x1, y1, z1), p(x1, y1, z0)),
        _quad(p(x0, y1, z0), p(x1, y1, z0), p(x1, y1, z1), p(x0, y1, z1)),
        _quad(p(x0, y0, z1), p(x1, y0, z1), p(x1, y0, z0), p(x0, y0, z0)),
    ]
    return np.concatenate(quads, axis=0)


def box_scene() -> BaseScene:
    """A single box — the box.obj test scene equivalent."""
    s = BaseScene()
    s.objects.append(_obj_from_tris(box_tris()))
    s.gen_normals()
    return s


def cornell_scene() -> BaseScene:
    """Open box room + two inner boxes; exercises shadows + reflections."""
    s = BaseScene()
    room = []
    # floor, back wall, left, right, ceiling
    room.append(_quad((-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)))
    room.append(_quad((-2, 0, -2), (-2, 4, -2), (2, 4, -2), (2, 0, -2)))
    room.append(_quad((-2, 0, -2), (-2, 0, 2), (-2, 4, 2), (-2, 4, -2)))
    room.append(_quad((2, 0, -2), (2, 4, -2), (2, 4, 2), (2, 0, 2)))
    room.append(_quad((-2, 4, -2), (-2, 4, 2), (2, 4, 2), (2, 4, -2)))
    s.objects.append(_obj_from_tris(np.concatenate(room, axis=0), mat=0))
    s.objects.append(
        _obj_from_tris(box_tris((-1.2, 0.0, -1.2), (-0.2, 2.0, -0.2)), mat=0)
    )
    s.objects.append(
        _obj_from_tris(box_tris((0.3, 0.0, 0.2), (1.3, 1.0, 1.2)), mat=0)
    )
    s.gen_normals()
    return s


def city_scene(grid: int = 24, seed: int = 0) -> BaseScene:
    """A grid of boxes of varying heights on a ground plane — a
    sponza-like benchmark stand-in (occlusion + shadow heavy) with
    ~``12*grid^2`` triangles."""
    rng = np.random.default_rng(seed)
    tris = [
        _quad(
            (-grid, 0, -grid), (grid, 0, -grid),
            (grid, 0, grid), (-grid, 0, grid),
        )
    ]
    for i in range(grid):
        for j in range(grid):
            if rng.uniform() < 0.3:
                continue
            x = (i - grid / 2) * 2.0 + rng.uniform(0.1, 0.4)
            z = (j - grid / 2) * 2.0 + rng.uniform(0.1, 0.4)
            w = rng.uniform(0.5, 1.4)
            h = rng.uniform(0.5, 6.0)
            tris.append(box_tris((x, 0, z), (x + w, h, z + w)))
    s = BaseScene()
    s.objects.append(_obj_from_tris(np.concatenate(tris, axis=0)))
    s.gen_normals()
    return s


def terrain_scene(n: int = 724, extent: float = 100.0, seed: int = 0,
                  octaves: int = 5) -> BaseScene:
    """Fractal-noise heightfield of ``2*n^2`` triangles — the large-scene
    benchmark stand-in for the reference's foot/thai meshes
    (benchmark.txt:78-80, 101-104; those .obj files are not mounted).
    n=724 gives ~1.05 Mtris, matching foot.obj's 1.06 Mtri scale."""
    rng = np.random.default_rng(seed)
    h = np.zeros((n + 1, n + 1), np.float32)
    for o in range(octaves):
        k = 4 * (2 ** o)
        if k >= n:
            break
        coarse = rng.normal(0.0, extent * 0.04 / (2 ** o), (k + 1, k + 1))
        yi = np.linspace(0, k, n + 1)
        xi = np.linspace(0, k, n + 1)
        y0 = np.clip(yi.astype(np.int64), 0, k - 1)
        x0 = np.clip(xi.astype(np.int64), 0, k - 1)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        c00 = coarse[np.ix_(y0, x0)]
        c01 = coarse[np.ix_(y0, x0 + 1)]
        c10 = coarse[np.ix_(y0 + 1, x0)]
        c11 = coarse[np.ix_(y0 + 1, x0 + 1)]
        h += ((1 - fy) * (1 - fx) * c00 + (1 - fy) * fx * c01
              + fy * (1 - fx) * c10 + fy * fx * c11).astype(np.float32)

    xs = np.linspace(-extent / 2, extent / 2, n + 1, dtype=np.float32)
    zs = np.linspace(-extent / 2, extent / 2, n + 1, dtype=np.float32)
    vx, vz = np.meshgrid(xs, zs, indexing="xy")
    verts = np.stack([vx, h, vz], axis=-1).reshape(-1, 3)

    idx = np.arange((n + 1) * (n + 1), dtype=np.int32).reshape(n + 1, n + 1)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[:-1, 1:].reshape(-1)
    c = idx[1:, 1:].reshape(-1)
    d = idx[1:, :-1].reshape(-1)
    tri_v = np.concatenate(
        [np.stack([a, b, c], axis=1), np.stack([a, c, d], axis=1)], axis=0
    ).astype(np.int32)

    t = len(tri_v)
    s = BaseScene()
    s.objects.append(SceneObject(
        verts=verts.astype(np.float32),
        uvs=np.zeros((0, 2), np.float32),
        normals=np.zeros((0, 3), np.float32),
        tri_v=tri_v,
        tri_vt=np.full((t, 3), -1, np.int32),
        tri_vn=np.full((t, 3), -1, np.int32),
        tri_mat=np.zeros(t, np.int32),
    ))
    s.gen_normals()
    return s
