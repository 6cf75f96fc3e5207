"""The ``terrain`` generator: the benchmark's frozen copy of the
fractal-noise terrain generator.

It gives the vertices and triangles of ``terrain_scene(n, extent, seed,
octaves)`` as the program's ``scene/procedural.py`` makes them (a test
holds the two equal at a small size), but does the interpolation on the
device in float64, so that 10 Mtri take a fraction of a second. The
program's copy may change; this one may not, so the geometry a cell
renders stays the same from PR to PR.

Only the coarse noise grids come from NumPy's generator (the same draws,
in the same order, as the program's copy); everything else is torch.
"""

from __future__ import annotations

import numpy as np
import torch


def _linspace64(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``np.linspace(start, stop, num)`` in float64, bit for bit: i * step
    + start, with the last point set to ``stop``."""
    step = (stop - start) / (num - 1)
    y = torch.arange(num, dtype=torch.float64, device=device) * step + start
    y[-1] = stop
    return y


def terrain(n: int, extent: float = 100.0, seed: int = 0, octaves: int = 5,
            device="cpu"):
    """(verts float32 (V, 3), tri_v int64 (T, 3)) of an n x n heightfield
    of 2 n^2 triangles on ``device``: quad (i, j) gives triangles (a, b, c)
    and, after all of those, (a, c, d)."""
    rng = np.random.default_rng(seed)
    h = torch.zeros((n + 1, n + 1), dtype=torch.float32, device=device)
    for o in range(octaves):
        k = 4 * (2 ** o)
        if k >= n:
            break
        coarse = torch.from_numpy(
            rng.normal(0.0, extent * 0.04 / (2 ** o), (k + 1, k + 1))
        ).to(device)
        ti = _linspace64(0.0, float(k), n + 1, device)
        i0 = torch.clamp(ti.to(torch.int64), 0, k - 1)
        f = ti - i0
        fy, fx = f[:, None], f[None, :]
        y0, x0 = i0[:, None], i0[None, :]
        c00 = coarse[y0, x0]
        c01 = coarse[y0, x0 + 1]
        c10 = coarse[y0 + 1, x0]
        c11 = coarse[y0 + 1, x0 + 1]
        h += ((1 - fy) * (1 - fx) * c00 + (1 - fy) * fx * c01
              + fy * (1 - fx) * c10 + fy * fx * c11).to(torch.float32)

    xs = _linspace64(-extent / 2, extent / 2, n + 1, device).to(torch.float32)
    vz, vx = torch.meshgrid(xs, xs, indexing="ij")
    verts = torch.stack([vx, h, vz], dim=-1).reshape(-1, 3)

    idx = torch.arange((n + 1) * (n + 1), device=device).reshape(n + 1, n + 1)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[:-1, 1:].reshape(-1)
    c = idx[1:, 1:].reshape(-1)
    d = idx[1:, :-1].reshape(-1)
    tri_v = torch.cat([torch.stack([a, b, c], 1), torch.stack([a, c, d], 1)])
    return verts, tri_v


def generate(gen: dict, device):
    """(verts, tri_v, tri_mat int64 (T,)) of a configuration's
    ``generator`` entry ``{"kind": "terrain", "n", "extent", "seed",
    "octaves"}``: every triangle takes material 0."""
    verts, tri_v = terrain(gen["n"], gen["extent"], gen["seed"],
                           gen["octaves"], device=device)
    return verts, tri_v, torch.zeros(tri_v.shape[0], dtype=torch.int64,
                                     device=device)
