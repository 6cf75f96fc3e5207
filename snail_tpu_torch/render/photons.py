"""Photon mapping (``snail_tpu.render.photons``, the reference's
src/photons.{h,cpp}).

- :func:`trace_photons` (``TracePhotons``, photons.cpp:197-250):
  stratified directions from each light, one closest-hit wavefront per
  light through the dispatch seam (``ops.dispatch.closest_hit``: B5 + B6
  on leaf tables, B9c on node tables, B11b on a fat-leaf scene), the hits
  compacted on the host.
- :func:`build_photon_kdtree` and :func:`gather_photons_kd`
  (``MakePhotonTree``, ``GatherPhotons``, photons.cpp:15-195): the median
  kd-tree and its range gather, host NumPy, the oracle of the grid.
- :func:`photon_grid` and :func:`gather_photons_grid`: photon powers
  splatted once per map into a dense density grid (host NumPy, so the
  grid equals the JAX package's bit for bit), and one trilinear fetch per
  query as tensor ops on the grid's device. The frames' photon term
  (``render.fast``, ``render.integrator``) reads this grid.
- :func:`render_photon_preview`: the primary hits coloured by photon
  density (the OpenGL ``DrawPhotons`` preview, render_opengl.h:20).
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from ..core.types import resolve_device
from ..core.vecmath import BIG
from ..ops import dispatch


@dataclasses.dataclass
class PhotonMap:
    pos: np.ndarray     # (P, 3) float32 hit positions
    power: np.ndarray   # (P, 3) float32 rgb power
    normal: np.ndarray  # (P, 3) float32 interpolated normal at the hit
    dirn: np.ndarray    # (P, 3) float32 incident direction

    @property
    def count(self) -> int:
        return len(self.pos)


def _stratified_sphere(n: int, gen: torch.Generator) -> torch.Tensor:
    """(n, 3) directions over the sphere, photon i in the i-th of n equal
    strata of cos(theta) with a uniform azimuth (the reference stratifies
    each batch, photons.cpp:212-230), drawn from ``gen`` on its device."""
    dev = gen.device
    i = torch.arange(n, dtype=torch.float32, device=dev)
    u = (i + torch.rand(n, generator=gen, device=dev)) / n
    v = torch.rand(n, generator=gen, device=dev)
    z = 1.0 - 2.0 * u
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * v
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def _trace_light(scene, li: int, d: torch.Tensor):
    """The photons of light ``li`` shot along the unit directions ``d`` (R,
    3), each carrying 1/R of its colour: (pos, power, normal, dirn) host
    arrays of the photons that hit."""
    lights = scene.lights
    n = d.shape[0]
    o = lights.pos[li].expand(n, 3)
    tmax = torch.full((n,), BIG, dtype=torch.float32, device=d.device)
    dist, tri, bary = dispatch.closest_hit(scene, o, d, tmax)
    hit = (dist > 0.0) & (dist < BIG)
    p = o + d * dist[:, None]
    sh = scene.sh_pack.index_select(0, torch.where(hit, tri, 0).long())
    u, v = bary[:, 0:1], bary[:, 1:2]
    nrm = sh[:, 0:3] + sh[:, 3:6] * u + sh[:, 6:9] * v
    nrm = nrm / torch.clamp_min(torch.linalg.vector_norm(nrm, dim=-1,
                                                         keepdim=True),
                                1e-12)
    # power: the light's colour over the photon count (photons.cpp)
    pw = (lights.color[li] / n).expand(n, 3)
    m = hit.cpu().numpy()
    return tuple(t.cpu().numpy()[m] for t in (p, pw, nrm, d))


def trace_photons(scene, n_per_light: int = 8192, seed: int = 0) -> PhotonMap:
    """Shoot ``n_per_light`` photons from every light of ``scene`` (the 8K
    batches of photons.cpp:197-250), each light's as one wavefront on the
    scene's device, and keep the hits. Directions come from a
    ``torch.Generator`` seeded with ``seed``."""
    if scene.lights is None:
        raise ValueError("the scene has no lights")
    gen = torch.Generator(device=scene.device)
    gen.manual_seed(seed)
    parts = [_trace_light(scene, li, _stratified_sphere(n_per_light, gen))
             for li in range(len(scene.lights))]
    return PhotonMap(*(np.concatenate(a).astype(np.float32)
                       for a in zip(*parts)))


# ---------------------------------------------------------------------------
# kd-tree (host, MakePhotonTree) and its range gather: the oracle
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PhotonKd:
    """Median-split kd-tree over photons in flat arrays (photons.cpp:15-66:
    a node is the median photon on the widest axis)."""

    axis: np.ndarray    # (N,) split axis, -1 for a leaf
    index: np.ndarray   # (N,) photon index at this node
    left: np.ndarray    # (N,) child ids (-1 none)
    right: np.ndarray


def build_photon_kdtree(pmap: PhotonMap) -> PhotonKd:
    n = pmap.count
    axis = np.full(n, -1, np.int32)
    index = np.zeros(n, np.int32)
    left = np.full(n, -1, np.int32)
    right = np.full(n, -1, np.int32)
    next_node = [0]

    def rec(ids: np.ndarray) -> int:
        if len(ids) == 0:
            return -1
        node = next_node[0]
        next_node[0] += 1
        pts = pmap.pos[ids]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        srt = ids[np.argsort(pts[:, ax], kind="stable")]
        mid = len(srt) // 2
        axis[node] = ax
        index[node] = srt[mid]
        left[node] = rec(srt[:mid])
        right[node] = rec(srt[mid + 1:])
        return node

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(np.arange(n))
    finally:
        sys.setrecursionlimit(old)
    return PhotonKd(axis=axis, index=index, left=left, right=right)


def gather_photons_kd(kd: PhotonKd, pmap: PhotonMap, point, normal,
                      radius: float) -> np.ndarray:
    """Stack-based range gather (photons.cpp:68-195): the photons within
    ``radius`` of ``point``, weighted by (1 - d/r) and by normal agreement
    max(0, n . n_p). Returns the rgb irradiance estimate (3,)."""
    point = np.asarray(point, np.float32)
    normal = np.asarray(normal, np.float32)
    acc = np.zeros(3, np.float32)
    r2 = radius * radius
    stack = [0] if kd.axis.size else []
    while stack:
        node = stack.pop()
        if node < 0:
            continue
        pi = kd.index[node]
        dvec = pmap.pos[pi] - point
        d2 = float(dvec @ dvec)
        if d2 < r2:
            w = 1.0 - np.sqrt(d2) / radius
            na = max(0.0, float(normal @ pmap.normal[pi]))
            acc += pmap.power[pi] * (w * na)
        ax = kd.axis[node]
        if ax < 0:
            continue
        delta = point[ax] - pmap.pos[pi][ax]
        near, far = ((kd.left[node], kd.right[node]) if delta < 0
                     else (kd.right[node], kd.left[node]))
        stack.append(near)
        if delta * delta < r2:
            stack.append(far)
    return acc / (np.pi * r2)


# ---------------------------------------------------------------------------
# The density grid and its trilinear fetch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhotonGrid:
    grid: torch.Tensor      # (G, G, G, 3) power density (power / cell volume)
    lo: torch.Tensor        # (3,)
    inv_cell: torch.Tensor  # (3,)
    res: int

    def to(self, device) -> "PhotonGrid":
        return PhotonGrid(grid=self.grid.to(device), lo=self.lo.to(device),
                          inv_cell=self.inv_cell.to(device), res=self.res)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def photon_grid(pmap: PhotonMap, scene_lo, scene_hi,
                res: int = 64) -> PhotonGrid:
    """Splat the photons' powers into a res^3 density grid over the box
    ``scene_lo``-``scene_hi`` (a host scatter, once per map, like the kd
    build). The grid goes to the device of ``scene_lo`` when it is a
    tensor (``scene.root_lo``), else to the card."""
    device = resolve_device(scene_lo.device if isinstance(
        scene_lo, torch.Tensor) else "cuda")
    lo = _host(scene_lo) - 1e-4
    hi = _host(scene_hi) + 1e-4
    cell = (hi - lo) / res
    idx = np.clip(((pmap.pos - lo) / cell).astype(np.int64), 0, res - 1)
    flat = (idx[:, 0] * res + idx[:, 1]) * res + idx[:, 2]
    grid = np.zeros((res * res * res, 3), np.float32)
    np.add.at(grid, flat, pmap.power)
    vol = float(cell[0] * cell[1] * cell[2])
    grid = grid.reshape(res, res, res, 3) / vol
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return PhotonGrid(grid=dev(grid), lo=dev(lo), inv_cell=dev(1.0 / cell),
                      res=res)


def gather_photons_grid(pg: PhotonGrid, points: torch.Tensor) -> torch.Tensor:
    """Trilinear density fetch: (R, 3) points -> (R, 3) irradiance, one
    8-corner gather per query (the vectorized ``GatherPhotons``), the
    lerps in z, then y, then x, each ``a * (1 - f) + b * f``."""
    g = pg.res
    q = (points - pg.lo[None]) * pg.inv_cell[None] - 0.5
    q0 = torch.floor(q)
    f = q - q0
    q0 = q0.to(torch.int32)
    # (R, 3, 2): each axis's two corners, clamped; then (R, x, y, z) rows
    ij = torch.clamp(torch.stack([q0, q0 + 1], -1), 0, g - 1)
    xy = ij[:, 0, :, None] * g + ij[:, 1, None, :]
    idx = xy[:, :, :, None] * g + ij[:, 2, None, None, :]
    c = pg.grid.reshape(-1, 3)[idx.reshape(-1).long()].reshape(-1, 2, 2, 2,
                                                                3)
    fx, fy, fz = (f[:, k, None, None, None] for k in range(3))
    c = c[:, :, :, 0] * (1 - fz) + c[:, :, :, 1] * fz  # (R, x, y, 3)
    c = c[:, :, 0] * (1 - fy[:, 0]) + c[:, :, 1] * fy[:, 0]  # (R, x, 3)
    return c[:, 0] * (1 - fx[:, 0, 0]) + c[:, 1] * fx[:, 0, 0]


def render_photon_preview(scene, camera, width: int, height: int,
                          pg: PhotonGrid, exposure: float = 1.0):
    """The primary hits coloured by photon density (the ``DrawPhotons``
    preview, render_opengl.h:20) as an (H, W, 3) image: rays in 32 x 32
    tiles where they divide the frame, else 1 x 1, through the dispatch
    seam."""
    from .raygen import primary_rays, tile_rays, untile_image

    origin, dirs = primary_rays(camera, width, height)
    th = 32 if height % 32 == 0 else 1
    tw = 32 if width % 32 == 0 else 1
    d = tile_rays(dirs, th, tw).reshape(-1, 3)
    o = origin.expand_as(d)
    tmax = torch.full(d.shape[:1], BIG, dtype=torch.float32, device=d.device)
    dist, tri, bary = dispatch.closest_hit(scene, o, d, tmax)
    hit = (dist > 0.0) & (dist < BIG)
    p = o + d * torch.where(hit, dist, 0.0)[:, None]
    rad = gather_photons_grid(pg, p) * exposure
    color = torch.where(hit[:, None], rad, 0.0)
    return untile_image(color.reshape(-1, th * tw, 3), height, width, th, tw)
