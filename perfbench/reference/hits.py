"""Ray-triangle hits for the plain reference, from the triangle arrays
alone: no tree, no table and nothing of the program.

The test is the reference's precomputed-edge Moller form over a, ba = p1
- p0, ca = p2 - p0 and n = ba x ca (triangle.cpp:4-63): det = d . n,
u = d . (tv x ca), v = d . (ba x tv), tmul = -(tv . n) with tv = o - a.
Closest hits are two-sided (u, v and det - u - v share a sign, 0 < dist
= tmul / det < tmax), nearest first, the lowest triangle index on a tie;
shadow rays are one-sided from the light (min(u, v) >= 0, u + v <= det,
0 < tmul < tmax det).

Rays that share an origin (the camera's, a light's) are sorted into a
uniform grid on a plane before the origin, and each is tested against
the triangles whose projection overlaps its cell. The projection and its
culling run in float64 with a margin, so they only drop pairs that
cannot hit; the test itself runs in the dtype the caller gives. Rays
with their own origins (reflections, transparency) are tested against
every triangle, in blocks.
"""

from __future__ import annotations

import math

import torch

BIG = 3.4e37
_PAIRS = 1 << 23  # (ray, triangle) pairs tested at once
_GRID_MAX = 1024


class Tris:
    """The triangles of a scene as the test reads them: a, ba, ca and n
    (T, 3), formed in ``dtype``, and the corners in float64 for the
    culling."""

    def __init__(self, verts: torch.Tensor, tri_v: torch.Tensor,
                 dtype=torch.float32):
        self.corners = verts.double()[tri_v]  # (T, 3, 3)
        p0, p1, p2 = (verts.to(dtype)[tri_v[:, k]] for k in range(3))
        ba, ca = p1 - p0, p2 - p0
        n = torch.stack([ba[:, 1] * ca[:, 2] - ba[:, 2] * ca[:, 1],
                         ba[:, 2] * ca[:, 0] - ba[:, 0] * ca[:, 2],
                         ba[:, 0] * ca[:, 1] - ba[:, 1] * ca[:, 0]], 1)
        self.a, self.ba, self.ca, self.n = p0, ba, ca, n
        self.count = tri_v.shape[0]


def _terms(t: Tris, tri, o, d):
    """det, u, v, tmul of rays (o, d) (P, 3) against triangles ``tri``
    (P,), or with ``tri`` None of rays (P, 1, 3) against every triangle."""
    if tri is None:
        a, ba, ca, n = t.a, t.ba, t.ca, t.n
    else:
        a, ba, ca, n = t.a[tri], t.ba[tri], t.ca[tri], t.n[tri]
    tv = o - a
    x, y, z = (lambda w: w[..., 0]), (lambda w: w[..., 1]), (lambda w: w[..., 2])
    det = x(d) * x(n) + y(d) * y(n) + z(d) * z(n)
    tmul = -(x(tv) * x(n) + y(tv) * y(n) + z(tv) * z(n))
    u = (x(d) * (y(tv) * z(ca) - z(tv) * y(ca))
         + y(d) * (z(tv) * x(ca) - x(tv) * z(ca))
         + z(d) * (x(tv) * y(ca) - y(tv) * x(ca)))
    v = (x(d) * (y(ba) * z(tv) - z(ba) * y(tv))
         + y(d) * (z(ba) * x(tv) - x(ba) * z(tv))
         + z(d) * (x(ba) * y(tv) - y(ba) * x(tv)))
    return det, u, v, tmul


def _closest_dist(t: Tris, tri, o, d, tmax):
    """Two-sided distance of each pair, BIG where it misses."""
    det, u, v, tmul = _terms(t, tri, o, d)
    duv = det - u - v
    side = ((torch.maximum(u, torch.maximum(v, duv)) <= 0)
            | (torch.minimum(u, torch.minimum(v, duv)) >= 0))
    dist = tmul * (1.0 / torch.where(det == 0, 1e-30, det))
    ok = side & (det != 0) & (dist > 0) & (dist < tmax)
    return torch.where(ok, dist, BIG)


def _blocks(t: Tris, tri, o, d, tmax):
    det, u, v, tmul = _terms(t, tri, o, d)
    return ((torch.minimum(u, v) >= 0) & (u + v <= det) & (tmul > 0)
            & (tmul < tmax * det))


def _reduce(t: Tris, rays, tris, o, d, tmax, closest: bool):
    """Closest (dist, tri) or blocked of R rays over the (ray, triangle)
    pairs ``rays``, ``tris``; ``o`` (3,) shared or (R, 3)."""
    r = d.shape[0]
    dev = d.device
    if closest:
        best = torch.full((r,), BIG, dtype=d.dtype, device=dev)
        dists = []
        for s in range(0, rays.numel(), _PAIRS):
            ri, ti = rays[s:s + _PAIRS], tris[s:s + _PAIRS]
            oi = o.expand(ri.numel(), 3) if o.dim() == 1 else o[ri]
            dist = _closest_dist(t, ti, oi, d[ri], tmax[ri])
            best.scatter_reduce_(0, ri, dist, "amin")
            dists.append(dist)
        dist = torch.cat(dists) if dists else best[:0]
        win = (dist < BIG) & (dist == best[rays])
        tri = torch.full((r,), t.count, dtype=torch.int64, device=dev)
        tri.scatter_reduce_(0, rays[win], tris[win], "amin")
        return best, torch.where(best < BIG, tri, -1)
    blocked = torch.zeros(r, dtype=torch.int64, device=dev)
    for s in range(0, rays.numel(), _PAIRS):
        ri, ti = rays[s:s + _PAIRS], tris[s:s + _PAIRS]
        hit = _blocks(t, ti, o.expand(ri.numel(), 3), d[ri], tmax[ri])
        blocked.scatter_reduce_(0, ri, hit.long(), "amax")
    return blocked.bool()


def _expand(counts: torch.Tensor):
    """(owner, rank) of sum(counts) slots: owner i repeated counts[i]
    times, rank 0 .. counts[i] - 1 within it."""
    owner = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    return owner, torch.arange(owner.numel(), device=counts.device) \
        - first[owner]


def _unit(v):
    return v / torch.linalg.vector_norm(v)


def _shared_pairs(t: Tris, o: torch.Tensor, d: torch.Tensor):
    """(ray, triangle) pairs of rays ``d`` (R, 3) from the one origin
    ``o`` (3,) that can hit: the grid on the plane before ``o``."""
    dev = d.device
    o64, d64 = o.double(), d.double()
    f = _unit(d64.mean(0))
    helper = torch.tensor([1.0, 0, 0] if abs(float(f[0])) < 0.9
                          else [0, 1.0, 0], dtype=torch.float64, device=dev)
    r = _unit(torch.linalg.cross(f, helper))
    up = torch.linalg.cross(r, f)
    dz = d64 @ f
    onplane = dz > 0.2
    if not bool(onplane.any()):
        onplane[0] = True  # a grid of one ray; the others go to "far"
    far = (~onplane).nonzero()[:, 0]  # rays the plane cannot hold
    rx = (d64 @ r) / dz
    ry = (d64 @ up) / dz
    rx, ry = torch.where(onplane, rx, 0.0), torch.where(onplane, ry, 0.0)
    x0, x1 = float(rx[onplane].min()), float(rx[onplane].max())
    y0, y1 = float(ry[onplane].min()), float(ry[onplane].max())
    pad = 1e-6 * (1.0 + x1 - x0 + y1 - y0)
    x0, x1, y0, y1 = x0 - pad, x1 + pad, y0 - pad, y1 + pad
    g = max(1, min(_GRID_MAX, int(math.sqrt(d.shape[0] / 2))))
    cw, ch = (x1 - x0) / g, (y1 - y0) / g

    q = t.corners - o64  # (T, 3, 3)
    depth, qx, qy = q @ f, q @ r, q @ up
    slack = 1e-6 * torch.linalg.vector_norm(q, dim=-1)
    out = ((depth <= slack).all(1)
           | (qx - x1 * depth > slack).all(1) | (qx - x0 * depth < -slack).all(1)
           | (qy - y1 * depth > slack).all(1) | (qy - y0 * depth < -slack).all(1))
    front = (depth > 1e-6 * torch.linalg.vector_norm(q, dim=-1)).all(1)
    wide = (~out & ~front).nonzero()[:, 0]  # straddles the origin's plane
    keep = (~out & front).nonzero()[:, 0]
    px, py = qx[keep] / depth[keep], qy[keep] / depth[keep]
    # a float32 test can find a hit a few ulps outside the exact triangle
    m = 1e-4 * (x1 - x0 + y1 - y0)
    cx0 = torch.floor((px.amin(1) - m - x0) / cw).clamp(0, g - 1).long()
    cx1 = torch.floor((px.amax(1) + m - x0) / cw).clamp(0, g - 1).long()
    cy0 = torch.floor((py.amin(1) - m - y0) / ch).clamp(0, g - 1).long()
    cy1 = torch.floor((py.amax(1) + m - y0) / ch).clamp(0, g - 1).long()
    nx = cx1 - cx0 + 1
    owner, rank = _expand(nx * (cy1 - cy0 + 1))
    cell = (cy0[owner] + rank // nx[owner]) * g + cx0[owner] + rank % nx[owner]
    cell, order = torch.sort(cell)
    cell_tris = keep[owner[order]]
    counts = torch.bincount(cell, minlength=g * g)
    starts = torch.cumsum(counts, 0) - counts

    ray_cell = (torch.floor((ry - y0) / ch).clamp(0, g - 1).long() * g
                + torch.floor((rx - x0) / cw).clamp(0, g - 1).long())
    n_ray = torch.where(onplane, counts[ray_cell], 0)
    rays, rank = _expand(n_ray)
    tris = cell_tris[starts[ray_cell[rays]] + rank]
    # every triangle for the rays off the plane; every ray for the
    # triangles across the origin's plane
    everyone = torch.arange(t.count, device=dev)
    all_rays = torch.arange(d.shape[0], device=dev)
    rays = torch.cat([rays, far.repeat_interleave(t.count),
                      all_rays.repeat(wide.numel())])
    tris = torch.cat([tris, everyone.repeat(far.numel()),
                      wide.repeat_interleave(d.shape[0])])
    return rays, tris


def _shared(t: Tris, o, d, tmax, closest: bool):
    """The shared-origin query over the live rays (tmax >= 0) only: a
    masked ray's direction may point anywhere, and would widen the grid."""
    dt = t.a.dtype
    live = (tmax >= 0).nonzero()[:, 0]
    dl, tl = d[live], tmax[live]
    if live.numel():
        rays, tris = _shared_pairs(t, o, dl)
    else:
        rays = tris = live
    out = _reduce(t, rays, tris, o.to(dt), dl.to(dt), tl.to(dt), closest)
    if closest:
        dist = torch.full(tmax.shape, BIG, dtype=dt, device=d.device)
        tri = torch.full(tmax.shape, -1, dtype=torch.int64, device=d.device)
        dist[live], tri[live] = out
        return dist, tri
    blocked = torch.zeros(tmax.shape, dtype=torch.bool, device=d.device)
    blocked[live] = out
    return blocked


def closest_shared(t: Tris, o, d, tmax):
    """Closest hit (dist BIG on a miss, tri -1) of rays ``d`` (R, 3) from
    the one origin ``o`` (3,); rays with a negative tmax miss."""
    return _shared(t, o, d, tmax, True)


def blocked_shared(t: Tris, o, d, tmax):
    """Whether a triangle blocks each shadow ray ``d`` from the light at
    ``o`` before ``tmax``; rays with a negative tmax are never blocked."""
    return _shared(t, o, d, tmax, False)


def closest_general(t: Tris, o, d, tmax, rays_at_once: int = 8):
    """Closest hit of rays with their own origins ``o`` (R, 3): every
    live ray (tmax >= 0) against every triangle."""
    dt = t.a.dtype
    live = (tmax >= 0).nonzero()[:, 0]
    dist = torch.full(tmax.shape, BIG, dtype=dt, device=d.device)
    tri = torch.full(tmax.shape, -1, dtype=torch.int64, device=d.device)
    every = torch.arange(t.count, device=d.device)
    for s in range(0, live.numel(), rays_at_once):
        idx = live[s:s + rays_at_once]
        dd = _closest_dist(t, None, o[idx, None].to(dt), d[idx, None].to(dt),
                           tmax[idx, None].to(dt))
        best = dd.amin(1)
        first = torch.where(dd == best[:, None], every, t.count).amin(1)
        dist[idx] = best
        tri[idx] = torch.where(best < BIG, first, -1)
    return dist, tri
