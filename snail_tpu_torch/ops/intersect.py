"""Ray-triangle intersection on tensors (``snail_tpu.ops.intersect``).

The reference's precomputed-edge Moller variant over edges ``ba = p1 -
p0``, ``ca = p2 - p0`` (triangle.cpp:4-63):

    nrm = ba x ca, det = dir . nrm, tv = orig - a,
    u = dir . (tv x ca), v = dir . (ba x tv), dist = -(tv . nrm) / det

Primary rays are two-sided (u, v and det - u - v share a sign,
triangle.cpp:47-51, and 0 < dist < best); shadow rays one-sided from the
light (min(u, v) >= 0, u + v <= det, 0 < tmul < dist * det,
triangle.cpp:95-96). These are the brute-force oracles of the tests and
the differentiable recompute of a known hit (:func:`intersect_dist_bary`);
the kernels trace.
"""

from __future__ import annotations

import torch

from ..core.vecmath import BIG


def _raw_uvdet(orig, dirn, a, ba, ca):
    """(det, u, v, tmul), (..., T) each, of rays (..., 3) against
    triangles (T, 3)."""
    nrm = torch.linalg.cross(ba, ca)
    o = orig[..., None, :]
    d = dirn[..., None, :]
    tvec = o - a
    det = (d * nrm).sum(-1)
    u = (d * torch.linalg.cross(tvec, ca.expand_as(tvec))).sum(-1)
    v = (d * torch.linalg.cross(ba.expand_as(tvec), tvec)).sum(-1)
    tmul = -(tvec * nrm).sum(-1)
    return det, u, v, tmul


def intersect_tris(orig, dirn, a, ba, ca, tmax=None):
    """Dense two-sided intersection (the primary-ray rule) of rays (..., 3)
    with every triangle (T, 3). Returns (dist, u, v, hit), (..., T) each:
    dist BIG where there is no hit, u and v the det-normalized weights of
    vertices 1 and 2."""
    det, u, v, tmul = _raw_uvdet(orig, dirn, a, ba, ca)
    duv = det - u - v
    side = ((torch.maximum(u, torch.maximum(v, duv)) <= 0.0)
            | (torch.minimum(u, torch.minimum(v, duv)) >= 0.0))
    idet = 1.0 / torch.where(det == 0.0, 1e-30, det)
    dist = tmul * idet
    hit = side & (dist > 0.0) & (det != 0.0)
    if tmax is not None:
        hit = hit & (dist < tmax[..., None])
    return torch.where(hit, dist, BIG), u * idet, v * idet, hit


def intersect_brute_force(orig, dirn, a, ba, ca, tmax=None):
    """Closest hit over all triangles, the ground-truth oracle (the leaf
    loop of bvh/traverse.cpp:45-53 without a BVH). Returns (dist, tri
    int32, bary (..., 2)); dist BIG means a miss."""
    dist, u, v, _ = intersect_tris(orig, dirn, a, ba, ca, tmax)
    tri = dist.argmin(-1)
    best = dist.amin(-1)
    pick = lambda x: x.gather(-1, tri[..., None])[..., 0]
    return best, tri.to(torch.int32), torch.stack([pick(u), pick(v)], -1)


def intersect_any_brute_force(orig, dirn, a, ba, ca, tmax):
    """Any-hit occlusion oracle with the one-sided shadow rule: True where
    a triangle blocks the ray before ``tmax``."""
    det, u, v, tmul = _raw_uvdet(orig, dirn, a, ba, ca)
    blocked = ((torch.minimum(u, v) >= 0.0) & (u + v <= det) & (tmul > 0.0)
               & (tmul < tmax[..., None] * det))
    return blocked.any(-1)


def intersect_dist_bary(orig, dirn, a, ba, ca, tri_id, mask=None):
    """Differentiable (dist, u, v) of rays (R, 3) against the known
    triangles ``tri_id`` (R,), as a function of the rays and the vertex
    arrays (R-row gathers of ``a``/``ba``/``ca``), so that gradients flow
    to both. Rays outside ``mask`` (R,) bool, where given, are computed
    against a fixed unit triangle instead: their values are discarded by
    the caller, and this keeps them, and their gradients, finite."""
    ta, tba, tca = (x.index_select(0, tri_id.long()) for x in (a, ba, ca))
    if mask is not None:
        m = mask[:, None]
        unit = lambda *c: torch.tensor(c, dtype=orig.dtype, device=orig.device)
        ta = torch.where(m, ta, unit(0.0, 0.0, 0.0))
        tba = torch.where(m, tba, unit(1.0, 0.0, 0.0))
        tca = torch.where(m, tca, unit(0.0, 1.0, 0.0))
        orig = torch.where(m, orig, unit(0.25, 0.25, 1.0))
        dirn = torch.where(m, dirn, unit(0.0, 0.0, -1.0))
    nrm = torch.linalg.cross(tba, tca)
    tvec = orig - ta
    det = (dirn * nrm).sum(-1)
    safe_det = torch.where(det == 0.0, 1e-30, det)
    u = (dirn * torch.linalg.cross(tvec, tca)).sum(-1) / safe_det
    v = (dirn * torch.linalg.cross(tba, tvec)).sum(-1) / safe_det
    dist = -(tvec * nrm).sum(-1) / safe_det
    return dist, u, v
