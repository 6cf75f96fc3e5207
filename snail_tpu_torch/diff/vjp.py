"""Differentiable traversal (``snail_tpu.diff.vjp``).

Which triangle a ray hits is piecewise constant, so the traversal runs
without gradients (the kernels, through the dispatch seam), and the hit's
distance and barycentrics are recomputed in closed form from the rays and
the primal triangle arrays (``ops.intersect.intersect_dist_bary``): one
gather and a few dozen operations per ray, through which autograd gives
the exact gradients with respect to the vertices and the ray.
"""

from __future__ import annotations

import torch

from ..core.vecmath import BIG
from ..ops import dispatch
from ..ops.intersect import intersect_dist_bary


def diff_closest_hit(scene, orig, dirn, tmax):
    """Closest hit of rays ``orig``/``dirn`` (R, 3) with gradients to
    ``scene.tri_a``/``tri_ba``/``tri_ca`` and the rays: (dist, tri, bary
    (R, 2)) as :func:`ops.dispatch.closest_hit` gives them, dist and bary
    recomputed where the ray hits, tri without gradient."""
    with torch.no_grad():
        dist0, tri, bary0 = dispatch.closest_hit(
            scene, orig.detach(), dirn.detach(), tmax.detach())
    hit = (dist0 > 0.0) & (dist0 < BIG)
    d, u, v = intersect_dist_bary(orig, dirn, scene.tri_a, scene.tri_ba,
                                  scene.tri_ca, torch.where(hit, tri, 0),
                                  mask=hit)
    dist = torch.where(hit, d, dist0)
    bary = torch.where(hit[:, None], torch.stack([u, v], -1), bary0)
    return dist, tri, bary
