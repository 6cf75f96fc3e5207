"""Traversal dispatch (``snail_tpu.ops.dispatch``): the seam through which
callers that hold rays as (R, 3) arrays — the portable integrator and
instancing — reach the kernels.

``closest_hit``, ``any_hit`` and ``any_hit_from`` route by what the scene
holds, as the wavefront entry points of :mod:`.traverse` do: a scene with
worklist leaf tables takes the worklist kernels (B5 + B6, B3 + B4, B5 +
B7), a scene with node tables the walk kernels (B9c, B9b, B9d). As
everywhere in the port, the device of the scene's tensors picks the CUDA
kernels or their plain versions. Where the JAX package's seam sends a CPU
run to its jnp oracle ``traverse_ref``, the port's plain versions are
that oracle (:mod:`.traverse_ref` is the walk kernels' plain version).
Visibility is boolean, so the any-hit entries run without gradients.
"""

from __future__ import annotations

import torch

from ..core.vecmath import BIG
from ..utils import trace
from .traverse import (any_hit_aos, any_hit_shared, closest_hit_aos,
                       pad_flat, substitute_masked)


def closest_hit(scene, orig, dirn, tmax):
    """(dist, tri, bary (R, 2)) of rays ``orig``/``dirn`` (R, 3): a miss
    has dist BIG, a masked ray (tmax < 0) -BIG."""
    return closest_hit_aos(scene, orig, dirn, tmax)


@torch.no_grad()
def any_hit_from(scene, origin, dirn, tmax):
    """Any-hit of rays that all start at ``origin`` (3,) (shadow rays are
    traced from the light, scene_inl.h:127-129) along ``dirn`` (R, 3):
    blocked bool (R,), never for a masked ray. Masked rays' directions
    are substituted by their packet's mean live direction first, so they
    cannot widen the packet's direction interval."""
    n = dirn.shape[0]
    with trace.span("snail.shadow"):
        tm, _ = pad_flat(tmax, -BIG)
        d = substitute_masked(tuple(pad_flat(dirn[:, k], 1.0)[0]
                                    for k in range(3)), tm,
                              unit_fallback=True)
        return any_hit_shared(scene, origin, d, tm)[:n] & (tmax >= 0.0)


@torch.no_grad()
def any_hit(scene, orig, dirn, tmax):
    """Any-hit of rays ``orig``/``dirn`` (R, 3): blocked bool (R,), never
    for a masked ray (tmax < 0)."""
    return any_hit_aos(scene, orig, dirn, tmax)
