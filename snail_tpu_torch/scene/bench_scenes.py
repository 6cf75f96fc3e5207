"""The benchmark scenes of ``bench.py``, built with the port's procedural
copies and the shared BVH builder, with their light and camera."""

from __future__ import annotations

import numpy as np

from snail_tpu.bvh import build_bvh

from ..core.types import Camera, Light
from .procedural import city_scene, terrain_scene
from .scene import make_traced_scene

# kind -> (generator, leaf size, light position, light radius, camera
# offset from the scene centre in units of its largest extent)
SCENES = {
    # the headline scene's self-contained fallback (bench.py:78-109)
    "city": (city_scene, 16, (0.0, 30.0, 0.0), 120.0, (0.45, 0.35, 0.9)),
    # the large-scene row (bench.py:151-174)
    "terrain": (terrain_scene, 32, (0.0, 60.0, 0.0), 200.0,
                (0.35, 0.25, 0.4)),
}

# kind -> the size bench.py renders it at (terrain 724: ~1.05 Mtri)
BENCH_N = {"city": 24, "terrain": 724}


def bench_scene(kind: str, n: int, device="cpu"):
    """(scene, camera, geometry, bvh) of ``kind`` at size ``n``."""
    make, leaf, light, radius, offset = SCENES[kind]
    g = make(n).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=leaf)
    scene = make_traced_scene(
        g, bvh, lights=Light.make(light, (1.0, 1.0, 1.0), radius),
        device=device)
    c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
    ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
    cam = Camera.look_at(pos=tuple(c + np.array(offset) * ext),
                         target=tuple(c), device=device)
    return scene, cam, g, bvh
