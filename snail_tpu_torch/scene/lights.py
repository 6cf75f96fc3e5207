"""Light helpers (reference src/light.h:6-18), a copy of
``snail_tpu.scene.lights`` on the port's :class:`Light`.

The reference's scenes construct point lights with a position, RGB color and
radius; the attenuation curve lives in the integrator
(src/scene_inl.h:150-152), reproduced in ``render.fast`` and
``render.integrator``.
"""

from __future__ import annotations

import numpy as np

from ..core.types import Light


def make_light(pos, color, radius, device="cuda") -> Light:
    return Light.make(pos, color, radius, device=device)


def default_scene_lights(scene_lo, scene_hi, device="cuda") -> Light:
    """A single light placed like rtracer's default: above and off-center of
    the scene bbox, radius scaled to the scene (rtracer.cpp's interactive
    light placement is user-driven; this mirrors its typical setup)."""
    lo = np.asarray(scene_lo, np.float32)
    hi = np.asarray(scene_hi, np.float32)
    center = (lo + hi) * 0.5
    size = float(np.linalg.norm(hi - lo))
    pos = center + np.asarray([0.25, 0.45, 0.25], np.float32) * size
    return Light.make(pos, (1.0, 1.0, 1.0), radius=size * 2.0, device=device)
