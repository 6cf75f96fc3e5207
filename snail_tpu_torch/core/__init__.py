from .types import Camera, Light, Rays, RenderOpts
from .vecmath import (BIG, cross, dot, length, normalize, reflect, refract,
                      safe_inv)

__all__ = ["BIG", "Camera", "Light", "Rays", "RenderOpts", "cross", "dot",
           "length", "normalize", "reflect", "refract", "safe_inv"]
