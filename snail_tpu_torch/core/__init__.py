from .types import Camera, Light, RenderOpts
from .vecmath import BIG

__all__ = ["BIG", "Camera", "Light", "RenderOpts"]
