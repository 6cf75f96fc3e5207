from .fast import render_frame_fast
from .renderer import Renderer, render_frame, to_rgb8

__all__ = ["Renderer", "render_frame", "render_frame_fast", "to_rgb8"]
