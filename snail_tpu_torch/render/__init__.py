from .fast import render_frame_fast, render_frame_fast_diff
from .renderer import Renderer, render_frame, to_rgb8

__all__ = ["Renderer", "render_frame", "render_frame_fast",
           "render_frame_fast_diff", "to_rgb8"]
