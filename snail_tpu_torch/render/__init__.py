from .fast import (render_frame_fast, render_frame_fast_diff,
                   render_frame_fast_stats)
from .renderer import Renderer, render_frame, to_rgb8

__all__ = ["Renderer", "render_frame", "render_frame_fast",
           "render_frame_fast_diff", "render_frame_fast_stats", "to_rgb8"]
