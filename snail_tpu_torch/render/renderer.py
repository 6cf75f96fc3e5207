"""Frame renderer (``snail_tpu.render.renderer``): camera -> packed
forward frame -> RGB image, with 2x2 supersampling (the reference's
gVals[9], render.cpp:60-110) and RGB8 conversion (ConvColor,
render.cpp:155-159).

The port has the packed path only: the frame (at twice the size when
supersampling) must be a multiple of the 64-pixel tile.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.types import Camera, RenderOpts
from .fast import render_frame_fast


def render_frame(scene, camera: Camera, width: int, height: int,
                 opts: RenderOpts = RenderOpts()) -> torch.Tensor:
    """Render a full frame; returns float32 (height, width, 3) linear
    color on the scene's device."""
    scale = 2 if opts.supersample else 1
    img = render_frame_fast(scene, camera, width * scale, height * scale,
                            opts)
    if opts.supersample:
        img = (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2]
               + img[1::2, 1::2]) * 0.25
    return img


def to_rgb8(img: torch.Tensor) -> np.ndarray:
    """ConvColor: clamp to [0, 255] and truncate."""
    return torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8).cpu().numpy()


class Renderer:
    """Holds scene + options and renders frames (the rtracer draw loop,
    rtracer.cpp:357-386); ``frames`` and ``last_frame_s`` track the
    frame rate."""

    def __init__(self, scene, width: int, height: int,
                 opts: RenderOpts = RenderOpts()):
        self.scene = scene
        self.width = width
        self.height = height
        self.opts = opts
        self.frames = 0
        self.last_frame_s = 0.0

    def render(self, camera: Camera) -> np.ndarray:
        t0 = time.perf_counter()
        img = render_frame(self.scene, camera, self.width, self.height,
                           self.opts).cpu().numpy()
        self.last_frame_s = time.perf_counter() - t0
        self.frames += 1
        return img

    def render_rgb8(self, camera: Camera) -> np.ndarray:
        return to_rgb8(torch.from_numpy(self.render(camera)))
