"""Frame renderer (``snail_tpu.render.renderer``): camera -> frame -> RGB
image, with 2x2 supersampling (the reference's gVals[9],
render.cpp:60-110) and RGB8 conversion (ConvColor, render.cpp:155-159).

A frame (at twice the size when supersampling) that is a multiple of the
64-pixel tile takes the packed fast path (``render.fast``); any other
size, 1280 x 720 or whatever a client of the render server asks for,
takes the portable integrator (``render.integrator``): primary rays cut
into 16 x 16 tiles where they divide the frame (else 1 x 1), traced and
shaded through the dispatch seam, and put back in raster order. Either
path runs on a scene of either kind of traversal tables.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import Camera, RenderOpts
from ..core.vecmath import BIG
from ..ops.traverse import TILE
from ..utils import trace
from ..utils.frame_counter import FrameCounter
from .fast import render_frame_fast
from .integrator import render_wavefront
from .raygen import TILE_H, TILE_W, primary_rays, tile_rays, untile_image


def render_frame(scene, camera: Camera, width: int, height: int,
                 opts: RenderOpts = RenderOpts(),
                 photon_grid=None) -> torch.Tensor:
    """Render a full frame; returns float32 (height, width, 3) linear
    color on the scene's device (differentiable on the portable path).
    ``photon_grid`` (``render.photons.PhotonGrid``), with ``opts.photons``,
    adds the photon-map radiance term."""
    scale = 2 if opts.supersample else 1
    w, h = width * scale, height * scale
    with trace.span("snail.frame"):
        if w % TILE == 0 and h % TILE == 0:
            img = render_frame_fast(scene, camera, w, h, opts, photon_grid)
        else:
            img = render_frame_portable(scene, camera, w, h, opts,
                                        photon_grid)
        if opts.supersample:
            img = (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2]
                   + img[1::2, 1::2]) * 0.25
    return img


def frame_rays(camera: Camera, width: int, height: int):
    """A width x height frame's primary wavefront in tile order, 16 x 16
    tiles where they divide the frame, else 1 x 1: (origin (R, 3), the
    shared origin expanded; directions (R, 3); tmax (R,); (th, tw))."""
    th = TILE_H if height % TILE_H == 0 else 1
    tw = TILE_W if width % TILE_W == 0 else 1
    origin, dirs = primary_rays(camera, width, height)
    d = tile_rays(dirs, th, tw).reshape(-1, 3)
    tmax = torch.full(d.shape[:1], BIG, dtype=torch.float32, device=d.device)
    return origin.expand_as(d), d, tmax, (th, tw)


def render_frame_portable(scene, camera: Camera, width: int, height: int,
                          opts: RenderOpts = RenderOpts(),
                          photon_grid=None) -> torch.Tensor:
    """A width x height frame through the portable integrator
    (``renderer.py:54-69`` of the JAX package): (height, width, 3)."""
    o, d, tmax, (th, tw) = frame_rays(camera, width, height)
    color = render_wavefront(scene, o, d, tmax, opts, tile_hw=(th, tw),
                             photon_grid=photon_grid)
    return untile_image(color.reshape(-1, th * tw, 3), height, width, th, tw)


def to_rgb8(img: torch.Tensor) -> np.ndarray:
    """ConvColor: clamp to [0, 255] and truncate."""
    with trace.span("snail.rgb8"):
        img = torch.clamp(img * 255.0, 0.0, 255.0)
        return img.to(torch.uint8).cpu().numpy()


class Renderer:
    """Holds scene + options and renders frames (the rtracer draw loop,
    rtracer.cpp:357-386); ``frames`` counts the frames and ``fps``
    (``utils.frame_counter.FrameCounter``) is ticked on each."""

    def __init__(self, scene, width: int, height: int,
                 opts: RenderOpts = RenderOpts()):
        self.scene = scene
        self.width = width
        self.height = height
        self.opts = opts
        self.frames = 0
        self.fps = FrameCounter()

    def render(self, camera: Camera) -> np.ndarray:
        img = render_frame(self.scene, camera, self.width, self.height,
                           self.opts).cpu().numpy()
        self.frames += 1
        self.fps.tick()
        return img

    def render_rgb8(self, camera: Camera) -> np.ndarray:
        return to_rgb8(torch.from_numpy(self.render(camera)))
