"""Primary-ray generation and tile (un)packing (``snail_tpu.render.raygen``,
the reference's RayGenerator, src/ray_generator.h:25-70).

Pixel (x, y) maps to the direction

    right * ((x + 0.5 - w/2) / h) + up * ((h/2 - y - 0.5) / h) + front * planeDist

normalized with a correctly rounded rsqrt (as the camera kernels'
raygen; the JAX package's CPU rsqrt is approximate, ROADMAP C).
:func:`tile_rays` cuts the image into ray tiles, each a coherent block of
rays, and :func:`untile_image` puts a tiled wavefront back into raster
order; :func:`camera_rays_wavefront` gives the tiled rays as one
wavefront.
"""

from __future__ import annotations

import torch

from ..core.types import Camera, Rays
from ..core.vecmath import BIG, normalize

TILE_W = 16
TILE_H = 16


def primary_rays(camera: Camera, width: int, height: int, jitter=None):
    """Full-image primary rays: the shared origin (3,) and unit directions
    (height, width, 3), on the camera's device. ``jitter`` (jx, jy) moves
    every sample by that many pixels."""
    dev = camera.pos.device
    x = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5
         - width * 0.5) / height
    y = (height * 0.5 - (torch.arange(height, dtype=torch.float32,
                                      device=dev) + 0.5)) / height
    if jitter is not None:
        jx, jy = jitter
        x = x + jx / height
        y = y - jy / height
    d = (camera.right * x[None, :, None] + camera.up * y[:, None, None]
         + camera.front * camera.plane_dist)
    d = normalize(d)
    return camera.pos, d


def tile_rays(dirs: torch.Tensor, tile_h: int = TILE_H,
              tile_w: int = TILE_W) -> torch.Tensor:
    """(H, W, 3) -> (P, tile_h * tile_w, 3) tile blocks, tiles in raster
    order."""
    h, w = dirs.shape[:2]
    if h % tile_h or w % tile_w:
        raise ValueError(f"image {h}x{w} is not a multiple of the "
                         f"{tile_h}x{tile_w} tile")
    d = dirs.reshape(h // tile_h, tile_h, w // tile_w, tile_w, 3)
    return d.permute(0, 2, 1, 3, 4).reshape(-1, tile_h * tile_w, 3)


def untile_image(tiles: torch.Tensor, height: int, width: int,
                 tile_h: int = TILE_H, tile_w: int = TILE_W) -> torch.Tensor:
    """(P, tile_h * tile_w, C) or (P, tile_h * tile_w) -> (H, W, C) or
    (H, W): the inverse of :func:`tile_rays`."""
    c_shape = tuple(tiles.shape[2:])
    t = tiles.reshape(height // tile_h, width // tile_w, tile_h, tile_w,
                      *c_shape)
    t = t.permute(0, 2, 1, 3, *range(4, 4 + len(c_shape)))
    return t.reshape(height, width, *c_shape)


def camera_rays_wavefront(camera: Camera, width: int, height: int,
                          jitter=None) -> Rays:
    """The primary rays as a flat wavefront (P * TILE_H * TILE_W,) of
    tiles (:func:`tile_rays`), the shared origin broadcast and tmax BIG
    (``snail_tpu.render.raygen.camera_rays_wavefront``)."""
    origin, dirs = primary_rays(camera, width, height, jitter)
    d = tile_rays(dirs).reshape(-1, 3)
    return Rays(origin=origin.expand_as(d), dir=d,
                tmax=torch.full(d.shape[:1], BIG, dtype=torch.float32,
                                device=d.device))
