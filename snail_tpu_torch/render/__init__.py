from .fast import (render_frame_fast, render_frame_fast_diff,
                   render_frame_fast_stats)
from .integrator import render_wavefront, shade_hits, trace_light
from .photons import (PhotonGrid, PhotonKd, PhotonMap, build_photon_kdtree,
                      gather_photons_grid, gather_photons_kd, photon_grid,
                      render_photon_preview, trace_photons)
from .raygen import (TILE_H, TILE_W, camera_rays_wavefront, primary_rays,
                     tile_rays, untile_image)
from .renderer import Renderer, render_frame, to_rgb8

__all__ = ["PhotonGrid", "PhotonKd", "PhotonMap", "Renderer", "TILE_H",
           "TILE_W", "build_photon_kdtree", "camera_rays_wavefront",
           "gather_photons_grid", "gather_photons_kd", "photon_grid",
           "primary_rays", "render_frame", "render_frame_fast",
           "render_frame_fast_diff", "render_frame_fast_stats",
           "render_photon_preview", "render_wavefront", "shade_hits",
           "tile_rays", "to_rgb8", "trace_light", "trace_photons",
           "untile_image"]
