from .fast import (render_frame_fast, render_frame_fast_diff,
                   render_frame_fast_stats)
from .photons import (PhotonGrid, PhotonKd, PhotonMap, build_photon_kdtree,
                      gather_photons_grid, gather_photons_kd, photon_grid,
                      render_photon_preview, trace_photons)
from .renderer import Renderer, render_frame, to_rgb8

__all__ = ["PhotonGrid", "PhotonKd", "PhotonMap", "Renderer",
           "build_photon_kdtree", "gather_photons_grid", "gather_photons_kd",
           "photon_grid", "render_frame", "render_frame_fast",
           "render_frame_fast_diff", "render_frame_fast_stats",
           "render_photon_preview", "to_rgb8", "trace_photons"]
