"""The portable Whitted integrator over (R, 3) ray wavefronts
(``snail_tpu.render.integrator``): the reference's RayTrace and
TraceLight (scene_inl.h:89-496) as tensor code, for frames of any size.

Traversal goes through the dispatch seam (``ops.dispatch``: the worklist
or the walk kernels, by what the scene holds), closest hits through the
differentiable recompute of ``diff.vjp.diff_closest_hit``, so the whole
integrator is differentiable with hit ids held constant. Its numerics are
the JAX integrator's, not the packed fast path's: ``|dir . n|`` shading,
light vectors normalised by division with a nudge where a hit sits on the
light, transparency rays continued from ``dist + 0.1``, reflection rays
from 0.001 along the mirrored direction, and bounces unrolled statically
up to ``opts.max_bounces``. A wavefront of a scene with no reflective (or
no transparent, and no dissolve-mapped) material traces no such bounce:
its rays would all be masked. A textured scene's hits read their diffuse
colour from its atlas, the primary wavefront's tiles giving the uv
footprint, and their opacity from a dissolve map (``map_d``, point-sampled
at mip 0), which the packed frame does not read (JAX integrator.py:80-103).
With ``opts.photons`` and a ``photon_grid`` (``render.photons``), every
wavefront's hits, the bounces' too, add the grid's gathered irradiance
times ``opts.photon_exposure`` to their diffuse light sum
(JAX integrator.py:253-262; the packed frame gathers on its primary hits
only, ROADMAP C18).
"""

from __future__ import annotations

import torch

from ..core.types import RenderOpts
from ..core.vecmath import BIG
from ..diff.vjp import diff_closest_hit
from ..ops import dispatch
from ..scene.textures import sample_atlas, sample_diffuse
from .fast import _SmallLookup
from .photons import gather_photons_grid


def shade_hits(scene, orig, dirn, dist, tri, bary, opts: RenderOpts,
               tile_hw=None):
    """Shading attributes at the hits of a traced wavefront: a dict of
    hit, pos, normal, mat, diffuse and specular base colours, opacity and
    reflectivity, (R,) or (R, 3) each (the wavefront form of
    ``shading::Sample``, scene_inl.h:218-300). ``tile_hw``: the tiles of
    a wavefront in tile packet order, whose uv differences give a textured
    hit its footprint (None: mip 0)."""
    hit = (dist > 0.0) & (dist < BIG)
    safe_tri = torch.where(hit, tri, 0).long()
    u, v = bary[:, 0:1], bary[:, 1:2]
    # a miss carries dist = BIG: its position collapses to the origin
    pos = orig + dirn * torch.where(hit, dist, 0.0)[:, None]
    sh = scene.sh_pack.index_select(0, safe_tri)
    normal = sh[:, 0:3] + sh[:, 3:6] * u + sh[:, 6:9] * v
    mat = torch.where(hit, scene.sh_mat.index_select(0, safe_tri), 0).long()
    kd = _SmallLookup.apply(scene.mat_diffuse, mat).T
    ks = _SmallLookup.apply(scene.mat_specular, mat).T
    mrow = scene.mat_pack.index_select(0, mat)
    opacity = mrow[:, 7]
    if opts.textures and scene.tex_atlas is not None:
        uv = sh[:, 9:11] + sh[:, 11:13] * u + sh[:, 13:15] * v
        tex_id = mrow[:, 8].to(torch.int32)
        rgb = sample_diffuse(scene, opts, tex_id, uv, hit, tile_hw)
        kd = torch.where((tex_id >= 0)[:, None], rgb, kd)
        if scene.has_diss_tex:  # else every id is -1: opacity as it is
            diss_id = mrow[:, 9].to(torch.int32)
            diss = sample_atlas(scene.tex_atlas, scene.tex_meta, diss_id, uv)
            opacity = torch.where(diss_id >= 0, diss[:, 0], opacity)
    # |dir . n| (simple_material.h:19, uber_material.h:16)
    ndotd = torch.abs((dirn * normal).sum(-1))
    h3 = hit[:, None]
    return {
        "hit": hit,
        "pos": pos,
        "normal": normal,
        "mat": mat,
        "diffuse": torch.where(h3, kd * ndotd[:, None], 0.0),
        "specular": torch.where(h3, ks, 0.0),
        "opacity": torch.where(hit, opacity, 1.0),
        "reflect": torch.where(hit, mrow[:, 6], 0.0),
    }


def trace_light(scene, samples, light_pos, light_color, light_radius, sel,
                opts: RenderOpts):
    """One light's diffuse and specular contribution, (R, 3) each, with
    shadows traced from the light through the dispatch seam (TraceLight,
    scene_inl.h:89-167); ``sel`` masks the live samples."""
    light_vec = samples["pos"] - light_pos  # from the light to the surface
    close = (light_vec * light_vec).sum(-1) < 1e-4
    light_vec = torch.where(close[:, None], light_vec.new_tensor(
        [0.0, 1.0, 0.0]), light_vec)
    dist = torch.sqrt((light_vec * light_vec).sum(-1))
    from_light = light_vec / dist[:, None]
    dot = (samples["normal"] * from_light).sum(-1)
    mask = sel & (dot > 0.0)
    if opts.shadows:
        tmax = torch.where(mask, dist * 0.9999, -BIG)
        lit = mask & ~dispatch.any_hit_from(scene, light_pos, from_light,
                                            tmax)
    else:
        lit = mask
    atten = dist * (1.0 / light_radius)
    atten = torch.clamp_min(
        (1.0 - atten) * 0.2 + 1.0 / (16.0 * atten * atten) - 0.0625, 0.0)
    spec = dot * dot
    spec = spec * spec
    spec = spec * spec
    spec = spec * spec
    lit3 = lit[:, None]
    return (torch.where(lit3, light_color * (dot * atten)[:, None], 0.0),
            torch.where(lit3, light_color * (spec * atten)[:, None], 0.0))


def render_wavefront(scene, orig, dirn, tmax, opts: RenderOpts,
                     depth: int = 0, tile_hw=None,
                     photon_grid=None) -> torch.Tensor:
    """Trace and shade one wavefront of rays ``orig``/``dirn`` (R, 3) up to
    ``tmax`` (R,), a negative tmax masking the ray; bounces recurse up to
    ``opts.max_bounces``. ``tile_hw`` (th, tw): the wavefront is in
    row-major tile order, which gives the primary hits their uv footprint.
    ``photon_grid``, with ``opts.photons``: the photon term, on this
    wavefront and its bounces. Returns colour (R, 3) (RayTrace,
    scene_inl.h:169-496)."""
    dist, tri, bary = diff_closest_hit(scene, orig, dirn, tmax)
    if not opts.shading:
        # the distance view (scene_inl.h:204-212)
        idist = torch.where(dist > 0.0,
                            1.0 / torch.clamp_min(dist, 1e-6), 0.0)
        idist = torch.where(dist >= BIG, 0.0, idist)
        return torch.stack([idist * 20.0, idist * 250.0, idist * 2.0], -1)

    s = shade_hits(scene, orig, dirn, dist, tri, bary, opts,
                   tile_hw if depth == 0 else None)
    sel = s["hit"] & (tmax >= 0.0)
    diffuse = s["diffuse"]
    bounce = depth < opts.max_bounces

    # reflections (scene_inl.h:434-444)
    if opts.reflections and bounce and scene.has_refl:
        rsel = sel & (s["reflect"] > 0.0)
        n = s["normal"]
        rdir = dirn - 2.0 * (dirn * n).sum(-1, keepdim=True) * n
        rcol = render_wavefront(scene, s["pos"] + rdir * 0.001, rdir,
                                torch.where(rsel, BIG, -BIG), opts, depth + 1,
                                photon_grid=photon_grid)
        blend = s["reflect"][:, None]
        diffuse = torch.where(rsel[:, None],
                              diffuse + (rcol - diffuse) * blend, diffuse)

    # transparency continuation (scene_inl.h:445-458)
    diss_mapped = opts.textures and scene.has_diss_tex
    if opts.transparency and bounce and (scene.has_transp or diss_mapped):
        tsel = sel & (s["opacity"] < 1.0)
        # a miss carries dist = BIG: its origin is masked anyway
        tdist = torch.where(s["hit"], dist, 0.0)
        tcol = render_wavefront(scene, orig + dirn * (tdist[:, None] + 0.1),
                                dirn, torch.where(tsel, BIG, -BIG), opts,
                                depth + 1, photon_grid=photon_grid)
        op = s["opacity"][:, None]
        diffuse = torch.where(tsel[:, None],
                              tcol + (diffuse - tcol) * op, diffuse)

    # lights (scene_inl.h:460-487)
    l_diffuse = torch.full_like(diffuse, opts.ambient)
    l_specular = torch.zeros_like(diffuse)
    lights = scene.lights
    for i in range(0 if lights is None else len(lights)):
        d, sp = trace_light(scene, s, lights.pos[i], lights.color[i],
                            lights.radius[i], sel, opts)
        l_diffuse = l_diffuse + d
        l_specular = l_specular + sp
    # photon radiance (GatherPhotons during shading, photons.cpp:68-195)
    if opts.photons and photon_grid is not None:
        l_diffuse = l_diffuse + gather_photons_grid(
            photon_grid, s["pos"]) * opts.photon_exposure
    color = diffuse * l_diffuse + s["specular"] * l_specular
    return torch.where(sel[:, None], color, 0.0)
