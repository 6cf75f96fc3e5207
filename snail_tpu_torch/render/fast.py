"""Packed Whitted frame and its differentiable twin
(``snail_tpu.render.fast``).

Every wavefront quantity is a flat (R,) float32 tensor in packet order:
primary rays come from the camera kernels (``ops.traverse.camera_trace``),
shading data from one gather of ``scene.sh_pack`` per traced wavefront
(``ops.gather.surface_rows``: the columns the shading reads, each in a
plane), each light
casts one shadow wavefront through the shared-origin any-hit kernels
(``ops.traverse.any_hit_shared``), and reflection and transparency
bounces trace rays with their own origins through the general kernels
(``ops.traverse.closest_hit_c``). Numerics — attenuation polynomial,
0.9999 shadow epsilon, dot^16 specular — are the JAX package's
(reference scene_inl.h:89-167, 434-458).

The differentiable frame takes traversal topology (hit ids) from the same
kernels under ``torch.no_grad`` and recomputes distance and barycentrics
in closed form from the primal triangle arrays, so gradients flow to the
vertices, the material colours, the lights and the camera position.

The counter frame (``render_frame_fast_stats``) is the forward frame
through the counting kernels (B8a/B8b, or B9e/B9f on a scene with node
tables) on its primary and shadow wavefronts. Other tracers plug into
the same shading through the ``normals``/``any_hit``/``bounce`` hooks of
``_shade_and_light``
(instanced scenes, ``scene.instancing``).

A textured scene's hits take their diffuse colour from its atlas
(``scene.textures.sample_diffuse``, JAX fast.py:159-192): the primary
wavefront's 32 x 32 quadrants give each hit a uv footprint, which picks
the mip (and the SAT rect); bounce wavefronts sample mip 0. As in the JAX
package, this frame reads no dissolve map.

With ``opts.photons`` and a ``photon_grid`` (``render.photons``), the
primary wavefront's hits add the grid's gathered irradiance times
``opts.photon_exposure`` to their diffuse light sum (JAX fast.py:382-394);
as in the JAX package, the bounce wavefronts of this frame gather none
(ROADMAP C18), and ``photons`` without a grid adds nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.types import Camera, RenderOpts
from ..core.vecmath import BIG, rsqrt_rn
from ..ops.gather import surface_rows
from ..ops.traverse import (QX, STATS, TILE, _pixel_xy, any_hit_shared,
                            any_hit_shared_stats, camera_trace,
                            camera_trace_stats, closest_hit_c, is_fat,
                            substitute_masked)
from ..scene.textures import sample_diffuse
from ..utils import trace

DIFF_ROWS = 42  # sh_pack (32) | tri_a | tri_ba | tri_ca (9) | mat id
# sh_pack's columns as the shading reads them: the normal rows n0, n_e1,
# n_e2; uv0, uv_e1, uv_e2; the material row's diffuse, specular,
# reflectivity and opacity; its diffuse texture id
NORMAL_COLS = tuple(range(0, 9))
UV_COLS = tuple(range(9, 15))
MATERIAL_COLS = tuple(range(16, 24))
REFL_COL, OPACITY_COL, TEX_COL = 22, 23, 24


def _packets_to_image(cr, cg, cb, width: int, height: int):
    """Packet order -> (H, W, 3) image. Flat order is (ty, tx, qy, qx, iy,
    ix): TILE x TILE tiles cut into 32 x 32 quadrants."""
    img = torch.stack([cr, cg, cb], dim=0).reshape(
        3, height // TILE, width // TILE, TILE // 32, QX, 32, 32)
    return img.permute(1, 3, 5, 2, 4, 6, 0).reshape(height, width, 3)


class _SmallLookup(torch.autograd.Function):
    """(C, R) rows of a small (M, C) table gathered by id. The backward
    sums the cotangent over the rays of each id, one masked reduction per
    row (the JAX package's custom VJP, fast.py:70-98): a scatter-add would
    put a million colliding atomics into a handful of rows."""

    @staticmethod
    def forward(ctx, tbl, idx):
        ctx.save_for_backward(idx)
        ctx.m = tbl.shape[0]
        return tbl.index_select(0, idx).T

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        d = torch.stack([torch.where(idx[None, :] == m, g, 0.0).sum(1)
                         for m in range(ctx.m)])
        return d, None


def shadow_tmax(ldist, mask):
    """tmax of the shadow rays toward one light: ``ldist * 0.9999`` for
    the rays in ``mask``, -BIG (masked) for the others."""
    return torch.where(mask, ldist * 0.9999, -BIG)


def _shadow_rays(fl3, ldist, mask):
    """One light's shadow wavefront for the shared-origin kernels: unit
    directions ``fl3`` (three (R,), from the light) and ``shadow_tmax``.
    Returns (dirs, tmax); masked rays get, in place of their garbage
    directions (misses, backfaces), the packet's mean live direction,
    which keeps its direction interval as it is."""
    stm = shadow_tmax(ldist, mask)
    return substitute_masked(fl3, stm, unit_fallback=True), stm


class _Planes:
    """Gathered ``sh_pack`` columns addressed by column number: ``p[k]``
    is column k's (R,) plane, ``p[a:b]`` the (b - a, R) planes of columns
    a to b - 1, each of them gathered. A (C, R) tensor of whole rows (the
    differentiable frame's pack columns, the instanced frame's rows) is
    addressed the same way by its own indexing."""

    def __init__(self, planes, cols):
        self.planes = planes
        self.at = {c: i for i, c in enumerate(cols)}

    def __getitem__(self, k):
        if isinstance(k, slice):
            i, n = self.at[k.start], k.stop - k.start
            if self.at.get(k.stop - 1) != i + n - 1:
                raise KeyError(f"columns {k.start}:{k.stop} not all gathered")
            return self.planes[i:i + n]
        return self.planes[self.at[k]]


def _surface(scene, o3, d3, dist, u, v, tri, sh=None, normals=None,
             textured=False):
    """Hit mask, shading rows (unless given: ``sh_pack``'s material
    columns, the normal rows unless ``normals`` are given, and the uv rows
    and texture id if ``textured``, gathered as :class:`_Planes`), normals
    (interpolated, unless given) and hit points of a traced wavefront from
    ``o3`` (a shared origin, three 0-d tensors, or three (R,))."""
    hit = (dist > 0.0) & (dist < BIG)
    if sh is None:
        cols = ((() if normals is not None else NORMAL_COLS)
                + (UV_COLS if textured else ()) + MATERIAL_COLS
                + ((TEX_COL,) if textured else ()))
        with trace.span("snail.gather"):
            sh = _Planes(surface_rows(scene.sh_pack, dist, tri, cols), cols)
    n3 = normals if normals is not None else (
        sh[0] + sh[3] * u + sh[6] * v,
        sh[1] + sh[4] * u + sh[7] * v,
        sh[2] + sh[5] * u + sh[8] * v)
    # miss rays carry dist = BIG: collapse their positions to the origin
    safe_dist = torch.where(hit, dist, 0.0)
    p3 = tuple(o + d * safe_dist for o, d in zip(o3, d3))
    return hit, sh, n3, p3


def _toward_light(p3, n3, hit, lp):
    """Unit vectors from the light at ``lp`` to the hit points ``p3``,
    their distances, n.l, and the mask of hits that face the light."""
    lv = [p3[k] - lp[k] for k in range(3)]
    ld2 = lv[0] * lv[0] + lv[1] * lv[1] + lv[2] * lv[2]
    ldist = torch.sqrt(torch.clamp_min(ld2, 1e-12))
    ild = 1.0 / ldist
    fl3 = tuple(c * ild for c in lv)
    dot = n3[0] * fl3[0] + n3[1] * fl3[1] + n3[2] * fl3[2]
    return fl3, ldist, dot, hit & (dot > 0.0)


def _reflect_rays(d3, n3, p3, rsel):
    """Mirror rays of the hits in ``rsel`` (scene_inl.h:434-444): origins
    nudged 0.001 along the mirrored direction, tmax BIG, others masked."""
    dn = d3[0] * n3[0] + d3[1] * n3[1] + d3[2] * n3[2]
    rd3 = tuple(d - 2.0 * dn * n for d, n in zip(d3, n3))
    ro3 = tuple(p + r * 0.001 for p, r in zip(p3, rd3))
    return ro3, rd3, torch.where(rsel, BIG, -BIG)


def shadow_wavefront(scene, o3, d3, dist, u, v, tri, lp):
    """The shadow wavefront a frame casts from the hits of a traced
    wavefront toward a light at ``lp``: (dirs, tmax) of ``_shadow_rays``."""
    hit, _, n3, p3 = _surface(scene, o3, d3, dist, u, v, tri)
    fl3, ldist, _, mask = _toward_light(p3, n3, hit, lp)
    return _shadow_rays(fl3, ldist, mask)


def bounce_wavefront(scene, o3, d3, dist, u, v, tri):
    """The reflection wavefront a frame casts from the hits of a traced
    wavefront: (o3, d3, tmax) of ``_reflect_rays``, the rays of hits on
    reflective materials live."""
    hit, sh, n3, p3 = _surface(scene, o3, d3, dist, u, v, tri)
    return _reflect_rays(d3, n3, p3, hit & (sh[REFL_COL] > 0.0))


def _lights(scene, p3, n3, hit, opts: RenderOpts, any_hit=None,
            stats_out=None):
    """Diffuse and specular light sums (TraceLight, scene_inl.h:89-167):
    ((ldr, ldg, ldb), (lsr, lsg, lsb)). Shadow rays are traced on detached
    tensors: visibility is piecewise constant. ``any_hit(lp, dirs,
    tmax)``, where given, traces them in place of the shared-origin
    kernels and gets the directions as they are (the packet-mean
    substitution serves those kernels only, JAX fast.py:343-344);
    ``stats_out``, a list, gets each shadow wavefront's counters (B8b)."""
    ld = [torch.full_like(hit, opts.ambient, dtype=torch.float32)] * 3
    ls = [torch.zeros_like(hit, dtype=torch.float32)] * 3
    lights = scene.lights
    for i in range(0 if lights is None else len(lights)):
        lp = lights.pos[i]
        fl3, ldist, dot, mask = _toward_light(p3, n3, hit, lp)
        if opts.shadows:
            with torch.no_grad(), trace.span("snail.shadow"):
                fl3d = tuple(c.detach() for c in fl3)
                stm = shadow_tmax(ldist.detach(), mask)
                if any_hit is not None:
                    blocked = any_hit(lp.detach(), fl3d, stm)
                else:
                    sd3 = substitute_masked(fl3d, stm, unit_fallback=True)
                    if stats_out is None:
                        blocked = any_hit_shared(scene, lp.detach(), sd3,
                                                 stm)
                    else:
                        blocked, st = any_hit_shared_stats(
                            scene, lp.detach(), sd3, stm)
                        stats_out.append(st)
            lit = mask & ~blocked
        else:
            lit = mask
        at = ldist * (1.0 / lights.radius[i])
        atten = torch.clamp_min(
            (1.0 - at) * 0.2 + 1.0 / (16.0 * at * at) - 0.0625, 0.0)
        dm = torch.where(lit, dot * atten, 0.0)
        sm = dot * dot
        sm = sm * sm
        sm = sm * sm
        sm = sm * sm
        sm = torch.where(lit, sm * atten, 0.0)
        lc = lights.color[i]
        ld = [ld[k] + lc[k] * dm for k in range(3)]
        ls = [ls[k] + lc[k] * sm for k in range(3)]
    return ld, ls


def _shade_and_light(scene, o3, d3, dist, u, v, tri, opts: RenderOpts,
                     depth: int, pack: Optional[torch.Tensor] = None,
                     sh_row=None, normals=None, any_hit=None, bounce=None,
                     stats_out=None, tile_hw=(32, 32), photon_grid=None):
    """Shading, bounces and lights of one traced wavefront. ``o3``: a
    shared origin (three 0-d tensors) or three (R,). ``pack``: the
    differentiable frame's (T, DIFF_ROWS) table, whose gathered columns
    ``sh_row`` carry the mat id: material colours then come from the
    primal ``mat_diffuse``/``mat_specular``.

    Hooks for other tracers (JAX fast.py:101-104): ``normals`` (three
    (R,)) replace the interpolated ones, ``any_hit`` traces the shadow
    rays (see :func:`_lights`) and ``bounce(o3, d3, tmax, depth)`` traces
    and shades a bounce wavefront in place of :func:`_trace_and_shade`.
    ``stats_out`` collects the counters of this wavefront's shadow rays,
    not those of its bounces (as the JAX package). ``tile_hw``: the tiles
    of the wavefront's pixels, whose uv differences give a textured hit
    its footprint at depth 0 (the kernels' 32 x 32 quadrants; None: no
    footprint). ``photon_grid``, with ``opts.photons``, adds the photon
    term to this wavefront's diffuse light sum (not to its bounces').
    Returns (r, g, b)."""
    with trace.span("snail.shade"):
        trace_bounce = bounce or (
            lambda bo3, bd3, btm, bdepth: _trace_and_shade(
                scene, bo3, bd3, btm, opts, bdepth, pack))
        textured = opts.textures and scene.tex_atlas is not None
        hit, sh, n3, p3 = _surface(scene, o3, d3, dist, u, v, tri, sh_row,
                                   normals, textured)
        if pack is not None:
            mid = sh[DIFF_ROWS - 1].long()
            kd = _SmallLookup.apply(scene.mat_diffuse, mid)
            ks = _SmallLookup.apply(scene.mat_specular, mid)
        else:
            kd, ks = sh[16:19], sh[19:22]
        if textured:
            uv = torch.stack([sh[9] + sh[11] * u + sh[13] * v,
                              sh[10] + sh[12] * u + sh[14] * v], -1)
            tex_id = sh[TEX_COL].to(torch.int32)
            rgb = sample_diffuse(scene, opts, tex_id, uv, hit,
                                 tile_hw if depth == 0 else None)
            kd = torch.where(tex_id[None] >= 0, rgb.T, kd)

        ndotd = torch.abs(d3[0] * n3[0] + d3[1] * n3[1] + d3[2] * n3[2])
        dc = [torch.where(hit, kd[k] * ndotd, 0.0) for k in range(3)]

        # --- reflections (scene_inl.h:434-444). Traced whenever the scene
        # has a reflective material, with no test for a selected ray: the
        # JAX package's lax.cond skip would be a host sync here ---
        if opts.reflections and depth < opts.max_bounces and scene.has_refl:
            refl = torch.where(hit, sh[REFL_COL], 0.0)
            rsel = hit & (refl > 0.0)
            ro3, rd3, rtm = _reflect_rays(d3, n3, p3, rsel)
            rc = trace_bounce(ro3, rd3, rtm, depth + 1)
            dc = [torch.where(rsel, dc[k] + (rc[k] - dc[k]) * refl, dc[k])
                  for k in range(3)]

        # --- transparency continuation (scene_inl.h:445-458) ---
        if opts.transparency and depth < opts.max_bounces and scene.has_transp:
            opac = torch.where(hit, sh[OPACITY_COL], 1.0)
            tsel = hit & (opac < 1.0)
            to3 = tuple(p + d * 0.1 for p, d in zip(p3, d3))
            ttm = torch.where(tsel, BIG, -BIG)
            tc = trace_bounce(to3, d3, ttm, depth + 1)
            dc = [torch.where(tsel, tc[k] + (dc[k] - tc[k]) * opac, dc[k])
                  for k in range(3)]

        ld, ls = _lights(scene, p3, n3, hit, opts, any_hit, stats_out)
        if opts.photons and photon_grid is not None:
            from .photons import gather_photons_grid

            rad = gather_photons_grid(photon_grid, torch.stack(p3, -1)) \
                * opts.photon_exposure
            ld = [ld[k] + torch.where(hit, rad[:, k], 0.0) for k in range(3)]
        return tuple(torch.where(hit, dc[k] * ld[k]
                                 + torch.where(hit, ks[k], 0.0) * ls[k], 0.0)
                     for k in range(3))


def _recompute_from_rows(row, o3, d3):
    """Differentiable (dist, u, v) of known hits from gathered primal
    [a | ba | ca] (9, R) columns (the Moller test in closed form)."""
    a, ba, ca = row[0:3], row[3:6], row[6:9]
    nx = ba[1] * ca[2] - ba[2] * ca[1]
    ny = ba[2] * ca[0] - ba[0] * ca[2]
    nz = ba[0] * ca[1] - ba[1] * ca[0]
    tvx, tvy, tvz = o3[0] - a[0], o3[1] - a[1], o3[2] - a[2]
    dx, dy, dz = d3
    det = dx * nx + dy * ny + dz * nz
    idet = 1.0 / torch.where(det == 0.0, 1e-30, det)
    c1x = tvy * ca[2] - tvz * ca[1]
    c1y = tvz * ca[0] - tvx * ca[2]
    c1z = tvx * ca[1] - tvy * ca[0]
    c2x = ba[1] * tvz - ba[2] * tvy
    c2y = ba[2] * tvx - ba[0] * tvz
    c2z = ba[0] * tvy - ba[1] * tvx
    u = (dx * c1x + dy * c1y + dz * c1z) * idet
    v = (dx * c2x + dy * c2y + dz * c2z) * idet
    dist = -(tvx * nx + tvy * ny + tvz * nz) * idet
    return dist, u, v


def _primary_dirs_planar(camera: Camera, width: int, height: int):
    """Differentiable primary-ray directions, flat (R,) components in the
    kernels' packet order (``ops.traverse._pixel_xy``)."""
    p = (width // TILE) * (height // TILE)
    px, py = _pixel_xy(width, height, torch.arange(p), camera.pos.device)
    inv_h = torch.tensor(1.0 / height, dtype=torch.float32)
    x = ((px.float() + 0.5 - width * 0.5) * inv_h).reshape(-1)
    y = ((height * 0.5 - py.float() - 0.5) * inv_h).reshape(-1)
    f = camera.front * camera.plane_dist
    d = [camera.right[k] * x + camera.up[k] * y + f[k] for k in range(3)]
    inv_len = rsqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return tuple(c * inv_len for c in d)


def _diff_pack(scene) -> torch.Tensor:
    """(T, DIFF_ROWS) rows: sh_pack | tri_a | tri_ba | tri_ca | mat id, the
    differentiable frame's one gather per wavefront. The concatenation is
    differentiable, so vertex gradients flow through the gathered rows;
    the mat id rides as float32 (exact below 2^24)."""
    with trace.span("snail.gather"):
        return torch.cat([scene.sh_pack, scene.tri_a, scene.tri_ba,
                          scene.tri_ca, scene.sh_mat.float()[:, None]], dim=1)


def _hit_rows(pack, o3, d3, dist, tri):
    """Gathered pack columns (DIFF_ROWS, R) of the hits of a traced
    wavefront, and its (dist, u, v) recomputed from them (misses keep
    ``dist``, u = v = 0)."""
    hit = (dist > 0.0) & (dist < BIG)
    with trace.span("snail.gather"):
        row = pack.index_select(0, torch.where(hit, tri, 0).long()).T
    rd, ru, rv = _recompute_from_rows(row[32:41], o3, d3)
    return (row, torch.where(hit, rd, dist), torch.where(hit, ru, 0.0),
            torch.where(hit, rv, 0.0))


def _trace_and_shade(scene, o3, d3, tmax, opts: RenderOpts, depth: int,
                     pack: Optional[torch.Tensor] = None):
    """Closest hit of a bounce wavefront, then its shading. With ``pack``
    the kernels run on detached tensors and (dist, u, v) are recomputed
    differentiably."""
    if pack is not None:
        with torch.no_grad():
            dist, _, _, tri = closest_hit_c(
                scene, tuple(c.detach() for c in o3),
                tuple(c.detach() for c in d3), tmax)
        sh_row, dist, u, v = _hit_rows(pack, o3, d3, dist, tri)
    else:
        dist, u, v, tri = closest_hit_c(scene, o3, d3, tmax)
        sh_row = None
    dist = torch.where(dist < tmax.clamp_max(BIG), dist, BIG)
    dist = torch.where(tmax >= 0.0, dist, -BIG)
    return _shade_and_light(scene, o3, d3, dist, u, v, tri, opts, depth,
                            pack, sh_row)


def render_frame_fast(scene, camera: Camera, width: int, height: int,
                      opts: RenderOpts = RenderOpts(),
                      photon_grid=None) -> torch.Tensor:
    """Full-frame packed Whitted render: primary wavefront, shading, one
    shadow wavefront per light and the bounces of ``opts``; with
    ``opts.photons``, the photon term of ``photon_grid`` on the primary
    hits. Returns (H, W, 3) float32 on the scene's device. Width and
    height must be multiples of TILE (64)."""
    dist, u, v, tri, dx, dy, dz = camera_trace(scene, camera, width, height)
    if not opts.shading:
        idist = torch.where((dist > 0.0) & (dist < BIG), 1.0 / dist, 0.0)
        cr, cg, cb = idist * 20.0, idist * 250.0, idist * 2.0
    else:
        o3 = (camera.pos[0], camera.pos[1], camera.pos[2])
        cr, cg, cb = _shade_and_light(scene, o3, (dx, dy, dz), dist, u, v,
                                      tri, opts, 0, photon_grid=photon_grid)
    return _packets_to_image(cr, cg, cb, width, height)


def stats_path_available(scene) -> bool:
    """Whether the counter frame can render ``scene``: it needs leaves of
    at most IVAL_LEAF triangles, traced by the worklist kernels (B8a/B8b)
    or the walk kernels (B9e/B9f); a fat-leaf scene has no counters (JAX
    fast.py:531-541)."""
    return not is_fat(scene)


def render_frame_fast_stats(scene, camera: Camera, width: int, height: int,
                            opts: RenderOpts = RenderOpts()):
    """:func:`render_frame_fast` through the counting kernels (B8a for
    the primary wavefront, B8b for each light's shadow wavefront from the
    primary hits; B9e and B9f on a scene with node tables; bounce
    wavefronts run uncounted, as in the JAX package). Returns (image, the
    same as render_frame_fast's bit for bit, and a dict of real in-kernel
    counts summed over the frame's packets: ``nodes``, ``leaves``,
    ``quarters``, ``tri_blocks``, ``chunks`` (see
    ``ops.traverse.camera_wl_stats``, ``walk_camera_stats``) and ``rays``
    = width * height * (1 + lights with shadows on)). A fat-leaf scene
    raises ValueError (:func:`stats_path_available`)."""
    dist, u, v, tri, dx, dy, dz, pstats = camera_trace_stats(
        scene, camera, width, height)
    stats_out = [pstats]
    if not opts.shading:
        idist = torch.where((dist > 0.0) & (dist < BIG), 1.0 / dist, 0.0)
        cr, cg, cb = idist * 20.0, idist * 250.0, idist * 2.0
    else:
        o3 = (camera.pos[0], camera.pos[1], camera.pos[2])
        cr, cg, cb = _shade_and_light(scene, o3, (dx, dy, dz), dist, u, v,
                                      tri, opts, 0, stats_out=stats_out)
    img = _packets_to_image(cr, cg, cb, width, height)
    # summed on the device; one copy to the host
    tot = torch.stack([st.sum(0, dtype=torch.int64)
                       for st in stats_out]).sum(0).cpu().tolist()
    n_lights = 0 if scene.lights is None else len(scene.lights)
    stats = dict(zip(STATS, tot))
    stats["rays"] = width * height * (1 + (n_lights if opts.shadows else 0))
    return img, stats


def render_frame_fast_diff(scene, camera: Camera, width: int, height: int,
                           opts: RenderOpts = RenderOpts()) -> torch.Tensor:
    """Differentiable packed Whitted render; returns (H, W, 3) float32.

    Hit ids come from the camera kernels under ``torch.no_grad``; primary
    directions, distances and barycentrics are recomputed in closed form,
    and material colours gathered from ``mat_diffuse``/``mat_specular``.
    Gradients flow to ``scene.tri_a``/``tri_ba``/``tri_ca``,
    ``mat_diffuse``/``mat_specular``, the lights' ``pos``/``color`` and
    ``camera.pos``, through the bounces too."""
    with torch.no_grad():
        dist0, _, _, tri, _, _, _ = camera_trace(scene, camera, width,
                                                 height)
    d3 = _primary_dirs_planar(camera, width, height)
    o3 = (camera.pos[0], camera.pos[1], camera.pos[2])
    pack = _diff_pack(scene)
    row, dist, u, v = _hit_rows(pack, o3, d3, dist0, tri)
    cr, cg, cb = _shade_and_light(scene, o3, d3, dist, u, v, tri, opts, 0,
                                  pack, row)
    return _packets_to_image(cr, cg, cb, width, height)
