"""Packed Whitted forward frame (``snail_tpu.render.fast``).

Every wavefront quantity is a flat (R,) float32 tensor in packet order:
primary rays come from the camera kernels (``ops.traverse.camera_trace``),
shading data from one row gather of ``scene.sh_pack`` per hit, and each
light casts one shadow wavefront through the shared-origin any-hit
kernels (``ops.traverse.any_hit_shared``). Numerics — attenuation
polynomial, 0.9999 shadow epsilon, dot^16 specular — are the JAX
package's (reference scene_inl.h:89-167).

Reflection and transparency bounces, textures and photon radiance are
later slices of the port: options that would run them raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..core.types import Camera, RenderOpts
from ..core.vecmath import BIG
from ..ops.traverse import (PACKET_R, QX, TILE, any_hit_shared,
                            camera_trace)


def _packets_to_image(cr, cg, cb, width: int, height: int):
    """Packet order -> (H, W, 3) image. Flat order is (ty, tx, qy, qx, iy,
    ix): TILE x TILE tiles cut into 32 x 32 quadrants."""
    img = torch.stack([cr, cg, cb], dim=0).reshape(
        3, height // TILE, width // TILE, TILE // 32, QX, 32, 32)
    return img.permute(1, 3, 5, 2, 4, 6, 0).reshape(height, width, 3)


def _check_supported(scene, opts: RenderOpts) -> None:
    if opts.reflections and opts.max_bounces > 0 and scene.has_refl:
        raise NotImplementedError(
            "reflection bounces are not ported yet (ROADMAP queue A item 5)")
    if opts.transparency and opts.max_bounces > 0 and scene.has_transp:
        raise NotImplementedError(
            "transparency bounces are not ported yet (ROADMAP queue A "
            "item 5)")
    if opts.textures and scene.textured:
        raise NotImplementedError(
            "textures are not ported yet (ROADMAP queue A item 6)")
    if opts.photons:
        raise NotImplementedError(
            "photon-map radiance is not ported yet (ROADMAP queue A "
            "item 13)")


def _packet_mean(c, mask):
    """Mean of ``c`` over the masked-in rays of each packet, per ray."""
    cm = torch.where(mask, c, 0.0).reshape(-1, PACKET_R)
    n = mask.reshape(-1, PACKET_R).sum(1).clamp_min(1)
    return torch.repeat_interleave(cm.sum(1) / n, PACKET_R)


def _shadow_rays(fl3, ldist, mask):
    """One light's shadow wavefront: unit directions ``fl3`` (three (R,),
    from the light) and tmax ``ldist * 0.9999`` for the rays in ``mask``.
    Returns (dirs, tmax); masked rays get tmax -BIG."""
    stm = torch.where(mask, ldist * 0.9999, -BIG)
    # masked rays (misses, backfaces) carry garbage directions that would
    # blow the packet's direction interval open: give them the packet's
    # mean live direction, a point inside its own cone
    m = [_packet_mean(c, mask) for c in fl3]
    # fully-masked packets: any nonzero dir keeps idir finite
    mlen = m[0] * m[0] + m[1] * m[1] + m[2] * m[2]
    m[2] = torch.where(mlen < 1e-12, 1.0, m[2])
    return tuple(torch.where(mask, c, mc) for c, mc in zip(fl3, m)), stm


def _surface(scene, o3, d3, dist, u, v, tri):
    """Hit mask, shading rows (``sh_pack`` gathered, (32, R)), normals
    and hit points of a traced wavefront from the shared origin ``o3``."""
    hit = (dist > 0.0) & (dist < BIG)
    st = torch.where(hit, tri, 0).long()
    # ONE row gather per hit: shading deltas + the material row
    sh = scene.sh_pack.index_select(0, st).T
    n3 = (sh[0] + sh[3] * u + sh[6] * v,
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


def shadow_wavefront(scene, o3, d3, dist, u, v, tri, lp):
    """The shadow wavefront a frame casts from the hits of a traced
    wavefront toward a light at ``lp``: (dirs, tmax) of ``_shadow_rays``."""
    hit, _, n3, p3 = _surface(scene, o3, d3, dist, u, v, tri)
    fl3, ldist, _, mask = _toward_light(p3, n3, hit, lp)
    return _shadow_rays(fl3, ldist, mask)


def _shade_and_light(scene, o3, d3, dist, u, v, tri, opts: RenderOpts):
    """Shading + lights for one traced wavefront (the slice of
    ``_shade_and_light`` without bounces, textures and photons).
    ``o3`` is the shared origin (three 0-d tensors). Returns (r, g, b)."""
    _check_supported(scene, opts)
    hit, sh, (nx, ny, nz), p3 = _surface(scene, o3, d3, dist, u, v, tri)
    kdr, kdg, kdb = sh[16], sh[17], sh[18]
    ksr, ksg, ksb = sh[19], sh[20], sh[21]

    dx, dy, dz = d3
    ndotd = torch.abs(dx * nx + dy * ny + dz * nz)
    dr = torch.where(hit, kdr * ndotd, 0.0)
    dg = torch.where(hit, kdg * ndotd, 0.0)
    db = torch.where(hit, kdb * ndotd, 0.0)

    # --- lights (TraceLight, scene_inl.h:89-167) ---
    ldr = torch.full_like(dr, opts.ambient)
    ldg = torch.full_like(dr, opts.ambient)
    ldb = torch.full_like(dr, opts.ambient)
    lsr = torch.zeros_like(dr)
    lsg = torch.zeros_like(dr)
    lsb = torch.zeros_like(dr)
    lights = scene.lights
    for i in range(0 if lights is None else len(lights)):
        lp = lights.pos[i]
        fl3, ldist, dot, mask = _toward_light(p3, (nx, ny, nz), hit, lp)
        if opts.shadows:
            sd3, stm = _shadow_rays(fl3, ldist, mask)
            blocked = any_hit_shared(scene, lp, sd3, stm)
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
        ldr = ldr + lc[0] * dm
        ldg = ldg + lc[1] * dm
        ldb = ldb + lc[2] * dm
        lsr = lsr + lc[0] * sm
        lsg = lsg + lc[1] * sm
        lsb = lsb + lc[2] * sm

    sr = torch.where(hit, ksr, 0.0)
    sg = torch.where(hit, ksg, 0.0)
    sb = torch.where(hit, ksb, 0.0)
    cr = torch.where(hit, dr * ldr + sr * lsr, 0.0)
    cg = torch.where(hit, dg * ldg + sg * lsg, 0.0)
    cb = torch.where(hit, db * ldb + sb * lsb, 0.0)
    return cr, cg, cb


def render_frame_fast(scene, camera: Camera, width: int, height: int,
                      opts: RenderOpts = RenderOpts()) -> torch.Tensor:
    """Full-frame packed Whitted render: primary wavefront, shading and
    one shadow wavefront per light. Returns (H, W, 3) float32 on the
    scene's device. Width and height must be multiples of TILE (64)."""
    dist, u, v, tri, dx, dy, dz = camera_trace(scene, camera, width, height)
    if not opts.shading:
        idist = torch.where((dist > 0.0) & (dist < BIG), 1.0 / dist, 0.0)
        cr, cg, cb = idist * 20.0, idist * 250.0, idist * 2.0
    else:
        o3 = (camera.pos[0], camera.pos[1], camera.pos[2])
        cr, cg, cb = _shade_and_light(scene, o3, (dx, dy, dz), dist, u, v,
                                      tri, opts)
    return _packets_to_image(cr, cg, cb, width, height)
