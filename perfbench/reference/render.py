"""The plain reference of the frames and of the inverse-rendering step.

A Whitted frame as the project defines it (the reference renderer's
camera.h:7-14 basis, ray_generator.cpp:41-44 primary rays, TraceLight of
scene_inl.h:89-167 and the bounces of scene_inl.h:434-458, render.cpp's
2 x 2 supersampling and ConvColor): flat face normals, |d . n| diffuse,
one shadow ray per light from the light, the attenuation polynomial and
dot^16 specular, and one level of reflection and transparency rays.

Everything is worked out from what the benchmark hands both sides: the
vertices and triangles, the material numbers, the light and the camera.
Hits come from ``hits.py``. The step is the same frame under autograd:
the hit triangles are found without gradients and the distance to each
is recomputed in closed form, so gradients reach the vertices, the
diffuse colours, the light and the camera position; normals are data.

``dtype`` runs the whole computation in another precision (the control
runs it in bfloat16).
"""

from __future__ import annotations

import dataclasses

import torch

from .hits import (BIG, Tris, blocked_shared, closest_general,
                   closest_shared)


@dataclasses.dataclass
class Inputs:
    """What the benchmark hands the program and the reference alike."""

    verts: torch.Tensor  # float32 (V, 3)
    tri_v: torch.Tensor  # int64 (T, 3)
    tri_mat: torch.Tensor  # int64 (T,)
    diffuse: torch.Tensor  # float32 (M, 3)
    specular: torch.Tensor  # float32 (M, 3)
    reflectivity: torch.Tensor  # float32 (M,)
    dissolve: torch.Tensor  # float32 (M,)
    light_pos: torch.Tensor  # float32 (L, 3)
    light_color: torch.Tensor  # float32 (L, 3)
    light_radius: torch.Tensor  # float32 (L,)


@dataclasses.dataclass(frozen=True)
class Opts:
    """The frame's switches (the reference's gVals)."""

    reflections: bool = False
    transparency: bool = False
    shadows: bool = True
    supersample: bool = False
    max_bounces: int = 1
    ambient: float = 0.1


class Scene:
    """The inputs in ``dtype``, with the unit face normals."""

    def __init__(self, inp: Inputs, dtype=torch.float32):
        self.dtype = dtype
        self.tris = Tris(inp.verts, inp.tri_v, dtype)
        n = self.tris.n
        ln = torch.sqrt(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]
                        + n[:, 2] * n[:, 2])
        self.normal = n / torch.clamp_min(ln, 1e-30)[:, None]
        self.mat = inp.tri_mat
        cast = lambda x: x.to(dtype)
        self.diffuse, self.specular = cast(inp.diffuse), cast(inp.specular)
        self.reflectivity, self.dissolve = (cast(inp.reflectivity),
                                            cast(inp.dissolve))
        self.light_pos, self.light_color = (cast(inp.light_pos),
                                            cast(inp.light_color))
        self.light_radius = cast(inp.light_radius)
        self.has_refl = bool((inp.reflectivity > 0).any())
        self.has_transp = bool((inp.dissolve < 1).any())


def look_at(pos, target, dtype=torch.float32):
    """(right, up, front) of a camera at ``pos`` looking at ``target``,
    the world's up (0, 1, 0)."""
    pos, target = pos.to(dtype), target.to(dtype)
    front = target - pos
    front = front / torch.linalg.vector_norm(front)
    right = torch.linalg.cross(front, torch.tensor(
        [0.0, 1.0, 0.0], dtype=dtype, device=pos.device))
    right = right / torch.linalg.vector_norm(right)
    return right, torch.linalg.cross(right, front), front


def primary_dirs(basis, width: int, height: int, px, py):
    """Unit directions (R, 3) through pixel centres (px, py) of a width x
    height image (focal distance 1 image height)."""
    right, up, front = basis
    dt = right.dtype
    inv_h = torch.tensor(1.0 / height, dtype=dt)
    half_w = torch.tensor(width * 0.5, dtype=dt)
    half_h = torch.tensor(height * 0.5, dtype=dt)
    x = (px.to(dt) + 0.5 - half_w) * inv_h
    y = (half_h - py.to(dt) - 0.5) * inv_h
    d = [right[k] * x + up[k] * y + front[k] for k in range(3)]
    inv_len = torch.rsqrt((d[0] * d[0] + d[1] * d[1] + d[2] * d[2]).double()
                          ).to(dt)
    return torch.stack([c * inv_len for c in d], 1)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def shade(sc: Scene, o, d, dist, tri, opts: Opts, depth: int = 0,
          kd_table=None, light_pos=None, light_color=None):
    """Colour (R, 3) of rays from ``o`` ((3,) shared, or (R, 3)) along
    ``d`` with hits (dist, tri); the tables, where given, replace the
    scene's (the step's parameters)."""
    kd_table = sc.diffuse if kd_table is None else kd_table
    light_pos = sc.light_pos if light_pos is None else light_pos
    light_color = sc.light_color if light_color is None else light_color
    hit = (dist > 0) & (dist < BIG)
    t = torch.where(hit, tri, 0)
    n = sc.normal[t]
    mat = sc.mat[t]
    kd, ks = kd_table[mat], sc.specular[mat]
    p = o + d * torch.where(hit, dist, 0)[:, None]
    ndotd = torch.abs(_dot(d, n))
    dc = torch.where(hit[:, None], kd * ndotd[:, None], 0)

    if opts.reflections and depth < opts.max_bounces and sc.has_refl:
        refl = torch.where(hit, sc.reflectivity[mat], 0)
        rsel = hit & (refl > 0)
        rd = d - 2.0 * _dot(d, n)[:, None] * n
        rc = _bounce(sc, p + rd * 0.001, rd, rsel, opts, depth, kd_table,
                     light_pos, light_color)
        dc = torch.where(rsel[:, None], dc + (rc - dc) * refl[:, None], dc)
    if opts.transparency and depth < opts.max_bounces and sc.has_transp:
        opac = torch.where(hit, sc.dissolve[mat], 1)
        tsel = hit & (opac < 1)
        tc = _bounce(sc, p + d * 0.1, d, tsel, opts, depth, kd_table,
                     light_pos, light_color)
        dc = torch.where(tsel[:, None], tc + (dc - tc) * opac[:, None], dc)

    ld = torch.full_like(dc, opts.ambient)
    ls = torch.zeros_like(dc)
    for i in range(light_pos.shape[0]):
        lp = light_pos[i]
        lv = p - lp
        ldist = torch.sqrt(torch.clamp_min(_dot(lv, lv), 1e-12))
        fl = lv * (1.0 / ldist)[:, None]
        dot = _dot(n, fl)
        mask = hit & (dot > 0)
        lit = mask
        if opts.shadows:
            with torch.no_grad():
                stm = torch.where(mask, ldist.detach() * 0.9999, -BIG)
                lit = mask & ~blocked_shared(sc.tris, lp.detach(),
                                             fl.detach(), stm)
        at = ldist * (1.0 / sc.light_radius[i])
        atten = torch.clamp_min(
            (1.0 - at) * 0.2 + 1.0 / (16.0 * at * at) - 0.0625, 0.0)
        dm = torch.where(lit, dot * atten, 0)
        sm = dot * dot
        sm = sm * sm
        sm = sm * sm
        sm = sm * sm
        sm = torch.where(lit, sm * atten, 0)
        ld = ld + light_color[i] * dm[:, None]
        ls = ls + light_color[i] * sm[:, None]
    return torch.where(hit[:, None],
                       dc * ld + torch.where(hit[:, None], ks, 0) * ls, 0)


def _bounce(sc: Scene, o, d, sel, opts, depth, kd_table, light_pos,
            light_color):
    """Closest hit and colour of a bounce wavefront; unselected rays miss."""
    tmax = torch.where(sel, BIG, -BIG).to(sc.dtype)
    with torch.no_grad():
        dist, tri = closest_general(sc.tris, o.detach(), d.detach(), tmax)
    dist = torch.where(tmax >= 0, dist, -BIG)
    return shade(sc, o, d, dist, tri, opts, depth + 1, kd_table, light_pos,
                 light_color)


def frame_pixels(sc: Scene, cam_pos, cam_target, width: int, height: int,
                 opts: Opts, px, py):
    """Colour (N, 3), before the RGB8 conversion, of output pixels (px,
    py) of a width x height frame; with ``opts.supersample`` the mean of
    the pixel's 2 x 2 rays of the 2W x 2H frame, summed in the order
    (even row, even column), (odd, even), (even, odd), (odd, odd)."""
    basis = look_at(cam_pos, cam_target, sc.dtype)
    o = cam_pos.to(sc.dtype)
    if opts.supersample:
        sx = torch.stack([2 * px, 2 * px, 2 * px + 1, 2 * px + 1])
        sy = torch.stack([2 * py, 2 * py + 1, 2 * py, 2 * py + 1])
        d = primary_dirs(basis, 2 * width, 2 * height, sx.reshape(-1),
                         sy.reshape(-1))
    else:
        d = primary_dirs(basis, width, height, px, py)
    with torch.no_grad():
        dist, tri = closest_shared(sc.tris, o, d,
                                   torch.full(d.shape[:1], BIG, dtype=d.dtype,
                                              device=d.device))
        c = shade(sc, o, d, dist, tri, opts)
    if opts.supersample:
        c = c.reshape(4, -1, 3)
        c = (c[0] + c[1] + c[2] + c[3]) * 0.25
    return c


def to_rgb8(c):
    """ConvColor: clamp to [0, 255] and truncate."""
    return torch.clamp(c.float() * 255.0, 0.0, 255.0).to(torch.uint8)


def step(sc: Scene, cam_pos, cam_target, width: int, height: int, target,
         opts: Opts, rows: int | None = None):
    """The inverse-rendering step: the mean squared difference of the
    whole width x height frame from ``target`` (H, W, 3), and its
    gradients with respect to the vertex rows a, ba, ca (T, 3 each, in
    the order of the inputs' triangles), the diffuse colours, the light's
    position and colour and the camera position. With
    ``opts.supersample`` the frame is the 2 x 2 mean of a 2W x 2H frame,
    as ``frame_pixels`` sums it. ``rows`` takes the mean over the first
    ``rows`` rows alone (a fault that the control tests plant). Returns
    (loss, {name: gradient})."""
    dt = sc.dtype
    basis = look_at(cam_pos, cam_target, dt)
    s = 2 if opts.supersample else 1
    py, px = torch.meshgrid(torch.arange(height * s, device=cam_pos.device),
                            torch.arange(width * s, device=cam_pos.device),
                            indexing="ij")
    d = primary_dirs(basis, width * s, height * s, px.reshape(-1),
                     py.reshape(-1))
    params = {"tri_a": sc.tris.a, "tri_ba": sc.tris.ba, "tri_ca": sc.tris.ca,
              "mat_diffuse": sc.diffuse, "light_pos": sc.light_pos,
              "light_color": sc.light_color, "cam_pos": cam_pos.to(dt)}
    params = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    o = params["cam_pos"]
    with torch.no_grad():
        dist0, tri = closest_shared(sc.tris, o.detach(), d, torch.full(
            d.shape[:1], BIG, dtype=dt, device=d.device))
    hit = (dist0 > 0) & (dist0 < BIG)
    t = torch.where(hit, tri, 0)
    a, ba, ca = (params[k].index_select(0, t) for k in
                 ("tri_a", "tri_ba", "tri_ca"))
    n = torch.stack([ba[:, 1] * ca[:, 2] - ba[:, 2] * ca[:, 1],
                     ba[:, 2] * ca[:, 0] - ba[:, 0] * ca[:, 2],
                     ba[:, 0] * ca[:, 1] - ba[:, 1] * ca[:, 0]], 1)
    det = _dot(d, n)
    dist = -_dot(o - a, n) * (1.0 / torch.where(det == 0, 1e-30, det))
    dist = torch.where(hit, dist, dist0)
    img = shade(sc, o, d, dist, tri, opts, 0, params["mat_diffuse"],
                params["light_pos"], params["light_color"])
    img = img.reshape(height * s, width * s, 3)
    if s == 2:
        img = (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2]
               + img[1::2, 1::2]) * 0.25
    rows = height if rows is None else rows
    loss = ((img[:rows] - target.to(dt)[:rows]) ** 2).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))
