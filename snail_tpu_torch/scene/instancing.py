"""Two-level instancing (``snail_tpu.scene.instancing``, the reference's
DBVH, src/dbvh/tree.h:7-252, src/dbvh/traverse.cpp:14-76).

An :class:`InstancedScene` is one base scene and N rigid instances of it
(rotation + translation, with cached world boxes). Instance counts are
small and wavefronts large, so the instance level is a loop over
instances: each ray is culled against the instance's world box, moved into
object space and traced through the base scene's kernels (the dispatch
seam, ``ops.dispatch``: B5 + B6 for closest hits, B5 + B7 for shadows),
with the running closest hit as its tmax, so that what earlier instances
hide is culled in the later ones' traversal. The rotations are rigid, so
object-space distances are world-space distances; normals rotate back by
R. A frame gets the full Whitted shading of ``render.fast`` through its
``normals``/``any_hit``/``bounce`` hooks.

An instance that no ray touches: the JAX package skips its traversal
(``lax.cond``); in torch that test is a host sync per instance and
wavefront. The port traces the fully masked wavefront instead, whose
kernels exit at once: the faster of the two on the card (PERF.md).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.vecmath import BIG, safe_inv
from ..ops import dispatch


def rotation_y(angle) -> torch.Tensor:
    """Rotation about the y axis, float32 (..., 3, 3) (the reference
    animates instances so, rtracer.cpp:359-364)."""
    a = torch.as_tensor(angle, dtype=torch.float32)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


@dataclasses.dataclass(frozen=True)
class InstancedScene:
    """A base scene plus N rigid instances: rot float32 (N, 3, 3), trans
    (N, 3), and the instances' cached world boxes inst_lo/inst_hi (N, 3)
    (dbvh ObjectInstance.bbox)."""

    rot: torch.Tensor
    trans: torch.Tensor
    inst_lo: torch.Tensor
    inst_hi: torch.Tensor
    base: object

    @property
    def num_instances(self) -> int:
        return self.rot.shape[0]

    @property
    def lights(self):
        return self.base.lights

    def to(self, device) -> "InstancedScene":
        return dataclasses.replace(
            self, rot=self.rot.to(device), trans=self.trans.to(device),
            inst_lo=self.inst_lo.to(device), inst_hi=self.inst_hi.to(device),
            base=self.base.to(device))


def make_instances(base, rot, trans) -> InstancedScene:
    """The instance set with its world boxes, from the 8 transformed
    corners of the base scene's root box (MakeDBVH, rtracer.cpp:357-364);
    ``rot`` (N, 3, 3) and ``trans`` (N, 3), moved to the base's device."""
    dev = base.root_lo.device
    rot = torch.as_tensor(rot, dtype=torch.float32).to(dev)
    trans = torch.as_tensor(trans, dtype=torch.float32).to(dev)
    lo, hi = base.root_lo, base.root_hi
    corners = torch.stack(torch.meshgrid(
        torch.stack([lo[0], hi[0]]), torch.stack([lo[1], hi[1]]),
        torch.stack([lo[2], hi[2]]), indexing="ij"), -1).reshape(-1, 3)
    wc = torch.einsum("nij,cj->nci", rot, corners) + trans[:, None, :]
    return InstancedScene(rot=rot, trans=trans, inst_lo=wc.amin(1),
                          inst_hi=wc.amax(1), base=base)


def _ray_hits_box(o3, d3, tmax, lo, hi):
    """Slab test of every ray's segment [0, tmax] against one world box:
    the per-ray instance cull (dbvh/traverse.cpp:14-76)."""
    tn = torch.zeros_like(tmax)
    tf = torch.where(tmax >= 0.0, tmax.clamp_max(BIG), -BIG)
    for k in range(3):
        ic = safe_inv(d3[k])
        t1 = (lo[k] - o3[k]) * ic
        t2 = (hi[k] - o3[k]) * ic
        tn = torch.maximum(tn, torch.minimum(t1, t2))
        tf = torch.minimum(tf, torch.maximum(t1, t2))
    return (tn <= tf) & (tf > 0.0)


def _to_object(iscene: InstancedScene, i: int, o3, d3):
    """World -> object space of instance i (ITransformPoint/ITransformVec,
    dbvh/tree.h:34-46): p' = R^T (p - t), v' = R^T v; (R, 3) each."""
    r, t = iscene.rot[i], iscene.trans[i]
    o = [o3[k] - t[k] for k in range(3)]
    rt = lambda v: torch.stack([r[0, j] * v[0] + r[1, j] * v[1]
                                + r[2, j] * v[2] for j in range(3)], -1)
    return rt(o), rt(d3)


def instanced_closest_hit(iscene: InstancedScene, o3, d3, tmax):
    """Closest hit over all instances (TraversePrimary0 over the DBVH):
    (dist, inst, tri, u, v), flat (R,) each. A miss has dist BIG and inst
    -1, a masked ray (tmax < 0) dist -BIG. Instance i is traced with the
    best hit so far as its tmax, and only for the rays whose segment
    enters its world box."""
    best = torch.where(tmax >= 0.0, tmax.clamp_max(BIG), -BIG)
    inst = torch.full(tmax.shape, -1, dtype=torch.int32, device=tmax.device)
    tri = torch.zeros(tmax.shape, dtype=torch.int32, device=tmax.device)
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)
    for i in range(iscene.num_instances):
        touch = _ray_hits_box(o3, d3, best, iscene.inst_lo[i],
                              iscene.inst_hi[i])
        o, d = _to_object(iscene, i, o3, d3)
        d_i, t_i, b_i = dispatch.closest_hit(
            iscene.base, o, d, torch.where(touch, best, -BIG))
        upd = (d_i > 0.0) & (d_i < best)
        best = torch.where(upd, d_i, best)
        inst = torch.where(upd, i, inst)
        tri = torch.where(upd, t_i, tri)
        bu = torch.where(upd, b_i[:, 0], bu)
        bv = torch.where(upd, b_i[:, 1], bv)
    dist = torch.where(inst >= 0, best,
                       torch.where(tmax >= 0.0, BIG, -BIG))
    return dist, inst, tri, bu, bv


def instanced_any_hit(iscene: InstancedScene, o3, d3, tmax):
    """Any-hit over all instances: blocked bool (R,). A ray blocked by one
    instance is masked for the later ones (the full-occlusion return of
    the DBVH shadow traversal)."""
    blocked = torch.zeros(tmax.shape, dtype=torch.bool, device=tmax.device)
    for i in range(iscene.num_instances):
        tm = torch.where(blocked, -BIG, tmax)
        touch = _ray_hits_box(o3, d3, tm, iscene.inst_lo[i],
                              iscene.inst_hi[i])
        o, d = _to_object(iscene, i, o3, d3)
        blocked = blocked | dispatch.any_hit(
            iscene.base, o, d, torch.where(touch, tm, -BIG))
    return blocked


def world_normal(iscene: InstancedScene, inst, n3):
    """Object-space normals three (R,) -> world space, each by its
    instance's R (rigid: the inverse transpose is R)."""
    r = iscene.rot.index_select(0, inst.clamp_min(0).long())
    return tuple(r[:, k, 0] * n3[0] + r[:, k, 1] * n3[1] + r[:, k, 2] * n3[2]
                 for k in range(3))


def instanced_hits(iscene: InstancedScene, o3, d3, tmax):
    """:func:`instanced_closest_hit` with the hits' gathered ``sh_pack``
    rows (32, R) and world normals (three (R,)): (dist, inst, tri, u, v,
    sh, normals)."""
    dist, inst, tri, u, v = instanced_closest_hit(iscene, o3, d3, tmax)
    hit = (dist > 0.0) & (dist < BIG)
    sh = iscene.base.sh_pack.index_select(
        0, torch.where(hit, tri, 0).long()).T
    normals = world_normal(iscene, inst, (sh[0] + sh[3] * u + sh[6] * v,
                                          sh[1] + sh[4] * u + sh[7] * v,
                                          sh[2] + sh[5] * u + sh[8] * v))
    return dist, inst, tri, u, v, sh, normals


def _instanced_trace_and_shade(iscene: InstancedScene, o3, d3, tmax, opts,
                               depth: int, tile_hw=None):
    """Instanced closest hit and the full packed Whitted shading of
    ``render.fast`` (the DBVH feeds the same Scene::RayTrace,
    dbvh/traverse.cpp:14-76): world normals, textures, shadows and bounces
    all run against the instance set; ``tile_hw``, the primary
    wavefront's tiles, gives its textured hits their uv footprint (bounce
    wavefronts have none). Returns (r, g, b)."""
    from ..render.fast import _shade_and_light

    dist, _, tri, u, v, sh, normals = instanced_hits(iscene, o3, d3, tmax)

    def any_hit(lp, sd3, stm):
        lo3 = tuple(lp[k].expand(stm.shape) for k in range(3))
        return instanced_any_hit(iscene, lo3, sd3, stm)

    def bounce(bo3, bd3, btm, bdepth):
        return _instanced_trace_and_shade(iscene, bo3, bd3, btm, opts,
                                          bdepth)

    return _shade_and_light(iscene.base, o3, d3, dist, u, v, tri, opts,
                            depth, sh_row=sh, normals=normals,
                            any_hit=any_hit, bounce=bounce, tile_hw=tile_hw)


def primary_wavefront(camera, width: int, height: int):
    """The instanced frame's primary rays in tiles of th x tw pixels (32 x
    32 where the frame allows): (o3, d3, tmax, (th, tw)), o3/d3 three
    flat (R,) components, tmax (R,) BIG."""
    from ..render.raygen import primary_rays, tile_rays

    origin, dirs = primary_rays(camera, width, height)
    th = 32 if height % 32 == 0 else 1
    tw = 32 if width % 32 == 0 else 1
    d = tile_rays(dirs, th, tw).reshape(-1, 3)
    o3 = tuple(origin[k].expand(d.shape[0]) for k in range(3))
    tmax = torch.full(d.shape[:1], BIG, dtype=torch.float32,
                      device=d.device)
    return o3, d.unbind(1), tmax, (th, tw)


def render_instanced(iscene: InstancedScene, camera, width: int,
                     height: int, opts=None) -> torch.Tensor:
    """Full Whitted instanced frame (the rtracer instancing demo,
    rtracer.cpp:357-386): primary, shadow and bounce rays over the
    instances, shaded as single scenes are. Returns (H, W, 3) float32 on
    the scene's device."""
    from ..core.types import RenderOpts
    from ..render.raygen import untile_image

    o3, d3, tmax, (th, tw) = primary_wavefront(camera, width, height)
    cr, cg, cb = _instanced_trace_and_shade(iscene, o3, d3, tmax,
                                            opts or RenderOpts(), 0,
                                            (th, tw))
    color = torch.stack([cr, cg, cb], -1)
    return untile_image(color.reshape(-1, th * tw, 3), height, width, th, tw)
