"""Plain BVH walk (``snail_tpu.ops.traverse_ref``): a lockstep per-ray
stack walk over the node tree on tensors, and the plain versions of the
walk kernels B9a-d (``csrc/walk.cu``) built on it.

Each ray keeps its own stack of ``NodeTables.stack_cap`` = depth + 2
entries, sized from the tree (the JAX oracle clamps at 66 entries,
ROADMAP C2; a push past the cap raises here). Every step pops one node
per live ray, slab-tests it against the ray's current bound (its best, or
its shadow limit), tests the triangles of an entered leaf, and at an
entered inner node pushes the far child and goes on with the near one.
Near is decided as the kernels decide it: by the near-child sign of the
ray's warp (32 consecutive rays), the sign of the midpoint of its live
rays' inverse directions, so that a ray meets its leaves in the kernel's
order and closest-hit ties resolve alike. The intersection arithmetic is
each kernel's, operation for operation: shared-origin rows
(``traverse.shared_rows``) for B9a/B9b, the full Moller test on raw rows
for B9c/B9d (as ``traverse._moller_sh`` / ``_moller_g``); the closest-hit
rule is two-sided and keeps the first strictly nearer hit, the any-hit
rule one-sided, and a blocked ray stops.
"""

from __future__ import annotations

import torch

from ..core.vecmath import BIG, INV_EPS
from .traverse import WARP, NodeTables, _camera_rays, _slab

LEAF_RAYS = 65536  # rays per step of the leaf tests


def _warp_signs(idir, live):
    """(R, 3) int64: the near-child sign of each ray's warp per axis."""
    signs = []
    for c in idir:
        w, lv = c.reshape(-1, WARP), live.reshape(-1, WARP)
        mid = (torch.where(lv, w, BIG).amin(1)
               + torch.where(lv, w, -BIG).amax(1))
        signs.append((mid < 0.0).long())
    return torch.stack(signs, 1).repeat_interleave(WARP, 0)


def _terms(rows, o, d, raw: bool):
    """Moller terms (det, u, v, tmul), (n, J) each, of rays ``d`` (three
    (n,)) against their own triangle rows ``rows`` (n, J, 16): shared-
    origin rows, or raw rows with the rays' origins ``o`` (three (n,))."""
    col = lambda j: rows[:, :, j]
    dx, dy, dz = (c[:, None] for c in d)
    if not raw:
        det = dx * col(0) + dy * col(1) + dz * col(2)
        u = dx * col(3) + dy * col(4) + dz * col(5)
        v = dx * col(6) + dy * col(7) + dz * col(8)
        return det, u, v, col(9)
    ax, ay, az = col(0), col(1), col(2)
    bax, bay, baz = col(3), col(4), col(5)
    cax, cay, caz = col(6), col(7), col(8)
    nx, ny, nz = col(9), col(10), col(11)
    tvx, tvy, tvz = o[0][:, None] - ax, o[1][:, None] - ay, o[2][:, None] - az
    det = dx * nx + dy * ny + dz * nz
    tmul = -(tvx * nx + tvy * ny + tvz * nz)
    u = (dx * (tvy * caz - tvz * cay) + dy * (tvz * cax - tvx * caz)
         + dz * (tvx * cay - tvy * cax))
    v = (dx * (bay * tvz - baz * tvy) + dy * (baz * tvx - bax * tvz)
         + dz * (bax * tvy - bay * tvx))
    return det, u, v, tmul


class _Walk:
    """State of one lockstep walk (see :func:`walk_plain`)."""

    def __init__(self, nodes: NodeTables, o, d, bound0, rows, raw: bool,
                 closest: bool, work):
        dev = d[0].device
        r = d[0].shape[0]
        self.lo, self.hi, self.child, self.count, self.axis, self.first = (
            nodes.columns())
        self.cap = nodes.stack_cap
        self.o, self.d, self.rows = o, d, rows
        self.raw, self.closest, self.work = raw, closest, work
        self.shared = o[0].dim() == 0
        self.idir = [1.0 / (c + INV_EPS) for c in d]
        self.signs = _warp_signs(self.idir, bound0 > 0.0)
        self.stack = torch.zeros((r, self.cap), dtype=torch.int64, device=dev)
        self.sp = torch.zeros(r, dtype=torch.int64, device=dev)
        self.node = torch.zeros(r, dtype=torch.int64, device=dev)
        # the closest-hit best, or the shadow limit
        self.bound = bound0.clone()
        self.tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
        self.bu = torch.zeros_like(bound0)
        self.bv = torch.zeros_like(bound0)
        self.blocked = torch.zeros(r, dtype=torch.bool, device=dev)
        # a ray whose bound is <= 0 can find nothing
        self.active = bound0 > 0.0
        if work is not None:
            work.update(slab=0, tri=0, entered=torch.zeros(
                nodes.n_nodes, dtype=torch.bool, device=dev))

    def _ray(self, idx):
        o = self.o if self.shared else [c[idx] for c in self.o]
        return o, [c[idx] for c in self.d], [c[idx] for c in self.idir]

    def step(self) -> bool:
        """One node per live ray; False once no ray is live."""
        idx = torch.nonzero(self.active).flatten()
        if idx.numel() == 0:
            return False
        n = self.node[idx]
        o, _, idir = self._ray(idx)
        t1 = [(self.lo[n, k] - o[k]) * idir[k] for k in range(3)]
        t2 = [(self.hi[n, k] - o[k]) * idir[k] for k in range(3)]
        tn, tf = _slab(t1, t2)
        enter = (tn <= tf) & (tf > 0.0) & (tn < self.bound[idx])
        cnt = self.count[n]
        leaf, inner = enter & (cnt > 0), enter & (cnt == 0)
        if self.work is not None:
            self.work["slab"] += int(enter.sum())
            self.work["entered"][n[enter]] = True
        if bool(leaf.any()):
            self._leaves(idx[leaf], self.child[n[leaf]], cnt[leaf])

        ri, ni = idx[inner], n[inner]
        if ri.numel():
            if int(self.sp[ri].max()) >= self.cap:
                raise RuntimeError(
                    f"walk stack overflow: the tree is deeper than its "
                    f"depth {self.cap - 2}")
            bit = self.first[ni] ^ self.signs[ri, self.axis[ni]]
            self.stack[ri, self.sp[ri]] = self.child[ni] + 1 - bit
            self.sp[ri] += 1
            self.node[ri] = self.child[ni] + bit
        rest = idx[~inner]
        has = self.sp[rest] > 0
        pop = rest[has]
        self.sp[pop] -= 1
        self.node[pop] = self.stack[pop, self.sp[pop]]
        self.active[rest[~has]] = False
        if not self.closest:
            self.active &= ~self.blocked
        return True

    def _leaves(self, li, first, cnt):
        """The triangle tests of rays ``li`` in the leaves they entered."""
        j = torch.arange(int(cnt.max()), device=li.device)
        for s in range(0, li.numel(), LEAF_RAYS):
            ri, f, c = (a[s:s + LEAF_RAYS] for a in (li, first, cnt))
            valid = j[None, :] < c[:, None]
            t = torch.where(valid, f[:, None] + j[None, :], 0)
            o, d, _ = self._ray(ri)
            det, u, v, tmul = _terms(self.rows[t], o, d, self.raw)
            if self.closest:
                self._closest(ri, t, valid, det, u, v, tmul)
            else:
                self._any(ri, c, valid, det, u, v, tmul)

    def _closest(self, ri, t, valid, det, u, v, tmul):
        duv = det - u - v
        side = ((torch.maximum(u, torch.maximum(v, duv)) <= 0.0)
                | (torch.minimum(u, torch.minimum(v, duv)) >= 0.0))
        idet = 1.0 / torch.where(det == 0.0, 1e-30, det)
        dist = tmul * idet
        ok = side & (det != 0.0) & (dist > 0.0) & valid
        dist = torch.where(ok, dist, float("inf"))
        m = dist.amin(1)
        # the first of equal distances: the kernel keeps the first strictly
        # nearer hit of its loop
        j = torch.where(ok & (dist == m[:, None]),
                        torch.arange(t.shape[1], device=t.device),
                        t.shape[1]).amin(1).clamp_max(t.shape[1] - 1)
        upd = m < self.bound[ri]
        pick = lambda a: a.gather(1, j[:, None])[:, 0]
        self.bound[ri] = torch.where(upd, m, self.bound[ri])
        self.tri[ri] = torch.where(upd, pick(t), self.tri[ri])
        self.bu[ri] = torch.where(upd, pick(u * idet), self.bu[ri])
        self.bv[ri] = torch.where(upd, pick(v * idet), self.bv[ri])
        if self.work is not None:
            self.work["tri"] += int(valid.sum())

    def _any(self, ri, cnt, valid, det, u, v, tmul):
        lim = self.bound[ri][:, None]
        occ = ((torch.minimum(u, v) >= 0.0) & (u + v <= det) & (tmul > 0.0)
               & (tmul < lim * det) & valid)
        hit = occ.any(1)
        self.blocked[ri] |= hit
        if self.work is not None:
            # a ray stops at its first blocker
            self.work["tri"] += int(torch.where(
                hit, occ.int().argmax(1) + 1, cnt).sum())


def walk_plain(nodes: NodeTables, o, d, bound0, rows, raw: bool,
               closest: bool, work=None):
    """The lockstep walk of rays from ``o`` (three 0-d tensors, one origin,
    or three (R,)) along ``d`` (three (R,), R a multiple of 32) with
    initial bounds ``bound0`` (R,): the closest hit's starting best, or
    the any-hit's limit (a ray with bound0 <= 0 finds nothing). ``rows``:
    shared-origin rows, or with ``raw`` the raw rows. Returns, closest,
    (best, tri, u, v) with tri int64 -1 where nothing was hit, else
    blocked bool (R,). ``work``, a dict, gets what the walk needed:
    ``slab`` (node boxes the rays entered, summed over rays), ``tri``
    (ray-triangle tests in the leaves they entered, up to a blocker) and
    ``entered`` (bool per node: some ray entered it)."""
    w = _Walk(nodes, o, d, bound0, rows, raw, closest, work)
    while w.step():
        pass
    if closest:
        return w.bound, w.tri, w.bu, w.bv
    return w.blocked


def walk_camera_plain(cam, width: int, height: int, rows, nodes: NodeTables,
                      pids: torch.Tensor, work=None):
    """Plain B9a: closest hit of the primary rays of packets ``pids``, each
    ray's bound starting at its root-box exit. Returns (dist, u, v, tri,
    dx, dy, dz), each (len(pids), PACKET_R): a miss has dist BIG, tri -1."""
    d, _, t_exit = _camera_rays(cam, width, height, pids)
    flat = [c.reshape(-1) for c in d]
    best, tri, u, v = walk_plain(nodes, cam[9:12].unbind(), flat,
                                 t_exit.reshape(-1), rows, False, True, work)
    shape = t_exit.shape
    dist = torch.where(tri >= 0, best, BIG).reshape(shape)
    return (dist, u.reshape(shape), v.reshape(shape),
            tri.to(torch.int32).reshape(shape), *d)


def walk_shadow_plain(orig, d, tm, rows, nodes: NodeTables, work=None):
    """Plain B9b: any-hit from ``orig`` (3,) of rays ``d`` (three (P,
    PACKET_R)) up to ``tm`` (P, PACKET_R), on shared-origin rows. Returns
    blocked float32 (P, PACKET_R)."""
    limit = torch.where(tm >= 0.0, tm, -BIG).reshape(-1)
    blocked = walk_plain(nodes, orig.unbind(), [c.reshape(-1) for c in d],
                         limit, rows, False, False, work)
    return blocked.float().reshape(tm.shape)


def walk_closest_g_plain(o, d, tm, rows, nodes: NodeTables, work=None):
    """Plain B9c: closest hit of rays with their own origins, on raw rows;
    ``o``/``d`` three and ``tm`` one (P, PACKET_R) planes. A live ray
    starts at min(tmax, BIG). Returns (dist, u, v, tri): a miss has dist
    BIG, a masked ray -BIG, tri is clamped at 0."""
    active = tm >= 0.0
    best0 = torch.where(active, tm.clamp_max(BIG), -BIG).reshape(-1)
    best, tri, u, v = walk_plain(nodes, [c.reshape(-1) for c in o],
                                 [c.reshape(-1) for c in d], best0, rows,
                                 True, True, work)
    shape = tm.shape
    tri = tri.reshape(shape)
    dist = torch.where(tri >= 0, best.reshape(shape),
                       torch.where(active, BIG, -BIG))
    return (dist, u.reshape(shape), v.reshape(shape),
            tri.clamp_min(0).to(torch.int32))


def walk_shadow_g_plain(o, d, tm, rows, nodes: NodeTables, work=None):
    """Plain B9d: any-hit of rays with their own origins, on raw rows.
    Returns blocked float32 (P, PACKET_R); a masked ray is never
    blocked."""
    limit = torch.where(tm >= 0.0, tm, -BIG).reshape(-1)
    blocked = walk_plain(nodes, [c.reshape(-1) for c in o],
                         [c.reshape(-1) for c in d], limit, rows, True, False,
                         work)
    return blocked.float().reshape(tm.shape)

