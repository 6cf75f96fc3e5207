"""Plain BVH walk (``snail_tpu.ops.traverse_ref``): a lockstep per-ray
stack walk over the node tree on tensors, and the plain versions of the
walk kernels B9a-d (``csrc/walk.cu``) and of the fat-leaf kernels B11a-d
(``csrc/fat.cu``) built on it; and a simulation of every warp's walk, the
plain versions of the counting walk kernels B9e/B9f, which also tallies
the leaf visits of B9c's and B11b's warps (:func:`closest_g_sim`) and
of B9a's and B11a's (:func:`camera_sim`).

Each ray keeps its own stack of ``NodeTables.stack_cap`` = depth + 2
entries, sized from the tree (the JAX oracle clamps at 66 entries,
ROADMAP C2; a push past the cap raises here). Every step pops one node
per live ray, slab-tests it against the ray's current bound (its best, or
its shadow limit), tests the triangles of an entered leaf, and at an
entered inner node pushes the far child and goes on with the near one.
Near is decided as the kernels decide it: for B9, by the near-child sign
of the ray's warp (32 consecutive rays; B9a's primary rays are taken in
the order of its threads, so that a warp is an 8 x 4 pixel tile), the
sign of the midpoint of its live rays' inverse directions; for B11, by
the signs of its packet's ray 0 (``traverse.camera_signs`` /
``packet_signs``), so that a ray meets its leaves in the kernel's order,
whatever its warp, and closest-hit ties resolve alike. The
intersection arithmetic is each kernel's, operation for operation: the
full Moller test on raw rows for every walk kernel, B9a/B9b and B11a/B11c
from their shared origin (as ``traverse._moller_g``). ``walk_plain``
also takes the shared-origin rows of ``traverse.shared_rows``
(``raw=False``), whose terms are the raw test's, rounded alike; the
closest-hit rule is two-sided and keeps the first strictly nearer hit,
the any-hit rule one-sided, and a blocked ray stops.
"""

from __future__ import annotations

import torch

from ..core.vecmath import BIG, safe_inv
from .traverse import (_BIN_EDGES, CHUNK_ROWS, LANE_BINS, PACKET_R, TALLY,
                       WARP, WARPS, NodeTables, _camera_rays, _slab,
                       _stats_row, camera_wl_order)

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
    origin rows, or raw rows with the rays' origins ``o`` (three (n,), or
    three 0-d: one origin)."""
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
    # a shared origin (three 0-d tensors) broadcasts as it is
    ox, oy, oz = (c if c.dim() == 0 else c[:, None] for c in o)
    tvx, tvy, tvz = ox - ax, oy - ay, oz - az
    det = dx * nx + dy * ny + dz * nz
    tmul = -(tvx * nx + tvy * ny + tvz * nz)
    u = (dx * (tvy * caz - tvz * cay) + dy * (tvz * cax - tvx * caz)
         + dz * (tvx * cay - tvy * cax))
    v = (dx * (bay * tvz - baz * tvy) + dy * (baz * tvx - bax * tvz)
         + dz * (bax * tvy - bay * tvx))
    return det, u, v, tmul


def _ray_signs(signs, per: int):
    """(R, 3) int64: per-packet (or per-warp) signs (n, 3) repeated over
    the ``per`` rays of each."""
    return signs.long().repeat_interleave(per, 0)


class _Walk:
    """State of one lockstep walk (see :func:`walk_plain`)."""

    def __init__(self, nodes: NodeTables, o, d, bound0, rows, raw: bool,
                 closest: bool, work, signs=None):
        dev = d[0].device
        r = d[0].shape[0]
        self.lo, self.hi, self.child, self.count, self.axis, self.first = (
            nodes.columns())
        self.cap = nodes.stack_cap
        self.o, self.d, self.rows = o, d, rows
        self.raw, self.closest, self.work = raw, closest, work
        self.shared = o[0].dim() == 0
        self.idir = [safe_inv(c) for c in d]
        self.signs = (_warp_signs(self.idir, bound0 > 0.0) if signs is None
                      else signs)
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
        """The triangle tests of rays ``li`` in the leaves they entered.
        Returns the triangles each ray tested (up to its blocker)."""
        j = torch.arange(int(cnt.max()), device=li.device)
        tested = []
        for s in range(0, li.numel(), LEAF_RAYS):
            ri, f, c = (a[s:s + LEAF_RAYS] for a in (li, first, cnt))
            valid = j[None, :] < c[:, None]
            t = torch.where(valid, f[:, None] + j[None, :], 0)
            o, d, _ = self._ray(ri)
            det, u, v, tmul = _terms(self.rows[t], o, d, self.raw)
            if self.closest:
                self._closest(ri, t, valid, det, u, v, tmul)
                tested.append(c)
            else:
                tested.append(self._any(ri, c, valid, det, u, v, tmul))
        tested = torch.cat(tested)
        if self.work is not None:
            self.work["tri"] += int(tested.sum())
        return tested

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

    def _any(self, ri, cnt, valid, det, u, v, tmul):
        """Blocks rays ``ri``; returns the triangles each tested: a ray
        stops at its first blocker."""
        lim = self.bound[ri][:, None]
        occ = ((torch.minimum(u, v) >= 0.0) & (u + v <= det) & (tmul > 0.0)
               & (tmul < lim * det) & valid)
        hit = occ.any(1)
        self.blocked[ri] |= hit
        return torch.where(hit, occ.int().argmax(1) + 1, cnt)


def walk_plain(nodes: NodeTables, o, d, bound0, rows, raw: bool,
               closest: bool, work=None, signs=None):
    """The lockstep walk of rays from ``o`` (three 0-d tensors, one origin,
    or three (R,)) along ``d`` (three (R,), R a multiple of 32) with
    initial bounds ``bound0`` (R,): the closest hit's starting best, or
    the any-hit's limit (a ray with bound0 <= 0 finds nothing). ``rows``:
    shared-origin rows, or with ``raw`` the raw rows. ``signs``: each
    ray's near-child signs, (R, 3) int64, or None for its warp's (B9).
    Returns, closest,
    (best, tri, u, v) with tri int64 -1 where nothing was hit, else
    blocked bool (R,). ``work``, a dict, gets what the walk needed:
    ``slab`` (node boxes the rays entered, summed over rays), ``tri``
    (ray-triangle tests in the leaves they entered, up to a blocker) and
    ``entered`` (bool per node: some ray entered it)."""
    w = _Walk(nodes, o, d, bound0, rows, raw, closest, work, signs)
    while w.step():
        pass
    if closest:
        return w.bound, w.tri, w.bu, w.bv
    return w.blocked


def _tiles(c, order):
    """A (P, PACKET_R) plane in the order of the camera kernels' threads
    (``order``: :func:`traverse.camera_wl_order` on its device), flat: 32
    consecutive rays are a warp's 8 x 4 pixel tile."""
    return c[:, order].reshape(-1)


def _untiled(x, order, shape):
    """The inverse of :func:`_tiles`: each thread's result back to its
    ray's slot, ``shape`` (P, PACKET_R)."""
    return torch.empty(shape, dtype=x.dtype, device=x.device).index_copy_(
        1, order, x.reshape(shape))


def walk_camera_plain(cam, width: int, height: int, rows, nodes: NodeTables,
                      pids: torch.Tensor, work=None):
    """Plain B9a: closest hit of the primary rays of packets ``pids``, each
    ray's bound starting at its root-box exit, near children by the signs
    of its warp, an 8 x 4 pixel tile (``camera_wl_order``). Returns (dist,
    u, v, tri, dx, dy, dz), each (len(pids), PACKET_R): a miss has dist
    BIG, tri -1."""
    d, _, t_exit = _camera_rays(cam, width, height, pids)
    order = camera_wl_order().to(t_exit.device)
    shape = t_exit.shape
    best, tri, u, v = (_untiled(x, order, shape) for x in walk_plain(
        nodes, cam[9:12].unbind(), [_tiles(c, order) for c in d],
        _tiles(t_exit, order), rows, True, True, work))
    dist = torch.where(tri >= 0, best, BIG)
    return dist, u, v, tri.to(torch.int32), *d


def walk_shadow_plain(orig, d, tm, rows, nodes: NodeTables, work=None):
    """Plain B9b: any-hit from ``orig`` (3,) of rays ``d`` (three (P,
    PACKET_R)) up to ``tm`` (P, PACKET_R), on raw rows. Returns blocked
    float32 (P, PACKET_R)."""
    limit = torch.where(tm >= 0.0, tm, -BIG).reshape(-1)
    blocked = walk_plain(nodes, orig.unbind(), [c.reshape(-1) for c in d],
                         limit, rows, True, False, work)
    return blocked.float().reshape(tm.shape)


def walk_closest_g_plain(o, d, tm, rows, nodes: NodeTables, work=None):
    """Plain B9c: closest hit of rays with their own origins, on raw rows;
    ``o``/``d`` three and ``tm`` one (P, PACKET_R) planes. A live ray
    starts at min(tmax, BIG). Returns (dist, u, v, tri): a miss has dist
    BIG, a masked ray -BIG, tri is clamped at 0."""
    best, tri, u, v = walk_plain(nodes, [c.reshape(-1) for c in o],
                                 [c.reshape(-1) for c in d], _best0(tm),
                                 rows, True, True, work)
    return _closest_g_out(best, tri, u, v, tm, False)


def _best0(tm):
    """B9c's and B11b's starting best of each ray, flat: min(tmax, BIG),
    or -BIG where tmax < 0 masks the ray."""
    return torch.where(tm >= 0.0, tm.clamp_max(BIG), -BIG).reshape(-1)


def _closest_g_out(best, tri, u, v, tm, fat: bool):
    """B9c's (``fat`` False) or B11b's outputs (dist, u, v, tri) from the
    walk's flat per-ray results, shaped as ``tm``: tri clamped at 0, and a
    ray that hit nothing has dist BIG (B9c; B11b: its best, min(tmax,
    BIG)), a masked ray -BIG."""
    shape = tm.shape
    tri = tri.reshape(shape)
    dist = best.reshape(shape)
    if not fat:
        dist = torch.where(tri >= 0, dist, torch.where(tm >= 0.0, BIG, -BIG))
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


# --- The fat-leaf kernels' plain versions (B11a-d): the walk with each
# packet's ray-0 signs, on raw rows, leaves of up to LEAF_PAD triangles ---


def fat_camera_plain(cam, width: int, height: int, signs, rows,
                     nodes: NodeTables, pids: torch.Tensor, work=None):
    """Plain B11a: closest hit of the primary rays of packets ``pids`` on
    the raw ``rows``, near children by their packets' ``signs`` (P, 3),
    each ray's best starting at BIG (no root-box clip). Returns (dist, u,
    v, tri, dx, dy, dz), each (len(pids), PACKET_R): a miss has dist BIG,
    tri 0."""
    d, _, t_exit = _camera_rays(cam, width, height, pids)
    flat = [c.reshape(-1) for c in d]
    best, tri, u, v = walk_plain(
        nodes, cam[9:12].unbind(), flat, torch.full_like(flat[0], BIG), rows,
        True, True, work, _ray_signs(signs[pids.to(signs.device)], PACKET_R))
    shape = t_exit.shape
    return (best.reshape(shape), u.reshape(shape), v.reshape(shape),
            tri.clamp_min(0).to(torch.int32).reshape(shape), *d)


def fat_closest_plain(o, d, tm, signs, rows, nodes: NodeTables, work=None):
    """Plain B11b: closest hit of rays with their own origins on the raw
    rows; ``o``/``d`` three and ``tm`` one (P, PACKET_R) planes, near
    children by ``signs`` (P, 3). Returns (dist, u, v, tri): each ray's
    best, starting at min(tmax, BIG), or -BIG when masked; tri 0 where
    nothing was hit."""
    best, tri, u, v = walk_plain(nodes, [c.reshape(-1) for c in o],
                                 [c.reshape(-1) for c in d], _best0(tm),
                                 rows, True, True, work,
                                 _ray_signs(signs, PACKET_R))
    return _closest_g_out(best, tri, u, v, tm, True)


def fat_shadow_plain(orig, d, tm, signs, rows, nodes: NodeTables,
                     work=None):
    """Plain B11c: any-hit from ``orig`` (3,) on the raw rows, near
    children by ``signs`` (P, 3). Returns blocked float32 (P, PACKET_R)."""
    limit = torch.where(tm >= 0.0, tm, -BIG).reshape(-1)
    blocked = walk_plain(nodes, orig.unbind(), [c.reshape(-1) for c in d],
                         limit, rows, True, False, work,
                         _ray_signs(signs, PACKET_R))
    return blocked.float().reshape(tm.shape)


def fat_shadow_g_plain(o, d, tm, signs, rows, nodes: NodeTables, work=None):
    """Plain B11d: any-hit of rays with their own origins on the raw rows,
    near children by ``signs`` (P, 3). Returns blocked float32 (P,
    PACKET_R); a masked ray is never blocked."""
    limit = torch.where(tm >= 0.0, tm, -BIG).reshape(-1)
    blocked = walk_plain(nodes, [c.reshape(-1) for c in o],
                         [c.reshape(-1) for c in d], limit, rows, True,
                         False, work, _ray_signs(signs, PACKET_R))
    return blocked.float().reshape(tm.shape)


# --- The counters of B9e/B9f: a simulation of every warp's walk ---------


# The tally of a warp walk (``_WarpWalk.tally``): the rows of
# ``traverse.TALLY``, per warp.


class _WarpWalk(_Walk):
    """Every warp's walk as the kernels run it (``csrc/walk.cuh`` ``walk``),
    with the counters of ``WalkCounts``: a warp loads a node, each lane
    slab-tests it against its own bound, and the warp descends where some
    lane enters it; at a leaf the lanes that enter it test its triangles;
    an any-hit warp stops after a leaf once every live lane is blocked.
    Warps are a batch dimension, lanes the rays of the per-ray state.
    ``signs``: each ray's near-child signs, (R, 3) int64 (B11's, each
    packet's), or None for its warp's (B9). Besides the counters, it keeps
    ``tally`` (len(TALLY), n_warps) int64: the rows of :data:`TALLY`."""

    def __init__(self, nodes: NodeTables, o, d, bound0, rows, raw: bool,
                 closest: bool, signs=None):
        super().__init__(nodes, o, d, bound0, rows, raw, closest, None,
                         signs)
        dev = bound0.device
        nw = bound0.shape[0] // WARP
        self.live0 = bound0 > 0.0
        self.wsigns = self.signs[::WARP]
        self.wnode = torch.zeros(nw, dtype=torch.int64, device=dev)
        self.wsp = torch.zeros(nw, dtype=torch.int64, device=dev)
        self.wstack = torch.zeros((nw, self.cap), dtype=torch.int64,
                                  device=dev)
        self.wactive = torch.ones(nw, dtype=torch.bool, device=dev)
        # nodes, leaves, quarters, tri_blocks, chunks per warp
        self.counts = torch.zeros((5, nw), dtype=torch.int64, device=dev)
        self.tally = torch.zeros((len(TALLY), nw), dtype=torch.int64,
                                 device=dev)
        self._edges = torch.tensor(_BIN_EDGES, device=dev)

    def _tally(self, idx, enter, at_leaf, cnt):
        """Adds a step of warps ``idx`` to the tally: ``enter`` (n, WARP)
        the lanes entering each warp's node, ``at_leaf`` the warps at a
        leaf some lane enters, ``cnt`` its rows."""
        t = self.tally
        t[0, idx] += 1
        lanes = enter.sum(1)
        wi, n_in = idx[at_leaf], lanes[at_leaf]
        t[1, wi] += 1
        t[2, wi] += n_in
        t[3, wi] += cnt[at_leaf]
        b = 4 + torch.bucketize(n_in, self._edges)
        t.index_put_((b, wi), torch.ones_like(wi), accumulate=True)

    def _tally_rows(self, idx, wi, tested, cnt, most, blocked):
        """Adds the row counts of the leaf visits of warps ``idx`` to the
        tally: ``wi`` the entering lanes' warps (positions in ``idx``),
        ``tested`` the rows each tested, ``blocked`` whether it is blocked
        now (it was not when it entered); ``cnt`` (per warp) the rows of
        its leaf and ``most`` the most rows a lane of it tested."""
        t, k = self.tally, len(LANE_BINS) + 4
        per = lambda x: torch.zeros_like(cnt).index_add_(0, wi, x.long())
        t[k, idx] += per(tested)
        t[k + 1, idx] += per(cnt[wi])
        t[k + 2, idx] += most
        t[k + 3, idx] += per(blocked)
        t[k + 4, idx] += (cnt > CHUNK_ROWS) & (per(tested > CHUNK_ROWS) > 0)

    def step(self) -> bool:
        """One node per walking warp; False once no warp walks."""
        idx = torch.nonzero(self.wactive).flatten()
        if idx.numel() == 0:
            return False
        n = self.wnode[idx]
        cnt = self.count[n]
        self.counts[0, idx] += 1
        self.counts[1, idx] += cnt > 0
        lanes = (idx[:, None] * WARP
                 + torch.arange(WARP, device=idx.device)[None, :])
        rl = lanes.reshape(-1)
        o, _, idir = self._ray(rl)
        nl = n.repeat_interleave(WARP)
        t1 = [(self.lo[nl, k] - o[k]) * idir[k] for k in range(3)]
        t2 = [(self.hi[nl, k] - o[k]) * idir[k] for k in range(3)]
        tn, tf = _slab(t1, t2)
        bound = (self.bound[rl] if self.closest else
                 torch.where(self.blocked[rl], -BIG, self.bound[rl]))
        enter = ((tn <= tf) & (tf > 0.0) & (tn < bound)).reshape(-1, WARP)
        some = enter.any(1)
        at_leaf, inner = some & (cnt > 0), some & (cnt == 0)
        self._tally(idx, enter, at_leaf, cnt)
        stop = torch.zeros_like(some)
        if bool(at_leaf.any()):
            wi, _ = torch.nonzero(enter & at_leaf[:, None], as_tuple=True)
            rl_in = lanes[enter & at_leaf[:, None]]
            tested = self._leaves(rl_in, self.child[n[wi]], cnt[wi])
            most = torch.zeros_like(n).scatter_reduce(0, wi, tested, "amax")
            self.counts[2, idx] += at_leaf
            self.counts[3, idx] += most
            self._tally_rows(idx, wi, tested, cnt, most,
                             self.blocked[rl_in])
            if not self.closest:
                done = (self.blocked | ~self.live0).reshape(-1, WARP)[idx]
                stop = at_leaf & done.all(1)
        wi, ni = idx[inner], n[inner]
        if wi.numel():
            if int(self.wsp[wi].max()) >= self.cap:
                raise RuntimeError(
                    f"walk stack overflow: the tree is deeper than its "
                    f"depth {self.cap - 2}")
            bit = self.first[ni] ^ self.wsigns[wi, self.axis[ni]]
            self.wstack[wi, self.wsp[wi]] = self.child[ni] + 1 - bit
            self.wsp[wi] += 1
            self.wnode[wi] = self.child[ni] + bit
        rest = idx[~inner & ~stop]
        has = self.wsp[rest] > 0
        pop = rest[has]
        self.counts[4, pop] += 1
        self.wsp[pop] -= 1
        self.wnode[pop] = self.wstack[pop, self.wsp[pop]]
        self.wactive[rest[~has]] = False
        self.wactive[idx[stop]] = False
        return True

    def run(self):
        """Walks every warp; returns the counters, int32 (P, 8) per packet
        of PACKET_R rays."""
        while self.step():
            pass
        per = self.counts.reshape(5, -1, WARPS).sum(2)
        return torch.stack([_stats_row(c) for c in per.T])


def walk_camera_stats_plain(cam, width: int, height: int, rows,
                            nodes: NodeTables, pids: torch.Tensor):
    """Plain B9e: :func:`walk_camera_plain`'s outputs for packets ``pids``
    and their counters, int32 (len(pids), 8), from a simulation of every
    warp's walk (:func:`camera_sim`)."""
    out, stats, _ = camera_sim(cam, width, height, rows, nodes, pids)
    return (*out, stats)


def camera_sim(cam, width: int, height: int, rows, nodes: NodeTables,
               pids: torch.Tensor, signs=None):
    """B9a (B9e) or, with ``signs`` (P, 3), B11a on the raw ``rows`` for
    the primary rays of packets ``pids``, simulated warp by warp as
    ``walk`` runs them, a warp's rays an 8 x 4 pixel tile
    (:func:`traverse.camera_wl_order`). Returns (the outputs (dist, u, v, tri, dx, dy, dz) as
    :func:`walk_camera_plain` / :func:`fat_camera_plain` give them, the
    counters int32 (len(pids), 8) as B9e's, the tally ``_WarpWalk.tally``
    (len(TALLY), len(pids) * WARPS)). B9a (``walk_pairs``) visits the
    same leaves with the same lanes, in fewer node steps than the
    tally's."""
    d, _, t_exit = _camera_rays(cam, width, height, pids)
    order = camera_wl_order().to(t_exit.device)
    shape = t_exit.shape
    if signs is None:
        bound0, rs = _tiles(t_exit, order), None
    else:
        bound0 = torch.full_like(t_exit.reshape(-1), BIG)
        rs = _ray_signs(signs[pids.to(signs.device)], PACKET_R)
    w = _WarpWalk(nodes, cam[9:12].unbind(), [_tiles(c, order) for c in d],
                  bound0, rows, True, True, rs)
    stats = w.run()
    best, tri, u, v = (_untiled(x, order, shape)
                       for x in (w.bound, w.tri, w.bu, w.bv))
    if signs is None:
        dist = torch.where(tri >= 0, best, BIG)
    else:
        dist, tri = best, tri.clamp_min(0)
    return (dist, u, v, tri.to(torch.int32), *d), stats, w.tally


def walk_shadow_stats_plain(orig, d, tm, rows, nodes: NodeTables):
    """Plain B9f: :func:`walk_shadow_plain`'s blocked planes and their
    counters, int32 (P, 8), from a simulation of every warp's walk."""
    blocked, stats, _ = shadow_sim(orig, d, tm, rows, nodes)
    return blocked, stats


def shadow_sim(orig, d, tm, rows, nodes: NodeTables):
    """B9b (and B9f) from ``orig`` (3,) on the planes ``d`` (three) and
    ``tm`` (P, PACKET_R), on the raw ``rows``, simulated warp by
    warp. Returns (blocked float32 (P, PACKET_R), as
    :func:`walk_shadow_plain` gives it; B9f's counters, int32 (P, 8); the
    tally ``_WarpWalk.tally`` (len(TALLY), P * WARPS)). A warp stops
    after a leaf once every live lane is blocked; an entering lane tests
    the leaf's rows up to its first occluder. The simulation walks as
    ``walk`` does (B9f); B9b (``walk_pairs``) visits the same leaves with
    the same lanes, in fewer node steps than the tally's."""
    limit = torch.where(tm >= 0.0, tm, -BIG).reshape(-1)
    w = _WarpWalk(nodes, orig.unbind(), [c.reshape(-1) for c in d], limit,
                  rows, True, False)
    stats = w.run()
    return w.blocked.float().reshape(tm.shape), stats, w.tally


def closest_g_sim(o, d, tm, rows, nodes: NodeTables, signs=None):
    """B9c (``signs`` None: each warp's own signs) or B11b (``signs`` (P,
    3): each packet's) on the planes ``o``/``d`` (three) and ``tm`` (P,
    PACKET_R), simulated warp by warp. Returns (the kernel's outputs as
    :func:`walk_closest_g_plain` / :func:`fat_closest_plain` give them,
    its counters int32 (P, 8) as B9e's, its tally: ``_WarpWalk.tally``
    (len(TALLY), P * WARPS)). The simulation walks as ``walk`` does; B9c
    (``walk_pairs``) visits the same leaves with the same lanes, in fewer
    node steps than the tally's."""
    w = _WarpWalk(nodes, [c.reshape(-1) for c in o],
                  [c.reshape(-1) for c in d], _best0(tm), rows, True, True,
                  None if signs is None else _ray_signs(signs, PACKET_R))
    stats = w.run()
    out = _closest_g_out(w.bound, w.tri, w.bu, w.bv, tm, signs is not None)
    return out, stats, w.tally


def shadow_g_sim(o, d, tm, rows, nodes: NodeTables, signs=None):
    """B9d (``signs`` None: each warp's own signs) or B11d (``signs`` (P,
    3): each packet's) on the planes ``o``/``d`` (three) and ``tm`` (P,
    PACKET_R), simulated warp by warp. Returns (blocked float32 (P,
    PACKET_R) as :func:`walk_shadow_g_plain` / :func:`fat_shadow_g_plain`
    give it, the counters int32 (P, 8) as B9f's, the tally
    ``_WarpWalk.tally`` (len(TALLY), P * WARPS)). A warp stops after a
    leaf once every live lane is blocked; an entering lane tests the
    leaf's rows up to its first occluder, so ``tested`` counts what the
    any-hit needs of the rows the warp stages. The simulation walks as
    ``walk`` does; B9d (``walk_pairs``) visits the same leaves with the
    same lanes, in fewer node steps than the tally's."""
    limit = torch.where(tm >= 0.0, tm, -BIG).reshape(-1)
    w = _WarpWalk(nodes, [c.reshape(-1) for c in o],
                  [c.reshape(-1) for c in d], limit, rows, True, False,
                  None if signs is None else _ray_signs(signs, PACKET_R))
    stats = w.run()
    return w.blocked.float().reshape(tm.shape), stats, w.tally
