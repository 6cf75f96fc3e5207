"""SAH BVH construction on host, emitting flat device-friendly arrays.

The port's own NumPy copy of ``snail_tpu.bvh.build``:
``tests/test_torch_bvh.py`` holds the two builders equal (every node array
and the triangle order), so both packages trace the same tree and a
triangle id means the same thing in both.

Rebuild of the reference's two builders (the *algorithms*, not the code):

- :func:`build_bvh` with ``method="binned"`` — 16-bin SAH over the
  max-extent axis with prefix/suffix box+count sweeps, median-split fallback
  when one side is empty, leaf when ``count <= leaf_size`` or when the
  no-split cost wins (reference BVH::FindSplit, src/bvh/tree.cpp:161-287;
  cost model: traverseCost=0, intersectCost=1, tree.cpp:175-176, 220-237).
- ``method="sweep"`` — full sort-based SAH on all 3 axes with exact
  left/right surface-area prefix arrays (reference BVH::FindSplitSweep,
  src/bvh/tree.cpp:51-159; recommended for mixed-size triangles,
  HOWTO.txt:44-49).

Differences from the reference (deliberate, TPU-facing):
- Children are still allocated adjacently (left = ``child``, right =
  ``child+1``, tree.cpp:273-282) but the leaf bit lives in a separate
  ``count`` array instead of bit 31 of ``first`` (tree.h:60-72) — int32
  SoA beats bitfield tricks on TPU.
- The build returns a permutation; callers reorder the flat triangle arrays
  so every leaf covers a contiguous range (same invariant the reference
  maintains by physically reordering ``tris``, tree.cpp:245-253).
- ``leaf_size`` defaults to 8 (reference: 4, tree.cpp:164) — leaves are
  DMA-staged in blocks on TPU, so slightly fatter leaves amortize transfer
  setup without hurting the SAH cost much.

Large scenes (> ~200k tris) route to :func:`build_bvh_fast`, a
LEVEL-SYNCHRONOUS vectorized variant of the same binned SAH: every node
of a depth level is binned/swept/partitioned in one batch of NumPy array
ops (counting-sort by (segment, bin) doubles as the left|right
partition), so a 10 Mtri build is seconds of vectorized work instead of
minutes of per-node Python (the reference builds thai.obj with a tight
C++ recursion, src/bvh/tree.cpp:161-287; level-synchronous batching is
the array-language equivalent).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

MAX_DEPTH = 64  # reference bvh/tree.h:33
N_BINS = 16  # reference bvh/tree.cpp:188


def _box_sa(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Surface area (actually 2*(wd+wh+dh) like reference BoxSA,
    src/bvh/tree.cpp:45-48)."""
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * (d[..., 1] + d[..., 2]) + d[..., 1] * d[..., 2])


@dataclasses.dataclass
class BVH:
    """Flat BVH arrays.

    node_lo/node_hi : float32[N, 3] node bounds
    child           : int32[N] left-child index (inner) / first tri (leaf)
    count           : int32[N] 0 for inner nodes, triangle count for leaves
    axis            : int32[N] split axis (inner only)
    first_node      : int32[N] near-child bit for positive-direction rays
                      (reference Node::firstNode, tree.cpp:277-279)
    order           : int32[T] permutation applied to the triangle arrays
    depth           : max depth reached
    """

    node_lo: np.ndarray
    node_hi: np.ndarray
    child: np.ndarray
    count: np.ndarray
    axis: np.ndarray
    first_node: np.ndarray
    order: np.ndarray
    depth: int

    @property
    def num_nodes(self) -> int:
        return len(self.child)

    @property
    def num_tris(self) -> int:
        return len(self.order)

    def leaf_stats(self) -> dict:
        leaf = self.count > 0
        return {
            "nodes": self.num_nodes,
            "leaves": int(leaf.sum()),
            "depth": self.depth,
            "max_leaf": int(self.count[leaf].max()) if leaf.any() else 0,
            "mean_leaf": float(self.count[leaf].mean()) if leaf.any() else 0.0,
        }

    def sah_cost(self) -> float:
        """Total SAH cost (sum over leaves of count * SA / SA_root) — the
        invariant checked by tests."""
        root_sa = _box_sa(self.node_lo[0], self.node_hi[0])
        leaf = self.count > 0
        return float(
            np.sum(_box_sa(self.node_lo[leaf], self.node_hi[leaf]) * self.count[leaf])
            / max(root_sa, 1e-30)
        )


def build_bvh(
    tri_lo: np.ndarray,
    tri_hi: np.ndarray,
    leaf_size: int = 8,
    method: str = "binned",
) -> BVH:
    """Build from per-triangle AABBs. Returns flat arrays + permutation."""
    t = len(tri_lo)
    assert t > 0
    if method == "binned" and t > 200_000:
        return build_bvh_fast(tri_lo, tri_hi, leaf_size)
    centers = (tri_lo + tri_hi) * 0.5

    # Worst case 2T-1 nodes; reference reserves 2T (tree.cpp:301).
    cap = max(2 * t, 16)
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    child = np.zeros(cap, np.int32)
    count = np.zeros(cap, np.int32)
    axis = np.zeros(cap, np.int32)
    first_node = np.zeros(cap, np.int32)

    order = np.arange(t, dtype=np.int64)
    root_lo = tri_lo.min(axis=0)
    root_hi = tri_hi.max(axis=0)
    node_lo[0], node_hi[0] = root_lo, root_hi
    n_nodes = 1
    max_depth_seen = 0

    # Explicit stack of (node, first, count, depth, bbox_lo, bbox_hi)
    stack = [(0, 0, t, 0, root_lo, root_hi)]

    while stack:
        nid, first, cnt, depth, blo, bhi = stack.pop()
        max_depth_seen = max(max_depth_seen, depth)
        seg = order[first : first + cnt]

        def make_leaf():
            # tighten leaf bbox to its triangles (reference FindSplitSweep
            # recomputes the leaf box, tree.cpp:56-58; FindSplit keeps the
            # parent box — we always tighten, strictly better culling)
            node_lo[nid] = tri_lo[seg].min(axis=0)
            node_hi[nid] = tri_hi[seg].max(axis=0)
            child[nid] = first
            count[nid] = cnt

        if cnt <= leaf_size:
            make_leaf()
            continue

        slo, shi = tri_lo[seg], tri_hi[seg]
        ext = bhi - blo

        # ``leaf_size`` is a HARD cap (the Pallas kernels' fixed leaf DMA
        # granule depends on it), so an oversized node must split even when
        # the SAH cost says stop (the reference can afford soft leaves,
        # tree.cpp:235-237; we cannot — a 411-tri SAH leaf on lancia.obj
        # silently knocked the whole scene off the kernel path). Median
        # splits halve the count, so switching to forced-median once the
        # remaining depth budget just covers ceil(log2(cnt/leaf_size))
        # levels guarantees termination within MAX_DEPTH.
        need = int(np.ceil(np.log2(max(cnt / leaf_size, 1.0))))
        split = None
        if depth < MAX_DEPTH - 1 - need:
            if method == "sweep":
                split = _find_split_sweep(slo, shi, centers[seg])
            else:
                split = _find_split_binned(slo, shi, blo, bhi, ext)

        if split is not None:
            is_left, sp_axis, lbox, rbox = split
            n_left = int(is_left.sum())
        else:
            n_left = 0  # force the median path below

        if n_left == 0 or n_left == cnt:
            # median fallback (tree.cpp:260-271) — also the forced split
            # for SAH-stalled or depth-limited oversized nodes
            sp_axis = int(np.argmax(ext))
            key = centers[seg][:, sp_axis]
            mid = cnt // 2
            part = np.argpartition(key, mid)
            is_left = np.zeros(cnt, bool)
            is_left[part[:mid]] = True
            n_left = mid
            lseg = seg[is_left]
            rseg = seg[~is_left]
            lbox = (tri_lo[lseg].min(axis=0), tri_hi[lseg].max(axis=0))
            rbox = (tri_lo[rseg].min(axis=0), tri_hi[rseg].max(axis=0))

        # stable partition keeps SAH-ish ordering; reorder `order` in place
        perm = np.concatenate([np.where(is_left)[0], np.where(~is_left)[0]])
        order[first : first + cnt] = seg[perm]

        cidx = n_nodes
        n_nodes += 2
        child[nid] = cidx
        count[nid] = 0
        axis[nid] = sp_axis
        # near-child precompute (tree.cpp:277-279): 0 if left box starts
        # first on the split axis, ties broken by max.
        l_lo, l_hi = lbox
        r_lo, r_hi = rbox
        if l_lo[sp_axis] == r_lo[sp_axis]:
            fn = 0 if l_hi[sp_axis] < r_hi[sp_axis] else 1
        else:
            fn = 1 if l_lo[sp_axis] > r_lo[sp_axis] else 0
        first_node[nid] = fn

        node_lo[cidx], node_hi[cidx] = l_lo, l_hi
        node_lo[cidx + 1], node_hi[cidx + 1] = r_lo, r_hi
        stack.append((cidx + 1, first + n_left, cnt - n_left, depth + 1, r_lo, r_hi))
        stack.append((cidx, first, n_left, depth + 1, l_lo, l_hi))

    return BVH(
        node_lo=node_lo[:n_nodes].copy(),
        node_hi=node_hi[:n_nodes].copy(),
        child=child[:n_nodes].copy(),
        count=count[:n_nodes].copy(),
        axis=axis[:n_nodes].copy(),
        first_node=first_node[:n_nodes].copy(),
        order=order.astype(np.int64),
        depth=max_depth_seen,
    )


def _find_split_binned(slo, shi, blo, bhi, ext):
    """One binned-SAH split attempt (reference FindSplit,
    tree.cpp:174-237). Returns (is_left, axis, lbox, rbox) or None if the
    no-split cost wins."""
    cnt = len(slo)
    sp_axis = int(np.argmax(ext))
    width = ext[sp_axis]
    if width <= 0:
        # flat node: binning impossible; caller falls back via empty side
        return (np.zeros(cnt, bool), sp_axis, (blo, bhi), (blo, bhi))

    mul = N_BINS * (1.0 - 1e-6) / width
    c = (slo[:, sp_axis] + shi[:, sp_axis]) * 0.5
    bin_idx = np.clip(((c - blo[sp_axis]) * mul).astype(np.int32), 0, N_BINS - 1)

    bin_cnt = np.bincount(bin_idx, minlength=N_BINS)
    bin_lo = np.full((N_BINS, 3), np.inf, np.float32)
    bin_hi = np.full((N_BINS, 3), -np.inf, np.float32)
    for b in range(N_BINS):
        m = bin_idx == b
        if m.any():
            bin_lo[b] = slo[m].min(axis=0)
            bin_hi[b] = shi[m].max(axis=0)

    left_lo = np.minimum.accumulate(bin_lo, axis=0)
    left_hi = np.maximum.accumulate(bin_hi, axis=0)
    right_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
    right_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
    left_cnt = np.cumsum(bin_cnt)
    right_cnt = np.cumsum(bin_cnt[::-1])[::-1]

    costs = np.empty(N_BINS - 1)
    for n in range(1, N_BINS):
        cl = left_cnt[n - 1]
        cr = right_cnt[n]
        costs[n - 1] = (
            (_box_sa(left_lo[n - 1], left_hi[n - 1]) * cl if cl else 0.0)
            + (_box_sa(right_lo[n], right_hi[n]) * cr if cr else 0.0)
        )
    best = int(np.argmin(costs)) + 1
    no_split = cnt * _box_sa(blo, bhi)
    if no_split < costs[best - 1]:
        return None

    is_left = bin_idx < best
    lbox = (left_lo[best - 1], left_hi[best - 1])
    rbox = (right_lo[best], right_hi[best])
    return is_left, sp_axis, lbox, rbox


def _find_split_sweep(slo, shi, centers):
    """Exact sweep SAH over all 3 axes (reference FindSplitSweep,
    tree.cpp:64-108). Sort key = 3*a + ba + ca == sum of the three vertex
    coords on the axis (OrderTris, tree.cpp:8-22) — equivalent to sorting by
    vertex-coordinate sum; we use the center which orders identically for
    the cost scan's purposes."""
    cnt = len(slo)
    best = (np.inf, None, None, None, None)  # cost, axis, split_idx, sort
    for ax in range(3):
        sort = np.argsort(centers[:, ax], kind="stable")
        lo_s, hi_s = slo[sort], shi[sort]
        l_lo = np.minimum.accumulate(lo_s, axis=0)
        l_hi = np.maximum.accumulate(hi_s, axis=0)
        r_lo = np.minimum.accumulate(lo_s[::-1], axis=0)[::-1]
        r_hi = np.maximum.accumulate(hi_s[::-1], axis=0)[::-1]
        n = np.arange(1, cnt)
        cost = _box_sa(l_lo[:-1], l_hi[:-1]) * n + _box_sa(r_lo[1:], r_hi[1:]) * (
            cnt - n
        )
        i = int(np.argmin(cost))
        if cost[i] < best[0]:
            best = (float(cost[i]), ax, i + 1, sort, (l_lo, l_hi, r_lo, r_hi))
    cost, ax, split, sort, boxes = best
    blo = np.minimum(slo.min(axis=0), slo.min(axis=0))
    no_split = cnt * _box_sa(slo.min(axis=0), shi.max(axis=0))
    if no_split < cost:
        return None
    l_lo, l_hi, r_lo, r_hi = boxes
    is_left = np.zeros(cnt, bool)
    is_left[sort[:split]] = True
    return (
        is_left,
        ax,
        (l_lo[split - 1], l_hi[split - 1]),
        (r_lo[split], r_hi[split]),
    )


def build_bvh_fast(
    tri_lo: np.ndarray,
    tri_hi: np.ndarray,
    leaf_size: int = 8,
) -> BVH:
    """Level-synchronous binned-SAH build: all nodes of a depth level are
    processed in one batch of vectorized NumPy ops. Same cost model and
    layout invariants as :func:`build_bvh` (16 bins on the max-extent
    axis, hard leaf cap with forced splits, children adjacent, leaves
    over contiguous reordered ranges); the counting sort by
    (segment, bin) that computes the per-bin boxes IS the left|right
    partition, so each level is O(T) with no per-node Python."""
    t = len(tri_lo)
    tri_lo = np.asarray(tri_lo, np.float32)
    tri_hi = np.asarray(tri_hi, np.float32)
    centers = (tri_lo + tri_hi) * 0.5

    cap = max(2 * t, 16)
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    child = np.zeros(cap, np.int32)
    count = np.zeros(cap, np.int32)
    axis = np.zeros(cap, np.int32)
    first_node = np.zeros(cap, np.int32)

    order = np.arange(t, dtype=np.int64)
    node_lo[0] = tri_lo.min(axis=0)
    node_hi[0] = tri_hi.max(axis=0)
    n_nodes = 1

    # active segments of the current level
    seg_nid = np.array([0], np.int64)
    seg_first = np.array([0], np.int64)
    seg_cnt = np.array([t], np.int64)
    depth = 0
    max_depth_seen = 0

    while len(seg_nid):
        max_depth_seen = max(max_depth_seen, depth)
        ns = len(seg_nid)
        blo = node_lo[seg_nid]
        bhi = node_hi[seg_nid]
        ext = bhi - blo
        sp_axis = np.argmax(ext, axis=1)
        width = ext[np.arange(ns), sp_axis]

        # ---- bin every triangle of the level (by its segment's axis) --
        sid = np.repeat(np.arange(ns), seg_cnt)  # segment of each slot
        slots = np.concatenate(
            [np.arange(f, f + c) for f, c in zip(seg_first, seg_cnt)]
        ) if ns else np.empty(0, np.int64)
        tri = order[slots]
        c = centers[tri, sp_axis[sid]]
        mul = np.where(width > 0, N_BINS * (1.0 - 1e-6)
                       / np.maximum(width, 1e-30), 0.0)
        bin_idx = np.clip(((c - blo[sid, sp_axis[sid]]) * mul[sid])
                          .astype(np.int64), 0, N_BINS - 1)

        # counting sort by (segment, bin): doubles as the partition
        key = sid * N_BINS + bin_idx
        sort = np.argsort(key, kind="stable")
        tri_s = tri[sort]
        key_s = key[sort]
        # per-(seg, bin) counts and reduceat boxes
        bc = np.bincount(key_s, minlength=ns * N_BINS).reshape(ns, N_BINS)
        starts = np.zeros(ns * N_BINS, np.int64)
        starts[1:] = np.cumsum(bc.reshape(-1))[:-1]
        nz = bc.reshape(-1) > 0
        bin_lo = np.full((ns * N_BINS, 3), np.inf, np.float32)
        bin_hi = np.full((ns * N_BINS, 3), -np.inf, np.float32)
        if nz.any():
            bin_lo[nz] = np.minimum.reduceat(tri_lo[tri_s],
                                             starts[nz], axis=0)
            bin_hi[nz] = np.maximum.reduceat(tri_hi[tri_s],
                                             starts[nz], axis=0)
        bin_lo = bin_lo.reshape(ns, N_BINS, 3)
        bin_hi = bin_hi.reshape(ns, N_BINS, 3)

        left_lo = np.minimum.accumulate(bin_lo, axis=1)
        left_hi = np.maximum.accumulate(bin_hi, axis=1)
        right_lo = np.minimum.accumulate(bin_lo[:, ::-1], axis=1)[:, ::-1]
        right_hi = np.maximum.accumulate(bin_hi[:, ::-1], axis=1)[:, ::-1]
        left_cnt = np.cumsum(bc, axis=1)
        right_cnt = np.cumsum(bc[:, ::-1], axis=1)[:, ::-1]

        cl = left_cnt[:, :-1]
        cr = right_cnt[:, 1:]
        costs = (np.where(cl > 0, _box_sa(left_lo[:, :-1],
                                          left_hi[:, :-1]) * cl, 0.0)
                 + np.where(cr > 0, _box_sa(right_lo[:, 1:],
                                            right_hi[:, 1:]) * cr, 0.0))
        best = np.argmin(costs, axis=1) + 1  # split-at-bin per segment
        bcost = costs[np.arange(ns), best - 1]
        no_split = seg_cnt * _box_sa(blo, bhi)

        n_left = left_cnt[np.arange(ns), best - 1]
        degenerate = (n_left == 0) | (n_left == seg_cnt) | (width <= 0)
        # hard leaf cap: oversized nodes must split even when SAH says
        # stop (see build_bvh); forced-median keeps termination bounded.
        # (The reference keeps soft leaves, tree.cpp:235-237; the hard
        # cap makes the no-split verdict irrelevant above it.)
        need = np.ceil(np.log2(np.maximum(seg_cnt / leaf_size, 1.0)))
        must = seg_cnt > leaf_size
        sah_ok = (~degenerate) & (depth < MAX_DEPTH - 1 - need)
        leaf = ~must
        split_sah = must & sah_ok
        split_med = must & ~split_sah
        del no_split, bcost  # cost bookkeeping kept for parity/debug

        # ---- emit leaves (registered now, boxes tightened at the end)
        lidx = np.where(leaf)[0]
        if len(lidx):
            child[seg_nid[lidx]] = seg_first[lidx]
            count[seg_nid[lidx]] = seg_cnt[lidx]

        # ---- splits ----
        sidx = np.where(~leaf & must)[0]
        if len(sidx) == 0:
            # write back the (sorted) order for the level and stop
            order[slots] = tri_s
            break

        # median split for degenerate/depth-forced segments: split at
        # the bin boundary closest to half the count; if ALL tris share
        # one bin, fall back to an exact per-segment argpartition
        sel_best = best.copy()
        for i in np.where(split_med)[0]:
            lc = left_cnt[i]
            half = seg_cnt[i] // 2
            # first bin boundary with left count >= half and both sides
            # nonempty
            cand = np.where((lc[:-1] > 0) & (lc[:-1] < seg_cnt[i]))[0]
            if len(cand):
                sel_best[i] = cand[np.argmin(np.abs(lc[cand] - half))] + 1
            else:
                sel_best[i] = -1  # exact fallback

        # write back sorted order (partition by bin within each segment)
        order[slots] = tri_s

        # exact fallback for single-bin segments (rare: flat or
        # coincident geometry)
        for i in np.where(sel_best == -1)[0]:
            f, cnt_i = seg_first[i], seg_cnt[i]
            segsl = order[f : f + cnt_i]
            ax = int(sp_axis[i])
            keyc = centers[segsl, ax]
            mid = int(cnt_i // 2)
            part = np.argpartition(keyc, mid)
            order[f : f + cnt_i] = segsl[part]

        # children allocation (adjacent, level order)
        nsp = len(sidx)
        cidx = n_nodes + 2 * np.arange(nsp)
        n_nodes += 2 * nsp

        for j, i in enumerate(sidx):
            f, cnt_i = seg_first[i], seg_cnt[i]
            if sel_best[i] == -1:
                nl = int(cnt_i // 2)
                lsl = order[f : f + nl]
                rsl = order[f + nl : f + cnt_i]
                l_lo, l_hi = tri_lo[lsl].min(0), tri_hi[lsl].max(0)
                r_lo, r_hi = tri_lo[rsl].min(0), tri_hi[rsl].max(0)
            else:
                b = int(sel_best[i])
                nl = int(left_cnt[i, b - 1])
                l_lo, l_hi = left_lo[i, b - 1], left_hi[i, b - 1]
                r_lo, r_hi = right_lo[i, b], right_hi[i, b]
            nid = int(seg_nid[i])
            ci = int(cidx[j])
            child[nid] = ci
            count[nid] = 0
            ax = int(sp_axis[i])
            axis[nid] = ax
            if l_lo[ax] == r_lo[ax]:
                fn = 0 if l_hi[ax] < r_hi[ax] else 1
            else:
                fn = 1 if l_lo[ax] > r_lo[ax] else 0
            first_node[nid] = fn
            node_lo[ci], node_hi[ci] = l_lo, l_hi
            node_lo[ci + 1], node_hi[ci + 1] = r_lo, r_hi

        # next level segments
        nls = []
        for j, i in enumerate(sidx):
            f, cnt_i = int(seg_first[i]), int(seg_cnt[i])
            if sel_best[i] == -1:
                nl = cnt_i // 2
            else:
                nl = int(left_cnt[i, int(sel_best[i]) - 1])
            nls.append(nl)
        nls = np.asarray(nls, np.int64)
        seg_nid = np.stack([cidx, cidx + 1], axis=1).reshape(-1)
        seg_first = np.stack(
            [seg_first[sidx], seg_first[sidx] + nls], axis=1).reshape(-1)
        seg_cnt = np.stack(
            [nls, seg_cnt[sidx] - nls], axis=1).reshape(-1)
        depth += 1

    # tighten LEAF boxes exactly (the level loop wrote split-derived
    # boxes; leaves keep bin-union boxes which can be loose on the
    # non-split axes only when emitted from the level path above — do
    # one vectorized pass)
    leaf_ids = np.where(count[:n_nodes] > 0)[0]
    for nid in leaf_ids:
        f, c = int(child[nid]), int(count[nid])
        sl = order[f : f + c]
        node_lo[nid] = tri_lo[sl].min(axis=0)
        node_hi[nid] = tri_hi[sl].max(axis=0)

    return BVH(
        node_lo=node_lo[:n_nodes].copy(),
        node_hi=node_hi[:n_nodes].copy(),
        child=child[:n_nodes].copy(),
        count=count[:n_nodes].copy(),
        axis=axis[:n_nodes].copy(),
        first_node=first_node[:n_nodes].copy(),
        order=order.astype(np.int64),
        depth=max_depth_seen,
    )
