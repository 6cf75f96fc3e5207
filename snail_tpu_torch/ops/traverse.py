"""Traversal: primary closest hit, shadow any-hit and bounce closest hit
(``snail_tpu.ops.traverse_pallas``). A scene with leaf tables takes the
worklist kernels (the JAX package's ``SNAIL_WL=1`` path, B1-B8, below); a
scene with node tables takes the walk kernels (B9a-d, the ``SNAIL_WL=0``
path, whose paged twins B10a-d they also cover, and B9e/B9f, the walk's
counters: see ``NodeTables`` and the section "Walk kernels"; all on the
raw triangle rows, B9a/B9b/B9e/B9f from their shared origin), or, where
its leaves hold more than IVAL_LEAF triangles, the fat-leaf kernels
(B11a-d, section "Fat-leaf kernels").

A frame is traced in packets of TILE x TILE = 64 x 64 pixels (PACKET_R =
4096 rays). Ray k of a packet is pixel ``(k & 31, k >> 5)`` of the
32 x 32 quadrant ``k >> 10`` (quadrants in raster order inside the tile),
the JAX package's square-quadrant order. Every wavefront is flat (R,)
float32 per component in that order.

Each wavefront runs two kernels:

1. a *words* pass (B1 camera, B3 shared origin, B5 per-ray origins): per
   packet, the ray interval bounds (inverse directions, and origins for
   B5) are tested against every leaf box of the BVH (the kernels test
   each 32-leaf word's box first, and the leaves of the words that pass);
   passing leaves are sorted into ``k_bands`` equal-count near-to-far
   distance bands and emitted as bit words, one summary word per 1024
   leaves and one distance floor per band;
2. a *trace* pass (B2 closest hit from the camera, B4 any-hit from a
   light, B6 closest hit and B7 any-hit from per-ray origins): the
   surviving leaf bits are scanned band by band; each ray culls the leaf
   box against its own current best and intersects the leaf's triangles
   with the full Moller test on the raw triangle rows (B2 and B4 from
   their shared origin: the JAX package's ``raw=True`` form, with no
   per-frame table). B8a/B8b are B2/B4 that also count what each
   packet's warps did (:data:`STATS`), on the shared-origin Moller terms
   of :func:`shared_rows`, as the JAX package's counter frame does.

Word layout, per packet: ``words`` int32 (P, K, Lp/32), bit p of word w =
leaf 32*w + p; ``summ`` int32 (P, K, Lp/1024), bit j of word s = word
32*s + j is nonzero; ``floors`` float32 (P, K), the least interval entry
distance of band b (BIG when the band is empty).

Every worklist kernel has a plain PyTorch version here, every walk kernel
in :mod:`.traverse_ref`. The wrappers route by the device of their
tensors: CUDA tensors launch the kernels of ``snail_tpu_torch/csrc``
(``worklist.cu``, ``walk.cu``), CPU tensors take the plain version. Each
wrapper counts its kernel launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..core.vecmath import BIG, rsqrt_rn, safe_inv
from ..utils import trace

TILE = 64  # square pixel tile per packet
PACKET_R = TILE * TILE  # rays per packet
QX = TILE // 32  # 32x32 quadrants per tile row
_QX_SHIFT = QX.bit_length() - 1
IVAL_LEAF = 32  # largest leaf of the worklist and walk kernels (triangles)
LEAF_PAD = 64  # largest leaf of the fat-leaf kernels (triangles)
WL_BANDS = 8  # closest-hit distance bands
LEAF_BLOCK = 1024  # leaves per summary word (32 words of 32 bits)
TRI_ROW = 16  # floats per 64-B triangle row
_HIST_BINS = 32  # histogram bins of the equal-count band edges
WARP = 32  # rays per warp: one thread per ray
WARPS = PACKET_R // WARP  # warps per packet
# The most leaf slots of leaf tables; a scene with more gets node tables,
# and the words passes (csrc/worklist.cu kMaxLp) refuse larger tables.
WL_MAX_LP = 429_056
# Blocks per packet of the words passes B1, B3 and B5, one thread block
# cluster (1, 2, 4 or 8): the fastest of the four on terrain_724's frame
# wavefronts at 1024 x 1024 on an H100 (time_words.py, PERF.md). More
# blocks split a packet's work, but past one wave of blocks each adds its
# chain of barriers; B1's primary packets pass few words.
WORDS_CLUSTER = {"words_camera": 2, "words_shared": 4, "words_general": 4}
# The counters of B8a/B8b and B9e/B9f, per packet: the slots of its (P, 8)
# int32 row (the JAX package's names and slots; slots 5-7 stay 0). What
# each counts is in csrc/worklist.cu (struct Counters) and csrc/walk.cuh
# (struct WalkCounts).
STATS = ("nodes", "leaves", "quarters", "tri_blocks", "chunks")
# rays per tri_blocks unit: one triangle is tested against one warp
RAYS_PER_TRI_BLOCK = WARP
# The tally of the warps of a simulated walk (``traverse_ref._WarpWalk``)
# or scan (:func:`shadow_wl_g_sim`), per warp: node rows loaded (loop
# steps; for a scan, the words that reach the leaf level), leaf visits
# (leaves some lane enters), the lanes that enter them and the rows of
# the leaves visited, summed over the visits, and the visits by their
# entering lanes: 1, 2-4, 5-8, 9-16, 17-32 (the two ways csrc/walk.cuh
# leaf_closest_staged and csrc/rays.cuh leaf_blocks_staged test a leaf).
# Then, summed over the visits: ``tested``, the rows the entering lanes
# tested up to their stop (an any-hit lane stops at its first occluder),
# against ``lane_rows``, the rows of the leaf times its entering lanes;
# ``most``, the most rows a lane tested (the loop of a visit tested lane
# per ray); ``blocked``, the entering lanes blocked in the visit; and
# ``chunk2``, the visits of a leaf of more than 32 rows that some
# entering lane is not blocked by within its first 32 rows (the visits
# that would still test rows 33-64 if a leaf were staged 32 rows at a
# time).
LANE_BINS = ("1", "2-4", "5-8", "9-16", "17-32")
TALLY = (("nodes", "visits", "lanes", "rows") + LANE_BINS
         + ("tested", "lane_rows", "most", "blocked", "chunk2"))
_BIN_EDGES = (1, 4, 8, 16)
CHUNK_ROWS = 32  # the rows of a half leaf (``chunk2``)


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafTables:
    """Leaf tables of the worklist kernels (the port's
    ``pack_leaf_tables``). Leaves are in leaf-index order: sorted by node
    id, the BVH's DFS order, so neighbouring bits are neighbouring leaves.

    box   float32 (6, Lp): lo.xyz, hi.xyz, planar; padding slots inverted
    first int32 (Lp,): first triangle of the leaf
    count int32 (Lp,): triangles in the leaf (<= IVAL_LEAF)
    wbox  float32 (6, Lp/32): the box around the real leaves of each bit
          word (leaves 32w..32w+31), as ``box``; a word without a real
          leaf is inverted (1e30 / -1e30)
    bbox  float32 (6, Lp/LEAF_BLOCK): the same for each block of a summary
          word (leaves 1024s..1024s+1023)
    n_leaf: real leaf count; Lp = n_leaf rounded up to LEAF_BLOCK.

    Min and max do not round, so ``wbox`` and ``bbox`` hold the leaf
    boxes' own floats and contain every leaf box of their word or block:
    the skip tests of B4, B6 and B7 (csrc/worklist.cu ``scan_boxes``) and
    B5's word pre-test rest on that."""

    box: torch.Tensor
    first: torch.Tensor
    count: torch.Tensor
    wbox: torch.Tensor
    bbox: torch.Tensor
    n_leaf: int

    @property
    def lp(self) -> int:
        return self.box.shape[1]

    @functools.cached_property
    def root(self) -> torch.Tensor:
        """float32 (6,): the box around every leaf, lo.xyz then hi.xyz."""
        return torch.cat([self.box[:3].amin(1), self.box[3:].amax(1)])

    def to(self, device) -> "LeafTables":
        return LeafTables(self.box.to(device), self.first.to(device),
                          self.count.to(device), self.wbox.to(device),
                          self.bbox.to(device), self.n_leaf)


def _group_boxes(box: np.ndarray, n: int) -> np.ndarray:
    """float32 (6, Lp/n): the box around each run of ``n`` leaves of the
    planar leaf ``box`` (6, Lp); padding slots, inverted, drop out."""
    g = box.reshape(6, -1, n)
    return np.concatenate([g[:3].min(-1), g[3:].max(-1)])


def pack_leaf_tables(node_lo, node_hi, node_child,
                     node_count) -> LeafTables:
    """Leaf boxes, first triangle and count per leaf of a BVH given by its
    node arrays (``snail_tpu_torch.bvh.BVH`` fields)."""
    leaf = np.where(node_count > 0)[0]
    if len(leaf) == 0:
        raise ValueError("BVH has no leaves")
    cnt = node_count[leaf]
    if int(cnt.max()) > IVAL_LEAF:
        raise ValueError(
            f"leaf of {int(cnt.max())} triangles > IVAL_LEAF ({IVAL_LEAF}); "
            f"build the BVH with leaf_size <= {IVAL_LEAF}")
    n = len(leaf)
    lp = -(-n // LEAF_BLOCK) * LEAF_BLOCK
    box = np.empty((6, lp), np.float32)
    box[0:3, :n] = node_lo[leaf].T
    box[3:6, :n] = node_hi[leaf].T
    box[0:3, n:] = 1e30
    box[3:6, n:] = -1e30
    first = np.zeros(lp, np.int32)
    first[:n] = node_child[leaf]
    count = np.zeros(lp, np.int32)
    count[:n] = cnt
    return LeafTables(torch.from_numpy(box), torch.from_numpy(first),
                      torch.from_numpy(count),
                      torch.from_numpy(_group_boxes(box, WARP)),
                      torch.from_numpy(_group_boxes(box, LEAF_BLOCK)), n)


@dataclasses.dataclass(frozen=True)
class NodeTables:
    """Node tables of the walk kernels (the port's ``pack_scene_arrays``,
    in the spirit of the reference's 32-byte node, tree.h:60-72).

    node  float32 (N, 8): per node lo.xyz, hi.xyz, then two int32 stored
          as their bits: child (the left child, the right one is child +
          1; a leaf's first triangle) and meta = count | axis << 16 |
          first_node << 18 (count 0 for an inner node)
    depth: the tree's depth, the root at 0, counted from the arrays; a
          walk holds at most one far child per level, and the walks keep
          ``stack_cap`` = depth + 2 entries (the reference's maxDepth + 2,
          traverse.cpp:17), for any depth
    leaf_max: the most triangles of a leaf (<= LEAF_PAD); above IVAL_LEAF
          the tree is traced by the fat-leaf kernels."""

    node: torch.Tensor
    depth: int
    leaf_max: int

    @property
    def n_nodes(self) -> int:
        return self.node.shape[0]

    @property
    def stack_cap(self) -> int:
        return self.depth + 2

    def columns(self):
        """(lo (N, 3), hi (N, 3), child, count, axis, first) of every
        node; the integers as int64."""
        bits = self.node.view(torch.int32)
        meta = bits[:, 7].long()
        return (self.node[:, 0:3], self.node[:, 3:6], bits[:, 6].long(),
                meta & 0xFFFF, (meta >> 16) & 3, (meta >> 18) & 1)

    def to(self, device) -> "NodeTables":
        return NodeTables(self.node.to(device), self.depth, self.leaf_max)


def tree_depth(child: np.ndarray, count: np.ndarray) -> int:
    """Depth of the BVH given by its child and count arrays, the root at
    depth 0, level by level from the root."""
    frontier, depth = np.zeros(1, np.int64), 0
    while True:
        inner = frontier[count[frontier] == 0]
        if len(inner) == 0:
            return depth
        left = child[inner].astype(np.int64)
        frontier = np.concatenate([left, left + 1])
        depth += 1


def pack_node_tables(node_lo, node_hi, node_child, node_count, node_axis,
                     node_first) -> NodeTables:
    """Node tables of a BVH given by its node arrays (``BVH`` fields
    node_lo, node_hi, child, count, axis, first_node), with leaves of at
    most LEAF_PAD triangles (``pack_scene_arrays`` :170)."""
    leaf_max = int(node_count.max())
    if leaf_max > LEAF_PAD:
        raise ValueError(
            f"leaf of {leaf_max} triangles > LEAF_PAD ({LEAF_PAD}); build "
            f"the BVH with leaf_size <= {LEAF_PAD}")
    rows = np.zeros((len(node_child), 8), np.float32)
    rows[:, 0:3] = node_lo
    rows[:, 3:6] = node_hi
    bits = rows.view(np.int32)
    bits[:, 6] = node_child
    bits[:, 7] = (np.asarray(node_count, np.int32)
                  | (np.asarray(node_axis, np.int32) & 3) << 16
                  | (np.asarray(node_first, np.int32) & 1) << 18)
    return NodeTables(torch.from_numpy(rows),
                      tree_depth(np.asarray(node_child),
                                 np.asarray(node_count)), leaf_max)


def pack_tri_rows(a, ba, ca) -> np.ndarray:
    """64-B triangle rows: a, ba, ca, n = ba x ca (unnormalized), pad."""
    rows = np.zeros((len(a), TRI_ROW), np.float32)
    rows[:, 0:3] = a
    rows[:, 3:6] = ba
    rows[:, 6:9] = ca
    rows[:, 9:12] = np.cross(ba, ca)
    return rows


def _cross(a, b):
    return torch.stack([
        a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
    ], dim=1)


def shared_rows(tris: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """Per-frame shared-origin triangle table, one per origin: the rows of
    the leaf-table counter frame's B8a/B8b alone, as the JAX package's
    ``camera_trace_stats`` takes them; every other kernel tests the raw
    rows.

    For a shared ray origin ``o`` every origin-dependent term of the Moller
    test is a per-triangle constant: tv = o - a, c1 = tv x ca,
    c2 = ba x tv, tmul = -(tv . n) (the reference's
    RayGroup<sharedOrigin=1>, ray_group.h:74-110).

    tris (T, 16) rows [a, ba, ca, n, pad] -> (T, 16) rows
    [n(0:3), c1(3:6), c2(6:9), tmul(9), 0...]. Traced as the stage
    ``snail.rows``, its T rows (a scene's triangles and their LEAF_PAD pad
    rows) counted in ``rows.tris``."""
    with trace.span("snail.rows"):
        trace.count("rows.tris", tris.shape[0])
        a, ba, ca, n = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9], tris[:, 9:12]
        tv = origin.reshape(1, 3) - a
        out = torch.zeros_like(tris)
        out[:, 0:3] = n
        out[:, 3:6] = _cross(tv, ca)
        out[:, 6:9] = _cross(ba, tv)
        out[:, 9] = -(tv[:, 0] * n[:, 0] + tv[:, 1] * n[:, 1]
                      + tv[:, 2] * n[:, 2])
        return out


def kernel_ray_index(width: int, height: int) -> np.ndarray:
    """Packet-order ray r -> flat pixel index py * width + px."""
    px, py = _pixel_xy(width, height, torch.arange(
        (width // TILE) * (height // TILE)), "cpu")
    return (py * width + px).reshape(-1).numpy()


def camera_wl_order() -> torch.Tensor:
    """int64 (PACKET_R,): the packet-order ray of each thread of a packet
    of the camera kernels B2 (B8a), B9a (B9e) and B11a (``csrc/rays.cuh``
    ``tile_ray``): warp w of quarter q takes
    the 8 x 4 pixel tile (w % 4, w // 4) of the quarter's 32 x 32, lane l
    its pixel (l % 8, l // 8), so ``x[..., camera_wl_order()]`` gives each
    warp's rays as 32 consecutive lanes."""
    t = torch.arange(PACKET_R)
    q, w, lane = t >> 10, (t >> 5) & 31, t & 31
    return (q << 10) | (((w >> 2) * 4 + (lane >> 3)) << 5) | (
        (w & 3) * 8 + (lane & 7))


def _pixel_xy(width: int, height: int, pids: torch.Tensor, device):
    """int64 (len(pids), PACKET_R) pixel coordinates of packets ``pids``."""
    tiles_x = width // TILE
    k = torch.arange(PACKET_R, device=device)
    q, i = k >> 10, k & 1023
    pxk = ((q & (QX - 1)) << 5) + (i & 31)
    pyk = ((q >> _QX_SHIFT) << 5) + (i >> 5)
    pids = pids.to(device)
    px = (pids % tiles_x)[:, None] * TILE + pxk[None, :]
    py = (pids // tiles_x)[:, None] * TILE + pyk[None, :]
    return px, py


def cam_vec(camera, width: int, height: int, root_lo, root_hi):
    """Camera scalars of the primary kernels, float32 (22,) on the
    camera's device: right, up, front * plane_dist, pos, w/2, h/2, 1/h,
    tiles_x, root lo.xyz, root hi.xyz (the JAX package's ``_cam_vec_rb``)."""
    dev = camera.pos.device
    # non-blocking, as core.types builds a camera: no wait for queued work
    scal = torch.tensor([width * 0.5, height * 0.5, 1.0 / height,
                         float(width // TILE)], dtype=torch.float32
                        ).to(dev, non_blocking=True)
    return torch.cat([camera.right, camera.up,
                      camera.front * camera.plane_dist, camera.pos, scal,
                      root_lo.to(dev), root_hi.to(dev)]).float().contiguous()


def pad_flat(x: torch.Tensor, fill: float = 0.0):
    """Pad a flat (n,) wavefront to a whole number of packets."""
    n = x.shape[0]
    p = -(-n // PACKET_R)
    return torch.nn.functional.pad(x, (0, p * PACKET_R - n), value=fill), n


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------


def _camera_rays(cam, width: int, height: int, pids):
    """Primary dirs, inverse dirs and root-box exit distance of packets
    ``pids``: float32 (len(pids), PACKET_R) each (the in-kernel raygen)."""
    px, py = _pixel_xy(width, height, pids, cam.device)
    px, py = px.float(), py.float()
    x = (px + 0.5 - cam[12]) * cam[14]
    y = (cam[13] - py - 0.5) * cam[14]
    d = [cam[k] * x + cam[3 + k] * y + cam[6 + k] for k in range(3)]
    inv_len = rsqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = [c * inv_len for c in d]
    idir = [safe_inv(c) for c in d]
    t1 = [(cam[16 + k] - cam[9 + k]) * idir[k] for k in range(3)]
    t2 = [(cam[19 + k] - cam[9 + k]) * idir[k] for k in range(3)]
    tn, tf = _slab(t1, t2)
    t_exit = torch.where((tn <= tf) & (tf > 0.0), tf * 1.0001,
                         torch.zeros_like(tf))
    return d, idir, t_exit


def _slab(t1, t2):
    tn = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                     torch.minimum(t1[1], t2[1])),
                       torch.minimum(t1[2], t2[2]))
    tf = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                     torch.maximum(t1[1], t2[1])),
                       torch.maximum(t1[2], t2[2]))
    return tn, tf


def _widen(lo, hi):
    """Conservative widening of a reduced bound pair."""
    w = 1e-6
    return lo - lo.abs() * w - 1e-30, hi + hi.abs() * w + 1e-30


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32n) bool -> (..., n) int32, bit p of word w = element 32w+p."""
    b = bits.reshape(*bits.shape[:-1], -1, 32).long()
    w = (b << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., n) int32 -> (..., 32n) bool (inverse of the word packing)."""
    sh = torch.arange(32, device=words.device, dtype=torch.int32)
    return ((words[..., None] >> sh) & 1).bool().reshape(
        *words.shape[:-1], -1)


def _corner_range(x, om, oM, lm, lM):
    """Least and greatest of (x - o) * i over the corners of the origin
    interval [om, oM] and the inverse-direction interval [lm, lM]; one
    origin (om is oM) has two corners."""
    xs = (x - om,) if om is oM else (x - om, x - oM)
    prods = [a * lm for a in xs] + [a * lM for a in xs]
    lo, hi = prods[0], prods[0]
    for q in prods[1:]:
        lo, hi = torch.minimum(lo, q), torch.maximum(hi, q)
    return lo, hi


def _interval_test(box, om, oM, im, iM, mb):
    """Each packet's interval entry and exit of every column of the planar
    ``box`` (6, n), the kernels' ``leaf_entry``: tn and tf, (P, n) each.
    ``om``/``oM``: the origin bounds, three scalars each (a shared origin:
    the same tensors) or three (P, 1); ``im``/``iM``: the inverse-direction
    bounds, three (P,) each; ``mb``: (P,) packet distance bound."""
    p, n = mb.shape[0], box.shape[1]
    tn = torch.zeros((p, n), dtype=torch.float32, device=box.device)
    tf = mb[:, None].expand(p, n)
    for k in range(3):
        lm, lM = im[k][:, None], iM[k][:, None]
        o_lo = om[k]
        o_hi = o_lo if om is oM else oM[k]
        lo_min, lo_max = _corner_range(box[k][None, :], o_lo, o_hi, lm, lM)
        hi_min, hi_max = _corner_range(box[3 + k][None, :], o_lo, o_hi,
                                       lm, lM)
        tn = torch.maximum(tn, torch.minimum(lo_min, hi_min))
        tf = torch.minimum(tf, torch.maximum(lo_max, hi_max))
    return tn, tf


def _leaf_pass(tables: LeafTables, om, oM, idir, mb, k_bands: int):
    """Interval test of every leaf against each packet's bounds, banding
    and bit packing. ``om``/``oM``: the origin bounds, three scalars each
    (a shared origin: the same tensors) or three (P, 1); ``idir``: three
    (P, PACKET_R) inverse dirs; ``mb``: (P,) packet distance bound."""
    im, iM = zip(*[_widen(c.amin(1), c.amax(1)) for c in idir])
    box = tables.box
    p, lp = mb.shape[0], tables.lp
    tn, tf = _interval_test(box, om, oM, im, iM, mb)
    # padding slots must never pass: with a direction interval spanning 0
    # the inverted +-1e30 boxes alone would pass the test
    real = torch.arange(lp, device=box.device)[None, :] < tables.n_leaf
    ok = (tn <= tf) & (tf > 0.0) & real

    t0 = torch.minimum(torch.where(ok, tn, BIG).amin(1), mb)
    span = torch.clamp_min(mb - t0, 1e-6)
    los = [t0]
    band = torch.zeros((p, lp), dtype=torch.int64, device=box.device)
    if k_bands > 1:
        # histogram-equalized band edges: ~1/K of the passing leaves each
        scale = (_HIST_BINS / span)[:, None]
        # clamped before the cast: a leaf that fails the test may lie
        # anywhere, outside the int range
        bidx = ((tn - t0[:, None]) * scale).clamp(-1.0, float(_HIST_BINS))
        bidx = bidx.to(torch.int64).clamp(0, _HIST_BINS - 1)
        bidx = torch.where(ok, bidx, _HIST_BINS)
        hist = torch.zeros((p, _HIST_BINS + 1), dtype=torch.int64,
                           device=box.device)
        hist.scatter_add_(1, bidx, torch.ones_like(bidx))
        c = torch.cumsum(hist[:, :_HIST_BINS], dim=1)
        total = torch.clamp_min(c[:, -1], 1)
        for b in range(1, k_bands):
            tgt = (total * b + k_bands - 1) // k_bands
            e = (c < tgt[:, None]).sum(1)
            los.append(t0 + e.float() * (span / _HIST_BINS))
            band += (tn >= los[b][:, None]).long()
    bits = torch.stack([ok & (band == b) for b in range(k_bands)], dim=1)
    words = _pack_bits(bits)
    summ = _pack_bits(words != 0)
    floors = torch.where(summ.ne(0).any(-1), torch.stack(los, dim=1),
                         torch.full_like(t0[:, None], BIG))
    return words, summ, floors


def _camera_bounds(cam, width: int, height: int, pids):
    """B1's packet bounds of the primary rays of packets ``pids``: the
    camera position as both origin bounds, the inverse directions (three
    (P, PACKET_R)) and the distance bound (P,)."""
    _, idir, t_exit = _camera_rays(cam, width, height, pids)
    o = cam[9:12]
    return o, o, idir, t_exit.amax(1) * 1.0001 + 1e-30


def _shared_bounds(orig, d, tm):
    """B3's packet bounds of rays from the one origin ``orig``: as
    :func:`_camera_bounds`, of the planes ``d`` and ``tm``."""
    idir = [safe_inv(c) for c in d]
    limit = torch.where(tm >= 0.0, tm, -BIG)
    return orig, orig, idir, limit.amax(1) * 1.0001 + 1e-30


def words_camera_plain(cam, width: int, height: int, tables: LeafTables,
                       k_bands: int, pids: torch.Tensor):
    """Plain B1: the primary leaf pass of packets ``pids``."""
    return _leaf_pass(tables, *_camera_bounds(cam, width, height, pids),
                      k_bands)


def words_shared_plain(orig, d, tm, tables: LeafTables, k_bands: int):
    """Plain B3: the leaf pass of rays from one origin; ``d`` three and
    ``tm`` one (P, PACKET_R) float32 planes."""
    return _leaf_pass(tables, *_shared_bounds(orig, d, tm), k_bands)


def _general_bounds(o, d, tm):
    """B5's packet bounds of the planes ``o``, ``d``, ``tm``: the widened
    origin bounds (three (P, 1) each), the inverse directions (three (P,
    PACKET_R)) and the distance bound (P,)."""
    idir = [safe_inv(c) for c in d]
    limit = torch.where(tm >= 0.0, tm.clamp_max(BIG), -BIG)
    mb = limit.amax(1) * 1.0001 + 1e-30
    om, oM = zip(*[_widen(c.amin(1, keepdim=True), c.amax(1, keepdim=True))
                   for c in o])
    return om, oM, idir, mb


def words_general_plain(o, d, tm, tables: LeafTables, k_bands: int):
    """Plain B5: the leaf pass of rays with their own origins; ``o`` and
    ``d`` three and ``tm`` one (P, PACKET_R) float32 planes, masked rays
    already substituted (:func:`substitute_masked`)."""
    return _leaf_pass(tables, *_general_bounds(o, d, tm), k_bands)


def _word_tests(tables: LeafTables, om, oM, idir, mb):
    """bool (P, Lp/32): the word's box (``tables.wbox``) passes the
    packet's interval test (the bounds of :func:`_leaf_pass`), or a bound
    of the interval is not finite."""
    im, iM = zip(*[_widen(c.amin(1), c.amax(1)) for c in idir])
    tn, tf = _interval_test(tables.wbox, om, oM, im, iM, mb)
    tame = torch.ones_like(mb, dtype=torch.bool)
    for x in (*om, *oM, *im, *iM):
        f = torch.isfinite(x)
        tame &= f.reshape(f.shape[0] if f.dim() else 1, -1).all(1)
    return ((tn <= tf) & (tf > 0.0)) | ~tame[:, None]


def camera_word_tests(cam, width: int, height: int, tables: LeafTables,
                      pids: torch.Tensor):
    """The words whose leaves B1's kernel tests on the primary rays of
    packets ``pids``: bool (P, Lp/32), the word's box passes the packet's
    interval test, or a bound of the interval is not finite (the kernel
    then tests every word). A word whose box fails has no leaf that passes
    (csrc/worklist.cu ``words_cluster_kernel``)."""
    return _word_tests(tables, *_camera_bounds(cam, width, height, pids))


def shared_word_tests(orig, d, tm, tables: LeafTables):
    """:func:`camera_word_tests` of B3 on rays from the one origin
    ``orig``, the planes ``d`` and ``tm``."""
    return _word_tests(tables, *_shared_bounds(orig, d, tm))


def general_word_tests(o, d, tm, tables: LeafTables):
    """:func:`camera_word_tests` of B5 on the planes ``o``, ``d``,
    ``tm``."""
    return _word_tests(tables, *_general_bounds(o, d, tm))


def _packet_leaves(tables: LeafTables, words_p):
    """Leaf ids set in any band of one packet's words, and for each of
    their triangles the triangle id and the position of its leaf."""
    leaves = torch.nonzero(unpack_bits(words_p).any(0)).flatten()
    return (leaves, *_leaf_tris(tables, leaves))


def _leaf_tris(tables: LeafTables, leaves):
    """Triangle ids of ``leaves`` and, per triangle, its leaf's position."""
    cnt = tables.count[leaves].long()
    owner = torch.repeat_interleave(torch.arange(len(leaves),
                                                 device=cnt.device), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    tri = (tables.first[leaves].long()[owner]
           + torch.arange(len(owner), device=cnt.device) - start[owner])
    return tri, owner


def _leaf_slab(tables: LeafTables, o, idir, leaves):
    """Per-ray slab test of ``leaves``: entry and exit, (R, n) each. ``o``:
    three scalars (a shared origin) or three (R,)."""
    box = tables.box[:, leaves]
    t1 = [(box[k][None, :] - o[k].reshape(-1, 1)) * idir[k][:, None]
          for k in range(3)]
    t2 = [(box[3 + k][None, :] - o[k].reshape(-1, 1)) * idir[k][:, None]
          for k in range(3)]
    return _slab(t1, t2)


def _moller_sh(rows, d):
    """Shared-origin Moller terms of rays ``d`` (three (R,)) against
    ``rows`` (n, 16): det, u, v, tmul, each (R, n)."""
    det = (d[0][:, None] * rows[None, :, 0] + d[1][:, None] * rows[None, :, 1]
           + d[2][:, None] * rows[None, :, 2])
    u = (d[0][:, None] * rows[None, :, 3] + d[1][:, None] * rows[None, :, 4]
         + d[2][:, None] * rows[None, :, 5])
    v = (d[0][:, None] * rows[None, :, 6] + d[1][:, None] * rows[None, :, 7]
         + d[2][:, None] * rows[None, :, 8])
    return det, u, v, rows[None, :, 9].expand_as(det)


_PLAIN_TRIS = 2048  # triangles per step of the plain trace versions


def _moller_o(rows, o, d, shared: bool):
    """Moller terms of rays ``d`` (three (R,)) from one origin ``o``
    (three 0-d) against ``rows`` (n, 16): the raw rows, the origin
    broadcast into the full test (the JAX package's
    ``_closest_ival_drain_sh_raw``), or with ``shared`` the shared-origin
    rows of :func:`shared_rows`. det, u, v, tmul, each (R, n)."""
    if shared:
        return _moller_sh(rows, d)
    return _moller_g(rows, [c.reshape(1) for c in o], d)


def camera_wl_plain(cam, width: int, height: int, rows, tables: LeafTables,
                    words, pids: torch.Tensor, shared: bool = False):
    """Plain B2: closest hit of the primary rays of packets ``pids`` over
    the leaves set in their ``words`` (len(pids), K, Lp/32); ``rows`` the
    raw triangle rows, or with ``shared`` (B8a) the shared-origin rows of
    the camera position.

    Returns (dist, u, v, tri, dx, dy, dz), each (len(pids), PACKET_R).
    Closest is strict: a hit must be nearer than the root-box exit and
    the lowest id wins a tie (the kernel keeps the first in traversal
    order, so tri ids may differ only where distances tie)."""
    d, idir, t_exit = _camera_rays(cam, width, height, pids)
    o = cam[9:12]
    best = t_exit.clone()
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)
    btri = torch.full(best.shape, -1, dtype=torch.int64, device=best.device)
    for i in range(len(pids)):
        leaves, tri, owner = _packet_leaves(tables, words[i])
        dp = [c[i] for c in d]
        tn, tf = _leaf_slab(tables, o, [c[i] for c in idir], leaves)
        slab = (tn <= tf) & (tf > 0.0)
        for s in range(0, len(tri), _PLAIN_TRIS):
            t = tri[s:s + _PLAIN_TRIS]
            det, u, v, tmul = _moller_o(rows[t], o, dp, shared)
            duv = det - u - v
            side = ((torch.maximum(u, torch.maximum(v, duv)) <= 0.0)
                    | (torch.minimum(u, torch.minimum(v, duv)) >= 0.0))
            idet = 1.0 / torch.where(det == 0.0, 1e-30, det)
            dist = tmul * idet
            ok = (side & (det != 0.0) & (dist > 0.0)
                  & slab[:, owner[s:s + _PLAIN_TRIS]])
            dist = torch.where(ok, dist, BIG)
            m = dist.amin(1)
            is_min = ok & (dist == m[:, None])
            j = torch.where(is_min, t[None, :], 2**62).argmin(1)
            upd = m < best[i]
            best[i] = torch.where(upd, m, best[i])
            btri[i] = torch.where(upd, t[j], btri[i])
            ui = (u * idet).gather(1, j[:, None])[:, 0]
            vi = (v * idet).gather(1, j[:, None])[:, 0]
            bu[i] = torch.where(upd, ui, bu[i])
            bv[i] = torch.where(upd, vi, bv[i])
    dist = torch.where(btri >= 0, best, BIG)
    return dist, bu, bv, btri.to(torch.int32), d[0], d[1], d[2]


def _moller_g(rows, o, d):
    """Full Moller terms of rays from their own origins ``o`` along ``d``
    (three (R,) each) against raw triangle rows (n, 16) [a, ba, ca, n]:
    det, u, v, tmul, each (R, n) (the JAX package's ``_intersect4``)."""
    col = lambda j: rows[None, :, j]
    ax, ay, az = col(0), col(1), col(2)
    bax, bay, baz = col(3), col(4), col(5)
    cax, cay, caz = col(6), col(7), col(8)
    nx, ny, nz = col(9), col(10), col(11)
    dx, dy, dz = (c[:, None] for c in d)
    tvx, tvy, tvz = o[0][:, None] - ax, o[1][:, None] - ay, o[2][:, None] - az
    det = dx * nx + dy * ny + dz * nz
    tmul = -(tvx * nx + tvy * ny + tvz * nz)
    u = (dx * (tvy * caz - tvz * cay) + dy * (tvz * cax - tvx * caz)
         + dz * (tvx * cay - tvy * cax))
    v = (dx * (bay * tvz - baz * tvy) + dy * (baz * tvx - bax * tvz)
         + dz * (bax * tvy - bay * tvx))
    return det, u, v, tmul


def closest_wl_g_plain(o, d, tm, rows, tables: LeafTables, words):
    """Plain B6: closest hit of rays from their own origins over the
    leaves set in ``words``; ``o``/``d`` three and ``tm`` one (P,
    PACKET_R) planes, ``rows`` the raw triangle rows (T, 16).

    Returns (dist, u, v, tri), each (P, PACKET_R). A live ray (tmax >= 0)
    starts at min(tmax, BIG) and a hit must be strictly nearer; it
    returns BIG on a miss, a masked ray -BIG; tri is clamped at 0. The
    two-sided test and tie rule of :func:`camera_wl_plain`."""
    idir = [safe_inv(c) for c in d]
    active = tm >= 0.0
    best = torch.where(active, tm.clamp_max(BIG), -BIG)
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)
    btri = torch.full(best.shape, -1, dtype=torch.int64, device=best.device)
    for i in range(tm.shape[0]):
        # a masked ray keeps -BIG: only the packet's live rays are traced
        rays = torch.nonzero(active[i]).flatten()
        op = [c[i, rays] for c in o]
        dp = [c[i, rays] for c in d]
        leaves, _, _ = _packet_leaves(tables, words[i])
        tn, tf = _leaf_slab(tables, op, [c[i, rays] for c in idir], leaves)
        slab = (tn <= tf) & (tf > 0.0)
        # only the leaves some ray of the packet enters
        keep = slab.any(0)
        slab = slab[:, keep]
        tri, owner = _leaf_tris(tables, leaves[keep])
        pb, ptr, pu, pv = (best[i, rays], btri[i, rays], bu[i, rays],
                           bv[i, rays])
        for s in range(0, len(tri), _PLAIN_TRIS):
            t = tri[s:s + _PLAIN_TRIS]
            det, u, v, tmul = _moller_g(rows[t], op, dp)
            duv = det - u - v
            side = ((torch.maximum(u, torch.maximum(v, duv)) <= 0.0)
                    | (torch.minimum(u, torch.minimum(v, duv)) >= 0.0))
            idet = 1.0 / torch.where(det == 0.0, 1e-30, det)
            dist = tmul * idet
            ok = (side & (det != 0.0) & (dist > 0.0)
                  & slab[:, owner[s:s + _PLAIN_TRIS]])
            dist = torch.where(ok, dist, BIG)
            m = dist.amin(1)
            is_min = ok & (dist == m[:, None])
            j = torch.where(is_min, t[None, :], 2**62).argmin(1)
            upd = m < pb
            pb = torch.where(upd, m, pb)
            ptr = torch.where(upd, t[j], ptr)
            ui = (u * idet).gather(1, j[:, None])[:, 0]
            vi = (v * idet).gather(1, j[:, None])[:, 0]
            pu = torch.where(upd, ui, pu)
            pv = torch.where(upd, vi, pv)
        best[i, rays], btri[i, rays] = pb, ptr
        bu[i, rays], bv[i, rays] = pu, pv
    hit = btri >= 0
    dist = torch.where(hit, best, torch.where(active, BIG, -BIG))
    return dist, bu, bv, btri.clamp_min(0).to(torch.int32)


def shadow_wl_plain(orig, d, tm, rows, tables: LeafTables, words,
                    shared: bool = False):
    """Plain B4: any-hit of rays from ``orig`` over the leaves set in
    ``words``; ``d`` three and ``tm`` one (P, PACKET_R) planes, ``rows``
    the raw triangle rows, or with ``shared`` (B8b) the shared-origin rows
    of ``orig``. Returns blocked float32 (P, PACKET_R), 1 where an
    occluder lies in (0, tmax), with the kernel's one-sided test
    (intersect.py:80-89)."""
    idir = [safe_inv(c) for c in d]
    limit = torch.where(tm >= 0.0, tm, -BIG)
    blocked = torch.zeros_like(tm)
    for i in range(tm.shape[0]):
        leaves, tri, owner = _packet_leaves(tables, words[i])
        dp = [c[i] for c in d]
        lim = limit[i][:, None]
        tn, tf = _leaf_slab(tables, orig, [c[i] for c in idir], leaves)
        slab = (tn <= tf) & (tf > 0.0) & (tn < lim)
        occ_any = torch.zeros_like(tm[i], dtype=torch.bool)
        for s in range(0, len(tri), _PLAIN_TRIS):
            det, u, v, tmul = _moller_o(rows[tri[s:s + _PLAIN_TRIS]],
                                        orig.unbind(), dp, shared)
            occ = ((torch.minimum(u, v) >= 0.0) & (u + v <= det)
                   & (tmul > 0.0) & (tmul < lim * det)
                   & slab[:, owner[s:s + _PLAIN_TRIS]])
            occ_any |= occ.any(1)
        blocked[i] = occ_any.float()
    return blocked


def shadow_wl_g_plain(o, d, tm, rows, tables: LeafTables, words):
    """Plain B7: any-hit of rays from their own origins over the leaves
    set in ``words``; ``o``/``d`` three and ``tm`` one (P, PACKET_R)
    planes, ``rows`` the raw triangle rows. Returns blocked float32 (P,
    PACKET_R), 1 where an occluder lies in (0, tmax) by the one-sided
    test (``_shadow_ival_drain_g`` :2044-2050); a masked ray is never
    blocked."""
    idir = [safe_inv(c) for c in d]
    limit = torch.where(tm >= 0.0, tm, -BIG)
    blocked = torch.zeros_like(tm)
    for i in range(tm.shape[0]):
        # a masked ray is never blocked: only the live rays are traced
        rays = torch.nonzero(tm[i] >= 0.0).flatten()
        op = [c[i, rays] for c in o]
        dp = [c[i, rays] for c in d]
        lim = limit[i, rays][:, None]
        leaves, _, _ = _packet_leaves(tables, words[i])
        tn, tf = _leaf_slab(tables, op, [c[i, rays] for c in idir], leaves)
        slab = (tn <= tf) & (tf > 0.0) & (tn < lim)
        keep = slab.any(0)
        slab = slab[:, keep]
        tri, owner = _leaf_tris(tables, leaves[keep])
        occ_any = torch.zeros(len(rays), dtype=torch.bool, device=tm.device)
        for s in range(0, len(tri), _PLAIN_TRIS):
            det, u, v, tmul = _moller_g(rows[tri[s:s + _PLAIN_TRIS]], op, dp)
            occ = ((torch.minimum(u, v) >= 0.0) & (u + v <= det)
                   & (tmul > 0.0) & (tmul < lim * det)
                   & slab[:, owner[s:s + _PLAIN_TRIS]])
            occ_any |= occ.any(1)
        blocked[i, rays] = occ_any.float()
    return blocked


# --- The counters of B8a/B8b: a simulation of each warp's scan ---------
#
# The counts depend on the order in which a warp meets leaves (its culls
# use its current bound), so the plain versions walk every warp of a
# packet through its words as the kernels do: band, summary word, word,
# bit, with the kernels' float arithmetic. Warps are a batch dimension;
# the walk loops over the packet's populated words and kept leaves.


def _warp_cull_sim(o, d, idir, limit):
    """The kernels' warp cull (``warp_cull``) of each warp of a packet:
    ``o`` the shared origin (three 0-d; ``warp_cull<false>``) or three
    (WARPS, WARP) origins (``warp_cull<true>``), ``d``/``idir`` three and
    ``limit`` one (WARPS, WARP). Returns (om, oM, im, iM, lo, hi), three
    each: the origin bounds of the warp's live rays (``o`` itself for a
    shared origin; else (WARPS, 1)), their inverse-direction bounds and
    the padded box around their segments ((WARPS, 1))."""
    live = limit > 0.0
    om, oM, im, iM, lo, hi = [], [], [], [], [], []
    for k in range(3):
        if o[k].dim() == 0:
            om.append(o[k])
            oM.append(o[k])
        else:
            a, b = _widen(torch.where(live, o[k], BIG).amin(1, True),
                          torch.where(live, o[k], -BIG).amax(1, True))
            om.append(a)
            oM.append(b)
        a, b = _widen(torch.where(live, idir[k], BIG).amin(1, True),
                      torch.where(live, idir[k], -BIG).amax(1, True))
        end = o[k] + d[k] * limit
        l = torch.where(live, torch.minimum(o[k], end), BIG).amin(1, True)
        h = torch.where(live, torch.maximum(o[k], end), -BIG).amax(1, True)
        pad = 1e-4 * torch.maximum(l.abs(), h.abs()) + 1e-4
        im.append(a)
        iM.append(b)
        lo.append(l - pad)
        hi.append(h + pad)
    return om, oM, im, iM, lo, hi


def _warp_keeps_sim(box, ls, cull, mb):
    """(WARPS, len(ls)) bool: each warp's cull (``warp_keeps``) of the
    boxes ``ls`` of the planar ``box`` (6, n) at the warp bounds ``mb``
    (WARPS,)."""
    om, oM, im, iM, lo, hi = cull
    tn = torch.zeros((mb.shape[0], len(ls)), dtype=torch.float32,
                     device=box.device)
    tf = mb[:, None].expand_as(tn)
    for k in range(3):
        lo_min, lo_max = _corner_range(box[k, ls][None, :], om[k], oM[k],
                                       im[k], iM[k])
        hi_min, hi_max = _corner_range(box[3 + k, ls][None, :], om[k],
                                       oM[k], im[k], iM[k])
        tn = torch.maximum(tn, torch.minimum(lo_min, hi_min))
        tf = torch.minimum(tf, torch.maximum(lo_max, hi_max))
    ok = (tn <= tf) & (tf > 0.0)
    for k in range(3):
        ok &= (box[k, ls][None, :] <= hi[k]) & (box[3 + k, ls][None, :]
                                                >= lo[k])
    return ok


def _scan_sim(tables: LeafTables, words_p, floors_p, o, cull, bound_fn,
              leaf_fn, lanes_fn=None, per_warp=False):
    """One packet's counters (int64 (5,), the order of :data:`STATS`):
    every warp walks the packet's words ``words_p`` (K, Lp/32) in band
    order as ``scan_words`` does. ``bound_fn()`` gives the warps' bounds
    (WARPS,); ``leaf_fn(l, proc)`` runs leaf l for the warps in ``proc``
    and returns, per warp, whether some lane intersected, the triangles
    tested and whether the warp ends its scan (or None). With
    ``lanes_fn`` the walk is ``scan_boxes``'s: ``lanes_fn()`` gives each
    lane's inverse directions (three (WARPS, WARP)) and current limit
    (WARPS, WARP), and a warp skips the blocks and words whose box none of
    its lanes enters before its limit, and the words its cull drops. With
    ``per_warp``, returns the counters of each warp, int64 (6, WARPS),
    and in row 5 the blocks each warp enters (``scan_boxes``)."""
    words_cpu = words_p.cpu()
    dev = words_p.device
    lanes = torch.arange(WARP, device=dev)
    done = torch.zeros(WARPS, dtype=torch.bool, device=dev)
    cnt = torch.zeros((6, WARPS), dtype=torch.int64, device=dev)
    # a warp whose cull has a bound that is not finite keeps every word
    tame = torch.ones(WARPS, dtype=torch.bool, device=dev)
    for bounds in cull[:4]:
        for x in bounds:
            tame &= torch.isfinite(x).reshape(-1)

    def enters(box, c):
        # (WARPS,): some lane's slab test of box c passes before its limit
        idir, lim = lanes_fn()
        tn, pas = _box_slab(box, c, o, idir)
        wild = ~(torch.isfinite(idir[0]) & torch.isfinite(idir[1])
                 & torch.isfinite(idir[2]))
        return (wild | (pas & (tn < lim))).any(1)

    def leaf_level(b, w, active):
        # one word's leaves, for the warps in ``active``
        nonlocal done
        mb = bound_fn()
        done |= active & ~(mb > 0.0)
        active &= ~done
        cnt[0] += active
        ls = w * WARP + lanes
        bits = ((words_p[b, w] >> lanes.to(torch.int32)) & 1).bool()
        keep = (active[:, None] & bits[None, :]
                & _warp_keeps_sim(tables.box, ls, cull, mb))
        cnt[1] += keep.sum(1)
        for j in torch.nonzero(keep.any(0)).flatten().tolist():
            proc = keep[:, j] & ~done
            go, tested, fin = leaf_fn(w * WARP + j, proc)
            cnt[2] += go
            cnt[3] += tested
            if fin is not None:
                done |= proc & fin

    for b in range(words_p.shape[0]):
        bound = bound_fn()
        done |= ~(bound > 0.0)
        enter = ~done & ~(floors_p[b] >= bound)
        cnt[4] += enter
        if not bool(enter.any()):
            continue
        populated = torch.nonzero(words_cpu[b]).flatten()
        if lanes_fn is None:
            for w in populated.tolist():
                active = enter & ~done
                if not bool(active.any()):
                    break
                leaf_level(b, w, active)
            continue
        for s in torch.unique(populated // WARP).tolist():
            active = enter & ~done
            if not bool(active.any()):
                break
            active &= enters(tables.bbox, s)
            cnt[5] += active
            if not bool(active.any()):
                continue
            mb = bound_fn()
            done |= active & ~(mb > 0.0)
            active &= ~done
            ws = populated[populated // WARP == s].to(dev)
            kept = ~tame[:, None] | _warp_keeps_sim(tables.wbox, ws, cull,
                                                    mb)
            for j, w in enumerate(ws.tolist()):
                act = active & ~done & kept[:, j]
                if not bool(act.any()):
                    continue
                act &= enters(tables.wbox, w)
                if bool(act.any()):
                    leaf_level(b, w, act)
    return cnt if per_warp else cnt[:5].sum(1)


def _box_slab(box, c, o, idir):
    """Each lane's slab test of column c of the planar ``box`` (6, n)
    (``ray_slab``): entry and pass, (WARPS, WARP) each; ``o`` three 0-d
    or (WARPS, WARP), ``idir`` three (WARPS, WARP). Columns ``c`` and
    operands with a trailing axis broadcast as torch does."""
    t1 = [(box[k, c] - o[k]) * idir[k] for k in range(3)]
    t2 = [(box[3 + k, c] - o[k]) * idir[k] for k in range(3)]
    tn, tf = _slab(t1, t2)
    return tn, (tn <= tf) & (tf > 0.0)


def _leaf_rows(tables: LeafTables, rows, l):
    first, cnt = int(tables.first[l]), int(tables.count[l])
    return rows[first:first + cnt], cnt


def _stats_row(c):
    row = torch.zeros(8, dtype=torch.int32, device=c.device)
    row[:5] = c.to(torch.int32)
    return row


def camera_wl_stats_plain(cam, width: int, height: int, rows,
                          tables: LeafTables, words, floors,
                          pids: torch.Tensor):
    """Plain B8a: :func:`camera_wl_plain`'s outputs for packets ``pids``
    and their counters, int32 (len(pids), 8), from a simulation of every
    warp's scan (``words``/``floors`` those of ``pids``;
    :func:`camera_wl_sim`)."""
    out = camera_wl_plain(cam, width, height, rows, tables, words, pids,
                          shared=True)
    _, stats, _ = camera_wl_sim(cam, width, height, rows, tables, words,
                                floors, pids, shared=True)
    return (*out, stats)


def camera_wl_sim(cam, width: int, height: int, rows, tables: LeafTables,
                  words, floors, pids: torch.Tensor, shared: bool = False):
    """B2 on the raw triangle ``rows`` (with ``shared``, B8a on the
    shared-origin rows) on packets ``pids`` (``words``/``floors`` theirs),
    simulated warp by warp as the kernel scans (``scan_words``: each
    warp's cull, then its kept leaves in order, each lane testing a leaf
    it enters before its current best; a warp's rays an 8 x 4 pixel tile,
    :func:`camera_wl_order`). Returns (B2's outputs (dist, u,
    v, tri, dx, dy, dz), each (len(pids), PACKET_R), in the kernel's
    order: at a distance tie the first hit of the scan, where
    :func:`camera_wl_plain` takes the lowest id; the counters, int32
    (len(pids), 8), as :func:`camera_wl_stats` gives them; the tally of
    the leaf visits, int64 (len(TALLY), len(pids) * WARPS):
    :data:`TALLY`'s rows, ``nodes`` the words that reach the leaf level,
    an entering lane testing every row of its leaf, none blocked). The
    leaves each warp's cull keeps are the counters' ``leaves``."""
    d, idir, t_exit = _camera_rays(cam, width, height, pids)
    o = cam[9:12]
    first, count = tables.first.tolist(), tables.count.tolist()
    order = camera_wl_order().to(t_exit.device)
    lanes = lambda c: c[order].reshape(WARPS, WARP)
    outs, stats, tallies = [], [], []
    for i in range(len(pids)):
        wd = [lanes(c[i]) for c in d]
        wi = [lanes(c[i]) for c in idir]
        flat_d = [c.reshape(-1) for c in wd]
        best = lanes(t_exit[i]).clone()
        tri = torch.full_like(best, -1, dtype=torch.int64)
        bu = torch.zeros_like(best)
        bv = torch.zeros_like(best)
        cull = _warp_cull_sim(o, wd, wi, best)
        calls = []  # (go, rows) of each leaf call

        def leaf(l, proc):
            tn, pas = _box_slab(tables.box, l, o, wi)
            go = proc[:, None] & pas & (tn < best)
            cnt = count[l]
            det, u, v, tmul = _moller_o(rows[first[l]:first[l] + cnt], o,
                                        flat_d, shared)
            duv = det - u - v
            side = ((torch.maximum(u, torch.maximum(v, duv)) <= 0.0)
                    | (torch.minimum(u, torch.minimum(v, duv)) >= 0.0))
            idet = 1.0 / torch.where(det == 0.0, 1e-30, det)
            dist = tmul * idet
            ok = side & (det != 0.0) & (dist > 0.0)
            dist = torch.where(ok, dist, float("inf"))
            m = dist.amin(1)
            # the loop's first strictly nearer hit: the first row of the
            # nearest distance
            j = torch.where(ok & (dist == m[:, None]),
                            torch.arange(cnt, device=dist.device),
                            cnt).amin(1).clamp_max(max(cnt - 1, 0))
            upd = go & (m.reshape(best.shape) < best)
            pick = lambda a: a.gather(1, j[:, None])[:, 0].reshape(
                best.shape)
            best.copy_(torch.where(upd, m.reshape(best.shape), best))
            tri.copy_(torch.where(upd, first[l] + j.reshape(best.shape),
                                  tri))
            bu.copy_(torch.where(upd, pick(u * idet), bu))
            bv.copy_(torch.where(upd, pick(v * idet), bv))
            calls.append((go, cnt))
            anyg = go.any(1)
            return anyg, anyg * cnt, None

        cnt = _scan_sim(tables, words[i], floors[i], o, cull,
                        lambda: torch.clamp_min(best, 0.0).amax(1), leaf,
                        per_warp=True)
        if calls:
            go, n_rows = zip(*calls)
            go = torch.stack(go)
            n_rows = torch.tensor(n_rows, device=go.device)
            tal = _tally_visits(go, go * n_rows[:, None, None],
                                torch.zeros_like(go), n_rows)
        else:
            tal = torch.zeros((len(TALLY), WARPS), dtype=torch.int64,
                              device=best.device)
        tal[0] = cnt[0]
        # each thread's results back to its ray's slot
        slot = lambda x: torch.empty_like(x.reshape(-1)).index_copy_(
            0, order, x.reshape(-1))
        outs.append((slot(torch.where(tri >= 0, best, BIG)), slot(bu),
                     slot(bv), slot(tri.to(torch.int32))))
        stats.append(_stats_row(cnt[:5].sum(1)))
        tallies.append(tal)
    out = tuple(torch.stack(c) for c in zip(*outs))
    return ((*out, *d), torch.stack(stats), torch.cat(tallies, 1))


def shadow_wl_stats_plain(orig, d, tm, rows, tables: LeafTables, words,
                          floors):
    """Plain B8b: :func:`shadow_wl_plain`'s blocked planes and their
    counters, int32 (P, 8), from a simulation of every warp's scan."""
    blocked = shadow_wl_plain(orig, d, tm, rows, tables, words, shared=True)
    idir = [safe_inv(c) for c in d]
    limit_all = torch.where(tm >= 0.0, tm, -BIG)
    stats = []
    for i in range(tm.shape[0]):
        wd = [c[i].reshape(WARPS, WARP) for c in d]
        wi = [c[i].reshape(WARPS, WARP) for c in idir]
        limit = limit_all[i].reshape(WARPS, WARP)
        blk = torch.zeros_like(limit, dtype=torch.bool)
        cull = _warp_cull_sim(orig, wd, wi, limit)

        def leaf(l, proc):
            lim = torch.where(blk, -BIG, limit)
            tn, pas = _box_slab(tables.box, l, orig, wi)
            go = proc[:, None] & pas & (tn < lim)
            t, cnt = _leaf_rows(tables, rows, l)
            det, u, v, tmul = _moller_sh(t, [c.reshape(-1) for c in wd])
            occ = ((torch.minimum(u, v) >= 0.0) & (u + v <= det)
                   & (tmul > 0.0) & (tmul < limit.reshape(-1, 1) * det))
            hit = occ.any(1)
            # a lane stops at its first blocker
            tested = torch.where(hit, occ.int().argmax(1) + 1, cnt)
            tested = torch.where(go, tested.reshape(limit.shape), 0)
            blk.copy_(blk | (go & hit.reshape(limit.shape)))
            return go.any(1), tested.amax(1), (blk | ~(limit > 0.0)).all(1)

        stats.append(_stats_row(_scan_sim(
            tables, words[i], floors[i], orig, cull,
            lambda: torch.where(blk, 0.0, torch.clamp_min(limit, 0.0))
            .amax(1), leaf, lambda: (wi, torch.where(blk, -BIG, limit)))))
    return blocked, torch.stack(stats)


def _root_reach(tables: LeafTables, o, idir, limit):
    """B7's ``reach``: ``limit``, clipped at each ray's exit from the root
    box times 1.0001 (``box_exit``; 0 where it misses the box)."""
    root = tables.root
    tn, tf = _slab([(root[k] - o[k]) * idir[k] for k in range(3)],
                   [(root[3 + k] - o[k]) * idir[k] for k in range(3)])
    exit_ = torch.where((tn <= tf) & (tf > 0.0), tf * 1.0001, 0.0)
    return torch.minimum(limit, exit_)


def _tally_visits(go, tested, hit, cnt):
    """The tally (len(TALLY), WARPS) of a warp scan's leaves, its ``nodes``
    row 0: ``go`` (n, WARPS, WARP) the lanes entering each of its n leaf
    calls, ``tested`` the rows each tested up to its stop, ``hit``
    whether it is blocked there, ``cnt`` (n,) the leaves' rows."""
    n_in = go.sum(2)
    at = n_in > 0
    tested = torch.where(go, tested, 0)
    cnt = cnt[:, None]
    bins = torch.bucketize(n_in, torch.tensor(_BIN_EDGES, device=go.device))
    by_bin = [(at & (bins == j)).sum(0) for j in range(len(LANE_BINS))]
    return torch.stack([
        torch.zeros_like(n_in[0]), at.sum(0), n_in.sum(0),
        (at * cnt).sum(0), *by_bin, tested.sum((0, 2)),
        (n_in * cnt).sum(0), tested.amax(2).sum(0),
        (go & hit).sum((0, 2)),
        (at & (cnt > CHUNK_ROWS) & (tested > CHUNK_ROWS).any(2)).sum(0)])


def shadow_wl_g_sim(o, d, tm, rows, tables: LeafTables, words, floors):
    """B7 on the planes ``o``/``d`` (three) and ``tm`` (P, PACKET_R) over
    B5's ``words``/``floors`` of those packets, simulated warp by warp as
    the kernel scans (``scan_boxes``, each lane's limit its tmax until it
    is blocked, the warp's bound the largest ``reach``: the limit clipped
    at the root box), with its exit once every live lane is blocked.
    Returns (blocked float32 (P, PACKET_R), as :func:`shadow_wl_g_plain`
    gives it; the scan's counters per warp, int64 (6, P * WARPS): the
    rows of :data:`STATS` (``nodes``: words that reach the leaf level;
    ``quarters``: leaf visits; ``tri_blocks``: per visit the most rows a
    lane tested up to its first occluder) and the blocks each warp
    enters; the tally of its leaf visits, int64 (len(TALLY), P * WARPS),
    :data:`TALLY`'s rows with ``nodes`` the words that reach the leaf
    level). An entering lane tests a leaf's rows up to its first
    occluder, so ``tested`` counts what the any-hit needs of the rows the
    warp stages."""
    idir = [safe_inv(c) for c in d]
    limit_all = torch.where(tm >= 0.0, tm, -BIG)
    blocked = torch.zeros_like(tm)
    # the leaves' first rows and counts on the host: no sync per leaf
    first, count = tables.first.tolist(), tables.count.tolist()
    counts, tallies = [], []
    for i in range(tm.shape[0]):
        lanes = lambda c: c[i].reshape(WARPS, WARP)
        wo, wd, wi = ([lanes(c) for c in x] for x in (o, d, idir))
        flat_o, flat_d = ([c.reshape(-1) for c in x] for x in (wo, wd))
        limit = lanes(limit_all)
        reach = _root_reach(tables, wo, wi, limit)
        blk = torch.zeros_like(limit, dtype=torch.bool)
        cull = _warp_cull_sim(wo, wd, wi, reach)
        calls = []  # (go, tested, hit, rows) of each leaf call

        def leaf(l, proc):
            tn, pas = _box_slab(tables.box, l, wo, wi)
            go = proc[:, None] & pas & (tn < torch.where(blk, -BIG, limit))
            cnt = count[l]
            det, u, v, tmul = _moller_g(rows[first[l]:first[l] + cnt],
                                        flat_o, flat_d)
            occ = ((torch.minimum(u, v) >= 0.0) & (u + v <= det)
                   & (tmul > 0.0) & (tmul < limit.reshape(-1, 1) * det))
            hit = occ.any(1).reshape(limit.shape)
            # a lane stops at its first blocker
            tested = torch.where(hit, occ.int().argmax(1).reshape(
                limit.shape) + 1, cnt)
            calls.append((go, tested, hit, cnt))
            blk.copy_(blk | (go & hit))
            return (go.any(1), torch.where(go, tested, 0).amax(1),
                    (blk | ~(reach > 0.0)).all(1))

        cnt = _scan_sim(
            tables, words[i], floors[i], wo, cull,
            lambda: torch.where(blk, 0.0, torch.clamp_min(reach, 0.0))
            .amax(1), leaf, lambda: (wi, torch.where(blk, -BIG, limit)),
            per_warp=True)
        if calls:
            go, tested, hit, n_rows = zip(*calls)
            tal = _tally_visits(torch.stack(go), torch.stack(tested),
                                torch.stack(hit),
                                torch.tensor(n_rows, device=tm.device))
        else:
            tal = torch.zeros((len(TALLY), WARPS), dtype=torch.int64,
                              device=tm.device)
        tal[0] = cnt[0]
        blocked[i] = blk.reshape(-1).float()
        counts.append(cnt)
        tallies.append(tal)
    return blocked, torch.cat(counts, 1), torch.cat(tallies, 1)


# ---------------------------------------------------------------------------
# Kernel wrappers: CUDA tensors launch the kernels, CPU tensors take the
# plain versions
# ---------------------------------------------------------------------------


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launched(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


_PLANES = ("ox", "oy", "oz", "dx", "dy", "dz", "tmax")


def _check_planes(planes, p, dev):
    """Checks ray planes, each (P, PACKET_R) float32, named by the tail of
    ``_PLANES``: directions and tmax, or origins, directions and tmax."""
    for name, t in zip(_PLANES[-len(planes):], planes):
        _check(t, name, torch.float32, (p, PACKET_R), dev)


def _check_tables(tables: LeafTables, dev):
    lp = tables.lp
    _check(tables.box, "leaf box", torch.float32, (6, lp), dev)
    _check(tables.first, "leaf first", torch.int32, (lp,), dev)
    _check(tables.count, "leaf count", torch.int32, (lp,), dev)
    _check(tables.wbox, "word box", torch.float32, (6, lp // WARP), dev)
    _check(tables.bbox, "block box", torch.float32, (6, lp // LEAF_BLOCK),
           dev)


def _words_out(p, k_bands, lp, dev):
    return (torch.empty((p, k_bands, lp // 32), dtype=torch.int32,
                        device=dev),
            torch.empty((p, k_bands, lp // LEAF_BLOCK), dtype=torch.int32,
                        device=dev),
            torch.empty((p, k_bands), dtype=torch.float32, device=dev))


def _words_launch(name, k_bands, cluster, p, dev, tables, rays):
    """Launches the words pass ``name`` (B1, B3 or B5) over clusters of
    ``cluster`` blocks (None: :data:`WORDS_CLUSTER`) per packet; ``rays``:
    the tensors its rays are made from, in its entry point's order (the
    camera vector; the shared origin and planes; the planes). Returns
    (words, summ, floors)."""
    from ._build import library

    _check_tables(tables, dev)
    if tables.lp > WL_MAX_LP:
        raise ValueError(
            f"{name}: {tables.lp} leaf slots, more than the words passes "
            f"take in shared memory ({WL_MAX_LP})")
    cluster = WORDS_CLUSTER[name] if cluster is None else cluster
    if cluster not in (1, 2, 4, 8):
        raise ValueError(f"{name}: cluster of {cluster} blocks, expected "
                         "1, 2, 4 or 8")
    words, summ, floors = _words_out(p, k_bands, tables.lp, dev)
    _launched(getattr(library(), f"snail_{name}")(
        *(_ptr(t) for t in (*rays, tables.box, tables.wbox)),
        tables.lp, tables.n_leaf, k_bands, p, cluster, _ptr(words),
        _ptr(summ), _ptr(floors), _stream()), name)
    return words, summ, floors


def words_camera(cam, width: int, height: int, tables: LeafTables,
                 k_bands: int = WL_BANDS, cluster: int | None = None):
    """B1: primary leaf pass of a width x height frame (replaces
    ``_words_camera_kernel``). Returns (words, summ, floors). On the card,
    each packet runs on a cluster of ``cluster`` blocks (default
    :data:`WORDS_CLUSTER`), and leaf tables of more than
    :data:`WL_MAX_LP` slots are refused."""
    p = (width // TILE) * (height // TILE)
    if not _on_cuda(cam):
        return words_camera_plain(cam, width, height, tables, k_bands,
                                  torch.arange(p))
    _check(cam, "cam", torch.float32, (22,), cam.device)
    out = _words_launch("words_camera", k_bands, cluster, p, cam.device,
                        tables, (cam,))
    words_camera.launches += 1
    return out


def words_shared(orig, d, tm, tables: LeafTables, k_bands: int = 1,
                 cluster: int | None = None):
    """B3: leaf pass of rays from one origin (replaces
    ``_words_shared_kernel``). ``d`` three and ``tm`` one (P, PACKET_R)
    float32 planes. Returns (words, summ, floors); on the card as
    :func:`words_camera`."""
    if not _on_cuda(tm):
        return words_shared_plain(orig, d, tm, tables, k_bands)
    dev = tm.device
    p = tm.shape[0]
    _check(orig, "origin", torch.float32, (3,), dev)
    _check_planes((*d, tm), p, dev)
    out = _words_launch("words_shared", k_bands, cluster, p, dev, tables,
                        (orig, *d, tm))
    words_shared.launches += 1
    return out


def _check_words(words, summ, floors, p, lp, dev):
    k = words.shape[1]
    _check(words, "words", torch.int32, (p, k, lp // 32), dev)
    _check(summ, "summ", torch.int32, (p, k, lp // LEAF_BLOCK), dev)
    _check(floors, "floors", torch.float32, (p, k), dev)


def _camera_wl_launch(cam, width, height, rows, tables, words, summ,
                      floors, stats):
    from ._build import library

    p = (width // TILE) * (height // TILE)
    dev = cam.device
    _check(cam, "cam", torch.float32, (22,), dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_tables(tables, dev)
    _check_words(words, summ, floors, p, tables.lp, dev)
    f32 = [torch.empty((p, PACKET_R), dtype=torch.float32, device=dev)
           for _ in range(6)]
    tri = torch.empty((p, PACKET_R), dtype=torch.int32, device=dev)
    dist, u, v, dx, dy, dz = f32
    _launched(library().snail_camera_wl(
        _ptr(cam), _ptr(rows), _ptr(tables.box), _ptr(tables.first),
        _ptr(tables.count), tables.lp, _ptr(words), _ptr(summ),
        _ptr(floors), words.shape[1], p, _ptr(dist), _ptr(u), _ptr(v),
        _ptr(tri), _ptr(dx), _ptr(dy), _ptr(dz),
        None if stats is None else _ptr(stats), _stream()), "camera_wl")
    return dist, u, v, tri, dx, dy, dz


def camera_wl(cam, width: int, height: int, rows, tables: LeafTables,
              words, summ, floors):
    """B2: closest hit of the primary rays over B1's words on the raw
    triangle ``rows`` (replaces ``_camera_wl_kernel`` with ``raw=True``).
    Returns (dist, u, v, tri, dx, dy, dz), each (P, PACKET_R); a miss has
    dist BIG and tri -1."""
    if not _on_cuda(cam):
        p = (width // TILE) * (height // TILE)
        return camera_wl_plain(cam, width, height, rows, tables, words,
                               torch.arange(p))
    out = _camera_wl_launch(cam, width, height, rows, tables, words, summ,
                            floors, None)
    camera_wl.launches += 1
    return out


def camera_wl_stats(cam, width: int, height: int, rows, tables: LeafTables,
                    words, summ, floors):
    """B8a: :func:`camera_wl` with counters (replaces
    ``_camera_wl_kernel_stats``). Returns B2's outputs, bit for bit, and
    int32 (P, 8): per packet, summed over its 128 warps, the slots of
    :data:`STATS` — populated words a warp tests against its cull, leaves
    it keeps, (leaf, warp) pairs in which some lane intersects, triangles
    tested per warp over those pairs, bands entered; slots 5-7 are 0.
    ``rows``: the shared-origin rows of the camera position
    (:func:`shared_rows`), as the JAX package's counter frame takes them
    (:3665)."""
    if not _on_cuda(cam):
        p = (width // TILE) * (height // TILE)
        return camera_wl_stats_plain(cam, width, height, rows, tables, words,
                                     floors, torch.arange(p))
    p = (width // TILE) * (height // TILE)
    stats = torch.zeros((p, 8), dtype=torch.int32, device=cam.device)
    out = _camera_wl_launch(cam, width, height, rows, tables, words, summ,
                            floors, stats)
    camera_wl_stats.launches += 1
    return (*out, stats)


def _shadow_wl_launch(orig, d, tm, rows, tables, words, summ, floors,
                      stats):
    from ._build import library

    dev = tm.device
    p = tm.shape[0]
    _check(orig, "origin", torch.float32, (3,), dev)
    _check_planes((*d, tm), p, dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_tables(tables, dev)
    _check_words(words, summ, floors, p, tables.lp, dev)
    blocked = torch.empty((p, PACKET_R), dtype=torch.float32, device=dev)
    _launched(library().snail_shadow_wl(
        _ptr(orig), _ptr(d[0]), _ptr(d[1]), _ptr(d[2]), _ptr(tm),
        _ptr(rows), _ptr(tables.box), _ptr(tables.wbox), _ptr(tables.bbox),
        _ptr(tables.first), _ptr(tables.count), tables.lp, _ptr(words),
        _ptr(summ), _ptr(floors), words.shape[1], p, _ptr(blocked),
        None if stats is None else _ptr(stats), _stream()), "shadow_wl")
    return blocked


def shadow_wl(orig, d, tm, rows, tables: LeafTables, words, summ, floors):
    """B4: any-hit from a shared origin over B3's words on the raw
    triangle ``rows`` (replaces ``_shadow_wl_kernel`` with ``raw=True``).
    Returns blocked float32 (P, PACKET_R)."""
    if not _on_cuda(tm):
        return shadow_wl_plain(orig, d, tm, rows, tables, words)
    out = _shadow_wl_launch(orig, d, tm, rows, tables, words, summ, floors,
                            None)
    shadow_wl.launches += 1
    return out


def shadow_wl_stats(orig, d, tm, rows, tables: LeafTables, words, summ,
                    floors):
    """B8b: :func:`shadow_wl` with counters (replaces
    ``_shadow_wl_kernel_stats``). Returns B4's blocked planes, bit for
    bit, and the counters of :func:`camera_wl_stats`, int32 (P, 8);
    ``nodes`` and ``leaves`` count the words left after B4's block and
    word skips, and ``tri_blocks`` counts, per (leaf, warp) pair, the
    most triangles a lane tested before its first blocker. ``rows``: the
    shared-origin rows of ``orig``, as :func:`camera_wl_stats`'s."""
    if not _on_cuda(tm):
        return shadow_wl_stats_plain(orig, d, tm, rows, tables, words,
                                     floors)
    stats = torch.zeros((tm.shape[0], 8), dtype=torch.int32,
                        device=tm.device)
    out = _shadow_wl_launch(orig, d, tm, rows, tables, words, summ, floors,
                            stats)
    shadow_wl_stats.launches += 1
    return out, stats


def words_general(o, d, tm, tables: LeafTables, k_bands: int = WL_BANDS,
                  cluster: int | None = None):
    """B5: leaf pass of rays with their own origins (replaces
    ``_words_general_kernel``). ``o`` and ``d`` three and ``tm`` one (P,
    PACKET_R) float32 planes, masked rays substituted. Returns (words,
    summ, floors); on the card as :func:`words_camera`."""
    if not _on_cuda(tm):
        return words_general_plain(o, d, tm, tables, k_bands)
    dev = tm.device
    p = tm.shape[0]
    _check_planes((*o, *d, tm), p, dev)
    out = _words_launch("words_general", k_bands, cluster, p, dev, tables,
                        (*o, *d, tm))
    words_general.launches += 1
    return out


def closest_wl_g(o, d, tm, rows, tables: LeafTables, words, summ, floors):
    """B6: closest hit of rays from their own origins over B5's words
    (replaces ``_closest_wl_kernel_g``); ``rows`` the raw triangle rows.
    Returns (dist, u, v, tri), each (P, PACKET_R): a miss has dist BIG, a
    masked ray -BIG, and tri is clamped at 0."""
    if not _on_cuda(tm):
        return closest_wl_g_plain(o, d, tm, rows, tables, words)
    from ._build import library

    dev = tm.device
    p = tm.shape[0]
    _check_planes((*o, *d, tm), p, dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_tables(tables, dev)
    _check_words(words, summ, floors, p, tables.lp, dev)
    dist, u, v = (torch.empty((p, PACKET_R), dtype=torch.float32,
                              device=dev) for _ in range(3))
    tri = torch.empty((p, PACKET_R), dtype=torch.int32, device=dev)
    lib = library()
    _launched(lib.snail_closest_wl_g(
        *(_ptr(t) for t in (*o, *d, tm)), _ptr(rows), _ptr(tables.box),
        _ptr(tables.wbox), _ptr(tables.bbox), _ptr(tables.root),
        _ptr(tables.first), _ptr(tables.count), tables.lp,
        _ptr(words), _ptr(summ), _ptr(floors), words.shape[1], p, _ptr(dist),
        _ptr(u), _ptr(v), _ptr(tri), _stream()), "closest_wl_g")
    closest_wl_g.launches += 1
    return dist, u, v, tri


def shadow_wl_g(o, d, tm, rows, tables: LeafTables, words, summ, floors):
    """B7: any-hit of rays from their own origins over B5's words
    (replaces ``_shadow_wl_kernel_g``); ``rows`` the raw triangle rows.
    Returns blocked float32 (P, PACKET_R); a masked ray is never
    blocked."""
    if not _on_cuda(tm):
        return shadow_wl_g_plain(o, d, tm, rows, tables, words)
    from ._build import library

    dev = tm.device
    p = tm.shape[0]
    _check_planes((*o, *d, tm), p, dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_tables(tables, dev)
    _check_words(words, summ, floors, p, tables.lp, dev)
    blocked = torch.empty((p, PACKET_R), dtype=torch.float32, device=dev)
    _launched(library().snail_shadow_wl_g(
        *(_ptr(t) for t in (*o, *d, tm)), _ptr(rows), _ptr(tables.box),
        _ptr(tables.wbox), _ptr(tables.bbox), _ptr(tables.root),
        _ptr(tables.first), _ptr(tables.count), tables.lp, _ptr(words),
        _ptr(summ), _ptr(floors), words.shape[1], p, _ptr(blocked),
        _stream()), "shadow_wl_g")
    shadow_wl_g.launches += 1
    return blocked


# --- Walk kernels (csrc/walk.cu): B9a-d, with no node cap, so that they
# also compute what the paged B10a-d compute. Plain versions in
# .traverse_ref. ---------------------------------------------------------


def _check_nodes(nodes: NodeTables, dev):
    _check(nodes.node, "nodes", torch.float32, (nodes.n_nodes, 8), dev)


def _walk_camera_launch(cam, width, height, rows, nodes, stats):
    from ._build import library

    p = (width // TILE) * (height // TILE)
    dev = cam.device
    _check(cam, "cam", torch.float32, (22,), dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_nodes(nodes, dev)
    if nodes.leaf_max > IVAL_LEAF:
        raise ValueError(f"leaf of {nodes.leaf_max} triangles > IVAL_LEAF "
                         f"({IVAL_LEAF}): walk_camera stages leaves of up "
                         f"to {IVAL_LEAF}; use fat_camera")
    dist, u, v, dx, dy, dz = (torch.empty((p, PACKET_R), dtype=torch.float32,
                                          device=dev) for _ in range(6))
    tri = torch.empty((p, PACKET_R), dtype=torch.int32, device=dev)
    _launched(library().snail_walk_camera(
        _ptr(cam), _ptr(rows), _ptr(nodes.node), nodes.n_nodes,
        nodes.stack_cap, nodes.leaf_max, p, _ptr(dist), _ptr(u), _ptr(v),
        _ptr(tri), _ptr(dx), _ptr(dy), _ptr(dz),
        None if stats is None else _ptr(stats), _stream()), "walk_camera")
    return dist, u, v, tri, dx, dy, dz


def walk_camera(cam, width: int, height: int, rows, nodes: NodeTables):
    """B9a: raygen + closest hit of a width x height frame of primary rays
    through the node tree on the raw triangle ``rows``, tested with the
    full Moller test from the camera's position (replaces
    ``_camera_ival_kernel`` and the paged ``_camera_ival_kernel_paged``).
    Returns B2's outputs: (dist, u, v, tri, dx, dy, dz), each (P,
    PACKET_R); a miss has dist BIG and tri -1. Its warps take B2's 8 x 4
    pixel tiles (:func:`camera_wl_order`), each with its own near-child
    signs. The kernel stages leaves of up to IVAL_LEAF rows; a tree with
    larger ones is the fat-leaf kernels' (:func:`fat_camera`)."""
    if not _on_cuda(cam):
        from .traverse_ref import walk_camera_plain

        p = (width // TILE) * (height // TILE)
        return walk_camera_plain(cam, width, height, rows, nodes,
                                 torch.arange(p))
    out = _walk_camera_launch(cam, width, height, rows, nodes, None)
    walk_camera.launches += 1
    return out


def walk_camera_stats(cam, width: int, height: int, rows,
                      nodes: NodeTables):
    """B9e: :func:`walk_camera` with counters (replaces
    ``_camera_ival_kernel_stats``). Returns B9a's outputs, bit for bit,
    and int32 (P, 8): per packet, summed over its 128 warps, the slots of
    :data:`STATS` — node rows a warp loads, leaf rows among them, leaves
    some lane enters, triangles tested per warp in those, stack pops;
    slots 5-7 are 0 (csrc/walk.cuh ``WalkCounts``)."""
    p = (width // TILE) * (height // TILE)
    if not _on_cuda(cam):
        from .traverse_ref import walk_camera_stats_plain

        return walk_camera_stats_plain(cam, width, height, rows, nodes,
                                       torch.arange(p))
    stats = torch.zeros((p, 8), dtype=torch.int32, device=cam.device)
    out = _walk_camera_launch(cam, width, height, rows, nodes, stats)
    walk_camera_stats.launches += 1
    return (*out, stats)


def _walk_shadow_launch(orig, d, tm, rows, nodes, stats):
    from ._build import library

    dev = tm.device
    p = tm.shape[0]
    _check(orig, "origin", torch.float32, (3,), dev)
    _check_planes((*d, tm), p, dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_nodes(nodes, dev)
    if nodes.leaf_max > IVAL_LEAF:
        raise ValueError(f"leaf of {nodes.leaf_max} triangles > IVAL_LEAF "
                         f"({IVAL_LEAF}): walk_shadow stages leaves of up "
                         f"to {IVAL_LEAF}; use fat_shadow")
    blocked = torch.empty((p, PACKET_R), dtype=torch.float32, device=dev)
    _launched(library().snail_walk_shadow(
        _ptr(orig), *(_ptr(t) for t in (*d, tm)), _ptr(rows),
        _ptr(nodes.node), nodes.n_nodes, nodes.stack_cap, nodes.leaf_max, p,
        _ptr(blocked), None if stats is None else _ptr(stats), _stream()),
        "walk_shadow")
    return blocked


def walk_shadow(orig, d, tm, rows, nodes: NodeTables):
    """B9b: any-hit from the shared origin ``orig`` through the node tree
    on the raw triangle ``rows``, tested with the full Moller test from
    ``orig`` (replaces ``_shadow_ival_kernel`` and
    ``_shadow_ival_kernel_paged``); ``d`` three and ``tm`` one (P,
    PACKET_R) planes. Returns blocked float32 (P, PACKET_R). The kernel
    stages leaves of up to IVAL_LEAF rows; a tree with larger ones is the
    fat-leaf kernels' (:func:`fat_shadow`)."""
    if not _on_cuda(tm):
        from .traverse_ref import walk_shadow_plain

        return walk_shadow_plain(orig, d, tm, rows, nodes)
    out = _walk_shadow_launch(orig, d, tm, rows, nodes, None)
    walk_shadow.launches += 1
    return out


def walk_shadow_stats(orig, d, tm, rows, nodes: NodeTables):
    """B9f: :func:`walk_shadow` with counters (replaces
    ``_shadow_ival_kernel_stats``). Returns B9b's blocked planes, bit for
    bit, and the counters of :func:`walk_camera_stats`, int32 (P, 8);
    ``tri_blocks`` counts, per (leaf, warp) pair, the most triangles a
    lane tested before its first blocker."""
    if not _on_cuda(tm):
        from .traverse_ref import walk_shadow_stats_plain

        return walk_shadow_stats_plain(orig, d, tm, rows, nodes)
    stats = torch.zeros((tm.shape[0], 8), dtype=torch.int32,
                        device=tm.device)
    out = _walk_shadow_launch(orig, d, tm, rows, nodes, stats)
    walk_shadow_stats.launches += 1
    return out, stats


def walk_closest_g(o, d, tm, rows, nodes: NodeTables):
    """B9c: closest hit of rays with their own origins through the node
    tree on the raw ``rows`` (replaces ``_closest_ival_kernel_g`` and
    ``_closest_ival_kernel_g_paged``); ``o``/``d`` three and ``tm`` one
    (P, PACKET_R) planes, masked rays substituted. Returns B6's outputs
    (dist, u, v, tri): a miss has dist BIG, a masked ray -BIG, tri is
    clamped at 0. The kernel stages leaves of up to IVAL_LEAF rows; a
    tree with larger ones is the fat-leaf kernels' (:func:`fat_closest`)."""
    if not _on_cuda(tm):
        from .traverse_ref import walk_closest_g_plain

        return walk_closest_g_plain(o, d, tm, rows, nodes)
    from ._build import library

    dev = tm.device
    p = tm.shape[0]
    _check_planes((*o, *d, tm), p, dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_nodes(nodes, dev)
    if nodes.leaf_max > IVAL_LEAF:
        raise ValueError(f"leaf of {nodes.leaf_max} triangles > IVAL_LEAF "
                         f"({IVAL_LEAF}): walk_closest_g stages leaves of "
                         f"up to {IVAL_LEAF}; use fat_closest")
    dist, u, v = (torch.empty((p, PACKET_R), dtype=torch.float32,
                              device=dev) for _ in range(3))
    tri = torch.empty((p, PACKET_R), dtype=torch.int32, device=dev)
    _launched(library().snail_walk_closest_g(
        *(_ptr(t) for t in (*o, *d, tm)), _ptr(rows), _ptr(nodes.node),
        nodes.n_nodes, nodes.stack_cap, nodes.leaf_max, p, _ptr(dist),
        _ptr(u), _ptr(v), _ptr(tri), _stream()), "walk_closest_g")
    walk_closest_g.launches += 1
    return dist, u, v, tri


def walk_shadow_g(o, d, tm, rows, nodes: NodeTables):
    """B9d: any-hit of rays with their own origins through the node tree
    on the raw ``rows`` (replaces ``_shadow_ival_kernel_g`` and
    ``_shadow_ival_kernel_g_paged``). Returns blocked float32 (P,
    PACKET_R); a masked ray is never blocked. The kernel stages leaves of
    up to IVAL_LEAF rows; a tree with larger ones is the fat-leaf
    kernels' (:func:`fat_shadow_g`)."""
    if not _on_cuda(tm):
        from .traverse_ref import walk_shadow_g_plain

        return walk_shadow_g_plain(o, d, tm, rows, nodes)
    from ._build import library

    dev = tm.device
    p = tm.shape[0]
    _check_planes((*o, *d, tm), p, dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_nodes(nodes, dev)
    if nodes.leaf_max > IVAL_LEAF:
        raise ValueError(f"leaf of {nodes.leaf_max} triangles > IVAL_LEAF "
                         f"({IVAL_LEAF}): walk_shadow_g stages leaves of "
                         f"up to {IVAL_LEAF}; use fat_shadow_g")
    blocked = torch.empty((p, PACKET_R), dtype=torch.float32, device=dev)
    _launched(library().snail_walk_shadow_g(
        *(_ptr(t) for t in (*o, *d, tm)), _ptr(rows), _ptr(nodes.node),
        nodes.n_nodes, nodes.stack_cap, nodes.leaf_max, p, _ptr(blocked),
        _stream()), "walk_shadow_g")
    walk_shadow_g.launches += 1
    return blocked


# --- Fat-leaf kernels (csrc/fat.cu): B11a-d, the warp walk of the walk
# kernels over leaves of up to LEAF_PAD triangles, with the near child by
# the signs of each packet's ray 0 and the raw triangle rows. Plain
# versions in .traverse_ref. ---------------------------------------------


def camera_signs(camera, width: int, height: int) -> torch.Tensor:
    """int32 (P, 3): the near-child signs of each packet of a width x
    height frame of primary rays, from its ray 0, the tile's pixel (tx *
    TILE, ty * TILE), as ``camera_trace`` :3628-3638 computes it: 1 where
    that ray's (unnormalized) direction is negative."""
    tiles_x = width // TILE
    pid = torch.arange(tiles_x * (height // TILE), device=camera.pos.device)
    tx, ty = (pid % tiles_x).float(), (pid // tiles_x).float()
    x0 = (tx * TILE + 0.5 - width * 0.5) / height
    y0 = (height * 0.5 - ty * TILE - 0.5) / height
    d0 = (camera.right[None] * x0[:, None] + camera.up[None] * y0[:, None]
          + (camera.front * camera.plane_dist)[None])
    return (d0 < 0.0).to(torch.int32).contiguous()


def packet_signs(d) -> torch.Tensor:
    """int32 (P, 3): the near-child signs of each packet of the direction
    planes ``d`` (three (P, PACKET_R)), from its ray 0 (``_signs_of``
    :3517): 1 where that ray's direction is negative."""
    return torch.stack([c[:, 0] < 0.0 for c in d], 1).to(
        torch.int32).contiguous()


def fat_camera(cam, width: int, height: int, signs, rows, nodes: NodeTables):
    """B11a: raygen + closest hit of a width x height frame of primary rays
    through a fat-leaf node tree on the raw triangle ``rows`` (replaces
    ``_camera_kernel``), near children by ``signs`` (:func:`camera_signs`).
    Returns (dist, u, v, tri, dx, dy, dz), each (P, PACKET_R): every ray
    starts at BIG with no root-box clip, and a miss has dist BIG, tri 0.
    Its warps take B2's 8 x 4 pixel tiles; with the packets' signs, a
    ray's result does not depend on its warp."""
    p = (width // TILE) * (height // TILE)
    if not _on_cuda(cam):
        from .traverse_ref import fat_camera_plain

        return fat_camera_plain(cam, width, height, signs, rows, nodes,
                                torch.arange(p))
    from ._build import library

    dev = cam.device
    _check(cam, "cam", torch.float32, (22,), dev)
    _check(signs, "signs", torch.int32, (p, 3), dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_nodes(nodes, dev)
    dist, u, v, dx, dy, dz = (torch.empty((p, PACKET_R), dtype=torch.float32,
                                          device=dev) for _ in range(6))
    tri = torch.empty((p, PACKET_R), dtype=torch.int32, device=dev)
    _launched(library().snail_fat_camera(
        _ptr(cam), _ptr(signs), _ptr(rows), _ptr(nodes.node), nodes.n_nodes,
        nodes.stack_cap, nodes.leaf_max, p, _ptr(dist), _ptr(u), _ptr(v),
        _ptr(tri), _ptr(dx), _ptr(dy), _ptr(dz), _stream()), "fat_camera")
    fat_camera.launches += 1
    return dist, u, v, tri, dx, dy, dz


def fat_closest(o, d, tm, signs, rows, nodes: NodeTables):
    """B11b: closest hit of rays with their own origins through a fat-leaf
    node tree on the raw ``rows`` (replaces ``_closest_kernel``); ``o``/``d``
    three and ``tm`` one (P, PACKET_R) planes as the caller gave them,
    masked rays not substituted, near children by ``signs``
    (:func:`packet_signs` of ``d``). Returns (dist, u, v, tri): each ray's
    best, which starts at min(tmax, BIG), or -BIG when masked — so a live
    miss returns min(tmax, BIG), not BIG (ROADMAP C13) — and tri 0 where
    nothing was hit."""
    if not _on_cuda(tm):
        from .traverse_ref import fat_closest_plain

        return fat_closest_plain(o, d, tm, signs, rows, nodes)
    from ._build import library

    dev = tm.device
    p = tm.shape[0]
    _check_planes((*o, *d, tm), p, dev)
    _check(signs, "signs", torch.int32, (p, 3), dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_nodes(nodes, dev)
    dist, u, v = (torch.empty((p, PACKET_R), dtype=torch.float32,
                              device=dev) for _ in range(3))
    tri = torch.empty((p, PACKET_R), dtype=torch.int32, device=dev)
    _launched(library().snail_fat_closest(
        *(_ptr(t) for t in (*o, *d, tm)), _ptr(signs), _ptr(rows),
        _ptr(nodes.node), nodes.n_nodes, nodes.stack_cap, nodes.leaf_max, p,
        _ptr(dist), _ptr(u), _ptr(v), _ptr(tri), _stream()), "fat_closest")
    fat_closest.launches += 1
    return dist, u, v, tri


def fat_shadow(orig, d, tm, signs, rows, nodes: NodeTables):
    """B11c: any-hit from the shared origin ``orig`` through a fat-leaf
    node tree on the raw ``rows`` (replaces ``_shadow_kernel``); ``d``
    three and ``tm`` one (P, PACKET_R) planes, near children by ``signs``.
    Returns blocked float32 (P, PACKET_R); a masked ray is never
    blocked."""
    if not _on_cuda(tm):
        from .traverse_ref import fat_shadow_plain

        return fat_shadow_plain(orig, d, tm, signs, rows, nodes)
    from ._build import library

    dev = tm.device
    p = tm.shape[0]
    _check(orig, "origin", torch.float32, (3,), dev)
    _check_planes((*d, tm), p, dev)
    _check(signs, "signs", torch.int32, (p, 3), dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_nodes(nodes, dev)
    blocked = torch.empty((p, PACKET_R), dtype=torch.float32, device=dev)
    _launched(library().snail_fat_shadow(
        _ptr(orig), *(_ptr(t) for t in (*d, tm)), _ptr(signs), _ptr(rows),
        _ptr(nodes.node), nodes.n_nodes, nodes.stack_cap, nodes.leaf_max, p,
        _ptr(blocked), _stream()), "fat_shadow")
    fat_shadow.launches += 1
    return blocked


def fat_shadow_g(o, d, tm, signs, rows, nodes: NodeTables):
    """B11d: any-hit of rays with their own origins through a fat-leaf
    node tree on the raw ``rows`` (replaces ``_shadow_kernel_g``); planes
    as the caller gave them, near children by ``signs``. Returns blocked
    float32 (P, PACKET_R); a masked ray is never blocked."""
    if not _on_cuda(tm):
        from .traverse_ref import fat_shadow_g_plain

        return fat_shadow_g_plain(o, d, tm, signs, rows, nodes)
    from ._build import library

    dev = tm.device
    p = tm.shape[0]
    _check_planes((*o, *d, tm), p, dev)
    _check(signs, "signs", torch.int32, (p, 3), dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_nodes(nodes, dev)
    blocked = torch.empty((p, PACKET_R), dtype=torch.float32, device=dev)
    _launched(library().snail_fat_shadow_g(
        *(_ptr(t) for t in (*o, *d, tm)), _ptr(signs), _ptr(rows),
        _ptr(nodes.node), nodes.n_nodes, nodes.stack_cap, nodes.leaf_max, p,
        _ptr(blocked), _stream()), "fat_shadow_g")
    fat_shadow_g.launches += 1
    return blocked


# every kernel's wrapper, each counting its launches; the volume march
# (V1, ops/march.py) and the hit-row gather (ops/gather.py) too, so one
# reset and one read cover them all
from .gather import surface_rows  # noqa: E402
from .march import march  # noqa: E402

KERNELS = (words_camera, camera_wl, words_shared, shadow_wl, words_general,
           closest_wl_g, shadow_wl_g, camera_wl_stats, shadow_wl_stats,
           walk_camera, walk_shadow, walk_closest_g, walk_shadow_g,
           walk_camera_stats, walk_shadow_stats, fat_camera, fat_closest,
           fat_shadow, fat_shadow_g, march, surface_rows)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def _count_rays(tmax: torch.Tensor) -> None:
    """A wavefront's counters while tracing is on: its rays as handed to
    the kernels (``rays.traced``) and its live ones (``rays.live``: tmax
    >= 0; a primary wavefront passes its dist, so every ray)."""
    if trace.active():
        trace.count("rays.traced", tmax.numel())
        trace.count("rays.live", (tmax >= 0.0).sum())


# ---------------------------------------------------------------------------
# Wavefront entry points
# ---------------------------------------------------------------------------


def walks(scene) -> bool:
    """Whether ``scene`` is traced through its node tree (by the walk or
    the fat-leaf kernels): it has node tables and no leaf tables (the JAX
    package's ``_wl_available`` the other way round)."""
    if getattr(scene, "leaves", None) is not None:
        return False
    if getattr(scene, "nodes", None) is not None:
        return True
    raise ValueError("the scene has neither leaf nor node tables")


def is_fat(scene) -> bool:
    """Whether ``scene`` is traced by the fat-leaf kernels B11a-d: node
    tables whose leaves hold more than IVAL_LEAF triangles (the JAX
    package's flat scenes with ``leaf_max > IVAL_LEAF``)."""
    return walks(scene) and scene.nodes.leaf_max > IVAL_LEAF


def _no_fat_counters(scene):
    if is_fat(scene):
        raise ValueError(
            f"the counter frame needs leaves of at most IVAL_LEAF "
            f"({IVAL_LEAF}) triangles; this scene's hold up to "
            f"{scene.nodes.leaf_max} (the JAX package asserts the same, "
            f"camera_trace_stats :3655)")


def _camera_vec(scene, camera, width: int, height: int):
    """The primary kernels' camera scalars."""
    if width % TILE or height % TILE:
        raise ValueError(f"frame {width}x{height} is not a multiple of "
                         f"the {TILE}-pixel tile")
    return cam_vec(camera, width, height, scene.root_lo, scene.root_hi)


def _camera_words(scene, camera, width: int, height: int):
    """B1 for a full frame of primary rays: (cam, words, summ, floors)
    for B2/B8a."""
    cam = _camera_vec(scene, camera, width, height)
    words, summ, floors = words_camera(cam, width, height, scene.leaves,
                                       WL_BANDS)
    return cam, words, summ, floors


def camera_trace(scene, camera, width: int, height: int):
    """Fused raygen + closest hit for a full frame of primary rays: B1 +
    B2 on a scene with leaf tables, B9a on one with node tables, B11a on
    one with fat-leaf node tables.

    Returns flat (R,) tensors dist, u, v, tri, dx, dy, dz in packet order
    (see :func:`kernel_ray_index`). Requires width and height to be
    multiples of TILE. A miss has dist BIG, and tri -1 (tri 0 from
    B11a)."""
    with trace.span("snail.camera"):
        if is_fat(scene):
            cam = _camera_vec(scene, camera, width, height)
            out = fat_camera(cam, width, height,
                             camera_signs(camera, width, height),
                             scene.tri_rows, scene.nodes)
        elif walks(scene):
            cam = _camera_vec(scene, camera, width, height)
            out = walk_camera(cam, width, height, scene.tri_rows,
                              scene.nodes)
        else:
            cam, words, summ, floors = _camera_words(scene, camera, width,
                                                     height)
            out = camera_wl(cam, width, height, scene.tri_rows,
                            scene.leaves, words, summ, floors)
        _count_rays(out[0])
        return tuple(a.reshape(-1) for a in out)


def camera_trace_stats(scene, camera, width: int, height: int):
    """:func:`camera_trace` through B8a, or B9e on a scene with node
    tables: its outputs, bit for bit, and the per-packet counters int32
    (P, 8) (see :func:`camera_wl_stats`, :func:`walk_camera_stats`). A
    fat-leaf scene raises ValueError, as the JAX package asserts. B8a
    takes shared-origin rows, as the JAX package's ``camera_trace_stats``
    (:3665); B9e the raw rows, as B9a."""
    _no_fat_counters(scene)
    with trace.span("snail.camera"):
        if walks(scene):
            cam = _camera_vec(scene, camera, width, height)
            *out, stats = walk_camera_stats(cam, width, height,
                                            scene.tri_rows, scene.nodes)
        else:
            cam, words, summ, floors = _camera_words(scene, camera, width,
                                                     height)
            *out, stats = camera_wl_stats(
                cam, width, height, shared_rows(scene.tri_rows, camera.pos),
                scene.leaves, words, summ, floors)
        _count_rays(out[0])
        return (*(a.reshape(-1) for a in out), stats)


def substitute_masked(comps, tm, unit_fallback: bool = False):
    """Masked rays' (tmax < 0) components -> their packet's mean over its
    live rays, a point inside the packet's own interval, so garbage (miss
    points at BIG) cannot blow the interval bounds open; masked rays'
    hits are discarded by tmax < 0 regardless. ``unit_fallback``: a fully
    masked packet's mean direction gets z = 1, so its inverse stays
    finite. ``comps`` flat (R,) each, R a multiple of PACKET_R."""
    mask = tm >= 0.0
    nlive = mask.reshape(-1, PACKET_R).sum(1).clamp_min(1)
    means = [torch.repeat_interleave(
        torch.where(mask, c, 0.0).reshape(-1, PACKET_R).sum(1) / nlive,
        PACKET_R) for c in comps]
    if unit_fallback:
        mlen = means[0] * means[0] + means[1] * means[1] + means[2] * means[2]
        means[2] = torch.where(mlen < 1e-12, 1.0, means[2])
    return tuple(torch.where(mask, c, m) for c, m in zip(comps, means))


def _pk(a):
    return a.reshape(-1, PACKET_R)


def padded_planes(o3, d3, tmax):
    """A wavefront of rays with their own origins padded to whole packets
    (origins 0, directions 1, tmax -BIG) and cut into (P, PACKET_R)
    planes, masked rays as given: as the fat-leaf kernels take it.
    ``o3``/``d3`` three flat (R,) components, ``tmax`` (R,) (negative =
    masked). Returns (o, d, tm, R)."""
    o = [pad_flat(c)[0] for c in o3]
    d = [pad_flat(c, 1.0)[0] for c in d3]
    tm, n = pad_flat(tmax, -BIG)
    return tuple(map(_pk, o)), tuple(map(_pk, d)), _pk(tm), n


def general_planes(o3, d3, tmax):
    """A wavefront of rays with their own origins as the B5/B6 and B9c/B9d
    kernels take it: :func:`padded_planes` with the masked rays
    substituted. Returns (o, d, tm, R)."""
    o, d, tm, n = padded_planes(o3, d3, tmax)
    flat = tm.reshape(-1)
    o = substitute_masked([c.reshape(-1) for c in o], flat)
    d = substitute_masked([c.reshape(-1) for c in d], flat,
                          unit_fallback=True)
    return tuple(map(_pk, o)), tuple(map(_pk, d)), tm, n


def closest_hit_c(scene, o3, d3, tmax):
    """Closest hit of a wavefront of rays with their own origins (bounce
    rays), B5 + B6, B9c or B11b: ``o3``/``d3`` three flat (R,) components,
    ``tmax`` (R,), a negative tmax masks the ray. Masked rays are
    substituted first (``closest_hit_c`` :3820-3823, :3835-3837), except
    for B11b, which takes them as they are (:3857). Returns flat (R,)
    dist, u, v, tri: a masked ray has dist -BIG, tri is clamped at 0, and
    a miss has dist BIG, or min(tmax, BIG) from B11b (ROADMAP C13)."""
    with trace.span("snail.closest"):
        if is_fat(scene):
            o, d, tm, n = padded_planes(o3, d3, tmax)
            _count_rays(tm)
            out = fat_closest(o, d, tm, packet_signs(d), scene.tri_rows,
                              scene.nodes)
            return tuple(a.reshape(-1)[:n] for a in out)
        o, d, tm, n = general_planes(o3, d3, tmax)
        _count_rays(tm)
        if walks(scene):
            out = walk_closest_g(o, d, tm, scene.tri_rows, scene.nodes)
        else:
            words, summ, floors = words_general(o, d, tm, scene.leaves,
                                                WL_BANDS)
            out = closest_wl_g(o, d, tm, scene.tri_rows, scene.leaves,
                               words, summ, floors)
        return tuple(a.reshape(-1)[:n] for a in out)


def _light_planes(light_pos, d3, tmax):
    """A shadow wavefront from one origin as B3/B4, B9b and B11c take it:
    (orig, d, tm, n)."""
    dx, n = pad_flat(d3[0], 1.0)
    dy, _ = pad_flat(d3[1], 1.0)
    dz, _ = pad_flat(d3[2], 1.0)
    tm, _ = pad_flat(tmax, -BIG)
    _count_rays(tm)
    return (light_pos.float().contiguous(), (_pk(dx), _pk(dy), _pk(dz)),
            _pk(tm), n)


def _shared_planes(scene, light_pos, d3, tmax):
    """:func:`_light_planes` with B3's words (one band: any-hit needs no
    order): (orig, d, tm, n, words, summ, floors)."""
    orig, d, tm, n = _light_planes(light_pos, d3, tmax)
    words, summ, floors = words_shared(orig, d, tm, scene.leaves, 1)
    return orig, d, tm, n, words, summ, floors


def any_hit_shared(scene, light_pos, d3, tmax):
    """Shadow any-hit from a shared origin, B3 + B4 (B3's words in one
    band: any-hit needs no order), B9b or B11c. ``d3`` three flat (R,)
    direction components, ``tmax`` (R,) (negative = masked ray). Returns
    blocked bool (R,)."""
    with trace.span("snail.shadow"):
        if walks(scene):
            orig, d, tm, n = _light_planes(light_pos, d3, tmax)
            if is_fat(scene):
                out = fat_shadow(orig, d, tm, packet_signs(d),
                                 scene.tri_rows, scene.nodes)
            else:
                out = walk_shadow(orig, d, tm, scene.tri_rows, scene.nodes)
        else:
            orig, d, tm, n, words, summ, floors = _shared_planes(
                scene, light_pos, d3, tmax)
            out = shadow_wl(orig, d, tm, scene.tri_rows, scene.leaves,
                            words, summ, floors)
        return out.reshape(-1)[:n] > 0.0


def any_hit_shared_stats(scene, light_pos, d3, tmax):
    """:func:`any_hit_shared` through B8b, or B9f on a scene with node
    tables: blocked bool (R,), bit for bit, and the per-packet counters
    int32 (P, 8) (see :func:`shadow_wl_stats`, :func:`walk_shadow_stats`).
    A fat-leaf scene raises ValueError, as the JAX package asserts
    (:3685). B8b takes shared-origin rows, B9f the raw rows, as B9b."""
    _no_fat_counters(scene)
    with trace.span("snail.shadow"):
        if walks(scene):
            orig, d, tm, n = _light_planes(light_pos, d3, tmax)
            out, stats = walk_shadow_stats(orig, d, tm, scene.tri_rows,
                                           scene.nodes)
        else:
            orig, d, tm, n, words, summ, floors = _shared_planes(
                scene, light_pos, d3, tmax)
            out, stats = shadow_wl_stats(orig, d, tm,
                                         shared_rows(scene.tri_rows, orig),
                                         scene.leaves, words, summ, floors)
        return out.reshape(-1)[:n] > 0.0, stats


def any_hit_c(scene, o3, d3, tmax):
    """Any-hit of a wavefront of rays with their own origins (``any_hit_c``
    :3999): ``o3``/``d3`` three flat (R,) components, ``tmax`` (R,), a
    negative tmax masks the ray. Masked rays are substituted before B5
    (one band) and B7, or B9d; B11d takes them as they are (:4048).
    Returns blocked bool (R,)."""
    if is_fat(scene):
        o, d, tm, n = padded_planes(o3, d3, tmax)
        _count_rays(tm)
        out = fat_shadow_g(o, d, tm, packet_signs(d), scene.tri_rows,
                           scene.nodes)
        return out.reshape(-1)[:n] > 0.0
    o, d, tm, n = general_planes(o3, d3, tmax)
    _count_rays(tm)
    if walks(scene):
        out = walk_shadow_g(o, d, tm, scene.tri_rows, scene.nodes)
    else:
        words, summ, floors = words_general(o, d, tm, scene.leaves, 1)
        out = shadow_wl_g(o, d, tm, scene.tri_rows, scene.leaves, words,
                          summ, floors)
    return out.reshape(-1)[:n] > 0.0


# --- (R, 3) AoS wrappers: the dispatch seam (``pallas_closest_hit`` /
# ``pallas_any_hit``, traverse_pallas.py:3986, :4057) --------------------


def closest_hit_aos(scene, orig, dirn, tmax):
    """Closest hit of rays ``orig``/``dirn`` (R, 3) with ``tmax`` (R,).
    Returns (dist, tri, bary (R, 2)): a miss has dist BIG, a masked ray
    (tmax < 0) -BIG, and a hit lies nearer than tmax."""
    with trace.span("snail.closest"):
        dist, u, v, tri = closest_hit_c(scene, orig.unbind(1),
                                        dirn.unbind(1), tmax)
        dist = torch.where(dist < tmax.clamp_max(BIG), dist, BIG)
        dist = torch.where(tmax >= 0.0, dist, -BIG)
        return dist, tri, torch.stack([u, v], dim=-1)


def any_hit_aos(scene, orig, dirn, tmax):
    """Any-hit of rays ``orig``/``dirn`` (R, 3) with ``tmax`` (R,):
    blocked bool (R,), never for a masked ray (tmax < 0)."""
    with trace.span("snail.shadow"):
        blocked = any_hit_c(scene, orig.unbind(1), dirn.unbind(1), tmax)
        return blocked & (tmax >= 0.0)
