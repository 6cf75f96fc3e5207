"""Worklist traversal: primary closest hit and shadow any-hit
(``snail_tpu.ops.traverse_pallas``, the ``SNAIL_WL=1`` path).

A frame is traced in packets of TILE x TILE = 64 x 64 pixels (PACKET_R =
4096 rays). Ray k of a packet is pixel ``(k & 31, k >> 5)`` of the
32 x 32 quadrant ``k >> 10`` (quadrants in raster order inside the tile),
the JAX package's square-quadrant order. Every wavefront is flat (R,)
float32 per component in that order.

Each wavefront runs two kernels:

1. a *words* pass (B1 camera, B3 shared origin): per packet, the ray
   interval bounds are tested against every leaf box of the BVH; passing
   leaves are sorted into ``k_bands`` equal-count near-to-far distance
   bands and emitted as bit words, one summary word per 1024 leaves and
   one distance floor per band;
2. a *trace* pass (B2 closest hit from the camera, B4 any-hit from a
   light): the surviving leaf bits are scanned band by band; each ray
   culls the leaf box against its own current best and intersects the
   leaf's triangles with the shared-origin Moller terms of
   :func:`shared_rows`.

Word layout, per packet: ``words`` int32 (P, K, Lp/32), bit p of word w =
leaf 32*w + p; ``summ`` int32 (P, K, Lp/1024), bit j of word s = word
32*s + j is nonzero; ``floors`` float32 (P, K), the least interval entry
distance of band b (BIG when the band is empty).

Every kernel has a plain PyTorch version here. The wrappers route by the
device of their tensors: CUDA tensors launch the kernels of
``snail_tpu_torch/csrc/worklist.cu``, CPU tensors take the plain version.
Each wrapper counts its kernel launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.vecmath import BIG, INV_EPS

TILE = 64  # square pixel tile per packet
PACKET_R = TILE * TILE  # rays per packet
QX = TILE // 32  # 32x32 quadrants per tile row
_QX_SHIFT = QX.bit_length() - 1
IVAL_LEAF = 32  # largest leaf the kernels take (triangles)
WL_BANDS = 8  # closest-hit distance bands
LEAF_BLOCK = 1024  # leaves per summary word (32 words of 32 bits)
TRI_ROW = 16  # floats per 64-B triangle row
_HIST_BINS = 32  # histogram bins of the equal-count band edges


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
    n_leaf: real leaf count; Lp = n_leaf rounded up to LEAF_BLOCK."""

    box: torch.Tensor
    first: torch.Tensor
    count: torch.Tensor
    n_leaf: int

    @property
    def lp(self) -> int:
        return self.box.shape[1]

    def to(self, device) -> "LeafTables":
        return LeafTables(self.box.to(device), self.first.to(device),
                          self.count.to(device), self.n_leaf)


def pack_leaf_tables(node_lo, node_hi, node_child,
                     node_count) -> LeafTables:
    """Leaf boxes, first triangle and count per leaf of a BVH given by its
    node arrays (``snail_tpu.bvh.BVH`` fields)."""
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
                      torch.from_numpy(count), n)


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
    """Per-frame shared-origin triangle table, one per origin.

    For a shared ray origin ``o`` every origin-dependent term of the Moller
    test is a per-triangle constant: tv = o - a, c1 = tv x ca,
    c2 = ba x tv, tmul = -(tv . n) (the reference's
    RayGroup<sharedOrigin=1>, ray_group.h:74-110).

    tris (T, 16) rows [a, ba, ca, n, pad] -> (T, 16) rows
    [n(0:3), c1(3:6), c2(6:9), tmul(9), 0...]."""
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
    scal = torch.tensor([width * 0.5, height * 0.5, 1.0 / height,
                         float(width // TILE)], dtype=torch.float32,
                        device=dev)
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


def _rsqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 1/sqrt (the kernels use __frsqrt_rn)."""
    return torch.rsqrt(x.double()).float()


def _camera_rays(cam, width: int, height: int, pids):
    """Primary dirs, inverse dirs and root-box exit distance of packets
    ``pids``: float32 (len(pids), PACKET_R) each (the in-kernel raygen)."""
    px, py = _pixel_xy(width, height, pids, cam.device)
    px, py = px.float(), py.float()
    x = (px + 0.5 - cam[12]) * cam[14]
    y = (cam[13] - py - 0.5) * cam[14]
    d = [cam[k] * x + cam[3 + k] * y + cam[6 + k] for k in range(3)]
    inv_len = _rsqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = [c * inv_len for c in d]
    idir = [1.0 / (c + INV_EPS) for c in d]
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


def _leaf_pass(tables: LeafTables, o, idir, mb, k_bands: int):
    """Interval test of every leaf against each packet's bounds, banding
    and bit packing. ``o``: float32 (3,) shared origin; ``idir``: three
    (P, PACKET_R) inverse dirs; ``mb``: (P,) packet distance bound."""
    im, iM = zip(*[_widen(c.amin(1), c.amax(1)) for c in idir])
    box = tables.box
    p, lp = mb.shape[0], tables.lp
    tn = torch.zeros((p, lp), dtype=torch.float32, device=box.device)
    tf = mb[:, None].expand(p, lp)
    for k in range(3):
        a = box[k][None, :] - o[k]
        c = box[3 + k][None, :] - o[k]
        lm, lM = im[k][:, None], iM[k][:, None]
        lo_min = torch.minimum(a * lm, a * lM)
        lo_max = torch.maximum(a * lm, a * lM)
        hi_min = torch.minimum(c * lm, c * lM)
        hi_max = torch.maximum(c * lm, c * lM)
        tn = torch.maximum(tn, torch.minimum(lo_min, hi_min))
        tf = torch.minimum(tf, torch.maximum(lo_max, hi_max))
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


def words_camera_plain(cam, width: int, height: int, tables: LeafTables,
                       k_bands: int, pids: torch.Tensor):
    """Plain B1: the primary leaf pass of packets ``pids``."""
    _, idir, t_exit = _camera_rays(cam, width, height, pids)
    mb = t_exit.amax(1) * 1.0001 + 1e-30
    return _leaf_pass(tables, cam[9:12], idir, mb, k_bands)


def words_shared_plain(orig, d, tm, tables: LeafTables, k_bands: int):
    """Plain B3: the leaf pass of rays from one origin; ``d`` three and
    ``tm`` one (P, PACKET_R) float32 planes."""
    idir = [1.0 / (c + INV_EPS) for c in d]
    limit = torch.where(tm >= 0.0, tm, -BIG)
    mb = limit.amax(1) * 1.0001 + 1e-30
    return _leaf_pass(tables, orig, idir, mb, k_bands)


def _packet_leaves(tables: LeafTables, words_p):
    """Leaf ids set in any band of one packet's words, and for each of
    their triangles the triangle id and the position of its leaf."""
    leaves = torch.nonzero(unpack_bits(words_p).any(0)).flatten()
    cnt = tables.count[leaves].long()
    owner = torch.repeat_interleave(torch.arange(len(leaves),
                                                 device=cnt.device), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    tri = (tables.first[leaves].long()[owner]
           + torch.arange(len(owner), device=cnt.device) - start[owner])
    return leaves, tri, owner


def _leaf_slab(tables: LeafTables, o, idir, leaves):
    """Per-ray slab test of ``leaves``: entry and exit, (R, n) each."""
    box = tables.box[:, leaves]
    t1 = [(box[k][None, :] - o[k]) * idir[k][:, None] for k in range(3)]
    t2 = [(box[3 + k][None, :] - o[k]) * idir[k][:, None]
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


def camera_wl_plain(cam, width: int, height: int, rows, tables: LeafTables,
                    words, pids: torch.Tensor):
    """Plain B2: closest hit of the primary rays of packets ``pids`` over
    the leaves set in their ``words`` (len(pids), K, Lp/32).

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
            det, u, v, tmul = _moller_sh(rows[t], dp)
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


def shadow_wl_plain(orig, d, tm, rows, tables: LeafTables, words):
    """Plain B4: any-hit of rays from ``orig`` over the leaves set in
    ``words``; ``d`` three and ``tm`` one (P, PACKET_R) planes. Returns
    blocked float32 (P, PACKET_R), 1 where an occluder lies in
    (0, tmax), with the kernel's one-sided test (intersect.py:80-89)."""
    idir = [1.0 / (c + INV_EPS) for c in d]
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
            det, u, v, tmul = _moller_sh(rows[tri[s:s + _PLAIN_TRIS]], dp)
            occ = ((torch.minimum(u, v) >= 0.0) & (u + v <= det)
                   & (tmul > 0.0) & (tmul < lim * det)
                   & slab[:, owner[s:s + _PLAIN_TRIS]])
            occ_any |= occ.any(1)
        blocked[i] = occ_any.float()
    return blocked


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


def _check_tables(tables: LeafTables, dev):
    lp = tables.lp
    _check(tables.box, "leaf box", torch.float32, (6, lp), dev)
    _check(tables.first, "leaf first", torch.int32, (lp,), dev)
    _check(tables.count, "leaf count", torch.int32, (lp,), dev)


def _words_out(p, k_bands, lp, dev):
    return (torch.empty((p, k_bands, lp // 32), dtype=torch.int32,
                        device=dev),
            torch.empty((p, k_bands, lp // LEAF_BLOCK), dtype=torch.int32,
                        device=dev),
            torch.empty((p, k_bands), dtype=torch.float32, device=dev))


def words_camera(cam, width: int, height: int, tables: LeafTables,
                 k_bands: int = WL_BANDS):
    """B1: primary leaf pass of a width x height frame (replaces
    ``_words_camera_kernel``). Returns (words, summ, floors)."""
    p = (width // TILE) * (height // TILE)
    if not _on_cuda(cam):
        return words_camera_plain(cam, width, height, tables, k_bands,
                                  torch.arange(p))
    from ._build import library

    dev = cam.device
    _check(cam, "cam", torch.float32, (22,), dev)
    _check_tables(tables, dev)
    words, summ, floors = _words_out(p, k_bands, tables.lp, dev)
    lib = library()
    _launched(lib.snail_words_camera(
        _ptr(cam), _ptr(tables.box), tables.lp, tables.n_leaf, k_bands, p,
        _ptr(words), _ptr(summ), _ptr(floors), _stream()), "words_camera")
    words_camera.launches += 1
    return words, summ, floors


def words_shared(orig, d, tm, tables: LeafTables, k_bands: int = 1):
    """B3: leaf pass of rays from one origin (replaces
    ``_words_shared_kernel``). ``d`` three and ``tm`` one (P, PACKET_R)
    float32 planes. Returns (words, summ, floors)."""
    if not _on_cuda(tm):
        return words_shared_plain(orig, d, tm, tables, k_bands)
    from ._build import library

    dev = tm.device
    p = tm.shape[0]
    _check(orig, "origin", torch.float32, (3,), dev)
    for name, t in zip(("dx", "dy", "dz", "tmax"), (*d, tm)):
        _check(t, name, torch.float32, (p, PACKET_R), dev)
    _check_tables(tables, dev)
    words, summ, floors = _words_out(p, k_bands, tables.lp, dev)
    lib = library()
    _launched(lib.snail_words_shared(
        _ptr(orig), _ptr(d[0]), _ptr(d[1]), _ptr(d[2]), _ptr(tm),
        _ptr(tables.box), tables.lp, tables.n_leaf, k_bands, p,
        _ptr(words), _ptr(summ), _ptr(floors), _stream()), "words_shared")
    words_shared.launches += 1
    return words, summ, floors


def _check_words(words, summ, floors, p, lp, dev):
    k = words.shape[1]
    _check(words, "words", torch.int32, (p, k, lp // 32), dev)
    _check(summ, "summ", torch.int32, (p, k, lp // LEAF_BLOCK), dev)
    _check(floors, "floors", torch.float32, (p, k), dev)


def camera_wl(cam, width: int, height: int, rows, tables: LeafTables,
              words, summ, floors):
    """B2: closest hit of the primary rays over B1's words (replaces
    ``_camera_wl_kernel``). Returns (dist, u, v, tri, dx, dy, dz), each
    (P, PACKET_R); a miss has dist BIG and tri -1."""
    p = (width // TILE) * (height // TILE)
    if not _on_cuda(cam):
        return camera_wl_plain(cam, width, height, rows, tables, words,
                               torch.arange(p))
    from ._build import library

    dev = cam.device
    _check(cam, "cam", torch.float32, (22,), dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_tables(tables, dev)
    _check_words(words, summ, floors, p, tables.lp, dev)
    f32 = [torch.empty((p, PACKET_R), dtype=torch.float32, device=dev)
           for _ in range(6)]
    tri = torch.empty((p, PACKET_R), dtype=torch.int32, device=dev)
    dist, u, v, dx, dy, dz = f32
    lib = library()
    _launched(lib.snail_camera_wl(
        _ptr(cam), _ptr(rows), _ptr(tables.box), _ptr(tables.first),
        _ptr(tables.count), tables.lp, _ptr(words), _ptr(summ),
        _ptr(floors), words.shape[1], p, _ptr(dist), _ptr(u), _ptr(v),
        _ptr(tri), _ptr(dx), _ptr(dy), _ptr(dz), _stream()), "camera_wl")
    camera_wl.launches += 1
    return dist, u, v, tri, dx, dy, dz


def shadow_wl(orig, d, tm, rows, tables: LeafTables, words, summ, floors):
    """B4: any-hit from a shared origin over B3's words (replaces
    ``_shadow_wl_kernel``). Returns blocked float32 (P, PACKET_R)."""
    if not _on_cuda(tm):
        return shadow_wl_plain(orig, d, tm, rows, tables, words)
    from ._build import library

    dev = tm.device
    p = tm.shape[0]
    _check(orig, "origin", torch.float32, (3,), dev)
    for name, t in zip(("dx", "dy", "dz", "tmax"), (*d, tm)):
        _check(t, name, torch.float32, (p, PACKET_R), dev)
    _check(rows, "rows", torch.float32, (rows.shape[0], TRI_ROW), dev)
    _check_tables(tables, dev)
    _check_words(words, summ, floors, p, tables.lp, dev)
    blocked = torch.empty((p, PACKET_R), dtype=torch.float32, device=dev)
    lib = library()
    _launched(lib.snail_shadow_wl(
        _ptr(orig), _ptr(d[0]), _ptr(d[1]), _ptr(d[2]), _ptr(tm),
        _ptr(rows), _ptr(tables.box), _ptr(tables.first),
        _ptr(tables.count), tables.lp, _ptr(words), _ptr(summ),
        _ptr(floors), words.shape[1], p, _ptr(blocked), _stream()),
        "shadow_wl")
    shadow_wl.launches += 1
    return blocked


KERNELS = (words_camera, camera_wl, words_shared, shadow_wl)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


# ---------------------------------------------------------------------------
# Wavefront entry points
# ---------------------------------------------------------------------------


def camera_trace(scene, camera, width: int, height: int):
    """Fused raygen + closest hit for a full frame of primary rays.

    Returns flat (R,) tensors dist, u, v, tri, dx, dy, dz in packet order
    (see :func:`kernel_ray_index`). Requires width and height to be
    multiples of TILE."""
    if width % TILE or height % TILE:
        raise ValueError(f"frame {width}x{height} is not a multiple of "
                         f"the {TILE}-pixel tile")
    cam = cam_vec(camera, width, height, scene.root_lo, scene.root_hi)
    words, summ, floors = words_camera(cam, width, height, scene.leaves,
                                       WL_BANDS)
    rows = shared_rows(scene.tri_rows, camera.pos)
    out = camera_wl(cam, width, height, rows, scene.leaves, words, summ,
                    floors)
    return tuple(a.reshape(-1) for a in out)


def any_hit_shared(scene, light_pos, d3, tmax):
    """Shadow any-hit from a shared origin. ``d3`` three flat (R,)
    direction components, ``tmax`` (R,) (negative = masked ray). Returns
    blocked bool (R,)."""
    dx, n = pad_flat(d3[0], 1.0)
    dy, _ = pad_flat(d3[1], 1.0)
    dz, _ = pad_flat(d3[2], 1.0)
    tm, _ = pad_flat(tmax, -BIG)
    pk = lambda a: a.reshape(-1, PACKET_R)
    d = (pk(dx), pk(dy), pk(dz))
    orig = light_pos.float().contiguous()
    # any-hit needs no ordering: one band
    words, summ, floors = words_shared(orig, d, pk(tm), scene.leaves, 1)
    rows = shared_rows(scene.tri_rows, orig)
    out = shadow_wl(orig, d, pk(tm), rows, scene.leaves, words, summ,
                    floors)
    return out.reshape(-1)[:n] > 0.0
