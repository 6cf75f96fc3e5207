"""Mipmapped textures (``snail_tpu.scene.textures``): the host tables in
NumPy, equal bit for bit to the JAX package's, and the samplers as torch
ops on the scene's device.

Rebuild of ``MipmapTexture`` + ``PointSampler``
(reference src/mipmap_texture.{h,cpp}, src/sampling/point_sampler.cpp):

- power-of-2 RGB textures with a full mip chain (box-filtered GenMips,
  mipmap_texture.cpp);
- point sampling with wrap addressing and the reference's vertical flip
  (point_sampler.cpp:79-80);
- mip level selected from the uv footprint: ``pixels = floor(min(diff.x*w,
  diff.y*h))``, mip = position of highest set bit + 1, clamped to the chain
  (point_sampler.cpp:97-108).

Layout: all textures share one **pyramid atlas** ``[NT, 2H, W, 3]``
(float32) — mip L of a texture lives at row offset ``2H * (1 - 2^-L)``, so
one gather fetches any texel of any mip of any texture. ``meta[NT, 4] =
(w, h, n_mips, 0)``. Smaller textures are upsampled to the common base
size at load (area-preserving repeat), so w/h are the base size for every
texture. A tap is one ``index_select`` of the atlas's (NT * 2H * W, 3)
rows at a flat index, whatever the wavefront's size.

The SAT (summed-area table) sampler of the reference
(src/sampling/sat_sampler.h) is :func:`build_sat_atlas` /
:func:`sample_sat_atlas` for box-filtered lookups over the footprint, and
:func:`build_sat` / :func:`sample_sat` over one texture.

PIL is imported only where an image file is read.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def gen_mips(img: np.ndarray) -> List[np.ndarray]:
    """Box-filter mip chain down to 1x1 (reference MipmapTexture::GenMips)."""
    assert _is_pow2(img.shape[0]) and _is_pow2(img.shape[1]), img.shape
    mips = [img.astype(np.float32)]
    cur = mips[0]
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        if cur.shape[0] > 1 and cur.shape[1] > 1:
            nxt = (
                cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]
            ) * 0.25
        elif cur.shape[0] > 1:
            nxt = (cur[0::2] + cur[1::2]) * 0.5
        else:
            nxt = (cur[:, 0::2] + cur[:, 1::2]) * 0.5
        mips.append(nxt.astype(np.float32))
        cur = nxt
    return mips


def build_pyramid_atlas(images: List[np.ndarray]):
    """Pack images (each [h, w, 3], power-of-2) into the pyramid atlas.

    Returns (atlas float32[NT, 2H, W, 3], meta int32[NT, 4]), NumPy."""
    assert images
    base_h = max(i.shape[0] for i in images)
    base_w = max(i.shape[1] for i in images)
    nt = len(images)
    atlas = np.zeros((nt, 2 * base_h, base_w, 3), np.float32)
    meta = np.zeros((nt, 4), np.int32)
    for t, img in enumerate(images):
        # upsample to common base size (nearest repeat keeps texel identity)
        ry = base_h // img.shape[0]
        rx = base_w // img.shape[1]
        up = np.repeat(np.repeat(img, ry, axis=0), rx, axis=1)
        mips = gen_mips(up)
        off = 0
        for m in mips:
            atlas[t, off : off + m.shape[0], : m.shape[1]] = m
            off += m.shape[0]
        meta[t] = (base_w, base_h, len(mips), 0)
    return atlas, meta


def mip_from_footprint(diff_uv, w, h, n_mips):
    """Reference mip rule (point_sampler.cpp:97-108): pixels =
    floor(min(diff.x*w, diff.y*h)); mip = bit-length of pixels, computed
    as floor(log2(float(pixels))) + 1 as the JAX package does."""
    px = torch.minimum(diff_uv[..., 0] * w, diff_uv[..., 1] * h)
    px = torch.clamp_min(px, 0.0)
    ip = torch.floor(px).to(torch.int32)
    mip = torch.where(
        ip > 0,
        torch.floor(torch.log2(torch.clamp_min(ip.float(), 1.0))).to(
            torch.int32) + 1,
        0)
    return torch.minimum(torch.clamp_min(mip, 0), n_mips - 1)


def uv_footprint(uv, tile_hw, valid):
    """Per-pixel uv footprint from tile-ordered wavefront uvs — the
    ``texDiff`` of the reference (scene_inl.h:294), as masked forward
    differences over each tile, the last row and column repeating the
    one before (the JAX package's edge padding).

    uv float32[R, 2] in row-major (tile_h, tile_w) tile packet order,
    valid bool[R] (misses/foreign pixels contribute no footprint).
    Returns float32[R, 2]."""
    th, tw = tile_hw
    q = uv.reshape(-1, th, tw, 2)
    vq = valid.reshape(-1, th, tw)
    dy = torch.where((vq[:, 1:] & vq[:, :-1])[..., None],
                     (q[:, 1:] - q[:, :-1]).abs(), 0.0)
    dx = torch.where((vq[:, :, 1:] & vq[:, :, :-1])[..., None],
                     (q[:, :, 1:] - q[:, :, :-1]).abs(), 0.0)
    dy = torch.cat([dy, dy[:, -1:]], 1)
    dx = torch.cat([dx, dx[:, :, -1:]], 2)
    return torch.maximum(dy, dx).reshape(-1, 2)


def _meta_of(meta, tex_id):
    """(tid, w, h, n_mips) of each sample: the texture id clamped to 0
    (-1 allowed: the caller masks) and its meta row, gathered a column at
    a time: on an H100 a gather of the 16-byte rows takes PyTorch's
    vectorized row-gather kernel, ~0.6 ms at 1M samples, where three of
    one word take ~0.01 ms apiece (PERF.md)."""
    tid = tex_id.clamp_min(0)
    idx = tid.reshape(-1).long()
    w, h, n_mips = (meta[:, k].index_select(0, idx).reshape(tid.shape)
                    for k in range(3))
    return tid, w, h, n_mips


def _in_range(i, n: int):
    """An index as JAX's array indexing reads it: a negative one counts
    from the end once, then it is clamped to [0, n - 1]. The last mips of
    a texture that is not square have a side of 0 texels, where the taps'
    wrap mask keeps nothing in range; every sample still reads what the
    JAX package reads."""
    i = i.long()
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _gather(table, tid, yi, xi):
    """Texels (..., 3) of a [NT, Y, X, 3] table at (tid, yi, xi), indices
    read as :func:`_in_range` reads them: one index_select at the flat
    index."""
    nt, ny, nx, _ = table.shape
    idx = ((_in_range(tid, nt) * ny + _in_range(yi, ny)) * nx
           + _in_range(xi, nx))
    return table.reshape(-1, 3).index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, 3)


def sample_atlas(atlas, meta, tex_id, uv, diff_uv=None, filter="point"):
    """Sample the pyramid atlas.

    tex_id int32[...] (-1 allowed: result meaningless, caller masks),
    uv float32[..., 2], diff_uv optional float32[..., 2] uv footprint,
    filter "point" (PointSampler, sampling/point_sampler.cpp:52-100) or
    "bilinear" (BilinearSampler, sampling/bilinear_sampler.*: 4 taps at
    the selected mip, fractional weights, wrap addressing).
    Returns rgb float32[..., 3] in [0, 1]."""
    tid, w, h, n_mips = _meta_of(meta, tex_id)
    base_h = atlas.shape[1] // 2

    if diff_uv is not None:
        mip = mip_from_footprint(diff_uv, w.float(), h.float(), n_mips)
    else:
        mip = torch.zeros_like(w)

    wm = w >> mip  # mip-level extent (pow2)
    hm = h >> mip
    row0 = 2 * base_h - ((2 * base_h) >> mip)  # pyramid offset

    def tap(xi, yi):
        xi = xi & (wm - 1)  # wrap addressing (point_sampler.cpp:72-76)
        yi = yi & (hm - 1)
        yi = hm - 1 - yi  # vertical flip (point_sampler.cpp:79-80)
        return _gather(atlas, tid, row0 + yi, xi)

    if filter == "point":
        # integer texel coords at mip 0 (truncated toward zero, as the JAX
        # package's astype), shifted down (point_sampler.cpp:110-116)
        x = (uv[..., 0] * w.float()).to(torch.int32)
        y = (uv[..., 1] * h.float()).to(torch.int32)
        return tap(x >> mip, y >> mip)

    # bilinear: fractional coords at the SELECTED mip, 4 taps
    xf = uv[..., 0] * wm.float() - 0.5
    yf = uv[..., 1] * hm.float() - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fx = (xf - x0)[..., None]
    fy = (yf - y0)[..., None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    c00 = tap(x0, y0)
    c10 = tap(x0 + 1, y0)
    c01 = tap(x0, y0 + 1)
    c11 = tap(x0 + 1, y0 + 1)
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def build_sat(img: np.ndarray) -> np.ndarray:
    """Summed-area table (reference SATSampler, sampling/sat_sampler.h:10-57)."""
    return np.cumsum(np.cumsum(img.astype(np.float64), axis=0), axis=1)


def build_sat_atlas(atlas, meta=None) -> np.ndarray:
    """Per-texture SATs over the mip-0 plane of a pyramid atlas
    ([T, 2H, W, 3] -> float32 [T, H, W, 3], NumPy): prefix sums in float64,
    then float32, so both packages read the same table. Pairs with a
    pyramid atlas so a scene can offer both samplers (NewSampler picks per
    format, sampling/sampler.cpp:9-44; here RenderOpts.tex_filter picks)."""
    a = np.asarray(atlas, np.float64)
    base_h = a.shape[1] // 2
    sats = np.cumsum(np.cumsum(a[:, :base_h], axis=1), axis=2)
    return sats.astype(np.float32)


def _sat_axis_segments(c, hw, n, full):
    """Wrap-aware texel interval [c-hw, c+hw] on an n-texel (pow2) axis.

    Returns two inclusive segments (a0, a1) and (b0, b1); the second is
    empty (b1 < b0) unless the interval straddles the wrap seam — the
    reference SATSampler wraps its rect coords the same way
    (sat_sampler.cpp:56-80). ``full`` forces the whole axis (the
    reference's size >= 0.5 average fallback, sat_sampler.cpp:52)."""
    i0 = torch.floor((c - hw) * n.float()).to(torch.int32)
    i1 = torch.floor((c + hw) * n.float()).to(torch.int32)
    whole = full | ((i1 - i0 + 1) >= n)
    m0 = torch.where(whole, 0, i0 & (n - 1))  # pow2 wrap (wMask/hMask)
    m1 = torch.where(whole, n - 1, i1 & (n - 1))
    wrapped = m0 > m1
    a1 = torch.where(wrapped, n - 1, m1)
    b1 = torch.where(wrapped, m1, -1)  # empty when not wrapped
    return m0, a1, torch.zeros_like(m0), b1


def sample_sat_atlas(sat_atlas, meta, tex_id, uv, diff_uv):
    """Box-filtered fetch over the uv footprint via SAT rect sums
    (SATSampler::operator(), sat_sampler.cpp:51-86) — the large-footprint
    complement to mip point/bilinear sampling.

    Wrap addressing: a footprint straddling the [0,1) seam splits into
    per-axis segments (up to 2x2 rect queries) and averages across the
    seam exactly. The vertical flip happens in TEXEL space ((h-1) - y, like
    the point/bilinear taps) so all three samplers agree on orientation.
    Each rect sum is ``a - b - c + d`` in that order, as the JAX package
    adds them: prefix sums reach ~H * W, where another order moves the
    result by their ulps."""
    tid, wi, hi, _ = _meta_of(meta, tex_id)
    size_u = torch.clamp_min(diff_uv[..., 0], 1e-6)
    size_v = torch.clamp_min(diff_uv[..., 1], 1e-6)
    # reference: either-axis footprint >= half the texture -> whole-texture
    # average (sat_sampler.cpp:52)
    full = (size_u >= 0.5) | (size_v >= 0.5)
    cu = uv[..., 0] - torch.floor(uv[..., 0])
    cv = uv[..., 1] - torch.floor(uv[..., 1])

    ua0, ua1, ub0, ub1 = _sat_axis_segments(cu, 0.5 * size_u, wi, full)
    va0, va1, vb0, vb1 = _sat_axis_segments(cv, 0.5 * size_v, hi, full)
    # texture-v segment [a, b] -> SAT rows [h-1-b, h-1-a] (texel flip)
    fva0, fva1 = hi - 1 - va1, hi - 1 - va0
    fvb0, fvb1 = hi - 1 - vb1, hi - 1 - vb0

    def t(yy, xx, on):
        return torch.where(on[..., None], _gather(sat_atlas, tid, yy, xx),
                           0.0)

    def rect(y0, y1, x0, x1):
        """Inclusive SAT rect sum; empty (x1<x0 or y1<y0) -> 0."""
        on = (x1 >= x0) & (y1 >= y0)
        y0c = y0.clamp_min(0)
        x0c = x0.clamp_min(0)
        return (
            t(y1, x1, on)
            - t((y0c - 1).clamp_min(0), x1, on & (y0c > 0))
            - t(y1, (x0c - 1).clamp_min(0), on & (x0c > 0))
            + t((y0c - 1).clamp_min(0), (x0c - 1).clamp_min(0),
                on & (x0c > 0) & (y0c > 0))
        )

    total = (
        rect(fva0, fva1, ua0, ua1) + rect(fva0, fva1, ub0, ub1)
        + rect(fvb0, fvb1, ua0, ua1) + rect(fvb0, fvb1, ub0, ub1)
    )
    nu = (ua1 - ua0 + 1).clamp_min(0) + (ub1 - ub0 + 1).clamp_min(0)
    nv = (va1 - va0 + 1).clamp_min(0) + (vb1 - vb0 + 1).clamp_min(0)
    area = (nu * nv).float()
    return total / area[..., None]


def sample_sat(sat, uv_min, uv_max):
    """Mean color over an axis-aligned uv rect via 4 SAT taps of one
    texture's table ``sat`` [h, w, 3] (a tensor, or :func:`build_sat`'s
    float64 array, read as float32 on the uvs' device)."""
    sat = torch.as_tensor(sat, dtype=torch.float32, device=uv_min.device)
    h, w = sat.shape[:2]
    x0 = (uv_min[..., 0] * w).to(torch.int32).clamp(0, w - 1)
    x1 = (uv_max[..., 0] * w).to(torch.int32).clamp(0, w - 1)
    y0 = (uv_min[..., 1] * h).to(torch.int32).clamp(0, h - 1)
    y1 = (uv_max[..., 1] * h).to(torch.int32).clamp(0, h - 1)
    x1 = torch.maximum(x1, x0)
    y1 = torch.maximum(y1, y0)
    s = sat.reshape(1, h, w, -1)
    z = torch.zeros_like(x0)
    tap = lambda yy, xx: _gather(s, z, yy, xx)
    total = (
        tap(y1, x1)
        - torch.where((y0 > 0)[..., None], tap((y0 - 1).clamp_min(0), x1),
                      0.0)
        - torch.where((x0 > 0)[..., None], tap(y1, (x0 - 1).clamp_min(0)),
                      0.0)
        + torch.where(((x0 > 0) & (y0 > 0))[..., None],
                      tap((y0 - 1).clamp_min(0), (x0 - 1).clamp_min(0)), 0.0)
    )
    area = ((x1 - x0 + 1) * (y1 - y0 + 1)).float()
    return total / area[..., None]


def footprint_tiles(tile_hw, n_rays: int) -> bool:
    """Whether a wavefront of ``n_rays`` in ``tile_hw`` tile order has a
    uv footprint: tiles of at least 2 x 2 pixels that divide it. A tile of
    one row or column has no forward difference along it (the JAX package
    raises there, on an edge pad of an empty axis); such a wavefront, like
    a bounce wavefront, samples mip 0."""
    return (tile_hw is not None and min(tile_hw) > 1
            and n_rays % (tile_hw[0] * tile_hw[1]) == 0)


def sample_diffuse(scene, opts, tex_id, uv, hit, tile_hw):
    """The diffuse texture colour (R, 3) of a wavefront's hits: the
    footprint of its ``tile_hw`` tiles (:func:`footprint_tiles`, else
    none) picks the mip; ``opts.tex_filter`` "sat" reads the scene's SATs
    where it has them and a footprint exists, else the pyramid atlas is
    point- or bilinear-sampled (JAX fast.py:159-192, integrator.py:80-97).
    The footprint and the mip carry no gradient; a bilinear sample's
    weights do."""
    diff_uv = (uv_footprint(uv.detach(), tile_hw, hit)
               if footprint_tiles(tile_hw, uv.shape[0]) else None)
    if (opts.tex_filter == "sat" and scene.tex_sat is not None
            and diff_uv is not None):
        return sample_sat_atlas(scene.tex_sat, scene.tex_meta, tex_id, uv,
                                diff_uv)
    return sample_atlas(scene.tex_atlas, scene.tex_meta, tex_id, uv, diff_uv,
                        filter=("bilinear" if opts.tex_filter == "bilinear"
                                else "point"))


def checker_atlas(scene, size: int = 256, squares: int = 16):
    """Attach a procedural checkerboard texture to every material of an
    existing TracedScene (textured-throughput benchmarking when the scene
    ships no image files — the reference's headline row is sponza WITH
    textures, benchmark.txt:91-94).

    Returns a new scene with tex_atlas/tex_meta set and every material's
    diffuse texture id pointing at texture 0, in both material encodings
    (mat_pack column 8 and the material row written out in sh_pack,
    column 24). The procedural scenes carry no ``vt`` records, so planar
    world-space UVs are synthesized from the triangle vertices (XZ
    projection over the root box, ~4 repeats; sh_pack columns 9-14)."""
    import dataclasses

    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cell = size // squares
    chk = ((yy // cell + xx // cell) % 2).astype(np.float32)
    img = np.stack([0.2 + 0.7 * chk, 0.25 + 0.5 * chk, 0.3 + 0.3 * chk],
                   axis=-1)
    atlas, meta = build_pyramid_atlas([img])

    lo, hi = scene.root_lo, scene.root_hi
    inv = 4.0 / torch.clamp_min(torch.max(hi - lo), 1e-6)  # ~4 repeats
    xz = [0, 2]
    uv0 = (scene.tri_a[:, xz] - lo[xz][None]) * inv
    uve1 = scene.tri_ba[:, xz] * inv
    uve2 = scene.tri_ca[:, xz] * inv

    mat_pack = scene.mat_pack.clone()
    mat_pack[:, 8] = 0.0
    sh_pack = scene.sh_pack.clone()
    sh_pack[:, 24] = 0.0  # the material row's difftex column
    sh_pack[:, 9:11] = uv0
    sh_pack[:, 11:13] = uve1
    sh_pack[:, 13:15] = uve2
    dev = scene.device
    return dataclasses.replace(
        scene, tex_atlas=torch.from_numpy(atlas).to(dev),
        tex_meta=torch.from_numpy(meta).to(dev), tex_sat=None,
        mat_pack=mat_pack, sh_pack=sh_pack)


def load_texture_atlas(descs, tex_dir: str):
    """Load the diffuse/dissolve maps referenced by material descs
    (reference LoadTextures, shading/material.cpp:150-166; bmp/tga/png).
    Returns ((atlas, meta), name->tex_id) or (None, {}) if none load."""
    import os

    names: List[str] = []
    for d in descs:
        for n in (d.diffuse_map, d.dissolve_map):
            if n and n not in names:
                names.append(n)
    images = []
    ids: Dict[str, int] = {}
    for n in names:
        path = os.path.join(tex_dir, n)
        img = _load_image_pow2(path)
        if img is None:
            continue
        ids[n] = len(images)
        images.append(img)
    if not images:
        return None, {}
    return build_pyramid_atlas(images), ids


def _load_image_pow2(path):
    """Load an image as float32 [h, w, 3] in [0,1], padded/cropped to
    power-of-2 (the reference FATALs on non-pow2, point_sampler.cpp:7-8;
    we resize instead). None where the file is missing or PIL cannot read
    it."""
    import os

    if not os.path.exists(path):
        return None
    try:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    except Exception:  # any file PIL cannot read is skipped, as in JAX
        return None
    h, w = img.shape[:2]
    ph = 1 << (h - 1).bit_length()
    pw = 1 << (w - 1).bit_length()
    if (ph, pw) != (h, w):
        ys = (np.arange(ph) * h // ph).clip(0, h - 1)
        xs = (np.arange(pw) * w // pw).clip(0, w - 1)
        img = img[ys][:, xs]
    return img
