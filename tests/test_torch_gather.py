"""The hit-row gather of the forward frame (``ops.gather.surface_rows``):
its plain version against a per-ray read of the table, the column sets
the frame asks for, and frames, bounce rays and counter frames bit for bit
what the whole-row gather (``sh_pack.index_select(...).T``) gives.

Scenes: city_scene(4) (134 triangles) with bench.py's bounce material
(half mirror, half glass) and a second light, on leaf and node tables,
and its checkerboard-textured twin; 64 x 64 frames. No JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from snail_tpu_torch.core.types import Light, RenderOpts
from snail_tpu_torch.core.vecmath import BIG
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.ops.gather import surface_rows
from snail_tpu_torch.render import fast
from snail_tpu_torch.render.renderer import render_frame
from snail_tpu_torch.scene.bench_scenes import bench_scene

W = H = 64
T = 50  # rows of the synthetic table
FRAME = fast.NORMAL_COLS + fast.MATERIAL_COLS
COLUMN_SETS = {
    "frame": FRAME,
    "given_normals": fast.MATERIAL_COLS,
    "textured": tuple(sorted(FRAME + fast.UV_COLS + (fast.TEX_COL,))),
}


def _wavefront(seed=0, n=1000):
    """A table of T distinct rows and n rays: hits on every row, the last
    one included, and misses at dist 0, negative, -BIG, BIG, +inf and
    NaN, whose tri is garbage (negative, beyond the table)."""
    gen = torch.Generator().manual_seed(seed)
    sh_pack = torch.randn((T, 32), generator=gen)
    tri = torch.randint(0, T, (n,), generator=gen, dtype=torch.int32)
    tri[:2] = torch.tensor([T - 1, 0], dtype=torch.int32)
    dist = torch.rand(n, generator=gen) * 100.0 + 1e-3
    kinds = torch.tensor([0.0, -1.0, -BIG, BIG, float("inf"), float("nan")])
    miss = torch.arange(2, n, 3)
    dist[miss] = kinds[torch.arange(len(miss)) % len(kinds)]
    tri[miss[::2]] = -7
    tri[miss[1::2]] = T + 3
    return sh_pack, dist, tri


@pytest.mark.parametrize("which", sorted(COLUMN_SETS))
def test_plain_gather_reads_each_rays_row(which):
    """Plane k holds column cols[k] of the ray's row: tri for a hit (0 <
    dist < BIG), row 0 for every miss, whatever its tri; the same bits as
    the whole-row gather's columns."""
    cols = COLUMN_SETS[which]
    sh_pack, dist, tri = _wavefront(seed=len(which))
    out = surface_rows(sh_pack, dist, tri, cols)
    d, t, tbl = dist.numpy(), tri.numpy(), sh_pack.numpy()
    rows = np.where((d > 0.0) & (d < np.float32(BIG)), t, 0)
    assert out.shape == (len(cols), len(d)) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), tbl[rows][:, cols].T)
    hit = (dist > 0.0) & (dist < BIG)
    whole = sh_pack.index_select(0, torch.where(hit, tri, 0).long()).T
    assert torch.equal(out, whole[list(cols)])
    assert 0 < int(hit.sum()) < len(d) and int(tri[0]) == T - 1


def test_hit_outside_the_table_reads_row_0():
    """A hit whose tri lies outside the table (negative, or past its last
    row) reads row 0, as a miss does, and as the kernel does."""
    sh_pack, dist, tri = _wavefront(seed=3)
    dist = torch.rand(len(dist)) * 10.0 + 1e-3  # every ray a hit
    tri[3::4] = -7
    tri[5::8] = T
    out = surface_rows(sh_pack, dist, tri, FRAME)
    inside = (tri >= 0) & (tri < T)
    want = sh_pack[torch.where(inside, tri, 0).long()].T[list(FRAME)]
    assert torch.equal(out, want) and not bool(inside.all())


@pytest.mark.parametrize("cols", [(3, 2), (1, 1), (-1, 4), (0, 32)])
def test_gather_refuses_columns(cols):
    sh_pack, dist, tri = _wavefront()
    with pytest.raises(ValueError, match="strictly increasing"):
        surface_rows(sh_pack, dist, tri, cols)


def test_planes_address_columns_by_number():
    """``_Planes`` gives column k's plane for ``[k]``, the planes of a run
    of gathered columns for ``[a:b]``, and refuses a column or a run not
    gathered."""
    cols = (0, 1, 2, 16, 17, 18, 22)
    planes = torch.arange(len(cols) * 5, dtype=torch.float32).reshape(-1, 5)
    sh = fast._Planes(planes, cols)
    assert torch.equal(sh[22], planes[6]) and torch.equal(sh[1], planes[1])
    assert torch.equal(sh[16:19], planes[3:6])
    with pytest.raises(KeyError):
        sh[23]
    with pytest.raises(KeyError):
        sh[1:17]


def _whole_row_surface(scene, o3, d3, dist, u, v, tri, sh=None,
                       normals=None, textured=False):
    """``render.fast._surface`` as it read whole rows: one index_select
    of every ray's 32 columns, addressed through the (32, R) view."""
    hit = (dist > 0.0) & (dist < BIG)
    if sh is None:
        sh = scene.sh_pack.index_select(0, torch.where(hit, tri, 0).long()).T
    n3 = normals if normals is not None else (
        sh[0] + sh[3] * u + sh[6] * v,
        sh[1] + sh[4] * u + sh[7] * v,
        sh[2] + sh[5] * u + sh[8] * v)
    safe_dist = torch.where(hit, dist, 0.0)
    p3 = tuple(o + d * safe_dist for o, d in zip(o3, d3))
    return hit, sh, n3, p3


@pytest.fixture(scope="module")
def scenes():
    """{name: (scene, camera)}: the bounce city on leaf and node tables,
    each with a second light, and its textured twin."""
    out = {}
    for name, kw in (("leaves", {}), ("nodes", {"walk": True}),
                     ("textured", {"textured": "point"})):
        scene, cam, _, _ = bench_scene("city", 4, device="cpu", bounce=True,
                                       **kw)
        second = Light.make((20.0, 40.0, -10.0), (0.6, 0.7, 0.9), 150.0,
                            device="cpu")
        out[name] = (dataclasses.replace(
            scene, lights=Light.stack([scene.lights, second])), cam)
    return out


BOUNCE = RenderOpts(textures=False)
FRAMES = {
    "bounce": ("leaves", lambda s, c: render_frame(s, c, W, H, BOUNCE)),
    "bounce_walk": ("nodes", lambda s, c: render_frame(s, c, W, H, BOUNCE)),
    "bounce_ss": ("leaves", lambda s, c: render_frame(
        s, c, W, H, dataclasses.replace(BOUNCE, supersample=True))),
    "fwd": ("leaves", lambda s, c: render_frame(s, c, W, H, RenderOpts(
        reflections=False, transparency=False, textures=False))),
    "two_bounces": ("leaves", lambda s, c: render_frame(
        s, c, W, H, dataclasses.replace(BOUNCE, max_bounces=2))),
    "textured": ("textured", lambda s, c: render_frame(
        s, c, W, H, RenderOpts(textures=True))),
    "stats": ("leaves", lambda s, c: fast.render_frame_fast_stats(
        s, c, W, H, BOUNCE)),
}


def _flat(out):
    if isinstance(out, tuple):  # the counter frame: (image, counters)
        img, stats = out
        return [img, torch.tensor([stats[k] for k in sorted(stats)])]
    return [out]


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_frame_bits_equal_the_whole_row_gather(scenes, frame, monkeypatch):
    """Each frame, with shadows from two lights, and its reflection and
    transparency bounces where its options have them, gives the bits it
    gives with every ray's whole row gathered."""
    which, run = FRAMES[frame]
    scene, cam = scenes[which]
    planes = _flat(run(scene, cam))
    monkeypatch.setattr(fast, "_surface", _whole_row_surface)
    rows = _flat(run(scene, cam))
    assert planes[0].abs().amax() > 0
    assert all(torch.equal(a, b) for a, b in zip(planes, rows))


def test_bounce_and_shadow_rays_equal_the_whole_row_gather(scenes,
                                                           monkeypatch):
    """The reflection wavefront (``bounce_wavefront``) and a light's
    shadow wavefront (``shadow_wavefront``) of the primary hits, each
    through the frame's column set, bit for bit the whole-row gather's."""
    scene, cam = scenes["leaves"]
    dist, u, v, tri, dx, dy, dz = pt.camera_trace(scene, cam, W, H)
    primary = (tuple(cam.pos), (dx, dy, dz), dist, u, v, tri)

    def rays():
        ro3, rd3, rtm = fast.bounce_wavefront(scene, *primary)
        sd3, stm = fast.shadow_wavefront(scene, *primary,
                                         scene.lights.pos[1])
        return [*ro3, *rd3, rtm, *sd3, stm]

    planes = rays()
    monkeypatch.setattr(fast, "_surface", _whole_row_surface)
    rows = rays()
    assert int((planes[6] >= 0).sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip(planes, rows))
