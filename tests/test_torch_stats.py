"""The counter frame (B8a/B8b) against the JAX package's
render_frame_fast_stats (Pallas kernels in interpret mode on the CPU), the
invariants of the per-packet counters, a frame whose counts follow by hand,
and the TreeStats conversion.

The counters count what the port's warps do, not the TPU's structures, so
only the image and ``rays`` are held equal to the JAX package's; the
counts themselves are held to their definitions (``ops.traverse.STATS``)."""

import numpy as np
import pytest
import torch

from snail_tpu.bvh import build_bvh
from snail_tpu.core.types import Camera as JCamera
from snail_tpu.core.types import Light as JLight
from snail_tpu.core.types import RenderOpts as JRenderOpts
from snail_tpu.render.fast import \
    render_frame_fast_stats as j_render_frame_fast_stats
from snail_tpu.scene import procedural as jproc
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.bvh import build_bvh as p_build_bvh
from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.render.fast import (_shadow_rays, _surface,
                                         _toward_light,
                                         render_frame_fast_stats,
                                         stats_path_available)
from snail_tpu_torch.render.renderer import render_frame
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene.base_scene import BaseScene
from snail_tpu_torch.scene.scene import make_traced_scene
from snail_tpu_torch.utils.stats import TreeStats, tree_stats_from_counters

OPTS = dict(reflections=False, transparency=False, textures=False)
LIGHT = ((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0)
POS, TARGET = (0.0, 2.0, 6.0), (0.0, 1.5, 0.0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The warp simulations here are Python loops of small tensor ops. On
    a machine whose cores other test workers keep busy, PyTorch's
    intra-op thread pool makes each of them wait (a simulation took over
    200 s there against 3 s on one thread), so they run on one thread;
    the results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stats_frame_matches_render_frame_and_jax():
    """The cornell golden configuration at 64 x 64: the port's counter
    frame is its forward frame bit for bit, and within 2e-3 of the JAX
    package's counter frame, with the same keys and ray count."""
    g = jproc.cornell_scene().flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=8)
    js = j_make_traced_scene(g, bvh, lights=JLight.make(*LIGHT))
    ps = make_traced_scene(pproc.cornell_scene().flatten(), bvh,
                           lights=Light.make(*LIGHT, device="cpu"),
                           device="cpu")
    assert stats_path_available(ps)
    jimg, jst = j_render_frame_fast_stats(
        js, JCamera.look_at(pos=POS, target=TARGET), 64, 64,
        JRenderOpts(**OPTS))
    cam = Camera.look_at(pos=POS, target=TARGET, device="cpu")
    img, st = render_frame_fast_stats(ps, cam, 64, 64, RenderOpts(**OPTS))
    assert torch.equal(img, render_frame(ps, cam, 64, 64, RenderOpts(**OPTS)))
    err = np.abs(img.numpy() - np.asarray(jimg)).max(-1)
    # atol 2e-3 (tests/test_photon_render.py:130); pixels beyond it are
    # hit ties (ROADMAP C7)
    assert (err > 2e-3).mean() <= 2e-3, err.max()
    assert set(st) == set(jst) and st["rays"] == jst["rays"] == 2 * 64 * 64
    assert all(isinstance(v, int) for v in st.values())
    assert st["tri_blocks"] > 0 and st["leaves"] > 0


@pytest.fixture(scope="module")
def city():
    g = pproc.city_scene(4).flatten()
    lo, hi = g.bounds()
    bvh = p_build_bvh(lo, hi, leaf_size=8)
    scene = make_traced_scene(
        g, bvh, lights=Light.make((0.0, 30.0, 0.0), (1.0, 1.0, 1.0), 120.0,
                                  device="cpu"), device="cpu")
    c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
    ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
    cam = Camera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9]) * ext),
                         target=tuple(c), device="cpu")
    return scene, cam


def _check_invariants(stats, words):
    """Per packet: every warp reads at most the packet's populated words and
    keeps at most their set bits; a (leaf, warp) pair that intersects
    tests at least one triangle; a warp enters at most every band."""
    bits = pt.unpack_bits(words).sum((1, 2))
    populated = words.ne(0).sum((1, 2))
    nodes, leaves, quarters, tri_blocks, chunks = stats[:, :5].T
    assert stats.dtype == torch.int32 and stats.shape[1] == 8
    assert (stats[:, 5:] == 0).all()
    assert (nodes <= pt.WARPS * populated).all()
    assert (leaves <= pt.WARPS * bits).all()
    assert (quarters <= leaves).all() and (tri_blocks >= quarters).all()
    assert (chunks <= pt.WARPS * words.shape[1]).all()
    assert (stats >= 0).all() and (nodes > 0).any() and (quarters > 0).any()


def test_camera_counters_invariants(city):
    scene, cam = city
    w = h = 128
    cv, words, summ, floors = pt._camera_words(scene, cam, w, h)
    *out, stats = pt.camera_wl_stats(cv, w, h,
                                     pt.shared_rows(scene.tri_rows, cam.pos),
                                     scene.leaves, words, summ, floors)
    ref = pt.camera_wl(cv, w, h, scene.tri_rows, scene.leaves, words, summ,
                       floors)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert stats.shape == (4, 8)
    _check_invariants(stats, words)


def test_shadow_counters_invariants(city):
    scene, cam = city
    w = h = 128
    dist, u, v, tri, dx, dy, dz = pt.camera_trace(scene, cam, w, h)
    o3 = (cam.pos[0], cam.pos[1], cam.pos[2])
    hit, _, n3, p3 = _surface(scene, o3, (dx, dy, dz), dist, u, v, tri)
    lp = scene.lights.pos[0]
    fl3, ldist, _, mask = _toward_light(p3, n3, hit, lp)
    d3, tm = _shadow_rays(fl3, ldist, mask)
    orig, d, tm, n, words, summ, floors = pt._shared_planes(scene, lp, d3,
                                                            tm)
    blocked, stats = pt.shadow_wl_stats(orig, d, tm,
                                        pt.shared_rows(scene.tri_rows, orig),
                                        scene.leaves, words, summ, floors)
    assert torch.equal(blocked, pt.shadow_wl(orig, d, tm, scene.tri_rows,
                                             scene.leaves, words, summ,
                                             floors))
    live = tm >= 0
    assert 0.02 < float(blocked[live].mean()) < 0.98
    _check_invariants(stats, words)
    # a warp tests at most the triangles of the packet's leaves, and culls
    # leaves and stops at its first blocker, so tests fewer in all
    tris = (scene.leaves.count * pt.unpack_bits(words).any(1)).sum(1)
    assert (stats[:, 3] <= pt.WARPS * tris).all()
    assert int(stats[:, 3].sum()) < pt.WARPS * int(tris.sum())


def test_hand_counted_quad():
    """One 2-triangle quad filling a 64 x 64 frame, no lights: the one
    leaf lies in the last of the 8 bands (every band edge is the leaf's own
    entry distance), so each of the packet's 128 warps enters 1 band, reads
    1 word, keeps 1 leaf, intersects it and tests its 2 triangles."""
    base = BaseScene()
    base.objects.append(pproc._obj_from_tris(pproc._quad(
        (-10.0, -10.0, 0.0), (10.0, -10.0, 0.0), (10.0, 10.0, 0.0),
        (-10.0, 10.0, 0.0))))
    g = base.flatten()
    lo, hi = g.bounds()
    scene = make_traced_scene(g, p_build_bvh(lo, hi, leaf_size=8),
                              device="cpu")
    assert scene.leaves.n_leaf == 1 and int(scene.leaves.count[0]) == 2
    cam = Camera.look_at(pos=(0.5, -0.25, 5.0), target=(0.5, -0.25, 0.0),
                         device="cpu")
    img, st = render_frame_fast_stats(scene, cam, 64, 64, RenderOpts(**OPTS))
    assert float(img.min()) > 0.0  # every pixel sees the quad
    assert st == {"nodes": 128, "leaves": 128, "quarters": 128,
                  "tri_blocks": 256, "chunks": 128, "rays": 64 * 64}
    ts = tree_stats_from_counters(st, 0)
    assert ts.intersects == 256 * 32 == 2 * 64 * 64 and ts.runs == 1


def test_tree_stats_from_counters():
    st = {"nodes": 1500, "leaves": 900, "quarters": 700, "tri_blocks": 2000,
          "chunks": 300, "rays": 3 * 64 * 64}
    ts = tree_stats_from_counters(st, 2)
    assert ts == TreeStats(intersects=2000 * pt.RAYS_PER_TRI_BLOCK,
                           loop_iters=1500, rays=3 * 64 * 64, runs=3)
    assert ts.gen_info(2.0, 6.1) == "in:64k it:1k ms:2.00 MRays/s:6.1"
    ts += ts
    assert ts.to_dict()["rays"] == 6 * 64 * 64
