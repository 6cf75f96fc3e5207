"""The port's walk path (a scene built with node tables, ``walk=True``:
B9a-d, plain versions in ``ops/traverse_ref.py``) against the JAX
package's interval-walk kernels, run in interpret mode on the CPU: B9 on
the flat scene and B10 on the two-level paged fixture of
``tests/test_paged_kernel.py:15-52``, both with their worklist leaf
tables cleared so that the JAX entry points take the walk
(``_wl_available`` False, asserted). Also the walk frames against the
JAX package's, a BVH deeper than the JAX oracle's 66-entry stack, the
node tables, and the walk's counter frame (B9e/B9f against JAX's
``camera_trace_stats`` / ``any_hit_shared_stats`` on the flat scene, the
counters against the simulation of every warp).

Scene: cornell at leaf 8 (34 triangles, 13 nodes; the paged fixture cuts
it into pages of 4 nodes), 64 x 64, seeded shadow and bounce rays. Each
JAX call runs once per module."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snail_tpu.bvh import build_bvh
from snail_tpu.bvh.build import BVH as JBVH
from snail_tpu.bvh.pages import partition_pages
from snail_tpu.core.types import Camera as JCamera
from snail_tpu.core.types import Light as JLight
from snail_tpu.core.types import RenderOpts as JRenderOpts
from snail_tpu.ops import traverse_pallas as tp
from snail_tpu.render.fast import render_frame_fast as j_render_frame_fast
from snail_tpu.scene.base_scene import FlatGeometry as JFlatGeometry
from snail_tpu.scene.materials import MaterialTable as JMaterialTable
from snail_tpu.scene.procedural import cornell_scene
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.bvh import BVH
from snail_tpu_torch.bvh import build_bvh as p_build_bvh
from snail_tpu_torch.core.types import Camera, RenderOpts
from snail_tpu_torch.core.vecmath import BIG
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.ops.intersect import (intersect_any_brute_force,
                                           intersect_brute_force)
from snail_tpu_torch.ops.traverse_ref import (LANE_BINS, TALLY, _tiles,
                                              _warp_signs, closest_g_sim,
                                              fat_shadow_g_plain,
                                              shadow_g_sim,
                                              walk_camera_plain,
                                              walk_camera_stats_plain,
                                              walk_closest_g_plain,
                                              walk_plain,
                                              walk_shadow_g_plain,
                                              walk_shadow_plain,
                                              walk_shadow_stats_plain)
from snail_tpu_torch.render.fast import (render_frame_fast,
                                         render_frame_fast_stats,
                                         shadow_wavefront,
                                         stats_path_available)
from snail_tpu_torch.scene.bench_scenes import scene_10m
from snail_tpu_torch.scene.base_scene import FlatGeometry
from snail_tpu_torch.scene.scene import (make_traced_scene,
                                         traced_scene_from_numpy)

W = H = 64
LIGHT = ((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0)
POS, TARGET = (0.0, 2.0, 6.0), (0.0, 1.5, 0.0)
FIELDS = ("node_lo", "node_hi", "node_child", "node_count", "node_axis",
          "node_first", "tri_a", "tri_ba", "tri_ca", "sh_mat", "sh_pack",
          "mat_pack", "mat_diffuse", "mat_specular", "mat_reflect",
          "mat_dissolve")
NO_WL = dict(wl_boxrows=None, wl_lfc=None, lf_boxv=None)


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


def _walk_only(js):
    """The JAX scene with its worklist leaf tables cleared: its entry
    points take the interval-walk kernels."""
    js = dataclasses.replace(js, **NO_WL)
    assert not tp._wl_available(js)
    return js


def _scenes(bounce: bool):
    """(JAX flat walk scene, JAX paged walk scene, port walk scene, JAX
    camera, port camera) on one BVH; with ``bounce``, material 0
    reflective and half transparent."""
    g = cornell_scene().flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=8)
    mats = None
    if bounce:
        mats = JMaterialTable.build({"": 0}, [])
        mats.reflectivity[0] = 0.5
        mats.dissolve[0] = 0.5
    js = j_make_traced_scene(g, bvh, mats, lights=JLight.make(*LIGHT))
    assert js.pg_meta is None
    # the paged fixture of tests/test_paged_kernel.py:33-50
    layout = partition_pages(bvh, page_cap=4)
    assert layout.n_pages > 1
    pm, pb = tp.page_kernel_layout(layout.pg_meta, layout.pg_box)
    mk_boxv, mk_off = tp.build_mask_boxv(layout.top_box, pb, layout.page_cap)
    paged = dataclasses.replace(
        js, pk_meta=jnp.asarray(layout.top_meta),
        pk_box=jnp.asarray(layout.top_box), pg_meta=jnp.asarray(pm),
        pg_box=jnp.asarray(pb), mk_boxv=jnp.asarray(mk_boxv), mk_off=mk_off,
        mk_cap=layout.page_cap)
    fields = {k: np.asarray(getattr(js, k)) for k in FIELDS}
    fields.update(light_pos=np.asarray(js.lights.pos),
                  light_color=np.asarray(js.lights.color),
                  light_radius=np.asarray(js.lights.radius))
    ps = traced_scene_from_numpy(fields, device="cpu", walk=True)
    assert ps.leaves is None and ps.nodes.n_nodes == bvh.num_nodes
    jcam = JCamera.look_at(pos=POS, target=TARGET)
    pcam = Camera(**{k: torch.from_numpy(np.array(getattr(jcam, k)))
                     for k in ("pos", "right", "up", "front", "plane_dist")})
    return _walk_only(js), _walk_only(paged), ps, jcam, pcam


@pytest.fixture(scope="module")
def scenes():
    return _scenes(bounce=False)


@pytest.fixture(scope="module", params=["flat", "paged"])
def jscene(request, scenes):
    """The JAX walk scene: flat (B9) or paged (B10)."""
    js, paged, _, _, _ = scenes
    return paged if request.param == "paged" else js


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_node_tables_hold_the_bvh():
    g = cornell_scene().flatten()
    lo, hi = g.bounds()
    bvh = p_build_bvh(lo, hi, leaf_size=8)
    ps = make_traced_scene(g, bvh, device="cpu", walk=True)
    assert ps.leaves is None and ps.depth == bvh.depth == ps.nodes.depth
    assert ps.nodes.stack_cap == bvh.depth + 2
    lo_, hi_, child, count, axis, first = ps.nodes.columns()
    np.testing.assert_array_equal(lo_.numpy(), bvh.node_lo)
    np.testing.assert_array_equal(hi_.numpy(), bvh.node_hi)
    for a, b in ((child, bvh.child), (count, bvh.count),
                 (first, bvh.first_node)):
        np.testing.assert_array_equal(a.numpy(), b)
    inner = bvh.count == 0
    np.testing.assert_array_equal(axis.numpy()[inner], bvh.axis[inner])
    # a leaf scene is unchanged: leaf tables, no node tables
    assert make_traced_scene(g, bvh, device="cpu").nodes is None


def test_walk_camera_trace_matches_jax(scenes, jscene):
    _, _, ps, jcam, pcam = scenes
    jd, ju, jv, jt, jdx, jdy, jdz = (np.asarray(a) for a in
                                     tp.camera_trace(jscene, jcam, W, H))
    pt.reset_launch_counts()
    pd, pu, pv, ptri, pdx, pdy, pdz = (a.numpy() for a in
                                       pt.camera_trace(ps, pcam, W, H))
    assert pt.launch_counts() == {k.__name__: 0 for k in pt.KERNELS}
    # tests/test_pallas.py:130-153
    np.testing.assert_allclose(pd, jd, rtol=2e-4, atol=2e-4)
    for a, b in ((pdx, jdx), (pdy, jdy), (pdz, jdz)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    hit = jd < BIG
    assert hit.mean() > 0.3 and (~hit).any()
    np.testing.assert_array_equal(ptri[~hit], -1)
    assert (ptri[hit] == jt[hit]).mean() > 0.999
    same = hit & (ptri == jt)
    np.testing.assert_allclose(pu[same], ju[same], atol=2e-3)
    np.testing.assert_allclose(pv[same], jv[same], atol=2e-3)


@pytest.fixture(scope="module")
def shadow_rays():
    """One packet of rays from the light to seeded points of the room."""
    rng = np.random.default_rng(3)
    tgt = rng.uniform((-2.0, 0.0, -2.0), (2.0, 3.0, 2.0),
                      (pt.PACKET_R, 3)).astype(np.float32)
    d = tgt - np.float32(LIGHT[0])
    ld = np.linalg.norm(d, axis=-1)
    tm = (ld * 0.9999).astype(np.float32)
    tm[::61] = -BIG
    return (d / ld[:, None]).astype(np.float32), tm


def test_walk_any_hit_shared_matches_jax(scenes, jscene, shadow_rays):
    _, _, ps, _, _ = scenes
    d, tm = shadow_rays
    lp = np.float32(LIGHT[0])
    jb = np.asarray(tp.any_hit_shared(
        jscene, jnp.asarray(lp), tuple(jnp.asarray(d[:, k]) for k in range(3)),
        jnp.asarray(tm)))
    pb = pt.any_hit_shared(ps, _t(lp), tuple(_t(d[:, k]) for k in range(3)),
                           _t(tm)).numpy()
    live = tm >= 0
    assert not pb[~live].any()
    assert 0.05 < pb[live].mean() < 0.95
    # tests/test_pallas.py:183-190
    assert (pb[live] == jb[live]).mean() > 0.999


@pytest.fixture(scope="module")
def bounce_rays():
    """500 seeded rays with their own origins in the room, every 20th
    masked with a garbage origin, some with a finite tmax."""
    rng = np.random.default_rng(7)
    n = 500
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[:, 1] += 1.5
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tm = np.full(n, BIG, np.float32)
    tm[1::9] = rng.uniform(0.5, 3.0, len(tm[1::9]))
    tm[::20] = -BIG
    o[::20] = 1e30
    return o, d, tm


def test_walk_closest_hit_c_matches_jax(scenes, jscene, bounce_rays):
    _, _, ps, _, _ = scenes
    o, d, tm = bounce_rays
    jd, ju, jv, jt = (np.asarray(a) for a in tp.closest_hit_c(
        jscene, tuple(jnp.asarray(o[:, k]) for k in range(3)),
        tuple(jnp.asarray(d[:, k]) for k in range(3)), jnp.asarray(tm)))
    pd, pu, pv, ptri = (a.numpy() for a in pt.closest_hit_c(
        ps, tuple(_t(o[:, k]) for k in range(3)),
        tuple(_t(d[:, k]) for k in range(3)), _t(tm)))
    big = np.float32(BIG)
    live = tm >= 0
    hit = live & (jd < big)
    assert 0.3 < hit.sum() / live.sum() < 1.0
    np.testing.assert_array_equal(pd[~live], -big)
    np.testing.assert_array_equal(jd[~live], -big)
    np.testing.assert_array_equal(pd[live & ~hit], big)
    np.testing.assert_array_equal(ptri[~hit], 0)
    np.testing.assert_allclose(pd[hit], jd[hit], rtol=2e-4, atol=2e-4)
    assert (ptri[hit] == jt[hit]).mean() > 0.999
    same = hit & (ptri == jt)
    np.testing.assert_allclose(pu[same], ju[same], atol=2e-3)
    np.testing.assert_allclose(pv[same], jv[same], atol=2e-3)
    assert (pd[hit] < tm[hit] * (1 + 1e-6)).all()


def test_walk_any_hit_c_matches_jax(scenes, jscene, bounce_rays):
    _, _, ps, _, _ = scenes
    o, d, _ = bounce_rays
    rng = np.random.default_rng(11)
    tm = rng.uniform(0.5, 4.0, len(o)).astype(np.float32)
    tm[::20] = -BIG
    jb = np.asarray(tp.any_hit_c(
        jscene, tuple(jnp.asarray(o[:, k]) for k in range(3)),
        tuple(jnp.asarray(d[:, k]) for k in range(3)), jnp.asarray(tm)))
    pb = pt.any_hit_c(ps, tuple(_t(o[:, k]) for k in range(3)),
                      tuple(_t(d[:, k]) for k in range(3)), _t(tm)).numpy()
    live = tm >= 0
    assert not pb[~live].any()
    assert 0.05 < pb[live].mean() < 0.95
    assert (pb[live] == jb[live]).mean() > 0.999


@pytest.mark.parametrize("bounce", [False, True], ids=["fwd", "bounce"])
def test_walk_frame_matches_jax(bounce):
    """render_frame_fast on the port's walk scene against the JAX
    package's on its walk scene (B9a, B9b and, with bounces, B9c)."""
    js, _, ps, jcam, pcam = _scenes(bounce)
    opts = dict(textures=False) if bounce else dict(
        reflections=False, transparency=False, textures=False)
    jimg = np.asarray(j_render_frame_fast(js, jcam, W, H,
                                          JRenderOpts(**opts)))
    pt.reset_launch_counts()
    pimg = render_frame_fast(ps, pcam, W, H, RenderOpts(**opts)).numpy()
    err = np.abs(pimg - jimg).max(-1)
    assert (err > 2e-3).mean() <= 1e-3, err.max()
    assert jimg.max() > 0.1


def _chain_bvh(n: int) -> tuple:
    """A BVH of depth n over n + 1 triangles on the z = 0 plane, one per
    level: inner node i holds the leaf of triangle i and the inner node
    of the rest, the inner child first for rays along +x, so that a walk
    keeps one far leaf per level on its stack. Returns (geometry, BVH)."""
    x = np.arange(n + 1, dtype=np.float32)
    a = np.stack([x, np.zeros_like(x), np.zeros_like(x)], 1)
    ba = np.tile(np.float32([0.9, 0.0, 0.0]), (n + 1, 1))
    ca = np.tile(np.float32([0.0, 0.9, 0.0]), (n + 1, 1))
    lo_t, hi_t = a, a + np.float32([0.9, 0.9, 0.0])
    nn = 2 * n + 1
    node_lo = np.zeros((nn, 3), np.float32)
    node_hi = np.zeros((nn, 3), np.float32)
    child = np.zeros(nn, np.int32)
    count = np.zeros(nn, np.int32)
    axis = np.zeros(nn, np.int32)
    first = np.zeros(nn, np.int32)
    inner = 0
    for i in range(n):
        left = 2 * i + 1  # the leaf of triangle i; right = left + 1
        node_lo[inner], node_hi[inner] = lo_t[i:].min(0), hi_t[i:].max(0)
        child[inner], first[inner] = left, 1  # near: the right, inner one
        node_lo[left], node_hi[left] = lo_t[i], hi_t[i]
        child[left], count[left] = i, 1
        inner = left + 1
    node_lo[inner], node_hi[inner] = lo_t[n], hi_t[n]
    child[inner], count[inner] = n, 1
    bvh = BVH(node_lo, node_hi, child, count, axis, first,
              np.arange(n + 1, dtype=np.int32), n)
    z = np.zeros((n + 1, 3), np.float32)
    up = z + np.float32([0.0, 0.0, 1.0])
    geom = FlatGeometry(
        a=a, ba=ba, ca=ca, nrm=up, t0=np.full(n + 1, 0.81, np.float32),
        uv0=z[:, :2], uv_e1=z[:, :2], uv_e2=z[:, :2], n0=up, n_e1=z, n_e2=z,
        mat_id=np.zeros(n + 1, np.int32))
    return geom, bvh


def test_deep_bvh_walk_matches_brute_force():
    """A BVH of depth 80 (> the JAX oracle's STACK_CAP of 66, ROADMAP C2):
    the plain walk sizes its stack from the tree and finds every hit of
    the brute force, closest and any-hit."""
    geom, bvh = _chain_bvh(80)
    ps = make_traced_scene(geom, bvh, device="cpu", walk=True)
    assert ps.nodes.depth == 80 and ps.nodes.stack_cap == 82
    rng = np.random.default_rng(5)
    r = 4 * pt.WARP
    tgt = np.stack([rng.uniform(0.0, 81.0, r), rng.uniform(0.05, 0.5, r),
                    np.zeros(r)], 1).astype(np.float32)
    # from below the plane: the one-sided shadow rule sees the triangles'
    # front faces (n = ba x ca is +z)
    o = np.float32([-5.0, 0.3, -3.0])
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    orig = np.broadcast_to(o, d.shape).copy()
    bd, btri, _ = intersect_brute_force(_t(orig), _t(d), ps.tri_a, ps.tri_ba,
                                        ps.tri_ca)
    hit = bd < BIG
    assert hit.float().mean() > 0.5
    work = {}
    best, tri, _, _ = walk_plain(
        ps.nodes, [_t(orig[:, k]) for k in range(3)],
        [_t(d[:, k]) for k in range(3)], torch.full((r,), BIG), ps.tri_rows,
        True, True, work)
    np.testing.assert_allclose(best[hit].numpy(), bd[hit].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(tri[hit].numpy(), btri[hit].numpy())
    assert (tri[~hit] == -1).all()
    assert work["entered"].sum() > 80
    # any-hit toward the plane: blocked where the brute force says so
    tm = torch.from_numpy(np.linalg.norm(tgt - o, axis=-1) * 1.01)
    blocked = walk_plain(ps.nodes, [_t(orig[:, k]) for k in range(3)],
                         [_t(d[:, k]) for k in range(3)], tm, ps.tri_rows,
                         True, False)
    ref = intersect_any_brute_force(_t(orig), _t(d), ps.tri_a, ps.tri_ba,
                                    ps.tri_ca, tm)
    assert torch.equal(blocked, ref) and ref.any()
    # the stack is the tree's: a shorter one overflows, and the walk raises
    small = dataclasses.replace(ps.nodes, depth=70)
    with pytest.raises(RuntimeError, match="stack overflow"):
        walk_plain(small, [_t(orig[:, k]) for k in range(3)],
                   [_t(d[:, k]) for k in range(3)], torch.full((r,), BIG),
                   ps.tri_rows, True, True)


def test_walk_counter_frame_raises():
    """The counter frame needs leaves of at most IVAL_LEAF triangles: on a
    fat-leaf node tree (cornell at leaf 64, one leaf of 34) it raises, as
    the JAX package asserts (camera_trace_stats :3655)."""
    g = cornell_scene().flatten()
    lo, hi = g.bounds()
    ps = make_traced_scene(g, p_build_bvh(lo, hi, leaf_size=64),
                           device="cpu", walk=True)
    assert ps.nodes.leaf_max > pt.IVAL_LEAF
    assert not stats_path_available(ps)
    pcam = Camera.look_at(pos=POS, target=TARGET, device="cpu")
    with pytest.raises(ValueError, match="IVAL_LEAF"):
        render_frame_fast_stats(ps, pcam, W, H)


def _assert_counters_hold(stats, work, closest):
    """Invariants of the walk's counters (csrc/walk.cuh WalkCounts) summed
    over packets, against the per-ray walk's ``work`` on the same rays:
    each (leaf, warp) pair holds between 1 and WARP of the (ray, leaf)
    tests, every leaf a warp enters was loaded, every pop loaded a node,
    and slots 5-7 stay 0."""
    tot = stats.sum(0, dtype=torch.int64)
    nodes, leaves, quarters, tri_blocks, chunks = (int(c) for c in tot[:5])
    assert (stats[:, 5:] == 0).all()
    assert nodes >= leaves >= quarters > 0 and nodes > chunks > 0
    assert tri_blocks <= work["tri"] <= pt.WARP * tri_blocks
    if closest:
        # every lane that enters a leaf tests all its triangles
        assert work["tri"] >= tri_blocks >= quarters


def test_walk_camera_trace_stats_matches_jax(scenes):
    """B9e: the outputs of JAX's ``camera_trace_stats`` on the flat walk
    scene (``_camera_ival_kernel_stats``), B9a's bit for bit, and counters
    equal to the simulation of every warp."""
    js, _, ps, jcam, pcam = scenes
    *jout, _ = tp.camera_trace_stats(js, jcam, W, H)
    jd, ju, jv, jt = (np.asarray(a) for a in jout[:4])
    *out, stats = pt.camera_trace_stats(ps, pcam, W, H)
    ref = pt.camera_trace(ps, pcam, W, H)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    pd, pu, pv, ptri = (a.numpy() for a in out[:4])
    np.testing.assert_allclose(pd, jd, rtol=2e-4, atol=2e-4)
    hit = jd < BIG
    assert hit.mean() > 0.3
    assert (ptri[hit] == jt[hit]).mean() > 0.999
    same = hit & (ptri == jt)
    np.testing.assert_allclose(pu[same], ju[same], atol=2e-3)
    assert stats.shape == (1, 8) and stats.dtype == torch.int32
    cam, rows = pt._camera_vec(ps, pcam, W, H), ps.tri_rows
    *_, sim = walk_camera_stats_plain(cam, W, H, rows, ps.nodes,
                                      torch.arange(1))
    assert torch.equal(stats, sim)
    work = {}
    walk_camera_plain(cam, W, H, rows, ps.nodes, torch.arange(1), work)
    _assert_counters_hold(stats, work, True)


def test_walk_camera_warps_are_pixel_tiles(scenes):
    """B9a's (and B9e's) warps are 8 x 4 pixel tiles, each with the
    near-child signs of its live rays: ``walk_camera_plain`` equals the
    per-ray walk given those signs, the tiles found from the pixels'
    coordinates, bit for bit, ties included, and the simulation of the
    warps behind ``walk_camera_stats_plain`` gives the same outputs. On
    this frame the signs of 32 consecutive rays differ from the tiles'."""
    _, _, ps, _, pcam = scenes
    w, h = 128, 64
    cam, rows = pt._camera_vec(ps, pcam, w, h), ps.tri_rows
    pids = torch.arange(2)
    d, idir, t_exit = pt._camera_rays(cam, w, h, pids)
    px, py = pt._pixel_xy(w, h, pids, "cpu")
    tile = ((py // 4) * (w // 8) + px // 8).reshape(-1)
    live = t_exit.reshape(-1) > 0.0
    n = int(tile.max()) + 1
    signs = []
    for c in (c.reshape(-1) for c in idir):
        lo = torch.full((n,), BIG).scatter_reduce(
            0, tile, torch.where(live, c, BIG), "amin")
        hi = torch.full((n,), -BIG).scatter_reduce(
            0, tile, torch.where(live, c, -BIG), "amax")
        signs.append((lo + hi < 0.0)[tile].long())
    signs = torch.stack(signs, 1)
    assert not torch.equal(signs, _warp_signs([c.reshape(-1) for c in idir],
                                              live))
    best, tri, u, v = walk_plain(ps.nodes, cam[9:12].unbind(),
                                 [c.reshape(-1) for c in d],
                                 t_exit.reshape(-1), rows, True, True,
                                 signs=signs)
    want = (torch.where(tri >= 0, best, BIG), u, v, tri.to(torch.int32))
    got = walk_camera_plain(cam, w, h, rows, ps.nodes, pids)
    assert bool((got[3] >= 0).any()) and bool((got[3] < 0).any())
    assert all(torch.equal(a.reshape(-1), b) for a, b in zip(got, want))
    *sim, stats = walk_camera_stats_plain(cam, w, h, rows, ps.nodes, pids)
    assert all(torch.equal(a, b) for a, b in zip(sim, got))
    work = {}
    walk_camera_plain(cam, w, h, rows, ps.nodes, pids, work)
    _assert_counters_hold(stats, work, True)


def test_walk_any_hit_shared_stats_matches_jax(scenes, shadow_rays):
    """B9f: JAX's ``any_hit_shared_stats`` verdicts on the flat walk scene,
    B9b's bit for bit, and counters equal to the simulation."""
    js, _, ps, _, _ = scenes
    d, tm = shadow_rays
    lp = np.float32(LIGHT[0])
    jb, _ = tp.any_hit_shared_stats(
        js, jnp.asarray(lp), tuple(jnp.asarray(d[:, k]) for k in range(3)),
        jnp.asarray(tm))
    jb = np.asarray(jb)
    args = (_t(lp), tuple(_t(d[:, k]) for k in range(3)), _t(tm))
    pb, stats = pt.any_hit_shared_stats(ps, *args)
    assert torch.equal(pb, pt.any_hit_shared(ps, *args))
    pb = pb.numpy()
    live = tm >= 0
    assert not pb[~live].any() and 0.05 < pb[live].mean() < 0.95
    assert (pb[live] == jb[live]).mean() > 0.999
    rows = ps.tri_rows
    pk = lambda a: _t(a).reshape(-1, pt.PACKET_R)
    blocked, sim = walk_shadow_stats_plain(
        _t(lp), tuple(pk(d[:, k]) for k in range(3)), pk(tm), rows, ps.nodes)
    assert torch.equal(stats, sim)
    np.testing.assert_array_equal(blocked.numpy().reshape(-1) > 0, pb)
    work = {}
    walk_plain(ps.nodes, _t(lp).unbind(), [_t(d[:, k]) for k in range(3)],
               torch.where(_t(tm) >= 0, _t(tm), -BIG), rows, True, False,
               work)
    _assert_counters_hold(stats, work, False)


def test_walk_counter_frame_matches_fwd_frame(scenes):
    """The walk's counter frame: the walk fwd frame's image bit for bit,
    the counters of its primary wavefront and its light's shadow
    wavefront (B9e + B9f), and every ray counted."""
    _, _, ps, _, pcam = scenes
    assert stats_path_available(ps)
    opts = RenderOpts(reflections=False, transparency=False, textures=False)
    img, st = render_frame_fast_stats(ps, pcam, W, H, opts)
    assert torch.equal(img, render_frame_fast(ps, pcam, W, H, opts))
    assert st["rays"] == W * H * 2
    assert st["nodes"] >= st["leaves"] >= st["quarters"] > 0
    assert st["tri_blocks"] >= st["quarters"] and st["chunks"] > 0
    *_, primary = pt.camera_trace_stats(ps, pcam, W, H)
    assert st["nodes"] > int(primary[:, 0].sum())  # the shadow rays count


@pytest.fixture(scope="module")
def terrain():
    """bench.py's 10 Mtri terrain at n = 24 (1,216 rows) on node tables,
    its camera vector for a 64 x 64 view frame, and the planes (d, tm) of
    that frame's shadow rays toward a low light (-80, 20, 0), which leaves
    some of the lit terrain in shadow."""
    scene, cam = scene_10m(24, device="cpu", walk=True)[:2]
    assert pt.walks(scene) and not pt.is_fat(scene)
    cv = pt._camera_vec(scene, cam, W, H)
    dist, u, v, tri, dx, dy, dz = pt.camera_trace(scene, cam, W, H)
    lp = torch.tensor((-80.0, 20.0, 0.0))
    d3, tm = shadow_wavefront(scene, tuple(cam.pos), (dx, dy, dz), dist, u,
                              v, tri, lp)
    orig, d, tm, _ = pt._light_planes(lp, d3, tm)
    return scene, cv, orig, d, tm


@pytest.mark.parametrize("kernel", ["B9a", "B9b", "B9e", "B9f"])
def test_walk_raw_rows_match_shared_rows(terrain, kernel):
    """B9a, B9b and their counting twins B9e, B9f test the raw triangle
    rows with the full Moller test from their shared origin: the plain
    walk on the raw rows (``walk_plain(..., raw=True)``; the simulation
    of the warps for B9e/B9f) gives exactly what it gives on the
    shared-origin rows of the same origin (``shared_rows``), outputs and
    counters, since the table computes the origin's terms with the raw
    test's products and sums in the same order; and the plain versions
    of the kernels, on the raw rows, give the same. On the terrain's view
    frame some rays hit and some miss, and some live shadow rays are
    blocked and some not."""
    from test_torch_cuda import plain_walk, walk_wave

    scene, cv, light, d, tm = terrain
    camera = kernel in ("B9a", "B9e")
    origin = cv[9:12] if camera else light
    dirs, bound0 = walk_wave(kernel, cv, W, H, origin, d, tm)
    table = pt.shared_rows(scene.tri_rows, origin)
    raw, shared = (plain_walk(kernel, scene.nodes, rows, form, origin, dirs,
                              bound0)
                   for rows, form in ((scene.tri_rows, True), (table, False)))
    assert all(torch.equal(a, b) for a, b in zip(raw, shared))
    pids = torch.arange(1)
    if camera:
        tri = raw[1]
        assert bool((tri >= 0).any()) and bool((tri < 0).any())
        fn = walk_camera_plain if kernel == "B9a" else walk_camera_stats_plain
        got = fn(cv, W, H, scene.tri_rows, scene.nodes, pids)
        assert torch.equal(_tiles(got[3], pt.camera_wl_order()),
                           tri.to(torch.int32))
    else:
        blocked = raw[0]
        live = bound0 > 0.0
        assert 0.02 < float(blocked[live].float().mean()) < 0.98
        fn = walk_shadow_plain if kernel == "B9b" else walk_shadow_stats_plain
        got = fn(light, d, tm, scene.tri_rows, scene.nodes)
        got = got if kernel == "B9f" else (got,)
        assert torch.equal(got[0].reshape(-1) > 0, blocked)
    if kernel in ("B9e", "B9f"):
        assert torch.equal(got[-1], raw[-1])


def _packet_rays(lo, hi, n_packets, seed):
    """``n_packets`` packets of seeded rays with their own origins as the
    (o, d, tm) planes of B9c/B11b: each warp's rays leave points near a
    seeded point of the box [lo, hi] (spread 1 % of the box in packet 0,
    30 % in the others) within a cone around a seeded direction, so that
    a leaf visit has from one to all 32 lanes entering; every 9th ray is
    masked with a garbage origin, every 5th live one has a finite tmax."""
    rng = np.random.default_rng(seed)
    nw, ext = n_packets * pt.WARPS, hi - lo
    spread = np.where(np.arange(nw) < pt.WARPS, 0.01, 0.3)[:, None, None]
    o = (rng.uniform(lo, hi, (nw, 1, 3))
         + rng.uniform(-1.0, 1.0, (nw, pt.WARP, 3)) * spread * ext)
    d = rng.normal(size=(nw, 1, 3)) + rng.normal(size=(nw, pt.WARP, 3)) * 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    tm = np.full(len(o), BIG)
    tm[1::5] = rng.uniform(0.5, 3.0, len(tm[1::5])) * float(ext.max())
    tm[::9] = -BIG
    o[::9] = 1e30
    pk = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float32).reshape(n_packets, -1))
    return (tuple(pk(o[:, k]) for k in range(3)),
            tuple(pk(d[:, k]) for k in range(3)), pk(tm))


def _assert_tally_holds(tally, stats):
    """The tally of a closest-hit warp walk against its counters, int32
    (P, 8): node steps are the ``nodes`` slot and leaf visits the
    ``quarters`` slot, summed over each packet's warps; the visits by
    entering lanes sum to the visits; each visit has 1-32 entering lanes
    and tests its leaf's rows (``tri_blocks``, a closest hit's)."""
    t = dict(zip(TALLY, tally))
    packet = lambda x: x.reshape(-1, pt.WARPS).sum(1)
    assert torch.equal(packet(t["nodes"]), stats[:, 0].long())
    assert torch.equal(packet(t["visits"]), stats[:, 2].long())
    assert torch.equal(packet(t["rows"]), stats[:, 3].long())
    assert torch.equal(sum(t[b] for b in LANE_BINS), t["visits"])
    assert (t["visits"] <= t["lanes"]).all()
    assert (t["lanes"] <= pt.WARP * t["visits"]).all()
    # both ways of testing a leaf occur: few lanes and many
    assert int(t["1"].sum()) > 0 and int(t["17-32"].sum()) > 0


def test_walk_closest_tally_matches_counters(scenes):
    """B9c's warps simulated (``closest_g_sim``, each warp's own signs):
    their outputs are the plain B9c's bit for bit, and their tally holds
    against their counters."""
    _, _, ps, _, _ = scenes
    o, d, tm = _packet_rays(ps.root_lo.numpy(), ps.root_hi.numpy(), 2, 13)
    out, stats, tally = closest_g_sim(o, d, tm, ps.tri_rows, ps.nodes)
    plain = walk_closest_g_plain(o, d, tm, ps.tri_rows, ps.nodes)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    live = tm >= 0
    assert 0.2 < float((out[0][live] < BIG).float().mean()) < 1.0
    assert stats.shape == (2, 8) and tally.shape == (len(TALLY),
                                                     2 * pt.WARPS)
    _assert_tally_holds(tally, stats)


def _shadow_g_rays(lo, hi, light, seed):
    """Three half packets of shadow rays with their own origins, flat (R,
    3) / (R,) numpy: the first from ``light`` toward seeded points of the
    box [lo, hi], each with a tmax just short of its point (an instanced
    frame's shadow wavefront: one origin), the others from near seeded
    points of the box in a cone (scattered warps), tmax a seeded share of
    the box; every 9th ray masked with a garbage origin."""
    rng = np.random.default_rng(seed)
    n = pt.PACKET_R // 2
    tgt = rng.uniform(lo, hi, (n, 3))
    d0 = tgt - np.float64(light)
    t0 = np.linalg.norm(d0, axis=-1)
    o1 = (rng.uniform(lo, hi, (2 * n // pt.WARP, 1, 3))
          + rng.uniform(-0.1, 0.1, (2 * n // pt.WARP, pt.WARP, 3))
          * (hi - lo)).reshape(-1, 3)
    d1 = rng.normal(size=(2 * n, 3)) * 0.3 + rng.normal(size=3)
    o = np.concatenate([np.broadcast_to(light, (n, 3)), o1])
    d = np.concatenate([d0 / t0[:, None],
                        d1 / np.linalg.norm(d1, axis=-1, keepdims=True)])
    tm = np.concatenate([t0 * 0.9999, rng.uniform(0.05, 0.6, 2 * n)
                         * float(np.linalg.norm(hi - lo))])
    tm[::9] = -BIG
    o[::9] = 1e30
    f = lambda a: np.ascontiguousarray(a, np.float32)
    return f(o), f(d), f(tm)


def _assert_shadow_tally_holds(tally, stats, blocked, live):
    """The tally of an any-hit warp walk (``shadow_g_sim``) against its
    counters, int32 (P, 8), and its verdicts ``blocked`` on the ``live``
    rays: node steps are the ``nodes`` slot, leaf visits the ``quarters``
    slot and the most rows a lane tested the ``tri_blocks`` slot, summed
    over each packet's warps; the visits by entering lanes sum to the
    visits; an entering lane tests at least one row of its leaf and never
    more than the leaf's rows, some stop early; each blocked ray is
    blocked in one visit."""
    t = dict(zip(TALLY, tally))
    packet = lambda x: x.reshape(-1, pt.WARPS).sum(1)
    assert torch.equal(packet(t["nodes"]), stats[:, 0].long())
    assert torch.equal(packet(t["visits"]), stats[:, 2].long())
    assert torch.equal(packet(t["most"]), stats[:, 3].long())
    assert torch.equal(sum(t[b] for b in LANE_BINS), t["visits"])
    assert ((t["visits"] <= t["lanes"])
            & (t["lanes"] <= pt.WARP * t["visits"])).all()
    assert ((t["lanes"] <= t["tested"]) & (t["tested"] <= t["lane_rows"])
            & (t["most"] <= t["rows"]) & (t["blocked"] <= t["lanes"])).all()
    assert int(t["tested"].sum()) < int(t["lane_rows"].sum())
    assert int(t["blocked"].sum()) == int(blocked[live].sum())
    assert int(t["1"].sum()) > 0 and int(t["17-32"].sum()) > 0


def test_walk_shadow_tally_matches_plain(scenes):
    """B9d's warps simulated (``shadow_g_sim``, each warp's own signs) on
    shadow rays from one light and on scattered ones: their verdicts are
    the plain B9d's bit for bit and the JAX package's ``any_hit_c``'s on
    the flat walk scene (B9 in interpret mode), and their tally holds
    against their counters and verdicts."""
    js, _, ps, _, _ = scenes
    o, d, tm = _shadow_g_rays(ps.root_lo.numpy(), ps.root_hi.numpy(),
                              LIGHT[0], 19)
    jb = np.asarray(tp.any_hit_c(
        js, tuple(jnp.asarray(o[:, k]) for k in range(3)),
        tuple(jnp.asarray(d[:, k]) for k in range(3)), jnp.asarray(tm)))
    po, pd, ptm, n = pt.general_planes(tuple(_t(o[:, k]) for k in range(3)),
                                       tuple(_t(d[:, k]) for k in range(3)),
                                       _t(tm))
    blocked, stats, tally = shadow_g_sim(po, pd, ptm, ps.tri_rows, ps.nodes)
    assert torch.equal(blocked, walk_shadow_g_plain(po, pd, ptm, ps.tri_rows,
                                                    ps.nodes))
    pb = blocked.reshape(-1)[:n].numpy() > 0
    live = tm >= 0
    assert not pb[~live].any()
    assert 0.05 < pb[live].mean() < 0.95
    np.testing.assert_array_equal(pb, jb)
    assert stats.shape == (2, 8) and tally.shape == (len(TALLY),
                                                     2 * pt.WARPS)
    _assert_shadow_tally_holds(tally, stats, blocked, ptm >= 0)


@pytest.mark.parametrize("kind", ["walk", "fat"])
def test_lane_scene_any_hit_matches_jax(kind):
    """The plain any-hit, B9d's on leaves of 1, 31 and 32 rows or B11d's
    on leaves of 33, 63 and 64, on the staged-leaf card tests' scene and
    rays (tests/test_torch_cuda.py ``_blocker_fields``: each leaf's only
    blocker in its last row; ``_blocker_rays``: 1 to 32 lanes of a warp
    aimed at a leaf, tmax short of, at the edge of and past the blocker,
    lanes running on into the next leaf, masked rays with garbage planes,
    live misses) against the JAX package's ``any_hit_c`` on the same
    geometry and tree (the interval walk, or the fat-leaf kernel, in
    interpret mode): verdicts identical, and the ones the rays must get;
    the simulation's verdicts the plain version's."""
    from test_torch_cuda import (STAGED_LEAVES, _blocker_fields,
                                 _blocker_rays, _traced)

    sizes = STAGED_LEAVES[kind]
    fields = _blocker_fields(sizes, -1)
    ps = _traced(fields, "cpu")
    geom, bvh = fields
    js = j_make_traced_scene(JFlatGeometry(**geom), JBVH(**bvh))
    js = _walk_only(js) if kind == "walk" else js
    assert pt.is_fat(ps) == (kind == "fat") and ps.nodes.leaf_max == max(sizes)
    o, d, tm, want = _blocker_rays(len(sizes))
    signs = pt.packet_signs(d) if kind == "fat" else None
    if signs is None:
        plain = walk_shadow_g_plain(o, d, tm, ps.tri_rows, ps.nodes)
    else:
        plain = fat_shadow_g_plain(o, d, tm, signs, ps.tri_rows, ps.nodes)
    assert torch.equal(plain > 0, want)
    sim = shadow_g_sim(o, d, tm, ps.tri_rows, ps.nodes, signs)[0]
    assert torch.equal(sim, plain)
    flat = lambda c: jnp.asarray(c.reshape(-1).numpy())
    jb = np.asarray(tp.any_hit_c(js, tuple(map(flat, o)),
                                 tuple(map(flat, d)), flat(tm)))
    np.testing.assert_array_equal(jb, want.reshape(-1).numpy())
