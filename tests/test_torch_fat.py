"""The port's fat-leaf path (a BVH whose leaves hold 33-64 triangles: node
tables, B11a-d, plain versions in ``ops/traverse_ref.py``) against the JAX
package's round-1 fat-leaf kernels, run in interpret mode on the CPU.

A JAX scene built at leaf 64 gets no worklist leaf tables and no pages
(``_wl_available`` False, ``pg_meta`` None, ``leaf_max`` > 32, asserted),
so its entry points take ``_camera_kernel``, ``_closest_kernel``,
``_shadow_kernel`` and ``_shadow_kernel_g``. The port's scene is made
from the JAX scene's arrays. Tolerances are ROADMAP A0's: dist allclose,
tri equal except on distance ties (C7), verdicts identical, images atol
2e-3.

Scene: city_scene(8) at leaf 64 (638 triangles, 31 nodes, leaves of up
to 58), the bench light and camera; 128 x 64 primary rays, 64 x 64
frames, 80 x 48 portable frames, seeded rays with masked rays (ray 0 of
a packet among them) and finite tmax. Each JAX call runs once per
module."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snail_tpu.bvh import build_bvh
from snail_tpu.core.types import Camera as JCamera
from snail_tpu.core.types import Light as JLight
from snail_tpu.core.types import RenderOpts as JRenderOpts
from snail_tpu.ops import traverse_pallas as tp
from snail_tpu.render.fast import render_frame_fast as j_render_frame_fast
from snail_tpu.render.fast import \
    render_frame_fast_diff as j_render_frame_fast_diff
from snail_tpu.render.renderer import render_frame as j_render_frame
from snail_tpu.scene import instancing as jinst
from snail_tpu.scene.materials import MaterialTable as JMaterialTable
from snail_tpu.scene.procedural import city_scene
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.bvh import BVH
from snail_tpu_torch.bvh import build_bvh as p_build_bvh
from snail_tpu_torch.core.types import Camera, RenderOpts
from snail_tpu_torch.core.vecmath import BIG
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.ops.traverse_ref import (LANE_BINS, TALLY,
                                              _ray_signs, closest_g_sim,
                                              fat_camera_plain,
                                              fat_closest_plain,
                                              fat_shadow_g_plain,
                                              fat_shadow_plain,
                                              shadow_g_sim, walk_plain)
from snail_tpu_torch.render.fast import (render_frame_fast,
                                         render_frame_fast_diff,
                                         render_frame_fast_stats,
                                         stats_path_available)
from snail_tpu_torch.render.renderer import render_frame
from snail_tpu_torch.scene import instancing as pinst
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene.bench_scenes import (GRAD_PARAMS, STEP_OPTS,
                                                bench_step, bounce_materials,
                                                grad_params, with_params)
from snail_tpu_torch.scene.scene import (make_traced_scene,
                                         traced_scene_from_numpy)

N, LEAF = 8, 64
LIGHT = ((0.0, 30.0, 0.0), (1.0, 1.0, 1.0), 120.0)
MOVED = (6.0, 26.0, 4.0)  # the diff step's target light
OFFSET = np.array([0.45, 0.35, 0.9])  # the bench camera's
FIELDS = ("node_lo", "node_hi", "node_child", "node_count", "node_axis",
          "node_first", "tri_a", "tri_ba", "tri_ca", "sh_mat", "sh_pack",
          "mat_pack", "mat_diffuse", "mat_specular", "mat_reflect",
          "mat_dissolve")
FWD = dict(reflections=False, transparency=False, textures=False)
BOUNCE = dict(textures=False)
W, H = 64, 64


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


def _scenes(bounce: bool):
    """(JAX scene, port scene, JAX camera, port camera) on one leaf-64
    BVH; with ``bounce``, material 0 reflective and half transparent."""
    g = city_scene(N).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=LEAF)
    mats = None
    if bounce:
        mats = JMaterialTable.build({"": 0}, [])
        mats.reflectivity[0] = 0.5
        mats.dissolve[0] = 0.5
    js = j_make_traced_scene(g, bvh, mats, lights=JLight.make(*LIGHT),
                             backend="pallas")
    # the JAX package's fat-leaf path: flat node tables, no leaf tables
    assert js.leaf_max > tp.IVAL_LEAF and not tp._wl_available(js)
    assert js.pg_meta is None and js.pk_meta is not None
    fields = {k: np.asarray(getattr(js, k)) for k in FIELDS}
    fields.update(light_pos=np.asarray(js.lights.pos),
                  light_color=np.asarray(js.lights.color),
                  light_radius=np.asarray(js.lights.radius))
    ps = traced_scene_from_numpy(fields, device="cpu")
    c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
    ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
    jcam = JCamera.look_at(pos=tuple(c + OFFSET * ext), target=tuple(c))
    pcam = Camera(**{k: torch.from_numpy(np.array(getattr(jcam, k)))
                     for k in ("pos", "right", "up", "front", "plane_dist")})
    return js, ps, jcam, pcam


@pytest.fixture(scope="module")
def scenes():
    return _scenes(bounce=False)


@pytest.fixture(scope="module")
def bounce_scenes():
    return _scenes(bounce=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j3(a):
    return tuple(jnp.asarray(a[:, k]) for k in range(3))


def _p3(a):
    return tuple(_t(a[:, k]) for k in range(3))


def test_fat_scene_takes_node_tables(scenes):
    js, ps, _, _ = scenes
    assert ps.leaves is None and pt.walks(ps) and pt.is_fat(ps)
    assert ps.nodes.leaf_max == js.leaf_max
    assert ps.nodes.n_nodes == js.num_nodes and ps.depth == js.depth
    # the port's own build of the same geometry at leaf 64, and a walk
    # scene at leaf 16, which keeps the walk kernels
    g = pproc.city_scene(N).flatten()
    lo, hi = g.bounds()
    fat = make_traced_scene(g, p_build_bvh(lo, hi, leaf_size=LEAF),
                            device="cpu")
    assert fat.leaves is None and pt.is_fat(fat)
    walk = make_traced_scene(g, p_build_bvh(lo, hi, leaf_size=16),
                             device="cpu", walk=True)
    assert pt.walks(walk) and not pt.is_fat(walk)
    assert stats_path_available(walk) and not stats_path_available(fat)


def test_leaf_65_raises():
    """A leaf of LEAF_PAD + 1 triangles: the node tables refuse it, as
    ``pack_scene_arrays`` :170 does, and so does the scene."""
    g = pproc.city_scene(4).flatten()
    lo, hi = g.bounds()
    one = BVH(lo.min(0)[None], hi.max(0)[None], np.zeros(1, np.int32),
              np.array([65], np.int32), np.zeros(1, np.int32),
              np.zeros(1, np.int32), np.arange(g.num_tris, dtype=np.int32),
              0)
    with pytest.raises(ValueError, match="LEAF_PAD"):
        pt.pack_node_tables(one.node_lo, one.node_hi, one.child, one.count,
                            one.axis, one.first_node)
    with pytest.raises(ValueError, match="LEAF_PAD"):
        make_traced_scene(g, one, device="cpu")
    # a leaf of 64 is taken
    at_cap = dataclasses.replace(one, count=np.array([64], np.int32))
    assert pt.pack_node_tables(at_cap.node_lo, at_cap.node_hi, at_cap.child,
                               at_cap.count, at_cap.axis,
                               at_cap.first_node).leaf_max == 64


def test_fat_camera_trace_matches_jax(scenes):
    js, ps, jcam, pcam = scenes
    w, h = 128, 64
    jd, ju, jv, jt, jdx, jdy, jdz = (np.asarray(a) for a in
                                     tp.camera_trace(js, jcam, w, h))
    pt.reset_launch_counts()
    pd, pu, pv, ptri, pdx, pdy, pdz = (a.numpy() for a in
                                       pt.camera_trace(ps, pcam, w, h))
    assert not any(pt.launch_counts().values())
    # tests/test_pallas.py:130-153
    np.testing.assert_allclose(pd, jd, rtol=2e-4, atol=2e-4)
    for a, b in ((pdx, jdx), (pdy, jdy), (pdz, jdz)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    hit = jd < BIG
    assert 0.2 < hit.mean() < 0.95
    # B11a's miss: dist BIG and tri 0 (:619-622)
    np.testing.assert_array_equal(pd[~hit], np.float32(BIG))
    np.testing.assert_array_equal(ptri[~hit], 0)
    np.testing.assert_array_equal(jt[~hit], 0)
    assert (ptri[hit] == jt[hit]).mean() > 0.999
    same = hit & (ptri == jt)
    np.testing.assert_allclose(pu[same], ju[same], atol=2e-3)
    np.testing.assert_allclose(pv[same], jv[same], atol=2e-3)
    # the near-child signs are those of each packet's ray 0
    signs = pt.camera_signs(pcam, w, h)
    ray0 = np.stack([pdx, pdy, pdz], 1).reshape(-1, pt.PACKET_R, 3)[:, 0]
    np.testing.assert_array_equal(signs.numpy(), ray0 < 0)


def test_fat_camera_rays_in_any_warp_order_give_the_same_hits(scenes):
    """B11a's warps take 8 x 4 pixel tiles (``camera_wl_order``) and its
    near children come from each packet's ray 0: so each packet's rays,
    permuted into tiles or at random before the walk and put back after
    it, give ``fat_camera_plain``'s outputs bit for bit (one packet of
    the 128 x 64 frame)."""
    _, ps, _, pcam = scenes
    w, h = 128, 64
    cam = pt._camera_vec(ps, pcam, w, h)
    signs = pt.camera_signs(pcam, w, h)
    pids = torch.arange(1, 2)
    want = fat_camera_plain(cam, w, h, signs, ps.tri_rows, ps.nodes, pids)
    assert bool((want[0] < BIG).any()) and bool((want[0] == BIG).any())
    d, _, _ = pt._camera_rays(cam, w, h, pids)
    gen = torch.Generator().manual_seed(3)
    for order in (pt.camera_wl_order(),
                  torch.randperm(pt.PACKET_R, generator=gen)):
        best, tri, u, v = walk_plain(
            ps.nodes, cam[9:12].unbind(), [c[:, order].reshape(-1)
                                           for c in d],
            torch.full((pt.PACKET_R,), BIG), ps.tri_rows, True, True,
            signs=_ray_signs(signs[pids], pt.PACKET_R))
        back = lambda x: torch.empty_like(x.reshape(1, -1)).index_copy_(
            1, order, x.reshape(1, -1))
        got = (back(best), back(u), back(v),
               back(tri).clamp_min(0).to(torch.int32))
        assert all(torch.equal(a, b) for a, b in zip(got, want[:4]))


def _bounce_rays(js, seed=7):
    """One packet less 96 rays with their own origins in the city, every
    11th masked with a garbage origin, ray 0 among them with a direction
    against the packet's; a third of the live rays with a finite tmax."""
    rng = np.random.default_rng(seed)
    n = pt.PACKET_R - 96
    lo, hi = np.asarray(js.node_lo[0]), np.asarray(js.node_hi[0])
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(lo[1] + 1.0, hi[1] + 2.0, n)
    d = rng.normal(size=(n, 3)) + np.array([0.3, -0.8, 0.2])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tm = np.full(n, BIG, np.float32)
    tm[1::3] = rng.uniform(0.5, 6.0, len(tm[1::3]))
    tm[::11] = -BIG
    o[::11] = 1e30
    d[0] = np.float32([-0.6, 0.64, -0.48])  # masked ray 0: up and back
    return o, d, tm


@pytest.fixture(scope="module")
def bounce_rays(scenes):
    return _bounce_rays(scenes[0])


def test_fat_closest_hit_c_matches_jax(scenes, bounce_rays):
    js, ps, _, _ = scenes
    o, d, tm = bounce_rays
    jd, ju, jv, jt = (np.asarray(a) for a in tp.closest_hit_c(
        js, _j3(o), _j3(d), jnp.asarray(tm)))
    pd, pu, pv, ptri = (a.numpy() for a in pt.closest_hit_c(
        ps, _p3(o), _p3(d), _t(tm)))
    # ray 0 is masked, and its direction, not a live ray's, orders the walk
    # (:3857): its signs differ from the packet's mean direction's
    _, pdir, ptm, _ = pt.padded_planes(_p3(o), _p3(d), _t(tm))
    assert float(ptm[0, 0]) < 0
    mean = pt.general_planes(_p3(o), _p3(d), _t(tm))[1]
    assert not torch.equal(pt.packet_signs(pdir),
                           torch.stack([c.mean(1) < 0 for c in mean], 1)
                           .int())
    big = np.float32(BIG)
    live = tm >= 0
    hit = live & (jd < np.minimum(tm, big))
    assert 0.2 < hit.sum() / live.sum() < 0.95
    np.testing.assert_array_equal(pd[~live], -big)
    np.testing.assert_array_equal(jd[~live], -big)
    # B11b's live miss returns min(tmax, BIG), not BIG (ROADMAP C13)
    miss = live & ~hit
    assert (tm[miss] < big).any()
    np.testing.assert_array_equal(pd[miss], np.minimum(tm, big)[miss])
    np.testing.assert_array_equal(jd[miss], np.minimum(tm, big)[miss])
    np.testing.assert_array_equal(ptri[~hit], 0)
    np.testing.assert_allclose(pd[hit], jd[hit], rtol=2e-4, atol=2e-4)
    assert (ptri[hit] == jt[hit]).mean() > 0.999
    same = hit & (ptri == jt)
    np.testing.assert_allclose(pu[same], ju[same], atol=2e-3)
    np.testing.assert_allclose(pv[same], jv[same], atol=2e-3)
    # the AoS seam maps the miss value to BIG, as pallas_closest_hit does
    sd, stri, _ = pt.closest_hit_aos(ps, _t(o), _t(d), _t(tm))
    np.testing.assert_array_equal(sd.numpy()[miss], big)
    np.testing.assert_array_equal(sd.numpy()[hit], pd[hit])


def _shadow_rays(js, seed=3):
    """One packet less 200 rays from the light to seeded points of the
    city's lower half; every 13th masked, ray 0 among them, with a
    direction away from the scene."""
    rng = np.random.default_rng(seed)
    n = pt.PACKET_R - 200
    lo, hi = np.asarray(js.node_lo[0]), np.asarray(js.node_hi[0])
    tgt = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    tgt[:, 1] = rng.uniform(lo[1], lo[1] + 0.4 * (hi[1] - lo[1]), n)
    d = tgt - np.float32(LIGHT[0])
    ld = np.linalg.norm(d, axis=-1)
    d = (d / ld[:, None]).astype(np.float32)
    tm = (ld * 0.9999).astype(np.float32)
    tm[::13] = -BIG
    d[0] = np.float32([0.6, 0.64, 0.48])
    return d, tm


def test_fat_any_hit_shared_matches_jax(scenes):
    js, ps, _, _ = scenes
    d, tm = _shadow_rays(js)
    lp = np.float32(LIGHT[0])
    jb = np.asarray(tp.any_hit_shared(js, jnp.asarray(lp), _j3(d),
                                      jnp.asarray(tm)))
    pb = pt.any_hit_shared(ps, _t(lp), _p3(d), _t(tm)).numpy()
    live = tm >= 0
    assert not pb[~live].any() and not jb[~live].any()
    assert 0.05 < pb[live].mean() < 0.95
    np.testing.assert_array_equal(pb, jb)


def test_fat_any_hit_c_matches_jax(scenes, bounce_rays):
    js, ps, _, _ = scenes
    o, d, _ = bounce_rays
    rng = np.random.default_rng(11)
    tm = rng.uniform(0.5, 8.0, len(o)).astype(np.float32)
    tm[::11] = -BIG
    jb = np.asarray(tp.any_hit_c(js, _j3(o), _j3(d), jnp.asarray(tm)))
    pb = pt.any_hit_c(ps, _p3(o), _p3(d), _t(tm)).numpy()
    live = tm >= 0
    assert not pb[~live].any() and not jb[~live].any()
    assert 0.05 < pb[live].mean() < 0.95
    np.testing.assert_array_equal(pb, jb)


@pytest.mark.parametrize("bounce", [False, True], ids=["fwd", "bounce"])
def test_fat_frame_matches_jax(scenes, bounce_scenes, bounce):
    """render_frame_fast on the port's fat scene against the JAX
    package's (B11a, B11c and, with bounces, B11b)."""
    js, ps, jcam, pcam = bounce_scenes if bounce else scenes
    opts = BOUNCE if bounce else FWD
    jimg = np.asarray(j_render_frame_fast(js, jcam, W, H,
                                          JRenderOpts(**opts)))
    pimg = render_frame_fast(ps, pcam, W, H, RenderOpts(**opts)).numpy()
    err = np.abs(pimg - jimg).max(-1)
    assert (err > 2e-3).mean() <= 1e-3, err.max()
    assert jimg.max() > 0.1


def test_fat_frame_matches_worklist_frame(bounce_scenes):
    """The fat scene's bounce frame and the same geometry's at leaf 16
    with worklist leaf tables, in the port: the images agree but at ties
    (raw against shared-origin rows, other BVHs)."""
    _, ps, _, pcam = bounce_scenes
    g = pproc.city_scene(N).flatten()
    lo, hi = g.bounds()
    wl = make_traced_scene(g, p_build_bvh(lo, hi, leaf_size=16),
                           bounce_materials(), lights=ps.lights,
                           device="cpu")
    assert wl.leaves is not None
    a = render_frame_fast(ps, pcam, W, H, RenderOpts(**BOUNCE))
    b = render_frame_fast(wl, pcam, W, H, RenderOpts(**BOUNCE))
    err = (a - b).abs().amax(-1)
    assert float((err > 2e-3).float().mean()) <= 2e-3, float(err.max())


ROT_Y = 0.5
TRANS = np.array([[0.0, 0.0, 0.0], [30.0, 0.0, -25.0]], np.float32)


def test_fat_instanced_frame_matches_jax(bounce_scenes):
    """Two instances of the fat city through the dispatch seam (B11b for
    closest hits, B11d for shadows), against the JAX package's Pallas
    path."""
    js, ps, _, _ = bounce_scenes
    rot = np.stack([np.eye(3), np.asarray(jinst.rotation_y(
        np.float32(ROT_Y)))]).astype(np.float32)
    cam = dict(pos=(45.0, 40.0, 70.0), target=(15.0, 0.0, -12.0))
    opts = dict(reflections=True, transparency=False, textures=False)
    jimg = np.asarray(jinst.render_instanced(
        jinst.make_instances(js, jnp.asarray(rot), jnp.asarray(TRANS)),
        JCamera.look_at(**cam), W, H, JRenderOpts(**opts)))
    pt.reset_launch_counts()
    pimg = pinst.render_instanced(
        pinst.make_instances(ps, rot, TRANS), Camera.look_at(**cam,
                                                             device="cpu"),
        W, H, RenderOpts(**opts)).numpy()
    err = np.abs(pimg - jimg).max(-1)
    assert (err > 2e-3).mean() <= 2e-3, err.max()
    assert jimg.max() > 0.1


@pytest.mark.parametrize("opts", ["fwd", "bounce"])
def test_fat_portable_frame_matches_jax(bounce_scenes, opts):
    """render_frame at 80 x 48 (the portable integrator, through the
    dispatch seam to B11b and B11c) against the JAX package's, which on
    the CPU takes its jnp oracle at the scene's leaf_max."""
    js, ps, jcam, pcam = bounce_scenes
    o = FWD if opts == "fwd" else BOUNCE
    jimg = np.asarray(j_render_frame(js, jcam, 80, 48, JRenderOpts(**o)))
    img = render_frame(ps, pcam, 80, 48, RenderOpts(**o))
    assert img.shape == (48, 80, 3)
    err = np.abs(img.numpy() - jimg).max(-1)
    assert (err > 2e-3).mean() <= 2e-3, err.max()
    assert jimg.max() > 0.1


@pytest.fixture(scope="module")
def diff(bounce_scenes):
    """bench.py's fwd+bwd step on the fat bounce scene in both packages,
    against a target lit from a moved light: (JAX loss, JAX gradients,
    port loss, port gradients, target)."""
    js, ps, jcam, pcam = bounce_scenes
    jopts = JRenderOpts(**dataclasses.asdict(STEP_OPTS))
    moved = dataclasses.replace(js, lights=JLight.make(MOVED, *LIGHT[1:]))
    target = np.array(j_render_frame_fast(moved, jcam, W, H, jopts))

    def step(params):  # bench.py:236-247
        lights = JLight(pos=params["light_pos"], color=params["light_color"],
                        radius=js.lights.radius)
        s = dataclasses.replace(js, tri_a=params["tri_a"],
                                tri_ba=params["tri_ba"],
                                tri_ca=params["tri_ca"],
                                mat_diffuse=params["mat_diffuse"],
                                lights=lights)
        c = dataclasses.replace(jcam, pos=params["cam_pos"])
        return jnp.mean((j_render_frame_fast_diff(s, c, W, H, jopts)
                         - target) ** 2)

    jparams = {"tri_a": js.tri_a, "tri_ba": js.tri_ba, "tri_ca": js.tri_ca,
               "mat_diffuse": js.mat_diffuse, "light_pos": js.lights.pos,
               "light_color": js.lights.color, "cam_pos": jcam.pos}
    jl, jg = jax.value_and_grad(step)(jparams)
    pl, pg = bench_step(ps, pcam, torch.from_numpy(target), W, H)
    return (float(jl), {k: np.asarray(v) for k, v in jg.items()}, float(pl),
            {k: v.numpy() for k, v in pg.items()}, target)


@pytest.mark.parametrize("name", GRAD_PARAMS)
def test_fat_diff_grads_match_jax(diff, name):
    jl, jg, pl, pg, _ = diff
    # tests/test_fast_diff.py:83-91
    assert np.isfinite(pl) and pl > 1e-4
    assert abs(pl - jl) < 3e-4 * max(1.0, abs(jl))
    a, b = pg[name], jg[name]
    assert a.shape == b.shape and np.isfinite(a).all()
    denom = max(np.abs(b).max(), 1e-8)
    assert np.abs(b).max() > 0
    assert np.quantile(np.abs(a - b), 0.999) < 5e-3 * denom, name
    assert np.abs(a - b).mean() < 1e-3 * denom, name


def test_fat_diff_grads_match_finite_differences(bounce_scenes, diff):
    """Central differences of the loss in each channel of the light colour
    (the image is polynomial in it, of low degree)."""
    _, ps, _, pcam = bounce_scenes
    target = torch.from_numpy(diff[-1])

    def loss(params):
        s, c = with_params(ps, pcam, params)
        img = render_frame_fast_diff(s, c, W, H, STEP_OPTS)
        return ((img - target) ** 2).mean()

    params = grad_params(ps, pcam)
    loss(params).backward()
    grad = params["light_color"].grad[0]
    eps = 1e-2
    for c in range(3):
        with torch.no_grad():
            lo, hi = (grad_params(ps, pcam) for _ in range(2))
            lo["light_color"][0, c] -= eps
            hi["light_color"][0, c] += eps
            fd = (loss(hi) - loss(lo)) / (2 * eps)
        assert abs(float(grad[c]) - float(fd)) <= 1e-2 * abs(float(fd)), (
            c, float(grad[c]), float(fd))


def test_fat_counter_frame_raises(scenes):
    _, ps, _, pcam = scenes
    assert not stats_path_available(ps)
    with pytest.raises(ValueError, match="IVAL_LEAF"):
        render_frame_fast_stats(ps, pcam, W, H)
    d, tm = _shadow_rays(scenes[0])
    with pytest.raises(ValueError, match="IVAL_LEAF"):
        pt.any_hit_shared_stats(ps, _t(np.float32(LIGHT[0])), _p3(d), _t(tm))


def test_fat_closest_tally_matches_counters(scenes):
    """B11b's warps simulated (``closest_g_sim`` with each packet's ray-0
    signs) on two packets of seeded rays, as the caller gives them (masked
    rays not substituted; packet 0's warps coherent, packet 1's
    scattered): their outputs are ``fat_closest_plain``'s bit for bit,
    and their tally holds against their counters: node steps are the
    ``nodes`` slot, leaf visits the ``quarters`` slot, the visits by
    entering lanes sum to the visits."""
    _, ps, _, _ = scenes
    rng = np.random.default_rng(17)
    lo, hi = ps.root_lo.numpy(), ps.root_hi.numpy()
    nw, ext = 2 * pt.WARPS, hi - lo
    spread = np.where(np.arange(nw) < pt.WARPS, 0.01, 0.3)[:, None, None]
    o = (rng.uniform(lo, hi, (nw, 1, 3))
         + rng.uniform(-1.0, 1.0, (nw, pt.WARP, 3)) * spread * ext)
    d = (rng.normal(size=(nw, 1, 3)) + [0.3, -0.8, 0.2]
         + rng.normal(size=(nw, pt.WARP, 3)) * 0.3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    tm = np.full(len(o), BIG)
    tm[1::3] = rng.uniform(0.5, 6.0, len(tm[1::3]))
    tm[::11] = -BIG
    o[::11] = 1e30
    pk = lambda a: _t(a.astype(np.float32).reshape(2, -1))
    o, d = (tuple(pk(x[:, k]) for k in range(3)) for x in (o, d))
    tm = pk(tm)
    signs = pt.packet_signs(d)
    out, stats, tally = closest_g_sim(o, d, tm, ps.tri_rows, ps.nodes,
                                      signs)
    plain = fat_closest_plain(o, d, tm, signs, ps.tri_rows, ps.nodes)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    live = tm >= 0
    assert 0.2 < float((out[0][live] < tm.clamp_max(BIG)[live]).float()
                       .mean()) < 1.0
    t = dict(zip(TALLY, tally))
    packet = lambda x: x.reshape(-1, pt.WARPS).sum(1)
    assert torch.equal(packet(t["nodes"]), stats[:, 0].long())
    assert torch.equal(packet(t["visits"]), stats[:, 2].long())
    assert torch.equal(packet(t["rows"]), stats[:, 3].long())
    assert torch.equal(sum(t[b] for b in LANE_BINS), t["visits"])
    assert ((t["visits"] <= t["lanes"])
            & (t["lanes"] <= pt.WARP * t["visits"])).all()
    # leaves of 33-64 rows, entered by one lane and by many
    assert int(t["rows"].sum()) > pt.IVAL_LEAF * int(t["visits"].sum()) // 2
    assert int(t["1"].sum()) > 0 and int(t["17-32"].sum()) > 0


def test_fat_shadow_tally_matches_plain(scenes):
    """B11d's warps simulated (``shadow_g_sim`` with each packet's ray-0
    signs) on shadow rays from the light and on scattered ones, as the
    caller gives them (masked rays not substituted): their verdicts are
    ``fat_shadow_g_plain``'s bit for bit and the JAX package's
    ``any_hit_c``'s (``_shadow_kernel_g`` in interpret mode), and their
    tally holds against their counters and verdicts (as
    tests/test_torch_walk.py's B9d tally); leaves of 33-64 rows, some of
    whose visits test rows 33-64 and some not."""
    from test_torch_walk import _assert_shadow_tally_holds, _shadow_g_rays

    js, ps, _, _ = scenes
    o, d, tm = _shadow_g_rays(ps.root_lo.numpy(), ps.root_hi.numpy(),
                              LIGHT[0], 23)
    jb = np.asarray(tp.any_hit_c(js, _j3(o), _j3(d), jnp.asarray(tm)))
    po, pd, ptm, n = pt.padded_planes(_p3(o), _p3(d), _t(tm))
    signs = pt.packet_signs(pd)
    blocked, stats, tally = shadow_g_sim(po, pd, ptm, ps.tri_rows, ps.nodes,
                                         signs)
    assert torch.equal(blocked, fat_shadow_g_plain(po, pd, ptm, signs,
                                                   ps.tri_rows, ps.nodes))
    pb = blocked.reshape(-1)[:n].numpy() > 0
    live = tm >= 0
    assert not pb[~live].any()
    assert 0.05 < pb[live].mean() < 0.95
    np.testing.assert_array_equal(pb, jb)
    _assert_shadow_tally_holds(tally, stats, blocked, ptm >= 0)
    t = dict(zip(TALLY, tally))
    assert int(t["rows"].sum()) > pt.IVAL_LEAF * int(t["visits"].sum()) // 2
    assert 0 < int(t["chunk2"].sum()) < int(t["visits"].sum())


def test_fat_shared_shadow_tally_matches_plain(scenes):
    """B11c's warps simulated (``shadow_g_sim`` with the light given as
    planes and each packet's ray-0 signs: the kernel's walk and staged
    any-hit leaf stage) on the light's shadow rays (``_shadow_rays``, as
    ``any_hit_shared`` pads them): their verdicts are
    ``fat_shadow_plain``'s bit for bit and the JAX package's
    ``any_hit_shared``'s (``_shadow_kernel`` in interpret mode), and their
    tally holds against their counters and verdicts (as the B11d tally's);
    leaves of 33-64 rows."""
    from test_torch_walk import _assert_shadow_tally_holds

    js, ps, _, _ = scenes
    d, tm = _shadow_rays(js)
    lp = np.float32(LIGHT[0])
    jb = np.asarray(tp.any_hit_shared(js, jnp.asarray(lp), _j3(d),
                                      jnp.asarray(tm)))
    orig, pd, ptm, n = pt._light_planes(_t(lp), _p3(d), _t(tm))
    signs = pt.packet_signs(pd)
    o = tuple(orig[k].expand_as(ptm) for k in range(3))
    blocked, stats, tally = shadow_g_sim(o, pd, ptm, ps.tri_rows, ps.nodes,
                                         signs)
    assert torch.equal(blocked, fat_shadow_plain(orig, pd, ptm, signs,
                                                 ps.tri_rows, ps.nodes))
    np.testing.assert_array_equal(blocked.reshape(-1)[:n].numpy() > 0, jb)
    live = tm >= 0
    assert 0.05 < jb[live].mean() < 0.95 and not jb[~live].any()
    _assert_shadow_tally_holds(tally, stats, blocked, ptm >= 0)
    t = dict(zip(TALLY, tally))
    assert int(t["rows"].sum()) > pt.IVAL_LEAF * int(t["visits"].sum()) // 2
