"""General any-hit (B7) and the instanced frame against the JAX package.

B7's plain version and ``any_hit_c`` are held against the JAX package's
Pallas kernels (interpret mode on the CPU) on 2 packets of rays with their
own origins in city_scene(4); the port's ``render_instanced`` against the
JAX package's, through its Pallas path, on two instances of the cornell
box with reflective, half-transparent walls; and against the port's own
single-scene frame with one identity instance."""

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
from snail_tpu.scene import instancing as jinst
from snail_tpu.scene import procedural as jproc
from snail_tpu.scene.materials import MaterialTable as JMaterialTable
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.core.vecmath import BIG
from snail_tpu_torch.ops import dispatch
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.render.renderer import render_frame
from snail_tpu_torch.scene import instancing as pinst
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene.bench_scenes import bounce_materials
from snail_tpu_torch.scene.scene import (make_traced_scene,
                                         traced_scene_from_numpy)

LIGHT = np.array([0.0, 30.0, 0.0], np.float32)
FIELDS = ("node_lo", "node_hi", "node_child", "node_count", "tri_a", "tri_ba",
          "tri_ca", "sh_mat", "sh_pack", "mat_pack", "mat_diffuse",
          "mat_specular", "mat_reflect", "mat_dissolve")


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


@pytest.fixture(scope="module")
def city():
    g = jproc.city_scene(4).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=8)
    js = j_make_traced_scene(g, bvh,
                             lights=JLight.make(LIGHT, (1.0, 1.0, 1.0), 120.0))
    assert js.wl_lfc is not None  # the JAX worklist path
    ps = traced_scene_from_numpy({k: np.asarray(getattr(js, k))
                                  for k in FIELDS}, device="cpu")
    return js, ps


@pytest.fixture(scope="module")
def shadow_rays(city):
    """2 packets less 1000 rays of shadow rays with their own origins:
    the first packet from one point above the scene (as an instance's
    light in object space), the second from scattered points; targets on
    and near the ground, tmax 0.9999 of the distance; every 7th ray
    masked, with a garbage origin as a miss point carries."""
    js, _ = city
    rng = np.random.default_rng(17)
    n = 2 * pt.PACKET_R - 1000
    lo, hi = np.asarray(js.node_lo[0]), np.asarray(js.node_hi[0])
    o = np.empty((n, 3), np.float32)
    o[:pt.PACKET_R] = (lo + hi) * 0.5 + np.array([3.0, 25.0, -2.0])
    o[pt.PACKET_R:] = rng.uniform(lo, hi, (n - pt.PACKET_R, 3))
    o[pt.PACKET_R:, 1] = rng.uniform(4.0, 12.0, n - pt.PACKET_R)
    tgt = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    tgt[:, 1] = rng.uniform(0.0, 2.5, n)
    d = tgt - o
    ld = np.linalg.norm(d, axis=-1)
    d = (d / ld[:, None]).astype(np.float32)
    tm = (ld * 0.9999).astype(np.float32)
    tm[::7] = -BIG
    o[::7] = 1e30
    return o, d, tm


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_shadow_wl_g_plain_matches_jax(city, shadow_rays):
    """B7's plain version against ``_shadow_wl_kernel_g`` on the port's
    padded, substituted planes and B5's words (one band), as any_hit_c
    runs them."""
    js, ps = city
    o, d, tm = shadow_rays
    po, pd, ptm, n = pt.general_planes(tuple(_t(o[:, k]) for k in range(3)),
                                       tuple(_t(d[:, k]) for k in range(3)),
                                       _t(tm))
    jpk = lambda a: jnp.asarray(a.numpy().reshape(-1, tp.RAY_SUB,
                                                  tp.RAY_LANE))
    jblock = tp._run_words_general(*(jpk(c) for c in (*po, *pd, ptm)),
                                   js.lf_boxv, 1, js.wl_nl)
    jb = np.asarray(tp._run_shadow_wl_g(
        js.wl_lfc, *(jpk(c) for c in (*po, *pd, ptm)), js.pk_tris,
        js.wl_boxrows, jblock, 1, js.lf_boxv.shape[1])).reshape(ptm.shape)
    words, _, _ = pt.words_general(po, pd, ptm, ps.leaves, 1)
    pb = pt.shadow_wl_g_plain(po, pd, ptm, ps.tri_rows, ps.leaves,
                              words).numpy()
    live = ptm.numpy() >= 0
    assert not pb[~live].any() and not jb[~live].any()
    assert 0.05 < pb[live].mean() < 0.95
    np.testing.assert_array_equal(pb[live], jb[live])


def test_any_hit_c_plain_matches_jax(city, shadow_rays):
    js, ps = city
    o, d, tm = shadow_rays
    jb = np.asarray(tp.any_hit_c(js, tuple(jnp.asarray(o[:, k])
                                           for k in range(3)),
                                 tuple(jnp.asarray(d[:, k])
                                       for k in range(3)), jnp.asarray(tm)))
    pb = pt.any_hit_c(ps, tuple(_t(o[:, k]) for k in range(3)),
                      tuple(_t(d[:, k]) for k in range(3)), _t(tm)).numpy()
    live = tm >= 0
    assert pb.shape == (len(tm),) and not pb[~live].any()
    assert 0.05 < pb[live].mean() < 0.95
    np.testing.assert_array_equal(pb[live], jb[live])
    # the AoS seam: the same verdicts, never blocked when masked
    ab = dispatch.any_hit(ps, _t(o), _t(d), _t(tm)).numpy()
    np.testing.assert_array_equal(ab, pb & live)


def test_any_hit_from_matches_any_hit(city, shadow_rays):
    """The seam's shared-origin entry (B3/B4 after the packet-mean
    substitution) and its general one (B5/B7) on the first packet's rays,
    which start at one point (ray 1; masked rays carry garbage origins):
    the same verdicts but at the boundary."""
    _, ps = city
    o, d, tm = shadow_rays
    k = pt.PACKET_R
    a = dispatch.any_hit_from(ps, _t(o[1]), _t(d[:k]), _t(tm[:k])).numpy()
    b = dispatch.any_hit(ps, _t(o[:k]), _t(d[:k]), _t(tm[:k])).numpy()
    live = tm[:k] >= 0
    assert not a[~live].any() and 0.05 < a[live].mean() < 0.95
    assert (a == b).mean() > 0.999


@pytest.fixture(scope="module")
def city24():
    """city_scene(24) at leaf 16 (the bench city's tree; 1 summary word of
    leaves): the JAX scene on its worklist path and the port's from its
    arrays, both lit by the bench light."""
    g = jproc.city_scene(24).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=16)
    js = j_make_traced_scene(g, bvh,
                             lights=JLight.make(LIGHT, (1.0, 1.0, 1.0), 120.0))
    assert js.wl_lfc is not None
    ps = traced_scene_from_numpy({k: np.asarray(getattr(js, k))
                                  for k in FIELDS}, device="cpu")
    return js, ps


def _instanced_wave(ps):
    """The B7 wavefront that the instanced fwd frame of 2 x 2 instances of
    ``ps`` (``instanced_grid``) at 128 x 64 launches for the first
    instance in which it blocks a live ray: (o, d, tm), B7's planes."""
    from snail_tpu_torch.scene.bench_scenes import instanced_grid

    wrapper, waves = pt.shadow_wl_g, []

    def record(*args):
        waves.append(args)
        return wrapper(*args)

    isc, icam = instanced_grid("city", ps, 2)
    pt.shadow_wl_g = record
    try:
        pinst.render_instanced(isc, icam, 128, 64, RenderOpts(
            reflections=False, transparency=False, textures=False))
    finally:
        pt.shadow_wl_g = wrapper
    assert len(waves) == 4
    for o, d, tm, *_ in waves:
        if bool(pt.shadow_wl_g_plain(o, d, tm, *waves[0][3:6])[tm >= 0]
                .any()):
            return o, d, tm
    raise AssertionError("no instance's wavefront blocks a live ray")


@pytest.mark.parametrize("wave", ["scattered", "instanced"])
def test_shadow_wl_g_sim_matches_plain_and_jax(city24, wave):
    """B7's warps simulated (``shadow_wl_g_sim``: ``scan_boxes`` with the
    staged any-hit leaf stage, as the kernel scans) on city_scene(24) at
    leaf 16, on two packets of scattered shadow rays (the first from one
    point above the city, as an instance's light, the second from
    scattered points) and on the instanced fwd frame's own wavefront:
    the verdicts are the plain B7's and the JAX package's ``any_hit_c``'s
    (B5 + ``_shadow_wl_kernel_g`` in interpret mode) bit for bit, masked
    rays never blocked; the tally holds against the scan's counters (leaf
    visits, the most rows a lane tested, the words at the leaf level) and
    the verdicts (each blocked ray blocked in one visit), and the visits
    by entering lanes sum to the visits."""
    js, ps = city24
    if wave == "scattered":
        rng = np.random.default_rng(31)
        n = 2 * pt.PACKET_R
        lo, hi = ps.root_lo.numpy(), ps.root_hi.numpy()
        o = np.empty((n, 3), np.float32)
        o[:pt.PACKET_R] = (lo + hi) * 0.5 + np.array([5.0, 30.0, -3.0])
        o[pt.PACKET_R:] = rng.uniform(lo, hi, (pt.PACKET_R, 3))
        o[pt.PACKET_R:, 1] = rng.uniform(2.0, 8.0, pt.PACKET_R)
        tgt = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
        tgt[:, 1] = rng.uniform(0.0, 2.5, n)
        d = tgt - o
        ld = np.linalg.norm(d, axis=-1)
        d = (d / ld[:, None]).astype(np.float32)
        tm = (ld * 0.9999).astype(np.float32)
        tm[::7] = -BIG
        o[::7] = 1e30
        po, pd, ptm, _ = pt.general_planes(
            tuple(_t(o[:, k]) for k in range(3)),
            tuple(_t(d[:, k]) for k in range(3)), _t(tm))
    else:
        po, pd, ptm = _instanced_wave(ps)
    rows, lt = ps.tri_rows, ps.leaves
    words, _, floors = pt.words_general(po, pd, ptm, lt, 1)
    blocked, cnt, tally = pt.shadow_wl_g_sim(po, pd, ptm, rows, lt, words,
                                             floors)
    assert torch.equal(blocked, pt.shadow_wl_g_plain(po, pd, ptm, rows, lt,
                                                     words))
    live = ptm >= 0
    flat = lambda c: jnp.asarray(c.reshape(-1).numpy())
    jb = np.asarray(tp.any_hit_c(js, tuple(map(flat, po)),
                                 tuple(map(flat, pd)), flat(ptm)))
    np.testing.assert_array_equal(blocked.reshape(-1).numpy() > 0, jb)
    assert not bool(blocked[~live].any())
    assert 0.0 < float(blocked[live].mean()) < 1.0
    t = dict(zip(pt.TALLY, tally))
    assert torch.equal(t["nodes"], cnt[0])
    assert torch.equal(t["visits"], cnt[2]) and torch.equal(t["most"],
                                                            cnt[3])
    assert torch.equal(sum(t[b] for b in pt.LANE_BINS), t["visits"])
    assert ((t["visits"] <= t["lanes"])
            & (t["lanes"] <= pt.WARP * t["visits"])).all()
    assert ((t["lanes"] <= t["tested"]) & (t["tested"] <= t["lane_rows"])
            & (t["most"] <= t["rows"]) & (t["blocked"] <= t["lanes"])
            & (t["visits"] <= cnt[1]) & (cnt[5] <= cnt[4])).all()
    assert int(t["blocked"].sum()) == int(blocked[live].sum())
    assert int(t["chunk2"].sum()) == 0 and int(t["visits"].sum()) > 0


def _jax_bounce_materials():
    mats = JMaterialTable.build({"": 0}, [])
    mats.reflectivity[0] = 0.5
    mats.dissolve[0] = 0.5
    return mats


# two instances of the cornell box: one as it is, one turned and set
# off to the side and back, partly behind the first
ROT = np.stack([np.eye(3), np.asarray(jinst.rotation_y(np.float32(0.6)))]
               ).astype(np.float32)
TRANS = np.array([[0.0, 0.0, 0.0], [4.5, 0.3, -5.0]], np.float32)
CAM = dict(pos=(1.5, 3.0, 9.0), target=(1.5, 1.5, 0.0))


_COND = jax.lax.cond


def _eager_cond(pred, true_fn, false_fn, *operands, **kw):
    """``lax.cond`` outside ``jit`` runs one branch, as this does; this
    lets the eager Pallas calls of every instance reuse one compiled
    kernel instead of compiling each cond anew. Traced conds (inside the
    kernels) stay as they are."""
    if isinstance(pred, jax.core.Tracer):
        return _COND(pred, true_fn, false_fn, *operands, **kw)
    return (true_fn if bool(pred) else false_fn)(*operands, **kw)


def test_render_instanced_matches_jax(monkeypatch):
    monkeypatch.setattr(jax.lax, "cond", _eager_cond)
    g = jproc.cornell_scene().flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=8)
    light = ((0.0, 3.5, 2.0), (1.0, 0.9, 0.8), 30.0)
    js = j_make_traced_scene(g, bvh, _jax_bounce_materials(),
                             lights=JLight.make(*light), backend="pallas")
    ps = make_traced_scene(pproc.cornell_scene().flatten(), bvh,
                           bounce_materials(),
                           lights=Light.make(*light, device="cpu"),
                           device="cpu")
    opts = dict(reflections=True, transparency=True, textures=False)
    jimg = np.asarray(jinst.render_instanced(
        jinst.make_instances(js, jnp.asarray(ROT), jnp.asarray(TRANS)),
        JCamera.look_at(**CAM), 64, 64, JRenderOpts(**opts)))
    pimg = pinst.render_instanced(
        pinst.make_instances(ps, ROT, TRANS),
        Camera.look_at(**CAM, device="cpu"), 64, 64,
        RenderOpts(**opts)).numpy()
    err = np.abs(pimg - jimg).max(-1)
    # atol 2e-3; pixels beyond it are hit ties (ROADMAP C7)
    assert (err > 2e-3).mean() <= 2e-3, err.max()
    assert jimg.max() > 0.1


def test_instanced_full_whitted_matches_flat_render():
    """One identity instance through the full shading (specular and
    reflections) gives the port's single-scene frame, as
    tests/test_instancing.py holds for the JAX package."""
    base = pproc.cornell_scene()
    for i in (1, 2):  # the inner boxes get a shiny material
        base.objects[i].tri_mat[:] = 1
    g = base.flatten()
    lo, hi = g.bounds()
    from snail_tpu_torch.bvh import build_bvh as p_build_bvh
    from snail_tpu_torch.scene.materials import MaterialTable

    mats = MaterialTable.build({"default": 0, "shiny": 1})
    mats.specular[1] = 0.6
    mats.reflectivity[1] = 0.4
    scene = make_traced_scene(
        g, p_build_bvh(lo, hi, leaf_size=8), mats, device="cpu",
        lights=Light.make((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0,
                          device="cpu"))
    cam = Camera.look_at(pos=(0.0, 2.0, 6.0), target=(0.0, 1.5, 0.0),
                         device="cpu")
    opts = RenderOpts(reflections=True, transparency=False, textures=False)
    isc = pinst.make_instances(scene, torch.eye(3)[None], torch.zeros(1, 3))
    img_i = pinst.render_instanced(isc, cam, 64, 64, opts)
    img_f = render_frame(scene, cam, 64, 64, opts)
    assert float((img_i - img_f).abs().max()) < 2e-3
    # the full shading fires on the instanced path
    off = RenderOpts(reflections=False, transparency=False, textures=False)
    img_no = pinst.render_instanced(isc, cam, 64, 64, off)
    assert float((img_i - img_no).abs().max()) > 1e-3


def test_instance_culling_sublinear(monkeypatch):
    """64 instances of a box strewn along +x, all but the first 4 far off
    a corridor of rays down +x: the cull touches at most 6 instances,
    instance 0 among them, every hit is on instance 0, and only the
    touched instances get live rays (the DBVH's sub-linearity, reference
    dbvh/tree.h:189-252): the others are traced fully masked, which the
    kernels leave at once."""
    from snail_tpu_torch.bvh import build_bvh as p_build_bvh

    g = pproc.box_scene().flatten()
    lo, hi = g.bounds()
    base = make_traced_scene(g, p_build_bvh(lo, hi, leaf_size=8),
                             device="cpu")
    n = 64
    trans = np.zeros((n, 3), np.float32)
    trans[:, 0] = np.arange(n) * 10.0
    trans[4:, 1] = 1000.0
    isc = pinst.make_instances(base, np.tile(np.eye(3, dtype=np.float32),
                                             (n, 1, 1)), trans)
    r = 128
    o = np.zeros((r, 3), np.float32)
    o[:, 0] = -5.0
    o[:, 1] = np.linspace(-0.5, 0.5, r)
    d = np.zeros((r, 3), np.float32)
    d[:, 0] = 1.0
    o3 = tuple(_t(o[:, k]) for k in range(3))
    d3 = tuple(_t(d[:, k]) for k in range(3))
    tm = torch.full((r,), 1e12)
    touched = [bool(pinst._ray_hits_box(o3, d3, tm, isc.inst_lo[i],
                                        isc.inst_hi[i]).any())
               for i in range(n)]
    assert sum(touched) <= 6 and touched[0]

    live = []  # per traced instance: does any ray go in live?
    traced = dispatch.closest_hit
    monkeypatch.setattr(dispatch, "closest_hit", lambda scene, o, d, tmax: (
        live.append(bool((tmax >= 0).any())) or traced(scene, o, d, tmax)))
    dist, inst, _, _, _ = pinst.instanced_closest_hit(isc, o3, d3, tm)
    hit = dist < 1e11
    assert bool(hit.any()) and bool((inst[hit] == 0).all())
    assert len(live) == n and live[0] and 1 <= sum(live) <= sum(touched)


def test_raygen_matches_jax():
    """primary_rays, tile_rays and untile_image against the JAX package's
    (render/raygen.py): directions to 1e-6 (the port's rsqrt is correctly
    rounded, ROADMAP C), tiling exact, untiling its inverse."""
    from snail_tpu.render import raygen as jraygen
    from snail_tpu_torch.render import raygen as praygen

    jcam = JCamera.look_at(**CAM)
    pcam = Camera.look_at(**CAM, device="cpu")
    jo, jd = jraygen.primary_rays(jcam, 96, 64, jitter=(0.25, -0.5))
    po, pd = praygen.primary_rays(pcam, 96, 64, jitter=(0.25, -0.5))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=1e-6)
    pt_ = praygen.tile_rays(pd, 32, 16)
    np.testing.assert_array_equal(
        pt_.numpy(), np.asarray(jraygen.tile_rays(jnp.asarray(pd.numpy()),
                                                  32, 16)))
    assert torch.equal(praygen.untile_image(pt_, 64, 96, 32, 16), pd)
    assert torch.equal(praygen.untile_image(pt_[..., 0], 64, 96, 32, 16),
                       pd[..., 0])
