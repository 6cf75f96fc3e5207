"""B2 and B4 on the raw triangle rows (the JAX package's ``raw=True`` of
``_run_camera_wl`` / ``_run_shadow_wl``, the port's only form of them)
and bench.py's 10 Mtri scene.

- ``camera_trace`` and ``any_hit_shared`` against the JAX package's raw
  kernels in interpret mode (its ``_wl_raw_tris`` patched to true in the
  test), on city_scene(6) at leaf 4 (tests/test_torch_traverse.py's
  scene); the port calls no ``shared_rows`` there, and its counter frame
  keeps the shared-origin rows;
- B2 and B4 on the raw rows bit for bit B8a and B8b on the shared-origin
  rows, on several scenes: the two forms round alike;
- B2's warps simulated (``camera_wl_sim``, what the card's kernel is held
  to bit for bit) against the plain B2;
- the fwd frame against the JAX frame on its raw form;
- the 10 Mtri configuration (``scene_10m``) at a small size against
  bench.py's ``section_10m``: geometry, camera, light and options.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snail_tpu.bvh import build_bvh as j_build_bvh
from snail_tpu.core.types import Camera as JCamera
from snail_tpu.core.types import Light as JLight
from snail_tpu.core.types import RenderOpts as JRenderOpts
from snail_tpu.ops import traverse_pallas as tp
from snail_tpu.render.fast import render_frame_fast as j_render_frame_fast
from snail_tpu.scene import procedural as jproc
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.bvh import build_bvh
from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.core.vecmath import BIG
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.render.fast import render_frame_fast_stats
from snail_tpu_torch.render.renderer import render_frame
from snail_tpu_torch.scene import bench_scenes as bs
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene.scene import (make_traced_scene,
                                         traced_scene_from_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 128, 64
LIGHT = np.array([0.0, 30.0, 0.0], np.float32)
FIELDS = ("node_lo", "node_hi", "node_child", "node_count", "tri_a",
          "tri_ba", "tri_ca", "sh_mat", "sh_pack", "mat_pack", "mat_diffuse",
          "mat_specular", "mat_reflect", "mat_dissolve")
OPTS = dict(reflections=False, transparency=False, textures=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """B2 raw's warp simulation is a Python loop of small tensor ops, which
    PyTorch's intra-op pool slows on a machine whose cores other test
    workers keep busy (tests/test_torch_shared.py); the results do not
    depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def forced_raw(monkeypatch):
    """The JAX package on its raw form (``_wl_raw_tris`` true), and the
    port's ``shared_rows`` refusing to run (B2 and B4 build no
    shared-origin table)."""
    monkeypatch.setattr(tp, "_wl_raw_tris", lambda scene: True)

    def no_table(*args):
        raise AssertionError("shared_rows called on the raw form")

    monkeypatch.setattr(pt, "shared_rows", no_table)


@pytest.fixture(scope="module")
def scenes():
    """city_scene(6) at leaf 4 in both packages on one BVH, and the bench
    camera (tests/test_torch_traverse.py's)."""
    g = jproc.city_scene(6).flatten()
    lo, hi = g.bounds()
    bvh = j_build_bvh(lo, hi, leaf_size=4)
    js = j_make_traced_scene(
        g, bvh, lights=JLight.make(LIGHT, (1.0, 1.0, 1.0), 120.0))
    assert js.wl_lfc is not None  # the JAX worklist path
    ps = traced_scene_from_numpy({k: np.asarray(getattr(js, k))
                                  for k in FIELDS}, device="cpu")
    slo, shi = np.asarray(js.node_lo[0]), np.asarray(js.node_hi[0])
    c = (slo + shi) * 0.5
    ext = float(np.max(shi - slo))
    jcam = JCamera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9]) * ext),
                           target=tuple(c))
    pcam = Camera(**{k: torch.from_numpy(np.array(getattr(jcam, k)))
                     for k in ("pos", "right", "up", "front", "plane_dist")})
    return js, ps, jcam, pcam


def _check_closest(pd, pu, pv, ptri, jd, ju, jv, jt):
    """dist allclose (rtol 1e-5); tri equal except on distance ties
    (ROADMAP C7: where the triangles differ, the distances agree to rtol
    1e-5); u and v where both found the same triangle."""
    hit = jd < BIG
    assert hit.mean() > 0.3 and (~hit).any()
    np.testing.assert_array_equal(pd >= BIG, ~hit)
    np.testing.assert_array_equal(ptri[~hit], -1)
    np.testing.assert_allclose(pd[hit], jd[hit], rtol=1e-5, atol=0.0)
    same = ptri == jt
    assert same[hit].mean() > 0.999
    np.testing.assert_allclose(pd[~same], jd[~same], rtol=1e-5, atol=0.0)
    np.testing.assert_allclose(pu[same & hit], ju[same & hit], atol=1e-5)
    np.testing.assert_allclose(pv[same & hit], jv[same & hit], atol=1e-5)


def test_camera_trace_raw_matches_jax(scenes, forced_raw):
    """B2's plain version through ``camera_trace`` against the JAX
    package's ``_camera_wl_kernel`` with ``raw=True`` (interpret mode):
    the full Moller test from the camera position on the raw rows, both
    sides. The directions differ by the JAX CPU rsqrt's rounding (ROADMAP
    C: to 1e-6), which the tolerances allow."""
    js, ps, jcam, pcam = scenes
    jd, ju, jv, jt, jdx, jdy, jdz = (np.asarray(a) for a in
                                     tp.camera_trace(js, jcam, W, H))
    pd, pu, pv, ptri, pdx, pdy, pdz = (a.numpy() for a in
                                       pt.camera_trace(ps, pcam, W, H))
    for a, b in ((pdx, jdx), (pdy, jdy), (pdz, jdz)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    _check_closest(pd, pu, pv, ptri, jd, ju, jv, jt)


@pytest.fixture(scope="module")
def shadow_rays(scenes):
    """2 packets of shadow rays from the light to seeded scene points
    (tests/test_torch_traverse.py's), every 97th masked."""
    js, _, _, _ = scenes
    rng = np.random.default_rng(7)
    n = 2 * pt.PACKET_R
    lo, hi = np.asarray(js.node_lo[0]), np.asarray(js.node_hi[0])
    tgt = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    tgt[:, 1] = rng.uniform(0.0, 3.0, n)
    d = tgt - LIGHT
    ld = np.linalg.norm(d, axis=-1)
    d = (d / ld[:, None]).astype(np.float32)
    tm = (ld * 0.9999).astype(np.float32)
    tm[::97] = -BIG
    return d, tm


def test_any_hit_shared_raw_matches_jax(scenes, shadow_rays, forced_raw):
    """B4's plain version through ``any_hit_shared`` against the JAX
    package's ``_shadow_wl_kernel`` with ``raw=True`` (interpret mode):
    the same one-sided test on the same floats, so the verdicts are
    equal."""
    js, ps, _, _ = scenes
    d, tm = shadow_rays
    jb = np.asarray(tp.any_hit_shared(
        js, jnp.asarray(LIGHT), tuple(jnp.asarray(d[:, k]) for k in range(3)),
        jnp.asarray(tm)))
    pb = pt.any_hit_shared(ps, torch.from_numpy(LIGHT),
                           tuple(torch.from_numpy(d[:, k]) for k in range(3)),
                           torch.from_numpy(tm)).numpy()
    live = tm >= 0
    assert not pb[~live].any()
    assert 0.05 < pb[live].mean() < 0.95
    np.testing.assert_array_equal(pb, jb)


def _raw_against_shared(ps, pcam, d, tm):
    """B2 and B4 (raw rows) against B8a and B8b (shared-origin rows) on
    ``ps`` at W x H and on the shadow rays ``d``/``tm`` from LIGHT: every
    output bit for bit the same. Returns (B2's hit share, B4's blocked
    share of the live rays)."""
    cam, words, summ, floors = pt._camera_words(ps, pcam, W, H)
    raw = pt.camera_wl(cam, W, H, ps.tri_rows, ps.leaves, words, summ,
                       floors)
    sh = pt.camera_wl_stats(cam, W, H, pt.shared_rows(ps.tri_rows, pcam.pos),
                            ps.leaves, words, summ, floors)
    assert all(torch.equal(a, b) for a, b in zip(sh[:7], raw))
    orig = torch.from_numpy(LIGHT)
    d3 = tuple(torch.from_numpy(d[:, k]).reshape(-1, pt.PACKET_R)
               for k in range(3))
    tmp = torch.from_numpy(tm).reshape(-1, pt.PACKET_R)
    w, s, f = pt.words_shared(orig, d3, tmp, ps.leaves, 1)
    b_raw = pt.shadow_wl(orig, d3, tmp, ps.tri_rows, ps.leaves, w, s, f)
    b_sh, _ = pt.shadow_wl_stats(orig, d3, tmp,
                                 pt.shared_rows(ps.tri_rows, orig),
                                 ps.leaves, w, s, f)
    assert torch.equal(b_sh, b_raw)
    live = tmp >= 0
    return (float((raw[0] < BIG).float().mean()),
            float(b_raw[live].mean()))


def test_raw_and_shared_forms_agree(scenes, shadow_rays):
    """On the port's own plain versions, B2 and B4 on the raw rows against
    B8a and B8b on the shared-origin rows, on the same words: every output
    bit for bit the same. ``shared_rows`` computes the origin's terms with
    the products and sums, in the same order, that the full test computes
    per ray, so the two forms round alike."""
    _, ps, _, pcam = scenes
    hit, blocked = _raw_against_shared(ps, pcam, *shadow_rays)
    assert hit > 0.3 and 0.05 < blocked < 0.95


@pytest.mark.parametrize("kind,n,leaf", [("city", 4, 8), ("city", 8, 16),
                                         ("city", 10, 32),
                                         ("terrain", 16, 4),
                                         ("terrain", 24, 32)])
def test_raw_and_shared_forms_agree_on_bench_kinds(kind, n, leaf):
    """B2/B4 on the raw rows against B8a/B8b on the shared-origin rows, bit
    for bit, on small scenes of both bench kinds at several leaf sizes:
    bench.py's camera, and shadow rays from LIGHT to seeded points of the
    root box (every 97th masked)."""
    make = {"city": pproc.city_scene, "terrain": pproc.terrain_scene}[kind]
    g = make(n).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=leaf)
    ps = make_traced_scene(g, bvh, device="cpu")
    c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
    ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
    pcam = Camera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9]) * ext),
                          target=tuple(c), device="cpu")
    rng = np.random.default_rng(n)
    tgt = rng.uniform(bvh.node_lo[0], bvh.node_hi[0],
                      (2 * pt.PACKET_R, 3)).astype(np.float32)
    d = tgt - LIGHT
    ld = np.linalg.norm(d, axis=-1)
    tm = (ld * 0.9999).astype(np.float32)
    tm[::97] = -BIG
    hit, blocked = _raw_against_shared(
        ps, pcam, (d / ld[:, None]).astype(np.float32), tm)
    assert hit > 0.2 and blocked < 0.98


def test_camera_wl_sim_raw_matches_plain(scenes):
    """B2's warps simulated as the kernel scans (its 8 x 4 pixel warps, its
    kept leaves in band order, the first strictly nearer hit) against the
    plain B2 on both packets, on the raw rows: dist, u and v bit for bit
    where the triangle agrees, the triangle differing only on a distance
    tie; the directions bit for bit; and the simulation's counters those
    of B8a's simulation on the shared-origin rows, which test the same
    leaves."""
    _, ps, _, pcam = scenes
    cam, words, summ, floors = pt._camera_words(ps, pcam, W, H)
    pids = torch.arange(words.shape[0])
    plain = pt.camera_wl_plain(cam, W, H, ps.tri_rows, ps.leaves, words,
                               pids)
    sim, stats, tally = pt.camera_wl_sim(cam, W, H, ps.tri_rows, ps.leaves,
                                         words, floors, pids)
    assert all(torch.equal(a, b) for a, b in zip(sim[4:], plain[4:]))
    same = sim[3] == plain[3]
    for a, b in zip(sim[:3], plain[:3]):
        assert torch.equal(a[same], b[same])
    assert torch.allclose(sim[0][~same], plain[0][~same], rtol=1e-5, atol=0)
    assert float(same.float().mean()) > 0.999
    _, stats_sh, _ = pt.camera_wl_sim(
        cam, W, H, pt.shared_rows(ps.tri_rows, pcam.pos), ps.leaves, words,
        floors, pids, shared=True)
    # the cull and the leaves kept do not depend on the rows' form
    assert torch.equal(stats[:, [0, 1, 4]], stats_sh[:, [0, 1, 4]])
    assert tally.shape == (len(pt.TALLY), len(pids) * pt.WARPS)


def test_counter_frame_keeps_shared_rows(scenes, monkeypatch):
    """The counter frame (B8a/B8b) takes the shared-origin rows, as the
    JAX package's ``camera_trace_stats`` (:3665): it builds the camera's
    and the light's tables, the fwd frame (B2/B4 on the raw rows) none,
    and its image is the fwd frame's."""
    _, ps, _, pcam = scenes
    ps = dataclasses.replace(ps, lights=Light.make(LIGHT, (1.0, 1.0, 1.0),
                                                   120.0, device="cpu"))
    calls = []
    table = pt.shared_rows
    monkeypatch.setattr(pt, "shared_rows",
                        lambda *a: calls.append(1) or table(*a))
    opts = RenderOpts(**OPTS)
    img, counts = render_frame_fast_stats(ps, pcam, W, H, opts)
    assert len(calls) == 2  # the camera's and the light's
    calls.clear()
    fwd = render_frame(ps, pcam, W, H, opts)
    assert not calls
    err = (img - fwd).abs().amax(-1)
    assert float((err > 2e-3).float().mean()) <= 2e-3
    assert counts and all(int(v) >= 0 for v in counts.values())


def test_raw_fwd_frame_matches_jax(forced_raw):
    """The fwd frame of city_scene(4) at leaf 16 and 128 x 128 (bench.py's
    camera), the JAX package's on its raw form: within 2e-3 on >= 99.8 %
    of pixels (ROADMAP's image rule). The JAX frame runs eagerly, its
    ``__wrapped__`` body, so that the patched rule is read."""
    g = jproc.city_scene(4).flatten()
    lo, hi = g.bounds()
    bvh = j_build_bvh(lo, hi, leaf_size=16)
    light = ((0.0, 30.0, 0.0), (1.0, 1.0, 1.0), 120.0)
    js = j_make_traced_scene(g, bvh, lights=JLight.make(*light))
    ps = make_traced_scene(pproc.city_scene(4).flatten(), bvh,
                           lights=Light.make(*light, device="cpu"),
                           device="cpu")
    c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
    ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
    pos, target = tuple(c + np.array([0.45, 0.35, 0.9]) * ext), tuple(c)
    jimg = np.asarray(j_render_frame_fast.__wrapped__(
        js, JCamera.look_at(pos=pos, target=target), 128, 128,
        JRenderOpts(**OPTS)))
    pimg = render_frame(ps, Camera.look_at(pos=pos, target=target,
                                           device="cpu"), 128, 128,
                        RenderOpts(**OPTS)).numpy()
    err = np.abs(pimg - jimg).max(-1)
    assert (err > 2e-3).mean() <= 2e-3, err.max()
    assert jimg.max() > 0.1


def _section_10m_source():
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    body = src[src.index("def section_10m"):]
    return body[:body.index("\ndef ")]


def test_scene_10m_is_bench_py_section_10m():
    """The port's 10 Mtri configuration against bench.py's
    ``section_10m`` (bench.py:350-398), read from its source: the size
    (2236), the light, the camera offset and the options; then built at a
    small size (terrain_scene(40)) on the CPU: the geometry the JAX
    package's, the camera the one bench.py's lines give on the JAX
    package's root box, leaf tables by default and node tables with
    ``walk``, leaves of at most 32 triangles, and the three seconds
    bench.py records."""
    src = _section_10m_source()
    n = int(re.search(r"\bn = (\d+)", src).group(1))
    assert n == bs.BENCH_N["terrain_10m"] == 2236
    make, leaf, lpos, radius, offset = bs.SCENES["terrain_10m"]
    assert "Light.make((0.0, 60.0, 0.0), (1.0, 1.0, 1.0), 400.0)" in src
    assert lpos == (0.0, 60.0, 0.0) and radius == 400.0
    assert "np.array([0.35, 0.25, 0.4]) * ext" in src
    assert offset == (0.35, 0.25, 0.4)
    assert make is pproc.terrain_scene and leaf == pt.IVAL_LEAF
    assert ("RenderOpts(reflections=False, transparency=False,\n"
            "                      textures=False)") in src
    jopts = JRenderOpts(**OPTS)
    assert all(getattr(bs.OPTS_10M, f.name) == getattr(jopts, f.name)
               for f in dataclasses.fields(bs.OPTS_10M))

    small = 40
    scene, cam, g, bvh, secs = bs.scene_10m(small, device="cpu")
    assert set(secs) == {"gen_s", "build_s", "pack_s"}
    assert all(v >= 0.0 for v in secs.values())
    jg = jproc.terrain_scene(small).flatten()
    assert g.num_tris == jg.num_tris == 2 * small * small
    for f in ("a", "ba", "ca", "mat_id"):
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
    # bench.py:372-383 on the JAX package's scene (its root box does not
    # depend on the leaf size)
    lo, hi = jg.bounds()
    js = j_make_traced_scene(jg, j_build_bvh(lo, hi, leaf_size=leaf))
    slo, shi = np.asarray(js.node_lo[0]), np.asarray(js.node_hi[0])
    center = (slo + shi) * 0.5
    ext = float(np.max(shi - slo))
    jcam = JCamera.look_at(
        pos=tuple(center + np.array([0.35, 0.25, 0.4]) * ext),
        target=tuple(center))
    for k in ("pos", "right", "up", "front"):
        np.testing.assert_allclose(getattr(cam, k).numpy(),
                                   np.asarray(getattr(jcam, k)), atol=1e-6)
    lights = scene.lights
    np.testing.assert_array_equal(lights.pos.numpy(), [[0.0, 60.0, 0.0]])
    np.testing.assert_array_equal(lights.color.numpy(), [[1.0, 1.0, 1.0]])
    np.testing.assert_array_equal(lights.radius.numpy(), [400.0])
    assert scene.leaves is not None and scene.nodes is None
    assert int(scene.leaves.count.max()) <= pt.IVAL_LEAF
    walk, _, _, _, _ = bs.scene_10m(small, device="cpu", walk=True)
    assert walk.leaves is None and walk.nodes is not None
    assert torch.equal(walk.tri_rows, scene.tri_rows)
