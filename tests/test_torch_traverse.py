"""The port's plain kernel versions (B1-B6) against the JAX package's
Pallas kernels, run in interpret mode on the CPU, on one scene and BVH.

Scene: city_scene(6) at leaf size 4 (~90 leaves), a 128 x 64 frame
(2 packets) of primary rays, 2 packets of shadow rays from a light and
2 packets (the last one partial) of bounce rays with their own origins.
Each JAX kernel runs once per module (module-scoped fixtures)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snail_tpu.bvh import build_bvh
from snail_tpu.core.types import Camera as JCamera
from snail_tpu.core.types import Light as JLight
from snail_tpu.ops import traverse_pallas as tp
from snail_tpu.scene import procedural as jproc
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.core.types import Camera
from snail_tpu_torch.core.vecmath import BIG
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.scene.scene import traced_scene_from_numpy

W, H = 128, 64
LIGHT = np.array([0.0, 30.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def scenes():
    g = jproc.city_scene(6).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=4)
    js = j_make_traced_scene(
        g, bvh, lights=JLight.make(LIGHT, (1.0, 1.0, 1.0), 120.0))
    assert js.wl_lfc is not None  # the JAX worklist path
    fields = {k: np.asarray(getattr(js, k)) for k in (
        "node_lo", "node_hi", "node_child", "node_count", "tri_a", "tri_ba",
        "tri_ca", "sh_mat", "sh_pack", "mat_pack", "mat_diffuse",
        "mat_specular", "mat_reflect", "mat_dissolve")}
    ps = traced_scene_from_numpy(fields, device="cpu")
    slo, shi = np.asarray(js.node_lo[0]), np.asarray(js.node_hi[0])
    c = (slo + shi) * 0.5
    ext = float(np.max(shi - slo))
    jcam = JCamera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9]) * ext),
                           target=tuple(c))
    # the port's camera holds the JAX camera's exact basis
    pcam = Camera(**{k: torch.from_numpy(np.array(getattr(jcam, k)))
                     for k in ("pos", "right", "up", "front", "plane_dist")})
    return js, ps, jcam, pcam


def _decode_jax_words(block, k_bands, lp):
    """JAX word block (P, rows, lanes) -> bits (P, K, lp), floors (P, K).
    Word (blk, sb, g) of band b is at row b*5+g, lane blk*8+sb; its bit p
    is leaf blk*1024 + sb*128 + g*32 + p (traverse_pallas._wl_block_shape)."""
    block = np.asarray(block)
    t = np.arange(lp)
    blk, sb, g, p = t >> 10, (t >> 7) & 7, (t >> 5) & 3, t & 31
    bits = np.stack([
        (block[:, b * 5 + g, blk * 8 + sb] >> p) & 1 for b in range(k_bands)
    ], axis=1).astype(bool)
    floors = block[:, k_bands * 5, :k_bands].view(np.float32)
    return bits, floors


def _check_words(jblock, port, k_bands, lp):
    jbits, jfloors = _decode_jax_words(jblock, k_bands, lp)
    words, summ, floors = port
    pbits = pt.unpack_bits(words).numpy()
    # per (packet, leaf): the same pass verdict and the same band
    np.testing.assert_array_equal(pbits.any(1), jbits.any(1))
    np.testing.assert_array_equal(pbits.argmax(1), jbits.argmax(1))
    np.testing.assert_array_equal(pbits, jbits)
    # band floors within an ulp: the JAX raygen's rsqrt is not correctly
    # rounded, which moves the packet's far bound by an ulp
    np.testing.assert_allclose(floors.numpy(), jfloors, rtol=3e-7)
    # summary bit j of word s <=> word 32*s + j nonzero
    np.testing.assert_array_equal(
        pt.unpack_bits(summ).numpy(), (words != 0).numpy())
    assert pbits.any(), "no leaf passed: the scene does not test the pass"


@pytest.fixture(scope="module")
def camera_words(scenes):
    js, ps, jcam, pcam = scenes
    p = (W // pt.TILE) * (H // pt.TILE)
    cam_rb = tp._cam_vec_rb(jcam, W, H, W // tp.TILE, js.node_lo[0],
                            js.node_hi[0])
    jblock = tp._run_words_camera(cam_rb, js.lf_boxv, p, tp.WL_BANDS,
                                  js.wl_nl)
    cam = pt.cam_vec(pcam, W, H, ps.root_lo, ps.root_hi)
    np.testing.assert_array_equal(cam.numpy(), np.asarray(cam_rb))
    port = pt.words_camera(cam, W, H, ps.leaves, pt.WL_BANDS)
    return jblock, port


def test_words_camera_plain_matches_jax(scenes, camera_words):
    _, ps, _, _ = scenes
    jblock, port = camera_words
    _check_words(jblock, port, pt.WL_BANDS, ps.leaves.lp)
    # several bands in use: the equal-count edges are exercised
    assert (pt.unpack_bits(port[0]).any(-1).sum(1) > 1).all()


@pytest.fixture(scope="module")
def shadow_rays(scenes):
    """2 packets of shadow rays from the light to seeded scene points."""
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
    tm[::97] = -BIG  # masked rays
    return d, tm


@pytest.fixture(scope="module")
def shared_words(scenes, shadow_rays):
    js, ps, _, _ = scenes
    d, tm = shadow_rays
    pk = lambda a: a.reshape(-1, pt.PACKET_R)
    jpk = lambda a: jnp.asarray(a.reshape(-1, tp.RAY_SUB, tp.RAY_LANE))
    orig = jnp.pad(jnp.asarray(LIGHT), (0, 1))
    jblock = tp._run_words_shared(
        orig, *(jpk(d[:, k]) for k in range(3)), jpk(tm), js.lf_boxv, 1,
        js.wl_nl)
    port = pt.words_shared(torch.from_numpy(LIGHT),
                           tuple(torch.from_numpy(pk(d[:, k]))
                                 for k in range(3)),
                           torch.from_numpy(pk(tm)), ps.leaves, 1)
    return jblock, port


def test_words_shared_plain_matches_jax(scenes, shared_words):
    _, ps, _, _ = scenes
    _check_words(*shared_words, 1, ps.leaves.lp)


def test_camera_trace_plain_matches_jax(scenes):
    js, ps, jcam, pcam = scenes
    jd, ju, jv, jt, jdx, jdy, jdz = (np.asarray(a) for a in
                                     tp.camera_trace(js, jcam, W, H))
    pd, pu, pv, ptri, pdx, pdy, pdz = (a.numpy() for a in
                                       pt.camera_trace(ps, pcam, W, H))
    # tolerances of tests/test_pallas.py:130-153, for the reasons given
    # there (shared-origin precompute and association order)
    np.testing.assert_allclose(pd, jd, rtol=2e-4, atol=2e-4)
    for a, b in ((pdx, jdx), (pdy, jdy), (pdz, jdz)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    hit = jd < BIG
    assert hit.mean() > 0.3 and (~hit).any()
    np.testing.assert_array_equal(ptri[~hit], -1)
    assert (ptri[hit] == jt[hit]).mean() > 0.999
    # barycentrics where both found the same triangle (at a tie, the other
    # triangle's u, v are right for it)
    same = hit & (ptri == jt)
    np.testing.assert_allclose(pu[same], ju[same], atol=2e-3)
    np.testing.assert_allclose(pv[same], jv[same], atol=2e-3)


def test_any_hit_shared_plain_matches_jax(scenes, shadow_rays):
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
    # test_pallas.py:183-190: blockers at the 0.9999 epsilon boundary
    assert (pb[live] == jb[live]).mean() > 0.999


def test_any_hit_shared_pads_partial_packets(scenes, shadow_rays):
    _, ps, _, _ = scenes
    d, tm = shadow_rays
    n = 5000
    full = pt.any_hit_shared(ps, torch.from_numpy(LIGHT),
                             tuple(torch.from_numpy(d[:, k])
                                   for k in range(3)),
                             torch.from_numpy(tm))
    part = pt.any_hit_shared(ps, torch.from_numpy(LIGHT),
                             tuple(torch.from_numpy(d[:n, k])
                                   for k in range(3)),
                             torch.from_numpy(tm[:n]))
    assert part.shape == (n,)
    # padding only adds masked rays; the packet interval is unchanged or
    # narrower, and verdicts are per ray
    assert torch.equal(part, full[:n])


@pytest.fixture(scope="module")
def bounce_rays(scenes):
    """Seeded rays with their own origins: 2 packets less 1000 rays, so
    the last packet is partial; every 7th ray masked. Origins in the
    street level of the scene box, directions random."""
    js, _, _, _ = scenes
    rng = np.random.default_rng(11)
    n = 2 * pt.PACKET_R - 1000
    lo, hi = np.asarray(js.node_lo[0]), np.asarray(js.node_hi[0])
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 2.0, n)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tm = np.full(n, BIG, np.float32)
    tm[::7] = -BIG
    tm[1::13] = rng.uniform(1.0, 8.0, len(tm[1::13]))  # finite tmax
    o[::7] = 1e30  # garbage on masked rays, as miss points carry
    return o, d, tm


def _planes(bounce_rays):
    o, d, tm = bounce_rays
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return pt.general_planes(tuple(t(o[:, k]) for k in range(3)),
                             tuple(t(d[:, k]) for k in range(3)), t(tm))


def test_substitute_masked_matches_jax(bounce_rays):
    o, d, tm = bounce_rays
    po, pd, ptm, n = _planes(bounce_rays)
    assert n == len(tm) and ptm.shape == (2, pt.PACKET_R)
    jo = tp._substitute_masked(
        tuple(tp._pad_flat(jnp.asarray(o[:, k]))[0] for k in range(3)),
        tp._pad_flat(jnp.asarray(tm), -BIG)[0])
    jd = tp._substitute_masked(
        tuple(tp._pad_flat(jnp.asarray(d[:, k]), 1.0)[0] for k in range(3)),
        tp._pad_flat(jnp.asarray(tm), -BIG)[0], unit_fallback=True)
    for a, b in zip(po + pd, jo + jd):
        np.testing.assert_allclose(a.numpy().reshape(-1), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)
    # masked rays lie inside their packet's live bounds
    live = (ptm >= 0).numpy()
    for c in po + pd:
        c = c.numpy()
        for i in range(c.shape[0]):
            lv = c[i][live[i]]
            assert lv.min() <= c[i].min() and c[i].max() <= lv.max()


@pytest.fixture(scope="module")
def general_words(scenes, bounce_rays):
    """B5 on the port's padded, substituted planes, in both packages."""
    js, ps, _, _ = scenes
    o, d, tm, _ = _planes(bounce_rays)
    jpk = lambda a: jnp.asarray(a.numpy().reshape(-1, tp.RAY_SUB,
                                                  tp.RAY_LANE))
    jblock = tp._run_words_general(*(jpk(c) for c in (*o, *d, tm)),
                                   js.lf_boxv, tp.WL_BANDS, js.wl_nl)
    port = pt.words_general(o, d, tm, ps.leaves, pt.WL_BANDS)
    return jblock, port, jpk


def test_words_general_plain_matches_jax(scenes, general_words):
    _, ps, _, _ = scenes
    jblock, port, _ = general_words
    _check_words(jblock, port, pt.WL_BANDS, ps.leaves.lp)


def test_closest_wl_g_plain_matches_jax(scenes, bounce_rays, general_words):
    js, ps, _, _ = scenes
    jblock, port, jpk = general_words
    o, d, tm, _ = _planes(bounce_rays)
    jd, ju, jv, jt = (np.asarray(a).reshape(tm.shape) for a in
                      tp._run_closest_wl_g(
                          js.wl_lfc, *(jpk(c) for c in (*o, *d, tm)),
                          js.pk_tris, js.wl_boxrows, jblock, tp.WL_BANDS,
                          js.lf_boxv.shape[1]))
    pd, pu, pv, ptri = (a.numpy() for a in pt.closest_wl_g_plain(
        o, d, tm, ps.tri_rows, ps.leaves, port[0]))
    _check_closest(pd, pu, pv, ptri, jd, ju, jv, jt, tm.numpy())


def _check_closest(pd, pu, pv, ptri, jd, ju, jv, jt, tm):
    """Bounce closest-hit outputs against the JAX package's: exact miss and
    masked conventions, dist allclose, tri ids equal but at ties."""
    big = np.float32(BIG)
    live = tm >= 0
    hit = live & (jd < big)
    assert 0.05 < hit.sum() / live.sum() < 0.95
    np.testing.assert_array_equal(jd[~live], -big)
    np.testing.assert_array_equal(pd[~live], -big)
    np.testing.assert_array_equal(pd[live & ~hit], big)
    np.testing.assert_array_equal(ptri[~hit], 0)
    np.testing.assert_array_equal(jt[~hit], 0)
    np.testing.assert_allclose(pd[hit], jd[hit], rtol=2e-4, atol=2e-4)
    assert (ptri[hit] == jt[hit]).mean() > 0.999
    same = hit & (ptri == jt)
    np.testing.assert_allclose(pu[same], ju[same], atol=2e-3)
    np.testing.assert_allclose(pv[same], jv[same], atol=2e-3)
    # a finite tmax bounds the hit
    assert (pd[hit] < tm[hit] * (1 + 1e-6)).all()


def test_closest_hit_c_plain_matches_jax(scenes, bounce_rays):
    js, ps, _, _ = scenes
    o, d, tm = bounce_rays
    jout = [np.asarray(a) for a in tp.closest_hit_c(
        js, tuple(jnp.asarray(o[:, k]) for k in range(3)),
        tuple(jnp.asarray(d[:, k]) for k in range(3)), jnp.asarray(tm))]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    pout = [a.numpy() for a in pt.closest_hit_c(
        ps, tuple(t(o[:, k]) for k in range(3)),
        tuple(t(d[:, k]) for k in range(3)), t(tm))]
    assert all(a.shape == (len(tm),) for a in pout)
    assert pout[3].dtype == np.int32
    _check_closest(*pout, *jout, tm)


def test_wrappers_route_by_device(scenes):
    """CPU tensors take the plain versions and count no launch; other
    non-CUDA devices are refused."""
    _, ps, _, pcam = scenes
    pt.reset_launch_counts()
    pt.camera_trace(ps, pcam, 64, 64)
    assert pt.launch_counts() == {k.__name__: 0 for k in pt.KERNELS}
    cam = pt.cam_vec(pcam, 64, 64, ps.root_lo, ps.root_hi).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pt.words_camera(cam, 64, 64, ps.leaves)


def test_camera_trace_rejects_partial_tiles(scenes):
    _, ps, _, pcam = scenes
    with pytest.raises(ValueError, match="tile"):
        pt.camera_trace(ps, pcam, 96, 64)
