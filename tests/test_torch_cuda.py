"""The CUDA kernels of snail_tpu_torch against their plain PyTorch
versions, on the card. Needs a CUDA device and nvcc (the kernels are built
at first use); every test skips without a card. Imports no JAX, so it runs
where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from snail_tpu_torch.bvh import build_bvh
from snail_tpu_torch.bvh.build import BVH
from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.core.vecmath import BIG
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.ops.traverse_ref import (_tiles, _WarpWalk,
                                              camera_sim,
                                              fat_camera_plain,
                                              fat_closest_plain,
                                              fat_shadow_g_plain,
                                              fat_shadow_plain,
                                              walk_camera_plain,
                                              walk_camera_stats_plain,
                                              walk_closest_g_plain,
                                              walk_plain,
                                              walk_shadow_g_plain,
                                              walk_shadow_plain,
                                              walk_shadow_stats_plain)
from snail_tpu_torch.render.fast import render_frame_fast_stats
from snail_tpu_torch.render.renderer import render_frame
from snail_tpu_torch.scene import instancing
from snail_tpu_torch.scene.bench_scenes import (STEP_OPTS, bench_scene,
                                                bench_step, bounce_materials,
                                                instanced_grid)
from snail_tpu_torch.scene.base_scene import FlatGeometry
from snail_tpu_torch.scene.procedural import city_scene, terrain_scene
from snail_tpu_torch.scene.scene import make_traced_scene

pytestmark = pytest.mark.cuda

OPTS = RenderOpts(reflections=False, transparency=False, textures=False)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _scene(which: str, bounce: bool = False, walk: bool = False,
           leaf: int = 4):
    """(scene on the card, camera, width, height, light position); with
    ``bounce``, material 0 reflective and half transparent; with ``walk``,
    node tables for the walk kernels in place of leaf tables; ``leaf``,
    the BVH's leaf size (64: a fat-leaf scene)."""
    if which == "city":
        g = city_scene(6).flatten()
        light, r, size = (0.0, 30.0, 0.0), 120.0, (256, 128)
    else:  # > 1024 leaves at leaf 4: several summary words per band
        g = terrain_scene(48).flatten()
        light, r, size = (0.0, 60.0, 0.0), 200.0, (256, 256)
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=leaf)
    scene = make_traced_scene(g, bvh, bounce_materials() if bounce else None,
                              lights=Light.make(light, (1, 1, 1), r),
                              walk=walk)
    c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
    ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
    cam = Camera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9]) * ext),
                         target=tuple(c))
    return scene, cam, size[0], size[1], torch.tensor(light, device="cuda")


SCENES = ["city", "terrain"]


def _assert_words_equal(kern, plain):
    kw, ks, kf = kern
    pw, ps, pf = plain
    assert torch.equal(kw, pw)
    assert torch.equal(ks, ps)
    torch.testing.assert_close(kf, pf, rtol=0.0, atol=0.0)
    assert kw.ne(0).any()


@pytest.mark.parametrize("which", SCENES)
def test_words_camera_kernel_matches_plain(which):
    _need_cuda()
    scene, cam, w, h, _ = _scene(which)
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    kern = pt.words_camera(cv, w, h, scene.leaves, pt.WL_BANDS)
    torch.cuda.synchronize()
    p = (w // pt.TILE) * (h // pt.TILE)
    plain = pt.words_camera_plain(cv, w, h, scene.leaves, pt.WL_BANDS,
                                  torch.arange(p, device="cuda"))
    _assert_words_equal(kern, plain)


def _shadow_rays(scene, light, n_packets, seed=3):
    rng = np.random.default_rng(seed)
    lo, hi = scene.root_lo.cpu().numpy(), scene.root_hi.cpu().numpy()
    n = n_packets * pt.PACKET_R
    tgt = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    tgt[:, 1] = rng.uniform(lo[1], lo[1] + 0.3 * (hi[1] - lo[1]), n)
    d = tgt - light.cpu().numpy()
    ld = np.linalg.norm(d, axis=-1)
    tm = (ld * 0.9999).astype(np.float32)
    tm[::89] = -BIG
    pk = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float32).reshape(-1, pt.PACKET_R)).cuda()
    return tuple(pk(d[:, k] / ld) for k in range(3)), pk(tm)


@pytest.mark.parametrize("which", SCENES)
def test_words_shared_kernel_matches_plain(which):
    _need_cuda()
    scene, _, _, _, light = _scene(which)
    d, tm = _shadow_rays(scene, light, 6)
    kern = pt.words_shared(light, d, tm, scene.leaves, 1)
    torch.cuda.synchronize()
    _assert_words_equal(kern, pt.words_shared_plain(light, d, tm,
                                                    scene.leaves, 1))


@pytest.mark.parametrize("which", SCENES)
def test_camera_wl_kernel_matches_plain(which):
    _need_cuda()
    scene, cam, w, h, _ = _scene(which)
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    words, summ, floors = pt.words_camera(cv, w, h, scene.leaves)
    rows = scene.tri_rows
    kern = pt.camera_wl(cv, w, h, rows, scene.leaves, words, summ, floors)
    torch.cuda.synchronize()
    p = (w // pt.TILE) * (h // pt.TILE)
    plain = pt.camera_wl_plain(cv, w, h, rows, scene.leaves, words,
                               torch.arange(p, device="cuda"))
    kd, ku, kv, kt, *kdir = (a.cpu().numpy() for a in kern)
    pd, pu, pv, ptri, *pdir = (a.cpu().numpy() for a in plain)
    # tolerances of tests/test_pallas.py:130-153
    np.testing.assert_allclose(kd, pd, rtol=2e-4, atol=2e-4)
    for a, b in zip(kdir, pdir):
        np.testing.assert_allclose(a, b, atol=1e-6)
    hit = pd < BIG
    assert hit.mean() > 0.3
    assert (kt[hit] == ptri[hit]).mean() > 0.999
    np.testing.assert_array_equal(kt[~hit], -1)
    # barycentrics where both found the same triangle (at a tie, the other
    # triangle's u, v are right for it)
    same = hit & (kt == ptri)
    np.testing.assert_allclose(ku[same], pu[same], atol=2e-3)
    np.testing.assert_allclose(kv[same], pv[same], atol=2e-3)


@pytest.mark.parametrize("which", SCENES)
def test_shadow_wl_kernel_matches_plain(which):
    _need_cuda()
    scene, _, _, _, light = _scene(which)
    d, tm = _shadow_rays(scene, light, 6)
    words, summ, floors = pt.words_shared(light, d, tm, scene.leaves, 1)
    rows = scene.tri_rows
    kern = pt.shadow_wl(light, d, tm, rows, scene.leaves, words, summ,
                        floors)
    torch.cuda.synchronize()
    plain = pt.shadow_wl_plain(light, d, tm, rows, scene.leaves, words)
    live = (tm >= 0).cpu().numpy()
    kb, pb = kern.cpu().numpy(), plain.cpu().numpy()
    assert not kb[~live].any()
    assert 0.02 < pb[live].mean() < 0.98
    # test_pallas.py:183-190: blockers at the 0.9999 epsilon boundary
    assert (kb[live] == pb[live]).mean() > 0.999


def _bounce_rays(scene, n_packets, seed=7, planes=pt.general_planes):
    """Seeded rays with their own origins, the last packet 1000 rays
    short: each packet's rays start near a point of the scene box and run
    in a narrow cone (down into the geometry or up out of it); every 7th
    ray masked, with a garbage origin as a miss point carries, and every
    3rd live one with a finite tmax. Returns the planes of ``planes``
    (``general_planes``, or the fat-leaf kernels' ``padded_planes``)."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.root_lo.cpu().numpy(), scene.root_hi.cpu().numpy()
    shape = (n_packets, pt.PACKET_R, 3)
    o = (rng.uniform(lo, hi, (n_packets, 1, 3))
         + rng.uniform(-0.01, 0.01, shape) * (hi - lo))
    axis = rng.normal(size=(n_packets, 1, 3))
    d = axis / np.linalg.norm(axis, axis=-1, keepdims=True)
    d = d + rng.uniform(-0.05, 0.05, shape)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = np.full(shape[:2], BIG)
    if planes is pt.padded_planes:
        diag = np.linalg.norm(hi - lo)
        tm[:, 1::3] = rng.uniform(0.05, 0.5, tm[:, 1::3].shape) * diag
    tm[:, ::7] = -BIG
    o[:, ::7] = 1e30
    n = n_packets * pt.PACKET_R - 1000
    flat = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float32).reshape(-1)[:n]).cuda()
    o, d, tm, _ = planes(tuple(flat(o[..., k]) for k in range(3)),
                         tuple(flat(d[..., k]) for k in range(3)), flat(tm))
    return o, d, tm


@pytest.mark.parametrize("which", SCENES)
def test_words_general_kernel_matches_plain(which):
    _need_cuda()
    scene, _, _, _, _ = _scene(which)
    o, d, tm = _bounce_rays(scene, 6)
    kern = pt.words_general(o, d, tm, scene.leaves)
    torch.cuda.synchronize()
    _assert_words_equal(kern, pt.words_general_plain(o, d, tm, scene.leaves,
                                                     pt.WL_BANDS))


@pytest.mark.parametrize("which", SCENES)
def test_closest_wl_g_kernel_matches_plain(which):
    _need_cuda()
    scene, _, _, _, _ = _scene(which)
    o, d, tm = _bounce_rays(scene, 6)
    words, summ, floors = pt.words_general(o, d, tm, scene.leaves)
    kern = pt.closest_wl_g(o, d, tm, scene.tri_rows, scene.leaves, words,
                           summ, floors)
    torch.cuda.synchronize()
    plain = pt.closest_wl_g_plain(o, d, tm, scene.tri_rows, scene.leaves,
                                  words)
    kd, ku, kv, kt = (a.cpu().numpy() for a in kern)
    pd, pu, pv, ptri = (a.cpu().numpy() for a in plain)
    live = (tm >= 0).cpu().numpy()
    big = np.float32(BIG)
    hit = live & (pd < big)
    assert 0.02 < hit.sum() / live.sum() < 0.98
    np.testing.assert_array_equal(kd[~live], -big)
    np.testing.assert_array_equal(kd[live & ~hit], big)
    np.testing.assert_array_equal(kt[~hit], 0)
    np.testing.assert_allclose(kd, pd, rtol=2e-4, atol=2e-4)
    assert (kt[hit] == ptri[hit]).mean() > 0.999
    same = hit & (kt == ptri)
    np.testing.assert_allclose(ku[same], pu[same], atol=2e-3)
    np.testing.assert_allclose(kv[same], pv[same], atol=2e-3)


@pytest.mark.parametrize("which", SCENES)
def test_bounce_frame_on_card_matches_cpu(which):
    _need_cuda()
    scene, cam, w, h, _ = _scene(which, bounce=True)
    opts = RenderOpts(textures=False)
    pt.reset_launch_counts()
    img = render_frame(scene, cam, w, h, opts)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    # the six kernels of the bounce path; B7 and B8 run on other paths
    assert all(counts[k.__name__] > 0 for k in pt.KERNELS[:6]), counts
    ref = render_frame(scene.to("cpu"), cam.to("cpu"), w, h, opts)
    err = (img.cpu() - ref).abs().amax(-1)
    assert torch.isfinite(img).all() and img.abs().amax() > 0
    assert (err > 2e-3).float().mean() < 1e-3, float(err.max())


def test_diff_step_on_card_matches_cpu():
    """bench.py's fwd+bwd step (7 parameters, reflections and shadows) on
    the card and on the CPU path, against a target at half the light
    colour."""
    _need_cuda()
    scene, cam, w, h, _ = _scene("city", bounce=True)
    half = dataclasses.replace(scene, lights=Light(
        pos=scene.lights.pos, color=scene.lights.color * 0.5,
        radius=scene.lights.radius))
    target = render_frame(half, cam, w, h, STEP_OPTS)
    pt.reset_launch_counts()
    lk, gk = bench_step(scene, cam, target, w, h)
    counts = pt.launch_counts()
    # the six kernels of the bounce path; B7 and B8 run on other paths
    assert all(counts[k.__name__] > 0 for k in pt.KERNELS[:6]), counts
    lc, gc = bench_step(scene.to("cpu"), cam.to("cpu"), target.cpu(), w, h)
    # tests/test_fast_diff.py:83-91
    lk, lc = float(lk), float(lc)
    assert abs(lk - lc) < 3e-4 * max(1.0, abs(lc))
    for k in gc:
        a, b = gk[k].cpu().numpy(), gc[k].numpy()
        denom = max(np.abs(b).max(), 1e-8)
        assert np.isfinite(a).all() and np.abs(b).max() > 0, k
        assert np.quantile(np.abs(a - b), 0.999) < 5e-3 * denom, k
        assert np.abs(a - b).mean() < 1e-3 * denom, k


@pytest.mark.parametrize("which", SCENES)
def test_render_frame_on_card_matches_cpu(which):
    _need_cuda()
    scene, cam, w, h, _ = _scene(which)
    pt.reset_launch_counts()
    img = render_frame(scene, cam, w, h, OPTS)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    # the forward frame's kernels; no bounce wavefront
    assert all(counts[k.__name__] > 0 for k in pt.KERNELS[:4]), counts
    assert counts["words_general"] == counts["closest_wl_g"] == 0, counts
    ref = render_frame(scene.to("cpu"), cam.to("cpu"), w, h, OPTS)
    err = (img.cpu() - ref).abs().amax(-1)
    assert torch.isfinite(img).all() and img.abs().amax() > 0
    # pixels off by more than 2e-3 are hit ties (ROADMAP C7)
    assert (err > 2e-3).float().mean() < 1e-3, float(err.max())


def test_wrappers_check_inputs():
    _need_cuda()
    scene, cam, w, h, _ = _scene("city")
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    with pytest.raises(ValueError, match="float32"):
        pt.words_camera(cv.double(), w, h, scene.leaves)
    with pytest.raises(ValueError, match="on cpu"):
        pt.words_camera(cv, w, h, scene.leaves.to("cpu"))


def _shadow_g_rays(scene, n_packets, seed=11, planes=pt.general_planes):
    """The rays of ``_bounce_rays`` as shadow rays: each live ray looks
    0.05-0.6 of the scene box's diagonal far."""
    o, d, tm = _bounce_rays(scene, n_packets, seed, planes)
    rng = np.random.default_rng(seed)
    diag = float((scene.root_hi - scene.root_lo).norm())
    frac = torch.from_numpy(rng.uniform(0.05, 0.6, tuple(tm.shape))
                            .astype(np.float32)).cuda()
    return o, d, torch.where(tm >= 0, frac * diag, tm)


@pytest.mark.parametrize("which", SCENES)
def test_shadow_wl_g_kernel_matches_plain(which):
    _need_cuda()
    scene, _, _, _, _ = _scene(which)
    o, d, tm = _shadow_g_rays(scene, 6)
    words, summ, floors = pt.words_general(o, d, tm, scene.leaves, 1)
    kern = pt.shadow_wl_g(o, d, tm, scene.tri_rows, scene.leaves, words,
                          summ, floors)
    torch.cuda.synchronize()
    plain = pt.shadow_wl_g_plain(o, d, tm, scene.tri_rows, scene.leaves,
                                 words)
    live = (tm >= 0).cpu().numpy()
    kb, pb = kern.cpu().numpy(), plain.cpu().numpy()
    assert not kb[~live].any() and not pb[~live].any()
    assert 0.02 < pb[live].mean() < 0.98
    # every (ray, row) test is the plain version's arithmetic
    # (--fmad=false), so the verdicts are its own bit for bit
    assert torch.equal(kern, plain)


@pytest.mark.parametrize("which", SCENES)
def test_camera_wl_stats_kernel_matches_b2_and_simulation(which):
    """B8a on the shared-origin rows: B2's outputs on the raw rows bit for
    bit, and every packet's counters equal to the plain version's
    simulation of its warps."""
    _need_cuda()
    scene, cam, w, h, _ = _scene(which)
    cv, words, summ, floors = pt._camera_words(scene, cam, w, h)
    rows = pt.shared_rows(scene.tri_rows, cam.pos)
    *out, stats = pt.camera_wl_stats(cv, w, h, rows, scene.leaves, words,
                                     summ, floors)
    ref = pt.camera_wl(cv, w, h, scene.tri_rows, scene.leaves, words, summ,
                       floors)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    *_, sim = pt.camera_wl_stats_plain(
        cv, w, h, rows, scene.leaves, words, floors,
        torch.arange(stats.shape[0], device="cuda"))
    assert torch.equal(stats, sim), (stats, sim)
    assert (stats[:, 3] > 0).sum() > 1


@pytest.mark.parametrize("which", SCENES)
def test_camera_wl_kernels_match_simulation_exactly(which):
    """B2 and B8a on a whole frame of primary rays against the plain
    simulation of their warps (``camera_wl_sim``: each warp's scan, its
    kept leaves in order, the loop's first strictly nearer hit): dist, u,
    v, tri and the directions bit for bit, tri included at distance ties,
    and B8a's counters, whichever way the leaf stage tested a leaf."""
    _need_cuda()
    scene, cam, w, h, _ = _scene(which)
    cv, words, summ, floors = pt._camera_words(scene, cam, w, h)
    rows = scene.tri_rows
    kern = pt.camera_wl(cv, w, h, rows, scene.leaves, words, summ, floors)
    *out, stats = pt.camera_wl_stats(cv, w, h,
                                     pt.shared_rows(rows, cam.pos),
                                     scene.leaves, words, summ, floors)
    torch.cuda.synchronize()
    sim_out, sim, tally = pt.camera_wl_sim(
        cv, w, h, rows, scene.leaves, words, floors,
        torch.arange(words.shape[0], device="cuda"))
    assert all(torch.equal(a, b) for a, b in zip(kern, sim_out))
    assert all(torch.equal(a, b) for a, b in zip(out, kern))
    assert torch.equal(stats, sim), (stats, sim)
    t = dict(zip(pt.TALLY, tally.sum(1).tolist()))
    assert t["visits"] == int(stats[:, 2].sum()) > 0
    assert float((kern[0] < BIG).float().mean()) > 0.3


@pytest.mark.parametrize("which", SCENES)
def test_shadow_wl_stats_kernel_matches_b4_and_simulation(which):
    _need_cuda()
    scene, _, _, _, light = _scene(which)
    d, tm = _shadow_rays(scene, light, 3)
    words, summ, floors = pt.words_shared(light, d, tm, scene.leaves, 1)
    rows = pt.shared_rows(scene.tri_rows, light)
    blocked, stats = pt.shadow_wl_stats(light, d, tm, rows, scene.leaves,
                                        words, summ, floors)
    ref = pt.shadow_wl(light, d, tm, scene.tri_rows, scene.leaves, words,
                       summ, floors)
    torch.cuda.synchronize()
    assert torch.equal(blocked, ref)
    _, sim = pt.shadow_wl_stats_plain(light, d, tm, rows, scene.leaves, words,
                                      floors)
    assert torch.equal(stats, sim), (stats, sim)
    assert (stats[:, 3] > 0).sum() > 1


def _skipped_blocks(lt, summ, o, d, lim):
    """(warp, block) pairs of the populated blocks of a warp's packet whose
    box none of its lanes enters before its limit ``lim`` (P, PACKET_R):
    blocks that B4/B6 skip whole. ``o``: three 0-d or three (P, PACKET_R)."""
    n = 0
    for i in range(lim.shape[0]):
        lanes = lambda x: x[i].reshape(pt.WARPS, pt.WARP)
        oi = [c if c.dim() == 0 else lanes(c) for c in o]
        idir = [lanes(pt.safe_inv(c)) for c in d]
        for s in torch.nonzero(summ[i].ne(0).any(0)).flatten().tolist():
            tn, pas = pt._box_slab(lt.bbox, s, oi, idir)
            n += int((~(pas & (tn < lanes(lim))).any(1)).sum())
    return n


def _warp_shadow_rays(scene, light, n_packets, seed=5):
    """Rays from ``light`` to seeded points in the upper half of the scene
    box, each warp's 32 within 5 % of the box's extent of a point of its
    own, the packet's warps spread over the box (~20 % blocked); every
    89th masked."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.root_lo.cpu().numpy(), scene.root_hi.cpu().numpy()
    shape = (n_packets * pt.WARPS, pt.WARP, 3)
    tgt = (rng.uniform(lo, hi, (shape[0], 1, 3))
           + rng.uniform(-0.05, 0.05, shape) * (hi - lo))
    tgt[..., 1] = rng.uniform(lo[1] + 0.5 * (hi[1] - lo[1]), hi[1],
                              shape[:2])
    d = tgt.reshape(-1, 3) - light.cpu().numpy()
    ld = np.linalg.norm(d, axis=-1)
    tm = (ld * 0.9999).astype(np.float32)
    tm[::89] = -BIG
    pk = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float32).reshape(-1, pt.PACKET_R)).cuda()
    return tuple(pk(d[:, k] / ld) for k in range(3)), pk(tm)


@pytest.mark.parametrize("rays", ["camera", "shadow", "bounce"])
def test_wl_kernels_skip_whole_blocks_exactly(rays):
    """B4 (and B8b) on shadow rays, B6 on bounce rays, on a scene of three
    leaf blocks whose warps skip whole blocks, and B2 (and B8a), which keep
    the word scan, on its primary rays: outputs identical to the plain
    versions (B2's triangle may differ on a distance tie), B8a's and B8b's
    counters the simulation's."""
    _need_cuda()
    g = terrain_scene(96).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=8)
    scene = make_traced_scene(g, bvh)
    lt = scene.leaves
    assert lt.lp // pt.LEAF_BLOCK >= 3
    if rays == "camera":
        c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
        ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
        cam = Camera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9]) * ext),
                             target=tuple(c))
        w = h = 256
        cv, words, summ, floors = pt._camera_words(scene, cam, w, h)
        rows = pt.shared_rows(scene.tri_rows, cam.pos)
        kern = pt.camera_wl(cv, w, h, scene.tri_rows, lt, words, summ,
                            floors)
        *out, stats = pt.camera_wl_stats(cv, w, h, rows, lt, words, summ,
                                         floors)
        pids = torch.arange(words.shape[0], device="cuda")
        *plain, sim = pt.camera_wl_stats_plain(cv, w, h, rows, lt, words,
                                               floors, pids)
        assert all(torch.equal(a, b) for a, b in zip(out, kern))
        assert all(torch.equal(a, b) for a, b in zip(kern[4:], plain[4:]))
        _assert_closest_equal(kern[:4], plain[:4])
        assert torch.equal(stats, sim), (stats, sim)
        d, _, lim = pt._camera_rays(cv, w, h, pids)
        o = cv[9:12].unbind()
    elif rays == "shadow":
        light = torch.tensor((-40.0, 10.0, 0.0), device="cuda")
        d, tm = _warp_shadow_rays(scene, light, 6)
        words, summ, floors = pt.words_shared(light, d, tm, lt, 1)
        rows = pt.shared_rows(scene.tri_rows, light)
        kern = pt.shadow_wl(light, d, tm, scene.tri_rows, lt, words, summ,
                            floors)
        blocked, stats = pt.shadow_wl_stats(light, d, tm, rows, lt, words,
                                            summ, floors)
        plain, sim = pt.shadow_wl_stats_plain(light, d, tm, rows, lt, words,
                                              floors)
        assert torch.equal(kern, plain) and torch.equal(blocked, kern)
        assert torch.equal(stats, sim), (stats, sim)
        assert 0.02 < float(plain[tm >= 0].mean()) < 0.98
        o, lim = light.unbind(), torch.where(tm >= 0, tm, -BIG)
    else:
        o, d, tm = _bounce_rays(scene, 6)
        words, summ, floors = pt.words_general(o, d, tm, lt)
        kern = pt.closest_wl_g(o, d, tm, scene.tri_rows, lt, words, summ,
                               floors)
        plain = pt.closest_wl_g_plain(o, d, tm, scene.tri_rows, lt, words)
        assert all(torch.equal(a, b) for a, b in zip(kern, plain))
        live = tm >= 0
        assert 0.02 < float((plain[0] < BIG)[live].float().mean()) < 0.98
        lim = torch.where(live, tm.clamp_max(BIG), -BIG)
    assert _skipped_blocks(lt, summ, o, d, lim) > 0


@pytest.mark.parametrize("which", SCENES)
def test_stats_frame_on_card_matches_cpu(which):
    """The counter frame runs B8a once and B8b once per light, gives the
    forward frame's image, and the CPU path's image and counters."""
    _need_cuda()
    scene, cam, w, h, _ = _scene(which)
    pt.reset_launch_counts()
    img, st = render_frame_fast_stats(scene, cam, w, h, OPTS)
    counts = pt.launch_counts()
    assert counts["camera_wl_stats"] == 1, counts
    assert counts["shadow_wl_stats"] == len(scene.lights), counts
    assert counts["camera_wl"] == counts["shadow_wl"] == 0, counts
    assert torch.equal(img, render_frame(scene, cam, w, h, OPTS))
    ref, st_cpu = render_frame_fast_stats(scene.to("cpu"), cam.to("cpu"), w,
                                          h, OPTS)
    err = (img.cpu() - ref).abs().amax(-1)
    assert (err > 2e-3).float().mean() < 1e-3, float(err.max())
    assert st == st_cpu


def test_instanced_frame_on_card_matches_cpu():
    """Two instances of the bounce-material city through B5, B6 and B7,
    against the CPU path."""
    _need_cuda()
    scene, cam, w, h, _ = _scene("city", bounce=True)
    isc = instancing.make_instances(
        scene, torch.stack([torch.eye(3), instancing.rotation_y(0.7)]),
        [[0.0, 0.0, 0.0], [14.0, 0.0, -10.0]])
    opts = RenderOpts(textures=False)
    pt.reset_launch_counts()
    img = instancing.render_instanced(isc, cam, w, h, opts)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    assert all(counts[k] > 0 for k in ("words_general", "closest_wl_g",
                                       "shadow_wl_g")), counts
    assert counts["camera_wl"] == counts["shadow_wl"] == 0, counts
    ref = instancing.render_instanced(isc.to("cpu"), cam.to("cpu"), w, h,
                                      opts)
    err = (img.cpu() - ref).abs().amax(-1)
    assert torch.isfinite(img).all() and img.abs().amax() > 0
    assert (err > 2e-3).float().mean() < 1e-3, float(err.max())


def _padded_scene(which):
    """A scene whose last real word of leaves ends in padding slots (its
    leaf count is not a multiple of 32): city_scene(6) at leaf 4, one
    block of 1,024 slots, 105 leaves, so that all but the first rank of
    B5's cluster hold padding words only; terrain_scene(96) at leaf 8,
    three blocks, 2,879 leaves. (scene, camera, width, height)."""
    g = (city_scene(6) if which == "city" else terrain_scene(96)).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=4 if which == "city" else 8)
    scene = make_traced_scene(g, bvh, bounce_materials(),
                              lights=Light.make((0.0, 30.0, 0.0), (1, 1, 1),
                                                120.0))
    c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
    ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
    cam = Camera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9]) * ext),
                         target=tuple(c))
    return scene, cam, 256, 256


@pytest.mark.parametrize("which", SCENES)
def test_words_general_cluster_matches_plain(which):
    """B5, a cluster of blocks per packet, on scenes whose ranks hold
    padding slots: words, summaries and floors identical to the plain
    version's at 8 bands and at one, on the frame's own reflection
    wavefront and on seeded bounce rays; no bit in a word whose box the
    pre-test drops."""
    _need_cuda()
    from snail_tpu_torch.render.fast import bounce_wavefront

    scene, cam, w, h = _padded_scene(which)
    lt = scene.leaves
    assert lt.n_leaf % 32 and (lt.lp // pt.LEAF_BLOCK == 1) == (
        which == "city")
    dist, u, v, tri, dx, dy, dz = pt.camera_trace(scene, cam, w, h)
    primary = ((cam.pos[0], cam.pos[1], cam.pos[2]),
               (dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)),
               dist.reshape(-1), u.reshape(-1), v.reshape(-1),
               tri.reshape(-1))
    own = pt.general_planes(*bounce_wavefront(scene, *primary))[:3]
    for o, d, tm in (own, _bounce_rays(scene, 6)):
        for k_bands in (pt.WL_BANDS, 1):
            kern = pt.words_general(o, d, tm, lt, k_bands)
            torch.cuda.synchronize()
            plain = pt.words_general_plain(o, d, tm, lt, k_bands)
            _assert_words_equal(kern, plain)
            assert torch.equal(kern[2], plain[2])
            tested = pt.general_word_tests(o, d, tm, lt)
            assert not bool((kern[0].ne(0).any(1) & ~tested).any())


CLUSTERS = (1, 2, 4, 8)


def _check_clusters(run, plain, tested):
    """A words pass at 8 bands and at 1 over clusters of 1, 2, 4 and 8
    blocks per packet: words, summaries and floors identical to the plain
    version's, and no bit in a word whose box the pre-test drops.
    ``run(k_bands, cluster)``, ``plain(k_bands)``."""
    for k_bands in (pt.WL_BANDS, 1):
        ref = plain(k_bands)
        for cluster in CLUSTERS:
            kern = run(k_bands, cluster)
            torch.cuda.synchronize()
            _assert_words_equal(kern, ref)
            assert torch.equal(kern[2], ref[2]), cluster
        assert not bool((ref[0].ne(0).any(1) & ~tested).any())


@pytest.mark.parametrize("kernel", ["camera", "shared"])
@pytest.mark.parametrize("which", SCENES)
def test_words_camera_and_shared_clusters_match_plain(which, kernel):
    """B1 and B3 on the padded scenes (at 8 blocks a packet the city's
    ranks 1-7 hold padding only, and still join every barrier): B1 on the
    frame's primary rays, B3 on its shadow rays toward the light and on
    seeded shadow rays, each at every cluster size, as
    ``_check_clusters``."""
    _need_cuda()
    from snail_tpu_torch.render.fast import shadow_wavefront

    scene, cam, w, h = _padded_scene(which)
    lt = scene.leaves
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    if kernel == "camera":
        pids = torch.arange((w // pt.TILE) * (h // pt.TILE), device="cuda")
        _check_clusters(
            lambda k, c: pt.words_camera(cv, w, h, lt, k, c),
            lambda k: pt.words_camera_plain(cv, w, h, lt, k, pids),
            pt.camera_word_tests(cv, w, h, lt, pids))
        return
    light = scene.lights.pos[0].contiguous()
    dist, u, v, tri, dx, dy, dz = pt.camera_trace(scene, cam, w, h)
    primary = ((cam.pos[0], cam.pos[1], cam.pos[2]),
               (dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)),
               dist.reshape(-1), u.reshape(-1), v.reshape(-1),
               tri.reshape(-1))
    d, tm = shadow_wavefront(scene, *primary, light)
    pk = lambda a: a.reshape(-1, pt.PACKET_R).contiguous()
    for d, tm in (((pk(d[0]), pk(d[1]), pk(d[2])), pk(tm)),
                  _shadow_rays(scene, light, 6)):
        _check_clusters(
            lambda k, c: pt.words_shared(light, d, tm, lt, k, c),
            lambda k: pt.words_shared_plain(light, d, tm, lt, k),
            pt.shared_word_tests(light, d, tm, lt))


def _scattered_tables(lp, seed=4):
    """Leaf tables of ``lp`` real leaves on the card: seeded boxes of
    half-width 0.001-0.02 around points of [-1, 1]^3 (triangles none)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (3, lp))
    e = rng.uniform(0.001, 0.02, (3, lp))
    box = np.concatenate([c - e, c + e]).astype(np.float32)
    zeros = torch.zeros(lp, dtype=torch.int32, device="cuda")
    return pt.LeafTables(
        torch.from_numpy(box).cuda(), zeros, zeros,
        torch.from_numpy(pt._group_boxes(box, pt.WARP)).cuda(),
        torch.from_numpy(pt._group_boxes(box, pt.LEAF_BLOCK)).cuda(), lp)


@pytest.mark.parametrize("kernel", ["shared", "general"])
def test_words_where_every_word_passes(kernel):
    """B3's worst case, and B5's: on 65,536 scattered leaves (2,048
    words), packet 0 casts rays in every direction from the middle, so its
    direction bounds span 0 on every axis and every word's box passes;
    packet 1 looks at the leaves from outside, so their entries differ.
    At 8 bands one block a packet keeps the entries of 304 of its 2,048
    words and recomputes the rest where it reads them. As
    ``_check_clusters``."""
    _need_cuda()
    lt = _scattered_tables(64 * pt.LEAF_BLOCK)
    rng = np.random.default_rng(6)
    src = np.array([[0.0, 0.0, 0.0], [-4.0, 0.3, -0.2]])
    tgt = rng.uniform(-1.0, 1.0, (2, pt.PACKET_R, 3))
    d = np.concatenate([rng.normal(size=(1, pt.PACKET_R, 3)),
                        tgt[1:] - src[1]])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    plane = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).cuda()
    d = tuple(plane(d[..., k]) for k in range(3))
    tm = torch.full((2, pt.PACKET_R), BIG, device="cuda")
    if kernel == "shared":
        orig = plane(src[0])
        tested = pt.shared_word_tests(orig, d, tm, lt)
        _check_clusters(
            lambda k, c: pt.words_shared(orig, d, tm, lt, k, c),
            lambda k: pt.words_shared_plain(orig, d, tm, lt, k), tested)
    else:
        o = src[:, None, :] + rng.uniform(-0.05, 0.05, (2, pt.PACKET_R, 3))
        o = tuple(plane(o[..., k]) for k in range(3))
        tested = pt.general_word_tests(o, d, tm, lt)
        _check_clusters(
            lambda k, c: pt.words_general(o, d, tm, lt, k, c),
            lambda k: pt.words_general_plain(o, d, tm, lt, k), tested)
    assert bool(tested[0].all())


def _one_leaf_tables(lp):
    """Leaf tables of ``lp`` slots on the card with one real leaf, the unit
    box (triangles none), the rest padding."""
    box = np.empty((6, lp), np.float32)
    box[:3], box[3:] = 1e30, -1e30
    box[:, 0] = (0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    zeros = torch.zeros(lp, dtype=torch.int32, device="cuda")
    return pt.LeafTables(
        torch.from_numpy(box).cuda(), zeros, zeros,
        torch.from_numpy(pt._group_boxes(box, pt.WARP)).cuda(),
        torch.from_numpy(pt._group_boxes(box, pt.LEAF_BLOCK)).cuda(), 1)


def test_words_general_refuses_tables_beyond_its_shared_memory():
    """B5 takes leaf tables of WL_MAX_LP (429,056) slots at 8 bands, equal
    to the plain version there, and the wrapper and the kernel's entry
    point both refuse one block more: WL_MAX_LP is the words passes' own
    limit (csrc/worklist.cu kMaxLp)."""
    _need_cuda()
    from snail_tpu_torch.ops._build import library

    rng = np.random.default_rng(2)
    o = tuple(torch.full((1, pt.PACKET_R), -1.0, device="cuda")
              for _ in range(3))
    d = rng.uniform(0.5, 1.0, (3, pt.PACKET_R))
    d /= np.linalg.norm(d, axis=0)
    d = tuple(torch.from_numpy(c[None].astype(np.float32)).cuda() for c in d)
    tm = torch.full((1, pt.PACKET_R), BIG, device="cuda")
    lt = _one_leaf_tables(pt.WL_MAX_LP)
    kern = pt.words_general(o, d, tm, lt)
    torch.cuda.synchronize()
    _assert_words_equal(kern, pt.words_general_plain(o, d, tm, lt,
                                                     pt.WL_BANDS))
    big = _one_leaf_tables(pt.WL_MAX_LP + pt.LEAF_BLOCK)
    with pytest.raises(ValueError, match="shared memory"):
        pt.words_general(o, d, tm, big)
    words, summ, floors = kern
    ptr = lambda t: t.data_ptr()
    rc = library().snail_words_general(
        *(ptr(t) for t in (*o, *d, tm, big.box, big.wbox)), big.lp,
        big.n_leaf, pt.WL_BANDS, 1, 8, ptr(words), ptr(summ), ptr(floors),
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0


@pytest.mark.parametrize("kernel", ["camera", "shared"])
def test_words_camera_and_shared_refuse_tables_beyond_wl_max_lp(kernel):
    """B1 and B3 as B5: tables of WL_MAX_LP slots are taken, equal to the
    plain version there; one block more is refused by the wrapper and by
    the kernel's entry point, and so is a cluster of 3 blocks."""
    _need_cuda()
    from snail_tpu_torch.ops._build import library

    lt = _one_leaf_tables(pt.WL_MAX_LP)
    big = _one_leaf_tables(pt.WL_MAX_LP + pt.LEAF_BLOCK)
    ptr = lambda t: t.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "camera":
        cam = Camera.look_at(pos=(2.0, 1.5, 3.0), target=(0.5, 0.5, 0.5))
        cv = pt.cam_vec(cam, pt.TILE, pt.TILE, lt.root[:3], lt.root[3:])
        run = lambda t, **kw: pt.words_camera(cv, pt.TILE, pt.TILE, t, **kw)
        plain = pt.words_camera_plain(cv, pt.TILE, pt.TILE, lt, pt.WL_BANDS,
                                      torch.arange(1, device="cuda"))
        lead = (cv,)
    else:
        rng = np.random.default_rng(2)
        d = rng.uniform(0.5, 1.0, (3, pt.PACKET_R))
        d /= np.linalg.norm(d, axis=0)
        d = tuple(torch.from_numpy(c[None].astype(np.float32)).cuda()
                  for c in d)
        tm = torch.full((1, pt.PACKET_R), BIG, device="cuda")
        orig = torch.full((3,), -1.0, device="cuda")
        run = lambda t, **kw: pt.words_shared(orig, d, tm, t, pt.WL_BANDS,
                                              **kw)
        plain = pt.words_shared_plain(orig, d, tm, lt, pt.WL_BANDS)
        lead = (orig, *d, tm)
    kern = run(lt)
    torch.cuda.synchronize()
    _assert_words_equal(kern, plain)
    with pytest.raises(ValueError, match="shared memory"):
        run(big)
    with pytest.raises(ValueError, match="cluster of 3"):
        run(lt, cluster=3)
    words, summ, floors = kern
    rc = getattr(library(), f"snail_words_{kernel}")(
        *(ptr(t) for t in (*lead, big.box, big.wbox)), big.lp, big.n_leaf,
        pt.WL_BANDS, 1, 8, ptr(words), ptr(summ), ptr(floors), stream)
    assert rc != 0


def test_entry_points_default_to_the_card():
    _need_cuda()
    scene, cam, _, _ = bench_scene("city", 4)
    assert scene.device.type == "cuda" and cam.pos.is_cuda
    assert scene.leaves.box.is_cuda and scene.lights.pos.is_cuda
    assert Light.make((0.0, 1.0, 0.0), (1.0, 1.0, 1.0), 5.0).pos.is_cuda


# --- The walk kernels (B9a-d) on scenes with node tables ------------------

WALK = ("walk_camera", "walk_shadow", "walk_closest_g", "walk_shadow_g")
# the kernel every table kind's forward frame shades through
GATHER = ("surface_rows",)


def _assert_closest_equal(kern, plain, live=None):
    """A walk kernel's closest hits against its plain version's: the same
    arithmetic in the same order, so equal bit for bit where the triangle
    agrees, and a triangle may differ only on a distance tie."""
    kd, ku, kv, kt = (a.cpu().numpy() for a in kern)
    pd, pu, pv, ptri = (a.cpu().numpy() for a in plain)
    live = np.ones(kd.shape, bool) if live is None else live
    hit = live & (np.abs(pd) < np.float32(BIG))
    assert hit.sum() / live.sum() > 0.02
    same = kt == ptri
    assert same[hit].mean() > 0.999
    np.testing.assert_array_equal(kd[same], pd[same])
    np.testing.assert_array_equal(ku[same], pu[same])
    np.testing.assert_array_equal(kv[same], pv[same])
    np.testing.assert_allclose(kd[~same], pd[~same], rtol=1e-5)


@pytest.mark.parametrize("which", SCENES)
def test_walk_camera_kernel_matches_plain(which):
    _need_cuda()
    scene, cam, w, h, _ = _scene(which, walk=True)
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    rows = scene.tri_rows
    kern = pt.walk_camera(cv, w, h, rows, scene.nodes)
    torch.cuda.synchronize()
    p = (w // pt.TILE) * (h // pt.TILE)
    plain = walk_camera_plain(cv, w, h, rows, scene.nodes,
                              torch.arange(p, device="cuda"))
    _assert_closest_equal(kern[:4], plain[:4])
    for a, b in zip(kern[4:], plain[4:]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(kern[3].cpu().numpy()[
        plain[0].cpu().numpy() >= BIG], -1)


@pytest.mark.parametrize("which", SCENES)
def test_walk_shadow_kernel_matches_plain(which):
    _need_cuda()
    scene, _, _, _, light = _scene(which, walk=True)
    d, tm = _shadow_rays(scene, light, 6)
    rows = scene.tri_rows
    kern = pt.walk_shadow(light, d, tm, rows, scene.nodes)
    torch.cuda.synchronize()
    plain = walk_shadow_plain(light, d, tm, rows, scene.nodes)
    live = tm >= 0
    assert not kern[~live].any()
    assert 0.02 < float(plain[live].mean()) < 0.98
    assert torch.equal(kern, plain)


@pytest.mark.parametrize("which", SCENES)
def test_walk_closest_g_kernel_matches_plain(which):
    _need_cuda()
    scene, _, _, _, _ = _scene(which, walk=True)
    o, d, tm = _bounce_rays(scene, 6)
    kern = pt.walk_closest_g(o, d, tm, scene.tri_rows, scene.nodes)
    torch.cuda.synchronize()
    plain = walk_closest_g_plain(o, d, tm, scene.tri_rows, scene.nodes)
    live = (tm >= 0).cpu().numpy()
    kd, kt = kern[0].cpu().numpy(), kern[3].cpu().numpy()
    np.testing.assert_array_equal(kd[~live], -np.float32(BIG))
    np.testing.assert_array_equal(kt[kd >= np.float32(BIG)], 0)
    _assert_closest_equal(kern, plain, live)


@pytest.mark.parametrize("which", SCENES)
def test_walk_shadow_g_kernel_matches_plain(which):
    _need_cuda()
    scene, _, _, _, _ = _scene(which, walk=True)
    o, d, tm = _shadow_g_rays(scene, 6)
    kern = pt.walk_shadow_g(o, d, tm, scene.tri_rows, scene.nodes)
    torch.cuda.synchronize()
    plain = walk_shadow_g_plain(o, d, tm, scene.tri_rows, scene.nodes)
    live = tm >= 0
    assert not kern[~live].any()
    assert 0.02 < float(plain[live].mean()) < 0.98
    assert torch.equal(kern, plain)


@pytest.mark.parametrize("bounce", [False, True], ids=["fwd", "bounce"])
@pytest.mark.parametrize("which", SCENES)
def test_walk_frame_on_card(which, bounce):
    """The walk frame launches the walk kernels, the hit-row gather and no
    worklist kernel, matches the CPU path, and matches the same scene's
    worklist frame."""
    _need_cuda()
    scene, cam, w, h, _ = _scene(which, bounce=bounce, walk=True)
    opts = RenderOpts(textures=False) if bounce else OPTS
    pt.reset_launch_counts()
    img = render_frame(scene, cam, w, h, opts)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    need = (WALK[:3] if bounce else WALK[:2]) + GATHER
    assert all(counts[k] > 0 for k in need), counts
    assert not any(n for k, n in counts.items() if k not in WALK + GATHER), \
        counts
    ref = render_frame(scene.to("cpu"), cam.to("cpu"), w, h, opts)
    err = (img.cpu() - ref).abs().amax(-1)
    assert torch.isfinite(img).all() and img.abs().amax() > 0
    assert (err > 2e-3).float().mean() < 1e-3, float(err.max())
    wl, _, _, _, _ = _scene(which, bounce=bounce)
    err = (img - render_frame(wl, cam, w, h, opts)).abs().amax(-1)
    assert (err > 2e-3).float().mean() < 2e-3, float(err.max())


@pytest.mark.parametrize("walk", [False, True], ids=["leaves", "nodes"])
@pytest.mark.parametrize("which", SCENES)
def test_portable_frame_on_card_matches_cpu(which, walk):
    """render_frame at 80 x 48 (the portable integrator) reaches the
    kernels of the scene's table kind through the dispatch seam."""
    _need_cuda()
    scene, cam, _, _, _ = _scene(which, bounce=True, walk=walk)
    opts = RenderOpts(textures=False)
    pt.reset_launch_counts()
    img = render_frame(scene, cam, 80, 48, opts)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    need = (("walk_closest_g", "walk_shadow") if walk else
            ("words_general", "closest_wl_g", "words_shared", "shadow_wl"))
    assert all(counts[k] > 0 for k in need), counts
    ref = render_frame(scene.to("cpu"), cam.to("cpu"), 80, 48, opts)
    err = (img.cpu() - ref).abs().amax(-1)
    assert torch.isfinite(img).all() and img.abs().amax() > 0
    assert (err > 2e-3).float().mean() < 2e-3, float(err.max())


# --- The walk's counters (B9e/B9f) and the fat-leaf kernels (B11a-d) ------


@pytest.mark.parametrize("which", SCENES)
def test_walk_camera_stats_kernel_matches_b9a_and_simulation(which):
    """B9e: B9a's outputs bit for bit, and every packet's counters equal to
    the plain version's simulation of its warps."""
    _need_cuda()
    scene, cam, w, h, _ = _scene(which, walk=True)
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    rows = scene.tri_rows
    *out, stats = pt.walk_camera_stats(cv, w, h, rows, scene.nodes)
    ref = pt.walk_camera(cv, w, h, rows, scene.nodes)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    *plain, sim = walk_camera_stats_plain(
        cv, w, h, rows, scene.nodes,
        torch.arange(stats.shape[0], device="cuda"))
    assert torch.equal(stats, sim), (stats, sim)
    _assert_closest_equal(out[:4], plain[:4])
    assert (stats[:, 3] > 0).sum() > 1 and (stats[:, 5:] == 0).all()


@pytest.mark.parametrize("which", SCENES)
def test_walk_shadow_stats_kernel_matches_b9b_and_simulation(which):
    _need_cuda()
    scene, _, _, _, light = _scene(which, walk=True)
    d, tm = _shadow_rays(scene, light, 3)
    rows = scene.tri_rows
    blocked, stats = pt.walk_shadow_stats(light, d, tm, rows, scene.nodes)
    ref = pt.walk_shadow(light, d, tm, rows, scene.nodes)
    torch.cuda.synchronize()
    assert torch.equal(blocked, ref)
    plain, sim = walk_shadow_stats_plain(light, d, tm, rows, scene.nodes)
    assert torch.equal(stats, sim), (stats, sim)
    assert torch.equal(plain, blocked)
    assert (stats[:, 3] > 0).sum() > 1


def walk_wave(kernel, cv, w, h, origin, d=None, tm=None):
    """The wavefront of B9a/B9e (``cv``, a w x h frame) or of B9b/B9f (the
    planes ``d``, ``tm`` from ``origin``) as the plain walk takes it:
    (directions, bounds), flat in the order of the kernel's threads (the
    camera kernels': 8 x 4 pixel warps)."""
    if kernel in ("B9a", "B9e"):
        pids = torch.arange((w // pt.TILE) * (h // pt.TILE),
                            device=cv.device)
        d, _, t_exit = pt._camera_rays(cv, w, h, pids)
        order = pt.camera_wl_order().to(cv.device)
        return [_tiles(c, order) for c in d], _tiles(t_exit, order)
    return ([c.reshape(-1) for c in d],
            torch.where(tm >= 0.0, tm, -BIG).reshape(-1))


def plain_walk(kernel, nodes, rows, raw, origin, dirs, bound0):
    """The plain walk of B9a or B9b (``walk_plain``), or the simulation of
    the warps of B9e or B9f (``_WarpWalk``), from ``origin`` (3,) on the
    raw ``rows`` or (``raw`` False) on the shared-origin rows of
    ``origin``: (best, tri, u, v) or (blocked,), flat in the order of the
    kernel's threads, and for B9e/B9f the counters, int32 (P, 8)."""
    closest = kernel in ("B9a", "B9e")
    if kernel in ("B9a", "B9b"):
        out = walk_plain(nodes, origin.unbind(), dirs, bound0, rows, raw,
                         closest)
        return tuple(out) if closest else (out,)
    walk = _WarpWalk(nodes, origin.unbind(), dirs, bound0, rows, raw,
                     closest)
    stats = walk.run()
    out = ((walk.bound, walk.tri, walk.bu, walk.bv) if closest
           else (walk.blocked,))
    return (*out, stats)


@pytest.mark.parametrize("kernel", ["B9a", "B9b", "B9e", "B9f"])
@pytest.mark.parametrize("which", SCENES)
def test_walk_raw_kernels_match_plain_on_shared_rows(which, kernel):
    """B9a, B9b, B9e and B9f on the raw triangle rows against the plain
    walk (B9e/B9f: the simulation of their warps) on the shared-origin
    rows of the same origin (``shared_rows``): outputs and counters bit
    for bit, tri included, since the table rounds the origin's terms as
    the full Moller test does."""
    _need_cuda()
    scene, cam, w, h, light = _scene(which, walk=True)
    nodes, rows = scene.nodes, scene.tri_rows
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    if kernel in ("B9a", "B9e"):
        origin = cv[9:12]
        dirs, bound0 = walk_wave(kernel, cv, w, h, origin)
        kern = (pt.walk_camera(cv, w, h, rows, nodes) if kernel == "B9a"
                else pt.walk_camera_stats(cv, w, h, rows, nodes))
    else:
        origin = light
        d, tm = _shadow_rays(scene, light, 6)
        dirs, bound0 = walk_wave(kernel, cv, w, h, origin, d, tm)
        kern = (pt.walk_shadow(light, d, tm, rows, nodes) if kernel == "B9b"
                else pt.walk_shadow_stats(light, d, tm, rows, nodes))
    table = pt.shared_rows(rows, origin)
    plain = plain_walk(kernel, nodes, table, False, origin, dirs, bound0)
    torch.cuda.synchronize()
    if kernel in ("B9e", "B9f"):
        *kern, stats = kern
        *plain, sim = plain
        assert torch.equal(stats, sim), (stats, sim)
    if kernel in ("B9a", "B9e"):
        order = pt.camera_wl_order().to(cv.device)
        best, tri, u, v = plain
        want = (torch.where(tri >= 0, best, BIG), u, v, tri.to(torch.int32))
        assert all(torch.equal(_tiles(a, order), b)
                   for a, b in zip(kern[:4], want))
        assert bool((tri >= 0).any()) and bool((tri < 0).any())
    else:
        blocked = (kern[0] if kernel == "B9f" else kern).reshape(-1) > 0
        assert torch.equal(blocked, plain[0])
        live = bound0 > 0.0
        assert 0.02 < float(blocked[live].float().mean()) < 0.98


@pytest.mark.parametrize("which", SCENES)
def test_walk_stats_frame_on_card_matches_cpu(which):
    """The walk's counter frame runs B9e once and B9f once per light,
    gives the walk fwd frame's image, and the CPU path's image and
    counters."""
    _need_cuda()
    scene, cam, w, h, _ = _scene(which, walk=True)
    pt.reset_launch_counts()
    img, st = render_frame_fast_stats(scene, cam, w, h, OPTS)
    counts = pt.launch_counts()
    assert counts["walk_camera_stats"] == 1, counts
    assert counts["walk_shadow_stats"] == len(scene.lights), counts
    assert counts["walk_camera"] == counts["walk_shadow"] == 0, counts
    assert torch.equal(img, render_frame(scene, cam, w, h, OPTS))
    ref, st_cpu = render_frame_fast_stats(scene.to("cpu"), cam.to("cpu"), w,
                                          h, OPTS)
    err = (img.cpu() - ref).abs().amax(-1)
    assert (err > 2e-3).float().mean() < 1e-3, float(err.max())
    assert st == st_cpu


FAT = ("fat_camera", "fat_closest", "fat_shadow", "fat_shadow_g")


@pytest.mark.parametrize("which", SCENES)
def test_fat_camera_kernel_matches_plain(which):
    _need_cuda()
    scene, cam, w, h, _ = _scene(which, leaf=64)
    assert pt.is_fat(scene)
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    signs = pt.camera_signs(cam, w, h)
    kern = pt.fat_camera(cv, w, h, signs, scene.tri_rows, scene.nodes)
    torch.cuda.synchronize()
    p = (w // pt.TILE) * (h // pt.TILE)
    plain = fat_camera_plain(cv, w, h, signs, scene.tri_rows, scene.nodes,
                             torch.arange(p, device="cuda"))
    _assert_closest_equal(kern[:4], plain[:4])
    for a, b in zip(kern[4:], plain[4:]):
        assert torch.equal(a, b)
    miss = plain[0] >= BIG
    assert bool((kern[3][miss] == 0).all() and (kern[0][miss] == BIG).all())


@pytest.mark.parametrize("which", SCENES)
def test_fat_closest_kernel_matches_plain(which):
    """B11b on rays as the caller gave them: masked rays with garbage
    origins, a finite tmax on some live rays, whose miss returns it."""
    _need_cuda()
    scene, _, _, _, _ = _scene(which, leaf=64)
    o, d, tm = _bounce_rays(scene, 6, planes=pt.padded_planes)
    signs = pt.packet_signs(d)
    kern = pt.fat_closest(o, d, tm, signs, scene.tri_rows, scene.nodes)
    torch.cuda.synchronize()
    plain = fat_closest_plain(o, d, tm, signs, scene.tri_rows, scene.nodes)
    live = tm >= 0
    kd = kern[0]
    assert bool((kd[~live] == -BIG).all())
    miss = live & (kern[3] == 0) & (kd == tm.clamp_max(BIG))
    assert bool((tm[miss] < BIG).any())
    hit = live & (kd < tm.clamp_max(BIG))
    _assert_closest_equal(kern, plain, (hit | miss).cpu().numpy())


# the leaf sizes of the staged-leaf tests: B9c's leaves of 1-32 rows,
# B11b's of 33-64
STAGED_LEAVES = {"walk": (1, 31, 32, 17, 2), "fat": (33, 63, 64, 48, 40)}


def _leaf_fields(zs):
    """Leaves side by side along x under a balanced tree of hand-built
    inner nodes: leaf i, in the cell x in [3i, 3i + 2], holds one
    triangle parallel to the z = 0 plane at z = zs[i][j] for each of its
    rows j, in that order. Returns (FlatGeometry fields, BVH fields) as
    numpy, for either package's classes."""
    sizes = [len(z) for z in zs]
    a, first = [], []
    for i, z in enumerate(zs):
        first.append(len(a))
        a += [(3.0 * i, 0.0, zj) for zj in z]
    a = np.float32(a)
    lo_t, hi_t = a, a + np.float32([2.0, 2.0, 0.0])
    # breadth first, so that a node's two children are adjacent
    under, child = [list(range(len(sizes)))], [0]
    for n, leaves in enumerate(under):
        if len(leaves) > 1:
            child[n] = len(under)
            h = len(leaves) // 2
            under += [leaves[:h], leaves[h:]]
            child += [0, 0]
    tris = lambda ls: np.concatenate([np.arange(first[i], first[i] + sizes[i])
                                      for i in ls])
    node_lo = np.float32([lo_t[tris(ls)].min(0) for ls in under])
    node_hi = np.float32([hi_t[tris(ls)].max(0) for ls in under])
    count = np.int32([sizes[ls[0]] if len(ls) == 1 else 0 for ls in under])
    child = np.int32([first[ls[0]] if len(ls) == 1 else c
                      for ls, c in zip(under, child)])
    zero = np.zeros(len(under), np.int32)
    n = len(a)
    bvh = dict(node_lo=node_lo, node_hi=node_hi, child=child, count=count,
               axis=zero, first_node=zero,
               order=np.arange(n, dtype=np.int32),
               depth=pt.tree_depth(child, count))
    z0 = np.zeros((n, 3), np.float32)
    up = z0 + np.float32([0.0, 0.0, 1.0])
    geom = dict(
        a=a, ba=np.tile(np.float32([2.0, 0.0, 0.0]), (n, 1)),
        ca=np.tile(np.float32([0.0, 2.0, 0.0]), (n, 1)), nrm=up,
        t0=np.full(n, 4.0, np.float32), uv0=z0[:, :2], uv_e1=z0[:, :2],
        uv_e2=z0[:, :2], n0=up, n_e1=z0, n_e2=z0,
        mat_id=np.zeros(n, np.int32))
    return geom, bvh


def _traced(fields, device, walk=True):
    geom, bvh = fields
    return make_traced_scene(FlatGeometry(**geom), BVH(**bvh), device=device,
                             walk=walk)


def _leaf_scene(sizes, device, seed=21, walk=True):
    """A scene of ``_leaf_fields`` leaves: leaf i holds sizes[i]
    triangles at z = 0.05 j in a seeded order, and two more of them at z
    = 0, the nearest (exact distance ties; rows j and j + 32 on a leaf of
    more than 32); node tables, or leaf tables where ``walk`` is false."""
    rng = np.random.default_rng(seed)
    zs = []
    for s in sizes:
        z = rng.permutation(s).astype(np.float32) * np.float32(0.05)
        if s > 1:
            j = int(rng.integers(0, s - 32)) if s > 32 else 0
            z[[j, j + 32] if s > 32 else rng.choice(s, 2, replace=False)] = 0
        zs.append(z)
    return _traced(_leaf_fields(zs), device, walk=walk)


def _blocker_fields(sizes, row):
    """``_leaf_fields`` of leaves of ``sizes`` rows whose only row that a
    ray from z = -1 along +z meets before 3 is row ``row`` (-1: the
    last; past a leaf's rows: its last), at z = 0; its other rows lie at
    z = 2 + 0.05 j."""
    zs = []
    for s in sizes:
        b = s - 1 if row < 0 else min(row, s - 1)
        zs.append(np.float32([0.0 if j == b else 2.0 + 0.05 * j
                              for j in range(s)]))
    return _leaf_fields(zs)


def _blocker_rays(n_leaves, seed=29):
    """``_lane_rays``' two packets (on the CPU), the aimed rays' tmax
    changed for ``_blocker_fields``' scenes, and the verdict each ray
    must get. An aimed ray (from z = -1 toward its leaf's cell) reaches
    its leaf's blocker at t = 1 / d_z: a quarter have tmax 0.5 (short of
    it), a quarter 1.5 (past it, short of the other rows), a quarter just
    short of and just past it (t (1 -+ 1e-5): the one-sided rule's edge),
    and a quarter turn toward +x, tmax 5: blocked at their leaf, their
    segment then runs into the next leaf's box, which the warp may visit
    after (lanes blocked in one leaf, masked for the next). Masked rays
    keep their garbage planes; live misses are never blocked. Returns
    (o, d, tm, want: bool (2, PACKET_R))."""
    o, d, tm, _ = _lane_rays(n_leaves, "cpu")
    o, d = [c.numpy().copy() for c in o], [c.numpy().copy() for c in d]
    tm = tm.numpy().copy()
    aimed = (tm >= 0) & (d[2] > 0)
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 5, tm.shape)
    t_hit = 1.0 / d[2].astype(np.float64)
    tm[aimed & (kind == 0)] = 0.5
    tm[aimed & (kind == 1)] = 1.5
    for k, f in ((2, 1.0 - 1e-5), (3, 1.0 + 1e-5)):
        m = aimed & (kind == k)
        tm[m] = (t_hit[m] * f).astype(np.float32)
    diag = aimed & (kind == 4)
    o[0][diag] = np.floor(o[0][diag] / 3.0) * 3.0 + 0.5
    o[1][diag] = 0.2
    d[0][diag], d[1][diag] = np.float32(np.sqrt(0.5)), 0.0
    d[2][diag] = np.float32(np.sqrt(0.5))
    tm[diag] = 5.0
    want = aimed & ((kind == 1) | (kind == 3) | (kind == 4))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return (tuple(map(t, o)), tuple(map(t, d)), t(tm), torch.from_numpy(want))


def _lane_rays(n_leaves, device, seed=23):
    """Two packets of rays with their own origins as (o, d, tm) planes, and
    the lanes of each warp that enter a leaf: warp w aims k = w % 32 + 1
    seeded lanes at leaf (w // 32) % n_leaves, from z = -1 along +z, a
    little tilted, half with tmax BIG and half a finite tmax past the
    leaf; of its other lanes, half are masked (tmax -BIG, garbage origins
    and directions) and half are live misses along -z with a finite tmax
    (ROADMAP C13)."""
    rng = np.random.default_rng(seed)
    nw = 2 * pt.WARPS
    k = np.arange(nw) % pt.WARP + 1
    o, d = np.zeros((2, nw, pt.WARP, 3))
    tm = np.zeros((nw, pt.WARP))
    cell = lambda leaf, m: np.stack([3.0 * leaf + rng.uniform(0.1, 0.7, m),
                                     rng.uniform(0.1, 0.7, m),
                                     np.full(m, -1.0)], 1)
    for w in range(nw):
        leaf = (w // pt.WARP) % n_leaves
        aim = rng.permutation(pt.WARP) < k[w]
        rest = np.flatnonzero(~aim)
        masked, away = rest[::2], rest[1::2]
        o[w, aim] = cell(leaf, k[w])
        d[w, aim, :2] = rng.uniform(-0.02, 0.02, (k[w], 2))
        d[w, aim, 2] = 1.0
        tm[w, aim] = np.where(rng.random(k[w]) < 0.5, BIG, 5.0)
        o[w, masked], d[w, masked], tm[w, masked] = 1e30, (3, -7, 0.5), -BIG
        o[w, away], d[w, away] = cell(leaf, len(away)), (0.01, 0.0, -1.0)
        tm[w, away] = rng.uniform(1.0, 4.0, len(away))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pk = lambda x: torch.from_numpy(np.ascontiguousarray(
        x, np.float32).reshape(2, pt.PACKET_R)).to(device)
    return (tuple(pk(o[..., c]) for c in range(3)),
            tuple(pk(d[..., c]) for c in range(3)), pk(tm), k)


@pytest.mark.parametrize("kind", list(STAGED_LEAVES))
def test_staged_closest_kernel_matches_plain_exactly(kind):
    """B9c (``walk``) and B11b (``fat``), whose leaf stage tests a leaf
    lane per triangle where at most a threshold of lanes enter it and lane
    per ray above: every output equal to the plain version's, tri
    included, with 1 to 32 lanes entering a leaf (both ways, whatever the
    threshold), leaves of 1, 31, 32 (B9c) and 33, 63, 64 rows (B11b),
    exact distance ties in a leaf, masked rays with garbage planes and
    live misses with a finite tmax."""
    _need_cuda()
    sizes = STAGED_LEAVES[kind]
    scene = _leaf_scene(sizes, "cuda")
    assert scene.nodes.leaf_max == max(sizes)
    assert pt.is_fat(scene) == (kind == "fat")
    o, d, tm, _ = _lane_rays(len(sizes), "cuda")
    rows, nodes = scene.tri_rows, scene.nodes
    if kind == "fat":
        signs = pt.packet_signs(d)
        kern = pt.fat_closest(o, d, tm, signs, rows, nodes)
        plain = fat_closest_plain(o, d, tm, signs, rows, nodes)
        miss_dist = tm.clamp_max(BIG)
    else:
        kern = pt.walk_closest_g(o, d, tm, rows, nodes)
        plain = walk_closest_g_plain(o, d, tm, rows, nodes)
        miss_dist = torch.full_like(tm, BIG)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))
    kd, kt = kern[0], kern[3]
    live = tm >= 0
    hit = live & (kd < miss_dist)
    assert bool((kd[~live] == -BIG).all()) and bool((kt[~hit] == 0).all())
    assert bool((kd[live & ~hit] == miss_dist[live & ~hit]).all())
    assert bool((tm[live & ~hit] < BIG).any())
    # every aimed ray hits the nearest triangle of its leaf, z = 0
    assert int(hit.sum()) == 2 * pt.WARPS * (pt.WARP + 1) // 2
    assert torch.equal(scene.tri_a[kt[hit].long(), 2],
                       torch.zeros_like(kd[hit]))


# the camera's distance from the leaves of the staged camera tests: near,
# most leaf visits have all 32 lanes of a warp entering; far, more of
# them few
CAMERA_VIEWS = {"near": 3.0, "far": 20.0}


@pytest.mark.parametrize("view", list(CAMERA_VIEWS))
@pytest.mark.parametrize("kind", list(STAGED_LEAVES))
def test_staged_camera_kernels_match_plain_exactly(kind, view):
    """B9a with B9e (``walk``) and B11a (``fat``), whose warps take 8 x 4
    pixel tiles and whose leaf stage tests a leaf lane per triangle where
    at most a threshold of lanes enter it and lane per ray above, on
    ``_leaf_scene``'s leaves of 1-32 (B9a) and 33-64 rows (B11a), each
    with two identical nearest rows (exact distance ties), from a camera
    3 or 20 units away, turned so that the leaves' edges cross its warps:
    every output equal to the plain version's bit for bit, tri included;
    every hit on a nearest row the lower of its leaf's two, as in the
    serial loop; visits with one lane entering and with 17-32 (the warps'
    simulation, ``camera_sim``) in each wavefront, so both ways of testing
    a leaf run whatever the threshold; B9e's outputs B9a's and its
    counters the simulation's."""
    _need_cuda()
    sizes = STAGED_LEAVES[kind]
    scene = _leaf_scene(sizes, "cuda")
    cam = Camera.look_at((6.0, 1.2, -CAMERA_VIEWS[view]), (7.0, 1.0, 0.0),
                         up=(0.3, 1.0, 0.0))
    w = h = 256
    pids = torch.arange((w // pt.TILE) * (h // pt.TILE), device="cuda")
    nodes = scene.nodes
    if kind == "fat":
        cv = pt._camera_vec(scene, cam, w, h)
        rows, signs = scene.tri_rows, pt.camera_signs(cam, w, h)
        kern = pt.fat_camera(cv, w, h, signs, rows, nodes)
        plain = fat_camera_plain(cv, w, h, signs, rows, nodes, pids)
        hit = kern[0] < BIG
        assert bool((kern[3][~hit] == 0).all())
    else:
        cv, rows = pt._camera_vec(scene, cam, w, h), scene.tri_rows
        signs = None
        kern = pt.walk_camera(cv, w, h, rows, nodes)
        *b9e, stats = pt.walk_camera_stats(cv, w, h, rows, nodes)
        plain = walk_camera_plain(cv, w, h, rows, nodes, pids)
        hit = kern[3] >= 0
    sim, sim_stats, tally = camera_sim(cv, w, h, rows, nodes, pids, signs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))
    assert all(torch.equal(a, b) for a, b in zip(sim, plain))
    if kind == "walk":
        assert all(torch.equal(a, b) for a, b in zip(b9e, kern))
        assert torch.equal(stats, sim_stats), (stats, sim_stats)
    assert 0.02 < float(hit.float().mean()) < 0.9
    # a hit on a nearest row (z = 0) is the lower of its leaf's two
    a = scene.tri_a
    leaf_of = (a[:, 0] / 3.0).long()
    z0 = a[:, 2] == 0.0
    lowest = torch.stack([torch.nonzero(z0 & (leaf_of == i)).min()
                          for i in range(len(sizes))])
    tri = kern[3][hit].long()
    on0 = z0[tri]
    assert bool(on0.any())
    assert torch.equal(tri[on0], lowest[leaf_of[tri[on0]]])
    bins = dict(zip(pt.TALLY, tally.sum(1).tolist()))
    assert bins["1"] > 0 and bins["17-32"] > 0, bins


def _shared_blocker_rays(n_leaves, seed=37):
    """Two packets of rays from one origin below ``_blocker_fields``'
    leaves (B11c's light), and the verdict each ray must get: warp w aims
    k = w % 32 + 1 seeded lanes at seeded points of the blocker triangle
    of leaf (w // 32) % n_leaves, on z = 0, which an aimed ray reaches at
    t = -orig_z / d_z. A fifth of the aimed rays have tmax half of that
    (short of the leaf's box), a fifth that + 1 (past the blocker, short
    of the leaf's other rows), a fifth just short of and a fifth just past
    it (t (1 -+ 1e-5): the one-sided rule's edge), a fifth 1e3 (blocked,
    the segment running on through the leaf and out of it). Of the other
    lanes, half are masked (tmax -BIG, garbage directions) and half are
    live misses along -z. Returns (orig, d, tm, want: bool (2,
    PACKET_R)), on the CPU."""
    rng = np.random.default_rng(seed)
    orig = np.float32([1.5 * n_leaves - 0.5, 1.0, -20.0])
    nw = 2 * pt.WARPS
    k = np.arange(nw) % pt.WARP + 1
    d = np.zeros((nw, pt.WARP, 3), np.float32)
    tm = np.zeros((nw, pt.WARP))
    want = np.zeros((nw, pt.WARP), bool)
    unit = lambda v: np.float32(v) / np.linalg.norm(np.float32(v))
    for w in range(nw):
        leaf = (w // pt.WARP) % n_leaves
        aim = rng.permutation(pt.WARP) < k[w]
        rest = np.flatnonzero(~aim)
        masked, away = rest[::2], rest[1::2]
        tgt = np.stack([3.0 * leaf + rng.uniform(0.1, 0.7, k[w]),
                        rng.uniform(0.1, 0.7, k[w]), np.zeros(k[w])], 1)
        da = tgt - orig
        d[w, aim] = da / np.linalg.norm(da, axis=1, keepdims=True)
        t_hit = -np.float64(orig[2]) / d[w, aim, 2].astype(np.float64)
        kind = rng.integers(0, 5, k[w])
        tm[w, aim] = np.select(
            [kind == 0, kind == 1, kind == 2, kind == 3],
            [0.5 * t_hit, t_hit + 1.0, t_hit * (1.0 - 1e-5),
             t_hit * (1.0 + 1e-5)], 1e3)
        want[w, aim] = (kind == 1) | (kind == 3) | (kind == 4)
        d[w, masked], tm[w, masked] = unit((3.0, -7.0, 0.5)), -BIG
        d[w, away] = unit((0.01, 0.0, -1.0))
        tm[w, away] = rng.uniform(1.0, 4.0, len(away))
    pk = lambda x: torch.from_numpy(np.ascontiguousarray(
        x, np.float32).reshape(2, pt.PACKET_R))
    return (torch.from_numpy(orig), tuple(pk(d[..., c]) for c in range(3)),
            pk(tm), torch.from_numpy(want.reshape(2, pt.PACKET_R)))


@pytest.mark.parametrize("kind,row", [
    ("walk", 0), ("walk", 16), ("walk", 31), ("fat", 0), ("fat", 31),
    ("fat", 63), ("wl", 0), ("wl", 16), ("wl", 31), ("fat_shared", 0),
    ("fat_shared", 31), ("fat_shared", 63), ("walk_shared", 0),
    ("walk_shared", 16), ("walk_shared", 31)])
def test_staged_any_hit_kernel_matches_plain_exactly(kind, row):
    """B9d (``walk``), B11d (``fat``), B7 (``wl``: the same leaves on leaf
    tables, B5's words), B11c (``fat_shared``: rays from one origin,
    ``_shared_blocker_rays``) and B9b (``walk_shared``: the same rays,
    with B9f), whose leaf stage stages a whole
    leaf and tests it lane per triangle (lane j: rows j and j + 32) where
    at most a threshold of unblocked lanes enter it and lane per ray
    above: verdicts equal to the plain version's and to what the rays
    must get, with 1 to 32 lanes entering a leaf (both ways, whatever the
    threshold), leaves of 1, 31, 32, 17, 2 (B9d, B7, B9b) and 33, 63, 64,
    48, 40 rows (B11d, B11c) whose only blocker is row 0, 16 or 31 (B9d,
    B7, B9b) or row 0, 31 or 63 (B11d, B11c; on a leaf of more than 32
    rows, row 63 is the second row some lane tests), each leaf's last
    where it has fewer rows, tmax just short of and just past the blocker,
    lanes blocked in one leaf whose segment runs on into the next, masked
    rays with garbage planes and live misses; B9f's verdicts B9b's and
    its counters (rows tested up to a stop, either way of testing) the
    simulation's."""
    _need_cuda()
    sizes = STAGED_LEAVES["walk" if kind in ("walk", "wl", "walk_shared")
                          else "fat"]
    scene = _traced(_blocker_fields(sizes, row), "cuda", walk=kind != "wl")
    rows, nodes = scene.tri_rows, scene.nodes
    if kind == "walk_shared":
        orig, d, tm, want = _shared_blocker_rays(len(sizes))
        orig, d, tm = orig.cuda(), tuple(c.cuda() for c in d), tm.cuda()
        kern = pt.walk_shadow(orig, d, tm, rows, nodes)
        plain = walk_shadow_plain(orig, d, tm, rows, nodes)
        blocked, stats = pt.walk_shadow_stats(orig, d, tm, rows, nodes)
        _, sim = walk_shadow_stats_plain(orig, d, tm, rows, nodes)
        assert torch.equal(blocked, kern) and torch.equal(stats, sim)
    elif kind == "fat_shared":
        orig, d, tm, want = _shared_blocker_rays(len(sizes))
        orig, d, tm = orig.cuda(), tuple(c.cuda() for c in d), tm.cuda()
        signs = pt.packet_signs(d)
        kern = pt.fat_shadow(orig, d, tm, signs, rows, nodes)
        plain = fat_shadow_plain(orig, d, tm, signs, rows, nodes)
    else:
        o, d, tm, want = _blocker_rays(len(sizes))
        o, d, tm = (tuple(c.cuda() for c in o),
                    tuple(c.cuda() for c in d), tm.cuda())
    if kind == "wl":
        # B5 and B7 take masked rays substituted, as any_hit_c gives them
        o, d, tm, _ = pt.general_planes(*(tuple(c.reshape(-1) for c in x)
                                          for x in (o, d)), tm.reshape(-1))
        lt = scene.leaves
        assert int(lt.count.max()) == max(sizes)
        words, summ, floors = pt.words_general(o, d, tm, lt, 1)
        kern = pt.shadow_wl_g(o, d, tm, rows, lt, words, summ, floors)
        plain = pt.shadow_wl_g_plain(o, d, tm, rows, lt, words)
    elif kind == "fat":
        signs = pt.packet_signs(d)
        kern = pt.fat_shadow_g(o, d, tm, signs, rows, nodes)
        plain = fat_shadow_g_plain(o, d, tm, signs, rows, nodes)
    elif kind == "walk":
        kern = pt.walk_shadow_g(o, d, tm, rows, nodes)
        plain = walk_shadow_g_plain(o, d, tm, rows, nodes)
    if kind != "wl":
        assert scene.nodes.leaf_max == max(sizes)
    torch.cuda.synchronize()
    assert torch.equal(kern, plain)
    assert torch.equal(kern.cpu() > 0, want)


def _lowest_nearest_rows(scene, n_leaves):
    """Each ``_leaf_scene`` leaf's lower row at z = 0, and per triangle
    whether it lies at z = 0 and its leaf."""
    a = scene.tri_a
    leaf_of = (a[:, 0] / 3.0).long()
    z0 = a[:, 2] == 0.0
    lowest = torch.stack([torch.nonzero(z0 & (leaf_of == i)).min()
                          for i in range(n_leaves)])
    return lowest, z0, leaf_of


@pytest.mark.parametrize("view", list(CAMERA_VIEWS))
def test_staged_camera_raw_kernel_matches_plain_exactly(view):
    """B2 (``camera_wl``: its two-slot stage, 8 x 4 pixel warps and
    lane-per-triangle threshold on the raw triangle rows) on
    ``_leaf_scene``'s leaves of 1-32 rows on leaf tables, each with two
    identical nearest rows, from a camera 3 or 20 units away: every
    output equal bit for bit to the plain B2's and to its warps'
    simulation (``camera_wl_sim``), tri included; every hit on a nearest
    row the lower of its leaf's two; visits with one lane entering and
    with 17-32 in each wavefront; one launch counted."""
    _need_cuda()
    sizes = STAGED_LEAVES["walk"]
    scene = _leaf_scene(sizes, "cuda", walk=False)
    lt = scene.leaves
    assert lt is not None and int(lt.count.max()) == max(sizes)
    cam = Camera.look_at((6.0, 1.2, -CAMERA_VIEWS[view]), (7.0, 1.0, 0.0),
                         up=(0.3, 1.0, 0.0))
    w = h = 256
    pids = torch.arange((w // pt.TILE) * (h // pt.TILE), device="cuda")
    cv, words, summ, floors = pt._camera_words(scene, cam, w, h)
    rows = scene.tri_rows
    pt.reset_launch_counts()
    kern = pt.camera_wl(cv, w, h, rows, lt, words, summ, floors)
    assert pt.launch_counts()["camera_wl"] == 1
    plain = pt.camera_wl_plain(cv, w, h, rows, lt, words, pids)
    sim, _, tally = pt.camera_wl_sim(cv, w, h, rows, lt, words, floors, pids)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))
    assert all(torch.equal(a, b) for a, b in zip(kern, sim))
    hit = kern[3] >= 0
    assert 0.02 < float(hit.float().mean()) < 0.9
    lowest, z0, leaf_of = _lowest_nearest_rows(scene, len(sizes))
    tri = kern[3][hit].long()
    on0 = z0[tri]
    assert bool(on0.any())
    assert torch.equal(tri[on0], lowest[leaf_of[tri[on0]]])
    bins = dict(zip(pt.TALLY, tally.sum(1).tolist()))
    assert bins["1"] > 0 and bins["17-32"] > 0, bins


@pytest.mark.parametrize("row", [0, 16, 31])
def test_staged_shadow_raw_kernel_matches_plain_exactly(row):
    """B4 (``shadow_wl``: the full Moller test from the light on the raw
    rows) on ``_blocker_fields``' leaves of 1-32 rows on leaf tables, one
    blocker a leaf at row 0, 16 or 31, with ``_shared_blocker_rays`` (1 to
    32 lanes entering a leaf, tmax just short of and past the blocker,
    masked rays, live misses): verdicts equal to the plain B4's, to what
    the rays must get and to B8b's on the shared-origin rows; one launch
    counted."""
    _need_cuda()
    sizes = STAGED_LEAVES["walk"]
    scene = _traced(_blocker_fields(sizes, row), "cuda", walk=False)
    lt, rows = scene.leaves, scene.tri_rows
    orig, d, tm, want = _shared_blocker_rays(len(sizes))
    orig, d, tm = orig.cuda(), tuple(c.cuda() for c in d), tm.cuda()
    words, summ, floors = pt.words_shared(orig, d, tm, lt, 1)
    pt.reset_launch_counts()
    kern = pt.shadow_wl(orig, d, tm, rows, lt, words, summ, floors)
    assert pt.launch_counts()["shadow_wl"] == 1
    plain = pt.shadow_wl_plain(orig, d, tm, rows, lt, words)
    b8, _ = pt.shadow_wl_stats(orig, d, tm, pt.shared_rows(rows, orig), lt,
                               words, summ, floors)
    torch.cuda.synchronize()
    assert torch.equal(kern, plain) and torch.equal(kern, b8)
    assert torch.equal(kern.cpu() > 0, want)
    assert 0.1 < float(want.float().mean()) < 0.9


@pytest.mark.parametrize("which", SCENES)
def test_raw_kernels_match_plain_and_simulation(which):
    """B2 and B4 on the raw rows on a whole frame's primary rays and on
    seeded shadow rays of the bench scenes at leaf 4: B2 bit for bit its
    warps' simulation (ties included) and, where the triangle agrees, the
    plain B2; B4's verdicts the plain B4's bit for bit."""
    _need_cuda()
    scene, cam, w, h, light = _scene(which)
    lt = scene.leaves
    cv, words, summ, floors = pt._camera_words(scene, cam, w, h)
    rows = scene.tri_rows
    kern = pt.camera_wl(cv, w, h, rows, lt, words, summ, floors)
    pids = torch.arange(words.shape[0], device="cuda")
    sim, _, _ = pt.camera_wl_sim(cv, w, h, rows, lt, words, floors, pids)
    plain = pt.camera_wl_plain(cv, w, h, rows, lt, words, pids)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kern, sim))
    same = kern[3] == plain[3]
    assert float(same.float().mean()) > 0.999
    assert all(torch.equal(a[same], b[same])
               for a, b in zip(kern[:3], plain[:3]))
    assert torch.allclose(kern[0][~same], plain[0][~same], rtol=1e-5,
                          atol=0.0)
    assert float((kern[0] < BIG).float().mean()) > 0.3

    d, tm = _shadow_rays(scene, light, 6)
    words, summ, floors = pt.words_shared(light, d, tm, lt, 1)
    kb = pt.shadow_wl(light, d, tm, rows, lt, words, summ, floors)
    pb = pt.shadow_wl_plain(light, d, tm, rows, lt, words)
    torch.cuda.synchronize()
    live = tm >= 0
    assert torch.equal(kb, pb)
    assert 0.02 < float(pb[live].mean()) < 0.98


@pytest.mark.parametrize("which", SCENES)
def test_fwd_frame_builds_no_shared_rows(which, monkeypatch):
    """The fwd frame on leaf tables: B1, B2, B3 and B4 launched and no
    shared-origin table built; the counter frame builds the camera's and
    the light's for B8a/B8b, and its image is the fwd frame's."""
    _need_cuda()
    scene, cam, w, h, _ = _scene(which)
    table = pt.shared_rows
    calls = []
    monkeypatch.setattr(pt, "shared_rows",
                        lambda *a: calls.append(1) or table(*a))
    pt.reset_launch_counts()
    img = render_frame(scene, cam, w, h, OPTS)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    assert not calls
    assert all(counts[k] > 0 for k in ("words_camera", "camera_wl",
                                       "words_shared", "shadow_wl")), counts
    pt.reset_launch_counts()
    stats_img, _ = render_frame_fast_stats(scene, cam, w, h, OPTS)
    counts = pt.launch_counts()
    assert len(calls) == 1 + len(scene.lights)
    assert counts["camera_wl_stats"] == 1 and counts["camera_wl"] == 0
    assert torch.equal(stats_img, img)


@pytest.mark.parametrize("kind", ["walk", "fat", "wl"])
def test_any_hit_kernels_match_plain_on_instanced_shadows(kind, monkeypatch):
    """B9d, B11d and B7 (``wl``, on leaf tables) on the shadow wavefronts
    that an instanced fwd frame launches (2 x 2 instances of the city at
    leaf 4, or 64: light 0 in each instance's object space, rays missing
    its box or blocked by an earlier instance masked): verdicts equal to
    their plain versions'."""
    _need_cuda()
    fat = kind == "fat"
    scene, _, _, _, _ = _scene("city", walk=kind == "walk",
                               leaf=64 if fat else 4)
    assert pt.is_fat(scene) == fat
    name = {"walk": "walk_shadow_g", "fat": "fat_shadow_g",
            "wl": "shadow_wl_g"}[kind]
    wrapper, waves = getattr(pt, name), []

    def record(*args):
        waves.append(args)
        return wrapper(*args)

    # the wrapper counts its launches on the name it looks itself up by
    record.launches = wrapper.launches
    monkeypatch.setattr(pt, name, record)
    isc, icam = instanced_grid("city", scene, 2)
    instancing.render_instanced(isc, icam, 256, 128, OPTS)
    monkeypatch.undo()
    assert len(waves) == 4
    plain_fn = {"walk": walk_shadow_g_plain, "fat": fat_shadow_g_plain,
                "wl": lambda *a: pt.shadow_wl_g_plain(*a[:6])}[kind]
    shares = []
    for args in waves:
        kern = wrapper(*args)
        torch.cuda.synchronize()
        assert torch.equal(kern, plain_fn(*args))
        live = args[2] >= 0
        assert not kern[~live].any()
        if bool(live.any()):
            shares.append(float(kern[live].mean()))
    assert shares and 0.0 < max(shares) and min(shares) < 1.0


@pytest.mark.parametrize("which", SCENES)
def test_fat_shadow_kernel_matches_plain(which):
    _need_cuda()
    scene, _, _, _, light = _scene(which, leaf=64)
    d, tm = _shadow_rays(scene, light, 6)
    signs = pt.packet_signs(d)
    kern = pt.fat_shadow(light, d, tm, signs, scene.tri_rows, scene.nodes)
    torch.cuda.synchronize()
    plain = fat_shadow_plain(light, d, tm, signs, scene.tri_rows,
                             scene.nodes)
    live = tm >= 0
    assert not kern[~live].any()
    assert 0.02 < float(plain[live].mean()) < 0.98
    assert torch.equal(kern, plain)


@pytest.mark.parametrize("which", SCENES)
def test_fat_shadow_kernel_matches_plain_on_bounce_frame_shadows(which,
                                                                 monkeypatch):
    """B11c on the shadow wavefronts of the fat bounce frame (its calls of
    the wrapper: the bounce wavefronts' and the primary hits', toward
    light 0; the terrain's is set low, since its overhead light blocks no
    ray): verdicts equal to its plain version's, masked rays never
    blocked, and some live ray blocked in one of them."""
    _need_cuda()
    scene, cam, w, h, _ = _scene(which, bounce=True, leaf=64)
    if which == "terrain":
        scene = dataclasses.replace(scene, lights=Light.make(
            (-40.0, 10.0, 0.0), (1.0, 1.0, 1.0), 200.0))
    wrapper, waves = pt.fat_shadow, []

    def record(*args):
        waves.append(args)
        return wrapper(*args)

    record.launches = wrapper.launches
    monkeypatch.setattr(pt, "fat_shadow", record)
    render_frame(scene, cam, w, h, RenderOpts(textures=False))
    monkeypatch.undo()
    assert len(waves) == 3
    blocked = 0
    for args in waves:
        kern = wrapper(*args)
        torch.cuda.synchronize()
        assert torch.equal(kern, fat_shadow_plain(*args))
        live = args[2] >= 0
        assert not kern[~live].any()
        blocked += int(kern[live].sum())
    assert blocked > 0


@pytest.mark.parametrize("which", SCENES)
def test_fat_shadow_g_kernel_matches_plain(which):
    _need_cuda()
    scene, _, _, _, _ = _scene(which, leaf=64)
    o, d, tm = _shadow_g_rays(scene, 6, planes=pt.padded_planes)
    signs = pt.packet_signs(d)
    kern = pt.fat_shadow_g(o, d, tm, signs, scene.tri_rows, scene.nodes)
    torch.cuda.synchronize()
    plain = fat_shadow_g_plain(o, d, tm, signs, scene.tri_rows, scene.nodes)
    live = tm >= 0
    assert not kern[~live].any()
    assert 0.02 < float(plain[live].mean()) < 0.98
    assert torch.equal(kern, plain)


@pytest.mark.parametrize("bounce", [False, True], ids=["fwd", "bounce"])
@pytest.mark.parametrize("which", SCENES)
def test_fat_frame_on_card(which, bounce):
    """The fat frame launches the fat-leaf kernels, the hit-row gather and
    no other, matches the CPU path, and matches the same geometry's
    worklist frame."""
    _need_cuda()
    scene, cam, w, h, _ = _scene(which, bounce=bounce, leaf=64)
    opts = RenderOpts(textures=False) if bounce else OPTS
    pt.reset_launch_counts()
    img = render_frame(scene, cam, w, h, opts)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    need = (FAT[:3] if bounce else (FAT[0], FAT[2])) + GATHER
    assert all(counts[k] > 0 for k in need), counts
    assert not any(n for k, n in counts.items() if k not in FAT + GATHER), \
        counts
    ref = render_frame(scene.to("cpu"), cam.to("cpu"), w, h, opts)
    err = (img.cpu() - ref).abs().amax(-1)
    assert torch.isfinite(img).all() and img.abs().amax() > 0
    assert (err > 2e-3).float().mean() < 1e-3, float(err.max())
    wl, _, _, _, _ = _scene(which, bounce=bounce)
    err = (img - render_frame(wl, cam, w, h, opts)).abs().amax(-1)
    assert (err > 2e-3).float().mean() < 2e-3, float(err.max())


@pytest.mark.parametrize("which", SCENES)
def test_fat_portable_and_instanced_frames_on_card(which):
    """render_frame at 80 x 48 and two instances of the fat scene, through
    the dispatch seam to B11b, B11c and B11d, against the CPU path."""
    _need_cuda()
    scene, cam, _, _, _ = _scene(which, bounce=True, leaf=64)
    opts = RenderOpts(textures=False)
    pt.reset_launch_counts()
    img = render_frame(scene, cam, 80, 48, opts)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    assert all(counts[k] > 0 for k in ("fat_closest", "fat_shadow")), counts
    ref = render_frame(scene.to("cpu"), cam.to("cpu"), 80, 48, opts)
    err = (img.cpu() - ref).abs().amax(-1)
    assert (err > 2e-3).float().mean() < 2e-3, float(err.max())
    ext = float((scene.root_hi - scene.root_lo).max())
    isc = instancing.make_instances(
        scene, torch.stack([torch.eye(3), instancing.rotation_y(0.7)]),
        [[0.0, 0.0, 0.0], [1.2 * ext, 0.0, -0.8 * ext]])
    pt.reset_launch_counts()
    img = instancing.render_instanced(isc, cam, 128, 64, OPTS)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    assert counts["fat_closest"] > 0 and counts["fat_shadow_g"] > 0, counts
    ref = instancing.render_instanced(isc.to("cpu"), cam.to("cpu"), 128, 64,
                                      OPTS)
    err = (img.cpu() - ref).abs().amax(-1)
    assert torch.isfinite(img).all() and img.abs().amax() > 0
    assert (err > 2e-3).float().mean() < 2e-3, float(err.max())


# --- Textured and loaded scenes --------------------------------------------


@pytest.mark.parametrize("filt", ["point", "bilinear", "sat"])
@pytest.mark.parametrize("which", SCENES)
def test_textured_frame_on_card_matches_cpu(which, filt):
    """bench.py's textured scene (checker_atlas and its SATs): the fwd
    frame with each filter launches B1-B4, matches the CPU path and
    differs from the untextured frame."""
    from snail_tpu_torch.scene.scene import with_sat
    from snail_tpu_torch.scene.textures import checker_atlas

    _need_cuda()
    scene, cam, w, h, _ = _scene(which)
    tex = with_sat(checker_atlas(scene))
    opts = RenderOpts(reflections=False, transparency=False, tex_filter=filt)
    pt.reset_launch_counts()
    img = render_frame(tex, cam, w, h, opts)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    need = ("words_camera", "camera_wl", "words_shared", "shadow_wl")
    assert all(counts[k] > 0 for k in need), counts
    ref = render_frame(tex.to("cpu"), cam.to("cpu"), w, h, opts)
    err = (img.cpu() - ref).abs().amax(-1)
    assert torch.isfinite(img).all() and img.abs().amax() > 0
    assert (err > 2e-3).float().mean() < 2e-3, float(err.max())
    flat = render_frame(scene, cam, w, h, OPTS)
    assert float((img - flat).abs().max()) > 0.1


def _write_city_obj(path, n=6):
    """city_scene(n) as an OBJ, its faces wound so that load_scene's flip
    gives the procedural winding, in three material groups, and an MTL."""
    (obj,) = city_scene(n).objects
    groups = ("concrete", "glass", "roof")
    lines = ["mtllib city.mtl"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in obj.verts]
    for i, (a, b, c) in enumerate(obj.tri_v + 1):
        if i % 12 == 0:
            lines.append(f"usemtl {groups[i // 12 % 3]}")
        lines.append(f"f {b} {a} {c}")
    (path / "city.obj").write_text("\n".join(lines) + "\n")
    (path / "city.mtl").write_text(
        "newmtl concrete\nKd 0.7 0.7 0.65\nKs 0.2 0.2 0.2\n"
        "newmtl glass\nKd 0.3 0.5 0.8\nd 0.5\nnewmtl roof\nKd 0.8 0.3 0.2\n")
    return str(path / "city.obj")


@pytest.mark.parametrize("walk", [False, True], ids=["leaves", "nodes"])
def test_loaded_scene_frame_on_card_matches_cpu(tmp_path, walk):
    """load_scene of an OBJ and its MTL on the card, twice through its
    cache (the second scene equal to the first), and its fwd frame, with
    the checkerboard too, through the worklist (B1-B4) or walk (B9a/B9b)
    kernels, against the CPU path."""
    from snail_tpu_torch.scene.scene import load_scene
    from snail_tpu_torch.scene.textures import checker_atlas

    _need_cuda()
    obj = _write_city_obj(tmp_path)
    scene = load_scene(obj, cache_dir=str(tmp_path), walk=walk)
    again = load_scene(obj, cache_dir=str(tmp_path), walk=walk)
    assert torch.equal(scene.tri_rows, again.tri_rows)
    assert torch.equal(scene.mat_pack, again.mat_pack) and scene.has_transp
    lo, hi = scene.root_lo.cpu().numpy(), scene.root_hi.cpu().numpy()
    c = (lo + hi) * 0.5
    cam = Camera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9])
                                   * float((hi - lo).max())), target=tuple(c))
    need = (("walk_camera", "walk_shadow") if walk else
            ("words_camera", "camera_wl", "words_shared", "shadow_wl"))
    for s, opts in ((scene, OPTS),
                    (checker_atlas(scene), RenderOpts(
                        reflections=False, transparency=False))):
        pt.reset_launch_counts()
        img = render_frame(s, cam, 128, 128, opts)
        torch.cuda.synchronize()
        counts = pt.launch_counts()
        assert all(counts[k] > 0 for k in need), counts
        ref = render_frame(s.to("cpu"), cam.to("cpu"), 128, 128, opts)
        err = (img.cpu() - ref).abs().amax(-1)
        assert torch.isfinite(img).all() and img.abs().amax() > 0
        assert (err > 2e-3).float().mean() < 2e-3, float(err.max())


def _volume(border: bool, n: int = 64):
    """The n^3 sphere on the card; with ``border``, a constant shell of
    value 1500 on all six faces (mip sees it, iso at 0.03 does not), where
    the mip mode's extra sample of a ray done early lands (ROADMAP C19)."""
    from snail_tpu_torch.volume.data import VolumeData, synthetic_sphere
    from snail_tpu_torch.volume.vtree import build_vtree

    data = synthetic_sphere(n).data
    if border:
        for a in range(3):
            idx = [slice(None)] * 3
            idx[a] = [0, -1]
            data[tuple(idx)] = 1500
    return build_vtree(VolumeData(data=data))


@pytest.mark.parametrize("max_steps", [2048, 24])
@pytest.mark.parametrize("mode", ["iso", "mip"])
@pytest.mark.parametrize("border", [False, True], ids=["sphere", "border"])
def test_march_kernel_matches_plain(border, mode, max_steps):
    """V1 (csrc/volume.cu) against _march_plain on the card, bit for bit
    in best and hit_t, from the viewer's camera and from one that sees
    the volume from outside a face, with the rays' shared origin read as
    one (volume_rays' stride-0 view) and as a row per ray; with the
    border, rays that miss the volume take C19's extra sample (best =
    the shell's value)."""
    from snail_tpu_torch.apps.dicom_viewer import viewer_camera
    from snail_tpu_torch.ops.march import march
    from snail_tpu_torch.volume.vtree import _march_plain, volume_rays

    _need_cuda()
    vt = _volume(border)
    for cam in (viewer_camera(vt.shape),
                Camera.look_at(pos=(32.0, 32.0, -96.0),
                               target=(32.0, 32.0, 32.0))):
        rays = volume_rays(vt, cam, 96, 80)
        assert rays[0].stride(0) == 0
        kb, kh = march(vt, *rays, 0.03, mode, max_steps)
        pb, ph = _march_plain(vt, *rays, 0.03, mode, max_steps)
        rb, rh = march(vt, rays[0].contiguous(), *rays[1:], 0.03, mode,
                       max_steps)
        torch.cuda.synchronize()
        assert torch.equal(kb, pb) and torch.equal(kh, ph)
        assert torch.equal(rb, pb) and torch.equal(rh, ph)
        if mode == "iso":
            assert bool((kh >= 0).any()) and bool((kh < 0).any())
        else:
            assert float(kb.max()) > 0.05
            miss = rays[2] > rays[3]
            if border and max_steps == 2048 and bool(miss.any()):
                assert torch.allclose(kb[miss], torch.full_like(
                    kb[miss], 1500 / 65535), rtol=1e-6, atol=0)


def test_render_volume_launches_the_march_kernel():
    """render_volume on the card goes through V1 (its launch counter,
    in the registry of every kernel: march_kernel, and in mip mode
    mip_extra_kernel too) and no other kernel, and its iso and mip images
    match the CPU path's (the rays' norms are sums in another order on
    the card: 2e-3 on all but 0.2 % of pixels, as every frame's check)."""
    from snail_tpu_torch.apps.dicom_viewer import viewer_camera
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.volume.vtree import render_volume

    _need_cuda()
    vt = _volume(True)
    cam = viewer_camera(vt.shape)
    for mode, n in (("iso", 1), ("mip", 2)):
        want = {k.__name__: 0 for k in pt.KERNELS} | {"march": n}
        pt.reset_launch_counts()
        img = render_volume(vt, cam, 64, 48, iso=0.03, mode=mode)
        torch.cuda.synchronize()
        assert pt.launch_counts() == want
        ref = render_volume(vt.to("cpu"), cam.to("cpu"), 64, 48, iso=0.03,
                            mode=mode)
        assert pt.launch_counts() == want
        err = (img.cpu() - ref).abs().amax(-1)
        assert img.shape == (48, 64, 3) and float(img.max()) > 0.5
        assert (err > 2e-3).float().mean() < 2e-3, (mode, float(err.max()))


@pytest.mark.parametrize("tables", ["leaves", "nodes", "fat"])
def test_photon_frame_on_card_matches_cpu(tables):
    """The photon map traced on the card (B5/B6, B9c or B11b), its grid,
    and the fwd frame with the photon term at 64 x 64 against the CPU
    path on the same grid; the photon term lights something."""
    from snail_tpu_torch.render.photons import (_stratified_sphere,
                                                _trace_light, photon_grid,
                                                render_photon_preview,
                                                trace_photons)

    _need_cuda()
    scene, cam, _, _, _ = _scene("city", walk=tables == "nodes",
                                 leaf=64 if tables == "fat" else 4)
    # a light among the blocks: most photons land on the city
    scene = dataclasses.replace(scene, lights=Light.make(
        (0.0, 2.0, 0.3), (1.0, 1.0, 1.0), 120.0))
    pt.reset_launch_counts()
    pmap = trace_photons(scene, n_per_light=8192, seed=1)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    need = {"leaves": ("words_general", "closest_wl_g"),
            "nodes": ("walk_closest_g",), "fat": ("fat_closest",)}[tables]
    assert all(counts[k] > 0 for k in need), counts
    assert 2000 < pmap.count <= 8192
    # the card's photons against the CPU path's on the same directions
    d = _stratified_sphere(8192, torch.Generator("cuda").manual_seed(2))
    card = _trace_light(scene, 0, d)
    cpu = _trace_light(scene.to("cpu"), 0, d.cpu())
    assert len(card[0]) == len(cpu[0]) > 2000
    np.testing.assert_allclose(card[0], cpu[0], rtol=0, atol=1e-4)
    pg = photon_grid(pmap, scene.root_lo, scene.root_hi, res=32)
    assert pg.grid.is_cuda
    on = RenderOpts(reflections=False, transparency=False, textures=False,
                    photons=True, photon_exposure=5.0)
    img = render_frame(scene, cam, 64, 64, on, photon_grid=pg)
    cpu = render_frame(scene.to("cpu"), cam.to("cpu"), 64, 64, on,
                       photon_grid=pg.to("cpu"))
    err = (img.cpu() - cpu).abs().amax(-1)
    assert (err > 2e-3).float().mean() < 2e-3, float(err.max())
    assert float((img - render_frame(scene, cam, 64, 64, on)).max()) > 1e-3
    prev = render_photon_preview(scene, cam, 64, 64, pg, exposure=5.0)
    ref = render_photon_preview(scene.to("cpu"), cam.to("cpu"), 64, 64,
                                pg.to("cpu"), exposure=5.0)
    assert (((prev.cpu() - ref).abs().amax(-1) > 2e-3).float().mean()
            < 2e-3)


def test_served_frames_on_card(tmp_path):
    """The render server on the card over a socketpair: two frames equal
    to_rgb8 of render_frame bit for bit through B1-B4, then a stats frame
    through B8a/B8b whose counters are the counter frame's."""
    import socket
    import threading

    from snail_tpu_torch.apps import server
    from snail_tpu_torch.net import codec, protocol
    from snail_tpu_torch.render.renderer import to_rgb8
    from snail_tpu_torch.scene.scene import load_scene
    from snail_tpu_torch.utils.stats import tree_stats_from_counters

    _need_cuda()
    assert codec.native_available()
    _write_city_obj(tmp_path)
    light = {"pos": [0.0, 30.0, 0.0], "color": [1.0, 1.0, 1.0],
             "radius": 120.0}
    srv, cli = socket.socketpair()
    cli.settimeout(120)
    err = []

    def run():
        try:
            server.serve_connection(srv, str(tmp_path))
        except Exception as e:
            err.append(e)
        finally:
            srv.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    w, h = 256, 128
    protocol.send_json(cli, protocol.LoadModel("city.obj", w, h).to_json())
    assert protocol.recv_json(cli)["type"] == "model_ready"
    cams = [((9.0, 10.0, 14.0), (0.0, 1.0, 0.0)),
            ((-12.0, 8.0, 9.0), (1.0, 0.0, 0.0))]
    got = []
    for (pos, tgt), gvals in ((cams[0], {}), (cams[1], {}),
                              (cams[0], {"2": True})):
        pt.reset_launch_counts()
        protocol.send_json(cli, protocol.FrameRequest(
            cam_pos=pos, cam_target=tgt, lights=[light],
            gvals=gvals).to_json())
        parts = list(protocol.recv_parts(cli))
        got.append((protocol.assemble(parts, h, w), protocol.recv_json(cli),
                    pt.launch_counts()))
    protocol.send_json(cli, {"type": "finish", "finish": True})
    th.join(120)
    cli.close()
    assert not th.is_alive() and not err, err
    scene = load_scene(str(tmp_path / "city.obj"), lights=Light.make(
        light["pos"], light["color"], light["radius"]))
    for (img, st, counts), ((pos, tgt), stats) in zip(
            got, ((cams[0], False), (cams[1], False), (cams[0], True))):
        cam = Camera.look_at(pos=pos, target=tgt)
        opts = RenderOpts(stats=stats)
        if stats:
            ref, kst = render_frame_fast_stats(scene, cam, w, h, opts)
            want = tree_stats_from_counters(kst, 1).to_dict()
            assert all(st[k] == want[k] for k in ("intersects",
                                                  "loop_iters", "rays"))
            need = ("camera_wl_stats", "shadow_wl_stats")
        else:
            ref = render_frame(scene, cam, w, h, opts)
            need = ("words_camera", "camera_wl", "words_shared",
                    "shadow_wl")
        assert all(counts[k] > 0 for k in need), counts
        np.testing.assert_array_equal(img, to_rgb8(ref))
        assert st["measured"] is stats and img.max() > 100


def test_nccl_world_size_one(tmp_path):
    """A process group of one rank on NCCL: the sharded frame equals the
    portable frame and the sharded step the step without a process group,
    bit for bit (an all-gather and an all-reduce over one rank are the
    identity)."""
    import torch.distributed as tdist

    from snail_tpu_torch.parallel import distributed as pdist
    from snail_tpu_torch.parallel.mesh import (make_mesh,
                                               render_frame_sharded,
                                               train_step_sharded)
    from snail_tpu_torch.render.renderer import render_frame_portable

    _need_cuda()
    scene, cam, w, h, _ = _scene("city", bounce=True)
    params = {"tri_a": scene.tri_a, "mat_diffuse": scene.mat_diffuse}
    target = torch.zeros(h, w, 3, device="cuda")
    # the backward's scatter-adds are atomic on the card unless in
    # deterministic mode, where two steps agree bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    alone = train_step_sharded(scene, params, target, cam, w, h, OPTS,
                               make_mesh())
    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                             world_size=1, rank=0)
    try:
        assert tdist.get_backend() == "nccl" and pdist.process_count() == 1
        mesh = pdist.global_mesh()
        assert mesh.group is not None and (mesh.size, mesh.rank) == (1, 0)
        assert pdist.replicate_scene(scene, mesh) is scene
        opts = RenderOpts(textures=False)
        img = render_frame_sharded(scene, cam, w, h, opts, mesh)
        assert torch.equal(img, render_frame_portable(scene, cam, w, h,
                                                      opts))
        loss, new = train_step_sharded(scene, params, target, cam, w, h,
                                       OPTS, mesh)
        assert torch.equal(loss, alone[0])
        for k in params:
            assert torch.equal(new[k], alone[1][k]), k
        rows = pdist.scaling_report(scene, cam, w, h, OPTS, [1, 2],
                                    frames=1)
        assert [r["devices"] for r in rows] == [1] and rows[0]["mrays"] > 0
    finally:
        tdist.destroy_process_group()
        torch.use_deterministic_algorithms(False)


@pytest.fixture(scope="module")
def bounce_ss_gathers():
    """The three gathers of terrain_724's supersampled 1024^2 bounce frame
    (bench.py's 1 Mtri scene, material 0 half mirror half glass: the
    camera's 2048^2 rays, then the reflection and the glass wavefronts),
    taken from the frame's own calls: (sh_pack, [(dist, tri, cols)])."""
    _need_cuda()
    from snail_tpu_torch.render import fast

    scene, cam, _, _ = bench_scene("terrain", 724, bounce=True)
    calls, gather = [], fast.surface_rows

    def record(sh_pack, dist, tri, cols):
        calls.append((dist.clone(), tri.clone(), tuple(cols)))
        return gather(sh_pack, dist, tri, cols)

    fast.surface_rows = record
    try:
        render_frame(scene, cam, 1024, 1024,
                     RenderOpts(textures=False, supersample=True))
    finally:
        fast.surface_rows = gather
    torch.cuda.synchronize()
    return scene.sh_pack, calls


@pytest.mark.parametrize("cols", ["frame", "textured"])
def test_surface_gather_kernel_matches_plain(bounce_ss_gathers, cols):
    """``surface_gather_kernel`` equals its plain version bit for bit on
    the bounce_ss frame's three wavefronts (17 columns each), with the
    frame's columns and with the textured set (normals, uv, colours,
    reflectivity, opacity, texture id), on an all-miss wavefront, and on
    hits whose tri lies outside the table (row 0, as the plain version)."""
    from snail_tpu_torch.ops.gather import surface_rows
    from snail_tpu_torch.render import fast

    sh_pack, calls = bounce_ss_gathers
    assert [len(c[2]) for c in calls] == [17, 17, 17]
    assert all(c[0].shape == (2048 * 2048,) for c in calls)
    miss = torch.where(torch.arange(2048 * 2048, device="cuda") % 2 == 0,
                       -BIG, BIG)
    n_rows = sh_pack.shape[0]
    outside = torch.where(torch.arange(2048 * 2048, device="cuda") % 3 == 0,
                          n_rows + 5, -2).to(torch.int32)
    waves = [(d, t) for d, t, _ in calls] + [
        (miss, calls[0][1]), (torch.ones_like(miss), outside)]
    every = tuple(sorted(fast.NORMAL_COLS + fast.UV_COLS + fast.MATERIAL_COLS
                         + (fast.TEX_COL,)))
    host = sh_pack.cpu()
    for k, (dist, tri) in enumerate(waves):
        want = every if cols == "textured" else (
            calls[k][2] if k < 3 else calls[0][2])
        before = pt.launch_counts()["surface_rows"]
        out = surface_rows(sh_pack, dist, tri, want)
        torch.cuda.synchronize()
        assert pt.launch_counts()["surface_rows"] == before + 1
        plain = surface_rows(host, dist.cpu(), tri.cpu(), want)
        assert torch.equal(out.cpu(), plain), k
        if k >= 3:  # every ray reads row 0
            assert torch.equal(plain, host[0, list(want)][:, None].expand(
                -1, dist.numel())), k
    hit = (calls[0][0] > 0.0) & (calls[0][0] < BIG)
    assert 0 < int(hit.sum()) < hit.numel()


def test_surface_gather_checks_inputs():
    """The wrapper refuses a wrong dtype, a non-contiguous input, a table
    not 16-byte aligned, a table not 32 columns wide and a table on
    another device."""
    _need_cuda()
    from snail_tpu_torch.ops.gather import surface_rows

    n, rows = 4096, 100
    sh_pack = torch.randn((rows, 32), device="cuda")
    dist = torch.rand(n, device="cuda") + 0.5
    tri = torch.randint(0, rows, (n,), device="cuda", dtype=torch.int32)
    cols = (0, 1, 2, 16)
    out = surface_rows(sh_pack, dist, tri, cols)
    assert torch.equal(out, sh_pack[tri.long()].T[list(cols)])
    with pytest.raises(ValueError, match="float32"):
        surface_rows(sh_pack, dist.double(), tri, cols)
    with pytest.raises(ValueError, match="int32"):
        surface_rows(sh_pack, dist, tri.long(), cols)
    with pytest.raises(ValueError, match="float32"):
        surface_rows(sh_pack.double(), dist, tri, cols)
    with pytest.raises(ValueError, match="not contiguous"):
        surface_rows(sh_pack, torch.rand(2 * n, device="cuda")[::2], tri,
                     cols)
    with pytest.raises(ValueError, match="not contiguous"):
        surface_rows(sh_pack.T.contiguous().T, dist, tri, cols)
    shifted = torch.randn(rows * 32 + 1, device="cuda")[1:].view(rows, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        surface_rows(shifted, dist, tri, cols)
    with pytest.raises(ValueError, match="shape"):
        surface_rows(sh_pack[:, :16].contiguous(), dist, tri, cols)
    with pytest.raises(ValueError, match="on cpu"):
        surface_rows(sh_pack.cpu(), dist, tri, cols)
