"""The CUDA kernels of snail_tpu_torch against their plain PyTorch
versions, on the card. Needs a CUDA device and nvcc (the kernels are built
at first use); every test skips without a card. Imports no JAX, so it runs
where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from snail_tpu.bvh import build_bvh
from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.core.vecmath import BIG
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.render.renderer import render_frame
from snail_tpu_torch.scene.procedural import city_scene, terrain_scene
from snail_tpu_torch.scene.scene import make_traced_scene

pytestmark = pytest.mark.cuda

OPTS = RenderOpts(reflections=False, transparency=False, textures=False)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _scene(which: str):
    """(scene on the card, camera, width, height, light position)."""
    if which == "city":
        g = city_scene(6).flatten()
        leaf, light, r, size = 4, (0.0, 30.0, 0.0), 120.0, (256, 128)
    else:  # > 1024 leaves: several summary words per band
        g = terrain_scene(48).flatten()
        leaf, light, r, size = 4, (0.0, 60.0, 0.0), 200.0, (256, 256)
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=leaf)
    scene = make_traced_scene(g, bvh, lights=Light.make(light, (1, 1, 1), r),
                              device="cuda")
    c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
    ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
    cam = Camera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9]) * ext),
                         target=tuple(c), device="cuda")
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
    rows = pt.shared_rows(scene.tri_rows, cam.pos)
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
    rows = pt.shared_rows(scene.tri_rows, light)
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


@pytest.mark.parametrize("which", SCENES)
def test_render_frame_on_card_matches_cpu(which):
    _need_cuda()
    scene, cam, w, h, _ = _scene(which)
    pt.reset_launch_counts()
    img = render_frame(scene, cam, w, h, OPTS)
    torch.cuda.synchronize()
    counts = pt.launch_counts()
    assert all(n > 0 for n in counts.values()), counts
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
