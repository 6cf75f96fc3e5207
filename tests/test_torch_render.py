"""The port's forward frame against the JAX package's render_frame_fast
(Pallas kernels in interpret mode on the CPU), the committed golden image,
and the options the port does not run yet."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from snail_tpu.bvh import build_bvh
from snail_tpu.core.types import Camera as JCamera
from snail_tpu.core.types import Light as JLight
from snail_tpu.core.types import RenderOpts as JRenderOpts
from snail_tpu.render.fast import render_frame_fast as j_render_frame_fast
from snail_tpu.scene import procedural as jproc
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.render.fast import render_frame_fast
from snail_tpu_torch.render.renderer import Renderer, render_frame, to_rgb8
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene.materials import MaterialTable
from snail_tpu_torch.scene.scene import make_traced_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden", "cornell64_fast.png")
OPTS = dict(reflections=False, transparency=False, textures=False)


def _pair(name):
    """Both packages' scene and camera on one BVH: (js, jcam, ps, pcam, w,
    h) — the golden config for cornell, the bench.py camera for city."""
    if name == "cornell":
        mk, leaf, w = (lambda m: m.cornell_scene()), 8, 64
        light = ((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0)
        pos, target = (0.0, 2.0, 6.0), (0.0, 1.5, 0.0)
    else:
        mk, leaf, w = (lambda m: m.city_scene(4)), 16, 128
        light = ((0.0, 30.0, 0.0), (1.0, 1.0, 1.0), 120.0)
        pos = target = None
    g = mk(jproc).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=leaf)
    js = j_make_traced_scene(g, bvh, lights=JLight.make(*light))
    ps = make_traced_scene(mk(pproc).flatten(), bvh, lights=Light.make(*light))
    if pos is None:
        c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
        ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
        pos, target = tuple(c + np.array([0.45, 0.35, 0.9]) * ext), tuple(c)
    jcam = JCamera.look_at(pos=pos, target=target)
    pcam = Camera.look_at(pos=pos, target=target)
    return js, jcam, ps, pcam, w, w


@pytest.fixture(scope="module", params=["cornell", "city"])
def frames(request):
    js, jcam, ps, pcam, w, h = _pair(request.param)
    jimg = np.asarray(j_render_frame_fast(js, jcam, w, h,
                                          JRenderOpts(**OPTS)))
    pimg = render_frame(ps, pcam, w, h, RenderOpts(**OPTS))
    return request.param, jimg, pimg, ps, pcam


def test_render_frame_matches_jax(frames):
    name, jimg, pimg, _, _ = frames
    assert pimg.shape == jimg.shape and pimg.dtype == torch.float32
    err = np.abs(pimg.numpy() - jimg).max(-1)
    # atol 2e-3 (tests/test_photon_render.py:130); pixels beyond it are
    # hit ties, where either triangle is right (ROADMAP C7)
    assert (err > 2e-3).mean() <= 1e-3, (name, err.max())
    assert jimg.max() > 0.1


def test_cornell_matches_golden():
    from PIL import Image

    _, _, ps, pcam, w, h = _pair("cornell")
    img = to_rgb8(render_frame(ps, pcam, w, h, RenderOpts(**OPTS)))
    golden = np.asarray(Image.open(GOLD).convert("RGB")).astype(np.int16)
    assert np.abs(img.astype(np.int16) - golden).max() <= 1


def test_shading_off_view_is_inverse_distance(frames):
    _, _, _, ps, pcam = frames
    w = h = 64
    img = render_frame(ps, pcam, w, h, RenderOpts(shading=False, **OPTS))
    dist = pt.camera_trace(ps, pcam, w, h)[0]
    hit = (dist > 0) & (dist < 3.4e37)
    idist = torch.where(hit, 1.0 / dist, 0.0)
    from snail_tpu_torch.render.fast import _packets_to_image

    ref = _packets_to_image(idist * 20.0, idist * 250.0, idist * 2.0, w, h)
    assert torch.equal(img, ref) and hit.any()


def test_supersample_box_averages(frames):
    _, _, _, ps, pcam = frames
    opts = RenderOpts(supersample=True, **OPTS)
    img = render_frame(ps, pcam, 64, 64, opts)
    big = render_frame_fast(ps, pcam, 128, 128, opts)
    ref = (big[0::2, 0::2] + big[1::2, 0::2] + big[0::2, 1::2]
           + big[1::2, 1::2]) * 0.25
    assert img.shape == (64, 64, 3) and torch.equal(img, ref)


def test_renderer_returns_host_image(frames):
    _, _, pimg, ps, pcam = frames
    r = Renderer(ps, pimg.shape[1], pimg.shape[0], RenderOpts(**OPTS))
    img = r.render(pcam)
    assert isinstance(img, np.ndarray) and r.frames == 1
    np.testing.assert_array_equal(img, pimg.numpy())
    assert r.render_rgb8(pcam).dtype == np.uint8


def _reflective_scene():
    g = pproc.cornell_scene().flatten()
    lo, hi = g.bounds()
    mats = MaterialTable.build({"": 0})
    mats.reflectivity[0] = 0.5
    mats.dissolve[0] = 0.5
    return make_traced_scene(g, build_bvh(lo, hi, leaf_size=8), mats,
                             Light.make((0.0, 3.5, 0.0), (1, 1, 1), 30.0))


@pytest.mark.parametrize("opts,match", [
    (dict(reflections=True, transparency=False, textures=False),
     "reflection"),
    (dict(reflections=False, transparency=True, textures=False),
     "transparency"),
    (dict(photons=True, **OPTS), "photon"),
])
def test_unported_options_raise(opts, match):
    scene = _reflective_scene()
    cam = Camera.look_at(pos=(0.0, 2.0, 6.0), target=(0.0, 1.5, 0.0))
    with pytest.raises(NotImplementedError, match=match):
        render_frame(scene, cam, 64, 64, RenderOpts(**opts))


def test_bounce_options_run_when_no_material_bounces():
    """reflections/transparency on a scene without such materials run the
    forward frame, as the JAX package's static has_refl/has_transp skip."""
    _, _, ps, pcam, w, h = _pair("cornell")
    a = render_frame(ps, pcam, w, h, RenderOpts(textures=False))
    b = render_frame(ps, pcam, w, h, RenderOpts(**OPTS))
    assert torch.equal(a, b)


def test_port_renders_without_jax():
    """snail_tpu_torch imports no JAX, directly or through another module."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        from snail_tpu.bvh import build_bvh
        from snail_tpu_torch.core.types import Camera, Light, RenderOpts
        from snail_tpu_torch.render.renderer import render_frame
        from snail_tpu_torch.scene.procedural import cornell_scene
        from snail_tpu_torch.scene.scene import make_traced_scene
        g = cornell_scene().flatten()
        lo, hi = g.bounds()
        scene = make_traced_scene(g, build_bvh(lo, hi, leaf_size=8),
                                  lights=Light.make((0, 3.5, 0), (1, 1, 1), 30))
        cam = Camera.look_at(pos=(0.0, 2.0, 6.0), target=(0.0, 1.5, 0.0))
        img = render_frame(scene, cam, 64, 64,
                           RenderOpts(reflections=False, transparency=False))
        assert img.shape == (64, 64, 3) and float(img.max()) > 0.1
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
