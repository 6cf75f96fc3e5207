"""The port's frame against the JAX package's render_frame_fast (Pallas
kernels in interpret mode on the CPU), without and with reflection and
transparency bounces, the committed golden image, and the photon option,
which the port refused until it had the photon map."""

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
from snail_tpu.scene.materials import MaterialTable as JMaterialTable
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.render.fast import render_frame_fast
from snail_tpu_torch.render.renderer import Renderer, render_frame, to_rgb8
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene.bench_scenes import bounce_materials
from snail_tpu_torch.scene.scene import make_traced_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden", "cornell64_fast.png")
OPTS = dict(reflections=False, transparency=False, textures=False)


def _jax_bounce_materials():
    """The JAX package's counterpart of ``bounce_materials``."""
    mats = JMaterialTable.build({"": 0}, [])
    mats.reflectivity[0] = 0.5
    mats.dissolve[0] = 0.5
    return mats


def _pair(name, bounce=False):
    """Both packages' scene and camera on one BVH: (js, jcam, ps, pcam, w,
    h) — the golden config for cornell, the bench.py camera for city; with
    ``bounce``, material 0 reflective and half transparent."""
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
    js = j_make_traced_scene(g, bvh,
                             _jax_bounce_materials() if bounce else None,
                             lights=JLight.make(*light))
    ps = make_traced_scene(mk(pproc).flatten(), bvh,
                           bounce_materials() if bounce else None,
                           lights=Light.make(*light, device="cpu"),
                           device="cpu")
    if pos is None:
        c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
        ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
        pos, target = tuple(c + np.array([0.45, 0.35, 0.9]) * ext), tuple(c)
    jcam = JCamera.look_at(pos=pos, target=target)
    pcam = Camera.look_at(pos=pos, target=target, device="cpu")
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


@pytest.mark.parametrize("name", ["cornell", "city"])
def test_bounce_frame_matches_jax(name):
    """Reflection and transparency bounces (one level, RenderOpts'
    max_bounces) on every hit, through the general kernels' plain
    versions, against the JAX package's frame."""
    js, jcam, ps, pcam, w, h = _pair(name, bounce=True)
    assert ps.has_refl and ps.has_transp
    opts = dict(textures=False)
    jimg = np.asarray(j_render_frame_fast(js, jcam, w, h,
                                          JRenderOpts(**opts)))
    pimg = render_frame(ps, pcam, w, h, RenderOpts(**opts))
    err = np.abs(pimg.numpy() - jimg).max(-1)
    assert (err > 2e-3).mean() <= 1e-3, (name, err.max())
    # the bounces changed the frame
    flat = render_frame(ps, pcam, w, h, RenderOpts(**OPTS)).numpy()
    assert np.abs(flat - jimg).max() > 0.1


def test_unported_options_raise():
    """Photons, the last option the port refused, now render: without a
    grid the option adds nothing, and with one the packed and portable
    frames gain the photon term against the JAX package's frames (the
    parity cases are in tests/test_torch_photons.py)."""
    from snail_tpu.render import photons as jph
    from snail_tpu.render.renderer import render_frame as j_render_frame
    from snail_tpu_torch.render import photons as pph

    js, jcam, ps, pcam, w, h = _pair("cornell", bounce=True)
    opts = dict(textures=False, photons=True, photon_exposure=0.5)
    off = render_frame(ps, pcam, w, h, RenderOpts(textures=False))
    assert torch.equal(render_frame(ps, pcam, w, h, RenderOpts(**opts)), off)
    jpmap = jph.trace_photons(js, n_per_light=512, seed=2)
    lo, hi = ps.root_lo, ps.root_hi
    jg = jph.photon_grid(jpmap, lo.numpy(), hi.numpy(), res=12)
    pg = pph.photon_grid(pph.PhotonMap(jpmap.pos, jpmap.power, jpmap.normal,
                                       jpmap.dirn), lo, hi, res=12)
    on = render_frame(ps, pcam, w, h, RenderOpts(**opts), photon_grid=pg)
    assert float((on - off).max()) > 1e-3
    # the portable frame at 40 x 24 (not a multiple of the tile)
    jimg = np.asarray(j_render_frame.__wrapped__(
        js, jcam, 40, 24, JRenderOpts(**opts), photon_grid=jg))
    pimg = render_frame(ps, pcam, 40, 24, RenderOpts(**opts), photon_grid=pg)
    err = np.abs(pimg.numpy() - jimg).max(-1)
    assert (err > 2e-3).mean() <= 2e-3, err.max()


def test_bounce_options_run_when_no_material_bounces():
    """reflections/transparency on a scene without such materials run the
    forward frame, as the JAX package's static has_refl/has_transp skip."""
    _, _, ps, pcam, w, h = _pair("cornell")
    a = render_frame(ps, pcam, w, h, RenderOpts(textures=False))
    b = render_frame(ps, pcam, w, h, RenderOpts(**OPTS))
    assert torch.equal(a, b)


def test_port_renders_without_jax():
    """snail_tpu_torch imports neither JAX nor snail_tpu, directly or
    through another module: every module of the package and chip_smoke.py
    import without them, and the CPU renders a forward frame, a bounce
    frame, a differentiable one, an instanced and a counter frame, a
    frame of a walk scene (node tables), a 48 x 32 frame through the
    portable integrator, a photon map and a frame and preview with its
    photon term, iso and mip views of a volume, a scene loaded from an
    OBJ, an MTL and a PNG (load_scene) in textured frames, packed and
    portable; the tile codec encodes and decodes a tile, and a frame and
    a training step run on the trivial mesh (the net, apps and parallel
    modules import with the rest)."""
    code = textwrap.dedent("""
        import dataclasses
        import importlib
        import pkgutil
        import sys
        sys.modules["jax"] = None
        sys.modules["snail_tpu"] = None
        import torch
        import snail_tpu_torch
        for m in pkgutil.walk_packages(snail_tpu_torch.__path__,
                                       "snail_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        from snail_tpu_torch.bvh import build_bvh
        from snail_tpu_torch.core.types import Camera, Light, RenderOpts
        from snail_tpu_torch.render.fast import (render_frame_fast_diff,
                                                 render_frame_fast_stats)
        from snail_tpu_torch.render.renderer import render_frame
        from snail_tpu_torch.scene.bench_scenes import bounce_materials
        from snail_tpu_torch.scene.instancing import (make_instances,
                                                      render_instanced,
                                                      rotation_y)
        from snail_tpu_torch.scene.procedural import cornell_scene
        from snail_tpu_torch.scene.scene import make_traced_scene
        g = cornell_scene().flatten()
        lo, hi = g.bounds()
        bvh = build_bvh(lo, hi, leaf_size=8)
        light = Light.make((0, 3.5, 0), (1, 1, 1), 30, device="cpu")
        scene = make_traced_scene(g, bvh, lights=light, device="cpu")
        cam = Camera.look_at(pos=(0.0, 2.0, 6.0), target=(0.0, 1.5, 0.0),
                             device="cpu")
        img = render_frame(scene, cam, 64, 64,
                           RenderOpts(reflections=False, transparency=False))
        assert img.shape == (64, 64, 3) and float(img.max()) > 0.1
        bounce = make_traced_scene(g, bvh, bounce_materials(), lights=light,
                                   device="cpu")
        img = render_frame(bounce, cam, 64, 64, RenderOpts(textures=False))
        assert img.shape == (64, 64, 3) and float(img.max()) > 0.1
        tri_a = bounce.tri_a.clone().requires_grad_()
        img = render_frame_fast_diff(dataclasses.replace(bounce, tri_a=tri_a),
                                     cam, 64, 64, RenderOpts(textures=False))
        img.square().mean().backward()
        assert tri_a.grad.abs().max() > 0
        isc = make_instances(bounce, torch.stack([torch.eye(3),
                                                  rotation_y(0.5)]),
                             [[0.0, 0.0, 0.0], [3.0, 0.0, -4.0]])
        img = render_instanced(isc, cam, 64, 64, RenderOpts(textures=False))
        assert img.shape == (64, 64, 3) and float(img.max()) > 0.1
        img, stats = render_frame_fast_stats(scene, cam, 64, 64)
        assert float(img.max()) > 0.1 and stats["tri_blocks"] > 0
        walk = make_traced_scene(g, bvh, lights=light, device="cpu",
                                 walk=True)
        img = render_frame(walk, cam, 64, 64, RenderOpts(textures=False))
        assert img.shape == (64, 64, 3) and float(img.max()) > 0.1
        img = render_frame(bounce, cam, 48, 32, RenderOpts(textures=False))
        assert img.shape == (32, 48, 3) and float(img.max()) > 0.1
        from snail_tpu_torch.render.photons import (photon_grid,
                                                    render_photon_preview,
                                                    trace_photons)
        pmap = trace_photons(scene, n_per_light=256)
        pg = photon_grid(pmap, scene.root_lo, scene.root_hi, res=8)
        popts = RenderOpts(reflections=False, transparency=False,
                           photons=True)
        img = render_frame(scene, cam, 64, 64, popts, photon_grid=pg)
        assert float((img - render_frame(scene, cam, 64, 64, popts)).max()
                     ) > 0
        assert float(render_photon_preview(scene, cam, 32, 32, pg).max()) > 0
        from snail_tpu_torch.apps.dicom_viewer import viewer_camera
        from snail_tpu_torch.volume import build_vtree, render_volume
        from snail_tpu_torch.volume.data import synthetic_sphere
        vt = build_vtree(synthetic_sphere(32), device="cpu")
        for mode in ("iso", "mip"):
            img = render_volume(vt, viewer_camera(vt.shape, "cpu"), 32, 32,
                                mode=mode)
            assert img.shape == (32, 32, 3) and float(img.max()) > 0.5
        import os
        import tempfile
        import numpy as np
        from PIL import Image
        from snail_tpu_torch.scene.scene import load_scene, with_sat
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "quad.obj"), "w") as f:
                f.write("mtllib quad.mtl\\nv -2 0 -2\\nv 2 0 -2\\nv 2 0 2\\n"
                        "v -2 0 2\\nvt 0 0\\nvt 2 0\\nvt 2 2\\nvt 0 2\\n"
                        "usemtl tex\\nf 4/4 3/3 2/2 1/1\\n")
            with open(os.path.join(d, "quad.mtl"), "w") as f:
                f.write("newmtl tex\\nKd 1 1 1\\nmap_Kd chk.png\\n")
            chk = (np.indices((8, 8)).sum(0) % 2 * 200 + 40).astype(np.uint8)
            Image.fromarray(np.stack([chk] * 3, -1)).save(
                os.path.join(d, "chk.png"))
            quad = with_sat(load_scene(os.path.join(d, "quad.obj"),
                                       tex_dir=d, cache_dir=d,
                                       device="cpu"))
        qcam = Camera.look_at(pos=(0.0, 3.0, 3.0), target=(0.0, 0.0, 0.0),
                              device="cpu")
        assert quad.tex_atlas.shape == (1, 16, 8, 3)
        for size, filt in (((64, 64), "sat"), ((48, 32), "bilinear")):
            opts = RenderOpts(tex_filter=filt)
            img = render_frame(quad, qcam, *size, opts)
            flat = render_frame(quad, qcam, *size,
                                RenderOpts(textures=False))
            assert float(img.max()) > 0.1
            assert float((img - flat).abs().max()) > 0.1
        from snail_tpu_torch.net import codec
        from snail_tpu_torch.parallel import distributed as pdist
        from snail_tpu_torch.parallel.mesh import (render_frame_sharded,
                                                   train_step_sharded)
        rgb8 = (np.indices((16, 24)).sum(0) % 7 * 30).astype(np.uint8)
        rgb8 = np.stack([rgb8] * 3, -1)
        assert (codec.decode_tile(*codec.encode_tile(rgb8), 16, 24)
                == rgb8).all()
        mesh = pdist.global_mesh()
        img = render_frame_sharded(scene, cam, 32, 32,
                                   RenderOpts(textures=False), mesh)
        assert img.shape == (32, 32, 3) and float(img.max()) > 0.1
        loss, new = train_step_sharded(
            scene, {"mat_diffuse": scene.mat_diffuse}, img * 0.5, cam, 32,
            32, RenderOpts(textures=False), mesh)
        assert float(loss) > 0 and new["mat_diffuse"].shape == (
            scene.mat_diffuse.shape)
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "snail_tpu")
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
