"""The port's textures against the JAX package's (``scene/textures.py``):
the host tables bit for bit, the footprint, the mip pick and point
sampling exactly, bilinear and SAT sampling to 1e-6; then textured frames
of ``checker_atlas(city_scene(4))`` (64 x 64) through the forward, bounce,
counter, instanced and differentiable frames against the JAX package's
(Pallas in interpret mode on the CPU), and two options of ROADMAP item 7
(two bounce levels, no shadows; its four lights are in
tests/test_torch_loaders.py).

The JAX frames run eagerly (the jitted functions' ``__wrapped__`` bodies):
every RenderOpts field is static in the JAX package, so under ``jit``
each option set would compile the frame anew; eagerly, its kernels
compile once per shape. Images: atol 2e-3 on >= 99.8 % of pixels (hit
ties, ROADMAP C7; a point sample may flip a texel where a uv lies on a
texel edge), the max error reported."""

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
from snail_tpu.render import fast as jfast
from snail_tpu.render.renderer import render_frame as j_render_frame
from snail_tpu.scene import instancing as jinst
from snail_tpu.scene import procedural as jproc
from snail_tpu.scene import textures as jt
from snail_tpu.scene.materials import MaterialTable as JMaterialTable
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene
from snail_tpu.scene.scene import with_sat as j_with_sat

from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.render.fast import (render_frame_fast,
                                         render_frame_fast_diff,
                                         render_frame_fast_stats)
from snail_tpu_torch.render.renderer import render_frame
from snail_tpu_torch.scene import instancing as pinst
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene import textures as pt
from snail_tpu_torch.scene.bench_scenes import bounce_materials
from snail_tpu_torch.scene.scene import make_traced_scene, with_sat

W = H = 64
FILTERS = ("point", "bilinear", "sat")
LIGHT = ((0.0, 30.0, 0.0), (1.0, 1.0, 1.0), 120.0)
FWD = dict(reflections=False, transparency=False, textures=True)


def _eager(fn):
    """The JAX function's body, run op by op (see the module docstring)."""
    return getattr(fn, "__wrapped__", fn)


_COND = jax.lax.cond


def _eager_cond(pred, true_fn, false_fn, *operands, **kw):
    """``lax.cond`` outside ``jit`` with a concrete predicate runs one
    branch, as this does, without compiling both (traced conds stay)."""
    if isinstance(pred, jax.core.Tracer):
        return _COND(pred, true_fn, false_fn, *operands, **kw)
    return (true_fn if bool(pred) else false_fn)(*operands, **kw)


@pytest.fixture(autouse=True)
def eager_cond(monkeypatch):
    monkeypatch.setattr(jax.lax, "cond", _eager_cond)


def _close(name, p, j, share=2e-3):
    """Images within 2e-3 on all but ``share`` of pixels, the JAX one not
    black; returns the max error."""
    p = p.detach().numpy() if isinstance(p, torch.Tensor) else p
    err = np.abs(p - np.asarray(j)).max(-1)
    assert p.shape == np.asarray(j).shape, name
    assert (err > 2e-3).mean() <= share, (name, (err > 2e-3).mean(),
                                          err.max())
    assert np.asarray(j).max() > 0.1, name
    return float(err.max())


# --- host tables ---

def _images():
    """Three power-of-two textures of mixed sizes and aspects."""
    rng = np.random.default_rng(11)
    return [rng.random(s, dtype=np.float32)
            for s in ((16, 32, 3), (8, 8, 3), (4, 16, 3))]


def test_host_tables_bit_equal():
    imgs = _images()
    for img in imgs:
        for a, b in zip(jt.gen_mips(img), pt.gen_mips(img)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    ja, jm = jt.build_pyramid_atlas(imgs)
    pa, pm = pt.build_pyramid_atlas(imgs)
    assert pa.dtype == np.float32 and pm.dtype == np.int32
    np.testing.assert_array_equal(pa, np.asarray(ja))
    np.testing.assert_array_equal(pm, np.asarray(jm))
    # every texture at the common base size
    assert pm[:, :2].tolist() == [[32, 16]] * 3 and pa.shape == (3, 32, 32, 3)
    js = np.asarray(jt.build_sat_atlas(ja, jm))
    ps = pt.build_sat_atlas(pa, pm)
    assert ps.dtype == js.dtype == np.float32
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pt.build_sat(imgs[0]),
                                  jt.build_sat(imgs[0]))


@pytest.fixture(scope="module")
def atlas():
    """Both packages' atlas, meta and SAT atlas of :func:`_images`."""
    ja, jm = jt.build_pyramid_atlas(_images())
    js = jt.build_sat_atlas(ja, jm)
    pa, pm = pt.build_pyramid_atlas(_images())
    return ((ja, jm, js), tuple(torch.from_numpy(np.asarray(x))
                                for x in (pa, pm, pt.build_sat_atlas(pa))))


# --- footprint and mip ---

@pytest.mark.parametrize("tile", [(32, 32), (16, 16), (8, 4)])
def test_uv_footprint_equal(tile):
    rng = np.random.default_rng(5)
    n = 3 * tile[0] * tile[1]
    uv = (rng.standard_normal((n, 2)) * 2).astype(np.float32)
    valid = rng.random(n) > 0.25
    j = np.asarray(jt.uv_footprint(jnp.asarray(uv), tile, jnp.asarray(valid)))
    p = pt.uv_footprint(torch.from_numpy(uv), tile, torch.from_numpy(valid))
    np.testing.assert_array_equal(p.numpy(), j)


def test_footprint_needs_tiles_of_two_by_two():
    assert pt.footprint_tiles((32, 32), 4096)
    assert not pt.footprint_tiles((32, 32), 1000)
    assert not pt.footprint_tiles((16, 1), 4096)
    assert not pt.footprint_tiles(None, 4096)


@pytest.mark.parametrize("n_mips", [1, 5, 9, 13, 14])
def test_mip_from_footprint_equal(n_mips):
    """At the powers of two up to 2^24, one below and one above them, 0
    and fractions: the mip of every texture a 14-level chain (8192^2)
    bounds. (Past 14 levels the JAX package's CPU log2 gives 8192 and
    32768 one level less than the bit-length rule: ROADMAP C14.)"""
    k = np.arange(25)
    ip = np.concatenate([2.0 ** k, 2.0 ** k - 1, 2.0 ** k + 1,
                         [0.0, 0.4, 1.5, 2.75, 1000.5]])
    w, h = np.float32(4.0), np.float32(2.0)
    duv = np.stack([ip / w, ip / h * 1.5], -1).astype(np.float32)
    j = np.asarray(jt.mip_from_footprint(jnp.asarray(duv), w, h,
                                         jnp.int32(n_mips)))
    p = pt.mip_from_footprint(torch.from_numpy(duv), float(w), float(h),
                              torch.tensor(n_mips, dtype=torch.int32))
    np.testing.assert_array_equal(p.numpy(), j)
    small = ip < 2 ** 20  # float32 log2 exact enough for the bit length
    rule = np.minimum([int(x).bit_length() for x in ip], n_mips - 1)
    np.testing.assert_array_equal(p.numpy()[small], rule[small])


# --- samplers ---

def _samples(case, n=4096, seed=3):
    """(tex_id, uv, diff_uv) of one sampling case."""
    rng = np.random.default_rng(seed)
    tid = rng.integers(-1, 3, n).astype(np.int32)  # -1: untextured
    if case == "negative":
        uv = -rng.random((n, 2)) * 3.0
    elif case == "seam":  # within a texel of the wrap seams
        uv = (rng.integers(-2, 3, (n, 2)) + rng.uniform(-0.04, 0.04, (n, 2)))
    else:
        uv = rng.standard_normal((n, 2)) * 3.0
    # footprints from a tenth of a texel to past the texture: every mip
    duv = np.exp(rng.uniform(np.log(1e-3), np.log(2.0), (n, 2)))
    return tid, uv.astype(np.float32), duv.astype(np.float32)


def _both(fn_j, fn_p, atlas, case, footprint, **kw):
    (ja, jm, jsat), (pa, pm, psat) = atlas
    tid, uv, duv = _samples(case)
    jd = jnp.asarray(duv) if footprint else None
    pd = torch.from_numpy(duv) if footprint else None
    j = np.asarray(fn_j(ja, jm, jsat, jnp.asarray(tid), jnp.asarray(uv), jd,
                        **kw))
    p = fn_p(pa, pm, psat, torch.from_numpy(tid), torch.from_numpy(uv), pd,
             **kw).numpy()
    return p, j


CASES = ["random", "negative", "seam"]


@pytest.mark.parametrize("footprint", [False, True], ids=["mip0", "mips"])
@pytest.mark.parametrize("case", CASES)
def test_point_sample_equal(atlas, case, footprint):
    p, j = _both(lambda a, m, s, *x: jt.sample_atlas(a, m, *x),
                 lambda a, m, s, *x: pt.sample_atlas(a, m, *x),
                 atlas, case, footprint)
    np.testing.assert_array_equal(p, j)
    if footprint:  # the footprints reach every mip of the chain
        _, pm, _ = atlas[1]
        tid, _, duv = _samples(case)
        mips = pt.mip_from_footprint(torch.from_numpy(duv), 32.0, 16.0,
                                     pm[0, 2])
        assert set(mips.tolist()) == set(range(int(pm[0, 2])))


@pytest.mark.parametrize("footprint", [False, True], ids=["mip0", "mips"])
@pytest.mark.parametrize("case", CASES)
def test_bilinear_sample_close(atlas, case, footprint):
    p, j = _both(lambda a, m, s, *x: jt.sample_atlas(a, m, *x,
                                                     filter="bilinear"),
                 lambda a, m, s, *x: pt.sample_atlas(a, m, *x,
                                                     filter="bilinear"),
                 atlas, case, footprint)
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_sat_sample_close(atlas, case):
    p, j = _both(lambda a, m, s, *x: jt.sample_sat_atlas(s, m, *x),
                 lambda a, m, s, *x: pt.sample_sat_atlas(s, m, *x),
                 atlas, case, True)
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)


def test_sample_sat_one_texture_close():
    rng = np.random.default_rng(9)
    img = rng.random((16, 32, 3)).astype(np.float32)
    lo = rng.uniform(-0.2, 0.9, (500, 2)).astype(np.float32)
    hi = (lo + rng.uniform(0.0, 0.6, (500, 2))).astype(np.float32)
    j = np.asarray(jt.sample_sat(jt.build_sat(img), jnp.asarray(lo),
                                 jnp.asarray(hi)))
    p = pt.sample_sat(pt.build_sat(img), torch.from_numpy(lo),
                      torch.from_numpy(hi))
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=1e-6)


# --- textured frames ---

def _scene_pair(bounce=False, lights=LIGHT):
    """checker_atlas (and its SATs) of city_scene(4) at leaf 16 in both
    packages, on one BVH, with bench.py's camera; with ``bounce``,
    material 0 reflective and half transparent. (js, jcam, ps, pcam)."""
    g = pproc.city_scene(4).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=16)
    jmats = None
    if bounce:
        jmats = JMaterialTable.build({"": 0}, [])
        jmats.reflectivity[0] = 0.5
        jmats.dissolve[0] = 0.5
    js = j_with_sat(jt.checker_atlas(j_make_traced_scene(
        jproc.city_scene(4).flatten(), bvh, jmats,
        lights=JLight.make(*lights))))
    ps = with_sat(pt.checker_atlas(make_traced_scene(
        g, bvh, bounce_materials() if bounce else None,
        lights=Light.make(*lights, device="cpu"), device="cpu")))
    c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
    ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
    pos = tuple(c + np.array([0.45, 0.35, 0.9]) * ext)
    return (js, JCamera.look_at(pos=pos, target=tuple(c)), ps,
            Camera.look_at(pos=pos, target=tuple(c), device="cpu"))


@pytest.fixture(scope="module")
def city():
    return _scene_pair()


def test_checker_atlas_matches_jax(city):
    js, _, ps, _ = city
    for name in ("sh_pack", "mat_pack", "tex_atlas", "tex_meta", "tex_sat"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    assert (ps.mat_pack[:, 8] == 0).all() and (ps.sh_pack[:, 24] == 0).all()


@pytest.mark.parametrize("filt", FILTERS)
def test_textured_fwd_frame_matches_jax(city, filt):
    js, jcam, ps, pcam = city
    opts = dict(FWD, tex_filter=filt)
    j = _eager(jfast.render_frame_fast)(js, jcam, W, H, JRenderOpts(**opts))
    p = render_frame(ps, pcam, W, H, RenderOpts(**opts))
    _close(filt, p, j)
    # the atlas is applied: most hits change colour
    flat = render_frame(ps, pcam, W, H, RenderOpts(**dict(FWD,
                                                          textures=False)))
    assert (np.abs((p - flat).numpy()).max(-1) > 1e-2).mean() > 0.3


def test_textured_frame_uses_footprint_mips(city):
    """The primary hits' footprints reach more than one mip, and the
    filters give different frames."""
    _, _, ps, pcam = city
    imgs = [render_frame_fast(ps, pcam, W, H, RenderOpts(**FWD,
                                                         tex_filter=f))
            for f in FILTERS]
    assert float((imgs[0] - imgs[1]).abs().max()) > 1e-3
    assert float((imgs[0] - imgs[2]).abs().max()) > 1e-3


def test_textured_counter_frame_matches_jax(city):
    js, jcam, ps, pcam = city
    opts = dict(FWD, tex_filter="bilinear")
    j, _ = jfast.render_frame_fast_stats(js, jcam, W, H, JRenderOpts(**opts))
    p, counts = render_frame_fast_stats(ps, pcam, W, H, RenderOpts(**opts))
    assert torch.equal(p, render_frame_fast(ps, pcam, W, H,
                                            RenderOpts(**opts)))
    assert counts["rays"] == W * H * 2 and counts["tri_blocks"] > 0
    _close("stats", p, j)


@pytest.mark.parametrize("filt", ["point", "sat"])
def test_textured_bounce_frame_matches_jax(filt):
    js, jcam, ps, pcam = _scene_pair(bounce=True)
    opts = dict(textures=True, tex_filter=filt)
    j = _eager(jfast.render_frame_fast)(js, jcam, W, H, JRenderOpts(**opts))
    p = render_frame(ps, pcam, W, H, RenderOpts(**opts))
    _close(filt, p, j)


ROT = np.stack([np.eye(3), np.asarray(jinst.rotation_y(np.float32(0.6)))]
               ).astype(np.float32)


def test_textured_instanced_frame_matches_jax(city):
    """Two instances of the textured city, the second turned and moved
    beside the first; the primary wavefront's 32 x 32 tiles give the
    footprint."""
    js, _, ps, _ = city
    ext = float((ps.root_hi - ps.root_lo).max())
    trans = np.array([[0.0, 0.0, 0.0], [1.1 * ext, 0.0, -0.3 * ext]],
                     np.float32)
    cam = dict(pos=(0.55 * ext, 0.6 * ext, 1.6 * ext),
               target=(0.55 * ext, 0.0, 0.0))
    opts = dict(FWD, tex_filter="bilinear")
    j = jinst.render_instanced(
        jinst.make_instances(js, jnp.asarray(ROT), jnp.asarray(trans)),
        JCamera.look_at(**cam), W, H, JRenderOpts(**opts))
    p = pinst.render_instanced(pinst.make_instances(ps, ROT, trans),
                               Camera.look_at(**cam, device="cpu"), W, H,
                               RenderOpts(**opts))
    _close("instanced", p, j)


MOVED = (8.0, 26.0, -6.0)  # the diff target's light position


@pytest.mark.parametrize("filt", ["point", "bilinear"])
def test_textured_diff_frame_and_grads_match_jax(city, filt):
    """render_frame_fast_diff on the textured city: its image against the
    JAX package's and against the port's forward frame, and the gradients
    of an MSE against a frame lit from a moved light with respect to the
    vertices and the light against ``jax.grad`` (the tolerances of
    tests/test_fast_diff.py:84-91). Bilinear weights carry uv gradients
    to the vertices."""
    js, jcam, ps, pcam = city
    opts = dict(FWD, tex_filter=filt)
    jdiff = _eager(jfast.render_frame_fast_diff)
    moved = dataclasses.replace(js, lights=JLight.make(MOVED, *LIGHT[1:]))
    target = np.array(_eager(jfast.render_frame_fast)(
        moved, jcam, W, H, JRenderOpts(**opts)))
    names = ("tri_a", "tri_ba", "tri_ca", "light_pos", "light_color")

    def jloss(params):
        s = dataclasses.replace(
            js, tri_a=params["tri_a"], tri_ba=params["tri_ba"],
            tri_ca=params["tri_ca"],
            lights=JLight(pos=params["light_pos"],
                          color=params["light_color"],
                          radius=js.lights.radius))
        return jnp.mean((jdiff(s, jcam, W, H, JRenderOpts(**opts))
                         - target) ** 2)

    jp = {"tri_a": js.tri_a, "tri_ba": js.tri_ba, "tri_ca": js.tri_ca,
          "light_pos": js.lights.pos, "light_color": js.lights.color}
    jl, jg = jax.value_and_grad(jloss)(jp)

    pp = {k: (getattr(ps, k) if k.startswith("tri") else
              getattr(ps.lights, k[6:])).clone().requires_grad_()
          for k in names}
    s = dataclasses.replace(
        ps, tri_a=pp["tri_a"], tri_ba=pp["tri_ba"], tri_ca=pp["tri_ca"],
        lights=Light(pos=pp["light_pos"], color=pp["light_color"],
                     radius=ps.lights.radius))
    img = render_frame_fast_diff(s, pcam, W, H, RenderOpts(**opts))
    _close("diff", img, jdiff(js, jcam, W, H, JRenderOpts(**opts)))
    fwd = render_frame_fast(ps, pcam, W, H, RenderOpts(**opts))
    assert torch.allclose(img.detach(), fwd, atol=2e-5)
    loss = ((img - torch.from_numpy(target)) ** 2).mean()
    grads = torch.autograd.grad(loss, [pp[k] for k in names])
    loss, jl = float(loss.detach()), float(jl)
    assert abs(loss - jl) < 3e-4 * max(1.0, abs(jl))
    for k, g in zip(names, grads):
        a, b = g.numpy(), np.asarray(jg[k])
        denom = max(np.abs(b).max(), 1e-8)
        assert np.abs(b).max() > 0 and np.isfinite(a).all(), k
        assert np.quantile(np.abs(a - b), 0.999) < 5e-3 * denom, k
        assert np.abs(a - b).mean() < 1e-3 * denom, k


# --- ROADMAP item 7: options not yet held against the JAX package ---

@pytest.mark.parametrize("path", ["fast", "portable"])
def test_two_bounce_levels_match_jax(path):
    """max_bounces=2 on bounce_materials: reflections of reflections and
    what lies behind what lies behind, fast (64 x 64) and portable (48 x
    32) frames; the second level changes the frame."""
    js, jcam, ps, pcam = _scene_pair(bounce=True)
    opts = dict(textures=True, max_bounces=2)
    if path == "fast":
        w, h = W, H
        j = _eager(jfast.render_frame_fast)(js, jcam, w, h,
                                            JRenderOpts(**opts))
    else:
        w, h = 48, 32
        j = j_render_frame(js.with_backend("reference"), jcam, w, h,
                           JRenderOpts(**opts))
    p = render_frame(ps, pcam, w, h, RenderOpts(**opts))
    _close(path, p, j)
    one = render_frame(ps, pcam, w, h, RenderOpts(textures=True))
    assert float((p - one).abs().max()) > 1e-2


def test_shadows_off_matches_jax(city):
    js, jcam, ps, pcam = city
    opts = dict(FWD, shadows=False)
    j = _eager(jfast.render_frame_fast)(js, jcam, W, H, JRenderOpts(**opts))
    p = render_frame(ps, pcam, W, H, RenderOpts(**opts))
    _close("no shadows", p, j)
    lit = render_frame(ps, pcam, W, H, RenderOpts(**FWD))
    assert bool((p >= lit - 1e-6).all()) and float((p - lit).max()) > 1e-2
