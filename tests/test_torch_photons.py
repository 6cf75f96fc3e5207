"""The port's photon mapping against the JAX package's
(``snail_tpu.render.photons``) on procedural scenes: the photon map traced
from the JAX package's own directions, the port's stratified sampler, the
kd-tree and its gather, the density grid and its trilinear fetch, and the
photon term of the frames: the packed frame (primary hits only), the
portable integrator with a reflective material (its bounces gather too,
ROADMAP C18) and the preview; ``photons`` without a grid changes no
frame.

The JAX packed frame runs eagerly (its ``__wrapped__`` body, as in
tests/test_torch_textures.py), its Pallas kernels in interpret mode; the
JAX portable frames trace with its jnp reference. Both packages' frames
take the same photon map (the JAX one), so their grids are equal bit for
bit. Tolerances: positions and normals of the photons 1e-5 (the two
traversals round the hit distance differently); the grid fetch 1e-6
(XLA fuses its lerps); images atol 2e-3 on >= 99.8 % of pixels (hit ties,
ROADMAP C7; the cameras' rsqrt, ROADMAP C)."""

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
from snail_tpu.render import photons as jph
from snail_tpu.render.renderer import render_frame as j_render_frame
from snail_tpu.scene import procedural as jproc
from snail_tpu.scene.materials import MaterialTable as JMaterialTable
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.render import photons as pph
from snail_tpu_torch.render.fast import (render_frame_fast,
                                         render_frame_fast_diff,
                                         render_frame_fast_stats)
from snail_tpu_torch.render.renderer import render_frame
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene.bench_scenes import bounce_materials
from snail_tpu_torch.scene.scene import make_traced_scene

FWD = dict(reflections=False, transparency=False, textures=False)
ON = dict(photons=True, photon_exposure=0.5)
# name -> (procedural scene, leaf, lights: pos, colour, radius); the box's
# light inside it; cornell at leaf 64 is a fat-leaf scene (B11b)
CORNELL_LIGHTS = [((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0),
                  ((1.0, 2.0, 1.0), (0.3, 0.4, 0.9), 20.0)]
SCENES = {
    "cornell": ("cornell", 8, CORNELL_LIGHTS),
    "box": ("box", 4, [((0.0, 0.5, 0.0), (1.0, 1.0, 1.0), 40.0)]),
    "cornell_fat": ("cornell", 64, CORNELL_LIGHTS),
}
CAM = ((0.0, 2.0, 6.0), (0.0, 1.5, 0.0))


def _eager(fn):
    return getattr(fn, "__wrapped__", fn)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU frames are many small tensor ops. On a machine
    whose cores other test workers keep busy, PyTorch's intra-op thread
    pool makes each of them wait (the volume march took 44 s there against
    0.7 s on one thread), so they run on one thread; the result does not
    depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_COND = jax.lax.cond


def _eager_cond(pred, true_fn, false_fn, *operands, **kw):
    """``lax.cond`` outside ``jit`` with a concrete predicate runs one
    branch without compiling both (traced conds stay)."""
    if isinstance(pred, jax.core.Tracer):
        return _COND(pred, true_fn, false_fn, *operands, **kw)
    return (true_fn if bool(pred) else false_fn)(*operands, **kw)


@pytest.fixture(autouse=True)
def eager_cond(monkeypatch):
    monkeypatch.setattr(jax.lax, "cond", _eager_cond)


def _pair(name, bounce=False, walk=False):
    """Both packages' scene of ``name`` on one BVH (material 0 reflective
    and half transparent with ``bounce``; the port's with node tables with
    ``walk``): (js, ps)."""
    kind, leaf, lights = SCENES[name]
    g = getattr(jproc, f"{kind}_scene")().flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=leaf)
    pos, col, rad = (list(x) for x in zip(*lights))
    jmats = None
    if bounce:
        jmats = JMaterialTable.build({"": 0}, [])
        jmats.reflectivity[0] = 0.5
        jmats.dissolve[0] = 0.5
    js = j_make_traced_scene(g, bvh, jmats,
                             lights=JLight.make(pos, col, rad))
    ps = make_traced_scene(getattr(pproc, f"{kind}_scene")().flatten(), bvh,
                           bounce_materials() if bounce else None,
                           lights=Light.make(pos, col, rad, device="cpu"),
                           device="cpu", walk=walk)
    return js, ps


def _jax_directions(n, seed, n_lights):
    """The directions JAX ``trace_photons`` draws for each light."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_lights):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jph._stratified_sphere(n, sub)))
    return out


def _to_port(jpmap):
    return pph.PhotonMap(*(getattr(jpmap, f.name)
                           for f in dataclasses.fields(jpmap)))


@pytest.fixture(scope="module")
def cornell():
    js, ps = _pair("cornell")
    jpmap = jph.trace_photons(js, n_per_light=1024, seed=3)
    return js, ps, jpmap


@pytest.mark.parametrize("name", list(SCENES))
def test_photon_map_from_jax_directions(name):
    js, ps = _pair(name)
    assert pt.is_fat(ps) == name.endswith("_fat")
    n, seed = 2048, 1
    jp = jph.trace_photons(js, n_per_light=n, seed=seed)
    parts = [pph._trace_light(ps, li, torch.tensor(d))
             for li, d in enumerate(_jax_directions(n, seed, len(ps.lights)))]
    pp = pph.PhotonMap(*(np.concatenate(a) for a in zip(*parts)))
    assert pp.count == jp.count > 1000
    np.testing.assert_allclose(pp.pos, jp.pos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pp.normal, jp.normal, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pp.power, jp.power)
    np.testing.assert_array_equal(pp.dirn, jp.dirn)
    lo, hi = ps.root_lo.numpy() - 1e-3, ps.root_hi.numpy() + 1e-3
    assert (pp.pos >= lo).all() and (pp.pos <= hi).all()


def test_port_sampler_is_stratified():
    n = 4096
    gen = torch.Generator().manual_seed(5)
    d = pph._stratified_sphere(n, gen).numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-6)
    u = (1.0 - d[:, 2]) / 2.0  # one cos(theta) per stratum, in order
    i = np.arange(n)
    assert (u >= i / n - 1e-6).all() and (u <= (i + 1) / n + 1e-6).all()
    assert 0.4 < (d[:, 0] > 0).mean() < 0.6  # the azimuth is spread
    _, ps = _pair("box")
    a = pph.trace_photons(ps, n_per_light=512, seed=2)
    b = pph.trace_photons(ps, n_per_light=512, seed=2)
    c = pph.trace_photons(ps, n_per_light=512, seed=3)
    np.testing.assert_array_equal(a.pos, b.pos)
    assert a.count == 512 and not np.array_equal(a.dirn, c.dirn)
    np.testing.assert_array_equal(a.power, np.full((512, 3), 1 / 512,
                                                   np.float32))


def test_kdtree_and_gather(cornell):
    _, _, jpmap = cornell
    pmap = _to_port(jpmap)
    jkd, pkd = jph.build_photon_kdtree(jpmap), pph.build_photon_kdtree(pmap)
    for f in ("axis", "index", "left", "right"):
        a, b = getattr(jkd, f), getattr(pkd, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a, err_msg=f)
    rng = np.random.default_rng(0)
    pts = pmap.pos[rng.choice(pmap.count, 12, replace=False)]
    for p, r in zip(pts, np.linspace(0.2, 1.5, len(pts))):
        nrm = pmap.normal[0]
        got = pph.gather_photons_kd(pkd, pmap, p, nrm, r)
        np.testing.assert_allclose(
            got, jph.gather_photons_kd(jkd, jpmap, p, nrm, r), rtol=1e-6)
        # the brute force of tests/test_photons.py:46-59
        d = np.linalg.norm(pmap.pos - p, axis=1)
        m = d < r
        w = (1.0 - d[m] / r) * np.maximum(0.0, pmap.normal[m] @ nrm)
        acc = (pmap.power[m] * w[:, None]).sum(0) / (np.pi * r ** 2)
        np.testing.assert_allclose(got, acc, rtol=1e-4, atol=1e-6)


def test_grid_bit_equal_and_fetch(cornell):
    js, ps, jpmap = cornell
    lo, hi = ps.root_lo, ps.root_hi
    jg = jph.photon_grid(jpmap, lo.numpy(), hi.numpy(), res=16)
    pg = pph.photon_grid(_to_port(jpmap), lo, hi, res=16)
    assert pg.grid.device == lo.device and pg.res == jg.res == 16
    for f in ("grid", "lo", "inv_cell"):
        a, b = np.asarray(getattr(jg, f)), getattr(pg, f).numpy()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert pg.to("cpu").grid is not None
    rng = np.random.default_rng(1)
    # points over the box and beyond it (clamped corners)
    pts = rng.uniform(lo.numpy() - 1.0, hi.numpy() + 1.0, (500, 3))
    pts = np.concatenate([pts, jpmap.pos[:300]]).astype(np.float32)
    got = pph.gather_photons_grid(pg, torch.from_numpy(pts)).numpy()
    want = np.asarray(jph.gather_photons_grid(jg, jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert want.max() > 0
    # the grid tracks the kd oracle (tests/test_photons.py:62-83)
    kd = pph.build_photon_kdtree(_to_port(jpmap))
    sel = rng.choice(jpmap.count, 48, replace=False)
    kd_v = [pph.gather_photons_kd(kd, jpmap, jpmap.pos[i], jpmap.normal[i],
                                  0.3).sum() for i in sel]
    grid_v = pph.gather_photons_grid(
        pg, torch.from_numpy(jpmap.pos[sel])).sum(1).numpy()
    assert np.corrcoef(grid_v, kd_v)[0, 1] > 0.5


def _close(name, p, j, share=2e-3):
    p = p.detach().numpy() if isinstance(p, torch.Tensor) else p
    j = np.asarray(j)
    assert p.shape == j.shape, name
    err = np.abs(p - j).max(-1)
    assert (err > 2e-3).mean() <= share, (name, (err > 2e-3).mean(),
                                          err.max())
    return float(err.max())


def _grids(ps, jpmap, res=16):
    lo, hi = ps.root_lo, ps.root_hi
    return (jph.photon_grid(jpmap, lo.numpy(), hi.numpy(), res),
            pph.photon_grid(_to_port(jpmap), lo, hi, res))


def test_fast_frame_photon_term(cornell):
    """The packed frame: the photon term on the primary hits, against the
    JAX package's, on leaf, node and fat-leaf tables; its delta is diffuse
    x gathered irradiance x exposure (tests/test_photon_render.py:27-64,
    on the port's own quantities)."""
    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops import dispatch
    from snail_tpu_torch.render.integrator import shade_hits
    from snail_tpu_torch.render.raygen import primary_rays

    js, ps, jpmap = cornell
    jg, pg = _grids(ps, jpmap)
    jcam, pcam = JCamera.look_at(*CAM), Camera.look_at(*CAM, device="cpu")
    on, off = RenderOpts(**FWD, **ON), RenderOpts(**FWD)
    j = _eager(jfast.render_frame_fast)(js, jcam, 64, 64,
                                         JRenderOpts(**FWD, **ON),
                                         photon_grid=jg)
    p = render_frame_fast(ps, pcam, 64, 64, on, photon_grid=pg)
    _close("fast", p, j)
    for tables, other in (("nodes", _pair("cornell", walk=True)[1]),
                          ("fat", _pair("cornell_fat")[1])):
        assert pt.walks(other) and pt.is_fat(other) == (tables == "fat")
        _close(tables, render_frame(other, pcam, 64, 64, on, photon_grid=pg),
               j)
    delta = (p - render_frame_fast(ps, pcam, 64, 64, off)).numpy()
    assert delta.max() > 1e-3
    origin, dirs = primary_rays(pcam, 64, 64)
    d = dirs.reshape(-1, 3)
    o = origin.expand_as(d)
    dist, tri, bary = dispatch.closest_hit(
        ps, o, d, torch.full((d.shape[0],), BIG))
    s = shade_hits(ps, o, d, dist, tri, bary, off)
    # the packed frame's |d . n| and the integrator's agree to rounding
    gathered = pph.gather_photons_grid(pg, s["pos"])
    want = torch.where(s["hit"][:, None], s["diffuse"] * gathered * 0.5,
                       0.0).reshape(64, 64, 3).numpy()
    np.testing.assert_allclose(delta, want, rtol=1e-4, atol=1e-5)


def test_portable_frame_photon_term_with_bounces():
    """The portable integrator gathers on every wavefront: with a
    reflective, half transparent material 0 the bounces' hits add their
    photon term too, as in the JAX integrator."""
    js, ps = _pair("cornell", bounce=True)
    jpmap = jph.trace_photons(js, n_per_light=1024, seed=4)
    jg, pg = _grids(ps, jpmap)
    jcam, pcam = JCamera.look_at(*CAM), Camera.look_at(*CAM, device="cpu")
    opts = dict(textures=False, **ON)
    j = _eager(j_render_frame)(js, jcam, 48, 32, JRenderOpts(**opts),
                               photon_grid=jg)
    p = render_frame(ps, pcam, 48, 32, RenderOpts(**opts), photon_grid=pg)
    _close("portable", p, j)
    # the bounces' term: it differs from a frame whose bounces gather none
    off = render_frame(ps, pcam, 48, 32, RenderOpts(textures=False))
    assert float((p - off).abs().max()) > 1e-3


def test_photon_preview(cornell):
    js, ps, jpmap = cornell
    jg, pg = _grids(ps, jpmap)
    jcam, pcam = JCamera.look_at(*CAM), Camera.look_at(*CAM, device="cpu")
    for w, h in ((64, 64), (48, 40)):  # 32 x 32 tiles, then 1 x 1
        j = jph.render_photon_preview(js, jcam, w, h, jg, exposure=10.0)
        p = pph.render_photon_preview(ps, pcam, w, h, pg, exposure=10.0)
        _close(f"preview {w}x{h}", p, j)
        assert p.shape == (h, w, 3) and float(p.max()) > 0


def test_photons_without_a_grid_change_nothing():
    """photons=True with no grid renders the frame without photons in the
    packed, counter, differentiable and portable frames."""
    _, ps = _pair("cornell", bounce=True)
    cam = Camera.look_at(*CAM, device="cpu")
    for base in (FWD, dict(textures=False)):
        on, off = RenderOpts(photons=True, **base), RenderOpts(**base)
        assert torch.equal(render_frame_fast(ps, cam, 64, 64, on),
                           render_frame_fast(ps, cam, 64, 64, off))
        a, sa = render_frame_fast_stats(ps, cam, 64, 64, on)
        b, sb = render_frame_fast_stats(ps, cam, 64, 64, off)
        assert torch.equal(a, b) and sa == sb
        assert torch.equal(render_frame_fast_diff(ps, cam, 64, 64, on),
                           render_frame_fast_diff(ps, cam, 64, 64, off))
        assert torch.equal(render_frame(ps, cam, 48, 32, on),
                           render_frame(ps, cam, 48, 32, off))
