"""The port's differentiable frame (render_frame_fast_diff) against its own
forward frame and the JAX package's gradients (Pallas in interpret mode on
the CPU), finite differences, and a float64 gradcheck of the material
lookup's backward.

Scene: cornell at leaf 8 with material 0 reflective and half transparent,
the JAX scene's arrays carried into the port by traced_scene_from_numpy;
64 x 64; bench.py's fwd+bwd step (7 parameters, reflections and shadows,
MSE) against a target lit from a moved light, so the gradients are not
zero."""

import dataclasses

import numpy as np
import pytest
import torch

from snail_tpu.bvh import build_bvh
from snail_tpu.core.types import Camera as JCamera
from snail_tpu.core.types import Light as JLight
from snail_tpu.core.types import RenderOpts as JRenderOpts
from snail_tpu.render.fast import render_frame_fast as j_render_frame_fast
from snail_tpu.render.fast import \
    render_frame_fast_diff as j_render_frame_fast_diff
from snail_tpu.scene.materials import MaterialTable as JMaterialTable
from snail_tpu.scene.procedural import cornell_scene
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.core.types import Camera, RenderOpts
from snail_tpu_torch.render.fast import (_SmallLookup, render_frame_fast,
                                         render_frame_fast_diff)
from snail_tpu_torch.scene.bench_scenes import (GRAD_PARAMS, STEP_OPTS,
                                                bench_step, grad_params,
                                                with_params)
from snail_tpu_torch.scene.scene import traced_scene_from_numpy

W = H = 64
POS, TARGET = (0.0, 2.0, 6.0), (0.0, 1.5, 0.0)
LIGHT = ((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0)
MOVED = (0.6, 3.2, 0.4)  # the target's light position


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, JAX camera, port scene, port camera, target image)."""
    g = cornell_scene().flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=8)
    mats = JMaterialTable.build({"": 0}, [])
    mats.reflectivity[0] = 0.5
    mats.dissolve[0] = 0.5
    js = j_make_traced_scene(g, bvh, mats, lights=JLight.make(*LIGHT))
    fields = {k: np.asarray(getattr(js, k)) for k in (
        "node_lo", "node_hi", "node_child", "node_count", "tri_a", "tri_ba",
        "tri_ca", "sh_mat", "sh_pack", "mat_pack", "mat_diffuse",
        "mat_specular", "mat_reflect", "mat_dissolve")}
    fields.update(light_pos=np.asarray(js.lights.pos),
                  light_color=np.asarray(js.lights.color),
                  light_radius=np.asarray(js.lights.radius))
    ps = traced_scene_from_numpy(fields, device="cpu")
    jcam = JCamera.look_at(pos=POS, target=TARGET)
    pcam = Camera.look_at(pos=POS, target=TARGET, device="cpu")
    moved = dataclasses.replace(js, lights=JLight.make(MOVED, *LIGHT[1:]))
    target = np.array(j_render_frame_fast(moved, jcam, W, H, _jax_opts()))
    return js, jcam, ps, pcam, target


def _jax_opts():
    return JRenderOpts(**dataclasses.asdict(STEP_OPTS))


def _port_loss(ps, pcam, target, params):
    s, c = with_params(ps, pcam, params)
    img = render_frame_fast_diff(s, c, W, H, STEP_OPTS)
    return ((img - torch.from_numpy(target)) ** 2).mean()


@pytest.mark.parametrize("opts", [
    dict(reflections=False, transparency=False, textures=False),
    dict(reflections=True, transparency=False, textures=False),
    dict(textures=False),
], ids=["flat", "reflections", "bounces"])
def test_diff_forward_matches_fast(scenes, opts):
    _, _, ps, pcam, _ = scenes
    a = render_frame_fast(ps, pcam, W, H, RenderOpts(**opts))
    b = render_frame_fast_diff(ps, pcam, W, H, RenderOpts(**opts)).detach()
    # atol of tests/test_fast_diff.py:49
    assert torch.allclose(a, b, atol=2e-5), float((a - b).abs().max())
    assert float(a.max()) > 0.1


@pytest.fixture(scope="module")
def grads(scenes):
    """Loss and gradients of bench.py's step in both packages."""
    import jax
    import jax.numpy as jnp

    js, jcam, ps, pcam, target = scenes
    jopts = _jax_opts()

    def step(params):  # bench.py:236-247
        lights = JLight(pos=params["light_pos"], color=params["light_color"],
                        radius=js.lights.radius)
        s = dataclasses.replace(js, tri_a=params["tri_a"],
                                tri_ba=params["tri_ba"],
                                tri_ca=params["tri_ca"],
                                mat_diffuse=params["mat_diffuse"],
                                lights=lights)
        c = dataclasses.replace(jcam, pos=params["cam_pos"])
        color = j_render_frame_fast_diff(s, c, W, H, jopts)
        return jnp.mean((color - target) ** 2)

    jparams = {"tri_a": js.tri_a, "tri_ba": js.tri_ba, "tri_ca": js.tri_ca,
               "mat_diffuse": js.mat_diffuse, "light_pos": js.lights.pos,
               "light_color": js.lights.color, "cam_pos": jcam.pos}
    jl, jg = jax.value_and_grad(step)(jparams)
    pl, pg = bench_step(ps, pcam, torch.from_numpy(target), W, H)
    return (float(jl), {k: np.asarray(v) for k, v in jg.items()},
            float(pl), {k: v.numpy() for k, v in pg.items()})


def test_loss_matches_jax(grads):
    jl, _, pl, _ = grads
    # tests/test_fast_diff.py:83
    assert np.isfinite(pl) and pl > 1e-3
    assert abs(pl - jl) < 3e-4 * max(1.0, abs(jl))


@pytest.mark.parametrize("name", GRAD_PARAMS)
def test_grads_match_jax(grads, name):
    _, jg, _, pg = grads
    a, b = pg[name], jg[name]
    assert a.shape == b.shape and np.isfinite(a).all()
    # tests/test_fast_diff.py:84-91: the bulk of the gradient mass; hits
    # may differ at a handful of tie or edge pixels
    denom = max(np.abs(b).max(), 1e-8)
    assert np.abs(b).max() > 0
    assert np.quantile(np.abs(a - b), 0.999) < 5e-3 * denom, name
    assert np.abs(a - b).mean() < 1e-3 * denom, name


@pytest.mark.parametrize("name", ["mat_diffuse", "light_color"])
def test_grads_match_finite_differences(scenes, name):
    """Central differences of the loss in each colour channel (the image
    is polynomial in both, of low degree, so a step of 1e-2 is exact to
    well within the tolerance)."""
    _, _, ps, pcam, target = scenes
    params = grad_params(ps, pcam)
    _port_loss(ps, pcam, target, params).backward()
    grad = params[name].grad[0]
    eps = 1e-2
    for c in range(3):
        with torch.no_grad():
            lo, hi = (grad_params(ps, pcam) for _ in range(2))
            lo[name][0, c] -= eps
            hi[name][0, c] += eps
            fd = (_port_loss(ps, pcam, target, hi)
                  - _port_loss(ps, pcam, target, lo)) / (2 * eps)
        assert abs(float(grad[c]) - float(fd)) <= 1e-2 * abs(float(fd)), (
            name, c, float(grad[c]), float(fd))


def test_small_lookup_gradcheck():
    rng = np.random.default_rng(2)
    tbl = torch.from_numpy(rng.normal(size=(3, 4))).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 3, 50))
    assert torch.autograd.gradcheck(_SmallLookup.apply, (tbl, idx))
    out = _SmallLookup.apply(tbl, idx)
    assert out.shape == (4, 50) and torch.equal(out, tbl[idx].T)
