"""The port's portable path — ``render_frame`` on a frame that is not a
multiple of the 64-pixel tile, through ``render/integrator.py``, the
dispatch seam and ``diff/vjp.py`` — against the JAX package's
``render_frame``, which on the CPU takes its portable integrator and its
jnp oracle ``traverse_ref``; both kinds of port scene (worklist leaf
tables and walk node tables) on the JAX scene's arrays; gradients
against ``jax.grad``; and ``diff_closest_hit`` against finite
differences (``tests/test_diff.py:59``).

Scene: cornell at leaf 8, material 0 reflective and half transparent;
48 x 32 (16 x 16 tiles) and 30 x 20 (1 x 1 tiles). Each JAX frame runs
once per module."""

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
from snail_tpu.render.renderer import render_frame as j_render_frame
from snail_tpu.scene.materials import MaterialTable as JMaterialTable
from snail_tpu.scene.procedural import cornell_scene
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.bvh import build_bvh as p_build_bvh
from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.core.vecmath import BIG
from snail_tpu_torch.diff.vjp import diff_closest_hit
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.render.renderer import render_frame
from snail_tpu_torch.scene.base_scene import BaseScene, SceneObject
from snail_tpu_torch.scene.scene import (make_traced_scene,
                                         traced_scene_from_numpy)

POS, TARGET = (0.0, 2.0, 6.0), (0.0, 1.5, 0.0)
LIGHT = ((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0)
FIELDS = ("node_lo", "node_hi", "node_child", "node_count", "node_axis",
          "node_first", "tri_a", "tri_ba", "tri_ca", "sh_mat", "sh_pack",
          "mat_pack", "mat_diffuse", "mat_specular", "mat_reflect",
          "mat_dissolve")
FWD = dict(reflections=False, transparency=False, textures=False)
BOUNCE = dict(textures=False)
SIZES = [(48, 32), (30, 20)]


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, JAX camera, {table kind: port scene}, port camera)."""
    g = cornell_scene().flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=8)
    mats = JMaterialTable.build({"": 0}, [])
    mats.reflectivity[0] = 0.5
    mats.dissolve[0] = 0.5
    js = j_make_traced_scene(g, bvh, mats, lights=JLight.make(*LIGHT))
    fields = {k: np.asarray(getattr(js, k)) for k in FIELDS}
    fields.update(light_pos=np.asarray(js.lights.pos),
                  light_color=np.asarray(js.lights.color),
                  light_radius=np.asarray(js.lights.radius))
    ps = {kind: traced_scene_from_numpy(fields, device="cpu",
                                        walk=kind == "nodes")
          for kind in ("leaves", "nodes")}
    jcam = JCamera.look_at(pos=POS, target=TARGET)
    pcam = Camera(**{k: torch.from_numpy(np.array(getattr(jcam, k)))
                     for k in ("pos", "right", "up", "front", "plane_dist")})
    return js, jcam, ps, pcam


@pytest.fixture(scope="module")
def jax_frames(scenes):
    """The JAX package's portable frames, keyed by (size, options)."""
    js, jcam, _, _ = scenes
    return {(size, name): np.asarray(j_render_frame(
        js, jcam, *size, JRenderOpts(**opts)))
        for size in SIZES for name, opts in (("fwd", FWD),
                                             ("bounce", BOUNCE))}


@pytest.mark.parametrize("kind", ["leaves", "nodes"])
@pytest.mark.parametrize("opts", ["fwd", "bounce"])
@pytest.mark.parametrize("size", SIZES, ids=["48x32", "30x20"])
def test_portable_frame_matches_jax(scenes, jax_frames, size, opts, kind):
    _, _, ps, pcam = scenes
    jimg = jax_frames[size, opts]
    pt.reset_launch_counts()
    img = render_frame(ps[kind], pcam, *size,
                       RenderOpts(**(FWD if opts == "fwd" else BOUNCE)))
    assert img.shape == (size[1], size[0], 3) and img.dtype == torch.float32
    # images atol 2e-3 (tests/test_photon_render.py:130); a pixel beyond
    # it is a hit tie or a shadow at the 0.9999 epsilon, where the oracle
    # traces raw rows and the kernels' plain versions shared-origin rows
    err = np.abs(img.numpy() - jimg).max(-1)
    assert (err > 2e-3).mean() <= 1e-3, err.max()
    assert jimg.max() > 0.1
    # the CPU path runs the plain versions: no launch
    assert not any(pt.launch_counts().values())
    if opts == "bounce":
        flat = jax_frames[size, "fwd"]
        assert np.abs(flat - jimg).max() > 0.1  # the bounces count


@pytest.fixture(scope="module")
def jax_grads(scenes):
    """jax.grad of the mean 48 x 32 fwd image (with shadows) with respect
    to mat_diffuse and tri_a. (Its gradient with respect to the light
    position is NaN: the JAX integrator places a miss at dist = BIG and
    its light vector overflows, ROADMAP C12.)"""
    js, jcam, _, _ = scenes

    def loss(diffuse, tri_a):
        s = dataclasses.replace(js, mat_diffuse=diffuse, tri_a=tri_a)
        return jnp.mean(j_render_frame(s, jcam, 48, 32, JRenderOpts(**FWD)))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        js.mat_diffuse, js.tri_a)]


def _mean_image(scene, pcam, light_pos, diffuse, tri_a, **opts):
    s = dataclasses.replace(scene, mat_diffuse=diffuse, tri_a=tri_a,
                            lights=Light(pos=light_pos,
                                         color=scene.lights.color,
                                         radius=scene.lights.radius))
    return render_frame(s, pcam, 48, 32, RenderOpts(**FWD, **opts)).mean()


@pytest.mark.parametrize("kind", ["leaves", "nodes"])
def test_portable_grads_match_jax(scenes, jax_grads, kind):
    """Gradients of the mean image with respect to mat_diffuse and tri_a
    against jax.grad, and with respect to the light position against
    central differences (shadows off: visibility is piecewise constant,
    so the gradient holds it fixed and a difference would not)."""
    _, _, ps, pcam = scenes
    scene = ps[kind]
    lp, kd, ta = (t.clone().requires_grad_() for t in (
        scene.lights.pos, scene.mat_diffuse, scene.tri_a))
    grads = torch.autograd.grad(_mean_image(scene, pcam, lp, kd, ta),
                                [lp, kd, ta])
    for name, g in zip(("light pos", "mat_diffuse", "tri_a"), grads):
        # tests/test_diff.py:109-140: finite, and not zero
        assert bool(torch.isfinite(g).all()) and g.abs().sum() > 0, name
    for name, g, jg in zip(("mat_diffuse", "tri_a"), grads[1:], jax_grads):
        # within the tolerances of tests/test_fast_diff.py:84-91
        denom = np.abs(jg).max()
        diff = np.abs(g.numpy() - jg)
        assert np.quantile(diff, 0.999) / denom < 5e-3, name
        assert diff.mean() / denom < 1e-3, name

    lp = scene.lights.pos.clone().requires_grad_()
    (g,) = torch.autograd.grad(_mean_image(
        scene, pcam, lp, scene.mat_diffuse, scene.tri_a, shadows=False),
        [lp])
    eps = 1e-2
    fd = torch.zeros(3)
    for k in range(3):
        step = torch.zeros_like(lp)
        step[0, k] = eps
        with torch.no_grad():
            fd[k] = (_mean_image(scene, pcam, lp + step, scene.mat_diffuse,
                                 scene.tri_a, shadows=False)
                     - _mean_image(scene, pcam, lp - step, scene.mat_diffuse,
                                   scene.tri_a, shadows=False)) / (2 * eps)
    np.testing.assert_allclose(g[0].numpy(), fd.numpy(), rtol=2e-2,
                               atol=2e-4)


def _two_tri_geometry():
    """tests/test_diff.py:18's two triangles, at z = 0 and z = -2."""
    verts = np.array([[-1.0, -1.0, 0.0], [3.0, -1.0, 0.0], [-1.0, 3.0, 0.0],
                      [-4.0, -4.0, -2.0], [8.0, -4.0, -2.0],
                      [-4.0, 8.0, -2.0]], np.float32)
    base = BaseScene()
    base.objects.append(SceneObject(
        verts=verts, uvs=np.zeros((0, 2), np.float32),
        normals=np.zeros((0, 3), np.float32),
        tri_v=np.array([[0, 1, 2], [3, 4, 5]], np.int32),
        tri_vt=np.full((2, 3), -1, np.int32),
        tri_vn=np.full((2, 3), -1, np.int32), tri_mat=np.zeros(2, np.int32)))
    return base.flatten()


@pytest.mark.parametrize("walk", [False, True], ids=["leaves", "nodes"])
def test_diff_closest_hit_matches_finite_differences(walk):
    g = _two_tri_geometry()
    lo, hi = g.bounds()
    bvh = p_build_bvh(lo, hi, leaf_size=2)
    scene = make_traced_scene(g, bvh, lights=Light.make(
        (0.0, 0.5, 5.0), (1.0, 1.0, 1.0), 50.0, device="cpu"),
        device="cpu", walk=walk)
    orig = torch.tensor([[0.3, 0.2, 5.0], [0.1, -0.4, 5.0]])
    dirn = torch.tensor([[0.0, 0.0, -1.0], [0.05, 0.02, -1.0]])
    dirn = dirn / dirn.norm(dim=-1, keepdim=True)
    tmax = torch.full((2,), BIG)

    def loss(tri_a):
        dist, _, bary = diff_closest_hit(
            dataclasses.replace(scene, tri_a=tri_a), orig, dirn, tmax)
        return dist.sum() + bary.sum()

    a0 = scene.tri_a.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(a0), [a0])
    eps = 1e-3
    fd = torch.zeros_like(a0)
    with torch.no_grad():
        for i in range(a0.shape[0]):
            for k in range(3):
                ap, am = a0.clone(), a0.clone()
                ap[i, k] += eps
                am[i, k] -= eps
                fd[i, k] = (loss(ap) - loss(am)) / (2 * eps)
    np.testing.assert_allclose(g.numpy(), fd.numpy(), rtol=2e-2, atol=2e-3)
    assert g.abs().sum() > 0
