"""The JAX package's public names that the port lacked until it had them,
each against the JAX package: ``diff.render_loss_and_grads``,
``render.raygen.camera_rays_wavefront``, ``core.vecmath``'s vector
functions and ``core.types.Rays``, and the packages' re-exports of what
the JAX ``__all__`` lists."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import snail_tpu.core as jcore
import snail_tpu.diff as jdiff
import snail_tpu.ops as jops
import snail_tpu.render as jrender
from snail_tpu.core import vecmath as jvec
from snail_tpu.core.types import Camera as JCamera
from snail_tpu.ops.intersect import intersect_dist_bary as j_dist_bary
from snail_tpu.render.raygen import (camera_rays_wavefront as
                                     j_camera_rays_wavefront)

import snail_tpu_torch.core as pcore
import snail_tpu_torch.diff as pdiff
import snail_tpu_torch.ops as pops
import snail_tpu_torch.render as prender
from snail_tpu_torch.core import vecmath as pvec
from snail_tpu_torch.core.types import Camera
from snail_tpu_torch.ops.intersect import intersect_dist_bary


def _vecs(seed, n=64):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["dot", "cross", "length", "normalize",
                                  "safe_inv", "reflect", "refract"])
def test_vecmath_matches_jax(name):
    """Each vector function on seeded vectors (unit ones for reflect and
    refract, at indices that give both a refracted ray and total internal
    reflection) against the JAX package's: to 1e-6 (the JAX CPU rsqrt of
    ``normalize`` is not correctly rounded; the port's
    ``torch.rsqrt``)."""
    a, b = _vecs(1), _vecs(2)
    a[0] = (1e-12, 0.0, -1.0)  # an axis-aligned ray for safe_inv
    args = {"dot": (a, b), "cross": (a, b), "length": (3.0 * a,),
            "normalize": (3.0 * a,), "safe_inv": (a,),
            "reflect": (a, b), "refract": (a, b, 1.5)}[name]
    jout = getattr(jvec, name)(*(jnp.asarray(x) if isinstance(x, np.ndarray)
                                 else x for x in args))
    pout = getattr(pvec, name)(*(torch.from_numpy(x) if isinstance(
        x, np.ndarray) else x for x in args))
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)
    if name == "refract":
        # both branches ran: some rays reflect totally
        cos_i = -(a * b).sum(-1)
        tir = 1.5 ** 2 * (1.0 - cos_i ** 2) > 1.0
        assert tir.any() and (~tir).any()


def test_camera_rays_wavefront_matches_jax():
    """The tiled primary wavefront of a 64 x 32 frame with a jitter: the
    origin broadcast, directions to 1e-6, tmax BIG, ``Rays``' idir the JAX
    ``safe_inv`` of the JAX directions, and its active mask and count as
    the JAX ``Rays``'."""
    pos, target = (3.0, 2.5, 4.0), (0.0, 0.5, 0.0)
    jr = j_camera_rays_wavefront(JCamera.look_at(pos=pos, target=target),
                                 64, 32, (0.25, -0.25))
    pr = prender.camera_rays_wavefront(
        Camera.look_at(pos=pos, target=target, device="cpu"), 64, 32,
        (0.25, -0.25))
    assert tuple(pr.dir.shape) == tuple(jr.dir.shape) == (64 * 32, 3)
    np.testing.assert_array_equal(pr.origin.numpy(), np.asarray(jr.origin))
    np.testing.assert_allclose(pr.dir.numpy(), np.asarray(jr.dir), atol=1e-6)
    np.testing.assert_array_equal(pr.tmax.numpy(), np.asarray(jr.tmax))
    np.testing.assert_allclose(pr.idir.numpy(),
                               np.asarray(jvec.safe_inv(jr.dir)), rtol=1e-5)
    assert bool(pr.active.all()) and pr.count() == jr.count() == 64 * 32


def test_render_loss_and_grads_matches_jax():
    """The value and gradients of a loss of a differentiable render
    function (the hit distances of seeded rays against given triangles,
    through ``ops.intersect.intersect_dist_bary``), with respect to a dict
    of the triangle arrays and the ray origins, against the JAX
    package's ``jax.value_and_grad``: to 1e-5. A parameter the loss does
    not read gets zeros in both; the port's parameters stay unchanged."""
    rng = np.random.default_rng(5)
    n = 32
    a = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    a[:, 2] = 2.0
    ba = np.tile(np.float32([0.5, 0.0, 0.1]), (n, 1))
    ca = np.tile(np.float32([0.0, 0.5, 0.1]), (n, 1))
    orig = (a + np.float32([0.1, 0.1, -3.0])).astype(np.float32)
    dirn = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    tri = np.arange(n, dtype=np.int32)
    params = {"tri_a": a, "tri_ba": ba, "tri_ca": ca, "orig": orig,
              "unused": np.ones(4, np.float32)}

    def loss(dist):
        return (dist ** 2).mean()

    jval, jgrad = jdiff.render_loss_and_grads(
        lambda p: j_dist_bary(p["orig"], jnp.asarray(dirn), p["tri_a"],
                              p["tri_ba"], p["tri_ca"], jnp.asarray(tri))[0],
        {k: jnp.asarray(v) for k, v in params.items()}, loss)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pval, pgrad = pdiff.render_loss_and_grads(
        lambda p: intersect_dist_bary(p["orig"], torch.from_numpy(dirn),
                                      p["tri_a"], p["tri_ba"], p["tri_ca"],
                                      torch.from_numpy(tri))[0],
        tp, loss)
    np.testing.assert_allclose(float(pval), float(jval), rtol=1e-6)
    assert set(pgrad) == set(jgrad)
    for k in params:
        np.testing.assert_allclose(pgrad[k].numpy(), np.asarray(jgrad[k]),
                                   rtol=1e-5, atol=1e-7)
    assert not bool(pgrad["unused"].any())
    assert all(not t.requires_grad and np.array_equal(t.numpy(), params[k])
               for k, t in tp.items())
    # a list of parameters keeps its structure
    val, grads = pdiff.render_loss_and_grads(
        lambda p: (p[0] * p[1][0]).sum(), [torch.ones(3), (torch.ones(3),)],
        lambda x: x)
    assert float(val) == 3.0 and isinstance(grads, list)
    assert isinstance(grads[1], tuple) and torch.equal(grads[1][0],
                                                       torch.ones(3))


def test_packages_export_the_jax_names():
    """Every name of the JAX ``render``, ``ops``, ``core`` and ``diff``
    ``__all__`` that the port has is exported by the port's package of
    the same name, and is that package's attribute. The port does not
    have three: the JAX package's jnp reference walks, whose port
    counterparts are the plain walks of ``ops.traverse_ref``, and its
    ``Hit`` record (the port's entry points return tensors)."""
    absent = {"traverse_bvh_ref", "traverse_bvh_shadow_ref", "Hit"}
    for jpkg, ppkg in ((jrender, prender), (jops, pops), (jcore, pcore),
                       (jdiff, pdiff)):
        want = set(jpkg.__all__) - absent
        assert want <= set(ppkg.__all__), want - set(ppkg.__all__)
        assert all(hasattr(ppkg, name) for name in ppkg.__all__)
