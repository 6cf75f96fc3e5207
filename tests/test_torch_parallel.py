"""The port's multi-device layer (``snail_tpu_torch.parallel``) on the CPU.

Two processes join a gloo process group through a ``file://`` store in
``tmp_path`` (no TCP port for the test workers to race for), each on one
thread: rank 1 receives the scene from rank 0 (``replicate_scene``), both
render a 32 x 32 cornell frame with the rays split between them
(``render_frame_multihost``) and take one ``train_step_sharded``; each
gets the one-process frame bit for bit and the one-process step (rtol
1e-4, atol 1e-7, as tests/test_distributed.py asks of the JAX package),
and ``scaling_report`` rows of the JAX package's shape. At world size 1
the step matches JAX ``train_step_sharded`` on ``make_mesh(1)`` within
tests/test_torch_integrator.py's gradient tolerance."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snail_tpu.bvh import build_bvh as j_build_bvh
from snail_tpu.core.types import Camera as JCamera
from snail_tpu.core.types import Light as JLight
from snail_tpu.core.types import RenderOpts as JRenderOpts
from snail_tpu.parallel import mesh as jmesh
from snail_tpu.scene.procedural import cornell_scene as j_cornell
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.bvh import build_bvh
from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.parallel import distributed as pdist
from snail_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                           render_frame_sharded, shard_rays,
                                           train_step_sharded)
from snail_tpu_torch.render.renderer import render_frame_portable
from snail_tpu_torch.scene.procedural import cornell_scene
from snail_tpu_torch.scene.scene import make_traced_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 32
TIMEOUT = 300  # seconds a rank may take

_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as tdist

from snail_tpu_torch.parallel import distributed as pdist
from snail_tpu_torch.parallel.mesh import train_step_sharded

assert pdist.initialize(device="cpu")  # SNAIL_COORD / _NPROCS / _PROC_ID
assert pdist.process_count() == 2 and tdist.get_backend() == "gloo"
rank = pdist.process_index()
from snail_tpu_torch.bvh import build_bvh
from snail_tpu_torch.core.types import Camera, Light, RenderOpts
from snail_tpu_torch.scene.procedural import cornell_scene
from snail_tpu_torch.scene.scene import make_traced_scene
W = H = 32
OPTS = RenderOpts(textures=False, reflections=False, transparency=False)
cam = Camera.look_at(pos=(0.0, 2.0, 6.0), target=(0.0, 1.5, 0.0),
                     device="cpu")
scene = None
if rank == 0:  # the other rank receives it
    g = cornell_scene().flatten()
    lo, hi = g.bounds()
    scene = make_traced_scene(
        g, build_bvh(lo, hi, leaf_size=8), device="cpu",
        lights=Light.make((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0,
                          device="cpu"))
mesh = pdist.global_mesh()
assert (mesh.size, mesh.rank) == (2, rank)
scene = pdist.replicate_scene(scene, mesh)
img = pdist.render_frame_multihost(scene, cam, W, H, OPTS, mesh)
params = {"tri_a": scene.tri_a, "mat_diffuse": scene.mat_diffuse}
loss, new = train_step_sharded(scene, params, torch.zeros(H, W, 3), cam, W,
                               H, OPTS, mesh)
rows = pdist.scaling_report(scene, cam, W, H, OPTS, [1, 2, 4], frames=1)
out = sys.argv[1]
np.savez(os.path.join(out, f"rank{rank}.npz"), img=img, loss=loss.numpy(),
         tri_rows=scene.tri_rows.numpy(), box=scene.leaves.box.numpy(),
         **{k: v.numpy() for k, v in new.items()})
with open(os.path.join(out, f"rows{rank}.json"), "w") as f:
    json.dump(rows, f)
tdist.destroy_process_group()
"""

OPTS = RenderOpts(textures=False, reflections=False, transparency=False)


def scene_and_camera():
    """tests/test_distributed.py's cornell scene and camera on the CPU."""
    g = cornell_scene().flatten()
    lo, hi = g.bounds()
    light = Light.make((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0, device="cpu")
    scene = make_traced_scene(g, build_bvh(lo, hi, leaf_size=8),
                              lights=light, device="cpu")
    cam = Camera.look_at(pos=(0.0, 2.0, 6.0), target=(0.0, 1.5, 0.0),
                         device="cpu")
    return scene, cam


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two gloo ranks' results: ([rank0, rank1] arrays, rows)."""
    out = tmp_path_factory.mktemp("ranks")
    procs = []
    for rank in range(2):
        env = dict(os.environ, SNAIL_COORD=f"file://{out}/store",
                   SNAIL_NPROCS="2", SNAIL_PROC_ID=str(rank),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(out)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{err}"
    finally:
        for p in procs:
            p.kill()
            p.wait(TIMEOUT)
    return ([dict(np.load(out / f"rank{r}.npz")) for r in range(2)],
            [json.loads((out / f"rows{r}.json").read_text())
             for r in range(2)])


def test_multihost_frame_equals_one_process(two_ranks):
    """Both ranks hold the whole frame, the one-process portable frame
    bit for bit, and rank 1 the scene rank 0 broadcast."""
    ranks, _ = two_ranks
    scene, cam = scene_and_camera()
    ref = render_frame_portable(scene, cam, W, H, OPTS).numpy()
    assert ref.max() > 0.1
    for r in ranks:
        assert r["img"].shape == (H, W, 3)
        np.testing.assert_array_equal(r["img"], ref)
        np.testing.assert_array_equal(r["tri_rows"], scene.tri_rows.numpy())
        np.testing.assert_array_equal(r["box"], scene.leaves.box.numpy())


def test_train_step_two_ranks_equals_one(two_ranks):
    ranks, _ = two_ranks
    scene, cam = scene_and_camera()
    params = {"tri_a": scene.tri_a, "mat_diffuse": scene.mat_diffuse}
    loss, new = train_step_sharded(scene, params, torch.zeros(H, W, 3), cam,
                                   W, H, OPTS, make_mesh())
    for r in ranks:
        assert abs(float(r["loss"]) - float(loss)) < 1e-5 * max(
            1.0, abs(float(loss)))
        for k, v in new.items():
            np.testing.assert_allclose(r[k], v.numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
            assert not np.array_equal(r[k], params[k].numpy()), k
    np.testing.assert_array_equal(ranks[0]["tri_a"], ranks[1]["tri_a"])


def test_scaling_report_rows(two_ranks):
    """The JAX package's row shape; counts above the world size skipped;
    every rank gets rank 0's rows."""
    _, rows = two_ranks
    assert rows[0] == rows[1]
    assert [r["devices"] for r in rows[0]] == [1, 2]
    assert rows[0][0]["efficiency"] == 1.0
    for r in rows[0]:
        assert set(r) == {"devices", "ms", "mrays", "efficiency"}
        assert r["mrays"] > 0 and r["ms"] > 0
    scene, cam = scene_and_camera()
    one = pdist.scaling_report(scene, cam, W, H, OPTS, [1, 2], frames=1)
    assert [r["devices"] for r in one] == [1] and one[0]["efficiency"] == 1.0


def test_initialize_does_nothing_without_env(monkeypatch):
    for k in ("SNAIL_COORD", "SNAIL_NPROCS", "SNAIL_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.initialize(device="cpu") is False
    assert not pdist.is_initialized()
    assert (pdist.process_count(), pdist.process_index()) == (1, 0)
    monkeypatch.setenv("SNAIL_NPROCS", "1")
    assert pdist.initialize(device="cpu") is False
    mesh = pdist.global_mesh()
    assert mesh == Mesh(None, 1, 0)
    with pytest.raises(ValueError):
        make_mesh(2)
    scene, _ = scene_and_camera()
    assert pdist.replicate_scene(scene, mesh) is scene


def test_rays_that_do_not_divide_raise():
    """As shard_map refuses, a wavefront that does not divide over the
    mesh raises (a mesh of 3 ranks, seen from rank 0)."""
    scene, cam = scene_and_camera()
    x = torch.zeros(W * H, 3)
    (a,) = shard_rays(Mesh(None, 4, 1), x)
    assert a.shape == (W * H // 4, 3)
    with pytest.raises(ValueError, match="do not divide"):
        shard_rays(Mesh(None, 3, 0), x)
    with pytest.raises(ValueError, match="do not divide"):
        render_frame_sharded(scene, cam, W, H, OPTS, Mesh(None, 3, 0))
    with pytest.raises(ValueError, match="not a member"):
        shard_rays(Mesh(None, 2, None), x)


def test_train_step_world_one_matches_jax():
    """World size 1: the port's step against JAX ``train_step_sharded`` on
    ``make_mesh(1)`` (lr 1, so each parameter moves by its gradient):
    the loss to 1e-3, the gradients within tests/test_torch_integrator.py's
    tolerance."""
    g = j_cornell().flatten()
    lo, hi = g.bounds()
    js = j_make_traced_scene(
        g, j_build_bvh(lo, hi, leaf_size=8),
        lights=JLight.make((0.0, 3.5, 0.0), (1.0, 0.9, 0.8), 30.0),
        backend="reference")
    jcam = JCamera.look_at(pos=(0.0, 2.0, 6.0), target=(0.0, 1.5, 0.0))
    jopts = JRenderOpts(textures=False, reflections=False,
                        transparency=False)
    jparams = {"tri_a": js.tri_a, "mat_diffuse": js.mat_diffuse}
    mesh = jmesh.make_mesh(1)
    jloss, jnew = jax.jit(lambda s, p, t: jmesh.train_step_sharded(
        s, p, t, jcam, W, H, jopts, mesh, lr=1.0))(
        js, jparams, jnp.zeros((H, W, 3), jnp.float32))

    scene, cam = scene_and_camera()
    params = {"tri_a": scene.tri_a, "mat_diffuse": scene.mat_diffuse}
    loss, new = train_step_sharded(scene, params, torch.zeros(H, W, 3), cam,
                                   W, H, OPTS, make_mesh(), lr=1.0)
    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    for k in params:
        np.testing.assert_array_equal(params[k].numpy(),
                                      np.asarray(jparams[k]))
        grad = params[k].numpy() - new[k].numpy()
        jgrad = np.asarray(jparams[k]) - np.asarray(jnew[k])
        denom = np.abs(jgrad).max()
        diff = np.abs(grad - jgrad)
        assert denom > 0, k
        assert np.quantile(diff, 0.999) / denom < 5e-3, k
        assert diff.mean() / denom < 1e-3, k
