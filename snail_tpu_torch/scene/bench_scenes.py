"""The benchmark scenes of ``bench.py``, built with the port's procedural
copies and BVH builder, with their light and camera, the parameters of
``bench.py``'s gradient step, and an instanced grid of a bench scene;
and ``bench.py``'s 10 Mtri scene (``section_10m``)."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..bvh import build_bvh
from ..core.types import Camera, Light, RenderOpts
from .materials import MaterialTable
from .procedural import city_scene, terrain_scene
from .scene import make_traced_scene

# kind -> (generator, leaf size, light position, light radius, camera
# offset from the scene centre in units of its largest extent)
SCENES = {
    # the headline scene's self-contained fallback (bench.py:78-109)
    "city": (city_scene, 16, (0.0, 30.0, 0.0), 120.0, (0.45, 0.35, 0.9)),
    # the large-scene row (bench.py:151-174)
    "terrain": (terrain_scene, 32, (0.0, 60.0, 0.0), 200.0,
                (0.35, 0.25, 0.4)),
    # the 10 Mtri row (bench.py:350-398), at leaf 32: the JAX row's leaf
    # 127 with SNAIL_IVAL_LEAF=128 is a TPU tunable, and the port's leaf
    # tables take leaves of at most 32 triangles (ops/traverse.py
    # IVAL_LEAF); its light has radius 400 (bench.py:367)
    "terrain_10m": (terrain_scene, 32, (0.0, 60.0, 0.0), 400.0,
                    (0.35, 0.25, 0.4)),
}

# kind -> the size bench.py renders it at (terrain 724: ~1.05 Mtri;
# terrain_10m 2236: 9,999,392 triangles, 2 n^2)
BENCH_N = {"city": 24, "terrain": 724, "terrain_10m": 2236}

# the parameters bench.py's fwd+bwd step differentiates (bench.py:223-231)
GRAD_PARAMS = ("tri_a", "tri_ba", "tri_ca", "mat_diffuse", "light_pos",
               "light_color", "cam_pos")
# its render options (bench.py:218)
STEP_OPTS = RenderOpts(reflections=True, transparency=False, textures=False,
                       shadows=True)


def bounce_materials() -> MaterialTable:
    """The default table with material 0 at reflectivity 0.5 and dissolve
    0.5, so every hit casts a reflection and a transparency ray. The bench
    scenes carry no such material of their own (every material defaults to
    reflectivity 0 and dissolve 1), which leaves bounces compiled out."""
    mats = MaterialTable.build({"": 0})
    mats.reflectivity[0] = 0.5
    mats.dissolve[0] = 0.5
    return mats


def host_build(kind: str, n: int, leaf: Optional[int] = None):
    """The host half of a bench scene: ``kind``'s geometry at size ``n``
    and its BVH at the kind's leaf size (or ``leaf``). Returns (geometry,
    bvh, seconds), seconds {"gen_s", "build_s"} as bench.py's
    ``section_10m`` records them (bench.py:358-366)."""
    make, kind_leaf = SCENES[kind][:2]
    t0 = time.perf_counter()
    g = make(n).flatten()
    t1 = time.perf_counter()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=kind_leaf if leaf is None else leaf)
    return g, bvh, {"gen_s": t1 - t0, "build_s": time.perf_counter() - t1}


def bench_scene(kind: str, n: int, device="cuda", bounce: bool = False,
                walk: bool = False, leaf: Optional[int] = None,
                textured: Optional[str] = None):
    """(scene, camera, geometry, bvh) of ``kind`` at size ``n`` on
    ``device`` (the card unless the caller asks for the CPU); with
    ``bounce``, material 0 is :func:`bounce_materials`'; with ``walk``,
    the scene carries node tables for the walk kernels in place of leaf
    tables; ``leaf``, the BVH's leaf size in place of the kind's (33-64:
    a fat-leaf scene, node tables for the fat-leaf kernels); ``textured``
    (None, "point", "bilinear" or "sat"), bench.py's ``section_tex``
    scene (bench.py:130-148): ``textures.checker_atlas`` on every
    material, with its summed-area tables for "sat" (the filter itself
    is ``RenderOpts.tex_filter``)."""
    g, bvh, _ = host_build(kind, n, leaf)
    scene, cam = traced_bench_scene(kind, g, bvh, device, bounce, walk)
    if textured is not None:
        from .scene import with_sat
        from .textures import checker_atlas

        scene = checker_atlas(scene)
        if textured == "sat":
            scene = with_sat(scene)
    return scene, cam, g, bvh


def traced_bench_scene(kind: str, g, bvh, device="cuda",
                       bounce: bool = False, walk: bool = False):
    """The device half of a bench scene: (scene, camera) of ``kind`` from
    its host-built geometry ``g`` and ``bvh`` (:func:`host_build`), with
    the kind's light, and its camera at the kind's offset from the root
    box's centre, in units of its largest extent, looking at the centre
    (bench.py:375-383); ``bounce`` and ``walk`` as :func:`bench_scene`."""
    _, _, light, radius, offset = SCENES[kind]
    scene = make_traced_scene(
        g, bvh, bounce_materials() if bounce else None,
        lights=Light.make(light, (1.0, 1.0, 1.0), radius, device=device),
        device=device, walk=walk)
    c = (bvh.node_lo[0] + bvh.node_hi[0]) * 0.5
    ext = float(np.max(bvh.node_hi[0] - bvh.node_lo[0]))
    cam = Camera.look_at(pos=tuple(c + np.array(offset) * ext),
                         target=tuple(c), device=device)
    return scene, cam


# the options of bench.py's 10 Mtri row (bench.py:384-385): reflections,
# transparency and textures off
OPTS_10M = RenderOpts(reflections=False, transparency=False, textures=False)


def scene_10m(n: int = BENCH_N["terrain_10m"], device="cuda",
              walk: bool = False):
    """bench.py's ``section_10m`` scene as the port runs it:
    terrain_scene(n) (n = 2236: 9,999,392 triangles) at leaf 32, light (0,
    60, 0) of colour 1 and power 400, the camera at centre + (0.35, 0.25,
    0.4) x extent looking at the centre; render it with
    :data:`OPTS_10M`. Leaf tables (B1-B4), or with ``walk`` node tables
    (B9a/B9b, which cover the paged B10a/B10b); a tree of more leaves than
    leaf tables hold gets node tables either way
    (``scene.make_traced_scene``). Returns (scene, camera,
    geometry, bvh, seconds), seconds {"gen_s", "build_s", "pack_s"} as
    bench.py records them (bench.py:390-392)."""
    g, bvh, secs = host_build("terrain_10m", n)
    t0 = time.perf_counter()
    scene, cam = traced_bench_scene("terrain_10m", g, bvh, device,
                                    walk=walk)
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
    return scene, cam, g, bvh, {**secs, "pack_s": time.perf_counter() - t0}


def instanced_grid(kind: str, base, grid: int = 4):
    """``grid`` x ``grid`` rigid instances of ``base``, a
    :func:`bench_scene` of ``kind``, on its device: spaced 1.1x its
    root-box x/z extent, instance i turned by ``rotation_y(0.4 i)`` about
    its centre. The light is the bench light at grid/2 times its height
    and grid times its radius, so that it reaches the corners; the camera,
    at bench.py's offset from the grid's centre in units of 0.9 of the
    grid's extent, sees every instance, and the nearer instances hide
    parts of those behind them. Returns (iscene, camera)."""
    from .instancing import make_instances, rotation_y

    _, _, light, radius, offset = SCENES[kind]
    dev = base.device
    base = dataclasses.replace(base, lights=Light.make(
        tuple(np.array(light) * (grid / 2)), (1.0, 1.0, 1.0), radius * grid,
        device=dev))
    lo, hi = base.root_lo.cpu().numpy(), base.root_hi.cpu().numpy()
    c = (lo + hi) * 0.5
    ij = np.stack(np.meshgrid(np.arange(grid), np.arange(grid),
                              indexing="ij"), -1).reshape(-1, 2)
    pos = np.zeros((grid * grid, 3), np.float32)
    pos[:, [0, 2]] = (ij - (grid - 1) / 2) * 1.1 * (hi - lo)[[0, 2]]
    rot = rotation_y(torch.arange(grid * grid, dtype=torch.float32) * 0.4)
    # about the base's centre: world = R (p - c) + c + pos
    trans = torch.from_numpy(pos + c) - rot @ torch.from_numpy(c)
    ext = float(np.max(hi - lo)) * grid * 1.1 * 0.9
    cam = Camera.look_at(pos=tuple(c + np.array(offset) * ext),
                         target=tuple(c), device=dev)
    return make_instances(base, rot, trans), cam


def grad_params(scene, camera) -> dict:
    """Fresh leaf tensors of :data:`GRAD_PARAMS`, from the scene's light 0
    table and the camera, requiring grad."""
    src = {name: getattr(scene, name) for name in GRAD_PARAMS[:4]}
    src.update(light_pos=scene.lights.pos, light_color=scene.lights.color,
               cam_pos=camera.pos)
    return {k: src[k].detach().clone().requires_grad_() for k in GRAD_PARAMS}


def with_params(scene, camera, params: dict):
    """(scene, camera) with ``params`` in place, as bench.py's step builds
    them (bench.py:237-245)."""
    lights = Light(pos=params["light_pos"], color=params["light_color"],
                   radius=scene.lights.radius)
    s = dataclasses.replace(scene, tri_a=params["tri_a"],
                            tri_ba=params["tri_ba"], tri_ca=params["tri_ca"],
                            mat_diffuse=params["mat_diffuse"], lights=lights)
    return s, dataclasses.replace(camera, pos=params["cam_pos"])


def bench_step(scene, camera, target, width: int, height: int):
    """bench.py's fwd+bwd step (bench.py:236-247): the MSE of
    ``render_frame_fast_diff`` under :data:`STEP_OPTS` against ``target``,
    and its gradients with respect to fresh copies of the
    :data:`GRAD_PARAMS`. Returns (loss, {name: gradient})."""
    from ..diff import render_loss_and_grads
    from ..render.fast import render_frame_fast_diff

    return render_loss_and_grads(
        lambda p: render_frame_fast_diff(*with_params(scene, camera, p),
                                         width, height, STEP_OPTS),
        grad_params(scene, camera), lambda img: ((img - target) ** 2).mean())
