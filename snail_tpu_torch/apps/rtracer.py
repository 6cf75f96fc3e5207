"""Standalone renderer CLI (``snail_tpu.apps.rtracer``), the rebuild of
the reference's ``rtracer`` binary (rtracer.cpp:456-599) minus the GL
window: loads a scene (OBJ + MTL), builds or loads the cached BVH (the
dump/ pattern, rtracer.cpp:505-513), renders N frames on an orbit on the
card (or ``--device cpu``) and writes PNGs + stats. Keyboard toggles
become CLI flags (gVals semantics, SURVEY.md §5).

Run: ``python -m snail_tpu_torch.apps.rtracer scene.obj -r 512x512``
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..core.types import Camera, Light, RenderOpts
from ..render.renderer import Renderer
from ..scene.scene import load_scene
from ..utils.image import save_image
from .client import orbit_pos


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="snail_tpu_torch standalone renderer")
    ap.add_argument("scene", help=".obj scene path")
    ap.add_argument("-r", "--res", default="512x512")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--cache-dir", default=None,
                    help="geometry and BVH cache (default: none)")
    ap.add_argument("--device", default="cuda",
                    help="device the frames render on (cuda or cpu)")
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--no-reflections", action="store_true")
    ap.add_argument("--no-textures", action="store_true")
    ap.add_argument("--no-shading", action="store_true",
                    help="distance view (gVals[4])")
    ap.add_argument("--supersample", action="store_true",
                    help="2x2 AA (gVals[9])")
    ap.add_argument("--light", default=None,
                    help="x,y,z:r,g,b:radius (default: auto above scene)")
    ap.add_argument("--cam", default=None, help="px,py,pz:tx,ty,tz")
    args = ap.parse_args(argv)

    resx, resy = map(int, args.res.split("x"))

    lights = None
    if args.light:
        p, c, r = args.light.split(":")
        lights = Light.make(tuple(map(float, p.split(","))),
                            tuple(map(float, c.split(","))), float(r),
                            device=args.device)

    t0 = time.perf_counter()
    scene = load_scene(args.scene, cache_dir=args.cache_dir, lights=lights,
                       device=args.device)
    print(f"[rtracer] {scene.num_tris} tris, load+build "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    lo = scene.root_lo.cpu().numpy()
    hi = scene.root_hi.cpu().numpy()
    center = (lo + hi) * 0.5
    ext = float(np.max(hi - lo))
    if args.cam:
        p, t = args.cam.split(":")
        cam_pos = np.array(list(map(float, p.split(","))))
        cam_tgt = np.array(list(map(float, t.split(","))))
    else:
        cam_pos = center + np.array([0.45, 0.35, 0.9]) * ext
        cam_tgt = center

    opts = RenderOpts(
        shading=not args.no_shading,
        shadows=not args.no_shadows,
        reflections=not args.no_reflections,
        transparency=not args.no_reflections,
        textures=not args.no_textures,
        supersample=args.supersample,
    )
    r = Renderer(scene, resx, resy, opts)
    os.makedirs(args.out_dir, exist_ok=True)

    orbit = cam_pos - cam_tgt
    n_lights = 1 if scene.lights is None else len(scene.lights)
    for f in range(args.frames):
        cam = Camera.look_at(pos=tuple(orbit_pos(cam_tgt, orbit, f,
                                                 args.frames)),
                             target=tuple(cam_tgt), device=args.device)
        t0 = time.perf_counter()
        img = r.render(cam)
        dt = time.perf_counter() - t0
        mrays = resx * resy * (1 + n_lights) / dt / 1e6
        print(f"[rtracer] frame {f}: {dt*1e3:.1f} ms, {mrays:.1f} MRays/s",
              flush=True)
        # 'k' output-dump key (rtracer.cpp:240-243) -> always write
        save_image(os.path.join(args.out_dir, f"output_{f:03d}.png"), img)
    print(f"[rtracer] avg fps {r.fps.fps:.2f}", flush=True)


if __name__ == "__main__":
    main()
