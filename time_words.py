#!/usr/bin/env python3
"""Device time of the words passes B1, B3 and B5 on one CUDA card.

    python3 time_words.py [--tree DIR] [--reps N]

Imports ``snail_tpu_torch`` from DIR (default: the directory of this
script), so that one command can time another commit's kernels from a
checkout of it, and compare trees in turns within one call. Builds the
bench scenes city_24 and terrain_724 on the card (bench_scenes, material
0 reflective), and on their 1024 x 1024 wavefronts times B1 on the primary
rays, B3 on the shadow rays toward light 0 (one band) and B5 on the
reflection rays (8 bands): the mean device time of each kernel over N
launches (default 20) after one warm-up, queued behind a spin so that
the host's time between launches does not count (``device_ms``). Where
the tree's wrappers take a cluster size, each pass is timed at 1, 2, 4
and 8 blocks per packet too. Prints the card (name and power limit, from
nvidia-smi) and one JSON line per scene. Exits non-zero without a card.
"""

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

WIDTH = HEIGHT = 1024
CLUSTERS = (1, 2, 4, 8)
# ~50 ms at the H100's 1.98 GHz boost clock: far longer than the host
# takes to queue the timed calls
SPIN_CYCLES = 100_000_000


def device_ms(fn, reps: int, tries: int = 3) -> float:
    """Mean device milliseconds per call of fn(), over reps calls after
    one warm-up. The calls are queued behind a spin kernel
    (``torch.cuda._sleep``), so that the CUDA events around them see the
    device run them back to back: the host's time between launches, longer
    than these kernels', does not count. A run whose queueing outlasted
    the spin is taken again, up to ``tries`` times."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        spun, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spun.record()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if queued_ms < spun.elapsed_time(start):
            return start.elapsed_time(end) / reps
    raise RuntimeError(f"queueing {reps} calls took {queued_ms:.1f} ms, "
                       f"longer than the spin, {tries} times")


def wavefronts(kind: str, n: int):
    """The scene's tables and its words passes' calls: {kernel:
    run(cluster)} (cluster None: the wrapper's default) on the primary,
    shadow (light 0) and reflection wavefronts of a 1024 x 1024 frame."""
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.fast import bounce_wavefront, shadow_wavefront
    from snail_tpu_torch.scene.bench_scenes import bench_scene

    scene, cam, _, _ = bench_scene(kind, n, bounce=True)
    w, h, lt = WIDTH, HEIGHT, scene.leaves
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    dist, u, v, tri, dx, dy, dz = pt.camera_trace(scene, cam, w, h)
    flat = lambda a: a.reshape(-1)
    primary = ((cam.pos[0], cam.pos[1], cam.pos[2]),
               (flat(dx), flat(dy), flat(dz)), flat(dist), flat(u), flat(v),
               flat(tri))
    light = scene.lights.pos[0].contiguous()
    d, tm = shadow_wavefront(scene, *primary, light)
    pk = lambda a: a.reshape(-1, pt.PACKET_R).contiguous()
    d, tm = tuple(pk(c) for c in d), pk(tm)
    o, gd, gtm, _ = pt.general_planes(*bounce_wavefront(scene, *primary))
    kw = lambda c: {} if c is None else {"cluster": c}
    return lt, {
        "words_camera": lambda c: pt.words_camera(cv, w, h, lt, **kw(c)),
        "words_shared": lambda c: pt.words_shared(light, d, tm, lt, 1,
                                                  **kw(c)),
        "words_general": lambda c: pt.words_general(o, gd, gtm, lt,
                                                    **kw(c)),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path,
                    default=Path(__file__).resolve().parent)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.scene.bench_scenes import BENCH_N

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {args.tree}", flush=True)
    sized = "cluster" in inspect.signature(pt.words_camera).parameters
    for kind in ("city", "terrain"):
        lt, runs = wavefronts(kind, BENCH_N[kind])
        out = {"scene": f"{kind}_{BENCH_N[kind]}", "tree": str(args.tree)}
        for k, run in runs.items():
            row = {"default": device_ms(lambda: run(None), args.reps)}
            if sized:
                row.update({str(c): device_ms(lambda: run(c), args.reps)
                            for c in CLUSTERS})
            out[k] = row
        print(json.dumps(out), flush=True)
        del lt, runs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
