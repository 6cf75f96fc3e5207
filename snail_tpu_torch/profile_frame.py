"""Profile a frame on a CUDA card: device time per kernel, per frame, and
the share of the frame the device is busy.

    python -m snail_tpu_torch.profile_frame [--kind city|terrain] [--n N]
        [--path fwd|bounce|fwd_bwd|stats|instanced|portable]
        [--tables leaves|nodes] [--leaf L] [--tex point|bilinear|sat]
        [--trace out.json]

Traces five 1024 x 1024 frames on a benchmark scene at bench.py's size
(or ``--n``) with ``torch.profiler``, after two warm-up frames:
``render_frame`` without bounces (fwd), with reflections and
transparency on the bounce material (bounce), bench.py's fwd+bwd step
(fwd_bwd), the counter frame ``render_frame_fast_stats`` (stats, fwd
options), the instanced frame of ``bench_scenes.instanced_grid``
(instanced: 4 x 4 instances, fwd options) or ``render_frame`` at 1280 x
720 (portable: the integrator and the dispatch seam, bounce options on
the bounce material); on a scene with worklist leaf tables (``--tables
leaves``) or node tables for the walk kernels (``--tables nodes``), its
BVH built at the kind's leaf size or ``--leaf`` (33-64: a fat-leaf
scene, node tables for the fat-leaf kernels B11a-d, which has no counter
frame); prints the kernels by device time and the busy share (union of
kernel intervals over the traced window). With ``--tex``, the scene is
bench.py's textured one (``bench_scene(..., textured=...)``: a
checkerboard on every material), rendered with textures on and that
filter. The window runs inside ``utils.trace.tracing()``, so the trace
carries the program's ``snail.`` spans: beside the kernels it prints the
device time by innermost span (a backward kernel under the forward
stage that made it, ``utils.trace.SpanIndex``), the live share of the
rays traced and the rows and columns of the hit-row gathers
(``gather.rows``, ``gather.cols``). Where a frame builds shared-origin
tables (the leaf-table counter frame's B8a/B8b: ``--path stats``), it
prints their stage too: ``rows_ms.frame``, the device ms a frame under
``snail.rows``, and the triangles tabled a frame (``rows.tris``); every
other frame, on either table kind, builds none and prints no rows stage.
bench.py's 10 Mtri terrain on node tables:

    python -m snail_tpu_torch.profile_frame --kind terrain --n 2236 \
        --tables nodes

Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

SIZE = 1024
FRAMES = 5


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", default="city", choices=("city", "terrain"))
    ap.add_argument("--n", type=int, default=None,
                    help="scene size in place of bench.py's")
    ap.add_argument("--path", default="fwd",
                    choices=("fwd", "bounce", "fwd_bwd", "stats",
                             "instanced", "portable"))
    ap.add_argument("--tables", default="leaves",
                    choices=("leaves", "nodes"))
    ap.add_argument("--leaf", type=int, default=None,
                    help="BVH leaf size in place of the kind's")
    ap.add_argument("--tex", default=None,
                    choices=("point", "bilinear", "sat"),
                    help="the textured scene, sampled with this filter")
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the window here")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .core.types import RenderOpts
    from .render.fast import render_frame_fast_stats
    from .render.renderer import render_frame
    from .scene.bench_scenes import (BENCH_N, STEP_OPTS, bench_scene,
                                     bench_step, instanced_grid)
    from .scene.instancing import render_instanced
    from .utils import trace

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    n = BENCH_N[args.kind] if args.n is None else args.n
    bounce = args.path in ("bounce", "fwd_bwd", "portable")
    scene, cam, g, bvh = bench_scene(args.kind, n, bounce=bounce,
                                     walk=args.tables == "nodes",
                                     leaf=args.leaf, textured=args.tex)
    tex = dict(textures=args.tex is not None, tex_filter=args.tex or "point")
    opts = (RenderOpts(**tex) if args.path in ("bounce", "portable")
            else RenderOpts(reflections=False, transparency=False, **tex))
    size = (1280, 720) if args.path == "portable" else (SIZE, SIZE)
    if args.path == "fwd_bwd":
        target = render_frame(scene, cam, SIZE, SIZE, STEP_OPTS)
        frame = lambda: bench_step(scene, cam, target, SIZE, SIZE)
    elif args.path == "stats":
        frame = lambda: render_frame_fast_stats(scene, cam, SIZE, SIZE, opts)
    elif args.path == "instanced":
        iscene, icam = instanced_grid(args.kind, scene, 4)
        frame = lambda: render_instanced(iscene, icam, SIZE, SIZE, opts)
    else:
        frame = lambda: render_frame(scene, cam, *size, opts)
    for _ in range(2):
        frame()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            trace.tracing():
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            frame()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    counts = trace.counters()
    path = args.trace
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            by_span = trace.SpanIndex(json.load(f)).device_us()
    finally:
        if not args.trace:
            os.unlink(path)

    by_name = defaultdict(lambda: [0, 0.0])
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
        spans.append((e.time_range.start, e.time_range.end))
    busy = _union_us(spans)
    dev = torch.cuda.get_device_name(0)
    tables = ("leaves" if scene.leaves is not None else
              f"nodes, {bvh.num_nodes} of them, leaf_max "
              f"{scene.nodes.leaf_max}")
    print(f"{args.kind}_{n} {args.path}"
          f"{'' if args.tex is None else ' tex ' + args.tex} "
          f"({g.num_tris} tris, {tables}) "
          f"{size[0]}x{size[1]} on {dev}: "
          f"{wall_us / FRAMES / 1e3:.3f} ms/frame (host clock, "
          f"profiler on), device busy {busy / FRAMES / 1e3:.3f} "
          f"ms/frame = {busy / wall_us:.3f} of the window, "
          f"{sum(c for c, _ in by_name.values()) / FRAMES:.0f} "
          f"kernels/frame")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in rows[:25]:
        print(f"  {us / FRAMES / 1e3:9.4f} ms/frame "
              f"{count / FRAMES:6.1f}x  {name[:90]}")
    total = sum(by_span.values())
    in_span = 1.0 - by_span.get(None, 0.0) / max(total, 1e-9)
    print(f"by innermost span ({100 * in_span:.1f} % of device time in "
          f"one), live rays {counts.get('rays.live', 0)} of "
          f"{counts.get('rays.traced', 0)} traced, rows gathered "
          f"{counts.get('gather.rows', 0)} with {counts.get('gather.cols', 0)}"
          f" columns summed over the gathers in the window:")
    for name, us in sorted(by_span.items(), key=lambda kv: -kv[1]):
        print(f"  {us / FRAMES / 1e3:9.4f} ms/frame  {name or 'no span'}")
    if counts.get("rows.tris"):
        print(f"rows stage: rows_ms.frame "
              f"{by_span.get('snail.rows', 0.0) / FRAMES / 1e3:.4f}, "
              f"rows.tris {counts['rows.tris'] / FRAMES:.0f} a frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
