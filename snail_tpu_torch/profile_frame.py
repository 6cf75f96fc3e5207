"""Profile the forward frame on a CUDA card: device time per kernel, per
frame, and the share of the frame the device is busy.

    python -m snail_tpu_torch.profile_frame [--kind city|terrain]
        [--trace out.json]

Traces five 1024 x 1024 frames of ``render_frame`` on a benchmark scene
at bench.py's size with ``torch.profiler``, after two warm-up frames;
prints the kernels by device time and the busy share (union of kernel
intervals over the traced window). Needs a card.
"""

from __future__ import annotations

import argparse
import sys
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
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the window here")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .core.types import RenderOpts
    from .render.renderer import render_frame
    from .scene.bench_scenes import BENCH_N, bench_scene

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    n = BENCH_N[args.kind]
    scene, cam, g, _ = bench_scene(args.kind, n, device="cuda")
    opts = RenderOpts(reflections=False, transparency=False, textures=False)
    frame = lambda: render_frame(scene, cam, SIZE, SIZE, opts)
    for _ in range(2):
        frame()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            frame()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if args.trace:
        prof.export_chrome_trace(args.trace)

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
    print(f"{args.kind}_{n} ({g.num_tris} tris) {SIZE}^2 on {dev}: "
          f"{wall_us / FRAMES / 1e3:.3f} ms/frame (host clock, "
          f"profiler on), device busy {busy / FRAMES / 1e3:.3f} "
          f"ms/frame = {busy / wall_us:.3f} of the window, "
          f"{sum(c for c, _ in by_name.values()) / FRAMES:.0f} "
          f"kernels/frame")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in rows[:25]:
        print(f"  {us / FRAMES / 1e3:9.4f} ms/frame "
              f"{count / FRAMES:6.1f}x  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
