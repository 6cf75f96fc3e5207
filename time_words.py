#!/usr/bin/env python3
"""Device time of the words passes B1, B3 and B5, of the closest hits B9c
and B11b, of the any-hits B7, B9d, B11c and B11d, of the shared-origin
scans B2, B8a, B9b and B9f, of the camera walks B9a, B9e and B11a, and
of the forward frame's hit-row gather on one CUDA card.

    python3 time_words.py [--tree DIR] [--reps N]
                          [--only words|closest|anyhit|shared|camera|gather]
                          [--scan]
    python3 time_words.py [--tree DIR] [--reps N]
                          [--only closest|anyhit|shared|camera]
                          --sweep T[,T...]
    python3 time_words.py [--tree DIR] [--reps N] --only camera
                          --variant NAME[,NAME...]

Imports ``snail_tpu_torch`` from DIR (default: the directory of this
script), so that one command can time another commit's kernels from a
checkout of it, and compare trees in turns within one call. Each time is
the mean device time of a kernel over N launches (default 20) after one
warm-up, queued behind a spin so that the host's time between launches
does not count (``device_ms``).

- words: builds the bench scenes city_24 and terrain_724 on the card
  (bench_scenes, material 0 reflective), and on their 1024 x 1024
  wavefronts times B1 on the primary rays, B3 on the shadow rays toward
  light 0 (one band) and B5 on the reflection rays (8 bands). Where the
  tree's wrappers take a cluster size, each pass is timed at 1, 2, 4 and
  8 blocks per packet too.
- closest: B9c on the reflection rays of the same scenes built with node
  tables, and on the terrain's photon wavefront (2^20 photons from light
  0, trace_photons' first draws); B11b on the reflection rays of
  city_24 and terrain_530 at leaf 64; and the 1024 x 1024 bounce frame
  of each of these four scenes (CUDA events over 10 frames after one
  warm-up: host time between launches counts there).
- anyhit: B9d on city_24 and terrain_724 with node tables and B11d on
  city_24 and terrain_530 at leaf 64, each on the shadow wavefronts that
  the 1024 x 1024 instanced fwd frame of its ``instanced_grid`` (16
  instances of the city, 4 of the terrain) launches, one per instance
  (taken from the frame's own calls: light 0 in the instance's object
  space, rays that miss its box or an earlier instance blocked masked),
  summed per frame, and on chip_smoke.py's seeded shadow wavefront
  (``seeded_shadow_planes``); with each, the live rays and blocked share
  of every instance's wavefront, the kernel's bound on it (chip_smoke
  ``walk_work``, from its plain version's walk, and ``anyhit_bytes``)
  and the instanced fwd frame (CUDA events over 10 frames). On the node
  scenes' leaf-table twins (same geometry and BVH), B7 and B5 (one band)
  + B7 on the same wavefronts, B7's bound (chip_smoke ``b7_work``) and
  the twin's instanced fwd frame; on the leaf-64 scenes, B11c on the
  fwd frame's shadow wavefront toward the bench light and (the terrain)
  the low light, and on the bounce frame's three (its own calls,
  chip_smoke ``bounce_shadow_calls``), summed and one by one, each with
  its live rays, blocked share and bound, and the fat fwd and bounce
  frames. The kernels' verdicts and the tally of their warps are
  chip_smoke.py's (phases 3, 5 and 7).
- shared: on city_24 and terrain_724 with leaf tables, B2 and B8a on
  the 1024 x 1024 primary wavefront, B4 on the fwd frame's shadow
  wavefront toward the bench light and (the terrain) the low light (its
  own calls, on the rows the tree gives B2 and B4: raw, or shared-origin
  in a tree from before PR 17) and the camera's ``shared_rows`` table; on
  the same geometry with node tables, B9b and B9f on the fwd frame's
  shadow wavefront toward the bench light and (the terrain) the low
  light, and on the walk bounce frame's three (its own calls), summed
  and one by one; each with a digest of its outputs, so two trees' can
  be compared bit for bit, its bound, live rays and blocked share; the
  fwd frame (the terrain's also under the low light) and counter frame
  on both table kinds and the walk bounce frame; with ``--scan``, the
  ``scan`` lines of its warps on a few packets (chip_smoke
  ``camera_tally``, ``warp_tally``, on the tree's simulations).
- camera: B9a and B9e on the 1024 x 1024 primary wavefront of city_24
  and terrain_724 with node tables, B11a on that of city_24 and
  terrain_530 at leaf 64, each called as the frame's ``camera_trace``
  calls it; with each, a digest of its outputs (B9e: and its counters;
  B9e's outputs must be B9a's), its bound (chip_smoke ``walk_work``,
  ``stats_entry``) and the walk fwd and counter frames or the fat fwd
  frame; with ``--scan``, the ``scan`` lines of the warps on a few
  packets, simulated with either warp footprint, 32 consecutive rays and
  an 8 x 4 pixel tile (``camera_scan``).
- gather: ``surface_gather_kernel`` (``ops/gather.py`` ``surface_rows``)
  on the three wavefronts of terrain_724's supersampled 1024 x 1024
  bounce frame (2048^2 rays each, material 0 half mirror, half glass:
  the frame of the benchmark's ``terrain_1m.bounce_ss`` cell), taken
  from the frame's own calls; with each, its bound (the sectors of the
  rows it needs, each read once, its dist and tri, and its planes, over
  the H100's 3.35 TB/s) and, as ``library_ms``, the ``index_select`` of
  whole rows that the frame called before (``library_path_ms`` with the
  hit mask and index conversion in front of it), with the bytes that
  moves; and the bounce frame (CUDA events over 10 frames).

With ``--sweep``, times the closest hits (``--only closest``, the
default), the any-hits (``--only anyhit``: the kernels' times only), the
shared-origin scans (``--only shared``: their times and digests) or the
camera walks (``--only camera``: their times and digests) of copies of
the tree's package in which B9c and B11b, B7, B9d, B11c and B11d,
B2/B8a and B9b/B9f, or B9a/B9e and B11a test a leaf lane per triangle
where at most T lanes enter it (the constexprs of ``LANE_TRI_MAX``:
``kWalkLaneTriMax`` / ``kFatLaneTriMax``, ``kWlAnyLaneTriMax`` /
``kWalkAnyLaneTriMax`` / ``kFatShadowLaneTriMax`` /
``kFatAnyLaneTriMax``, ``kCamLaneTriMax`` / ``kWalkShadowLaneTriMax``,
or ``kWalkCamLaneTriMax`` / ``kFatCamLaneTriMax``, set to T), one copy
per T in turn, each in a process of its own; each JSON line then
carries its ``lane_tri_max``. With ``--variant``, the camera walks'
times and digests in copies of the tree's package edited as
``VARIANTS`` says (warps on 32 consecutive rays, ``walk`` in place of
``walk_pairs``, the shared origin not broadcast, launch bounds), in
turn; ``none`` is the
tree as it is, so ``--variant none,rows,rows,none`` times the two in
turns; each JSON line carries its ``variant``.

Prints the card (name and power limit, from nvidia-smi) and one JSON line
per scene. Exits non-zero without a card.
"""

import argparse
import hashlib
import importlib.util
import inspect
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

WIDTH = HEIGHT = 1024
CLUSTERS = (1, 2, 4, 8)
# the closest-hit scenes: kind -> size at leaf 64 (chip_smoke.py FAT_N),
# the photons of the photon wavefront, and the bounce frames timed
FAT_N = {"city": 24, "terrain": 530}
PHOTONS = 2 ** 20
FRAMES = 10
# the threshold constexprs of the staged leaf stages, by kernels and
# source
LANE_TRI_MAX = {
    "closest": {"walk.cu": ("kWalkLaneTriMax",),
                "fat.cu": ("kFatLaneTriMax",)},
    "anyhit": {"walk.cu": ("kWalkAnyLaneTriMax",),
               "fat.cu": ("kFatAnyLaneTriMax", "kFatShadowLaneTriMax"),
               "worklist.cu": ("kWlAnyLaneTriMax",)},
    "shared": {"walk.cu": ("kWalkShadowLaneTriMax",),
               "worklist.cu": ("kCamLaneTriMax",)},
    "camera": {"walk.cu": ("kWalkCamLaneTriMax",),
               "fat.cu": ("kFatCamLaneTriMax",)}}
_CAM_K = "k = tile_ray((int)(t % kPacketR));"
_FAT_PAIRS = """  walk_pairs(nodes, warp_stack(stack_cap), o, r.idir,
             packet_signs(signs, pid), [&] { return best; },
             [&](bool enter, int first, int count) {
               leaf_closest_staged<kFatLeafRows, kFatCamLaneTriMax>(
                   rows, stage, first, count, enter, o, r.d, best, tri, bu,
                   bv);
             });"""
_FAT_WALK = """  WalkCounts wc;
  walk<false>(nodes, warp_stack(stack_cap), o, r.idir,
              packet_signs(signs, pid), [&] { return best; },
              [&](bool enter, int first, int count, int&) {
                leaf_closest_staged<kFatLeafRows, kFatCamLaneTriMax>(
                    rows, stage, first, count, enter, o, r.d, best, tri, bu,
                    bv);
                return false;
              },
              wc);"""
# the variants of the camera kernels B9a (B9e) and B11a that ``--variant``
# times: {name: [(source in csrc, text, replacement)]}, each text found
# once in the tree's source
VARIANTS = {
    # warps on 32 consecutive rays, as before the 8 x 4 tiles
    "rows": [("walk.cu", _CAM_K, "k = (int)(t % kPacketR);"),
             ("fat.cu", _CAM_K, "k = (int)(t % kPacketR);")],
    # B9a and B11a on ``walk`` in place of ``walk_pairs``
    "walk": [
        ("walk.cu",
         "walk_pairs(nodes, warp_stack(stack_cap), o, r.idir, sg, bound, "
         "leaf);",
         "WalkCounts wc; walk<false>(nodes, warp_stack(stack_cap), o, "
         "r.idir, sg, bound, [&](bool e, int f, int c, int&) { leaf(e, f, "
         "c); return false; }, wc);"),
        ("fat.cu", _FAT_PAIRS, _FAT_WALK)],
    # B11a's lane-per-triangle tests with the shared origin as the lane
    # holds it, not broadcast (the copy's B11b, which needs the broadcast,
    # is wrong there and is not timed)
    "sharedo": [("walk.cuh", "ro[k] = __shfl_sync(kFull, o[k], src);",
                 "ro[k] = o[k];")],
    # B9a (B9e) and B11a asked for at least N blocks an SM (0: no
    # minimum)
    **{f"blocks{n}": [
        ("walk.cu", "__launch_bounds__(kWalkThreads, 2)\nwalk_camera_kernel(",
         f"__launch_bounds__(kWalkThreads{f', {n}' if n else ''})\n"
         "walk_camera_kernel("),
        ("fat.cu", "__launch_bounds__(kWalkThreads)\nfat_camera_kernel(",
         f"__launch_bounds__(kWalkThreads{f', {n}' if n else ''})\n"
         "fat_camera_kernel(")]
       for n in (0, 2, 3, 4)},
}
# the any-hit scenes: (kind, size, leaf): node tables at the kind's leaf
# (B9d; B5 + B7 on the same geometry's leaf tables), or leaf 64 (B11d)
ANYHIT = (("city", 24, None), ("terrain", 724, None), ("city", 24, 64),
          ("terrain", 530, 64))
# the H100 SXM's HBM rate, bytes/s (NVIDIA's data sheet)
HBM_BPS = 3.35e12
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


def photon_planes(scene, n: int, seed: int = 0):
    """The wavefront ``trace_photons(scene, n, seed)`` casts from light 0
    (the same draws of its seeded generator), as B5/B6 and B9c take it:
    the (o, d, tm) planes."""
    import torch

    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.photons import _stratified_sphere

    gen = torch.Generator(device=scene.device)
    gen.manual_seed(seed)
    d = _stratified_sphere(n, gen)
    o = scene.lights.pos[0].expand(n, 3)
    tmax = torch.full((n,), BIG, device=scene.device)
    o, d, tm, _ = pt.general_planes(o.unbind(1), d.unbind(1), tmax)
    return o, d, tm


def closest_calls(kind: str, n: int, leaf=None):
    """A bounce scene of ``kind`` at size ``n`` with node tables (``leaf``
    None: the kind's leaf, B9c) or at leaf ``leaf`` (64: B11b), and its
    timed calls: {name: fn()}: the closest hit on the reflection rays of
    its 1024 x 1024 frame (on the terrain's node tables, also on the
    photon wavefront) and the bounce frame."""
    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.fast import bounce_wavefront
    from snail_tpu_torch.render.renderer import render_frame
    from snail_tpu_torch.scene.bench_scenes import bench_scene

    scene, cam, _, _ = bench_scene(kind, n, bounce=True, walk=leaf is None,
                                   leaf=leaf)
    w, h = WIDTH, HEIGHT
    dist, u, v, tri, dx, dy, dz = pt.camera_trace(scene, cam, w, h)
    flat = lambda a: a.reshape(-1)
    primary = ((cam.pos[0], cam.pos[1], cam.pos[2]),
               (flat(dx), flat(dy), flat(dz)), flat(dist), flat(u), flat(v),
               flat(tri))
    rows, nodes = scene.tri_rows, scene.nodes
    calls = {}
    if pt.is_fat(scene):
        o, d, tm, _ = pt.padded_planes(*bounce_wavefront(scene, *primary))
        signs = pt.packet_signs(d)
        calls["fat_closest reflections"] = lambda: pt.fat_closest(
            o, d, tm, signs, rows, nodes)
    else:
        o, d, tm, _ = pt.general_planes(*bounce_wavefront(scene, *primary))
        calls["walk_closest_g reflections"] = lambda: pt.walk_closest_g(
            o, d, tm, rows, nodes)
        if kind == "terrain":
            po, pd, ptm = photon_planes(scene, PHOTONS)
            calls["walk_closest_g photons"] = lambda: pt.walk_closest_g(
                po, pd, ptm, rows, nodes)
    opts = RenderOpts(textures=False)
    calls["bounce frame"] = lambda: render_frame(scene, cam, w, h, opts)
    return calls


def frame_ms(fn, frames: int = FRAMES) -> float:
    """Mean ms of fn() over ``frames`` calls after one warm-up, CUDA events
    around them (the host's time between launches counts)."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(frames):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / frames


def time_passes(tree, reps: int) -> None:
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.scene.bench_scenes import BENCH_N

    sized = "cluster" in inspect.signature(pt.words_camera).parameters
    for kind in ("city", "terrain"):
        lt, runs = wavefronts(kind, BENCH_N[kind])
        out = {"scene": f"{kind}_{BENCH_N[kind]}", "tree": str(tree)}
        for k, run in runs.items():
            row = {"default": device_ms(lambda: run(None), reps)}
            if sized:
                row.update({str(c): device_ms(lambda: run(c), reps)
                            for c in CLUSTERS})
            out[k] = row
        print(json.dumps(out), flush=True)
        del lt, runs
        torch.cuda.empty_cache()


def time_closest(tree, reps: int) -> None:
    import torch

    from snail_tpu_torch.scene.bench_scenes import BENCH_N

    for kind, n, leaf, tables in (
            ("city", BENCH_N["city"], None, "nodes"),
            ("terrain", BENCH_N["terrain"], None, "nodes"),
            ("city", FAT_N["city"], 64, "leaf 64"),
            ("terrain", FAT_N["terrain"], 64, "leaf 64")):
        calls = closest_calls(kind, n, leaf)
        out = {"scene": f"{kind}_{n} {tables}", "tree": str(tree)}
        for k, fn in calls.items():
            out[k] = (frame_ms(fn) if k == "bounce frame"
                      else device_ms(fn, reps))
        print(json.dumps(out), flush=True)
        del calls
        torch.cuda.empty_cache()


def smoke():
    """chip_smoke.py beside this script (not the ``--tree``'s), as a
    module."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", Path(__file__).resolve().with_name("chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


def anyhit_waves(kind: str, n: int, leaf):
    """A bounce scene of ``kind`` at size ``n`` with node tables (``leaf``
    None; and its leaf-table twin on the same geometry and BVH) or at
    leaf ``leaf`` (64), the instanced grid of it, and the shadow
    wavefronts its instanced fwd frame gives its any-hit kernel
    (chip_smoke ``instanced_shadow_calls``): (node scene, twin or None,
    camera, instanced scene, its camera, kernel name, [the kernel's
    arguments, one call per instance])."""
    from snail_tpu_torch.scene.bench_scenes import (bench_scene,
                                                    bounce_materials)
    from snail_tpu_torch.scene.scene import make_traced_scene

    if leaf:
        node, cam = bench_scene(kind, n, bounce=True, leaf=leaf)[:2]
        twin = None
    else:
        twin, cam, g, bvh = bench_scene(kind, n, bounce=True)
        node = make_traced_scene(g, bvh, bounce_materials(),
                                 lights=twin.lights, device=twin.device,
                                 walk=True)
    return (node, twin, cam, *smoke().instanced_shadow_calls(kind, node))


def b7_times(out, kind, twin, waves, seeded, reps, quick):
    """Adds to ``out`` B7 on the twin's leaf tables, on the rays of the
    node scene's instanced wavefronts (summed and one by one) and seeded
    one; unless ``quick`` also B5 + B7 on them, B7's bound on each
    (chip_smoke ``b7_work``: live rays' planes only) and the leaf-table
    instanced fwd frame."""
    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.scene.bench_scenes import instanced_grid
    from snail_tpu_torch.scene.instancing import render_instanced

    sm = smoke()
    lt, rows = twin.leaves, twin.tri_rows
    b7, b57, bound = [], [], []
    for o, d, tm, *_ in waves + [seeded]:
        words = pt.words_general(o, d, tm, lt, 1)
        b7.append(device_ms(lambda: pt.shadow_wl_g(o, d, tm, rows, lt,
                                                   *words), reps))
        if quick:
            continue
        b57.append(device_ms(lambda: pt.shadow_wl_g(
            o, d, tm, rows, lt, *pt.words_general(o, d, tm, lt, 1)), reps))
        kern = pt.shadow_wl_g(o, d, tm, rows, lt, *words)
        bound.append(sm.entry(0.0, 0.0, 0.0, *sm.b7_work(
            lt, rows, o, d, tm, *words, kern))["bound_ms"])
    out.update({"instanced shadow_wl_g ms": sum(b7[:-1]),
                "instanced shadow_wl_g ms by instance": b7[:-1],
                "seeded shadow_wl_g ms": b7[-1]})
    if quick:
        return
    isc, icam = instanced_grid(kind, twin, sm.INSTANCE_GRID[kind][0])
    opts = RenderOpts(reflections=False, transparency=False, textures=False)
    out.update({
        "instanced words_general + shadow_wl_g ms": sum(b57[:-1]),
        "seeded words_general + shadow_wl_g ms": b57[-1],
        "instanced shadow_wl_g bound ms": sum(bound[:-1]),
        "instanced shadow_wl_g bound ms by instance": bound[:-1],
        "seeded shadow_wl_g bound ms": bound[-1],
        "leaf-table instanced fwd frame ms": frame_ms(
            lambda: render_instanced(isc, icam, WIDTH, HEIGHT, opts))})


def b11c_times(out, kind, scene, cam, reps, quick):
    """Adds to ``out`` B11c on the fat-leaf scene's own shadow wavefronts
    (chip_smoke ``frame_shadow_calls``): the fwd frame's toward the bench
    light and, where the kind has one, toward the low light; the bounce
    frame's (light 0, or where it blocks no ray the low light:
    chip_smoke ``bounce_shadow_calls``), summed and one by one; and unless
    ``quick`` each one's live rays, blocked share and bound (live rays'
    planes only) and the fat fwd and bounce frames."""
    import dataclasses

    from snail_tpu_torch.core.types import Light, RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref
    from snail_tpu_torch.render.renderer import render_frame
    from snail_tpu_torch.scene.bench_scenes import SCENES

    sm = smoke()
    fwd = RenderOpts(reflections=False, transparency=False, textures=False)
    waves = {"bench light": sm.frame_shadow_calls(scene, cam, fwd)[0]}
    if kind in sm.LOW_LIGHT:
        low = dataclasses.replace(scene, lights=Light.make(
            sm.LOW_LIGHT[kind], (1.0, 1.0, 1.0), SCENES[kind][3]))
        waves["low light"] = sm.frame_shadow_calls(low, cam, fwd)[0]
    light, bounce = sm.bounce_shadow_calls(kind, scene, cam)
    for i, a in enumerate(bounce):
        waves[f"bounce frame call {i + 1} of {len(bounce)}, {light}"] = a
    ms = {w: device_ms(lambda: pt.fat_shadow(*a), reps)
          for w, a in waves.items()}
    out["fat_shadow ms"] = ms
    out["fat_shadow bounce frame ms"] = sum(
        v for w, v in ms.items() if w.startswith("bounce"))
    if quick:
        return
    info = {}
    for w, (orig, d, tm, signs, rows, nodes) in waves.items():
        kern, work = pt.fat_shadow(orig, d, tm, signs, rows, nodes), {}
        ref.fat_shadow_plain(orig, d, tm, signs, rows, nodes, work)
        ops, tree_bytes = sm.walk_work("fat_shadow", nodes, rows, work)
        n_bytes = (sm.nbytes(orig) + sm.anyhit_bytes((), d, tm, signs, kern)
                   + tree_bytes)
        live = tm >= 0
        info[w] = {"live rays": int(live.sum()),
                   "blocked share": float(kern[live].mean())
                   if bool(live.any()) else 0.0,
                   "bound ms": sm.entry(0.0, 0.0, 0.0, n_bytes,
                                        ops)["bound_ms"]}
    out["fat_shadow wavefronts"] = info
    out["fat fwd frame ms"] = frame_ms(
        lambda: render_frame(scene, cam, WIDTH, HEIGHT, fwd))
    out["fat bounce frame ms"] = frame_ms(
        lambda: render_frame(scene, cam, WIDTH, HEIGHT,
                             RenderOpts(textures=False)))


def anyhit_extra(out, k, isc, icam, waves, seeded):
    """Adds to ``out`` what ``--only anyhit`` gives beside the kernel's
    times: per instance the live rays, blocked share and bound of its
    wavefront (and the seeded one's); the instanced fwd frame."""
    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref
    from snail_tpu_torch.scene.instancing import render_instanced

    sm = smoke()
    kern = getattr(pt, k)
    plain = getattr(ref, f"{k}_plain")
    live, share, bound = [], [], []
    for a in waves + [seeded]:
        tm, blocked = a[2], kern(*a)
        work = {}
        plain(*a, work)
        ops, tree_bytes = sm.walk_work(k, a[-1], a[-2], work)
        n_bytes = sm.anyhit_bytes(*a[:3], a[3] if len(a) == 6 else None,
                                  blocked)
        bound.append(sm.entry(0.0, 0.0, 0.0, n_bytes + tree_bytes,
                              ops)["bound_ms"])
        live.append(int((tm >= 0).sum()))
        share.append(float(blocked[tm >= 0].mean()) if live[-1] else 0.0)
    out.update({"live rays by instance": live[:-1],
                "blocked share by instance": share[:-1],
                "instanced bound ms": sum(bound[:-1]),
                "instanced bound ms by instance": bound[:-1],
                "seeded live rays": live[-1], "seeded blocked share":
                share[-1], "seeded bound ms": bound[-1]})
    opts = RenderOpts(reflections=False, transparency=False, textures=False)
    out["instanced fwd frame ms"] = frame_ms(
        lambda: render_instanced(isc, icam, WIDTH, HEIGHT, opts))


def time_anyhit(tree, reps: int, quick: bool = False) -> None:
    """B9d and B11d on the ANYHIT scenes' instanced and seeded shadow
    wavefronts, B7 on the same rays on leaf tables (``b7_times``), B11c
    on the leaf-64 scenes' own shadow wavefronts (``b11c_times``): their
    times, and unless ``quick`` ``anyhit_extra``."""
    import torch

    from snail_tpu_torch.ops import traverse as pt

    for kind, n, leaf in ANYHIT:
        node, twin, cam, isc, icam, k, waves = anyhit_waves(kind, n, leaf)
        kern = getattr(pt, k)
        seed, o, d, tm, signs = smoke().seeded_shadow_planes(
            node, (WIDTH // pt.TILE) * (HEIGHT // pt.TILE))
        seeded = ((o, d, tm) + (() if signs is None else (signs,))
                  + (node.tri_rows, node.nodes))
        by = [device_ms(lambda: kern(*a), reps) for a in waves]
        out = {"scene": f"{kind}_{n} {'leaf 64' if leaf else 'nodes'} "
                        f"x{len(waves)}", "tree": str(tree), "kernel": k,
               "seed": seed, "instanced ms": sum(by),
               "instanced ms by instance": by,
               "seeded ms": device_ms(lambda: kern(*seeded), reps)}
        if twin is not None:
            b7_times(out, kind, twin, waves, seeded, reps, quick)
        else:
            b11c_times(out, kind, node, cam, reps, quick)
        if not quick:
            anyhit_extra(out, k, isc, icam, waves, seeded)
        print(json.dumps(out), flush=True)
        del node, twin, isc, waves, seeded
        torch.cuda.empty_cache()


def digest(*tensors) -> str:
    """A short hash of the tensors' bytes: outputs of two trees compared
    bit for bit within one call."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def shared_waves(kind, scene, cam):
    """B9b's wavefronts on the node-table scene: {name: the arguments of
    its call}: the 1024 x 1024 fwd frame's toward the bench light and
    (the terrain) the low light, and the bounce frame's three (light 0,
    or where it blocks no live ray the low light: chip_smoke
    ``bounce_shadow_calls``), each taken from the frame's own calls."""
    import dataclasses

    from snail_tpu_torch.core.types import Light, RenderOpts
    from snail_tpu_torch.scene.bench_scenes import SCENES

    sm = smoke()
    fwd = RenderOpts(reflections=False, transparency=False, textures=False)
    waves = {"bench light": sm.frame_shadow_calls(scene, cam, fwd)[0]}
    if kind in sm.LOW_LIGHT:
        low = dataclasses.replace(scene, lights=Light.make(
            sm.LOW_LIGHT[kind], (1.0, 1.0, 1.0), SCENES[kind][3]))
        waves["low light"] = sm.frame_shadow_calls(low, cam, fwd)[0]
    light, bounce = sm.bounce_shadow_calls(kind, scene, cam)
    for i, a in enumerate(bounce):
        waves[f"bounce frame call {i + 1} of {len(bounce)}, {light}"] = a
    return waves


def time_shared(tree, reps: int, quick: bool = False,
                scan: bool = False) -> None:
    """B2 and B8a on the primary wavefront of city_24 and terrain_724
    (leaf tables), B4 on the fwd frame's shadow wavefront toward the bench
    light and (the terrain) the low light, each on the rows the tree's
    frame gives it (a tree from before PR 17: the shared-origin rows), and
    one ``shared_rows`` table; B9b and B9f on the same geometry's node
    tables (``shared_waves``): their times and a digest of their outputs (B8a's
    and B9f's: their counters) per wavefront; unless ``quick``, each
    one's bound (chip_smoke ``needed_work``; ``walk_work`` and
    ``anyhit_bytes``: live rays' planes only), live rays and blocked
    share, the fwd and counter frames on both table kinds and the walk
    bounce frame; with ``scan``, the ``scan`` lines of their warps on a
    few packets (chip_smoke ``camera_tally``, ``warp_tally``: the tree's
    simulations, ops/traverse.py ``camera_wl_sim`` and
    ops/traverse_ref.py ``shadow_sim``)."""
    import dataclasses

    import torch

    from snail_tpu_torch.core.types import Light, RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref
    from snail_tpu_torch.render.fast import render_frame_fast_stats
    from snail_tpu_torch.render.renderer import render_frame
    from snail_tpu_torch.scene.bench_scenes import (BENCH_N, SCENES,
                                                    bench_scene,
                                                    bounce_materials)
    from snail_tpu_torch.scene.scene import make_traced_scene

    sm = smoke()
    w, h = WIDTH, HEIGHT
    fwd = RenderOpts(reflections=False, transparency=False, textures=False)
    for kind in ("city", "terrain"):
        n = BENCH_N[kind]
        scene, cam, g, bvh = bench_scene(kind, n, bounce=True)
        node = make_traced_scene(g, bvh, bounce_materials(),
                                 lights=scene.lights, device=scene.device,
                                 walk=True)
        lt = scene.leaves
        srows = pt.shared_rows(scene.tri_rows, cam.pos)
        res = pt._camera_words(scene, cam, w, h)
        if len(res) == 5:
            # a tree whose B2 takes the shared-origin rows (before PR 17)
            cv, _, words, summ, floors = res
            rows, b2_form = srows, "camera_wl_stats"
        else:
            cv, words, summ, floors = res
            rows, b2_form = scene.tri_rows, "camera_wl"
        b2 = lambda: pt.camera_wl(cv, w, h, rows, lt, words, summ, floors)
        b8 = lambda: pt.camera_wl_stats(cv, w, h, srows, lt, words, summ,
                                        floors)
        kern, st = b2(), b8()[-1]
        # B4 on the fwd frame's shadow wavefronts, each on the rows the
        # tree's frame gives it (taken from the frame's own calls)
        b4_waves = {"bench light": sm.captured("shadow_wl", lambda: (
            render_frame(scene, cam, w, h, fwd)))[0]}
        if kind in sm.LOW_LIGHT:
            low = dataclasses.replace(scene, lights=Light.make(
                sm.LOW_LIGHT[kind], (1.0, 1.0, 1.0), SCENES[kind][3]))
            b4_waves["low light"] = sm.captured("shadow_wl", lambda: (
                render_frame(low, cam, w, h, fwd)))[0]
        out = {"scene": f"{kind}_{n}", "tree": str(tree),
               "camera_wl rows": ("raw" if b2_form == "camera_wl"
                                  else "shared-origin"),
               "camera_wl ms": device_ms(b2, reps),
               "camera_wl_stats ms": device_ms(b8, reps),
               "shared_rows ms": device_ms(
                   lambda: pt.shared_rows(scene.tri_rows, cam.pos), reps),
               "shadow_wl ms": {k: device_ms(lambda: pt.shadow_wl(*a), reps)
                                for k, a in b4_waves.items()},
               "camera_wl digest": digest(*kern),
               "camera_wl_stats digest": digest(st),
               "shadow_wl digest": {k: digest(pt.shadow_wl(*a))
                                    for k, a in b4_waves.items()}}
        waves = shared_waves(kind, node, cam)
        out["walk_shadow ms"] = {k: device_ms(lambda: pt.walk_shadow(*a),
                                              reps)
                                 for k, a in waves.items()}
        out["walk_shadow bounce frame ms"] = sum(
            v for k, v in out["walk_shadow ms"].items()
            if k.startswith("bounce"))
        out["walk_shadow_stats ms"] = {
            k: device_ms(lambda: pt.walk_shadow_stats(*a), reps)
            for k, a in waves.items()}
        out["walk_shadow digest"] = {k: digest(pt.walk_shadow(*a))
                                     for k, a in waves.items()}
        out["walk_shadow_stats digest"] = {
            k: digest(pt.walk_shadow_stats(*a)[1]) for k, a in waves.items()}
        if not quick:
            pids = torch.arange(words.shape[0], device=cv.device)
            d, idir, t_exit = pt._camera_rays(cv, w, h, pids)
            reach = torch.where(kern[3] >= 0, kern[0], t_exit)
            for k in ("camera_wl", "camera_wl_stats"):
                ops, leaf_bytes = sm.needed_work(
                    b2_form if k == "camera_wl" else k, lt, rows, words,
                    cv[9:12].unbind(), idir, reach)
                n_bytes = (sm.nbytes(cv, words, summ, floors, *kern)
                           + leaf_bytes + (sm.nbytes(st) if k != "camera_wl"
                                           else 0))
                out[f"{k} bound ms"] = sm.entry(0.0, 0.0, 0.0, n_bytes,
                                                ops)["bound_ms"]
            if scan:
                out["camera_wl scan"], _ = sm.camera_tally(
                    f"{kind}_{n}", cv, rows, lt, words, floors, kern, st)
            info = {}
            for k, (orig, d, tm, wrows, nodes) in waves.items():
                blocked, work = pt.walk_shadow(orig, d, tm, wrows, nodes), {}
                ref.walk_shadow_plain(orig, d, tm, wrows, nodes, work)
                ops, tree_bytes = sm.walk_work("walk_shadow", nodes, wrows,
                                               work)
                n_bytes = (sm.nbytes(orig) + tree_bytes
                           + sm.anyhit_bytes((), d, tm, None, blocked))
                live = tm >= 0
                info[k] = {
                    "live rays": int(live.sum()),
                    "blocked share": float(blocked[live].mean())
                    if bool(live.any()) else 0.0,
                    "bound ms": sm.entry(0.0, 0.0, 0.0, n_bytes,
                                         ops)["bound_ms"]}
                if scan:
                    info[k]["scan"] = sm.warp_tally(
                        f"{kind}_{n} nodes {k}", "walk_shadow", orig, d, tm,
                        wrows, nodes, None, blocked, by_live=True)
            out["walk_shadow wavefronts"] = info
            out["frame ms"] = {
                "fwd": frame_ms(lambda: render_frame(scene, cam, w, h, fwd)),
                "fwd low light": frame_ms(lambda: render_frame(
                    low, cam, w, h, fwd)) if kind in sm.LOW_LIGHT else None,
                "stats": frame_ms(lambda: render_frame_fast_stats(
                    scene, cam, w, h, fwd)),
                "walk fwd": frame_ms(lambda: render_frame(node, cam, w, h,
                                                          fwd)),
                "walk bounce": frame_ms(lambda: render_frame(
                    node, cam, w, h, RenderOpts(textures=False))),
                "walk stats": frame_ms(lambda: render_frame_fast_stats(
                    node, cam, w, h, fwd))}
        print(json.dumps(out), flush=True)
        del scene, node, waves, kern, srows, b4_waves
        torch.cuda.empty_cache()


# the camera kernels' scenes: (kind, size, leaf): node tables at the
# kind's leaf (B9a, B9e) or leaf 64 (B11a)
CAMERA = (("city", 24, None), ("terrain", 724, None), ("city", 24, 64),
          ("terrain", 530, 64))


def camera_scan(name, kernel, cv, rows, nodes, signs, kern, stats=None,
                seed=1):
    """The warps of B9a (B9e) or, with ``signs``, of B11a on SIM_PACKETS
    seeded packets of the 1024 x 1024 primary wavefront with hits,
    simulated as ``walk`` runs them (ops/traverse_ref.py ``_WarpWalk``)
    once with each warp footprint: 32 consecutive rays, and an 8 x 4
    pixel tile (ops/traverse.py ``camera_wl_order``). Prints the ``scan``
    lines of each (chip_smoke ``print_tally``: node steps, leaf visits,
    the lanes entering them and their rows) and whether the simulated
    outputs equal the kernel's, ``kern``, on those packets (dist, and
    every output) and its counters B9e's, ``stats``; the footprint of the
    tree's kernel is the one they equal. It drives ``_WarpWalk`` itself,
    as ops/traverse_ref.py ``camera_sim`` does, so that it also scans a
    tree older than ``camera_sim``. Returns {footprint: tally}."""
    import numpy as np
    import torch

    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref

    sm = smoke()
    busy = np.flatnonzero((kern[0] < BIG).any(1).cpu().numpy())
    pk = torch.from_numpy(np.sort(np.random.default_rng(seed).choice(
        busy, min(sm.SIM_PACKETS, len(busy)), replace=False))).to(cv.device)
    d, _, t_exit = pt._camera_rays(cv, WIDTH, HEIGHT, pk)
    out = {}
    for foot, order in (("32 x 1", torch.arange(pt.PACKET_R)),
                        ("8 x 4", pt.camera_wl_order())):
        order = order.to(cv.device)
        tiles = lambda c: c[:, order].reshape(-1)
        if signs is None:
            bound0, raw, rs = tiles(t_exit), False, None
        else:
            bound0 = torch.full_like(tiles(t_exit), BIG)
            raw, rs = True, ref._ray_signs(signs[pk], pt.PACKET_R)
        w = ref._WarpWalk(nodes, cv[9:12].unbind(), [tiles(c) for c in d],
                          bound0, rows, raw, True, rs)
        counts = w.run()
        back = lambda x: torch.empty(t_exit.shape, dtype=x.dtype,
                                     device=x.device).index_copy_(
            1, order, x.reshape(t_exit.shape))
        best, tri, u, v = (back(x) for x in (w.bound, w.tri, w.bu, w.bv))
        if signs is None:
            dist = torch.where(tri >= 0, best, BIG)
        else:
            dist, tri = best, tri.clamp_min(0)
        sim = (dist, u, v, tri.to(torch.int32))
        same = [torch.equal(a[pk], b) for a, b in zip(kern, sim)]
        tally = {"warps": w.tally.shape[1],
                 **dict(zip(pt.TALLY, w.tally.sum(1).tolist()))}
        sm.print_tally(f"{name} {foot}", kernel, pk, tally, True)
        print(f"scan {name} {foot} {kernel}: simulated dist equal to the "
              f"kernel's {same[0]}, every output {all(same)}"
              + ("" if stats is None else ", counters equal to B9e's "
                 f"{torch.equal(counts, stats[pk])}"), flush=True)
        out[foot] = {**tally, "dist equal": same[0],
                     "outputs equal": all(same)}
    return out


def time_camera(tree, reps: int, quick: bool = False,
                scan: bool = False) -> None:
    """B9a and B9e on the 1024 x 1024 primary wavefront of city_24 and
    terrain_724 with node tables, B11a on city_24 and terrain_530 at leaf
    64, each as the frame's ``camera_trace`` calls it: their device ms and
    a digest of their outputs (B9e's: its counters too); unless ``quick``,
    each one's bound (chip_smoke ``walk_work`` on its plain version's walk;
    B9e's with its counters' bytes, chip_smoke ``stats_entry``) and the
    walk fwd and counter frames or the fat fwd frame (CUDA events over 10
    frames); with ``scan``, ``camera_scan``'s lines."""
    import torch

    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref
    from snail_tpu_torch.render.fast import render_frame_fast_stats
    from snail_tpu_torch.render.renderer import render_frame
    from snail_tpu_torch.scene.bench_scenes import bench_scene

    sm = smoke()
    w, h = WIDTH, HEIGHT
    fwd = RenderOpts(reflections=False, transparency=False, textures=False)
    pids = torch.arange((w // pt.TILE) * (h // pt.TILE), device="cuda")
    for kind, n, leaf in CAMERA:
        scene, cam, _, _ = bench_scene(kind, n, bounce=True,
                                       walk=leaf is None, leaf=leaf)
        nodes = scene.nodes
        out = {"scene": f"{kind}_{n} {'leaf 64' if leaf else 'nodes'}",
               "tree": str(tree)}
        if leaf:
            cv = pt._camera_vec(scene, cam, w, h)
            rows, signs = scene.tri_rows, pt.camera_signs(cam, w, h)
            k, ins = "fat_camera", (cv, signs)
            call = lambda: pt.fat_camera(cv, w, h, signs, rows, nodes)
            plain = lambda work: ref.fat_camera_plain(cv, w, h, signs, rows,
                                                      nodes, pids, work)
        else:
            if hasattr(pt, "_camera_setup"):
                # a tree whose B9a takes the camera's shared-origin rows
                cv, rows = pt._camera_setup(scene, cam, w, h)
            else:
                cv, rows = pt._camera_vec(scene, cam, w, h), scene.tri_rows
            signs, k, ins = None, "walk_camera", (cv,)
            call = lambda: pt.walk_camera(cv, w, h, rows, nodes)
            plain = lambda work: ref.walk_camera_plain(cv, w, h, rows, nodes,
                                                       pids, work)
            b9e = lambda: pt.walk_camera_stats(cv, w, h, rows, nodes)
        kern = call()
        out[f"{k} ms"] = device_ms(call, reps)
        out[f"{k} digest"] = digest(*kern)
        out[f"{k} dist digest"] = digest(kern[0])
        st = None
        if not leaf:
            *e_out, st = b9e()
            out["walk_camera_stats ms"] = device_ms(b9e, reps)
            out["walk_camera_stats digest"] = digest(*e_out, st)
            out["walk_camera_stats equals walk_camera"] = all(
                torch.equal(a, b) for a, b in zip(e_out, kern))
        if not quick:
            work = {}
            plain(work)
            ops, tree_bytes = sm.walk_work(k, nodes, rows, work)
            base = sm.entry(0.0, 0.0, 0.0, sm.nbytes(*ins, *kern)
                            + tree_bytes, ops)
            out[f"{k} bound ms"] = base["bound_ms"]
            out[f"{k} bound by"] = base["bound_by"]
            if st is not None:
                out["walk_camera_stats bound ms"] = sm.stats_entry(
                    base, 0.0, 0.0, st, 0)["bound_ms"]
            if scan:
                out[f"{k} scan"] = camera_scan(
                    out["scene"], k, cv, rows, nodes, signs, kern[:4], st)
            frames = {("fat fwd" if leaf else "walk fwd"): lambda:
                      render_frame(scene, cam, w, h, fwd)}
            if not leaf:
                frames["walk stats"] = lambda: render_frame_fast_stats(
                    scene, cam, w, h, fwd)
            out["frame ms"] = {f: frame_ms(fn) for f, fn in frames.items()}
        print(json.dumps(out), flush=True)
        del scene, kern, call, plain
        torch.cuda.empty_cache()


def gather_calls(n: int = 724):
    """terrain_``n``'s bounce scene on the card and the three gathers of
    its supersampled 1024 x 1024 bounce frame, taken from the frame's own
    calls: (scene, camera, opts, [(dist, tri, cols)])."""
    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.render import fast
    from snail_tpu_torch.render.renderer import render_frame
    from snail_tpu_torch.scene.bench_scenes import bench_scene

    scene, cam, _, _ = bench_scene("terrain", n, bounce=True)
    opts = RenderOpts(textures=False, supersample=True)
    calls, gather = [], fast.surface_rows

    def record(sh_pack, dist, tri, cols):
        calls.append((dist.clone(), tri.clone(), tuple(cols)))
        return gather(sh_pack, dist, tri, cols)

    fast.surface_rows = record
    try:
        render_frame(scene, cam, WIDTH, HEIGHT, opts)
    finally:
        fast.surface_rows = gather
    return scene, cam, opts, calls


def gather_bytes(rows, n_rays: int, cols) -> tuple:
    """(bytes the gather needs, bytes the whole-row ``index_select``
    moves) for ``n_rays`` rays reading the sh_pack ``rows`` (R,): the
    32-byte sectors of each distinct row that hold a requested column,
    read once, 8 bytes of dist and tri a ray and 4 a column written; the
    library reads every distinct row whole once, an 8-byte index a ray,
    and writes 128 bytes a ray."""
    import torch

    distinct = int(torch.unique(rows).numel())
    sectors = sum(any(8 * s <= c < 8 * s + 8 for c in cols)
                  for s in range(4))
    need = distinct * 32 * sectors + n_rays * (8 + 4 * len(cols))
    return need, distinct * 128 + n_rays * (8 + 128)


def time_gather(reps: int) -> None:
    import torch

    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops.gather import surface_rows
    from snail_tpu_torch.render.renderer import render_frame

    scene, cam, opts, calls = gather_calls()
    sh = scene.sh_pack
    names = ("camera", "reflection", "glass")
    total = {"kernel_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "library_path_ms": 0.0}
    for name, (dist, tri, cols) in zip(names, calls):
        hit = (dist > 0.0) & (dist < BIG)
        idx = torch.where(hit, tri, 0).long()
        need, lib = gather_bytes(idx, dist.numel(), cols)
        out = surface_rows(sh, dist, tri, cols)
        same = torch.equal(out, sh.index_select(0, idx).T[list(cols)])
        row = {
            "wavefront": name, "rays": dist.numel(), "hits": int(hit.sum()),
            "cols": len(cols), "equal_to_library": same,
            "kernel_ms": device_ms(lambda: surface_rows(sh, dist, tri, cols),
                                   reps),
            "bound_ms": need / HBM_BPS * 1e3, "bound_bytes": need,
            "library_ms": device_ms(lambda: sh.index_select(0, idx), reps),
            "library_path_ms": device_ms(lambda: sh.index_select(
                0, torch.where((dist > 0.0) & (dist < BIG), tri, 0).long()),
                reps),
            "library_bytes": lib}
        for k in total:
            total[k] += row[k]
        print(json.dumps(row), flush=True)
    fms = frame_ms(lambda: render_frame(scene, cam, WIDTH, HEIGHT, opts))
    print(json.dumps({"wavefront": "frame", **total, "bounce_ss_frame_ms":
                      fms}), flush=True)


def copies(tree: Path, only: str, runs, reps: int) -> None:
    """Times ``only``'s kernels (``--quick``) in copies of ``tree``'s
    package, one per run of ``runs`` in turn, each by this script in a
    process of its own: ``runs`` is [(label, edits)], ``edits`` [(source
    in csrc, regex, replacement)], each regex matching once; each JSON
    line printed carries its label."""
    for label, edits in runs:
        with tempfile.TemporaryDirectory() as tmp:
            pkg = Path(tmp) / "snail_tpu_torch"
            shutil.copytree(tree / "snail_tpu_torch", pkg,
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            for name, pattern, repl in edits:
                src = pkg / "csrc" / name
                text, n = re.subn(pattern, lambda m: repl, src.read_text())
                if n != 1:
                    raise RuntimeError(f"{pattern!r} matched {n} times in "
                                       f"{src}")
                src.write_text(text)
            res = subprocess.run(
                [sys.executable, __file__, "--only", only, "--tree", tmp,
                 "--reps", str(reps), "--quick"], capture_output=True,
                text=True)
            if res.returncode:
                raise RuntimeError(f"{label}: {res.stderr}")
            for line in res.stdout.splitlines():
                if line.startswith("{"):
                    print(json.dumps({**label, **json.loads(line)}),
                          flush=True)


def sweep(tree: Path, only: str, values, reps: int) -> None:
    """The kernels of ``only`` with each lane-per-triangle threshold in
    ``values`` (LANE_TRI_MAX's constexprs set to it)."""
    copies(tree, only, [
        ({"lane_tri_max": t},
         [(name, rf"constexpr int {const} = \d+;",
           f"constexpr int {const} = {t};")
          for name, consts in LANE_TRI_MAX[only].items()
          for const in consts]) for t in values], reps)


def variants(tree: Path, names, reps: int) -> None:
    """The camera kernels with each of the VARIANTS ``names`` in turn
    ("none": the tree as it is)."""
    copies(tree, "camera", [
        ({"variant": v}, [(name, re.escape(old), new)
                          for name, old, new in VARIANTS.get(v, ())])
        for v in names], reps)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path,
                    default=Path(__file__).resolve().parent)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=("words", "closest", "anyhit",
                                       "shared", "camera", "gather"))
    ap.add_argument("--sweep", type=lambda v: [int(t) for t in v.split(",")])
    ap.add_argument("--variant", type=lambda v: v.split(","),
                    help="with --only camera, time these VARIANTS in turn "
                         "(none: the tree as it is)")
    # the kernels' times only (what the copies of a sweep print)
    ap.add_argument("--quick", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--scan", action="store_true",
                    help="with --only shared or camera, the scan lines of "
                         "the warps (the tree's simulations)")
    args = ap.parse_args()
    if args.variant and (args.only != "camera" or args.sweep or not set(
            args.variant) <= set(VARIANTS) | {"none"}):
        ap.error(f"--variant takes --only camera and names of "
                 f"{sorted(VARIANTS)} or none")
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {args.tree}", flush=True)
    if args.sweep:
        only = args.only or "closest"
        if only not in LANE_TRI_MAX:
            ap.error("--sweep times --only closest (the default), anyhit, "
                     "shared or camera")
        sweep(args.tree.resolve(), only, args.sweep, args.reps)
        return
    if args.variant:
        variants(args.tree.resolve(), args.variant, args.reps)
        return
    if args.only in (None, "words"):
        time_passes(args.tree, args.reps)
    if args.only in (None, "closest"):
        time_closest(args.tree, args.reps)
    if args.only in (None, "anyhit"):
        time_anyhit(args.tree, args.reps, args.quick)
    if args.only in (None, "shared"):
        time_shared(args.tree, args.reps, args.quick, args.scan)
    if args.only in (None, "camera"):
        time_camera(args.tree, args.reps, args.quick, args.scan)
    if args.only in (None, "gather"):
        time_gather(args.reps)


if __name__ == "__main__":
    main()
