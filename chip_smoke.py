#!/usr/bin/env python3
"""Smoke run of snail_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line:
1. the card (name and power limit from nvidia-smi);
2. the kernel build from snail_tpu_torch/csrc, with its seconds;
3. every kernel of the frames (B1-B8) against its plain PyTorch version on
   the card, at full frame size, on two scenes: city_scene(24) at leaf 16
   and terrain_scene(724) (~1 Mtri) at leaf 32, 1024 x 1024, both with
   material 0 reflective and half transparent (bench_scenes
   bounce_materials). B1, B2 and B8a run on the primary rays; B3, B4 and
   B8b on the frame's own shadow rays, and on the terrain also toward a
   low light, since its overhead bench light blocks no ray; B5 and B6 on
   the frame's own reflection rays, and on a seeded wavefront that hits
   where too few of those do; B7 on a seeded wavefront of shadow rays with
   their own origins, and on the instanced frame's own shadow wavefront
   (phase 4), each with the ``scan`` lines of its warps simulated on a few
   packets (ops/traverse.py ``shadow_wl_g_sim``: words and blocks
   entered, leaf visits by entering lanes, rows tested up to a stop; its
   verdicts the kernel's bit for bit). B4, B6 and B7 must equal their
   plain versions bit for bit (verdicts; dist, u, v and tri), B2 in dist, u and v wherever the
   triangle agrees, which may differ only on a distance tie, and B1, B3
   and B5 in their words, summaries and floors (and set no bit in a word
   whose box the pre-test drops; the ``passing`` lines give the word
   boxes that pass per packet); B1 on the primary rays, B3 on the shadow
   rays toward light 0 and B5 on the reflection rays also run on
   clusters of 1, 2, 4 and 8 blocks per packet, each equal to the plain
   version and timed (the ``cluster`` lines); B2, B4 and B6 print what
   their warps are given to scan (``scan_counts``: populated words, the
   words and blocks some lane enters, the leaves a warp cull keeps; B2's
   warps 8 x 4 pixel tiles); B8a and B8b, on the shared-origin rows of
   ``shared_rows`` where B2 and B4 take the raw triangle rows, must give
   B2's and B4's outputs bit for bit (the ``raw`` lines), and their
   counters must equal the plain versions' simulation of every warp on a
   few seeded packets; B2's simulated warps (ops/traverse.py
   ``camera_wl_sim``) must give its outputs bit for bit, ties included,
   with the ``scan`` lines of their leaf visits by entering lanes; the
   camera's ``shared_rows`` table is timed (the ``table`` line);
4. the paths at 1024 x 1024 on both scenes, each with the launch count of
   every kernel during one run, a check against the CPU path at 64 x 64
   (the terrain's lit by the low light), and its time: render_frame
   without bounces (fwd: ms/frame, MRays/s, peak memory); render_frame
   with reflections and transparency (bounce: the same); bench.py's
   fwd+bwd step (fwd_bwd: ms/step); the counter frame
   render_frame_fast_stats (stats: its image bit-identical to the fwd
   frame's, its counters, its ms/frame beside the fwd frame's); and the
   instanced frame render_instanced on a grid of rigid instances of the
   scene (bench_scenes.instanced_grid: 16 of city_24, fwd and bounce
   options; 4 of terrain_724, fwd), where the camera must see every
   instance and some instances hide others; every frame that shades
   through render/fast.py must launch the hit-row gather S1
   (csrc/shade.cu ``surface_gather_kernel``), the instanced frame (its
   own rows), the step and the portable frame none; on the terrain, the
   supersampled bounce frame (bounce_ss: the benchmark's
   terrain_1m.bounce_ss frame, 2048^2 rays a wavefront), its launches
   from its own run, and S1 bit for bit its plain version on each of its
   three gathers (camera, reflection, glass; recorded from the frame's
   calls), timed beside its bound and the whole-row ``index_select`` it
   replaced (the ``gather`` lines; ``library_ms`` in the kernels line);
5. the walk kernels B9a-d (csrc/walk.cu) against their plain versions
   (ops/traverse_ref.py) on both scenes rebuilt with node tables
   (``walk=True``; the terrain's ~88.5k nodes are more than the 24,576 of
   the TPU's node cap, so the check is also the parity of the paged
   B10a-d that the same kernels cover), each over its whole wavefront:
   B9a on the primary rays, B9b on the frame's shadow rays (and the
   terrain's toward the low light), B9c on the frame's reflection rays and
   on a seeded wavefront, B9d on the instanced frame's own shadow
   wavefront (taken from the frame's calls: the first instance's with a
   blocked ray) and on a seeded shadow wavefront with its own origins; on
   the reflection rays B9c's warps, on B9b's shadow wavefronts its own
   and on both of B9d's shadow wavefronts B9d's, on a few seeded
   packets, simulated (their outputs the kernel's bit for bit), with the
   tally of their leaf visits by entering lanes (the ``scan`` lines; for
   the any-hits also the rows their lanes tested up to their first
   occluder);
   closest hits equal bit for bit where the triangle agrees, the triangle
   differing only on a distance tie, verdicts identical; and the
   walk's counting kernels B9e/B9f on B9a's and B9b's inputs: their
   outputs B9a's and B9b's bit for bit, their counters on a few seeded
   packets equal to the plain versions' simulation of every warp; then the
   ratios B2/B9a, B6/B9c and B4/B9b of kernel times on the same
   wavefronts, and B1's, B3's and B5's times beside their bounds;
6. the walk paths at 1024 x 1024: the fwd, bounce and instanced fwd
   frames of the walk scenes, launching walk kernels only, each checked
   against the CPU path at 64 x 64 and timed, the fwd and bounce frames
   also against the same scene's worklist frame (within 2e-3 on >= 99.8 %
   of pixels); the walk counter frame (B9e/B9f: as phase 4's, beside the
   walk fwd frame); and the portable path: render_frame at 1280 x 720
   (not a multiple of the tile: the integrator and the dispatch seam),
   fwd and bounce on both leaf-table scenes and the walk terrain, with
   launches, a check against the CPU path at 80 x 48 and ms/frame, and on
   city_24 one fwd+bwd step of the portable fwd frame (ms/step, gradients
   on the card against the CPU path at 48 x 32);
7. the fat-leaf path on each kind's scene built at leaf 64 (node tables,
   leaves of 33-64 triangles): city_scene(24) and terrain_scene(530),
   ~0.56 Mtri, whose tree is the largest the TPU's B11 took (at most
   24,576 nodes), each with material 0 reflective: B11a-d (csrc/fat.cu) against
   their plain versions over whole wavefronts, as phase 5 (B11a on the
   primary rays, B11c on the shadow rays and on the bounce frame's own
   shadow wavefronts, taken from its calls: the first with a blocked live
   ray, on the terrain lit by the low light, each with the ``scan`` lines
   of its warps, B11b on the reflection rays and
   a seeded wavefront, B11d on the instanced frame's own shadow wavefront
   and on seeded shadow rays, the rays as the caller gave them); then the
   fat fwd, bounce, fwd_bwd, instanced fwd and portable fwd frames,
   launching fat-leaf kernels only, each checked
   against the CPU path at small size, against the same geometry's frame
   on leaf tables (leaf 16 / 32; the step by its loss) and timed;
8. textured frames (bench.py's ``section_tex``: ``checker_atlas`` on
   every material, with its summed-area tables) on both phase-4 scenes:
   the mip levels of the primary hits' texture samples (the terrain's
   must span more than one), then the fwd frame with each filter (point,
   bilinear, sat), each as a phase-4 path (launches of B1-B4, a 64 x 64
   frame against the CPU path, ms/frame, MRays/s), the share of hit
   pixels whose colour the atlas changes (> 0), and its ms/frame beside
   the untextured fwd frame's, timed in turns; the textured terrain
   bounce frame, the textured portable 1280 x 720 and instanced x16 city
   frames, each beside its untextured twin; and a loaded scene:
   city_scene(24) written as an OBJ (three ``usemtl`` groups) and an MTL
   (Kd, Ks, one ``d 0.5``) into a temporary directory, loaded twice by
   ``load_scene`` through its geometry and BVH cache (cold, then cached:
   seconds each, the second scene's tables equal to the first's), and its
   fwd frame on leaf tables (B1-B4) and on node tables (B9a/B9b);
9. photons on both phase-4 scenes, from their bench light: trace_photons
   with 2^20 photons (as many as the frame's primary rays) on leaf and
   node tables (hits, ms on the host clock, launches), B5/B6 and B9c
   against their plain versions on 64 sampled packets (a quarter; B9c's
   tally as in phase 5) of the
   photon wavefront and each kernel's time on the whole of it, photon_grid
   at res 64 (host seconds, bytes on the card), the fwd frame with the photon
   term on leaf and node tables as a phase-4 path, its delta over the
   frame without photons equal to diffuse x |d.n| x the gathered
   irradiance x exposure on the primary hits, and its ms beside that
   frame's in turns; on the city the portable 1280 x 720 bounce frame with
   photons (its bounces gather too); render_photon_preview at 1024 x 1024;
   and the grid's gather correlated with the kd oracle's (> 0.5) on 48
   points of a 2^14-photon map;
10. the volume viewer: synthetic_sphere(512) (a CT series of 512 slices
   of 512 x 512, 512 MiB float32 on the card) and the same with a constant
   border shell; V1 (csrc/volume.cu) against its plain version on the
   viewer's 512 x 512 rays, bit for bit in best and hit_t, iso and mip, on
   both volumes, at the viewer's max_steps and at one that cuts rays off;
   on the border volume the mip rays that miss the volume take the shell's
   value from their extra sample (ROADMAP C19); V1's ms beside its bound
   and its plain version's; render_volume iso and mip at 512 x 512 (V1's
   launches: march_kernel, and in mip mode mip_extra_kernel too; ms/frame,
   peak memory), a 64 x 64 frame of a 128^3 sphere
   against the CPU path; and a DICOM series of 64 slices of 512 x 512
   written with write_dicom_file, read back equal by load_dicom_dir, and
   its iso frame;
11. the apps: the render server (apps.server ``serve``) on the card in a
   thread, on 127.0.0.1 at a free port, serving phase 8's city OBJ + MTL;
   the native codec built; the client (apps.client ``run_client``) at
   1024 x 1024, 4 frames on its orbit, then a session of 1 frame with the
   stats toggle (gVals[2]); each assembled frame equal to to_rgb8 of the
   port's render_frame (the stats frame's: render_frame_fast_stats's) of
   the request's camera bit for bit, the stats frame's counters equal to
   tree_stats_from_counters of the counter frame's; per frame the
   client's ms, the server's render_ms and encode_ms and the KB of its
   parts; the host syncs of the frame loop's work for one frame (camera,
   lights, render_frame) under torch.cuda.set_sync_debug_mode (none
   allowed); then rtracer's main for one 1024 x 1024 frame, its PNG equal
   to Renderer.render's frame of the same camera;
12. torch.distributed at world size 1: a NCCL process group of one rank
   on a file:// store; render_frame_sharded at 512 x 512 on city_24
   (bounces on) bit for bit against render_frame_portable, and one
   train_step_sharded (tri_a and mat_diffuse) bit for bit against the
   same step without a process group; the sharded frame's ms beside the
   portable frame's, in turns; scaling_report at 1 device; the group is
   destroyed at the end;
13. bench.py's 10 Mtri row (``section_10m``; bench_scenes.scene_10m):
   terrain_scene(2236), 9,999,392 triangles at leaf 32, its generation
   and BVH built on the host while no card phase runs (gen_s, build_s;
   pack_s of the device scene), on leaf tables (B1-B4) and on node
   tables (B9a/B9b, covering the paged B10a/B10b): B1, B2, B3 and B4
   against their plain versions on 16 seeded packets (B4 toward light 0
   and toward the low light, where rays are blocked), B9a and B9b over
   their whole wavefronts; 1,024 seeded primary rays against the brute
   force over every triangle (tools/bench_big.py's oracle spot check); B2
   and B4 bit for bit B8a and B8b on the shared-origin rows, and the time
   of a ``shared_rows`` table; then the fwd frame at 1024 x 1024 on
   each table kind, launching only its path's kernels, ms/frame by CUDA
   events around each of 10 frames (min/avg/max), MRays/s by bench.py's
   count (2 W H), peak memory, the two frames within 2e-3 of each other
   on >= 99.8 % of pixels; the ``row`` line gathers the numbers.

The last two lines are a JSON object per kernel (all 19 traversal kernels
of the port per scene, V1 in iso and mip mode, and the six of the 10 Mtri
frames; the
city_24 kernels' ``launches_by_path`` also count phases 11 and 12's
paths: ``served``, ``served_stats``, ``rtracer``, ``sharded``,
``sharded_step``) and the result line.
Every kernel's line gives its time beside its bound: the larger of the
bytes it must move (each input read once, each output written once) over
the card's memory rate and the float operations of the tests its wavefront
needs over the card's float32 rate (``needed_work``; a trace kernel's
bytes count only the leaves its rays enter, a words pass's work only the
word boxes and the leaves of the words whose box passes its packet's
test). Each phase prints the seconds since the start. Any failed phase
ends the run with a non-zero exit and no result line; so does a machine
without a CUDA device or a directory without the package.
"""

import dataclasses
import json
import subprocess
import sys
import time


WIDTH = HEIGHT = 1024
TIMED_FRAMES = 10
INSTANCED_FRAMES = 3  # an instanced bounce frame takes ~0.2 s
TIMED_STEPS = 5
KERNEL_REPS = 20
CLUSTERS = (1, 2, 4, 8)  # blocks per packet of the words passes, timed
SIM_PACKETS = 3  # seeded packets whose counters are simulated
SRC = "snail_tpu_torch/csrc/worklist.cu"
WALK_SRC = "snail_tpu_torch/csrc/walk.cu"
FAT_SRC = "snail_tpu_torch/csrc/fat.cu"
VOL_SRC = "snail_tpu_torch/csrc/volume.cu"
GATHER_SRC = "snail_tpu_torch/csrc/shade.cu"
# V1 replaces the JAX volume march, a lax.while_loop, not a Pallas kernel
VOL_REPLACES = "snail_tpu/volume/vtree.py:116"
TPU = "snail_tpu/ops/traverse_pallas.py"
REPLACES = {  # kernel -> line of the Pallas kernel it replaces
    "words_camera": f"{TPU}:2785",
    # B2 and B4: the kernels with raw=True, and their raw-row drains
    "camera_wl": f"{TPU}:3150, {TPU}:2057",
    "words_shared": f"{TPU}:2822",
    "shadow_wl": f"{TPU}:3208, {TPU}:2104",
    "words_general": f"{TPU}:2834",
    "closest_wl_g": f"{TPU}:3226",
    "shadow_wl_g": f"{TPU}:3272",
    "camera_wl_stats": f"{TPU}:3160",
    "shadow_wl_stats": f"{TPU}:3217",
    # the B9 kernel, and the paged B10 twin it also covers
    "walk_camera": f"{TPU}:1809, {TPU}:1828",
    "walk_shadow": f"{TPU}:1901, {TPU}:1918",
    "walk_closest_g": f"{TPU}:2178, {TPU}:2199",
    "walk_shadow_g": f"{TPU}:2255, {TPU}:2274",
    "walk_camera_stats": f"{TPU}:1852",
    "walk_shadow_stats": f"{TPU}:1940",
    "fat_camera": f"{TPU}:588",
    "fat_closest": f"{TPU}:643",
    "fat_shadow": f"{TPU}:720",
    "fat_shadow_g": f"{TPU}:731",
    # S1 replaces the frame's jnp take of sh_pack rows, not a Pallas kernel
    "surface_rows": "snail_tpu/render/fast.py:130",
}
FORWARD = ("words_camera", "camera_wl", "words_shared", "shadow_wl")
# the hit-row gather, which every frame shading through render/fast.py
# launches on every table kind (not the instanced frame, the step or the
# portable frame, which gather their own rows)
GATHER = ("surface_rows",)
BOUNCE = FORWARD + ("words_general", "closest_wl_g")
STATS = ("words_camera", "camera_wl_stats", "words_shared", "shadow_wl_stats")
INSTANCED = ("words_general", "closest_wl_g", "shadow_wl_g")
WALK = ("walk_camera", "walk_shadow", "walk_closest_g", "walk_shadow_g",
        "walk_camera_stats", "walk_shadow_stats")
WALK_FWD = WALK[:2]
WALK_BOUNCE = WALK[:3]
WALK_INSTANCED = WALK[2:4]
WALK_STATS = WALK[4:]
FAT = ("fat_camera", "fat_closest", "fat_shadow", "fat_shadow_g")
FAT_FWD = ("fat_camera", "fat_shadow")
FAT_BOUNCE = FAT[:3]
FAT_INSTANCED = ("fat_closest", "fat_shadow_g")
# the fat-leaf scenes: kind -> size, built at leaf LEAF_PAD; the terrain's
# tree is the largest the TPU's B11 took (SMEM_NODE_CAP, 24,576 nodes):
# terrain_scene(530), 561,800 triangles, 24,399 nodes (531 and 532 have
# 24,589 and 24,597); the small CPU-path check's scene, as the others'
FAT_N = {"city": 24, "terrain": 530}
FAT_SMALL_N = {"city": 24, "terrain": 64}
# the kernels the portable frame reaches through the dispatch seam
PORTABLE = {"leaves": ("words_general", "closest_wl_g", "words_shared",
                       "shadow_wl"),
            "nodes": ("walk_closest_g", "walk_shadow"),
            "fat": ("fat_closest", "fat_shadow")}
PORTABLE_SIZE = (1280, 720)
PORTABLE_SMALL = (80, 48)
PORTABLE_STEP_SMALL = (48, 32)
PORTABLE_FRAMES = 3
# the path whose launches a kernel's line reports
PATH_OF = {**{k: "bounce" for k in BOUNCE}, "shadow_wl_g": "instanced_fwd",
           "camera_wl_stats": "stats", "shadow_wl_stats": "stats",
           **{k: "walk_bounce" for k in WALK_BOUNCE},
           "walk_shadow_g": "walk_instanced_fwd",
           **{k: "walk_stats" for k in WALK_STATS},
           **{k: "fat_bounce" for k in FAT_BOUNCE},
           "fat_shadow_g": "fat_instanced_fwd", "surface_rows": "bounce_ss"}
# kind -> a low light for the blocked-ray checks of B3/B4 and of the small
# frame: the terrain's bench light is overhead and its hills cast no
# shadow toward it (~20 % of the frame's shadow rays toward this light are
# blocked on terrain_scene(128))
LOW_LIGHT = {"terrain": (-80.0, 20.0, 0.0)}
# kind -> instances per side of the instanced frame's grid, and its paths;
# the terrain's overhead light blocks few of its shadow rays, so B7's
# blocked share is held to 0.02-0.98 on the city's instanced wavefront and
# on both scenes' seeded ones
INSTANCE_GRID = {"city": (4, ("fwd", "bounce")), "terrain": (2, ("fwd",))}
TEX_FILTERS = ("point", "bilinear", "sat")
# phase 9: photons per light (as many as the frame's primary rays), runs of
# trace_photons timed, packets of the photon wavefront held against the
# plain versions, launches per kernel time on the whole wavefront, the
# grid's resolution, and the photons of the kd oracle's map
PHOTONS = 2 ** 20
PHOTON_TRACES = 3
PHOTON_PACKETS = 64
PHOTON_REPS = 5
PHOTON_RES = 64
PHOTON_KD_N = 2 ** 14
# phase 10: the sphere's size (a CT series of 512 slices of 512 x 512), the
# viewer's frame and threshold, the march's step limits (the viewer's, and
# one that cuts rays off), the border shell's value (below the threshold,
# above 0), the DICOM series' slices
VOLUME_N = 512
VOLUME_SIZE = (512, 512)
VOLUME_ISO = 0.05
MARCH_MAX_STEPS = 2048
MARCH_CUT_STEPS = 24
BORDER_VALUE = 1500
DICOM_SLICES = 64
# V1's bound: per ray d (12 bytes), t0, t1 in and best, hit_t out (8 + 8),
# and once the origin the frame's rays share (12); float operations of a
# step, counted in csrc/volume.cu
MARCH_RAY_BYTES = 28
MARCH_ORIGIN_BYTES = 12
MARCH_OPS = {"skip": 47, "sample": 50}
# phase 11: frames of the client's first session, and the longest wait for
# the server thread; phase 12: the sharded frame's size
APPS_FRAMES = 4
APPS_TIMEOUT_S = 120
SHARDED_SIZE = 512
# phase 13: bench.py's 10 Mtri scene; seeded packets of its wavefronts
# held against the plain B1-B4 versions (a plain pass over all 256 would
# take minutes), primary rays of the brute-force spot check and the
# triangles of each of its steps, and its share of spot-check rays that
# must agree (tools/bench_big.py's rule)
PACKETS_10M = 16
ORACLE_RAYS = 1024
ORACLE_TRIS = 1 << 16
ORACLE_AGREE = 0.995
# the loaded scene's materials: every 12 faces (a box) take the next
LOADED_MTL = """newmtl concrete
Kd 0.7 0.7 0.65
Ks 0.2 0.2 0.2
newmtl glass
Kd 0.3 0.5 0.8
Ks 0.6 0.6 0.6
d 0.5
newmtl roof
Kd 0.8 0.3 0.2
"""

# The card's peak rates (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_MS = 3.35e9  # 3.35 TB/s
F32_OPS_PER_MS = 67e9  # 67 TFLOP/s float32 outside the tensor cores
# Float operations of one test, counted from csrc/worklist.cu (adds,
# multiplies, divides, min/max and compares alike): a words pass's
# interval test of one leaf per packet (leaf_entry: one origin, or an
# origin interval's four corner products) and its set-up per ray (the
# camera's includes the raygen); one ray's slab test of a leaf box
# (ray_slab); one ray-triangle test of each trace kernel (shared-origin
# or raw rows, closest or any hit).
LEAF_OPS = {"words_camera": 45, "words_shared": 45, "words_general": 87}
RAY_OPS = {"words_camera": 61, "words_shared": 14, "words_general": 20}
SLAB_OPS = 25
TRI_OPS = {"camera_wl": 56, "shadow_wl": 49, "closest_wl_g": 56,
           "shadow_wl_g": 49, "camera_wl_stats": 29, "shadow_wl_stats": 22}
# the walk and fat-leaf kernels test triangles with the same device
# functions, every one on the raw rows
TRI_OPS.update(walk_camera=56, walk_shadow=49, walk_closest_g=56,
               walk_shadow_g=49, walk_camera_stats=56, walk_shadow_stats=49,
               fat_camera=56, fat_closest=56, fat_shadow=49, fat_shadow_g=49)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def words_ms(fn):
    """A words pass's ms: its mean device time over KERNEL_REPS launches
    queued behind a spin (time_words.py ``device_ms``: the host's time
    between launches, longer than the kernel's, does not count), and
    beside it the CUDA events' ms of ``cuda_ms``, which it does."""
    from time_words import device_ms

    return device_ms(fn, KERNEL_REPS), cuda_ms(fn, KERNEL_REPS)


def make_scene(kind: str, n: int):
    """A benchmark scene of bench.py on the card (scene/bench_scenes.py):
    (scene, camera, geometry, BVH)."""
    from snail_tpu_torch.scene.bench_scenes import SCENES, bench_scene

    t0 = time.perf_counter()
    scene, cam, g, bvh = bench_scene(kind, n, bounce=True)
    print(f"scene {kind}_{n}: {g.num_tris} tris, {scene.leaves.n_leaf} "
          f"leaves (leaf {SCENES[kind][1]}), host build "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return scene, cam, g, bvh


def walk_twin(name, scene, g, bvh):
    """``scene`` rebuilt on its geometry, BVH, material table and lights
    with node tables for the walk kernels in place of leaf tables."""
    from snail_tpu_torch.scene.bench_scenes import bounce_materials
    from snail_tpu_torch.scene.scene import make_traced_scene

    t0 = time.perf_counter()
    walk = make_traced_scene(g, bvh, bounce_materials(), lights=scene.lights,
                             device=scene.device, walk=True)
    print(f"scene {name} walk: {walk.nodes.n_nodes} nodes, depth "
          f"{walk.nodes.depth}, host build {time.perf_counter() - t0:.2f} s",
          flush=True)
    return walk


def timed_plain(fn):
    """Result of one call of fn, and its host ms."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def entry(err, ms, plain_ms, n_bytes, ops, **extra):
    """One kernel's numbers, with its bound: the larger of its bytes over
    the card's memory rate and its operations over its float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **extra}


def words_entry(kernel, err, ms, plain_ms, lt, planes, out, tested,
                event_ms):
    """The entry of a words pass (``ms`` its device time, ``event_ms`` its
    CUDA events' time): its work is its set-up per ray and, per packet,
    one test of every word box and one of each leaf of a word that passes
    (``tested``: bool (P, Lp/32), the words whose box passes the packet's
    test: ``camera_word_tests``, ``shared_word_tests``,
    ``general_word_tests``), with the boxes of the leaves some packet
    tests read once; ``bound_every_leaf_ms`` is the bound of one interval
    test of every leaf per packet, the work of a pass without the
    pre-test."""
    import torch

    from snail_tpu_torch.ops.traverse import PACKET_R, WARP

    p = out[0].shape[0]
    ray_ops = p * PACKET_R * RAY_OPS[kernel]
    every = entry(err, ms, plain_ms, nbytes(*planes, lt.box, *out),
                  p * lt.n_leaf * LEAF_OPS[kernel] + ray_ops)
    n_words = -(-lt.n_leaf // WARP)
    per_word = (lt.n_leaf - WARP * torch.arange(n_words, device=lt.box.device)
                ).clamp(0, WARP)
    tested = tested[:, :n_words]
    leaves = int((tested * per_word).sum())
    read = int((tested.any(0) * per_word).sum())
    ops = (p * n_words + leaves) * LEAF_OPS[kernel] + ray_ops
    n_bytes = (nbytes(*planes, *out) + n_words * nbytes(lt.wbox[:, 0])
               + read * nbytes(lt.box[:, 0]))
    return entry(err, ms, plain_ms, n_bytes, ops, event_ms=event_ms,
                 bound_every_leaf_ms=every["bound_ms"])


def root_exit(lt, o, idir):
    """Each ray's exit distance from the scene's root box, as the kernels'
    box_exit (0 where it misses)."""
    import torch

    from snail_tpu_torch.ops import traverse as pt

    t1 = [(lt.root[k] - o[k]) * idir[k] for k in range(3)]
    t2 = [(lt.root[3 + k] - o[k]) * idir[k] for k in range(3)]
    tn, tf = pt._slab(t1, t2)
    return torch.where((tn <= tf) & (tf > 0.0), tf * 1.0001, 0.0)


def needed_work(kernel, lt, rows, words, o, idir, reach, n_blocked=0,
                tally=None):
    """The work a trace kernel's wavefront needs, as (float operations,
    bytes of leaf data). Operations: for each ray, the slab tests of the
    leaves of its packet's words whose box it enters before ``reach`` (P,
    PACKET_R; -inf for a ray that needs none) and the ray-triangle tests
    of those leaves' triangles; one of each for each of the ``n_blocked``
    rays that an any-hit finds blocked. Bytes: the box, first and count of
    every leaf some ray enters and its triangles' ``rows``, each read
    once (a blocked ray's blocker may lie in a leaf another ray enters, so
    it adds none). ``o``: three 0-d tensors (one origin) or three (P,
    PACKET_R) planes. With ``tally`` (a dict), adds to its "leaves
    entered" the (leaf, warp) pairs in which some lane enters the leaf."""
    import torch

    from snail_tpu_torch.ops import traverse as pt

    slab = torch.zeros((), dtype=torch.int64, device=reach.device)
    tri = torch.zeros_like(slab)
    pairs = torch.zeros_like(slab)
    entered = torch.zeros(lt.lp, dtype=torch.bool, device=reach.device)
    for i in range(words.shape[0]):
        leaves = torch.nonzero(pt.unpack_bits(words[i]).any(0)).flatten()
        oi = [c if c.dim() == 0 else c[i] for c in o]
        ii = [c[i] for c in idir]
        for s in range(0, len(leaves), 16384):
            ls = leaves[s:s + 16384]
            tn, tf = pt._leaf_slab(lt, oi, ii, ls)
            enter = (tn <= tf) & (tf > 0.0) & (tn < reach[i][:, None])
            slab += enter.sum()
            tri += (enter * lt.count[ls]).sum()
            entered[ls] |= enter.any(0)
            pairs += enter.reshape(pt.WARPS, pt.WARP, -1).any(1).sum()
    if tally is not None:
        tally["leaves entered"] = tally.get("leaves entered", 0) + int(pairs)
    ops = ((int(slab) + n_blocked) * SLAB_OPS
           + (int(tri) + n_blocked) * TRI_OPS[kernel])
    leaf_bytes = (lt.box.shape[0] * lt.box.element_size()
                  + lt.first.element_size() + lt.count.element_size())
    n_bytes = (int(entered.sum()) * leaf_bytes + int(lt.count[entered].sum())
               * rows.shape[1] * rows.element_size())
    return ops, n_bytes


def scan_counts(lt, words, summ, o, d, idir, lim, reach):
    """What the word lists of a trace wavefront give its warps to scan, in
    plain torch from the wavefront and the tables, at each warp's starting
    limits (B4 and B6 as csrc/worklist.cu ``scan_boxes`` describes them;
    B2 keeps the word scan, whose leaf-level cull drops what they skip):
    per warp, the packet's populated (band, word) pairs (the words every
    warp of the packet scans band by band); its populated words and
    blocks, and those whose word or block box some lane enters before its
    limit ``lim`` (P, PACKET_R); the words whose box the warp's cull keeps
    (the warp cull from the lanes' ``reach``, the warp's bound the largest
    reach); and the leaves its cull keeps. ``o``: three 0-d tensors (one
    origin) or three (P, PACKET_R) planes. Returns {count: sum over the
    wavefront's warps}."""
    import torch

    from snail_tpu_torch.ops import traverse as pt

    lanes = lambda x, i: x[i].reshape(pt.WARPS, pt.WARP)
    tally = dict.fromkeys(("warps", "band words", "words", "words culled in",
                           "words entered", "blocks", "blocks entered",
                           "leaves kept"), 0)

    def entered(box, cols, oi, ii, li):
        # (WARPS, len(cols)): some lane's slab test passes before its limit
        tn, pas = pt._box_slab(box[:, cols], slice(None),
                               [c[..., None] for c in oi],
                               [c[..., None] for c in ii])
        return (pas & (tn < li[..., None])).any(1)

    for i in range(words.shape[0]):
        oi = [c if c.dim() == 0 else lanes(c, i) for c in o]
        di, ii = [lanes(c, i) for c in d], [lanes(c, i) for c in idir]
        li, ri = lanes(lim, i), lanes(reach, i)
        cull = pt._warp_cull_sim(oi, di, ii, ri)
        mb = ri.clamp_min(0.0).amax(1)
        ws = torch.nonzero(words[i].ne(0).any(0)).flatten()
        bs = torch.nonzero(summ[i].ne(0).any(0)).flatten()
        ls = torch.nonzero(pt.unpack_bits(words[i]).any(0)).flatten()
        n = pt.WARPS
        tally["warps"] += n
        tally["band words"] += n * int(words[i].ne(0).sum())
        tally["words"] += n * len(ws)
        tally["blocks"] += n * len(bs)
        tally["words culled in"] += int(pt._warp_keeps_sim(
            lt.wbox, ws, cull, mb).sum())
        tally["words entered"] += int(entered(lt.wbox, ws, oi, ii, li).sum())
        tally["blocks entered"] += int(entered(lt.bbox, bs, oi, ii, li).sum())
        tally["leaves kept"] += int(pt._warp_keeps_sim(lt.box, ls, cull,
                                                       mb).sum())
    return tally


def print_scan(name, kernel, tally):
    """The counts of ``scan_counts`` (and needed_work's), per warp."""
    n = max(tally["warps"], 1)
    print(f"scan {name} {kernel}: per warp (mean of {tally['warps']}): "
          + ", ".join(f"{k} {v / n:.2f}" for k, v in tally.items()
                      if k != "warps"), flush=True)


def words_err(kern, plain, name):
    """A words pass's words, summaries and floors must be identical to
    the plain version's; returns the floors' max abs error, 0."""
    import torch

    kw, ks, kf = kern
    pw, ps, pf = plain
    bad = int((kw != pw).sum()) + int((ks != ps).sum())
    if bad:
        fail(f"{name}: {bad} words differ from the plain version")
    if not torch.equal(kf, pf):
        fail(f"{name}: {int((kf != pf).sum())} band floors differ from the "
             "plain version")
    return 0.0


def print_passing(name, kernel, tested):
    """The word boxes that pass per packet (``tested``: bool (P, Lp/32)):
    median, p99 and max."""
    import torch

    n = tested.sum(1).float()
    q = torch.quantile(n, torch.tensor([0.5, 0.99], device=n.device))
    print(f"passing {name} {kernel}: word boxes passing per packet: mean "
          f"{float(n.mean()):.1f}, median {float(q[0]):.1f}, p99 "
          f"{float(q[1]):.1f}, max {int(n.max())} of {tested.shape[1]} "
          f"words, over {tested.shape[0]} packets", flush=True)


def sweep_clusters(name, kernel, run, plain):
    """The words pass ``kernel`` over clusters of each size in CLUSTERS
    (``run(cluster)``): outputs identical to the plain version's
    (``plain``) at each, and its device ms, timed in turns (1, 2, 4, 8, 8,
    4, 2, 1); prints a ``cluster`` line. Returns {size: mean ms}."""
    from snail_tpu_torch.ops import traverse as pt

    from time_words import device_ms

    for c in CLUSTERS:
        words_err(run(c), plain, f"{name} {kernel} cluster {c}")
    times = {c: [] for c in CLUSTERS}
    for c in CLUSTERS + CLUSTERS[::-1]:
        times[c].append(device_ms(lambda: run(c), KERNEL_REPS))
    print(f"cluster {name} {kernel}: outputs identical at every size; "
          + ", ".join(f"{c} blocks {sum(t) / 2:.4f} ms ("
                      + " / ".join(f"{x:.4f}" for x in t) + ")"
                      for c, t in times.items())
          + f"; kept {pt.WORDS_CLUSTER[kernel]}", flush=True)
    return {c: sum(t) / 2 for c, t in times.items()}


def sample_packets(stats, seed):
    """SIM_PACKETS seeded packets among those whose warps tested
    triangles."""
    import numpy as np
    import torch

    busy = torch.nonzero(stats[:, 3] > 0).flatten().cpu().numpy()
    if len(busy) < 2:
        fail(f"only {len(busy)} packets tested triangles")
    pick = np.random.default_rng(seed).choice(
        busy, min(SIM_PACKETS, len(busy)), replace=False)
    return torch.from_numpy(np.sort(pick)).to(stats.device)


def check_counters(name, stats, pk, sim):
    """The kernel's counter rows of packets ``pk`` against the plain
    version's simulation of their warps: equal in every slot."""
    import torch

    if not torch.equal(stats[pk], sim):
        fail(f"{name}: counters of packets {pk.tolist()} differ from the "
             f"simulation:\n{stats[pk].tolist()}\n{sim.tolist()}")
    print(f"check {name}: counters of packets {pk.tolist()} equal the "
          f"simulation: {sim[:, :5].tolist()}", flush=True)


def camera_tally(name, cv, rows, lt, words, floors, kern, stats, seed=1):
    """B2's (B8a's) warps on SIM_PACKETS seeded packets of the 1024 x 1024
    primary wavefront whose warps tested triangles (``sample_packets`` of
    B8a's counters ``stats``), simulated as the kernel scans
    (ops/traverse.py ``camera_wl_sim``): their outputs must equal B2's,
    ``kern``, bit for bit and their counters B8a's; prints ``scan`` lines
    per warp (words at the leaf level, leaves its cull keeps, leaf visits
    by entering lanes and their rows). Returns (the tally's sums, the
    packets simulated)."""
    import torch

    from snail_tpu_torch.ops import traverse as pt

    pk = sample_packets(stats, seed)
    out, sim, tal = pt.camera_wl_sim(cv, WIDTH, HEIGHT, rows, lt,
                                     words[pk], floors[pk], pk)
    check_counters(f"{name} camera_wl_stats", stats, pk, sim)
    if not all(torch.equal(a[pk], b) for a, b in zip(kern, out)):
        fail(f"{name} camera_wl: the simulation's outputs on packets "
             f"{pk.tolist()} differ from the kernel's")
    tally = {"warps": tal.shape[1], "words": int(tal[0].sum()),
             "leaves kept": int(sim[:, 1].sum()),
             **dict(zip(pt.TALLY[1:], tal[1:].sum(1).tolist()))}
    print_tally(name, "camera_wl", pk, tally, True)
    return tally, len(pk)


def camera_work(name, kernel, cv, rows, lt, words, summ, floors, kern,
                scan=True):
    """B2's (B8a's) work on a whole 1024 x 1024 primary wavefront: (its
    float operations, its bytes, the ``scan_counts`` tally), each warp's
    rays an 8 x 4 pixel tile as the kernel takes them, each ray's tests
    up to its hit ``kern``; prints the ``scan`` line. Without ``scan``,
    no tally (None)."""
    import torch

    from snail_tpu_torch.ops import traverse as pt

    p = words.shape[0]
    pids = torch.arange(p, device=words.device)
    kd, kt = kern[0], kern[3]
    tile = lambda x: x[:, pt.camera_wl_order().to(x.device)]
    d, idir, t_exit = (tuple(map(tile, x)) if isinstance(x, list)
                       else tile(x) for x in pt._camera_rays(
                           cv, WIDTH, HEIGHT, pids))
    o = cv[9:12].unbind()
    tally = None
    if scan:
        tally = scan_counts(lt, words, summ, o, d, idir, t_exit, t_exit)
    ops, leaf_bytes = needed_work(kernel, lt, rows, words, o, idir,
                                  tile(torch.where(kt >= 0, kd, t_exit)),
                                  tally=tally)
    if scan:
        print_scan(name, kernel, tally)
    return ops, nbytes(cv, words, summ, floors, *kern) + leaf_bytes, tally


def shadow_work(name, kernel, orig, d, tm, rows, lt, words, summ, floors,
                kern, scan=True):
    """B4's (B8b's) work on a shadow wavefront from ``orig``: (its float
    operations, its bytes, the ``scan_counts`` tally or None without
    ``scan``): each live unblocked ray's tests to its limit, one slab and
    one triangle test for each blocked ray; prints the ``scan`` line."""
    import torch

    from snail_tpu_torch.ops import traverse as pt

    live = tm >= 0
    idir = [pt.safe_inv(c) for c in d]
    blocked = kern > 0
    limit = torch.where(live, tm, -pt.BIG)
    tally = None
    if scan:
        tally = scan_counts(lt, words, summ, orig.unbind(), d, idir, limit,
                            limit)
    ops, leaf_bytes = needed_work(
        kernel, lt, rows, words, orig.unbind(), idir,
        torch.where(live & ~blocked, tm, float("-inf")),
        int((live & blocked).sum()), tally)
    if scan:
        print_scan(name, kernel, tally)
    n_bytes = nbytes(orig, *d, tm, words, summ, floors, kern) + leaf_bytes
    return ops, n_bytes, tally


def check_kernels(name, kind, scene, cam):
    """Phase 3 on the frame's wavefronts: each kernel against its plain
    version on the card. Returns {kernel: entry}."""
    import torch

    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops import traverse as pt

    w, h = WIDTH, HEIGHT
    p = (w // pt.TILE) * (h // pt.TILE)
    pids = torch.arange(p, device="cuda")
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    lt = scene.leaves
    out = {}

    # B1
    kern = pt.words_camera(cv, w, h, lt)
    plain, plain_ms = timed_plain(
        lambda: pt.words_camera_plain(cv, w, h, lt, pt.WL_BANDS, pids))
    err = words_err(kern, plain, f"{name} words_camera")
    ms, event_ms = words_ms(lambda: pt.words_camera(cv, w, h, lt))
    tested = pt.camera_word_tests(cv, w, h, lt, pids)
    if bool((kern[0].ne(0).any(1) & ~tested).any()):
        fail(f"{name} words_camera: a bit set in a word whose box fails")
    print_passing(name, "words_camera", tested)
    out["words_camera"] = words_entry("words_camera", err, ms, plain_ms, lt,
                                      (cv,), kern, tested, event_ms)
    out["words_camera"]["cluster_ms"] = sweep_clusters(
        name, "words_camera",
        lambda c: pt.words_camera(cv, w, h, lt, cluster=c), plain)
    words, summ, floors = kern

    # B2 on the raw triangle rows
    rows = scene.tri_rows
    kern = pt.camera_wl(cv, w, h, rows, lt, words, summ, floors)
    plain, plain_ms = timed_plain(
        lambda: pt.camera_wl_plain(cv, w, h, rows, lt, words, pids))
    kd, ku, kv, kt, kdx, kdy, kdz = kern
    hit = plain[0] < BIG
    if not bool((kt[~hit] == -1).all() and (kd[~hit] == BIG).all()):
        fail(f"{name} camera_wl: misses differ from the plain version")
    if not all(torch.equal(a, b) for a, b in zip(kern[4:], plain[4:])):
        fail(f"{name} camera_wl: directions differ from the plain version")
    # dist, u, v bit for bit where the triangle agrees; it differs only on a
    # distance tie (the walk checks' rule)
    derr, share = closest_equal(f"{name} camera_wl", kern[:4], plain[:4],
                                torch.ones_like(hit))
    if share <= 0.3:
        fail(f"{name} camera_wl: hit share {share}")
    ms = cuda_ms(lambda: pt.camera_wl(cv, w, h, rows, lt, words, summ,
                                      floors), KERNEL_REPS)
    ops, b2_bytes, tally = camera_work(name, "camera_wl", cv, rows, lt,
                                       words, summ, floors, kern)
    out["camera_wl"] = entry(derr, ms, plain_ms, b2_bytes, ops, scan=tally)

    # B8a on the same words and the camera's shared-origin rows: B2's
    # outputs bit for bit (the shared-origin table rounds the origin's
    # terms as B2's full test does); the warps of a few seeded packets
    # simulated (camera_wl_sim): B2's outputs bit for bit, B8a's counters,
    # and the tally of their leaf visits
    srows = pt.shared_rows(rows, cam.pos)
    print(f"table {name} shared_rows: "
          f"{cuda_ms(lambda: pt.shared_rows(rows, cam.pos), KERNEL_REPS):.4f}"
          f" ms a frame (B8a's; B2 and B9a build none)", flush=True)
    *k8, st = pt.camera_wl_stats(cv, w, h, srows, lt, words, summ, floors)
    raw_against_shared(f"{name} camera_wl", kern, k8)
    (sim_tally, n_sim), plain_ms = timed_plain(lambda: camera_tally(
        name, cv, rows, lt, words, floors, kern, st))
    out["camera_wl"]["sim_scan"] = sim_tally
    ms = cuda_ms(lambda: pt.camera_wl_stats(cv, w, h, srows, lt, words, summ,
                                            floors), KERNEL_REPS)
    ops, n_bytes, _ = camera_work(name, "camera_wl_stats", cv, srows, lt,
                                  words, summ, floors, kern, scan=False)
    out["camera_wl_stats"] = entry(derr, ms, plain_ms, n_bytes + nbytes(st),
                                   ops, plain_packets=n_sim)
    del srows

    # B3, B4 and B8b on the shadow rays the frame casts from these hits
    # toward its light 0, and toward the scene's low light where it has one
    primary = ((cam.pos[0], cam.pos[1], cam.pos[2]),
               (kdx.reshape(-1), kdy.reshape(-1), kdz.reshape(-1)),
               kd.reshape(-1), ku.reshape(-1), kv.reshape(-1),
               kt.reshape(-1))
    out.update(check_shadow(f"{name} light 0", scene, primary,
                            scene.lights.pos[0], kind not in LOW_LIGHT,
                            sweep=True))
    if kind in LOW_LIGHT:
        check_shadow(f"{name} low light", scene, primary,
                     torch.tensor(LOW_LIGHT[kind], device="cuda"), True)
    out.update(check_bounce(name, scene, primary))
    print_checks(name, out)
    return out


def seeded_packets(p, n, seed):
    """``n`` seeded packet ids of ``p``, sorted, on the card."""
    import numpy as np
    import torch

    pick = np.random.default_rng(seed).choice(p, min(n, p), replace=False)
    return torch.from_numpy(np.sort(pick)).cuda()


def camera_plain_packets(name, cv, rows, lt, words, kern, pk):
    """B2's outputs ``kern`` (the whole wavefront) against the plain B2 on
    packets ``pk``: directions bit for bit, misses as the plain version's,
    dist, u and v bit for bit where the triangle agrees, which may differ
    only on a distance tie (``closest_equal``). Returns (max abs dist
    error, plain ms)."""
    import torch

    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops import traverse as pt

    plain, plain_ms = timed_plain(lambda: pt.camera_wl_plain(
        cv, WIDTH, HEIGHT, rows, lt, words[pk], pk))
    sub = [a[pk] for a in kern]
    hit = plain[0] < BIG
    if not bool((sub[3][~hit] == -1).all() and (sub[0][~hit] == BIG).all()):
        fail(f"{name} camera_wl: misses differ from the plain version")
    if not all(torch.equal(a, b) for a, b in zip(sub[4:], plain[4:])):
        fail(f"{name} camera_wl: directions differ from the plain version")
    err, share = closest_equal(f"{name} camera_wl packets {len(pk)}",
                               sub[:4], plain[:4], torch.ones_like(hit))
    if share <= 0.3:
        fail(f"{name} camera_wl: hit share {share}")
    return err, plain_ms


def raw_against_shared(name, raw, shared):
    """B2's (B4's) outputs ``raw`` on the raw triangle rows against B8a's
    (B8b's) ``shared`` on the shared-origin rows, on the same words: bit
    for bit, since ``shared_rows`` computes the origin's terms with the
    products and sums, in the same order, that the full test computes per
    ray. Prints and returns the values that differ."""
    pairs = (list(zip(raw, shared)) if isinstance(raw, (tuple, list))
             else [(raw, shared)])
    n_diff = sum(int((a != b).sum()) for a, b in pairs)
    print(f"raw {name}: raw rows against shared-origin rows on the same "
          f"words: {n_diff} of {sum(a.numel() for a, _ in pairs)} output "
          f"values differ", flush=True)
    if n_diff:
        fail(f"{name}: the raw rows' outputs differ from the shared-origin "
             "rows'")
    return n_diff


def print_checks(name, out):
    for k, e in out.items():
        print(f"check {name} {k}: ok, max_abs_err {e['max_abs_err']}, "
              f"kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.1f} ms, "
              f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})", flush=True)


def check_shadow(name, scene, primary, lp, need_blocked, sweep=False):
    """B3, B4 and B8b against their plain versions on the frame's shadow
    rays from the ``primary`` hits toward the light at ``lp``, B3's
    words, summaries and floors and B4's verdicts identical, and B4's
    ``scan_counts``; with ``sweep``, B3 at every cluster size. Every
    wavefront must leave some rays unblocked; with ``need_blocked`` it
    must also block some. Returns {kernel: entry}."""
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.fast import shadow_wavefront

    pk = lambda a: a.reshape(-1, pt.PACKET_R).contiguous()
    d, tm = shadow_wavefront(scene, *primary, lp)
    orig, d, tm = lp.contiguous(), tuple(pk(c) for c in d), pk(tm)
    lt = scene.leaves
    out = {}
    kern = pt.words_shared(orig, d, tm, lt, 1)
    plain, plain_ms = timed_plain(
        lambda: pt.words_shared_plain(orig, d, tm, lt, 1))
    err = words_err(kern, plain, f"{name} words_shared")
    ms, event_ms = words_ms(lambda: pt.words_shared(orig, d, tm, lt, 1))
    tested = pt.shared_word_tests(orig, d, tm, lt)
    if bool((kern[0].ne(0).any(1) & ~tested).any()):
        fail(f"{name} words_shared: a bit set in a word whose box fails")
    print_passing(name, "words_shared", tested)
    out["words_shared"] = words_entry("words_shared", err, ms, plain_ms, lt,
                                      (orig, *d, tm), kern, tested, event_ms)
    if sweep:
        out["words_shared"]["cluster_ms"] = sweep_clusters(
            name, "words_shared",
            lambda c: pt.words_shared(orig, d, tm, lt, 1, c), plain)
    words, summ, floors = kern

    rows = scene.tri_rows
    kern = pt.shadow_wl(orig, d, tm, rows, lt, words, summ, floors)
    plain, plain_ms = timed_plain(
        lambda: pt.shadow_wl_plain(orig, d, tm, rows, lt, words))
    live = tm >= 0
    agree = float((kern[live] == plain[live]).float().mean())
    frac = float(plain[live].mean())
    n_diff = int((kern != plain).sum())
    print(f"check {name} shadow_wl: agreement {agree}, {n_diff} verdicts "
          f"differ, blocked share {frac} of {int(live.sum())} live rays",
          flush=True)
    if (n_diff or bool(kern[~live].any()) or frac >= 0.98
            or (need_blocked and frac <= 0.02)):
        fail(f"{name} shadow_wl: {n_diff} verdicts differ, blocked share "
             f"{frac}")
    ms = cuda_ms(lambda: pt.shadow_wl(orig, d, tm, rows, lt, words, summ,
                                      floors), KERNEL_REPS)
    ops, b4_bytes, tally = shadow_work(name, "shadow_wl", orig, d, tm, rows,
                                       lt, words, summ, floors, kern)
    out["shadow_wl"] = entry(float((kern - plain).abs().max()), ms, plain_ms,
                             b4_bytes, ops, scan=tally)

    # B8b on the light's shared-origin rows: B4's verdicts bit for bit,
    # and the simulated counters
    srows = pt.shared_rows(rows, orig)
    k8, st = pt.shadow_wl_stats(orig, d, tm, srows, lt, words, summ, floors)
    raw_against_shared(f"{name} shadow_wl", kern, k8)
    pk = sample_packets(st, 2)
    (_, sim), plain_ms = timed_plain(lambda: pt.shadow_wl_stats_plain(
        orig, tuple(c[pk] for c in d), tm[pk], srows, lt, words[pk],
        floors[pk]))
    check_counters(f"{name} shadow_wl_stats", st, pk, sim)
    ms = cuda_ms(lambda: pt.shadow_wl_stats(orig, d, tm, srows, lt, words,
                                            summ, floors), KERNEL_REPS)
    ops, n_bytes, _ = shadow_work(name, "shadow_wl_stats", orig, d, tm,
                                  srows, lt, words, summ, floors, kern,
                                  scan=False)
    out["shadow_wl_stats"] = entry(0.0, ms, plain_ms, n_bytes + nbytes(st),
                                   ops, plain_packets=len(pk))
    return out


def check_bounce(name, scene, primary):
    """B5 and B6 against their plain versions on the reflection wavefront
    the frame casts from the ``primary`` hits. Where too few of its live
    rays hit anything (a terrain's reflections mostly leave for the sky),
    they are also checked on a seeded wavefront that must hit on 0.02-0.98
    of its rays. Returns {kernel: entry} of the frame's wavefront."""
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.fast import bounce_wavefront

    o, d, tm, _ = pt.general_planes(*bounce_wavefront(scene, *primary))
    out, share = check_general(f"{name} reflections", scene, o, d, tm,
                               sweep=True)
    if not 0.02 < share < 0.98:
        o, d, tm = seeded_general(scene, tm.shape[0])
        seeded, share = check_general(f"{name} seeded", scene, o, d, tm)
        if not 0.02 < share < 0.98:
            fail(f"{name} seeded wavefront: hit share {share}")
        print_checks(f"{name} seeded", seeded)
    return out


def seeded_general(scene, n_packets, seed=5, planes=None):
    """A wavefront of rays with their own origins, ``n_packets`` packets:
    each packet's rays start within 1 % of the scene box's extent of a
    seeded point in the box and run within a narrow cone around a seeded
    direction (down into the geometry or up out of it); every 7th ray
    masked. Returns the (o, d, tm) planes of ``planes`` (default
    ``general_planes``; the fat-leaf kernels take ``padded_planes``)."""
    import numpy as np
    import torch

    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops import traverse as pt

    rng = np.random.default_rng(seed)
    lo, hi = scene.root_lo.cpu().numpy(), scene.root_hi.cpu().numpy()
    shape = (n_packets, pt.PACKET_R, 3)
    o = (rng.uniform(lo, hi, (n_packets, 1, 3))
         + rng.uniform(-0.01, 0.01, shape) * (hi - lo))
    axis = rng.normal(size=(n_packets, 1, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    d = axis + rng.uniform(-0.05, 0.05, shape)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = np.full(shape[:2], BIG)
    tm[:, ::7] = -BIG
    flat = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float32).reshape(-1)).cuda()
    o, d, tm, _ = (planes or pt.general_planes)(
        tuple(flat(o[..., k]) for k in range(3)),
        tuple(flat(d[..., k]) for k in range(3)), flat(tm))
    return o, d, tm


def check_general(name, scene, o, d, tm, sweep=False):
    """B5 (words, summaries and floors identical) and B6 (dist, u, v and
    tri bit for bit, which includes the miss and masked conventions and
    tri clamped at 0) against their plain versions on the planes ``o``,
    ``d``, ``tm``, and B6's ``scan_counts``; with ``sweep``, B5 at every
    cluster size. Returns ({kernel: entry}, hit share of the live
    rays)."""
    import torch

    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops import traverse as pt

    lt, rows = scene.leaves, scene.tri_rows
    out = {}
    kern = pt.words_general(o, d, tm, lt)
    plain, plain_ms = timed_plain(
        lambda: pt.words_general_plain(o, d, tm, lt, pt.WL_BANDS))
    err = words_err(kern, plain, f"{name} words_general")
    ms, event_ms = words_ms(lambda: pt.words_general(o, d, tm, lt))
    tested = pt.general_word_tests(o, d, tm, lt)
    words, summ, floors = kern
    if bool((words.ne(0).any(1) & ~tested).any()):
        fail(f"{name} words_general: a bit set in a word whose box fails")
    out["words_general"] = words_entry("words_general", err, ms, plain_ms, lt,
                                       (*o, *d, tm), kern, tested, event_ms)
    if sweep:
        out["words_general"]["cluster_ms"] = sweep_clusters(
            name, "words_general",
            lambda c: pt.words_general(o, d, tm, lt, cluster=c), plain)
    kept = pt.unpack_bits(words).any(1).sum(1).float()
    print(f"check {name} words_general: words, summaries and floors equal "
          f"the plain version's; words whose box passes per packet: mean "
          f"{float(tested.sum(1).float().mean()):.1f} of {tested.shape[1]}, "
          f"populated {float(words.ne(0).any(1).sum(1).float().mean()):.1f}",
          flush=True)

    kern = pt.closest_wl_g(o, d, tm, rows, lt, words, summ, floors)
    plain, plain_ms = timed_plain(
        lambda: pt.closest_wl_g_plain(o, d, tm, rows, lt, words))
    kd, ku, kv, kt = kern
    pd, pu, pv, ptri = plain
    live = tm >= 0
    hit = live & (pd < BIG)
    n_live, n_hit = int(live.sum()), int(hit.sum())
    share = n_hit / max(n_live, 1)
    derr = float((kd - pd)[hit].abs().max()) if n_hit else 0.0
    n_diff = int(((kd != pd) | (ku != pu) | (kv != pv) | (kt != ptri))
                 .sum())
    checks = {
        "masked": bool((kd[~live] == -BIG).all()
                       and (pd[~live] == -BIG).all()),
        "misses": bool((kd[live & ~hit] == BIG).all()),
        "tri clamp": bool((kt[~hit] == 0).all() and (ptri[~hit] == 0).all()),
        # bit for bit: the plain version keeps the lowest triangle id of a
        # distance tie, the kernel the first in band order, and no tie
        # has shown on these wavefronts
        "bits": n_diff == 0,
    }
    print(f"check {name} closest_wl_g: hit share {share} of {n_live} live "
          f"rays, {n_diff} rays differ in dist, u, v or tri; B5 leaves kept "
          f"per packet: mean {float(kept.mean()):.1f}, max "
          f"{int(kept.max())} of {lt.n_leaf}", flush=True)
    if not all(checks.values()):
        fail(f"{name} closest_wl_g: {checks}, max dist err {derr}")
    ms = cuda_ms(lambda: pt.closest_wl_g(o, d, tm, rows, lt, words, summ,
                                         floors), KERNEL_REPS)
    idir = [pt.safe_inv(c) for c in d]
    t_root = root_exit(lt, o, idir)
    reach = torch.where(hit, kd, torch.minimum(tm, t_root))
    best = torch.where(live, tm.clamp_max(BIG), -BIG)
    tally = scan_counts(lt, words, summ, o, d, idir, best,
                        torch.minimum(best, t_root))
    ops, leaf_bytes = needed_work("closest_wl_g", lt, rows, words, o, idir,
                                  torch.where(live, reach, float("-inf")),
                                  tally=tally)
    print_scan(name, "closest_wl_g", tally)
    out["closest_wl_g"] = entry(derr, ms, plain_ms, nbytes(
        *o, *d, tm, lt.root, words, summ, floors, *kern) + leaf_bytes, ops,
        scan=tally)
    return out, share


def blocked_share(scene, o, d, tm):
    """B5 (one band, as ``any_hit_c``) and B7 on the planes ``o``, ``d``,
    ``tm``: (words, summ, floors, blocked, blocked share of the live
    rays)."""
    from snail_tpu_torch.ops import traverse as pt

    words, summ, floors = pt.words_general(o, d, tm, scene.leaves, 1)
    kern = pt.shadow_wl_g(o, d, tm, scene.tri_rows, scene.leaves, words,
                          summ, floors)
    return words, summ, floors, kern, float(kern[tm >= 0].mean())


def check_shadow_general(name, scene, o, d, tm, need_window=True,
                         by_live=False):
    """B7 against its plain version on the planes ``o``, ``d``, ``tm``:
    verdicts identical, masked rays never blocked, and with
    ``need_window`` a blocked share of the live rays in 0.02-0.98; and
    the tally of its warps on a few packets (``wl_tally``, its
    ``by_live``). Returns its entry (with the tally's sums); its bound
    counts the o and d planes of the live rays only (``anyhit_bytes``)."""
    from snail_tpu_torch.ops import traverse as pt

    lt, rows = scene.leaves, scene.tri_rows
    words, summ, floors, kern, share = blocked_share(scene, o, d, tm)
    live = tm >= 0
    plain, plain_ms = timed_plain(
        lambda: pt.shadow_wl_g_plain(o, d, tm, rows, lt, words))
    n_diff = int((kern != plain).sum())
    print(f"check {name} shadow_wl_g: {n_diff} verdicts differ, blocked "
          f"share {share} of {int(live.sum())} live rays", flush=True)
    if (n_diff or bool(kern[~live].any())
            or (need_window and not 0.02 < share < 0.98)):
        fail(f"{name} shadow_wl_g: {n_diff} verdicts differ, blocked share "
             f"{share}")
    tally = wl_tally(name, o, d, tm, rows, lt, words, floors, kern,
                     by_live=by_live)
    ms = cuda_ms(lambda: pt.shadow_wl_g(o, d, tm, rows, lt, words, summ,
                                        floors), KERNEL_REPS)
    e = entry(float((kern - plain).abs().max()), ms, plain_ms,
              *b7_work(lt, rows, o, d, tm, words, summ, floors, kern),
              scan=tally)
    print_checks(name, {"shadow_wl_g": e})
    return e


def b7_work(lt, rows, o, d, tm, words, summ, floors, kern):
    """The bytes and float operations that B7 needs on the planes ``o``,
    ``d``, ``tm`` over B5's ``words``, with its verdicts ``kern``: the
    leaves each unblocked live ray enters before its reach
    (``needed_work``), one test for each blocked one, the word lists and
    the root box, and the rays' planes as ``anyhit_bytes`` counts them
    (o and d of the live rays only)."""
    import torch

    from snail_tpu_torch.ops import traverse as pt

    idir = [pt.safe_inv(c) for c in d]
    live, blocked = tm >= 0, kern > 0
    reach = torch.minimum(tm, root_exit(lt, o, idir))
    ops, leaf_bytes = needed_work(
        "shadow_wl_g", lt, rows, words, o, idir,
        torch.where(live & ~blocked, reach, float("-inf")),
        int((live & blocked).sum()))
    return (anyhit_bytes(o, d, tm, None, kern)
            + nbytes(lt.root, words, summ, floors) + leaf_bytes), ops


def check_seeded_shadows(name, scene, n_packets):
    """B7 on seeded shadow rays with their own origins: the rays of
    ``seeded_general``, each live one looking 0.05-0.6 of the scene box's
    diagonal far; checked on the first seed whose blocked share lies in
    0.02-0.98. Returns its entry, with the wavefront's name."""
    import numpy as np
    import torch

    for seed in range(5, 25):
        o, d, tm = seeded_general(scene, n_packets, seed)
        rng = np.random.default_rng(seed)
        diag = float((scene.root_hi - scene.root_lo).norm())
        frac = torch.from_numpy(rng.uniform(0.05, 0.6, tuple(tm.shape))
                                .astype(np.float32)).cuda()
        tm = torch.where(tm >= 0, frac * diag, tm)
        if 0.02 < blocked_share(scene, o, d, tm)[-1] < 0.98:
            wave = f"seeded {seed}"
            return {**check_shadow_general(f"{name} {wave}", scene, o, d,
                                           tm), "wavefront": wave}
    fail(f"{name}: no seeded shadow wavefront blocks 0.02-0.98 of its rays")


def launched(name, path, need):
    """The launch counts since the last reset; every kernel in ``need``
    must have launched."""
    from snail_tpu_torch.ops import traverse as pt

    launches = pt.launch_counts()
    if not all(launches[k] > 0 for k in need):
        fail(f"{name} {path}: a kernel of the path was not launched: "
             f"{launches}")
    return launches


def check_small(name, path, frame, small, size=(64, 64)):
    """A small frame ``frame(scene, camera, *size)`` of ``small``
    ((scene, camera)) on the card against the CPU path (plain versions):
    within 2e-3 on all but 0.2 % of pixels, the reference not all zero."""
    card_img = frame(*small, *size).cpu()
    ref = frame(small[0].to("cpu"), small[1].to("cpu"), *size)
    off = float(((card_img - ref).abs().amax(-1) > 2e-3).float().mean())
    wh = f"{size[0]}x{size[1]}"
    if off > 2e-3:
        fail(f"{name} {path}: {wh} card frame differs from the CPU path "
             f"on {off} of pixels")
    if not float(ref.abs().max()) > 0:
        fail(f"{name} {path}: the {wh} reference frame is all zero")
    print(f"frame {name} {path}: {wh} card vs CPU path, share of pixels "
          f"off by > 2e-3: {off}", flush=True)


def run_path(name, path, need, frame, scene, cam, small, card, rays,
             frames=TIMED_FRAMES, size=(WIDTH, HEIGHT), small_size=(64, 64),
             only=None):
    """Phase 4, one path: the launch counts of one frame ``frame(scene,
    camera, *size)`` (each kernel in ``need`` > 0; with ``only``, no kernel
    outside it), a ``small_size`` frame of ``small`` against the CPU path,
    ms/frame over ``frames``, MRays/s (``rays`` as bench.py counts them)
    and peak memory. Returns the launch counts."""
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.utils import trace

    width, height = size
    torch.cuda.synchronize()
    pt.reset_launch_counts()
    with trace.tracing():
        img = frame(scene, cam, width, height)
    torch.cuda.synchronize()
    launches = launched(name, path, need)
    if only is not None and any(n for k, n in launches.items()
                                if k not in only):
        fail(f"{name} {path}: a kernel outside {only} ran: {launches}")
    live = trace.counters()
    if tuple(img.shape) != (height, width, 3):
        fail(f"{name} {path}: image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or not float(img.abs().max()) > 0:
        fail(f"{name} {path}: image not finite or all zero")
    print(f"frame {name} {path}: launches {launches}, mean "
          f"{float(img.mean()):.6f}", flush=True)
    check_small(name, path, frame, small, small_size)

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: frame(scene, cam, width, height), frames)
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"frame {name} {path} {width}x{height}: {ms:.3f} ms/frame, "
          f"{rays / ms / 1e3:.2f} MRays/s ({rays} rays as bench.py counts; "
          f"{live.get('rays.live', 0)} live rays of "
          f"{live.get('rays.traced', 0)} traced), peak "
          f"memory {peak:.1f} MiB, on {card}", flush=True)
    return launches


def run_frame(name, path, opts, need, scene, cam, small, card):
    """Phase 4, one path through render_frame (see run_path)."""
    from snail_tpu_torch.render.renderer import render_frame

    return run_path(name, path, need + GATHER,
                    lambda s, c, w, h: render_frame(s, c, w, h, opts),
                    scene, cam, small, card,
                    WIDTH * HEIGHT * (1 + len(scene.lights)))


def check_gather(name, scene, cam, card):
    """Phase 4 on the terrain, S1: one supersampled bounce frame (the
    benchmark's terrain_1m.bounce_ss frame: 2048^2 rays a wavefront), its
    launches from its own run (three gathers: the camera's, the
    reflection's and the glass wavefront's, each recorded from the
    frame's call), and on each wavefront ``surface_gather_kernel`` bit
    for bit its plain version (the CPU path), its device ms beside its
    bound (time_words ``gather_bytes``: the 32-byte sectors of the
    distinct rows that hold a requested column, dist and tri, the planes)
    and the whole-row ``index_select`` the frame called before
    (``library_ms``). Returns (S1's entry, the frame's launch counts)."""
    import torch

    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops.gather import surface_rows
    from snail_tpu_torch.render import fast
    from snail_tpu_torch.render.renderer import render_frame

    from time_words import device_ms, gather_bytes

    opts = RenderOpts(textures=False, supersample=True)
    calls = []

    def record(sh_pack, dist, tri, cols):
        calls.append((dist.clone(), tri.clone(), tuple(cols)))
        return surface_rows(sh_pack, dist, tri, cols)

    torch.cuda.synchronize()
    pt.reset_launch_counts()
    fast.surface_rows = record
    try:
        render_frame(scene, cam, WIDTH, HEIGHT, opts)
    finally:
        fast.surface_rows = surface_rows
    torch.cuda.synchronize()
    launches = launched(name, "bounce_ss", GATHER)
    rays = 4 * WIDTH * HEIGHT
    if (launches["surface_rows"] != 3 or len(calls) != 3
            or any(d.numel() != rays for d, _, _ in calls)):
        fail(f"{name} bounce_ss: {launches['surface_rows']} gathers "
             f"launched, {[d.numel() for d, _, _ in calls]} rays recorded; "
             f"want 3 of {rays}")
    sh, host = scene.sh_pack, scene.sh_pack.cpu()
    waves, total = [], {"ms": 0.0, "plain_ms": 0.0, "bytes": 0,
                        "library_ms": 0.0, "library_bytes": 0}
    for wave, (dist, tri, cols) in zip(("camera", "reflection", "glass"),
                                       calls):
        out = surface_rows(sh, dist, tri, cols)
        hd, ht = dist.cpu(), tri.cpu()
        plain, plain_ms = timed_plain(lambda: surface_rows(host, hd, ht,
                                                           cols))
        n_diff = int((out.cpu().view(torch.int32)
                      != plain.view(torch.int32)).sum())
        hit = (dist > 0.0) & (dist < BIG)
        idx = torch.where(hit, tri, 0).long()
        need, lib = gather_bytes(idx, rays, cols)
        ms = device_ms(lambda: surface_rows(sh, dist, tri, cols),
                       KERNEL_REPS)
        lib_ms = device_ms(lambda: sh.index_select(0, idx), KERNEL_REPS)
        row = {"wavefront": wave, "rays": rays, "hits": int(hit.sum()),
               "cols": len(cols), "values_differ": n_diff, "ms": ms,
               "plain_ms": plain_ms,
               "bound_ms": need / HBM_BYTES_PER_MS, "bytes": need,
               "library_ms": lib_ms, "library_bytes": lib}
        print(f"gather {name} bounce_ss {wave}: {json.dumps(row)}",
              flush=True)
        if n_diff:
            fail(f"{name} bounce_ss {wave}: surface_gather_kernel differs "
                 f"from its plain version in {n_diff} values")
        waves.append(row)
        for k in total:
            total[k] += row[k]
    e = entry(0, total["ms"], total["plain_ms"], total["bytes"], 0,
              library_ms=total["library_ms"],
              library_bytes=total["library_bytes"], wavefronts=waves)
    print(f"gather {name} bounce_ss: the frame's three gathers "
          f"{e['ms']:.4f} ms beside their bound {e['bound_ms']:.4f} ms and "
          f"the whole-row index_select's {e['library_ms']:.4f} ms, on "
          f"{card}", flush=True)
    return e, launches


def run_stats(name, opts, scene, cam, small, card):
    """Phase 4, the counter frame: B8a and B8b in place of B2 and B4 (on a
    walk scene, phase 6: B9e and B9f in place of B9a and B9b), its image
    bit-identical to render_frame's, its counters (and the 64 x 64 frame's
    on the card and the CPU path), and its ms/frame beside the forward
    frame's, timed in turns. Returns the launch counts."""
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.fast import render_frame_fast_stats
    from snail_tpu_torch.render.renderer import render_frame

    rays = WIDTH * HEIGHT * (1 + len(scene.lights))
    counters = {}  # (frame width, device) -> the counters of its last run

    def frame(s, c, w, h):
        img, st = render_frame_fast_stats(s, c, w, h, opts)
        counters[w, img.device.type] = st
        return img

    walk = pt.walks(scene)
    path, need, twins = (("walk stats", WALK_STATS, WALK_FWD) if walk else
                         ("stats", STATS, ("camera_wl", "shadow_wl")))
    launches = run_path(name, path, need + GATHER, frame, scene, cam, small,
                        card, rays, only=WALK + GATHER if walk else None)
    if any(launches[k] for k in twins):
        fail(f"{name} {path}: {twins} ran beside {need}: {launches}")
    img, st = render_frame_fast_stats(scene, cam, WIDTH, HEIGHT, opts)
    if not torch.equal(img, render_frame(scene, cam, WIDTH, HEIGHT, opts)):
        fail(f"{name} {path}: the counter frame's image is not the fwd "
             "frame's")
    if st["rays"] != rays or min(st.values()) <= 0:
        fail(f"{name} {path}: counters {st}")
    s64, c64 = counters[64, "cuda"], counters[64, "cpu"]
    packets = (WIDTH // pt.TILE) * (HEIGHT // pt.TILE) * (1 + len(
        scene.lights))
    fwd = lambda: render_frame(scene, cam, WIDTH, HEIGHT, opts)
    stats = lambda: render_frame_fast_stats(scene, cam, WIDTH, HEIGHT, opts)
    f1, s1, s2, f2 = (cuda_ms(fn, TIMED_FRAMES)
                      for fn in (fwd, stats, stats, fwd))
    print(f"frame {name} {path}: counters {st}, "
          f"{st['leaves'] / packets:.1f} leaves {'loaded' if walk else 'kept'}"
          f" per packet (summed over its warps); 64x64 card {s64}, CPU path "
          f"{c64}, equal: {s64 == c64}", flush=True)
    print(f"frame {name} {path} {WIDTH}x{HEIGHT}: {(s1 + s2) / 2:.3f} "
          f"ms/frame (runs {s1:.3f}, {s2:.3f}) beside the fwd frame's "
          f"{(f1 + f2) / 2:.3f} ({f1:.3f}, {f2:.3f}), on {card}", flush=True)
    return launches


def run_instanced(name, kind, scene, small, card):
    """Phase 3's B7 checks, on the instanced frame's own shadow wavefront
    and on a seeded one (``check_seeded_shadows``), and phase 4's
    instanced frames on a grid of instances of ``scene``, timed over
    INSTANCED_FRAMES. Returns (B7's entry, {path: launch counts})."""
    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.ops.traverse import TILE
    from snail_tpu_torch.scene.bench_scenes import instanced_grid
    from snail_tpu_torch.scene.instancing import render_instanced

    grid, paths = INSTANCE_GRID[kind]
    isc, icam = instanced_grid(kind, scene, grid)
    small_isc, small_cam = instanced_grid(kind, small[0], grid)
    iname = f"{name} x{grid * grid}"
    b7 = check_instanced(iname, isc, icam, need_window=kind == "city")
    b7["seeded"] = check_seeded_shadows(
        name, scene, (WIDTH // TILE) * (HEIGHT // TILE))
    launches = {}
    for path in paths:
        opts = (RenderOpts(textures=False) if path == "bounce" else
                RenderOpts(reflections=False, transparency=False,
                           textures=False))
        launches[f"instanced_{path}"] = run_path(
            iname, f"instanced {path}", INSTANCED,
            lambda s, c, w, h: render_instanced(s, c, w, h, opts), isc, icam,
            (small_isc, small_cam), card,
            WIDTH * HEIGHT * (1 + len(isc.lights)), INSTANCED_FRAMES)
    return b7, launches


def check_instanced(name, isc, icam, need_window):
    """What the instanced frame's camera sees (every instance; some rays'
    hits on one instance hidden behind another), and B7 against its plain
    version on the frame's shadow wavefront toward light 0 in the object
    space of the first instance it touches (``check_shadow_general``).
    Returns B7's entry."""
    import torch

    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops import dispatch
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.fast import _toward_light, shadow_tmax
    from snail_tpu_torch.scene import instancing as inst

    o3, d3, tm, _ = inst.primary_wavefront(icam, WIDTH, HEIGHT)
    dist, ids, _, _, _, _, n3 = inst.instanced_hits(isc, o3, d3, tm)
    hit = (dist > 0.0) & (dist < BIG)
    seen = torch.unique(ids[hit]).numel()
    hidden = []
    for j in range(isc.num_instances):
        d_j, _, _ = dispatch.closest_hit(isc.base, *inst._to_object(
            isc, j, o3, d3), tm)
        hidden.append(int(((d_j > 0.0) & (d_j < BIG) & (ids != j)).sum()))
    print(f"check {name}: the camera sees {seen} of {isc.num_instances} "
          f"instances on {float(hit.float().mean()):.4f} of its rays; rays "
          f"whose hit on an instance another hides: {hidden}", flush=True)
    if seen != isc.num_instances or not any(hidden):
        fail(f"{name}: the camera sees {seen} instances, hidden {hidden}")

    p3 = tuple(o + d * torch.where(hit, dist, 0.0) for o, d in zip(o3, d3))
    lp = isc.lights.pos[0]
    fl3, ldist, _, mask = _toward_light(p3, n3, hit, lp)
    stm = shadow_tmax(ldist, mask)
    lo3 = tuple(lp[k].expand(stm.shape) for k in range(3))
    for i in range(isc.num_instances):
        touch = inst._ray_hits_box(lo3, fl3, stm, isc.inst_lo[i],
                                   isc.inst_hi[i])
        if bool(touch.any()):
            break
    o, d = inst._to_object(isc, i, lo3, fl3)
    o, d, tmi, _ = pt.general_planes(o.unbind(1), d.unbind(1),
                                     torch.where(touch, stm, -BIG))
    wave = f"{name.split()[-1]} instance {i} shadows"
    return {**check_shadow_general(f"{name} instance {i} shadows", isc.base,
                                   o, d, tmi, need_window, by_live=True),
            "wavefront": wave}


def run_step(name, scene, cam, small, card, path="fwd_bwd", need=BOUNCE,
             against=None):
    """Phase 4, bench.py's fwd+bwd step (bench.py:236-247): the loss and
    gradients of its 7 parameters through render_frame_fast_diff with
    reflections and shadows, MSE against a forward render. Launch counts
    of one step (each kernel in ``need``: by default the six kernels of
    the bounce path), a 64 x 64 step on the card against the CPU path (its
    target lit at half the light colour, so that the gradients are not
    ~0), with ``against`` (the same geometry with leaf tables) its loss
    against that scene's, ms/step. Returns the launch counts."""
    import numpy as np
    import torch

    from snail_tpu_torch.core.types import Light
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.renderer import render_frame
    from snail_tpu_torch.scene.bench_scenes import STEP_OPTS, bench_step
    from snail_tpu_torch.utils import trace

    target = render_frame(scene, cam, WIDTH, HEIGHT, STEP_OPTS)
    torch.cuda.synchronize()
    pt.reset_launch_counts()
    with trace.tracing():
        loss, grads = bench_step(scene, cam, target, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    launches = launched(name, path, need)
    live = trace.counters()
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    loss = float(loss)
    if not np.isfinite(loss) or bad:
        fail(f"{name} {path}: loss {loss}, non-finite grads {bad}")
    if against is not None:
        ref = float(bench_step(against, cam, target, WIDTH, HEIGHT)[0])
        print(f"step {name} {path}: loss {loss} against the worklist "
              f"scene's {ref}", flush=True)
        if not abs(loss - ref) < 3e-4 * max(1.0, abs(ref)):
            fail(f"{name} {path}: loss {loss}, the worklist scene's {ref}")
    print(f"step {name} {path}: launches {launches}, loss {loss}, "
          "grad max |g| " + ", ".join(
              f"{k} {float(g.abs().max()):.3e}" for k, g in grads.items()),
          flush=True)

    sscene, scam = small
    lights = sscene.lights
    half = dataclasses.replace(sscene, lights=Light(
        pos=lights.pos, color=lights.color * 0.5, radius=lights.radius))
    t64 = render_frame(half, scam, 64, 64, STEP_OPTS)
    lk, gk = bench_step(sscene, scam, t64, 64, 64)
    lc, gc = bench_step(sscene.to("cpu"), scam.to("cpu"), t64.cpu(), 64, 64)
    lk, lc = float(lk), float(lc)
    # the tolerances of tests/test_fast_diff.py:84-91
    worst = {}
    ok = abs(lk - lc) < 3e-4 * max(1.0, abs(lc))
    for k in gc:
        a, b = gk[k].cpu().numpy(), gc[k].numpy()
        denom = max(float(np.abs(b).max()), 1e-8)
        q, m = (float(np.quantile(np.abs(a - b), 0.999)) / denom,
                float(np.abs(a - b).mean()) / denom)
        worst[k] = (q, m)
        ok = ok and q < 5e-3 and m < 1e-3
    print(f"step {name} {path}: 64x64 card vs CPU path, loss {lk} vs {lc}; "
          "grad |diff| q99.9 / mean over max |g|: " + ", ".join(
              f"{k} {q:.2e}/{m:.2e}" for k, (q, m) in worst.items()),
          flush=True)
    if not ok:
        fail(f"{name} {path}: 64x64 card step differs from the CPU path")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: bench_step(scene, cam, target, WIDTH, HEIGHT),
                 TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    rays = WIDTH * HEIGHT * (1 + len(scene.lights))
    print(f"step {name} {path} {WIDTH}x{HEIGHT}: {ms:.3f} ms/step, "
          f"{rays / ms / 1e3:.2f} MRays/s ({rays} rays as bench.py counts; "
          f"{live.get('rays.live', 0)} live rays of "
          f"{live.get('rays.traced', 0)} traced), peak "
          f"memory {peak:.1f} MiB, on {card}", flush=True)
    return launches


def walk_work(kernel, nodes, rows, work):
    """The work a walk wavefront needs, as (float operations, bytes of
    tree data), from its plain walk's ``work`` (ops/traverse_ref.py
    ``walk_plain``): for each ray the slab tests of the nodes it enters
    and the ray-triangle tests of the leaves it enters (up to its blocker);
    each node some ray enters (32 B) and its leaf's triangle rows, read
    once."""
    count = nodes.columns()[3]
    entered = work["entered"]
    ops = work["slab"] * SLAB_OPS + work["tri"] * TRI_OPS[kernel]
    n_bytes = (int(entered.sum()) * nodes.node.shape[1]
               * nodes.node.element_size()
               + int(count[entered].sum()) * rows.shape[1]
               * rows.element_size())
    return ops, n_bytes


def closest_equal(name, kern, plain, live):
    """A walk kernel's closest hits (dist, u, v, tri) against its plain
    version's, on the ``live`` rays and the rest: the triangle equal on >
    0.999 of the hits and, where it differs, a distance tie (rtol 1e-5);
    dist, u and v equal bit for bit where it agrees. Returns (max abs
    dist error over the hits, hit share of the live rays)."""
    import torch

    from snail_tpu_torch.core.vecmath import BIG

    kd, ku, kv, kt = kern
    pd, pu, pv, ptri = plain
    hit = live & (pd.abs() < BIG)
    same = kt == ptri
    n_hit = int(hit.sum())
    checks = {
        "tri": n_hit == 0 or float(same[hit].float().mean()) > 0.999,
        "bits": all(torch.equal(a[same], b[same])
                    for a, b in ((kd, pd), (ku, pu), (kv, pv))),
        "ties": bool(torch.allclose(kd[~same], pd[~same], rtol=1e-5,
                                    atol=0.0)),
    }
    err = float((kd - pd)[hit].abs().max()) if n_hit else 0.0
    print(f"check {name}: tri differs on {int((~same).sum())} rays "
          f"(distance ties), hit share {n_hit / max(int(live.sum()), 1)}",
          flush=True)
    if not all(checks.values()):
        fail(f"{name}: {checks}, max dist err {err}")
    return err, n_hit / max(int(live.sum()), 1)


def check_walk_kernels(name, kind, scene, cam):
    """Phase 5 on a walk scene's wavefronts (phase 7 on a fat-leaf
    scene's): B9a-d against their plain versions on the card, each over
    its whole wavefront, and B9e/B9f against B9a/B9b and the simulation
    of their warps (B11a-d against theirs, B11c also on the bounce
    frame's own shadow wavefronts); returns {kernel: entry}."""
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref
    from snail_tpu_torch.render.fast import bounce_wavefront

    fat = pt.is_fat(scene)
    w, h = WIDTH, HEIGHT
    p = (w // pt.TILE) * (h // pt.TILE)
    pids = torch.arange(p, device="cuda")
    nodes = scene.nodes
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    out = {}

    # B9a, or B11a with the packets' ray-0 signs, on the raw rows
    rows = scene.tri_rows
    if fat:
        k = "fat_camera"
        signs = pt.camera_signs(cam, w, h)
        call = lambda: pt.fat_camera(cv, w, h, signs, rows, nodes)
        plain_fn = lambda work: ref.fat_camera_plain(cv, w, h, signs, rows,
                                                     nodes, pids, work)
        ins = (cv, signs)
    else:
        k = "walk_camera"
        call = lambda: pt.walk_camera(cv, w, h, rows, nodes)
        plain_fn = lambda work: ref.walk_camera_plain(cv, w, h, rows, nodes,
                                                      pids, work)
        ins = (cv,)
    kern = call()
    work = {}
    plain, plain_ms = timed_plain(lambda: plain_fn(work))
    if not all(torch.equal(a, b) for a, b in zip(kern[4:], plain[4:])):
        fail(f"{name} {k}: directions differ from the plain version")
    miss = plain[0] >= pt.BIG
    if not bool((kern[3][miss] == (0 if fat else -1)).all()):
        fail(f"{name} {k}: the miss convention differs")
    err, share = closest_equal(f"{name} {k}", kern[:4], plain[:4],
                               torch.ones_like(kern[0], dtype=torch.bool))
    if share <= 0.3:
        fail(f"{name} {k}: hit share {share}")
    ms = cuda_ms(call, KERNEL_REPS)
    ops, tree_bytes = walk_work(k, nodes, rows, work)
    out[k] = entry(err, ms, plain_ms, nbytes(*ins, *kern) + tree_bytes, ops)
    if not fat:
        out["walk_camera_stats"] = check_walk_camera_stats(
            name, cv, rows, nodes, kern, out[k])
    kd, ku, kv, kt, kdx, kdy, kdz = kern

    # B9b/B11c on the frame's shadow rays, B9c/B11b on its reflection rays
    # and on a seeded wavefront
    primary = ((cam.pos[0], cam.pos[1], cam.pos[2]),
               (kdx.reshape(-1), kdy.reshape(-1), kdz.reshape(-1)),
               kd.reshape(-1), ku.reshape(-1), kv.reshape(-1),
               kt.reshape(-1))
    shadow = check_walk_shadow(f"{name} light 0", scene, primary,
                               scene.lights.pos[0], kind not in LOW_LIGHT)
    out.update(shadow)
    if kind in LOW_LIGHT:
        low = check_walk_shadow(f"{name} low light", scene, primary,
                                torch.tensor(LOW_LIGHT[kind], device="cuda"),
                                True)
    if fat:
        # B11c on the fwd frame's shadow rays, and on the bounce frame's own
        out["fat_shadow"].update(wavefront="fwd frame shadows, light 0")
        if kind in LOW_LIGHT:
            out["fat_shadow"]["low light"] = {
                **low["fat_shadow"], "wavefront": "fwd frame shadows, low "
                "light"}
        out["fat_shadow"]["bounce"] = check_fat_bounce_shadows(
            name, kind, scene, cam)
    planes = pt.padded_planes if fat else pt.general_planes
    k = "fat_closest" if fat else "walk_closest_g"
    o, d, tm, _ = planes(*bounce_wavefront(scene, *primary))
    out[k], _ = check_walk_closest(f"{name} reflections", scene, o, d, tm,
                                   scan=True)
    seeded, share = check_walk_closest(
        f"{name} seeded", scene, *seeded_general(scene, p, planes=planes))
    if not 0.02 < share < 0.98:
        fail(f"{name} seeded wavefront: hit share {share}")
    print_checks(f"{name} seeded", {k: seeded})
    # B9d/B11d on the instanced frame's own shadow wavefront, the one
    # their main path launches, and on a seeded one
    k = "fat_shadow_g" if fat else "walk_shadow_g"
    wave, e = check_walk_instanced_shadows(name, kind, scene)
    seeded = check_walk_seeded_shadows(name, scene, p)
    print_checks(f"{name} seeded", {k: seeded})
    out[k] = {**e, "wavefront": wave, "seeded": seeded}
    print_checks(name, out)
    return out


def check_walk_camera_stats(name, cv, rows, nodes, b9a, b9a_entry):
    """B9e on B9a's inputs: B9a's outputs bit for bit, and the counters of
    a few seeded packets equal to the simulation of their warps. Returns
    its entry (B9a's work, and the counters' bytes)."""
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops.traverse_ref import walk_camera_stats_plain

    w, h = WIDTH, HEIGHT
    *out, st = pt.walk_camera_stats(cv, w, h, rows, nodes)
    if not all(torch.equal(a, b) for a, b in zip(out, b9a)):
        fail(f"{name} walk_camera_stats: outputs differ from walk_camera's")
    pk = sample_packets(st, 3)
    (*sim_out, sim), plain_ms = timed_plain(
        lambda: walk_camera_stats_plain(cv, w, h, rows, nodes, pk))
    check_counters(f"{name} walk_camera_stats", st, pk, sim)
    if not all(torch.equal(a[pk], b) for a, b in zip(out, sim_out)):
        fail(f"{name} walk_camera_stats: the simulation's outputs differ")
    ms = cuda_ms(lambda: pt.walk_camera_stats(cv, w, h, rows, nodes),
                 KERNEL_REPS)
    return stats_entry(b9a_entry, ms, plain_ms, st, len(pk))


def stats_entry(base, ms, plain_ms, stats, n_packets):
    """A counting kernel's entry: its twin's work and the counters it
    writes; its plain version is the simulation of ``n_packets``."""
    t_bytes = stats.numel() * stats.element_size() / HBM_BYTES_PER_MS
    bound = base["bound_ms"] + (t_bytes if base["bound_by"] == "bytes"
                                else 0.0)
    return {**base, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "plain_packets": n_packets}


def check_walk_shadow(name, scene, primary, lp, need_blocked):
    """B9b (and B9f) against its plain version, or on a fat-leaf scene B11c
    against its own (``check_fat_shadow``), on the frame's shadow rays
    from the ``primary`` hits toward the light at ``lp``: verdicts
    identical, some rays unblocked and, with ``need_blocked``, some
    blocked, and B9b's tally on a few packets (``warp_tally``); B9f's
    verdicts B9b's bit for bit and its counters of a few seeded packets
    the simulation's. Returns {kernel: entry}; B9b's bound counts the d
    planes of the live rays only (``anyhit_bytes``)."""
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref
    from snail_tpu_torch.render.fast import shadow_wavefront

    pk = lambda a: a.reshape(-1, pt.PACKET_R).contiguous()
    d, tm = shadow_wavefront(scene, *primary, lp)
    orig, d, tm = lp.contiguous(), tuple(pk(c) for c in d), pk(tm)
    nodes = scene.nodes
    if pt.is_fat(scene):
        return {"fat_shadow": check_fat_shadow(
            name, orig, d, tm, pt.packet_signs(d), scene.tri_rows, nodes,
            need_blocked, frac_max=0.98)}
    k, rows = "walk_shadow", scene.tri_rows
    call = lambda: pt.walk_shadow(orig, d, tm, rows, nodes)
    kern = call()
    work = {}
    plain, plain_ms = timed_plain(lambda: ref.walk_shadow_plain(
        orig, d, tm, rows, nodes, work))
    live = tm >= 0
    frac = float(plain[live].mean())
    n_diff = int((kern != plain).sum())
    print(f"check {name} {k}: {n_diff} verdicts differ, blocked share "
          f"{frac} of {int(live.sum())} live rays", flush=True)
    if (n_diff or bool(kern[~live].any()) or frac >= 0.98
            or (need_blocked and frac <= 0.02)):
        fail(f"{name} {k}: {n_diff} verdicts differ, blocked share {frac}")
    tally = warp_tally(name, k, orig, d, tm, rows, nodes, None, kern,
                       by_live=True)
    ms = cuda_ms(call, KERNEL_REPS)
    ops, tree_bytes = walk_work(k, nodes, rows, work)
    out = {k: entry(0.0, ms, plain_ms, nbytes(orig)
                    + anyhit_bytes((), d, tm, None, kern) + tree_bytes, ops,
                    scan=tally)}
    # B9f: B9b's verdicts bit for bit, and the simulated counters
    blocked, st = pt.walk_shadow_stats(orig, d, tm, rows, nodes)
    if not torch.equal(blocked, kern):
        fail(f"{name} walk_shadow_stats: verdicts differ from "
             "walk_shadow's")
    ps = sample_packets(st, 4)
    (sim_blocked, sim), sim_ms = timed_plain(
        lambda: ref.walk_shadow_stats_plain(
            orig, tuple(c[ps] for c in d), tm[ps], rows, nodes))
    check_counters(f"{name} walk_shadow_stats", st, ps, sim)
    if not torch.equal(sim_blocked, kern[ps]):
        fail(f"{name} walk_shadow_stats: the simulation's verdicts "
             "differ")
    ms = cuda_ms(lambda: pt.walk_shadow_stats(orig, d, tm, rows, nodes),
                 KERNEL_REPS)
    out["walk_shadow_stats"] = stats_entry(out[k], ms, sim_ms, st,
                                           len(ps))
    return out


def check_fat_shadow(name, orig, d, tm, signs, rows, nodes, need_blocked,
                     frac_max=1.0):
    """B11c against its plain version on a shadow wavefront from ``orig``:
    verdicts identical, masked rays never blocked, a blocked share of the
    live rays below ``frac_max`` and, with ``need_blocked``, above 0.02;
    and the tally of its warps on a few packets drawn by their live rays
    (``warp_tally``, the shared origin given as planes). Returns its entry
    (with the tally's sums); its bound counts the d planes of the live
    rays only (``anyhit_bytes``)."""
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref

    call = lambda: pt.fat_shadow(orig, d, tm, signs, rows, nodes)
    kern = call()
    work = {}
    plain, plain_ms = timed_plain(lambda: ref.fat_shadow_plain(
        orig, d, tm, signs, rows, nodes, work))
    live = tm >= 0
    frac = float(plain[live].mean())
    n_diff = int((kern != plain).sum())
    print(f"check {name} fat_shadow: {n_diff} verdicts differ, blocked "
          f"share {frac} of {int(live.sum())} live rays", flush=True)
    if (n_diff or bool(kern[~live].any()) or frac >= frac_max
            or (need_blocked and frac <= 0.02)):
        fail(f"{name} fat_shadow: {n_diff} verdicts differ, blocked share "
             f"{frac}")
    tally = warp_tally(name, "fat_shadow",
                       tuple(orig[k].expand_as(tm) for k in range(3)), d, tm,
                       rows, nodes, signs, kern, by_live=True)
    ms = cuda_ms(call, KERNEL_REPS)
    ops, tree_bytes = walk_work("fat_shadow", nodes, rows, work)
    return entry(0.0, ms, plain_ms, nbytes(orig)
                 + anyhit_bytes((), d, tm, signs, kern) + tree_bytes, ops,
                 scan=tally)


def frame_shadow_calls(scene, cam, opts):
    """The arguments of every shared-origin any-hit call (B11c
    ``fat_shadow`` on a fat-leaf scene, B9b ``walk_shadow`` on node
    tables) of a 1024 x 1024 ``render_frame`` of ``scene`` with ``opts``,
    in the order of the frame's calls (``captured``; with bounces, the
    bounce wavefronts' shadow rays come first, the primary hits' last)."""
    from snail_tpu_torch.render.renderer import render_frame

    return captured(shared_kernel(scene), lambda: render_frame(
        scene, cam, WIDTH, HEIGHT, opts))


def shared_kernel(scene) -> str:
    """The shared-origin any-hit of a node-table scene: B11c or B9b."""
    from snail_tpu_torch.ops import traverse as pt

    return "fat_shadow" if pt.is_fat(scene) else "walk_shadow"


def bounce_shadow_calls(kind, scene, cam):
    """The bounce frame's shared-origin any-hit calls
    (``frame_shadow_calls``: B11c's, or B9b's on node tables) and the
    name of the light: light 0's if one of its wavefronts blocks a live
    ray, else (the terrain's overhead light blocks none) those of the
    same frame lit by the kind's low light."""
    from snail_tpu_torch.core.types import Light, RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.scene.bench_scenes import SCENES

    opts = RenderOpts(textures=False)
    calls = frame_shadow_calls(scene, cam, opts)
    kern = getattr(pt, shared_kernel(scene))
    if any(bool(kern(*a)[a[2] >= 0].any()) for a in calls) or (
            kind not in LOW_LIGHT):
        return "light 0", calls
    low = dataclasses.replace(scene, lights=Light.make(
        LOW_LIGHT[kind], (1.0, 1.0, 1.0), SCENES[kind][3]))
    return "low light", frame_shadow_calls(low, cam, opts)


def check_fat_bounce_shadows(name, kind, scene, cam):
    """B11c on the fat bounce frame's own shadow wavefronts
    (``bounce_shadow_calls``): the first of them in which the kernel
    blocks a live ray, as ``check_fat_shadow``. Returns its entry, with
    the wavefront's name."""
    from snail_tpu_torch.ops import traverse as pt

    light, calls = bounce_shadow_calls(kind, scene, cam)
    for i, args in enumerate(calls):
        if bool(pt.fat_shadow(*args)[args[2] >= 0].any()):
            break
    else:
        fail(f"{name} fat_shadow: no live ray of the bounce frame's "
             f"{len(calls)} shadow wavefronts is blocked")
    wave = f"bounce frame shadows, call {i + 1} of {len(calls)}, {light}"
    return {**check_fat_shadow(f"{name} {wave}", *args, False),
            "wavefront": wave}


def draw_packets(tm, seed, by_live):
    """SIM_PACKETS seeded packets of the (P, PACKET_R) ``tm`` with live
    rays; with ``by_live``, each drawn with a chance in proportion to its
    live rays (an instanced wavefront, where most packets hold a few)."""
    import numpy as np
    import torch

    n_live = (tm >= 0).sum(1).cpu().numpy()
    busy = np.flatnonzero(n_live)
    p = n_live[busy] / n_live[busy].sum() if by_live else None
    return torch.from_numpy(np.sort(np.random.default_rng(seed).choice(
        busy, min(SIM_PACKETS, len(busy)), replace=False, p=p))).to(
            tm.device)


def print_tally(name, kernel, pk, tally, closest):
    """The ``scan`` lines of a simulated tally (``warp_tally``,
    ``wl_tally``) of packets ``pk``: its counts per warp, the share of the
    leaf visits by their entering lanes and, for an any-hit, the rows
    tested up to a stop."""
    from snail_tpu_torch.ops import traverse as pt

    print_scan(name, kernel, tally)
    visits = max(tally["visits"], 1)
    print(f"scan {name} {kernel}: lanes entering a leaf visit (packets "
          f"{pk.tolist()}, outputs equal to the kernel's): "
          + ", ".join(f"{b} {tally[b] / visits:.4f}" for b in pt.LANE_BINS)
          + f" of {tally['visits']} visits; mean "
          f"{tally['lanes'] / visits:.3f} lanes and "
          f"{tally['rows'] / visits:.3f} rows a visit", flush=True)
    if not closest:
        lanes = max(tally["lanes"], 1)
        print(f"scan {name} {kernel}: rows tested up to a stop "
              f"{tally['tested'] / max(tally['lane_rows'], 1):.4f} of the "
              f"entering lanes' leaf rows, the longest lane "
              f"{tally['most'] / max(tally['rows'], 1):.4f} of a visit's "
              f"rows; entering lanes blocked in the visit "
              f"{tally['blocked'] / lanes:.4f}; visits still needing rows "
              f"33-64 {tally['chunk2']} of {tally['visits']}", flush=True)


def warp_tally(name, kernel, o, d, tm, rows, nodes, signs, kern, seed=6,
               by_live=False):
    """The warps of a closest hit (B9c, or B11b with ``signs``) or of an
    any-hit (B9d, or B11c/B11d with ``signs``; B11c's shared origin given
    as planes; B9b, ``walk_shadow``, with ``o`` its origin (3,)) on the
    raw ``rows``, on SIM_PACKETS seeded packets of the planes
    ``o``, ``d``, ``tm`` with live rays (``draw_packets``, its
    ``by_live``), simulated (ops/traverse_ref.py ``closest_g_sim`` /
    ``shadow_g_sim`` / ``shadow_sim``): their
    outputs must equal the kernel's, ``kern``, bit for bit; prints
    ``scan`` lines of their tally per warp (node steps, leaf visits, the
    lanes entering them and their rows, the rows tested up to a stop) and
    the share of the visits by their entering lanes, which decides how
    csrc/walk.cuh ``leaf_closest_staged`` / csrc/rays.cuh
    ``leaf_blocks_staged`` tests a leaf (node steps as ``walk`` takes
    them: B9c's and B9d's ``walk_pairs`` takes fewer); for an any-hit
    also the share of the entering lanes' rows they tested and of the
    lanes blocked, and of the visits of a leaf of more than 32 rows, those
    whose rows 33-64 some entering lane still needs. Returns the tally's
    sums."""
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref

    pk = draw_packets(tm, seed, by_live)
    sel = lambda c: c.index_select(0, pk).contiguous()
    closest = "closest" in kernel
    if kernel == "walk_shadow":
        out, _, tal = ref.shadow_sim(o, tuple(map(sel, d)), sel(tm), rows,
                                     nodes)
    else:
        sim = ref.closest_g_sim if closest else ref.shadow_g_sim
        out, _, tal = sim(tuple(map(sel, o)), tuple(map(sel, d)), sel(tm),
                          rows, nodes, None if signs is None else sel(signs))
    if closest:
        same = all(torch.equal(a, sel(b)) for a, b in zip(out, kern))
    else:
        same = torch.equal(out, sel(kern))
    if not same:
        fail(f"{name} {kernel}: the simulation's outputs on packets "
             f"{pk.tolist()} differ from the kernel's")
    tally = {"warps": tal.shape[1],
             **dict(zip(pt.TALLY, tal.sum(1).tolist()))}
    print_tally(name, kernel, pk, tally, closest)
    return tally


def wl_tally(name, o, d, tm, rows, lt, words, floors, kern, seed=6,
             by_live=False):
    """B7's warps on SIM_PACKETS seeded packets of the planes ``o``, ``d``,
    ``tm`` with live rays (``draw_packets``), simulated as the kernel
    scans (ops/traverse.py ``shadow_wl_g_sim``: ``scan_boxes`` and the
    staged any-hit leaf stage): their verdicts must equal the kernel's,
    ``kern``, bit for bit; prints ``scan`` lines per warp (words that
    reach the leaf level, blocks entered, leaves its cull keeps, bands
    entered) and the tally of its leaf visits, as ``warp_tally``. Returns
    the tally's sums."""
    import torch

    from snail_tpu_torch.ops import traverse as pt

    pk = draw_packets(tm, seed, by_live)
    sel = lambda c: c.index_select(0, pk).contiguous()
    blocked, cnt, tal = pt.shadow_wl_g_sim(
        tuple(map(sel, o)), tuple(map(sel, d)), sel(tm), rows, lt,
        sel(words), sel(floors))
    if not torch.equal(blocked, sel(kern)):
        fail(f"{name} shadow_wl_g: the simulation's verdicts on packets "
             f"{pk.tolist()} differ from the kernel's")
    cnt, t = cnt.sum(1).tolist(), tal.sum(1).tolist()
    tally = {"warps": tal.shape[1], "words entered": cnt[0],
             "blocks entered": cnt[5], "leaves kept": cnt[1],
             "bands entered": cnt[4],
             **dict(zip(pt.TALLY[1:], t[1:]))}
    print_tally(name, "shadow_wl_g", pk, tally, False)
    return tally


def check_walk_closest(name, scene, o, d, tm, scan=False):
    """B9c, or on a fat-leaf scene B11b, against its plain version on the
    planes ``o``, ``d``, ``tm``: the miss and masked conventions exactly
    (B11b's live miss returns min(tmax, BIG)), tri 0 where nothing was
    hit, the rest as ``closest_equal``; with ``scan``, the tally of its
    warps on a few packets (``warp_tally``). Returns (its entry, hit
    share of the live rays)."""
    import torch

    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref

    rows, nodes = scene.tri_rows, scene.nodes
    if pt.is_fat(scene):
        k, signs = "fat_closest", pt.packet_signs(d)
        call = lambda: pt.fat_closest(o, d, tm, signs, rows, nodes)
        plain_fn = lambda work: ref.fat_closest_plain(o, d, tm, signs, rows,
                                                      nodes, work)
        ins, miss_dist = (*o, *d, tm, signs), tm.clamp_max(BIG)
    else:
        k, signs = "walk_closest_g", None
        call = lambda: pt.walk_closest_g(o, d, tm, rows, nodes)
        plain_fn = lambda work: ref.walk_closest_g_plain(o, d, tm, rows,
                                                         nodes, work)
        ins, miss_dist = (*o, *d, tm), torch.full_like(tm, BIG)
    kern = call()
    work = {}
    plain, plain_ms = timed_plain(lambda: plain_fn(work))
    live = tm >= 0
    kd, kt = kern[0], kern[3]
    miss = live & (plain[0] == miss_dist)
    if not (bool((kd[~live] == -BIG).all())
            and bool((kd[miss] == miss_dist[miss]).all())
            and bool((kt[miss | ~live] == 0).all())):
        fail(f"{name} {k}: masked or miss conventions differ")
    err, share = closest_equal(f"{name} {k}", kern, plain, live)
    extra = ({"scan": warp_tally(name, k, o, d, tm, rows, nodes, signs,
                                 kern)} if scan else {})
    ms = cuda_ms(call, KERNEL_REPS)
    ops, tree_bytes = walk_work(k, nodes, rows, work)
    return entry(err, ms, plain_ms, nbytes(*ins, *kern) + tree_bytes, ops,
                 **extra), share


def anyhit_calls(scene, o, d, tm, signs):
    """B9d, or with ``signs`` (a fat-leaf scene) B11d, on the planes ``o``,
    ``d``, ``tm``: (kernel, its call, its plain version's call with a
    ``work`` dict)."""
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref

    rows, nodes = scene.tri_rows, scene.nodes
    if signs is not None:
        return ("fat_shadow_g",
                lambda: pt.fat_shadow_g(o, d, tm, signs, rows, nodes),
                lambda work: ref.fat_shadow_g_plain(o, d, tm, signs, rows,
                                                    nodes, work))
    return ("walk_shadow_g",
            lambda: pt.walk_shadow_g(o, d, tm, rows, nodes),
            lambda work: ref.walk_shadow_g_plain(o, d, tm, rows, nodes,
                                                 work))


def seeded_shadow_planes(scene, n_packets):
    """The seeded shadow rays of ``check_seeded_shadows`` for a node-table
    scene's any-hit, B9d (``general_planes``) or on a fat-leaf scene B11d
    (``padded_planes``: masked rays unsubstituted): the first seed whose
    blocked share of the live rays lies in 0.02-0.98. Returns (seed, o,
    d, tm, signs: B11d's packet signs, else None)."""
    import numpy as np
    import torch

    from snail_tpu_torch.ops import traverse as pt

    fat = pt.is_fat(scene)
    for seed in range(5, 25):
        o, d, tm = seeded_general(scene, n_packets, seed, planes=(
            pt.padded_planes if fat else pt.general_planes))
        rng = np.random.default_rng(seed)
        diag = float((scene.root_hi - scene.root_lo).norm())
        frac = torch.from_numpy(rng.uniform(0.05, 0.6, tuple(tm.shape))
                                .astype(np.float32)).cuda()
        tm = torch.where(tm >= 0, frac * diag, tm)
        signs = pt.packet_signs(d) if fat else None
        kern = anyhit_calls(scene, o, d, tm, signs)[1]()
        if 0.02 < float(kern[tm >= 0].mean()) < 0.98:
            return seed, o, d, tm, signs
    fail("no seeded shadow wavefront blocks 0.02-0.98 of its rays")


def anyhit_bytes(o, d, tm, signs, blocked) -> int:
    """The bytes of an any-hit's rays that it must move: tm and the verdict
    of every ray, the o and d planes of the live rays only (a masked ray
    needs no more than its tm), and B11d's ``signs`` (or None) of the
    packets with a live ray."""
    live = tm >= 0
    n = nbytes(tm, blocked) + int(live.sum()) * sum(
        c.element_size() for c in (*o, *d))
    if signs is not None:
        n += int(live.any(1).sum()) * signs.shape[1] * signs.element_size()
    return n


def check_walk_anyhit(name, scene, o, d, tm, signs, need_window=True,
                      by_live=False):
    """B9d, or with ``signs`` B11d, against its plain version on the planes
    ``o``, ``d``, ``tm``: verdicts identical, masked rays never blocked,
    with ``need_window`` a blocked share of the live rays in 0.02-0.98;
    and the tally of its warps on a few packets (``warp_tally``, its
    ``by_live``). Returns its entry (with the tally's sums)."""
    import torch

    k, call, plain_fn = anyhit_calls(scene, o, d, tm, signs)
    kern = call()
    live = tm >= 0
    share = float(kern[live].mean())
    work = {}
    plain, plain_ms = timed_plain(lambda: plain_fn(work))
    n_diff = int((kern != plain).sum())
    print(f"check {name} {k}: {n_diff} verdicts differ, blocked share "
          f"{share} of {int(live.sum())} live rays", flush=True)
    if (n_diff or bool(kern[~live].any())
            or (need_window and not 0.02 < share < 0.98)):
        fail(f"{name} {k}: {n_diff} verdicts differ, blocked share {share}")
    tally = warp_tally(name, k, o, d, tm, scene.tri_rows, scene.nodes,
                       signs, kern, by_live=by_live)
    ms = cuda_ms(call, KERNEL_REPS)
    ops, tree_bytes = walk_work(k, scene.nodes, scene.tri_rows, work)
    return entry(0.0, ms, plain_ms,
                 anyhit_bytes(o, d, tm, signs, kern) + tree_bytes, ops,
                 scan=tally)


def check_walk_seeded_shadows(name, scene, n_packets):
    """B9d, or on a fat-leaf scene B11d, on the seeded shadow rays of
    ``seeded_shadow_planes`` (``check_walk_anyhit``). Returns its
    entry."""
    seed, o, d, tm, signs = seeded_shadow_planes(scene, n_packets)
    return check_walk_anyhit(f"{name} seeded {seed}", scene, o, d, tm, signs)


def captured(name: str, fn):
    """The arguments of every call of the kernel wrapper
    ``ops.traverse.<name>`` while fn() runs (the wrapper still runs, and
    counts its launches on the name it looks itself up by)."""
    from snail_tpu_torch.ops import traverse as pt

    wrapper, calls = getattr(pt, name), []

    def record(*args):
        calls.append(args)
        return wrapper(*args)

    record.launches = wrapper.launches
    setattr(pt, name, record)
    try:
        fn()
    finally:
        setattr(pt, name, wrapper)
        wrapper.launches = record.launches
    return calls


def instanced_shadow_calls(kind, scene):
    """The instanced fwd frame of a grid of instances of the node-table
    scene ``scene`` (INSTANCE_GRID: 16 of the city, 4 of the terrain) and
    the arguments of its any-hit kernel's calls (B9d, or on a fat-leaf
    scene B11d), one per instance in order: light 0 in the instance's
    object space, rays whose segment misses its box or that an earlier
    instance blocked masked. Returns (instanced scene, camera, kernel
    name, [its arguments, one call per instance])."""
    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.scene.bench_scenes import instanced_grid
    from snail_tpu_torch.scene.instancing import render_instanced

    isc, icam = instanced_grid(kind, scene, INSTANCE_GRID[kind][0])
    k = "fat_shadow_g" if pt.is_fat(scene) else "walk_shadow_g"
    opts = RenderOpts(reflections=False, transparency=False, textures=False)
    return isc, icam, k, captured(
        k, lambda: render_instanced(isc, icam, WIDTH, HEIGHT, opts))


def check_walk_instanced_shadows(name, kind, scene):
    """B9d, or on a fat-leaf scene B11d, on the instanced frame's own
    shadow wavefront (``instanced_shadow_calls``): that of the first
    instance in which the kernel blocks a live ray (none is a failure:
    the terrain's overhead light blocks few rays, and a kernel that never
    blocks would pass on a wavefront with none), as ``check_walk_anyhit``,
    on the city with a blocked share in 0.02-0.98. Returns (the
    wavefront's name, its entry)."""
    from snail_tpu_torch.ops import traverse as pt

    isc, _, k, waves = instanced_shadow_calls(kind, scene)
    kern = getattr(pt, k)
    for i, args in enumerate(waves):
        if bool(kern(*args)[args[2] >= 0].any()):
            break
    else:
        fail(f"{name} {k}: no live ray of the x{len(waves)} instanced "
             "frame's shadow wavefronts is blocked")
    o, d, tm = args[:3]
    wave = f"x{len(waves)} instance {i} shadows"
    return wave, check_walk_anyhit(
        f"{name} {wave}", isc.base, o, d, tm,
        args[3] if pt.is_fat(scene) else None, need_window=kind == "city",
        by_live=True)


def against_frame(name, path, a, b):
    """A frame ``a`` against ``b``, the same geometry's frame on worklist
    leaf tables: within 2e-3 on >= 99.8 % of pixels."""
    err = (a - b).abs().amax(-1)
    off = float((err > 2e-3).float().mean())
    print(f"frame {name} {path}: against the worklist frame, share of "
          f"pixels off by > 2e-3: {off} (max {float(err.max())})",
          flush=True)
    if off > 2e-3:
        fail(f"{name} {path}: the frame differs from the worklist frame on "
             f"{off} of pixels")


def only_kernels(scene):
    """The kernels a node-table scene's frames may launch."""
    from snail_tpu_torch.ops import traverse as pt

    return FAT if pt.is_fat(scene) else WALK


def run_walk_frame(name, path, opts, need, walk, scene, cam, small, card):
    """Phase 6 (7), one walk (fat-leaf) path through render_frame on the
    node-table scene ``walk`` (see run_path; its own kernels only), and its
    1024 x 1024 frame against the worklist frame of ``scene``, the same
    geometry with leaf tables. Returns the launch counts."""
    from snail_tpu_torch.render.renderer import render_frame

    launches = run_path(name, path, need + GATHER,
                        lambda s, c, w, h: render_frame(s, c, w, h, opts),
                        walk, cam, small, card,
                        WIDTH * HEIGHT * (1 + len(walk.lights)),
                        only=only_kernels(walk) + GATHER)
    against_frame(name, path, render_frame(walk, cam, WIDTH, HEIGHT, opts),
                  render_frame(scene, cam, WIDTH, HEIGHT, opts))
    return launches


def run_walk_instanced(name, kind, walk, small, card, against=None):
    """Phase 6 (7), the instanced fwd frame on a grid of instances of the
    walk (fat-leaf) scene (B9c + B9d, or B11b + B11d, through the dispatch
    seam), as run_instanced's; with ``against``, a base scene of the same
    geometry with leaf tables, against its instanced frame. Returns the
    launch counts."""
    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.scene.bench_scenes import instanced_grid
    from snail_tpu_torch.scene.instancing import render_instanced

    grid, _ = INSTANCE_GRID[kind]
    isc, icam = instanced_grid(kind, walk, grid)
    opts = RenderOpts(reflections=False, transparency=False, textures=False)
    fat = pt.is_fat(walk)
    iname = f"{name} x{grid * grid}"
    path = f"{'fat' if fat else 'walk'} instanced fwd"
    launches = run_path(
        iname, path, FAT_INSTANCED if fat else WALK_INSTANCED,
        lambda s, c, w, h: render_instanced(s, c, w, h, opts), isc, icam,
        instanced_grid(kind, small[0], grid), card,
        WIDTH * HEIGHT * (1 + len(isc.lights)), INSTANCED_FRAMES,
        only=only_kernels(walk))
    if against is not None:
        wl, _ = instanced_grid(kind, against, grid)
        against_frame(iname, path,
                      render_instanced(isc, icam, WIDTH, HEIGHT, opts),
                      render_instanced(wl, icam, WIDTH, HEIGHT, opts))
    return launches


def run_portable(name, path, opts, tables, scene, cam, small, card,
                 against=None):
    """Phase 6 (7), the portable path: render_frame at PORTABLE_SIZE, which
    is not a multiple of the tile, through the integrator and the dispatch
    seam to the kernels of the scene's ``tables``, against the CPU path at
    PORTABLE_SMALL (see run_path); with ``against`` (the same geometry
    with leaf tables), against its frame. Returns the launch counts."""
    from snail_tpu_torch.render.renderer import render_frame

    w, h = PORTABLE_SIZE
    launches = run_path(name, path, PORTABLE[tables],
                        lambda s, c, w, h: render_frame(s, c, w, h, opts),
                        scene, cam, small, card,
                        w * h * (1 + len(scene.lights)), PORTABLE_FRAMES,
                        PORTABLE_SIZE, PORTABLE_SMALL)
    if against is not None:
        against_frame(name, path, render_frame(scene, cam, w, h, opts),
                      render_frame(against, cam, w, h, opts))
    return launches


def portable_step(scene, cam, target, width, height):
    """One fwd+bwd step of the portable fwd frame: the MSE of render_frame
    (no bounces, shadows on) against ``target`` and its gradients with
    respect to fresh copies of bench.py's 7 parameters (bench_scenes
    GRAD_PARAMS). Returns (loss, {name: gradient})."""
    import torch

    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.render.renderer import render_frame
    from snail_tpu_torch.scene.bench_scenes import grad_params, with_params

    params = grad_params(scene, cam)
    s, c = with_params(scene, cam, params)
    img = render_frame(s, c, width, height, RenderOpts(
        reflections=False, transparency=False, textures=False))
    loss = ((img - target) ** 2).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def run_portable_step(name, scene, cam, small, card):
    """Phase 6, one fwd+bwd step of the portable fwd frame at
    PORTABLE_SIZE: launch counts, a PORTABLE_STEP_SMALL step on the card
    against the CPU path (its target lit at half the light colour), with
    the tolerances of run_step, and ms/step. Returns the launch counts."""
    import numpy as np
    import torch

    from snail_tpu_torch.core.types import Light, RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.renderer import render_frame

    w, h = PORTABLE_SIZE
    fwd = RenderOpts(reflections=False, transparency=False, textures=False)
    target = render_frame(scene, cam, w, h, fwd)
    torch.cuda.synchronize()
    pt.reset_launch_counts()
    loss, grads = portable_step(scene, cam, target, w, h)
    torch.cuda.synchronize()
    launches = launched(name, "portable fwd_bwd", PORTABLE["leaves"])
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    if not np.isfinite(float(loss)) or bad:
        fail(f"{name} portable fwd_bwd: loss {float(loss)}, non-finite "
             f"grads {bad}")

    sscene, scam = small
    half = dataclasses.replace(sscene, lights=Light(
        pos=sscene.lights.pos, color=sscene.lights.color * 0.5,
        radius=sscene.lights.radius))
    sw, sh = PORTABLE_STEP_SMALL
    t = render_frame(half, scam, sw, sh, fwd)
    lk, gk = portable_step(sscene, scam, t, sw, sh)
    lc, gc = portable_step(sscene.to("cpu"), scam.to("cpu"), t.cpu(), sw, sh)
    lk, lc = float(lk), float(lc)
    ok = abs(lk - lc) < 3e-4 * max(1.0, abs(lc))
    worst = {}
    for k in gc:
        a, b = gk[k].cpu().numpy(), gc[k].numpy()
        denom = max(float(np.abs(b).max()), 1e-8)
        q, m = (float(np.quantile(np.abs(a - b), 0.999)) / denom,
                float(np.abs(a - b).mean()) / denom)
        worst[k] = (q, m)
        ok = ok and q < 5e-3 and m < 1e-3 and np.isfinite(a).all()
    print(f"step {name} portable fwd_bwd: launches {launches}; {sw}x{sh} "
          f"card vs CPU path, loss {lk} vs {lc}; grad |diff| q99.9 / mean "
          "over max |g|: " + ", ".join(f"{k} {q:.2e}/{m:.2e}"
                                       for k, (q, m) in worst.items()),
          flush=True)
    if not ok:
        fail(f"{name} portable fwd_bwd: {sw}x{sh} card step differs from "
             "the CPU path")
    ms = cuda_ms(lambda: portable_step(scene, cam, target, w, h),
                 PORTABLE_FRAMES)
    rays = w * h * (1 + len(scene.lights))
    print(f"step {name} portable fwd_bwd {w}x{h}: {ms:.3f} ms/step, "
          f"{rays / ms / 1e3:.2f} MRays/s, on {card}", flush=True)
    return launches


def kernel_lines(name, checks, launches):
    """The ``kernels`` line's entries of one scene's checks."""
    source = lambda k: (FAT_SRC if k in FAT else WALK_SRC if k in WALK
                        else GATHER_SRC if k in GATHER else SRC)
    return [{"name": f"{k}/{name}", "route": "cuda", "source": source(k),
             "replaces": REPLACES[k], "launches": launches[PATH_OF[k]][k],
             "path": PATH_OF[k],
             "launches_by_path": {p: n[k] for p, n in launches.items()},
             "library_ms": None, **e} for k, e in checks.items()]


def fat_scene(kind, n):
    """A benchmark scene of ``kind`` at size ``n`` built at leaf LEAF_PAD:
    node tables for the fat-leaf kernels. (scene, camera, geometry, BVH)."""
    from snail_tpu_torch.ops.traverse import LEAF_PAD
    from snail_tpu_torch.scene.bench_scenes import bench_scene

    t0 = time.perf_counter()
    scene, cam, g, bvh = bench_scene(kind, n, bounce=True, leaf=LEAF_PAD)
    nodes = scene.nodes
    print(f"scene {kind}_{n} leaf {LEAF_PAD}: {g.num_tris} tris, "
          f"{nodes.n_nodes} nodes, depth {nodes.depth}, leaf_max "
          f"{nodes.leaf_max}, host build {time.perf_counter() - t0:.2f} s",
          flush=True)
    return scene, cam, g, bvh


def run_fat(kind, wl, card):
    """Phase 7 on ``kind``'s fat-leaf scene (FAT_N, leaf LEAF_PAD): B11a-d
    against their plain versions over whole wavefronts, then the fat fwd,
    bounce, fwd_bwd, instanced fwd and portable fwd frames, each with its
    launches, against the CPU path at small size and against the same
    geometry's frame on leaf tables (``wl``, built here when None), and
    timed. Returns (name, {kernel: entry}, {path: launch counts})."""
    from snail_tpu_torch.core.types import Light, RenderOpts
    from snail_tpu_torch.scene.bench_scenes import SCENES, bench_scene

    n = FAT_N[kind]
    name = f"{kind}_{n}_leaf64"
    fat, cam, _, _ = fat_scene(kind, n)
    if wl is None:
        t0 = time.perf_counter()
        wl = bench_scene(kind, n, bounce=True)[0]
        print(f"scene {kind}_{n}: {wl.leaves.n_leaf} leaves (leaf "
              f"{SCENES[kind][1]}), host build "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    small = ((fat, cam) if FAT_SMALL_N[kind] == n
             else fat_scene(kind, FAT_SMALL_N[kind])[:2])
    if kind in LOW_LIGHT:
        small = (dataclasses.replace(small[0], lights=Light.make(
            LOW_LIGHT[kind], (1.0, 1.0, 1.0), SCENES[kind][3])), small[1])
    checks = check_walk_kernels(name, kind, fat, cam)
    fwd = RenderOpts(reflections=False, transparency=False, textures=False)
    launches = {
        "fat_fwd": run_walk_frame(name, "fat fwd", fwd, FAT_FWD, fat, wl,
                                  cam, small, card),
        "fat_bounce": run_walk_frame(name, "fat bounce",
                                     RenderOpts(textures=False), FAT_BOUNCE,
                                     fat, wl, cam, small, card),
        "fat_fwd_bwd": run_step(name, fat, cam, small, card, "fat fwd_bwd",
                                FAT_BOUNCE, wl),
        "fat_instanced_fwd": run_walk_instanced(name, kind, fat, small, card,
                                                wl),
        "fat_portable_fwd": run_portable(name, "fat portable fwd", fwd,
                                         "fat", fat, cam, small, card, wl),
    }
    return name, checks, launches


def textured(scene):
    """``scene`` with bench.py's ``section_tex`` checkerboard on every
    material and its summed-area tables (what ``bench_scene(...,
    textured="sat")`` builds, without the host build again)."""
    from snail_tpu_torch.scene.scene import with_sat
    from snail_tpu_torch.scene.textures import checker_atlas

    return with_sat(checker_atlas(scene))


def primary_mips(scene, cam):
    """The mip level histogram of the primary hits' texture samples (the
    footprint of their 32 x 32 quadrants, as ``render.fast`` computes it)
    and the hit mask in raster order."""
    import torch

    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.fast import _packets_to_image
    from snail_tpu_torch.scene.textures import mip_from_footprint, uv_footprint

    dist, u, v, tri, _, _, _ = pt.camera_trace(scene, cam, WIDTH, HEIGHT)
    hit = (dist > 0.0) & (dist < BIG)
    sh = scene.sh_pack.index_select(0, torch.where(hit, tri, 0).long()).T
    uv = torch.stack([sh[9] + sh[11] * u + sh[13] * v,
                      sh[10] + sh[12] * u + sh[14] * v], -1)
    w, h, n_mips, _ = scene.tex_meta[0]
    mip = mip_from_footprint(uv_footprint(uv, (32, 32), hit), w.float(),
                             h.float(), n_mips)
    hist = torch.bincount(mip[hit].long(), minlength=int(n_mips)).tolist()
    mask = hit.float()
    return hist, _packets_to_image(mask, mask, mask, WIDTH, HEIGHT)[..., 0] > 0


def beside(name, path, tex, flat, card, frames=TIMED_FRAMES,
           what=("texture", "untextured")):
    """A textured frame's ms beside its untextured twin's, timed in turns
    (untextured, textured, textured, untextured) over ``frames``; ``what``
    names the line and the twin (("photon", "photon-less") for the photon
    frames). Returns the ms added."""
    f1, t1, t2, f2 = (cuda_ms(fn, frames) for fn in (flat, tex, tex, flat))
    print(f"{what[0]} {name} {path}: {(t1 + t2) / 2:.3f} ms/frame (runs "
          f"{t1:.3f}, {t2:.3f}) beside the {what[1]} frame's "
          f"{(f1 + f2) / 2:.3f} ({f1:.3f}, {f2:.3f}): +"
          f"{(t1 + t2 - f1 - f2) / 2:.3f} ms, on {card}", flush=True)
    return (t1 + t2 - f1 - f2) / 2


def run_textured(name, kind, scene, cam, small, card):
    """Phase 8 on one phase-4 scene (see the module docstring). Returns
    {path: launch counts}."""
    import torch

    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.render.renderer import render_frame
    from snail_tpu_torch.scene.bench_scenes import instanced_grid
    from snail_tpu_torch.scene.instancing import render_instanced

    tex = textured(scene)
    tsmall = (textured(small[0]), small[1])
    hist, hitmask = primary_mips(tex, cam)
    used = sum(1 for n in hist if n)
    print(f"texture {name}: mip levels of the primary hits' samples (0 "
          f"up): {hist}, {used} levels used", flush=True)
    if used < (2 if kind == "terrain" else 1):
        fail(f"{name}: the primary hits sample {used} mip levels")
    rays = WIDTH * HEIGHT * (1 + len(scene.lights))
    frame = lambda opts: (lambda s, c, w, h: render_frame(s, c, w, h, opts))
    flat_opts = RenderOpts(reflections=False, transparency=False,
                           textures=False)
    flat = render_frame(scene, cam, WIDTH, HEIGHT, flat_opts)
    launches = {}
    for filt in TEX_FILTERS:
        opts = RenderOpts(reflections=False, transparency=False,
                          tex_filter=filt)
        path = f"tex {filt} fwd"
        launches[f"tex_{filt}_fwd"] = run_path(name, path, FORWARD + GATHER,
                                               frame(opts), tex, cam,
                                               tsmall, card, rays)
        img = render_frame(tex, cam, WIDTH, HEIGHT, opts)
        share = float(((img - flat).abs().amax(-1) > 1e-3)[hitmask]
                      .float().mean())
        print(f"texture {name} {path}: share of hit pixels the atlas "
              f"changes {share:.4f}", flush=True)
        if not share > 0:
            fail(f"{name} {path}: the atlas changes no hit pixel")
        beside(name, path, lambda: render_frame(tex, cam, WIDTH, HEIGHT,
                                                opts),
               lambda: render_frame(scene, cam, WIDTH, HEIGHT, flat_opts),
               card)
    if kind == "terrain":
        opts, flat_opts = RenderOpts(), RenderOpts(textures=False)
        launches["tex_bounce"] = run_path(name, "tex bounce", BOUNCE + GATHER,
                                          frame(opts), tex, cam, tsmall,
                                          card, rays)
        beside(name, "tex bounce",
               lambda: render_frame(tex, cam, WIDTH, HEIGHT, opts),
               lambda: render_frame(scene, cam, WIDTH, HEIGHT, flat_opts),
               card)
    else:
        w, h = PORTABLE_SIZE
        opts, flat_opts = RenderOpts(), RenderOpts(textures=False)
        launches["tex_portable"] = run_path(
            name, "tex portable", PORTABLE["leaves"], frame(opts), tex, cam,
            tsmall, card, w * h * (1 + len(scene.lights)), PORTABLE_FRAMES,
            PORTABLE_SIZE, PORTABLE_SMALL)
        beside(name, "tex portable",
               lambda: render_frame(tex, cam, w, h, opts),
               lambda: render_frame(scene, cam, w, h, flat_opts), card,
               PORTABLE_FRAMES)
        grid, _ = INSTANCE_GRID[kind]
        isc, icam = instanced_grid(kind, tex, grid)
        flat_isc, _ = instanced_grid(kind, scene, grid)
        opts = RenderOpts(reflections=False, transparency=False)
        iname = f"{name} x{grid * grid}"
        launches["tex_instanced_fwd"] = run_path(
            iname, "tex instanced fwd", INSTANCED,
            lambda s, c, w, h: render_instanced(s, c, w, h, opts), isc, icam,
            instanced_grid(kind, tsmall[0], grid), card,
            WIDTH * HEIGHT * (1 + len(isc.lights)), INSTANCED_FRAMES)
        beside(iname, "tex instanced fwd",
               lambda: render_instanced(isc, icam, WIDTH, HEIGHT, opts),
               lambda: render_instanced(flat_isc, icam, WIDTH, HEIGHT,
                                        dataclasses.replace(
                                            opts, textures=False)),
               card, INSTANCED_FRAMES)
    del tex, tsmall
    torch.cuda.empty_cache()
    return launches


def write_city_obj(directory, n):
    """city_scene(n)'s geometry as ``city.obj`` (its faces wound so that
    load_scene's flip gives the procedural winding; every 12 faces in the
    next of LOADED_MTL's three ``usemtl`` groups) and ``city.mtl``.
    Returns the OBJ's path."""
    import os

    from snail_tpu_torch.scene.procedural import city_scene

    (obj,) = city_scene(n).objects
    groups = ("concrete", "glass", "roof")
    lines = ["mtllib city.mtl"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in obj.verts]
    for i, (a, b, c) in enumerate(obj.tri_v + 1):
        if i % 12 == 0:
            lines.append(f"usemtl {groups[i // 12 % 3]}")
        lines.append(f"f {b} {a} {c}")
    path = os.path.join(directory, "city.obj")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(directory, "city.mtl"), "w") as f:
        f.write(LOADED_MTL)
    return path


def run_loaded(card, n=24):
    """Phase 8's loaded scene (see the module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from snail_tpu_torch.core.types import Camera, RenderOpts
    from snail_tpu_torch.render.renderer import render_frame
    from snail_tpu_torch.scene.scene import load_scene

    name = f"loaded_city_{n}"
    with tempfile.TemporaryDirectory() as d:
        obj = write_city_obj(d, n)
        scenes = []
        for when in ("cold", "cached"):
            t0 = time.perf_counter()
            scenes.append(load_scene(obj, cache_dir=d, device="cuda"))
            torch.cuda.synchronize()
            print(f"scene {name}: load_scene {when} (OBJ parse or geometry "
                  f"cache, BVH build or cache, MTL, upload) "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
        walk = load_scene(obj, cache_dir=d, device="cuda", walk=True)
    a, b = scenes
    same = (torch.equal(a.tri_rows, b.tri_rows)
            and all(torch.equal(getattr(a.leaves, k), getattr(b.leaves, k))
                    for k in ("box", "first", "count"))
            and torch.equal(a.mat_pack, b.mat_pack))
    print(f"scene {name}: {a.num_tris} tris, {a.leaves.n_leaf} leaves, "
          f"{a.mat_pack.shape[0]} materials (has_transp {a.has_transp}); "
          f"the cached scene's tables equal the cold one's: {same}",
          flush=True)
    if not same or not a.has_transp:
        fail(f"{name}: the cached scene differs from the cold one")
    lo, hi = a.root_lo.cpu().numpy(), a.root_hi.cpu().numpy()
    c = (lo + hi) * 0.5
    cam = Camera.look_at(pos=tuple(c + np.array([0.45, 0.35, 0.9])
                                   * float((hi - lo).max())),
                         target=tuple(c))
    opts = RenderOpts(reflections=False, transparency=False, textures=False)
    frame = lambda s, c, w, h: render_frame(s, c, w, h, opts)
    rays = WIDTH * HEIGHT * (1 + len(a.lights))
    run_path(name, "fwd", FORWARD + GATHER, frame, a, cam, (a, cam), card,
             rays)
    run_path(name, "walk fwd", WALK_FWD + GATHER, frame, walk, cam,
             (walk, cam), card, rays, only=WALK + GATHER)
    against_frame(name, "walk fwd", frame(walk, cam, WIDTH, HEIGHT),
                  frame(a, cam, WIDTH, HEIGHT))


def sample_planes(planes, n, seed=3):
    """``n`` seeded packets of the (o, d, tm) planes."""
    import numpy as np
    import torch

    o, d, tm = planes
    idx = torch.from_numpy(np.sort(np.random.default_rng(seed).choice(
        tm.shape[0], n, replace=False))).cuda()
    pick = lambda c: c.index_select(0, idx).contiguous()
    return tuple(map(pick, o)), tuple(map(pick, d)), pick(tm)


def photon_kernels(name, scene, walk):
    """B5/B6 and B9c on the photon wavefront: against their plain versions
    on PHOTON_PACKETS sampled packets (a quarter of them: the plain
    versions take ~40 ms a terrain packet), and each kernel's ms over the
    whole wavefront beside the word boxes B5 passes per packet."""
    from snail_tpu_torch.ops import traverse as pt

    from time_words import photon_planes

    planes = photon_planes(scene, PHOTONS)
    o, d, tm = planes
    sample = sample_planes(planes, PHOTON_PACKETS)
    out, share = check_general(f"{name} photons ({PHOTON_PACKETS} packets)",
                               scene, *sample)
    wout, wshare = check_walk_closest(
        f"{name} photons ({PHOTON_PACKETS} packets)", walk, *sample,
        scan=True)
    print_checks(f"{name} photons ({PHOTON_PACKETS} sampled packets)",
                 {**out, "walk_closest_g": wout})
    lt = scene.leaves
    words = pt.words_general(o, d, tm, lt)
    b5_ms, _ = words_ms(lambda: pt.words_general(o, d, tm, lt))
    b6_ms = cuda_ms(lambda: pt.closest_wl_g(o, d, tm, scene.tri_rows, lt,
                                            *words), PHOTON_REPS)
    b9c_ms = cuda_ms(lambda: pt.walk_closest_g(o, d, tm, walk.tri_rows,
                                               walk.nodes), PHOTON_REPS)
    tested = pt.general_word_tests(o, d, tm, lt)
    print(f"photon {name} wavefront ({PHOTONS} photons from light 0, "
          f"{tm.shape[0]} packets): words_general {b5_ms:.4f} ms, "
          f"closest_wl_g {b6_ms:.4f} ms, walk_closest_g {b9c_ms:.4f} ms; "
          f"word boxes passing per packet: mean "
          f"{float(tested.sum(1).float().mean()):.1f} of {tested.shape[1]}; "
          f"hit share of the sampled packets' live rays {share:.4f} "
          f"(walk {wshare:.4f})", flush=True)


def photon_oracle(scene, cam, pg, exposure):
    """The photon term the fwd frame must add on its primary hits (JAX
    tests/test_photon_render.py:27-64): diffuse x |d . n| x the gathered
    irradiance x exposure, as an image; and the mean gathered irradiance
    over the hits."""
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.fast import _packets_to_image, _surface
    from snail_tpu_torch.render.photons import gather_photons_grid

    dist, u, v, tri, dx, dy, dz = pt.camera_trace(scene, cam, WIDTH, HEIGHT)
    o3 = tuple(cam.pos)
    d3 = (dx, dy, dz)
    hit, sh, n3, p3 = _surface(scene, o3, d3, dist, u, v, tri)
    ndotd = torch.abs(d3[0] * n3[0] + d3[1] * n3[1] + d3[2] * n3[2])
    g = gather_photons_grid(pg, torch.stack(p3, -1))
    dc = [torch.where(hit, sh[16 + k] * ndotd, 0.0) for k in range(3)]
    want = [torch.where(hit, dc[k] * (g[:, k] * exposure), 0.0)
            for k in range(3)]
    return _packets_to_image(*want, WIDTH, HEIGHT), float(g[hit].mean())


def run_photon_frame(name, path, need, tables, scene, cam, small, card, pg,
                     exposure, only=None):
    """The fwd frame with the photon term (``photons``, ``exposure``) as a
    phase-4 path (run_path), its delta over the frame without photons
    equal to ``photon_oracle`` (rtol 1e-4, atol 1e-5), and its ms beside
    that frame's in turns. Returns (launches, ms added)."""
    import torch

    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.render.renderer import render_frame

    fwd = dict(reflections=False, transparency=False, textures=False)
    on = RenderOpts(photons=True, photon_exposure=exposure, **fwd)
    off = RenderOpts(**fwd)
    frame = lambda s, c, w, h: render_frame(s, c, w, h, on,
                                            photon_grid=pg.to(s.device))
    launches = run_path(name, path, need + GATHER, frame, scene, cam, small,
                        card, WIDTH * HEIGHT * (1 + len(scene.lights)),
                        only=None if only is None else only + GATHER)
    delta = (render_frame(scene, cam, WIDTH, HEIGHT, on, photon_grid=pg)
             - render_frame(scene, cam, WIDTH, HEIGHT, off))
    want, _ = photon_oracle(scene, cam, pg, exposure)
    err = float((delta - want).abs().max())
    ok = bool(torch.allclose(delta, want, rtol=1e-4, atol=1e-5))
    print(f"photon {name} {path} ({tables}): the frame's delta over the "
          f"photon-less frame is diffuse x |d.n| x gather x exposure on "
          f"the primary hits: {ok} (max |err| {err:.3e}, max delta "
          f"{float(delta.max()):.4f}, mean {float(delta.mean()):.5f})",
          flush=True)
    if not ok or not float(delta.max()) > 1e-2:
        fail(f"{name} {path}: the photon term differs from its oracle")
    added = beside(name, path, lambda: frame(scene, cam, WIDTH, HEIGHT),
                   lambda: render_frame(scene, cam, WIDTH, HEIGHT, off),
                   card, what=("photon", "photon-less"))
    return launches, added


def photon_corr(name, scene):
    """The grid's gather against the kd oracle's (tests/test_photons.py:
    62-83): PHOTON_KD_N photons, a 16^3 grid, 48 photons' positions, the kd
    radius one grid cell (the trilinear fetch's reach), each query with its
    photon's normal; corr > 0.5."""
    import numpy as np
    import torch

    from snail_tpu_torch.render.photons import (build_photon_kdtree,
                                                gather_photons_grid,
                                                gather_photons_kd,
                                                photon_grid, trace_photons)

    t0 = time.perf_counter()
    pmap = trace_photons(scene, n_per_light=PHOTON_KD_N, seed=7)
    kd = build_photon_kdtree(pmap)
    lo, hi = scene.root_lo, scene.root_hi
    pg = photon_grid(pmap, lo, hi, res=16)
    radius = float((hi - lo).max()) / 16
    sel = np.random.default_rng(0).choice(pmap.count, 48, replace=False)
    grid_v = gather_photons_grid(pg, torch.from_numpy(
        pmap.pos[sel]).cuda()).sum(1).cpu().numpy()
    kd_v = np.array([gather_photons_kd(kd, pmap, pmap.pos[i],
                                       pmap.normal[i], radius).sum()
                     for i in sel])
    corr = float(np.corrcoef(grid_v, kd_v)[0, 1])
    print(f"photon {name}: grid gather vs kd oracle on 48 of {pmap.count} "
          f"photons ({PHOTON_KD_N} shot, radius {radius:.3f}): corr "
          f"{corr:.4f}, {time.perf_counter() - t0:.2f} s with the kd build",
          flush=True)
    if not corr > 0.5:
        fail(f"{name}: the grid gather does not track the kd oracle ({corr})")


def run_photons(name, kind, scene, walk, cam, small, wsmall, card):
    """Phase 9 on one phase-4 scene and its walk twin (see the module
    docstring). Returns {path: launch counts}."""
    import torch

    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.photons import (photon_grid,
                                                render_photon_preview,
                                                trace_photons)
    from snail_tpu_torch.render.renderer import render_frame

    launches = {}
    for tables, s, need in (("leaves", scene, ("words_general",
                                               "closest_wl_g")),
                            ("nodes", walk, ("walk_closest_g",))):
        torch.cuda.synchronize()
        pt.reset_launch_counts()
        pmap = trace_photons(s, n_per_light=PHOTONS)
        key = "photon_trace" if tables == "leaves" else "walk_photon_trace"
        launches[key] = launched(name, key, need)
        ms = []
        for _ in range(PHOTON_TRACES):
            _, t = timed_plain(lambda: trace_photons(s, n_per_light=PHOTONS))
            ms.append(t)
        print(f"photon {name} trace_photons ({tables}): {pmap.count} of "
              f"{PHOTONS} photons hit, {sum(ms) / len(ms):.3f} ms (runs "
              + ", ".join(f"{t:.3f}" for t in ms) + f"; host clock, the "
              f"hits copied and compacted on the host), launches "
              f"{launches[key]}, on {card}", flush=True)
        if not 0.05 * PHOTONS < pmap.count <= PHOTONS:
            fail(f"{name} trace_photons ({tables}): {pmap.count} hits")
        if tables == "leaves":
            leaf_map = pmap
    photon_kernels(name, scene, walk)
    t0 = time.perf_counter()
    pg = photon_grid(leaf_map, scene.root_lo, scene.root_hi, res=PHOTON_RES)
    torch.cuda.synchronize()
    print(f"photon {name} photon_grid res {PHOTON_RES}: "
          f"{time.perf_counter() - t0:.3f} s host (splat and upload), "
          f"{pg.grid.numel() * pg.grid.element_size()} bytes on the card",
          flush=True)
    # an exposure that makes the mean photon term on the hits 0.25
    _, mean_g = photon_oracle(scene, cam, pg, 1.0)
    exposure = 0.25 / max(mean_g, 1e-30)
    print(f"photon {name}: mean gathered irradiance on the primary hits "
          f"{mean_g:.4e}, exposure {exposure:.4e}", flush=True)
    launches["photon_fwd"], _ = run_photon_frame(
        name, "photon fwd", FORWARD, "leaves", scene, cam, small, card, pg,
        exposure)
    launches["walk_photon_fwd"], _ = run_photon_frame(
        name, "walk photon fwd", WALK_FWD, "nodes", walk, cam, wsmall, card,
        pg, exposure, only=WALK)
    launches["photon_preview"] = run_path(
        name, "photon preview", ("words_general", "closest_wl_g"),
        lambda s, c, w, h: render_photon_preview(s, c, w, h, pg.to(s.device),
                                                 exposure),
        scene, cam, small, card, WIDTH * HEIGHT)
    if kind == "city":
        w, h = PORTABLE_SIZE
        opts = RenderOpts(textures=False, photons=True,
                          photon_exposure=exposure)
        flat = RenderOpts(textures=False)
        frame = lambda s, c, w, h: render_frame(s, c, w, h, opts,
                                                photon_grid=pg.to(s.device))
        launches["photon_portable_bounce"] = run_path(
            name, "photon portable bounce", PORTABLE["leaves"], frame, scene,
            cam, small, card, w * h * (1 + len(scene.lights)),
            PORTABLE_FRAMES, PORTABLE_SIZE, PORTABLE_SMALL)
        beside(name, "photon portable bounce",
               lambda: frame(scene, cam, w, h),
               lambda: render_frame(scene, cam, w, h, flat), card,
               PORTABLE_FRAMES, what=("photon", "photon-less"))
    photon_corr(name, scene)
    del pg, leaf_map, pmap
    torch.cuda.empty_cache()
    return launches


def with_border(vd):
    """``vd`` with a one-voxel shell of BORDER_VALUE on all six faces,
    where a mip ray done early takes its extra sample (ROADMAP C19)."""
    from snail_tpu_torch.volume.data import VolumeData

    data = vd.data.copy()
    for a in range(3):
        idx = [slice(None)] * 3
        idx[a] = [0, -1]
        data[tuple(idx)] = BORDER_VALUE
    return VolumeData(data=data)


def check_march(name, vt, rays, mode, max_steps):
    """V1 against _march_plain on ``rays``, bit for bit in best and hit_t.
    Returns ((best, hit_t), plain ms, max |kernel - plain| over both)."""
    import torch

    from snail_tpu_torch.ops.march import march
    from snail_tpu_torch.volume.vtree import _march_plain

    kern = march(vt, *rays, VOLUME_ISO, mode, max_steps)
    plain, plain_ms = timed_plain(
        lambda: _march_plain(vt, *rays, VOLUME_ISO, mode, max_steps))
    same = all(torch.equal(a, b) for a, b in zip(kern, plain))
    n_diff = int(sum((a != b).sum() for a, b in zip(kern, plain)))
    err = max(float((a - b).abs().max()) for a, b in zip(kern, plain))
    print(f"check {name} march {mode} max_steps {max_steps}: best and "
          f"hit_t equal the plain version's bit for bit: {same} ({n_diff} "
          f"values differ, max abs err {err}); plain {plain_ms:.1f} ms",
          flush=True)
    if not same:
        fail(f"{name} march {mode} max_steps {max_steps}: {n_diff} values "
             "differ from the plain version")
    return kern, plain_ms, err


def march_tally(vt, rays, iso, mode, max_steps):
    """What the march needs, from the steps of the plain loop: the body
    steps of live rays (in mip mode also the one extra step of ROADMAP
    C19 of each ray done before the loop ends), those that sample, and
    the bricks that hold a tap of some sample."""
    import torch

    from snail_tpu_torch.volume.vtree import (BRICK, _corners, _march_start,
                                              _march_step)

    o, d, t0, t1 = rays
    shape = vt.shape
    _, h, w = shape
    bricks = torch.zeros(vt.brick_max.shape, dtype=torch.bool,
                         device=t0.device)
    _, bh, bw = bricks.shape
    state = _march_start(t0, t1)
    extra_taken = torch.zeros_like(state[1])
    steps = samples = k = 0
    while k < max_steps and bool((~state[1]).any()):
        was_done = state[1]
        state, pos, sampled = _march_step(vt, o, d, t1, iso, mode, state)
        need = ~was_done
        if mode == "mip":
            need = need | (was_done & ~extra_taken)
            extra_taken = extra_taken | was_done
        steps += int(need.sum())
        samples += int((need & sampled).sum())
        idx, _ = _corners(pos[need & sampled], shape)
        z, y, x = idx // (h * w), idx // w % h, idx % w
        bricks.view(-1)[((z // BRICK * bh + y // BRICK) * bw
                         + x // BRICK).reshape(-1).long()] = True
        k += 1
    return steps, samples, int(bricks.sum())


def march_entry(name, vt, rays, mode, plain_ms, err):
    """V1's ms (CUDA events) beside its bound, from the plain loop's tally
    of this march (``march_tally``): the bytes of every brick some sample
    reads, the rays' tables (MARCH_RAY_BYTES) and their shared origin
    over the memory rate, the steps' operations (MARCH_OPS) over the
    float32 rate."""
    from snail_tpu_torch.ops.march import march

    steps, samples, bricks = march_tally(vt, rays, VOLUME_ISO, mode,
                                         MARCH_MAX_STEPS)
    ms = cuda_ms(lambda: march(vt, *rays, VOLUME_ISO, mode, MARCH_MAX_STEPS),
                 KERNEL_REPS)
    n_rays = rays[2].shape[0]
    ops = ((steps - samples) * MARCH_OPS["skip"]
           + samples * MARCH_OPS["sample"])
    e = entry(err, ms, plain_ms, bricks * 4 ** 3 * 4 + n_rays
              * MARCH_RAY_BYTES + MARCH_ORIGIN_BYTES, ops, steps=steps,
              samples=samples, bricks=bricks)
    print(f"kernel {name} march {mode}: {ms:.4f} ms beside its bound "
          f"{e['bound_ms']:.4f} ms ({e['bound_by']}; {steps} steps, "
          f"{samples} with a sample, {bricks} bricks read, {n_rays} rays), "
          f"plain {plain_ms:.1f} ms", flush=True)
    return e


def run_volume(card):
    """Phase 10 (see the module docstring). Returns the kernels line's
    entries of V1."""
    import tempfile

    import numpy as np
    import torch

    from snail_tpu_torch.apps.dicom_viewer import viewer_camera
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.volume.data import (load_dicom_dir,
                                             synthetic_sphere,
                                             write_dicom_file)
    from snail_tpu_torch.volume.vtree import (build_vtree, render_volume,
                                              volume_rays)

    n = VOLUME_N
    t0 = time.perf_counter()
    vd = synthetic_sphere(n)
    vt = build_vtree(vd)
    torch.cuda.synchronize()
    name = f"sphere_{n}"
    print(f"volume {name}: {n}^3 u16 ({n} slices of {n} x {n}), "
          f"{vt.vol.numel() * 4 / 2**20:.0f} MiB float32 on the card, "
          f"pyramid {tuple(vt.brick_max.shape)} / "
          f"{tuple(vt.coarse_max.shape)}, host build "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cam = viewer_camera(vt.shape)
    w, h = VOLUME_SIZE
    rays = volume_rays(vt, cam, w, h)
    miss = rays[2] > rays[3]
    print(f"volume {name}: {w}x{h} rays from the viewer's camera, "
          f"{int(miss.sum())} miss the volume", flush=True)
    # launches of V1 a view: march_kernel, and in mip mode also
    # mip_extra_kernel (C19)
    per_view = {"iso": ["march_kernel<ISO>"],
                "mip": ["march_kernel<MIP>", "mip_extra_kernel"]}
    entries, launches = {}, {}
    for mode in ("iso", "mip"):
        kern, plain_ms, err = check_march(name, vt, rays, mode,
                                          MARCH_MAX_STEPS)
        cut, _, cut_err = check_march(name, vt, rays, mode, MARCH_CUT_STEPS)
        if all(torch.equal(a, b) for a, b in zip(kern, cut)):
            fail(f"{name} march {mode}: max_steps {MARCH_CUT_STEPS} cut "
                 "no ray")
        entries[mode] = march_entry(name, vt, rays, mode, plain_ms,
                                    max(err, cut_err))
        torch.cuda.synchronize()
        pt.reset_launch_counts()
        img = render_volume(vt, cam, w, h, iso=VOLUME_ISO, mode=mode)
        torch.cuda.synchronize()
        launches[f"volume_{mode}"] = pt.launch_counts()
        hit = float((img.amax(-1) > 0).float().mean())
        if (launches[f"volume_{mode}"]["march"] != len(per_view[mode])
                or not bool(torch.isfinite(img).all())
                or not 0.05 < hit < 0.95 or not float(img.max()) > 0.5):
            fail(f"{name} {mode}: launches {launches[f'volume_{mode}']}, "
                 f"lit share {hit}, max {float(img.max())}")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: render_volume(vt, cam, w, h, iso=VOLUME_ISO,
                                           mode=mode), TIMED_FRAMES)
        peak = torch.cuda.max_memory_allocated() / 2**20
        print(f"frame {name} volume {mode} {w}x{h}: {ms:.3f} ms/frame, "
              f"launches {launches[f'volume_{mode}']}, lit share {hit:.4f}, "
              f"peak memory {peak:.1f} MiB (the volume included), on {card}",
              flush=True)

    # C19: the mip extra sample on a volume whose border is not empty
    bt = build_vtree(with_border(vd))
    bname = f"{name}_border"
    for mode in ("iso", "mip"):
        (best, _), _, err = check_march(bname, bt, rays, mode,
                                        MARCH_MAX_STEPS)
        _, _, cut_err = check_march(bname, bt, rays, mode, MARCH_CUT_STEPS)
        entries[mode]["max_abs_err"] = max(entries[mode]["max_abs_err"],
                                           err, cut_err)
    want = torch.full_like(best[miss], BORDER_VALUE / 65535)
    ok = bool(miss.any()) and bool(torch.allclose(best[miss], want,
                                                  rtol=1e-6, atol=0))
    print(f"check {bname} march mip: the {int(miss.sum())} rays that miss "
          f"the volume take the border's value {BORDER_VALUE / 65535:.6f} "
          f"from their extra sample (ROADMAP C19): {ok}", flush=True)
    if not ok:
        fail(f"{bname}: the mip extra sample is not the border's value")
    del bt

    # the CPU path at 64 x 64 on a 128^3 sphere
    small = build_vtree(synthetic_sphere(128))
    scam = viewer_camera(small.shape)
    for mode in ("iso", "mip"):
        a = render_volume(small, scam, 64, 64, iso=VOLUME_ISO, mode=mode)
        b = render_volume(small.to("cpu"), scam.to("cpu"), 64, 64,
                          iso=VOLUME_ISO, mode=mode)
        # the rays' norms are sums in another order on the card (as every
        # path's check_small allows): 2e-3 on all but 0.2 % of pixels
        err = (a.cpu() - b).abs().amax(-1)
        off = float((err > 2e-3).float().mean())
        print(f"frame sphere_128 volume {mode} 64x64: card vs CPU path, share "
              f"of pixels off by > 2e-3: {off} (max {float(err.max()):.3e})",
              flush=True)
        if off > 2e-3 or not float(b.max()) > 0.5:
            fail(f"sphere_128 volume {mode}: the card frame differs from "
                 "the CPU path")

    # a DICOM series: the sphere's middle slices written and read back
    lo = (n - DICOM_SLICES) // 2
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for i in range(DICOM_SLICES):
            write_dicom_file(f"{d}/{i:04d}.dcm", vd.data[lo + i],
                             slice_location=0.5 * i,
                             pixel_spacing=(0.4, 0.4))
        t1 = time.perf_counter()
        series = load_dicom_dir(d)
        t2 = time.perf_counter()
    same = bool(np.array_equal(series.data, vd.data[lo:lo + DICOM_SLICES]))
    st = build_vtree(series)
    img = render_volume(st, viewer_camera(st.shape), w, h, iso=VOLUME_ISO)
    lit = float((img.amax(-1) > 0).float().mean())
    print(f"volume dicom_{DICOM_SLICES}x{n}x{n}: written in {t1 - t0:.3f} s, "
          f"read back in {t2 - t1:.3f} s, equal: {same}, spacing "
          f"{series.spacing}; its iso frame {w}x{h}: lit share {lit:.4f}",
          flush=True)
    if not same or not lit > 0.01 or not bool(torch.isfinite(img).all()):
        fail("the DICOM series does not load back equal or render")
    del vt, st, small
    torch.cuda.empty_cache()
    return [{"name": f"march/{name}_{mode}", "route": "cuda",
             "source": VOL_SRC, "replaces": VOL_REPLACES,
             "launches": launches[f"volume_{mode}"]["march"],
             "launched": per_view[mode], "path": f"volume_{mode}",
             "launches_by_path": {p: c["march"] for p, c in launches.items()},
             **e, "library_ms": None} for mode, e in entries.items()]


def served_sync_sites(scene, req, opts):
    """The host syncs of the server's per-frame work on its frame loop
    (camera, lights, render_frame; the encoder's copy to the host aside),
    as ``torch.cuda.set_sync_debug_mode`` reports them: file:line -> count."""
    import collections
    import warnings

    import torch

    from snail_tpu_torch.core.types import Camera, Light
    from snail_tpu_torch.render.renderer import render_frame

    sites = collections.Counter()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cam = Camera.look_at(pos=req.cam_pos, target=req.cam_target)
            s = scene.with_lights(Light.stack([Light.make(
                tuple(l["pos"]), tuple(l["color"]), float(l["radius"]))
                for l in req.lights]))
            render_frame(s, cam, WIDTH, HEIGHT, opts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "synchroniz" in str(w.message):
            sites[f"{w.filename}:{w.lineno}"] += 1
    torch.cuda.synchronize()
    return dict(sites)


def run_apps(card, n=24):
    """Phase 11 (see the module docstring). Returns {path: launch counts}
    of the served frames, the stats frame and rtracer's frame."""
    import os
    import socket
    import tempfile
    import threading

    import numpy as np
    import torch
    from PIL import Image

    from snail_tpu_torch.apps import client, rtracer, server
    from snail_tpu_torch.core.types import Camera, Light, RenderOpts
    from snail_tpu_torch.net import codec
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.fast import render_frame_fast_stats
    from snail_tpu_torch.render.renderer import (Renderer, render_frame,
                                                 to_rgb8)
    from snail_tpu_torch.scene.bench_scenes import SCENES
    from snail_tpu_torch.scene.scene import load_scene
    from snail_tpu_torch.utils.image import save_image
    from snail_tpu_torch.utils.stats import tree_stats_from_counters

    name = f"served_city_{n}"
    opts = RenderOpts()  # the server's options for a request without gVals
    if not codec.native_available():
        fail(f"{name}: the native codec did not build")
    _, _, lpos, radius, _ = SCENES["city"]
    light = {"pos": list(lpos), "color": [1.0, 1.0, 1.0], "radius": radius}
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        obj = write_city_obj(d, n)
        scene = load_scene(obj, lights=Light.make(
            light["pos"], light["color"], light["radius"]))
        lo, hi = scene.root_lo.cpu().numpy(), scene.root_hi.cpu().numpy()
        # run_loaded's camera, rounded so that its text (rtracer's --cam)
        # parses back to the same floats
        tgt = np.round((lo + hi).astype(np.float64) * 0.5, 3)
        pos = np.round(tgt + np.array([0.45, 0.35, 0.9])
                       * float((hi - lo).max()), 3)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        rc = []
        th = threading.Thread(target=lambda: rc.append(server.serve(
            srv, d, device="cuda", sessions=2)), daemon=True)
        th.start()
        sessions = {}
        for path, frames, stats in (("served", APPS_FRAMES, False),
                                    ("served_stats", 1, True)):
            got = []
            torch.cuda.synchronize()
            pt.reset_launch_counts()
            client.run_client("127.0.0.1", port, "city.obj", WIDTH, HEIGHT,
                              frames, pos, tgt, [light], stats=stats,
                              on_frame=lambda *a: got.append(a))
            torch.cuda.synchronize()
            launches[path] = launched(name, path,
                                      (STATS if stats else BOUNCE) + GATHER)
            sessions[path] = got
        th.join(APPS_TIMEOUT_S)
        if th.is_alive() or rc != [0]:
            fail(f"{name}: the server did not end its sessions cleanly "
                 f"({rc})")
        for path, got in sessions.items():
            for f, req, img, st, dt, kb in got:
                cam = Camera.look_at(pos=req.cam_pos, target=req.cam_target)
                if st["measured"]:
                    ref, counts = render_frame_fast_stats(
                        scene, cam, WIDTH, HEIGHT,
                        RenderOpts(stats=True))
                    want = tree_stats_from_counters(counts, 1).to_dict()
                    stat_ok = all(st[k] == want[k] for k in (
                        "intersects", "loop_iters", "rays", "runs"))
                else:
                    ref, stat_ok = render_frame(scene, cam, WIDTH, HEIGHT,
                                                opts), True
                same = np.array_equal(img, to_rgb8(ref))
                print(f"served {name} {path} frame {f} {WIDTH}x{HEIGHT}: "
                      f"client {dt * 1e3:.3f} ms, server render_ms "
                      f"{st['render_ms']:.3f}, encode_ms "
                      f"{st['encode_ms']:.3f}, {kb:.1f} KB a frame; "
                      f"equal to render_frame bit for bit: {same}; "
                      f"measured {st['measured']} (intersects "
                      f"{st['intersects']}, loop_iters {st['loop_iters']}, "
                      f"rays {st['rays']}), on {card}", flush=True)
                if not same or not stat_ok or st["measured"] != (
                        path == "served_stats"):
                    fail(f"{name} {path} frame {f}: the served frame or its "
                         f"stats differ from the port's frame")
        sites = served_sync_sites(scene, sessions["served"][0][1], opts)
        print(f"served {name}: host syncs of the frame loop's work for one "
              f"frame: {sites or 'none'}", flush=True)
        if sites:
            fail(f"{name}: the frame loop syncs with the card: {sites}")

        out = os.path.join(d, "rtracer")
        cam_arg = ",".join(map(str, pos)) + ":" + ",".join(map(str, tgt))
        torch.cuda.synchronize()
        pt.reset_launch_counts()
        rtracer.main([obj, "-r", f"{WIDTH}x{HEIGHT}", "--out-dir", out,
                      "--cam", cam_arg, "--light",
                      ":".join(",".join(map(str, light[k]))
                               for k in ("pos", "color")) + f":{radius}"])
        torch.cuda.synchronize()
        launches["rtracer"] = launched(name, "rtracer", BOUNCE + GATHER)
        cam = Camera.look_at(pos=tuple(client.orbit_pos(tgt, pos - tgt, 0,
                                                         1)),
                             target=tuple(tgt))
        save_image(os.path.join(d, "ref.png"),
                   Renderer(scene, WIDTH, HEIGHT, opts).render(cam))
        png, ref = (np.asarray(Image.open(os.path.join(*p))) for p in (
            (out, "output_000.png"), (d, "ref.png")))
        same = png.shape == (HEIGHT, WIDTH, 3) and np.array_equal(png, ref)
        print(f"rtracer {name}: output_000.png equal to Renderer.render's "
              f"frame: {same}", flush=True)
        if not same:
            fail(f"{name}: rtracer's PNG differs from Renderer.render's")
    return launches


def run_distributed(card, n=24):
    """Phase 12 (see the module docstring). Returns {path: launch
    counts} of the sharded frame and step."""
    import torch

    name = f"city_{n}"
    scene, cam, _, _ = make_scene("city", n)
    # the step's backward scatter-adds its gradients (the backward of a
    # gather), atomically on the card unless in deterministic mode: so two
    # steps agree bit for bit there only
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return sharded_phase(card, name, scene, cam)
    finally:
        torch.use_deterministic_algorithms(False)


def sharded_phase(card, name, scene, cam):
    """Phase 12 on ``scene`` in deterministic mode (see run_distributed)."""
    import tempfile

    import torch
    import torch.distributed as tdist

    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.parallel import distributed as pdist
    from snail_tpu_torch.parallel.mesh import (make_mesh,
                                               render_frame_sharded,
                                               train_step_sharded)
    from snail_tpu_torch.render.renderer import render_frame_portable

    w = h = SHARDED_SIZE
    bounce = RenderOpts(textures=False)
    fwd = RenderOpts(reflections=False, transparency=False, textures=False)
    params = {"tri_a": scene.tri_a, "mat_diffuse": scene.mat_diffuse}
    target = torch.zeros(h, w, 3, device=scene.device)
    ref_img = render_frame_portable(scene, cam, w, h, bounce)
    ref_loss, ref_new = train_step_sharded(scene, params, target, cam, w, h,
                                           fwd, make_mesh())
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        tdist.init_process_group("nccl", init_method=f"file://{d}/store",
                                 world_size=1, rank=0)
        try:
            backend = tdist.get_backend()
            mesh = pdist.global_mesh()
            print(f"distributed {name}: process group on {backend}, world "
                  f"size {tdist.get_world_size()}, mesh size {mesh.size}",
                  flush=True)
            if backend != "nccl" or mesh.group is None:
                fail(f"{name}: no NCCL process group ({backend})")
            s = pdist.replicate_scene(scene, mesh)
            torch.cuda.synchronize()
            pt.reset_launch_counts()
            img = render_frame_sharded(s, cam, w, h, bounce, mesh)
            torch.cuda.synchronize()
            launches["sharded"] = launched(name, "sharded",
                                           PORTABLE["leaves"])
            pt.reset_launch_counts()
            loss, new = train_step_sharded(s, params, target, cam, w, h, fwd,
                                           mesh)
            torch.cuda.synchronize()
            launches["sharded_step"] = launched(name, "sharded_step",
                                                PORTABLE["leaves"])
            frame_same = torch.equal(img, ref_img)
            diff = {k: float((new[k] - ref_new[k]).abs().max()) for k in new}
            step_same = (torch.equal(loss, ref_loss)
                         and all(torch.equal(new[k], ref_new[k])
                                 for k in new))
            print(f"distributed {name} sharded {w}x{h}: frame equal to "
                  f"render_frame_portable bit for bit: {frame_same}; step "
                  f"(loss {float(loss)} beside {float(ref_loss)}, new "
                  f"parameters' max |diff| {diff}) equal to the step "
                  f"without a process group bit for bit: {step_same}; "
                  f"launches frame {launches['sharded']}, step "
                  f"{launches['sharded_step']}", flush=True)
            if not frame_same or not step_same:
                fail(f"{name}: the sharded frame or step differs")
            beside(name, f"sharded {w}x{h}",
                   lambda: render_frame_sharded(s, cam, w, h, bounce, mesh),
                   lambda: render_frame_portable(scene, cam, w, h, bounce),
                   card, PORTABLE_FRAMES, ("sharded", "portable"))
            rows = pdist.scaling_report(s, cam, w, h, bounce, [1],
                                        frames=PORTABLE_FRAMES)
            print(f"distributed {name}: scaling_report {rows}, on {card}",
                  flush=True)
            if [r["devices"] for r in rows] != [1] or not rows[0]["ms"] > 0:
                fail(f"{name}: scaling_report rows {rows}")
        finally:
            tdist.destroy_process_group()
    return launches


def oracle_check(name, scene, cam, kern, seed=17):
    """tools/bench_big.py's oracle spot check: ORACLE_RAYS seeded primary
    rays of the frame (``kern``: B2's whole-wavefront outputs) against
    ``ops.intersect.intersect_brute_force``'s rule over every triangle of
    the scene, ORACLE_TRIS triangles a step on the card: the distance
    within 1e-3 relative (or both a miss) on >= ORACLE_AGREE of the rays;
    prints the triangle and the distance's exact agreement too."""
    import numpy as np
    import torch

    from snail_tpu_torch.core.vecmath import BIG
    from snail_tpu_torch.ops.intersect import intersect_tris

    n_rays = kern[0].numel()
    sel = torch.from_numpy(np.random.default_rng(seed).choice(
        n_rays, ORACLE_RAYS, replace=False)).cuda()
    kd, kt = kern[0].reshape(-1)[sel], kern[3].reshape(-1)[sel]
    d = torch.stack([c.reshape(-1)[sel] for c in kern[4:7]], -1)
    o = cam.pos.expand_as(d)
    best = torch.full_like(kd, BIG)
    tri = torch.full_like(kt, -1)
    t0 = time.perf_counter()
    a, ba, ca = scene.tri_a, scene.tri_ba, scene.tri_ca
    for s in range(0, a.shape[0], ORACLE_TRIS):
        dist, _, _, _ = intersect_tris(o, d, a[s:s + ORACLE_TRIS],
                                       ba[s:s + ORACLE_TRIS],
                                       ca[s:s + ORACLE_TRIS])
        m, j = dist.min(-1)
        upd = m < best
        best = torch.where(upd, m, best)
        tri = torch.where(upd, (j + s).to(tri.dtype), tri)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    both_miss = (kd >= BIG) & (best >= BIG)
    close = (kd - best).abs() <= 1e-3 * best.abs().clamp_min(1.0)
    agree = float((both_miss | close).float().mean())
    hit = best < BIG
    same_tri = float((kt[hit] == tri[hit]).float().mean())
    exact = float((kd == best).float().mean())
    print(f"oracle {name}: {ORACLE_RAYS} seeded primary rays against the "
          f"brute force over {a.shape[0]} triangles ({secs:.2f} s on the "
          f"card): distance agreement {agree:.4f} (>= {ORACLE_AGREE}), "
          f"same triangle on {same_tri:.4f} of {int(hit.sum())} hits, "
          f"distance bit for bit on {exact:.4f}", flush=True)
    if agree < ORACLE_AGREE or not float(hit.float().mean()) > 0.3:
        fail(f"{name}: the frame's hits disagree with the brute force "
             f"({agree})")
    return {"agree": agree, "same_tri": same_tri, "exact": exact,
            "seconds": secs}


def frame_10m(name, path, scene, cam, need, card):
    """Phase 13, one fwd frame of bench.py's 10 Mtri row at 1024 x 1024
    (render_frame with bench_scenes.OPTS_10M): the launches of one frame
    (each kernel of ``need``, and no other), the image finite and not all
    zero, ms/frame by CUDA events around each of TIMED_FRAMES frames (min,
    avg, max), MRays/s by bench.py's count (2 W H), peak memory. Returns
    (image, launches, numbers)."""
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.renderer import render_frame
    from snail_tpu_torch.scene.bench_scenes import OPTS_10M

    frame = lambda: render_frame(scene, cam, WIDTH, HEIGHT, OPTS_10M)
    torch.cuda.synchronize()
    pt.reset_launch_counts()
    img = frame()
    torch.cuda.synchronize()
    launches = launched(name, path, need)
    if any(n for k, n in launches.items() if k not in need):
        fail(f"{name} {path}: a kernel outside {need} ran: {launches}")
    if (tuple(img.shape) != (HEIGHT, WIDTH, 3)
            or not bool(torch.isfinite(img).all())
            or not float(img.abs().max()) > 0):
        fail(f"{name} {path}: image {tuple(img.shape)} not finite or all "
             "zero")
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(TIMED_FRAMES)]
    for a, b in events:
        a.record()
        frame()
        b.record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    peak = torch.cuda.max_memory_allocated() / 2**20
    avg = sum(ms) / len(ms)
    rays = 2 * WIDTH * HEIGHT
    nums = {"ms_min": min(ms), "ms_avg": avg, "ms_max": max(ms),
            "mrays": rays / avg / 1e3, "peak_mib": peak}
    print(f"frame {name} {path} {WIDTH}x{HEIGHT}: launches {launches}; "
          f"{avg:.3f} ms/frame (min {min(ms):.3f}, max {max(ms):.3f} over "
          f"{TIMED_FRAMES} frames), {nums['mrays']:.2f} MRays/s ({rays} rays "
          f"as bench.py counts), peak memory {peak:.1f} MiB, mean "
          f"{float(img.mean()):.6f}, on {card}", flush=True)
    return img, launches, nums


def kernels_10m(name, scene, walk, cam):
    """Phase 13's kernel checks on the 10 Mtri frame's wavefronts: B1 and
    B3 against their plain versions on PACKETS_10M seeded packets, B2
    (``camera_plain_packets``) and B4 on seeded packets, each timed on
    the whole wavefront beside its bound over the whole wavefront; the
    brute-force spot check (``oracle_check``); B2 and B4 bit for bit B8a
    and B8b on the shared-origin rows (``raw_against_shared``), and the
    time of each shared-origin table (``shared_rows``) that they build
    and B2, B4, B9a and B9b do not; B4 also toward the low light, where
    rays are blocked; B9a and B9b on the node tables against their plain
    versions over their whole wavefronts. Returns ({kernel: entry}, {what:
    numbers})."""
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.ops import traverse_ref as ref
    from snail_tpu_torch.render.fast import shadow_wavefront

    w, h = WIDTH, HEIGHT
    p = (w // pt.TILE) * (h // pt.TILE)
    lt, rows = scene.leaves, scene.tri_rows
    cv = pt.cam_vec(cam, w, h, scene.root_lo, scene.root_hi)
    pk = seeded_packets(p, PACKETS_10M, 13)
    pids = torch.arange(p, device="cuda")
    out, extra = {}, {}

    # B1 on the seeded packets
    kern = pt.words_camera(cv, w, h, lt)
    plain, plain_ms = timed_plain(
        lambda: pt.words_camera_plain(cv, w, h, lt, pt.WL_BANDS, pk))
    err = words_err(tuple(a[pk] for a in kern), plain, f"{name} words_camera")
    ms, event_ms = words_ms(lambda: pt.words_camera(cv, w, h, lt))
    tested = pt.camera_word_tests(cv, w, h, lt, pids)
    if bool((kern[0].ne(0).any(1) & ~tested).any()):
        fail(f"{name} words_camera: a bit set in a word whose box fails")
    print_passing(name, "words_camera", tested)
    out["words_camera"] = words_entry("words_camera", err, ms, plain_ms, lt,
                                      (cv,), kern, tested, event_ms)
    out["words_camera"]["plain_packets"] = len(pk)
    words, summ, floors = kern

    # B2 on the raw rows
    call = lambda: pt.camera_wl(cv, w, h, rows, lt, words, summ, floors)
    b2 = call()
    err, plain_ms = camera_plain_packets(name, cv, rows, lt, words, b2, pk)
    ms = cuda_ms(call, KERNEL_REPS)
    ops, n_bytes, _ = camera_work(name, "camera_wl", cv, rows, lt, words,
                                  summ, floors, b2, scan=False)
    out["camera_wl"] = entry(err, ms, plain_ms, n_bytes, ops,
                             plain_packets=len(pk))
    extra["oracle"] = oracle_check(name, scene, cam, b2)
    srows = pt.shared_rows(rows, cam.pos)
    extra["camera raw vs shared, values that differ"] = raw_against_shared(
        f"{name} camera_wl", b2, pt.camera_wl_stats(cv, w, h, srows, lt,
                                                    words, summ, floors)[:7])
    extra["shared_rows ms"] = cuda_ms(lambda: pt.shared_rows(rows, cam.pos),
                                      KERNEL_REPS)
    print(f"table {name} shared_rows: {extra['shared_rows ms']:.4f} ms a "
          f"frame and origin (B8a/B8b's; B2, B4, B9a and B9b build none), "
          f"on {card_line()}", flush=True)
    del srows

    # B3 and B4 toward light 0 (the frame's) and the low light
    primary = ((cam.pos[0], cam.pos[1], cam.pos[2]),
               tuple(c.reshape(-1) for c in b2[4:7]),
               *(c.reshape(-1) for c in b2[:4]))
    pkp = lambda a: a.reshape(-1, pt.PACKET_R).contiguous()
    for label, lp in (("light 0", scene.lights.pos[0]),
                      ("low light", torch.tensor(LOW_LIGHT["terrain"],
                                                 device="cuda"))):
        d, tm = shadow_wavefront(scene, *primary, lp)
        orig, d, tm = lp.contiguous(), tuple(map(pkp, d)), pkp(tm)
        live = tm >= 0
        sw = pt.words_shared(orig, d, tm, lt, 1)
        sub = lambda: (tuple(c[pk] for c in d), tm[pk])
        plain, words_plain_ms = timed_plain(
            lambda: pt.words_shared_plain(orig, *sub(), lt, 1))
        werr = words_err(tuple(a[pk] for a in sw), plain,
                         f"{name} {label} words_shared")
        kb = pt.shadow_wl(orig, d, tm, rows, lt, *sw)
        plain, plain_ms = timed_plain(lambda: pt.shadow_wl_plain(
            orig, *sub(), rows, lt, sw[0][pk]))
        frac = float(kb[live].mean())
        n_diff = int((kb[pk] != plain).sum())
        print(f"check {name} {label} shadow_wl: {n_diff} verdicts differ "
              f"on {len(pk)} packets, blocked share {frac} of "
              f"{int(live.sum())} live rays", flush=True)
        if n_diff or bool(kb[~live].any()) or frac >= 0.98 or (
                label == "low light" and frac <= 0.02):
            fail(f"{name} {label} shadow_wl: {n_diff} verdicts differ, "
                 f"blocked share {frac}")
        lrows = pt.shared_rows(rows, orig)
        extra[f"{label} raw vs shared, values that differ"] = (
            raw_against_shared(f"{name} {label} shadow_wl", kb,
                               pt.shadow_wl_stats(orig, d, tm, lrows, lt,
                                                  *sw)[0]))
        del lrows
        if label != "light 0":
            continue
        ms, event_ms = words_ms(lambda: pt.words_shared(orig, d, tm, lt, 1))
        tested = pt.shared_word_tests(orig, d, tm, lt)
        out["words_shared"] = words_entry(
            "words_shared", werr, ms, words_plain_ms, lt, (orig, *d, tm), sw,
            tested, event_ms)
        out["words_shared"]["plain_packets"] = len(pk)
        ms = cuda_ms(lambda: pt.shadow_wl(orig, d, tm, rows, lt, *sw),
                     KERNEL_REPS)
        ops, n_bytes, _ = shadow_work(name, "shadow_wl", orig, d, tm, rows,
                                      lt, *sw, kb, scan=False)
        out["shadow_wl"] = entry(0.0, ms, plain_ms, n_bytes, ops,
                                 plain_packets=len(pk))

    # B9a and B9b on the node tables, whole wavefronts
    nodes = walk.nodes
    call = lambda: pt.walk_camera(cv, w, h, rows, nodes)
    kern = call()
    work = {}
    plain, plain_ms = timed_plain(lambda: ref.walk_camera_plain(
        cv, w, h, rows, nodes, pids, work))
    if not all(torch.equal(a, b) for a, b in zip(kern[4:], plain[4:])):
        fail(f"{name} walk_camera: directions differ from the plain version")
    err, _ = closest_equal(f"{name} walk_camera", kern[:4], plain[:4],
                           torch.ones_like(kern[0], dtype=torch.bool))
    ms = cuda_ms(call, KERNEL_REPS)
    ops, tree_bytes = walk_work("walk_camera", nodes, rows, work)
    out["walk_camera"] = entry(err, ms, plain_ms,
                               nbytes(cv, *kern) + tree_bytes, ops)
    primary = ((cam.pos[0], cam.pos[1], cam.pos[2]),
               tuple(c.reshape(-1) for c in kern[4:7]),
               *(c.reshape(-1) for c in kern[:4]))
    d, tm = shadow_wavefront(walk, *primary, walk.lights.pos[0])
    orig, d, tm = walk.lights.pos[0].contiguous(), tuple(map(pkp, d)), pkp(tm)
    call = lambda: pt.walk_shadow(orig, d, tm, rows, nodes)
    kb = call()
    work = {}
    plain, plain_ms = timed_plain(lambda: ref.walk_shadow_plain(
        orig, d, tm, rows, nodes, work))
    live = tm >= 0
    n_diff = int((kb != plain).sum())
    print(f"check {name} walk_shadow: {n_diff} verdicts differ, blocked "
          f"share {float(kb[live].mean())} of {int(live.sum())} live rays",
          flush=True)
    if n_diff or bool(kb[~live].any()):
        fail(f"{name} walk_shadow: {n_diff} verdicts differ")
    ms = cuda_ms(call, KERNEL_REPS)
    ops, tree_bytes = walk_work("walk_shadow", nodes, rows, work)
    out["walk_shadow"] = entry(0.0, ms, plain_ms, nbytes(orig)
                               + anyhit_bytes((), d, tm, None, kb)
                               + tree_bytes, ops)
    print_checks(name, out)
    return out, extra


def run_10m(card):
    """Phase 13 (see the module docstring): bench.py's 10 Mtri scene on
    leaf tables (B1-B4) and on node tables (B9a, B9b). Returns the kernels
    line's entries."""
    import dataclasses

    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.scene import bench_scenes as bs

    scene, cam, g, bvh, secs = bs.scene_10m()
    name = f"terrain_10m_{bs.BENCH_N['terrain_10m']}"
    if scene.leaves is None:
        fail(f"{name}: {int((bvh.count > 0).sum())} leaves, more than leaf "
             "tables hold: the scene got node tables")
    print(f"scene {name}: {g.num_tris} tris, {scene.leaves.n_leaf} leaves "
          f"(leaf {bs.SCENES['terrain_10m'][1]}, leaf slots "
          f"{scene.leaves.lp} of at most {pt.WL_MAX_LP}), BVH depth "
          f"{bvh.depth}, {scene.tri_rows.shape[0]} triangle rows; gen_s "
          f"{secs['gen_s']:.2f}, build_s {secs['build_s']:.2f}, pack_s "
          f"{secs['pack_s']:.2f} (bench.py's three; the host build alone, "
          f"with no card phase running), scene tensors {nbytes(*(t for t in vars(scene).values() if isinstance(t, torch.Tensor))) / 2**20:.1f} MiB",
          flush=True)
    t0 = time.perf_counter()
    walk = dataclasses.replace(scene, leaves=None, nodes=pt.pack_node_tables(
        bvh.node_lo, bvh.node_hi, bvh.child, bvh.count, bvh.axis,
        bvh.first_node).to("cuda"))
    torch.cuda.synchronize()
    walk_pack_s = time.perf_counter() - t0
    print(f"scene {name} walk: {walk.nodes.n_nodes} nodes, depth "
          f"{walk.nodes.depth}, node tables packed in {walk_pack_s:.2f} s "
          "(the triangle and shading rows shared with the leaf-table scene)",
          flush=True)
    checks, extra = kernels_10m(name, scene, walk, cam)
    launches = {}
    img, launches["fwd"], fwd = frame_10m(name, "fwd", scene, cam,
                                          FORWARD + GATHER, card)
    wimg, launches["walk_fwd"], wfwd = frame_10m(name, "walk fwd", walk, cam,
                                                 WALK_FWD + GATHER, card)
    against_frame(name, "walk fwd", wimg, img)
    numbers = {**secs, "walk_pack_s": walk_pack_s, "fwd": fwd,
               "walk_fwd": wfwd, **extra}
    print(f"row {name}: {json.dumps(numbers)}", flush=True)
    path = lambda k: "walk_fwd" if k in WALK else "fwd"
    return [{"name": f"{k}/{name}", "route": "cuda",
             "source": WALK_SRC if k in WALK else SRC,
             "replaces": REPLACES[k], "launches": launches[path(k)][k],
             "path": path(k),
             "launches_by_path": {q: c[k] for q, c in launches.items()},
             **e, "library_ms": None} for k, e in checks.items()]


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from snail_tpu_torch.core.types import Light, RenderOpts
        from snail_tpu_torch.ops import _build
        from snail_tpu_torch.scene.bench_scenes import BENCH_N, SCENES
    except ImportError as e:
        fail(f"snail_tpu_torch not found beside this script: {e}")

    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    stamp = lambda what: print(f"time: {what} done after "
                               f"{time.perf_counter() - t0:.1f} s",
                               flush=True)
    path, secs = _build.build()
    _build.library()
    print(f"build: {path.name}, nvcc {secs:.2f} s, ready after "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    kernels = []
    # (scene kind, n of the small CPU-path check)
    for kind, n_small in (("city", BENCH_N["city"]), ("terrain", 64)):
        n = BENCH_N[kind]
        name = f"{kind}_{n}"
        scene, cam, g, bvh = make_scene(kind, n)
        sscene, scam, sg, sbvh = ((scene, cam, g, bvh) if n_small == n
                                  else make_scene(kind, n_small))
        if kind in LOW_LIGHT:
            sscene = dataclasses.replace(sscene, lights=Light.make(
                LOW_LIGHT[kind], (1.0, 1.0, 1.0), SCENES[kind][3]))
        small = (sscene, scam)
        stamp(f"{name} scenes")
        checks = check_kernels(name, kind, scene, cam)
        stamp(f"{name} kernel checks")
        fwd = RenderOpts(reflections=False, transparency=False,
                         textures=False)
        launches = {}
        launches["fwd"] = run_frame(name, "fwd", fwd, FORWARD, scene, cam,
                                    small, card)
        launches["bounce"] = run_frame(name, "bounce",
                                       RenderOpts(textures=False), BOUNCE,
                                       scene, cam, small, card)
        stamp(f"{name} fwd and bounce frames")
        if kind == "terrain":
            checks["surface_rows"], launches["bounce_ss"] = check_gather(
                name, scene, cam, card)
            stamp(f"{name} hit-row gather")
        launches["fwd_bwd"] = run_step(name, scene, cam, small, card)
        stamp(f"{name} fwd_bwd step")
        launches["stats"] = run_stats(name, fwd, scene, cam, small, card)
        stamp(f"{name} counter frame")
        checks["shadow_wl_g"], by_path = run_instanced(name, kind, scene,
                                                       small, card)
        launches.update(by_path)
        stamp(f"{name} instanced frames")

        walk = walk_twin(name, scene, g, bvh)
        wsmall = ((walk, cam) if n_small == n else
                  (walk_twin(f"{kind}_{n_small}", sscene, sg, sbvh), scam))
        checks.update(check_walk_kernels(name, kind, walk, cam))
        # the worklist kernels against the walk kernels that compute the
        # same function on the same wavefront, in this call
        print(f"ratio {name}: " + ", ".join(
            f"{a} / {b} = {checks[a]['ms'] / checks[b]['ms']:.3f}"
            for a, b in (("camera_wl", "walk_camera"),
                         ("closest_wl_g", "walk_closest_g"),
                         ("shadow_wl", "walk_shadow"))) + "; " + ", ".join(
            f"{k} {e['ms']:.4f} ms beside its bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}; every leaf {e['bound_every_leaf_ms']:.4f})"
            for k, e in ((k, checks[k]) for k in (
                "words_camera", "words_shared", "words_general"))),
            flush=True)
        stamp(f"{name} walk kernel checks")
        launches["walk_fwd"] = run_walk_frame(name, "walk fwd", fwd,
                                              WALK_FWD, walk, scene, cam,
                                              wsmall, card)
        launches["walk_bounce"] = run_walk_frame(
            name, "walk bounce", RenderOpts(textures=False), WALK_BOUNCE,
            walk, scene, cam, wsmall, card)
        launches["walk_instanced_fwd"] = run_walk_instanced(name, kind, walk,
                                                            wsmall, card)
        launches["walk_stats"] = run_stats(name, fwd, walk, cam, wsmall, card)
        stamp(f"{name} walk frames")
        for path, opts in (("portable_fwd", fwd),
                           ("portable_bounce", RenderOpts(textures=False))):
            launches[path] = run_portable(name, path.replace("_", " "), opts,
                                          "leaves", scene, cam, small, card)
            if kind == "terrain":
                launches[f"walk_{path}"] = run_portable(
                    name, f"walk {path.replace('_', ' ')}", opts, "nodes",
                    walk, cam, wsmall, card)
        if kind == "city":
            launches["portable_fwd_bwd"] = run_portable_step(
                name, scene, cam, small, card)
        stamp(f"{name} portable frames")
        launches.update(run_textured(name, kind, scene, cam, small, card))
        stamp(f"{name} textured frames")
        launches.update(run_photons(name, kind, scene, walk, cam, small,
                                    wsmall, card))
        stamp(f"{name} photon phase")
        kernels += kernel_lines(name, checks, launches)
        fat_name, checks, launches = run_fat(
            kind, scene if FAT_N[kind] == n else None, card)
        kernels += kernel_lines(fat_name, checks, launches)
        stamp(f"{fat_name} fat-leaf phase")
        del scene, small, sscene, walk, wsmall
        torch.cuda.empty_cache()
    run_loaded(card)
    stamp("loaded scene")
    kernels += run_volume(card)
    stamp("volume phase")
    extra = run_apps(card)
    stamp("apps phase")
    extra.update(run_distributed(card))
    stamp("distributed phase")
    kernels += run_10m(card)
    stamp("10 Mtri phase")
    # the new phases' launches beside the city's other paths
    city = f"/city_{BENCH_N['city']}"
    for e in kernels:
        if e["name"].endswith(city):
            k = e["name"].split("/")[0]
            e["launches_by_path"].update({p: c[k] for p, c in extra.items()})

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
