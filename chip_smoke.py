#!/usr/bin/env python3
"""Smoke run of snail_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line:
1. the card (name and power limit from nvidia-smi);
2. the kernel build from snail_tpu_torch/csrc, with its seconds;
3. every kernel of the forward frame (B1-B4) against its plain PyTorch
   version on the card, at full frame size, on two scenes: city_scene(24)
   at leaf 16 and terrain_scene(724) (~1 Mtri) at leaf 32, 1024 x 1024;
   B3 and B4 run on the frame's own shadow rays, and on the terrain also
   toward a low light, since its overhead bench light blocks no ray;
4. render_frame at 1024 x 1024 on both scenes: the launch count of each
   kernel during one frame, the image checked against the CPU path on a
   small frame (the terrain's lit by the low light), then ms/frame over
   timed frames, MRays/s and peak memory.

The last two lines are a JSON object per kernel and the result line. Any
failed phase ends the run with a non-zero exit and no result line; so does
a machine without a CUDA device or a directory without the package.
"""

import dataclasses
import json
import subprocess
import sys
import time


WIDTH = HEIGHT = 1024
TIMED_FRAMES = 10
KERNEL_REPS = 20
SRC = "snail_tpu_torch/csrc/worklist.cu"
TPU = "snail_tpu/ops/traverse_pallas.py"
REPLACES = {  # kernel -> line of the Pallas kernel it replaces
    "words_camera": f"{TPU}:2785",
    "camera_wl": f"{TPU}:3150",
    "words_shared": f"{TPU}:2822",
    "shadow_wl": f"{TPU}:3208",
}
# kind -> a low light for the blocked-ray checks of B3/B4 and of the small
# frame: the terrain's bench light is overhead and its hills cast no
# shadow toward it (~20 % of the frame's shadow rays toward this light are
# blocked on terrain_scene(128))
LOW_LIGHT = {"terrain": (-80.0, 20.0, 0.0)}


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


def make_scene(kind: str, n: int):
    """A benchmark scene of bench.py on the card (scene/bench_scenes.py)."""
    from snail_tpu_torch.scene.bench_scenes import SCENES, bench_scene

    t0 = time.perf_counter()
    scene, cam, g, _ = bench_scene(kind, n, device="cuda")
    print(f"scene {kind}_{n}: {g.num_tris} tris, {scene.leaves.n_leaf} "
          f"leaves (leaf {SCENES[kind][1]}), host build "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return scene, cam


def timed_plain(fn):
    """Result of a first call of fn, and the host ms of a second (warm)."""
    import torch

    res = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def words_err(kern, plain, name):
    """Words must be identical; floors are compared as floats."""
    import torch

    kw, ks, kf = kern
    pw, ps, pf = plain
    bad = int((kw != pw).sum()) + int((ks != ps).sum())
    if bad:
        fail(f"{name}: {bad} words differ from the plain version")
    both = (kf < 1e37) & (pf < 1e37)
    if not bool(((kf < 1e37) == (pf < 1e37)).all()):
        fail(f"{name}: empty bands differ from the plain version")
    err = float((kf - pf)[both].abs().max()) if bool(both.any()) else 0.0
    if not torch.allclose(kf[both], pf[both], rtol=1e-6, atol=0.0):
        fail(f"{name}: band floors differ by {err}")
    return err


def check_kernels(name, kind, scene, cam):
    """Phase 3: each kernel against its plain version on the card; returns
    {kernel: (max_abs_err, ms, plain_ms)}."""
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
    ms = cuda_ms(lambda: pt.words_camera(cv, w, h, lt), KERNEL_REPS)
    out["words_camera"] = (err, ms, plain_ms)
    words, summ, floors = kern

    # B2
    rows = pt.shared_rows(scene.tri_rows, cam.pos)
    kern = pt.camera_wl(cv, w, h, rows, lt, words, summ, floors)
    plain, plain_ms = timed_plain(
        lambda: pt.camera_wl_plain(cv, w, h, rows, lt, words, pids))
    kd, ku, kv, kt, kdx, kdy, kdz = kern
    pd, pu, pv, ptri, pdx, pdy, pdz = plain
    hit = pd < BIG
    if not bool((kt[~hit] == -1).all() and (kd[~hit] == BIG).all()):
        fail(f"{name} camera_wl: misses differ from the plain version")
    derr = float((kd - pd)[hit].abs().max())
    same = hit & (kt == ptri)
    checks = {
        "dist": bool(torch.allclose(kd, pd, rtol=2e-4, atol=2e-4)),
        "tri": float((kt[hit] == ptri[hit]).float().mean()) > 0.999,
        # barycentrics where both found the same triangle: at a tie the
        # other triangle's (u, v) are right for it
        "u": float((ku - pu)[same].abs().max()) <= 2e-3,
        "v": float((kv - pv)[same].abs().max()) <= 2e-3,
        "dirs": max(float((a - b).abs().max()) for a, b in
                    ((kdx, pdx), (kdy, pdy), (kdz, pdz))) <= 1e-6,
        "hits": float(hit.float().mean()) > 0.3,
    }
    if not all(checks.values()):
        fail(f"{name} camera_wl: {checks}, max dist err {derr}")
    ms = cuda_ms(lambda: pt.camera_wl(cv, w, h, rows, lt, words, summ,
                                      floors), KERNEL_REPS)
    out["camera_wl"] = (derr, ms, plain_ms)

    # B3 and B4 on the shadow rays the frame casts from these hits toward
    # its light 0, and toward the scene's low light where it has one
    primary = ((cam.pos[0], cam.pos[1], cam.pos[2]),
               (kdx.reshape(-1), kdy.reshape(-1), kdz.reshape(-1)),
               kd.reshape(-1), ku.reshape(-1), kv.reshape(-1),
               kt.reshape(-1))
    out.update(check_shadow(f"{name} light 0", scene, primary,
                            scene.lights.pos[0], kind not in LOW_LIGHT))
    if kind in LOW_LIGHT:
        check_shadow(f"{name} low light", scene, primary,
                     torch.tensor(LOW_LIGHT[kind], device="cuda"), True)
    for k, (e, t, tp) in out.items():
        print(f"check {name} {k}: ok, max_abs_err {e}, kernel {t:.4f} ms, "
              f"plain {tp:.1f} ms", flush=True)
    return out


def check_shadow(name, scene, primary, lp, need_blocked):
    """B3 and B4 against their plain versions on the frame's shadow rays
    from the ``primary`` hits toward the light at ``lp``. Every wavefront
    must leave some rays unblocked; with ``need_blocked`` it must also
    block some. Returns {kernel: (max_abs_err, ms, plain_ms)}."""
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
    ms = cuda_ms(lambda: pt.words_shared(orig, d, tm, lt, 1), KERNEL_REPS)
    out["words_shared"] = (err, ms, plain_ms)
    words, summ, floors = kern

    srows = pt.shared_rows(scene.tri_rows, orig)
    kern = pt.shadow_wl(orig, d, tm, srows, lt, words, summ, floors)
    plain, plain_ms = timed_plain(
        lambda: pt.shadow_wl_plain(orig, d, tm, srows, lt, words))
    live = tm >= 0
    agree = float((kern[live] == plain[live]).float().mean())
    frac = float(plain[live].mean())
    print(f"check {name} shadow_wl: agreement {agree}, blocked share "
          f"{frac} of {int(live.sum())} live rays", flush=True)
    if (agree <= 0.999 or bool(kern[~live].any()) or frac >= 0.98
            or (need_blocked and frac <= 0.02)):
        fail(f"{name} shadow_wl: agreement {agree}, blocked share {frac}")
    ms = cuda_ms(lambda: pt.shadow_wl(orig, d, tm, srows, lt, words, summ,
                                      floors), KERNEL_REPS)
    out["shadow_wl"] = (float((kern - plain).abs().max()), ms, plain_ms)
    return out


def run_frames(name, scene, cam, small, card):
    """Phase 4: the main path through render_frame; returns launches.
    ``small``: (scene, camera) of the check against the CPU path."""
    import torch

    from snail_tpu_torch.core.types import RenderOpts
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.renderer import render_frame

    opts = RenderOpts(reflections=False, transparency=False, textures=False)
    torch.cuda.synchronize()
    pt.reset_launch_counts()
    img = render_frame(scene, cam, WIDTH, HEIGHT, opts)
    torch.cuda.synchronize()
    launches = pt.launch_counts()
    if not all(n > 0 for n in launches.values()):
        fail(f"{name}: a kernel of the path was not launched: {launches}")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3):
        fail(f"{name}: image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or not float(img.abs().max()) > 0:
        fail(f"{name}: image not finite or all zero")
    print(f"frame {name}: launches {launches}, mean {float(img.mean()):.6f}",
          flush=True)

    # a 64 x 64 frame on the card and on the CPU path (plain versions)
    sscene, scam = small
    img64 = render_frame(sscene, scam, 64, 64, opts).cpu()
    ref = render_frame(sscene.to("cpu"), scam.to("cpu"), 64, 64, opts)
    off = float(((img64 - ref).abs().amax(-1) > 2e-3).float().mean())
    if off > 2e-3:
        fail(f"{name}: 64x64 card frame differs from the CPU path on "
             f"{off} of pixels")
    if not float(ref.abs().max()) > 0:
        fail(f"{name}: the 64x64 reference frame is all zero")
    print(f"frame {name}: 64x64 card vs CPU path, share of pixels off by "
          f"> 2e-3: {off}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: render_frame(scene, cam, WIDTH, HEIGHT, opts),
                 TIMED_FRAMES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    rays = WIDTH * HEIGHT * (1 + len(scene.lights))
    print(f"frame {name} {WIDTH}x{HEIGHT}: {ms:.3f} ms/frame, "
          f"{rays / ms / 1e3:.2f} MRays/s ({rays} rays), peak memory "
          f"{peak:.1f} MiB, on {card}", flush=True)
    return launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from snail_tpu_torch.core.types import Light
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
    path, secs = _build.build()
    _build.library()
    print(f"build: {path.name}, nvcc {secs:.2f} s, ready after "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    kernels = []
    # (scene kind, n of the small CPU-path check)
    for kind, n_small in (("city", BENCH_N["city"]), ("terrain", 64)):
        n = BENCH_N[kind]
        name = f"{kind}_{n}"
        scene, cam = make_scene(kind, n)
        small = (scene, cam) if n_small == n else make_scene(kind, n_small)
        if kind in LOW_LIGHT:
            small = (dataclasses.replace(small[0], lights=Light.make(
                LOW_LIGHT[kind], (1.0, 1.0, 1.0), SCENES[kind][3],
                device="cuda")), small[1])
        checks = check_kernels(name, kind, scene, cam)
        launches = run_frames(name, scene, cam, small, card)
        for k, (err, ms, plain_ms) in checks.items():
            kernels.append({
                "name": f"{k}/{name}", "route": "cuda", "source": SRC,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        del scene, small
        torch.cuda.empty_cache()

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
