#!/usr/bin/env python3
"""Smoke run of snail_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own line:
1. the card (name and power limit from nvidia-smi);
2. the kernel build from snail_tpu_torch/csrc, with its seconds;
3. every kernel of the frame (B1-B6) against its plain PyTorch version on
   the card, at full frame size, on two scenes: city_scene(24) at leaf 16
   and terrain_scene(724) (~1 Mtri) at leaf 32, 1024 x 1024, both with
   material 0 reflective and half transparent (bench_scenes
   bounce_materials); B3 and B4 run on the frame's own shadow rays, and
   on the terrain also toward a low light, since its overhead bench light
   blocks no ray; B5 and B6 on the frame's own reflection rays, and on a
   seeded wavefront that hits where too few of those do;
4. three paths at 1024 x 1024 on both scenes, each with the launch count
   of every kernel during one run, a check against the CPU path at 64 x 64
   (the terrain's lit by the low light), and its time: render_frame
   without bounces (ms/frame, MRays/s, peak memory); render_frame with
   reflections and transparency (the same); and bench.py's fwd+bwd step
   (render_frame_fast_diff, 7 gradient parameters, reflections and
   shadows, MSE against a forward render; ms/step).

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
TIMED_STEPS = 5
KERNEL_REPS = 20
SRC = "snail_tpu_torch/csrc/worklist.cu"
TPU = "snail_tpu/ops/traverse_pallas.py"
REPLACES = {  # kernel -> line of the Pallas kernel it replaces
    "words_camera": f"{TPU}:2785",
    "camera_wl": f"{TPU}:3150",
    "words_shared": f"{TPU}:2822",
    "shadow_wl": f"{TPU}:3208",
    "words_general": f"{TPU}:2834",
    "closest_wl_g": f"{TPU}:3226",
}
FORWARD = ("words_camera", "camera_wl", "words_shared", "shadow_wl")
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
    scene, cam, g, _ = bench_scene(kind, n, device="cuda", bounce=True)
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
    out.update(check_bounce(name, scene, primary))
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


def check_bounce(name, scene, primary):
    """B5 and B6 against their plain versions on the reflection wavefront
    the frame casts from the ``primary`` hits. Where too few of its live
    rays hit anything (a terrain's reflections mostly leave for the sky),
    they are also checked on a seeded wavefront that must hit on 0.02-0.98
    of its rays. Returns {kernel: (max_abs_err, ms, plain_ms)} of the
    frame's wavefront."""
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.fast import bounce_wavefront

    o, d, tm, _ = pt.general_planes(*bounce_wavefront(scene, *primary))
    out, share = check_general(f"{name} reflections", scene, o, d, tm)
    if not 0.02 < share < 0.98:
        o, d, tm = seeded_general(scene, tm.shape[0])
        seeded, share = check_general(f"{name} seeded", scene, o, d, tm)
        if not 0.02 < share < 0.98:
            fail(f"{name} seeded wavefront: hit share {share}")
        for k, (e, t, tp) in seeded.items():
            print(f"check {name} seeded {k}: ok, max_abs_err {e}, kernel "
                  f"{t:.4f} ms, plain {tp:.1f} ms", flush=True)
    return out


def seeded_general(scene, n_packets, seed=5):
    """A wavefront of rays with their own origins, ``n_packets`` packets:
    each packet's rays start within 1 % of the scene box's extent of a
    seeded point in the box and run within a narrow cone around a seeded
    direction (down into the geometry or up out of it); every 7th ray
    masked. Returns the (o, d, tm) planes of ``general_planes``."""
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
    o, d, tm, _ = pt.general_planes(tuple(flat(o[..., k]) for k in range(3)),
                                    tuple(flat(d[..., k]) for k in range(3)),
                                    flat(tm))
    return o, d, tm


def check_general(name, scene, o, d, tm):
    """B5 (words identical, floors to rtol 1e-6) and B6 (the checks of
    B2, the miss and masked conventions exactly, tri clamped at 0)
    against their plain versions on the planes ``o``, ``d``, ``tm``.
    Returns ({kernel: (max_abs_err, ms, plain_ms)}, hit share of the live
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
    ms = cuda_ms(lambda: pt.words_general(o, d, tm, lt), KERNEL_REPS)
    out["words_general"] = (err, ms, plain_ms)
    words, summ, floors = kern
    kept = pt.unpack_bits(words).any(1).sum(1).float()

    kern = pt.closest_wl_g(o, d, tm, rows, lt, words, summ, floors)
    plain, plain_ms = timed_plain(
        lambda: pt.closest_wl_g_plain(o, d, tm, rows, lt, words))
    kd, ku, kv, kt = kern
    pd, pu, pv, ptri = plain
    live = tm >= 0
    hit = live & (pd < BIG)
    same = hit & (kt == ptri)
    n_live, n_hit = int(live.sum()), int(hit.sum())
    share = n_hit / max(n_live, 1)
    derr = float((kd - pd)[hit].abs().max()) if n_hit else 0.0
    checks = {
        "masked": bool((kd[~live] == -BIG).all()
                       and (pd[~live] == -BIG).all()),
        "misses": bool((kd[live & ~hit] == BIG).all()),
        "tri clamp": bool((kt[~hit] == 0).all() and (ptri[~hit] == 0).all()),
        "dist": bool(torch.allclose(kd, pd, rtol=2e-4, atol=2e-4)),
        "tri": n_hit == 0 or float((kt[hit] == ptri[hit]).float().mean())
        > 0.999,
        "u": not bool(same.any()) or float((ku - pu)[same].abs().max())
        <= 2e-3,
        "v": not bool(same.any()) or float((kv - pv)[same].abs().max())
        <= 2e-3,
    }
    print(f"check {name} closest_wl_g: hit share {share} of {n_live} live "
          f"rays; B5 leaves kept per packet: mean {float(kept.mean()):.1f}, "
          f"max {int(kept.max())} of {lt.n_leaf}", flush=True)
    if not all(checks.values()):
        fail(f"{name} closest_wl_g: {checks}, max dist err {derr}")
    ms = cuda_ms(lambda: pt.closest_wl_g(o, d, tm, rows, lt, words, summ,
                                         floors), KERNEL_REPS)
    out["closest_wl_g"] = (derr, ms, plain_ms)
    return out, share


def launched(name, path, need):
    """The launch counts since the last reset; every kernel in ``need``
    must have launched."""
    from snail_tpu_torch.ops import traverse as pt

    launches = pt.launch_counts()
    if not all(launches[k] > 0 for k in need):
        fail(f"{name} {path}: a kernel of the path was not launched: "
             f"{launches}")
    return launches


def run_frame(name, path, opts, need, scene, cam, small, card):
    """Phase 4, one path through render_frame: the launch counts of one
    frame (each kernel in ``need`` > 0), a 64 x 64 card frame of ``small``
    ((scene, camera)) against the CPU path, ms/frame and MRays/s. Returns
    the launch counts."""
    import torch

    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.renderer import render_frame

    torch.cuda.synchronize()
    pt.reset_launch_counts()
    with pt.count_live_rays() as live:
        img = render_frame(scene, cam, WIDTH, HEIGHT, opts)
    torch.cuda.synchronize()
    launches = launched(name, path, need)
    traced = sum(int(n) for n in live)
    if tuple(img.shape) != (HEIGHT, WIDTH, 3):
        fail(f"{name} {path}: image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or not float(img.abs().max()) > 0:
        fail(f"{name} {path}: image not finite or all zero")
    print(f"frame {name} {path}: launches {launches}, mean "
          f"{float(img.mean()):.6f}", flush=True)

    # a 64 x 64 frame on the card and on the CPU path (plain versions)
    sscene, scam = small
    img64 = render_frame(sscene, scam, 64, 64, opts).cpu()
    ref = render_frame(sscene.to("cpu"), scam.to("cpu"), 64, 64, opts)
    off = float(((img64 - ref).abs().amax(-1) > 2e-3).float().mean())
    if off > 2e-3:
        fail(f"{name} {path}: 64x64 card frame differs from the CPU path "
             f"on {off} of pixels")
    if not float(ref.abs().max()) > 0:
        fail(f"{name} {path}: the 64x64 reference frame is all zero")
    print(f"frame {name} {path}: 64x64 card vs CPU path, share of pixels "
          f"off by > 2e-3: {off}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: render_frame(scene, cam, WIDTH, HEIGHT, opts),
                 TIMED_FRAMES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    rays = WIDTH * HEIGHT * (1 + len(scene.lights))
    print(f"frame {name} {path} {WIDTH}x{HEIGHT}: {ms:.3f} ms/frame, "
          f"{rays / ms / 1e3:.2f} MRays/s ({rays} rays as bench.py counts; "
          f"{traced} live rays traced in {len(live)} wavefronts), peak "
          f"memory {peak:.1f} MiB, on {card}", flush=True)
    return launches


def run_step(name, scene, cam, small, card):
    """Phase 4, bench.py's fwd+bwd step (bench.py:236-247): the loss and
    gradients of its 7 parameters through render_frame_fast_diff with
    reflections and shadows, MSE against a forward render. Launch counts
    of one step (all six kernels), a 64 x 64 step on the card against the
    CPU path (its target lit at half the light colour, so that the
    gradients are not ~0), ms/step. Returns the launch counts."""
    import numpy as np
    import torch

    from snail_tpu_torch.core.types import Light
    from snail_tpu_torch.ops import traverse as pt
    from snail_tpu_torch.render.renderer import render_frame
    from snail_tpu_torch.scene.bench_scenes import STEP_OPTS, bench_step

    target = render_frame(scene, cam, WIDTH, HEIGHT, STEP_OPTS)
    torch.cuda.synchronize()
    pt.reset_launch_counts()
    with pt.count_live_rays() as live:
        loss, grads = bench_step(scene, cam, target, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    launches = launched(name, "fwd_bwd", tuple(REPLACES))
    traced = sum(int(n) for n in live)
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    loss = float(loss)
    if not np.isfinite(loss) or bad:
        fail(f"{name} fwd_bwd: loss {loss}, non-finite grads {bad}")
    print(f"step {name} fwd_bwd: launches {launches}, loss {loss}, "
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
    print(f"step {name} fwd_bwd: 64x64 card vs CPU path, loss {lk} vs {lc}; "
          "grad |diff| q99.9 / mean over max |g|: " + ", ".join(
              f"{k} {q:.2e}/{m:.2e}" for k, (q, m) in worst.items()),
          flush=True)
    if not ok:
        fail(f"{name} fwd_bwd: 64x64 card step differs from the CPU path")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: bench_step(scene, cam, target, WIDTH, HEIGHT),
                 TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    rays = WIDTH * HEIGHT * (1 + len(scene.lights))
    print(f"step {name} fwd_bwd {WIDTH}x{HEIGHT}: {ms:.3f} ms/step, "
          f"{rays / ms / 1e3:.2f} MRays/s ({rays} rays as bench.py counts; "
          f"{traced} live rays traced in {len(live)} wavefronts), peak "
          f"memory {peak:.1f} MiB, on {card}", flush=True)
    return launches


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
        fwd = RenderOpts(reflections=False, transparency=False,
                         textures=False)
        launches = {
            "fwd": run_frame(name, "fwd", fwd, FORWARD, scene, cam, small,
                             card),
            "bounce": run_frame(name, "bounce", RenderOpts(textures=False),
                                tuple(REPLACES), scene, cam, small, card),
            "fwd_bwd": run_step(name, scene, cam, small, card),
        }
        # launches: those of the bounce frame, which runs all six
        for k, (err, ms, plain_ms) in checks.items():
            kernels.append({
                "name": f"{k}/{name}", "route": "cuda", "source": SRC,
                "replaces": REPLACES[k], "launches": launches["bounce"][k],
                "launches_by_path": {p: n[k] for p, n in launches.items()},
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
