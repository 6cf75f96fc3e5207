"""One run of one cell: the inputs, the program's set-up, the warm-up,
the measured window, the traced window, and the check.

Everything a cell needs is data found by name: its configuration in
``configs/<config>.json``, whose ``generator`` names the module
``generators/<kind>.py`` that makes its geometry, its traffic in
``traffic/<traffic>.json``, the limits of its check in
``limits/<workload>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``. The program is driven only through its public
entry points: ``scene.base_scene`` and ``bvh.cache`` on the host,
``scene.scene.make_traced_scene``, and the timed calls
``render.renderer.render_frame`` + ``to_rgb8`` (frames) or
``diff.render_loss_and_grads`` of ``render.fast.render_frame_fast_diff``
(steps, as ``scene.bench_scenes.bench_step`` builds them).
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import check
from .reference.render import Inputs

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
PORT = REPO / "snail_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "snail_tpu", "bench")
WARMUP = 3  # frames or steps before the window: every shape built
TRACE_SKIP = 3  # window iterations before the traced stretches
ORBIT_STEP = math.radians(3.0)  # the camera's turn a frame or step


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load(folder: str, name: str, attr: str):
    """``attr`` of the module ``<folder>/<name>.py``, loaded by path."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


def load_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load("metrics", name, "read")


def load_generator(kind: str):
    """The ``generate`` function of ``generators/<kind>.py``: (generator
    entry, device) -> (verts, tri_v, tri_mat)."""
    return _load("generators", kind, "generate")


def cell_spec(bench: dict, workload: str) -> dict:
    """The workload entry, its configuration, traffic and limits, and the
    metrics it reports, all by name."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if m["moves"] in e2e_names
             and applies(m)]
    return {"workload": wl,
            "config": load_json(REPO / cfg_entry["file"]),
            "traffic": load_json(HERE / "traffic" / f"{wl['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json"),
            "end_to_end": e2e, "per_layer": layer}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (or its old benchmark's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------- inputs


def make_inputs(cfg: dict, trf: dict, device) -> Inputs:
    """The scene's arrays as the benchmark hands them to both sides: the
    geometry of the configuration's generator, its materials (each with
    the traffic's ``material`` changes) and its light."""
    verts, tri_v, tri_mat = load_generator(cfg["generator"]["kind"])(
        cfg["generator"], device)
    mats = [{**m, **trf.get("material", {})} for m in cfg["materials"]]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    col = lambda k: f32([m[k] for m in mats])
    light = cfg["light"]
    return Inputs(
        verts=verts, tri_v=tri_v, tri_mat=tri_mat,
        diffuse=col("diffuse"), specular=col("specular"),
        reflectivity=col("reflectivity"), dissolve=col("dissolve"),
        light_pos=f32([light["pos"]]), light_color=f32([light["color"]]),
        light_radius=f32([light["radius"]]))


def orbit(inp: Inputs, cfg: dict, seed: int):
    """Camera positions of a closed loop that turns about the scene's
    centre by ``ORBIT_STEP`` a frame, from an angle drawn
    from the seed (the rtracer client's orbit, frozen): a function of the
    frame's index giving (pos, target), float32 (3,) on the CPU."""
    v = inp.verts
    lo, hi = v.amin(0).double().cpu(), v.amax(0).double().cpu()
    c = (lo + hi) * 0.5
    off = torch.tensor(cfg["camera_offset"], dtype=torch.float64) \
        * float((hi - lo).max())
    a0 = np.random.default_rng([seed, 1]).uniform(0.0, 2.0 * math.pi)

    def at(i: int):
        ang = a0 + i * ORBIT_STEP
        cs, sn = math.cos(ang), math.sin(ang)
        pos = c + torch.tensor([off[0] * cs + off[2] * sn, off[1],
                                -off[0] * sn + off[2] * cs],
                               dtype=torch.float64)
        return pos.float(), c.float()
    return at


def target_image(trf: dict, seed: int, device) -> torch.Tensor:
    """The step's target, a photograph's stand-in: smooth colour noise
    (H, W, 3) in [0, 1] at the traffic's output size, bilinear from a
    17 x 17 grid drawn from the seed on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 62))
    coarse = torch.rand((1, 3, 17, 17), generator=gen, device=device)
    img = torch.nn.functional.interpolate(
        coarse, size=(trf["height"], trf["width"]), mode="bilinear",
        align_corners=True)
    return img[0].permute(1, 2, 0).contiguous()


# ---------------------------------------------------------------- program


def _source_hash(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class Program:
    """The program's scene and the one call the window times."""

    scene: object
    call: object  # (pos, target) -> frame as RGB8, or (loss, grads)
    host: dict  # set-up spans (seconds)
    feed: dict  # the step's target image, under "target"


def setup_program(cfg: dict, trf: dict, inp: Inputs, device, cache: Path,
                  seed: int) -> Program:
    """The program's set-up from the inputs: its host scene, its BVH
    (built, or loaded from the scene cache, which is keyed by the
    configuration and the program's BVH and packing sources), its device
    scene, and the timed call (a step's target drawn from ``seed``)."""
    from snail_tpu_torch.bvh.cache import build_or_load
    from snail_tpu_torch.core.types import Camera, Light, RenderOpts
    from snail_tpu_torch.diff import render_loss_and_grads
    from snail_tpu_torch.render.fast import render_frame_fast_diff
    from snail_tpu_torch.render.renderer import render_frame, to_rgb8
    from snail_tpu_torch.scene.base_scene import BaseScene, SceneObject
    from snail_tpu_torch.scene.bench_scenes import grad_params, with_params
    from snail_tpu_torch.scene.materials import MaterialTable
    from snail_tpu_torch.scene.scene import make_traced_scene

    host = {}
    t0 = time.perf_counter()
    t = inp.tri_v.shape[0]
    none = lambda w: np.full((t, w), -1, np.int32)
    obj = SceneObject(verts=inp.verts.cpu().numpy(),
                      uvs=np.zeros((0, 2), np.float32),
                      normals=np.zeros((0, 3), np.float32),
                      tri_v=inp.tri_v.cpu().numpy().astype(np.int32),
                      tri_vt=none(3), tri_vn=none(3),
                      tri_mat=inp.tri_mat.cpu().numpy().astype(np.int32))
    base = BaseScene()
    base.objects.append(obj)
    base.gen_normals()
    geom = base.flatten()
    lo, hi = geom.bounds()
    key = _source_hash([PORT / "bvh" / "build.py", PORT / "bvh" / "cache.py",
                        PORT / "scene" / "scene.py",
                        PORT / "scene" / "base_scene.py"])
    bvh = build_or_load(lo, hi, str(cache), f"{cfg['name']}-{key}",
                        leaf_size=cfg["leaf"])
    host["scene_host_s"] = time.perf_counter() - t0

    mats = MaterialTable.build({f"m{i}": i
                                for i in range(inp.diffuse.shape[0])})
    mats.diffuse[:] = inp.diffuse.cpu().numpy()
    mats.specular[:] = inp.specular.cpu().numpy()
    mats.reflectivity[:] = inp.reflectivity.cpu().numpy()
    mats.dissolve[:] = inp.dissolve.cpu().numpy()
    t0 = time.perf_counter()
    scene = make_traced_scene(
        geom, bvh, mats, lights=Light(pos=inp.light_pos,
                                      color=inp.light_color,
                                      radius=inp.light_radius),
        device=device, walk=cfg.get("tables", "leaves") == "nodes")
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
    host["scene_pack_s"] = time.perf_counter() - t0
    del geom, base, obj

    w, h = trf["width"], trf["height"]
    feed = {}
    cam = lambda pos, tgt: Camera.look_at(tuple(pos.tolist()),
                                          tuple(tgt.tolist()), device=device)
    opts = RenderOpts(**frame_options(cfg, trf))
    if trf["kind"] == "frame":
        def call(pos, tgt):
            with torch.profiler.record_function("camera"):
                c = cam(pos, tgt)
            with torch.profiler.record_function("render_frame"):
                img = render_frame(scene, c, w, h, opts)
            with torch.profiler.record_function("to_rgb8"):
                return to_rgb8(img)
    else:
        # bench_step's step, its frame supersampled as render_frame does
        # with ``opts.supersample``: 2W x 2H rays, each 2 x 2 averaged
        feed["target"] = target_image(trf, seed, device)
        s = 2 if opts.supersample else 1

        def image(scene_, cam_):
            img = render_frame_fast_diff(scene_, cam_, w * s, h * s, opts)
            if s == 2:
                img = (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2]
                       + img[1::2, 1::2]) * 0.25
            return img

        def call(pos, tgt):
            with torch.profiler.record_function("camera"):
                c = cam(pos, tgt)
            with torch.profiler.record_function("loss_and_grads"):
                loss, grads = render_loss_and_grads(
                    lambda p: image(*with_params(scene, c, p)),
                    grad_params(scene, c),
                    lambda img: ((img - feed["target"]) ** 2).mean())
            with torch.profiler.record_function("loss_readback"):
                return float(loss), grads
    return Program(scene, call, host, feed)


def frame_options(cfg: dict, trf: dict) -> dict:
    """The render options of a frame or step: the configuration's, then
    the traffic's."""
    return {**cfg.get("options", {}), **trf.get("options", {})}


# ---------------------------------------------------------------- run


@dataclasses.dataclass
class Window:
    """What the window recorded: each iteration's seconds, the time from
    its start to the end of the last iteration, and the kept sample of
    outputs [(index, output)]."""

    times: list
    seconds: float
    kept: list


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(prog: Program, kind: str, at, seconds: float, keep: int,
               seed: int, device, trace_iters: int = 0, trace_skip: int = 0):
    """The closed loop: one frame or step at a time for ``seconds``. A
    reservoir drawn from the seed keeps ``keep`` outputs for the check.

    With ``trace_iters``, two stretches run under the profiler, from
    iteration ``trace_skip`` on: first ``trace_iters`` iterations that
    record the device's operations alone (the per-layer metrics and the
    idle share), then a third as many that record the host's operations
    and the benchmark's spans too (to name the idle gaps). Returns
    (Window, {"device"/"host": (Chrome trace, seconds, iterations)})."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    dev_acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    host_n = max(1, trace_iters // 3)
    stretches = ([(trace_skip, trace_iters, "device", dev_acts),
                  (trace_skip + trace_iters, host_n, "host",
                   [ProfilerActivity.CPU] + dev_acts[:cuda])]
                 if trace_iters else [])
    traces = {}
    rng = np.random.default_rng([seed, 2])
    times, kept = [], []
    prof = None
    t_start = time.perf_counter()
    i = 0
    while True:
        for first, n, name, acts in stretches:
            if i == first:
                _sync(device)
                prof = profile(activities=acts)
                prof.start()
                p0 = time.perf_counter()
            if i == first + n:
                _sync(device)
                took = time.perf_counter() - p0
                prof.stop()
                # exported now: the next profiler clears this one's events
                traces[name] = (_export(prof), took, n)
        pos, tgt = at(i)
        t0 = time.perf_counter()
        with torch.profiler.record_function(kind):
            out = prog.call(pos, tgt)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if len(kept) < keep:
            kept.append((i, out))
        else:
            j = int(rng.integers(0, i + 1))
            if j < keep:
                kept[j] = (i, out)
        i += 1
        if t1 - t_start >= seconds and len(traces) == len(stretches):
            break
    return Window(times, t1 - t_start,
                  sorted(kept, key=lambda k: k[0])), traces


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, cache: Path) -> dict:
    """One run of a cell (``cell_spec``): returns the result line's
    object."""
    cfg, trf, lim = spec["config"], spec["traffic"], spec["limits"]
    kind = trf["kind"]
    cuda = torch.device(device).type == "cuda"
    spans = {"start_s": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    inp = make_inputs(cfg, trf, device)
    _sync(device)
    spans["inputs_s"] = time.perf_counter() - t0
    at = orbit(inp, cfg, seed)
    prog = setup_program(cfg, trf, inp, device, cache, seed)
    for k in range(WARMUP):
        t0 = time.perf_counter()
        prog.call(*at(-1 - k))
        _sync(device)
        spans[f"warmup{k}_s"] = time.perf_counter() - t0
    # what set-up made stays out of the window's garbage collections
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    spans = {**spans, **prog.host}
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in spans.items())
          + f" setup_s {setup_s:.3f}", file=sys.stderr)

    win, traces = run_window(prog, kind, at, seconds, trf["check"]["iters"],
                           seed, device, trf["trace_iters"] if trace else 0,
                           TRACE_SKIP)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    q = np.percentile(np.array(win.times) * 1e3, [0, 25, 50, 75, 95, 100])
    print(f"window {kind}s {len(win.times)} ms min/q1/median/q3/p95/max "
          + " ".join(f"{x:.4f}" for x in q), file=sys.stderr)

    metrics = {}
    breakdown = None
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name() if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        from . import tracing

        tr = _read_trace(*traces["device"], kind)
        run = dataclasses.make_dataclass("Run", ["kind", "trace", "host"])(
            kind, tr, prog.host)
        for m in spec["per_layer"]:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_us() * 1e-6
        dev_info["window_s"] = tr.window_us * 1e-6
        breakdown = tracing.breakdown(
            tr, _read_trace(traces["host"][0], None, None, kind))
    else:
        times = np.array(win.times)
        e2e = {"frame_ms": win.seconds / len(times) * 1e3,
               "frame_p95_ms": float(np.percentile(times, 95)) * 1e3,
               "step_ms": win.seconds / len(times) * 1e3,
               "peak_mib": peak / 2.0 ** 20, "setup_s": setup_s}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the program's state goes before the reference runs
    kept = [(i, at(i), out) for i, out in win.kept]
    n_iters = len(win.times)
    del prog, win
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.compare(kind, cfg, trf, inp, kept, lim, seed, device)
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    res = {"correct": bool(correct), "attempted": n_iters, "failed": 0,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["checked"] = numbers
    return res


def _export(prof) -> dict:
    """The profiler's Chrome trace, as parsed JSON."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return load_json(Path(path))
    finally:
        os.unlink(path)


def _read_trace(chrome: dict, seconds, iters, kind: str):
    """The :class:`tracing.Trace` of one traced stretch: of ``iters``
    iterations in ``seconds``, or with None the iterations its spans
    mark."""
    from . import tracing

    return tracing.parse(chrome, kind,
                         tracing.port_kernel_names(PORT / "csrc"),
                         None if seconds is None else seconds * 1e6, iters)
