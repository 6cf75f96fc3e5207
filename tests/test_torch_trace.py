"""The port's spans and counters (``utils.trace``): off, they enter no
``record_function`` and change no bit of a frame or a gradient; on, a
profiler trace holds the stages nested as the frame and the step run
them, the ray counters match a hand count per wavefront, and
``SpanIndex`` puts each device operation, backward ones too, under the
stage that made it.

Scene: city_scene(4) (134 triangles) with bench.py's bounce material
(half mirror, half glass) and a second light; for the shared-origin
tables' stage (the leaf-table counter frame's alone), bench.py's 10 Mtri
terrain at n = 24 on both table kinds; 64 x 64 frames."""

import contextlib
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from snail_tpu_torch.core.types import Light, RenderOpts
from snail_tpu_torch.core.vecmath import BIG
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.render.fast import shadow_wavefront
from snail_tpu_torch.render.renderer import render_frame, to_rgb8
from snail_tpu_torch.scene.bench_scenes import (OPTS_10M, STEP_OPTS,
                                                bench_scene, bench_step,
                                                scene_10m)
from snail_tpu_torch.utils import trace

W = H = 64
BOUNCE = RenderOpts(textures=False)  # reflections and transparency
FWD = RenderOpts(reflections=False, transparency=False, textures=False)


def _two_lights(scene):
    second = Light.make((20.0, 40.0, -10.0), (0.6, 0.7, 0.9), 150.0,
                        device="cpu")
    return dataclasses.replace(scene, lights=Light.stack([scene.lights,
                                                          second]))


@pytest.fixture(scope="module")
def scenes():
    """{tables: (scene, camera)}: leaf tables, node tables (the walk) and
    fat-leaf node tables, each with two lights."""
    out = {}
    for tables, kw in (("leaves", {}), ("nodes", {"walk": True}),
                       ("fat", {"leaf": 48})):
        scene, cam, _, _ = bench_scene("city", 4, device="cpu", bounce=True,
                                       **kw)
        out[tables] = (_two_lights(scene), cam)
    assert pt.is_fat(out["fat"][0]) and pt.walks(out["nodes"][0])
    return out


def _step(scene, cam):
    target = render_frame(scene, cam, W, H, STEP_OPTS) * 0.5
    return bench_step(scene, cam, target, W, H)


RUNS = {
    "bounce": lambda s, c: to_rgb8(render_frame(s, c, W, H, BOUNCE)),
    "bounce_ss": lambda s, c: to_rgb8(render_frame(
        s, c, W, H, dataclasses.replace(BOUNCE, supersample=True))),
    "step": _step,
}


def _flat(out):
    if isinstance(out, tuple):
        loss, grads = out
        return [loss] + [grads[k] for k in sorted(grads)]
    return [torch.from_numpy(out)]


def test_off_enters_no_record_function(scenes, monkeypatch):
    """With tracing off a span is the one shared null context and a
    counter keeps nothing: a bounce frame and a step run with
    ``record_function`` patched to raise."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    scene, cam = scenes["leaves"]
    with trace.tracing():
        pass
    RUNS["bounce"](scene, cam)
    _step(scene, cam)
    assert trace.span("snail.frame") is trace.span("snail.shade")
    assert not trace.active() and trace.counters() == {}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_on_and_off_bit_identical(scenes, run):
    """Frames (RGB8) and a step's loss and gradients are the same bits
    with tracing on and off."""
    scene, cam = scenes["leaves"]
    off = _flat(RUNS[run](scene, cam))
    with trace.tracing():
        on = _flat(RUNS[run](scene, cam))
    assert len(on) == len(off)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            trace.tracing():
        fn()
    counts = trace.counters()
    return prof, counts


def _chrome(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def _spans(ix):
    """[(name, parent name or None)] of every span in the trace."""
    out = []
    for nest in ix.spans.values():
        for row, parent in zip(nest.rows, nest.parent):
            out.append((row[2], None if parent < 0 else nest.rows[parent][2]))
    return out


@pytest.mark.parametrize("run", ["frame", "step"])
def test_spans_nest_as_the_frame_runs(scenes, run, tmp_path):
    """A profiled bounce frame (and its RGB8) or step holds the stages
    nested as they run: the frame's camera and shading, inside the
    shading each bounce's closest hit and gather and one shadow span per
    light and depth, nothing inside a wavefront's span; a step's forward
    holds the same stages and the pack's gathers, its backward none."""
    scene, cam = scenes["leaves"]
    n_lights = len(scene.lights)
    if run == "frame":
        prof, counts = _profiled(lambda: RUNS["bounce"](scene, cam))
        want = {("snail.frame", None): 1, ("snail.rgb8", None): 1,
                ("snail.camera", "snail.frame"): 1,
                ("snail.shade", "snail.frame"): 1,
                # depth 0's rows, then each bounce's (reflection, glass)
                ("snail.gather", "snail.shade"): 3,
                ("snail.closest", "snail.shade"): 2,
                ("snail.shadow", "snail.shade"): 3 * n_lights}
        assert counts["snail.frame"] == 1
    else:
        target = render_frame(scene, cam, W, H, STEP_OPTS)
        prof, counts = _profiled(lambda: bench_step(scene, cam, target, W,
                                                    H))
        want = {("snail.forward", None): 1, ("snail.backward", None): 1,
                ("snail.camera", "snail.forward"): 1,
                # the pack and the primary hits' rows
                ("snail.gather", "snail.forward"): 2,
                ("snail.shade", "snail.forward"): 1,
                ("snail.gather", "snail.shade"): 1,
                ("snail.closest", "snail.shade"): 1,
                ("snail.shadow", "snail.shade"): 2 * n_lights}
        assert counts["snail.forward"] == 1 and "snail.frame" not in counts
    got = {}
    for pair in _spans(trace.SpanIndex(_chrome(prof, tmp_path))):
        got[pair] = got.get(pair, 0) + 1
    assert got == want


def _random_rays(cam, n, seed):
    gen = torch.Generator().manual_seed(seed)
    d = torch.randn((n, 3), generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    o = cam.pos[None, :] + 0.1 * torch.randn((n, 3), generator=gen)
    tmax = torch.where(torch.rand(n, generator=gen) < 0.3, -1.0, BIG)
    return o, d, tmax


ENTRIES = {
    "camera": lambda s, c, o, d, tm: pt.camera_trace(s, c, W, H),
    "shadow": lambda s, c, o, d, tm: pt.any_hit_shared(
        s, s.lights.pos[0], d.unbind(1), tm),
    "closest": lambda s, c, o, d, tm: pt.closest_hit_c(
        s, o.unbind(1), d.unbind(1), tm),
    "any_hit_aos": lambda s, c, o, d, tm: pt.any_hit_aos(s, o, d, tm),
    "closest_aos": lambda s, c, o, d, tm: pt.closest_hit_aos(s, o, d, tm),
}


@pytest.mark.parametrize("tables", ["leaves", "nodes", "fat"])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_ray_counters_per_wavefront(scenes, entry, tables):
    """One wavefront of 5,000 rays, ~30 % masked, through each entry
    point: ``rays.traced`` counts it padded to whole packets as the
    kernels take it, ``rays.live`` its rays with tmax >= 0; a camera
    wavefront counts every pixel, all live."""
    scene, cam = scenes[tables]
    o, d, tm = _random_rays(cam, 5000, seed=len(entry) + len(tables))
    with trace.tracing():
        ENTRIES[entry](scene, cam, o, d, tm)
    if entry == "camera":
        want = {"rays.traced": W * H, "rays.live": W * H}
    else:
        want = {"rays.traced": 2 * pt.PACKET_R,
                "rays.live": int((tm >= 0).sum())}
    # every kernel here, B9a and B9b too, tests the raw rows: no table
    assert trace.counters() == want


def test_ray_counters_of_a_frame(scenes):
    """A frame without bounces counts its camera wavefront and one shadow
    wavefront a light, each live ray as the frame's own shadow rays
    (``shadow_wavefront``) have it, and its one gather of 17 columns."""
    scene, cam = scenes["leaves"]
    dist, u, v, tri, dx, dy, dz = pt.camera_trace(scene, cam, W, H)
    o3 = tuple(cam.pos)
    live = W * H + sum(
        int((shadow_wavefront(scene, o3, (dx, dy, dz), dist, u, v, tri,
                              lp)[1] >= 0).sum())
        for lp in scene.lights.pos)
    with trace.tracing():
        render_frame(scene, cam, W, H, FWD)
    counts = trace.counters()
    assert 0 < live < W * H * (1 + len(scene.lights))
    assert counts == {"snail.frame": 1, "rays.live": live,
                      "rays.traced": W * H * (1 + len(scene.lights)),
                      "gather.rows": W * H, "gather.cols": 17}


@pytest.mark.parametrize("run", ["bounce", "bounce_ss", "step"])
def test_gather_counters(scenes, run):
    """A bounce frame gathers three wavefronts of rows, the camera's and
    each bounce's, each with the frame's 17 columns (normals, colours,
    reflectivity, opacity); the supersampled frame four times the rays; a
    step, whose pack rows come from its own gathers, none through
    ``surface_rows``."""
    scene, cam = scenes["leaves"]
    if run == "step":
        target = render_frame(scene, cam, W, H, STEP_OPTS)
        fn = lambda: bench_step(scene, cam, target, W, H)
    else:
        fn = lambda: RUNS[run](scene, cam)
    with trace.tracing():
        fn()
    counts = trace.counters()
    rays = W * H * (4 if run == "bounce_ss" else 1)
    if run == "step":
        assert counts["snail.forward"] == 1
        assert "gather.rows" not in counts and "gather.cols" not in counts
    else:
        assert counts["gather.rows"] == 3 * rays
        assert counts["gather.cols"] == 3 * 17


@pytest.fixture(scope="module")
def terrains():
    """{tables: (scene, camera)}: bench.py's 10 Mtri terrain at n = 24
    (1,152 triangles) on leaf tables and on node tables (the walk)."""
    return {tables: scene_10m(24, device="cpu", walk=tables == "nodes")[:2]
            for tables in ("leaves", "nodes")}


def _rows_stage(prof, tmp_path):
    """The parents of every ``snail.rows`` span of a profiled run, sorted,
    and the names of the CPU ops ``SpanIndex`` puts under one."""
    chrome = _chrome(prof, tmp_path)
    ix = trace.SpanIndex(chrome)
    rows = sorted(parent for name, parent in _spans(ix)
                  if name == "snail.rows")
    in_rows = [e["name"] for e in chrome["traceEvents"]
               if e.get("cat") == "cpu_op" and ix.at(
                   (e.get("pid"), e.get("tid")), float(e["ts"]))
               == "snail.rows"]
    return rows, in_rows


@pytest.mark.parametrize("tables", ["leaves", "nodes"])
def test_rows_stage_of_a_view_frame(terrains, tables, tmp_path):
    """A view frame builds no shared-origin table on either table kind:
    B2 and B4 (leaf tables) and B9a and B9b (node tables) test the raw
    rows from their shared origin, so the frame opens no ``snail.rows``,
    no op falls under one, and ``rows.tris`` stays 0."""
    scene, cam = terrains[tables]
    assert pt.walks(scene) == (tables == "nodes")
    prof, counts = _profiled(
        lambda: to_rgb8(render_frame(scene, cam, W, H, OPTS_10M)))
    rows, in_rows = _rows_stage(prof, tmp_path)
    assert counts["snail.frame"] == 1
    assert rows == [] and in_rows == []
    assert counts.get("rows.tris", 0) == 0


@pytest.mark.parametrize("tables", ["leaves", "nodes"])
def test_rows_stage_of_the_counter_wavefronts(terrains, tables, tmp_path):
    """The counter frame's wavefronts: on leaf tables B8a and B8b take the
    shared-origin rows, so ``snail.rows`` opens once inside
    ``snail.camera`` and once inside ``snail.shadow``, ``SpanIndex`` puts
    each table's ops (its ``zeros_like``) under it, and ``rows.tris``
    counts 2 x T; on node tables B9e and B9f test the raw rows, as B9a and
    B9b, and build none."""
    scene, cam = terrains[tables]
    _, d, tm = _random_rays(cam, 5000, seed=7)

    def run():
        pt.camera_trace_stats(scene, cam, W, H)
        pt.any_hit_shared_stats(scene, scene.lights.pos[0], d.unbind(1), tm)

    prof, counts = _profiled(run)
    rows, in_rows = _rows_stage(prof, tmp_path)
    if tables == "nodes":
        assert rows == [] and in_rows == []
        assert counts.get("rows.tris", 0) == 0
        return
    assert rows == ["snail.camera", "snail.shadow"]
    assert in_rows.count("aten::zeros_like") == 2
    assert counts["rows.tris"] == 2 * scene.tri_rows.shape[0]


@pytest.mark.parametrize("tables", ["leaves", "nodes"])
def test_rows_stage_changes_no_bit(terrains, tables):
    """The terrain's view frame, as RGB8 and as floats, is the same bits
    with tracing on and off on both table kinds."""
    scene, cam = terrains[tables]
    frame = lambda: render_frame(scene, cam, W, H, OPTS_10M)
    off = frame()
    with trace.tracing():
        on = frame()
    assert torch.equal(on, off)
    assert (to_rgb8(on) == to_rgb8(off)).all()


def test_backward_follows_its_forward_stage(scenes, tmp_path):
    """By the sequence-number rule, every ``IndexSelectBackward0`` of a
    profiled step (the pack's and the shading rows' gathers) falls under
    ``snail.gather``, and every backward function under some span."""
    scene, cam = scenes["leaves"]
    target = render_frame(scene, cam, W, H, STEP_OPTS)
    prof, _ = _profiled(lambda: bench_step(scene, cam, target, W, H))
    chrome = _chrome(prof, tmp_path)
    ix = trace.SpanIndex(chrome)
    found = {}
    for e in chrome["traceEvents"]:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith(
                "autograd::engine::evaluate_function: "):
            found.setdefault(name.split(": ")[1], set()).add(
                ix.at((e["pid"], e["tid"]), float(e["ts"])))
    assert found["IndexSelectBackward0"] == {"snail.gather"}
    assert None not in set().union(*found.values())


def _x(cat, name, ts, dur, tid=10, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


# a recorded step's trace, by hand: the forward on thread 10, the autograd
# engine on thread 20, the device's stream 7
RECORDED = {"traceEvents": [
    _x("user_annotation", "snail.forward", 0, 100),
    _x("user_annotation", "snail.gather", 10, 20),
    _x("user_annotation", "snail.shade", 30, 60),
    _x("user_annotation", "snail.backward", 100, 100),
    _x("user_annotation", "snail.rgb8", 200, 20),
    _x("user_annotation", "loss_and_grads", 0, 200),  # not the program's
    _x("gpu_user_annotation", "snail.gather", 50, 4, pid=0, tid=7),
    # sequence number 7: recorded first by an op that makes no backward
    # function, in the forward's own span, then taken by index_select
    _x("cpu_op", "aten::where", 5, 2, **{"Sequence number": 7,
                                         "Fwd thread id": 0}),
    _x("cpu_op", "aten::index_select", 12, 5, **{"Sequence number": 7,
                                                 "Fwd thread id": 0}),
    _x("cuda_runtime", "cudaLaunchKernel", 13, 1, correlation=1),
    _x("kernel", "indexSelectLargeIndex", 50, 4, pid=0, tid=7,
       correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=2),
    _x("kernel", "vectorized_elementwise_kernel", 60, 6, pid=0, tid=7,
       correlation=2),
    _x("cpu_op", "autograd::engine::evaluate_function: "
       "IndexSelectBackward0", 120, 30, tid=20,
       **{"Sequence number": 7, "Fwd thread id": 1}),
    _x("cuda_runtime", "cudaLaunchKernel", 125, 1, tid=20, correlation=3),
    _x("kernel", "indexFuncLargeIndex", 130, 10, pid=0, tid=7,
       correlation=3),
    _x("cpu_op", "autograd::engine::evaluate_function: "
       "torch::autograd::AccumulateGrad", 160, 10, tid=20),
    _x("cuda_runtime", "cudaLaunchKernel", 162, 1, tid=20, correlation=4),
    _x("kernel", "vectorized_elementwise_kernel", 165, 3, pid=0, tid=7,
       correlation=4),
    _x("cpu_op", "autograd::engine::evaluate_function: MulBackward0", 170,
       10, tid=20, **{"Sequence number": 99, "Fwd thread id": 1}),
    _x("cuda_runtime", "cudaLaunchKernel", 172, 1, tid=20, correlation=5),
    _x("kernel", "elementwise_kernel", 175, 2, pid=0, tid=7,
       correlation=5),
    _x("cuda_runtime", "cudaMemcpyAsync", 205, 10, correlation=6),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 206, 8, pid=0,
       tid=7, correlation=6),
    _x("kernel", "launched_before_the_window", 0, 1, pid=0, tid=7,
       correlation=8),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 1, "tid": 10,
     "ts": 13, "id": 1},
]}


def test_span_index_on_a_recorded_trace():
    """Each device operation of a recorded trace by its span: launches by
    correlation, a backward kernel on the engine's thread under the
    forward stage of its sequence number (the op that took it, not the
    one before), the engine's own kernels and a backward function with
    no forward op in the trace under ``snail.backward``, the frame's copy
    under ``snail.rgb8``, and a kernel launched outside the trace under
    no span."""
    ix = trace.SpanIndex(RECORDED)
    assert ix.device_us() == {"snail.gather": 14.0, "snail.shade": 6.0,
                              "snail.backward": 5.0, "snail.rgb8": 8.0,
                              None: 1.0}
    assert [op[4] for op in ix.device_ops()][:2] == ["snail.gather",
                                                     "snail.shade"]
    assert ix.at((1, 10), 95.0) == "snail.forward"
    assert ix.at((1, 10), 250.0) is None


def test_span_stack_and_counters(monkeypatch):
    """A stage entered inside itself opens one range; root spans are
    counted; counters sum ints and device tensors; ``tracing()`` clears
    them and leaves tracing off."""
    opened = []

    def record(name):
        opened.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", record)
    with trace.tracing():
        for _ in range(2):
            with trace.span("snail.frame"), trace.span("snail.shade"):
                with trace.span("snail.shade"), trace.span("snail.gather"):
                    trace.count("rays.live", torch.tensor(3))
                    trace.count("rays.traced", 4)
                with trace.span("snail.shade"):
                    pass
    assert opened == ["snail.frame", "snail.shade", "snail.gather"] * 2
    assert trace.counters() == {"snail.frame": 2, "rays.live": 6,
                                "rays.traced": 8}
    with trace.tracing():
        assert trace.active()
    assert not trace.active() and trace.counters() == {}
