"""The benchmark's reader of the walk kernels' device time a frame,
``perfbench/metrics/walk_ms.frame.py``, on a small recorded trace of two
frames: it sums B9a-B9d (``csrc/walk.cu``) and nothing else the port
launches."""

import dataclasses

import pytest

from perfbench import harness, tracing

B9A = "void (anonymous namespace)::walk_camera_kernel<false>(float const*, int)"
B9B = "void (anonymous namespace)::walk_shadow_kernel<false>(float const*)"
B9C = "(anonymous namespace)::walk_closest_g_kernel(float const*, int)"
B9D = "(anonymous namespace)::walk_shadow_g_kernel(float const*, int)"
S1 = "(anonymous namespace)::surface_gather_kernel(float4 const*, int)"
B6 = "(anonymous namespace)::closest_wl_g_kernel(float const*, float const*)"
B2 = "void (anonymous namespace)::camera_wl_kernel<false>(float const*, int)"
EW = "void at::native::elementwise_kernel<128, 2>(int, at::native::Func)"
# a kernel whose name holds a walk kernel's only as a part of a word
NEAR = "void (anonymous namespace)::walk_camera_kernel_stats(float const*)"


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _chrome(kernels):
    ev = []
    for f in (0, 1000):
        ev.append(_x("frame", "user_annotation", f, 1000))
        ts = f + 10
        for name, dur in kernels:
            ev.append(_x(name, "kernel", ts, dur))
            ts += dur + 5
    return {"traceEvents": ev}


WALK = [(B9A, 100), (B9B, 60), (B9C, 40), (B9D, 20)]
OTHERS = [(S1, 70), (B6, 30), (B2, 50), (EW, 25), (NEAR, 45)]


def _run(tr, kind="frame"):
    return dataclasses.make_dataclass("Run", ["kind", "trace", "host"])(
        kind, tr, {})


@pytest.mark.parametrize("device_only", [False, True])
def test_walk_ms_sums_the_four_walk_kernels(device_only):
    """(100 + 60 + 40 + 20) us a frame, over two frames: 0.22 ms; the
    hit-row gather S1, B6, B2, an elementwise kernel and a name that
    only begins with a walk kernel's are left out."""
    names = tracing.port_kernel_names(harness.PORT / "csrc")
    chrome = _chrome(WALK + OTHERS)
    tr = (tracing.parse(chrome, "frame", names, 2000.0, 2) if device_only
          else tracing.parse(chrome, "frame", names))
    read = harness.load_reader("walk_ms.frame")
    assert read(_run(tr)) == pytest.approx(0.22)
    assert read(_run(tr)) < harness.load_reader("trace_ms.frame")(_run(tr))


def test_walk_ms_reads_nothing_without_a_walk_a_frame_or_a_trace():
    names = tracing.port_kernel_names(harness.PORT / "csrc")
    assert {"walk_camera_kernel", "walk_shadow_kernel",
            "walk_closest_g_kernel", "walk_shadow_g_kernel"} <= names
    read = harness.load_reader("walk_ms.frame")
    leaves = tracing.parse(_chrome(OTHERS), "frame", names)
    assert read(_run(leaves)) is None
    step = tracing.parse(_chrome(WALK), "frame", names)
    assert read(_run(step, "step")) is None
    assert read(_run(None)) is None
    empty = tracing.parse({"traceEvents": []}, "frame", names)
    assert read(_run(empty)) is None
