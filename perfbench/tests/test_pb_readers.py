"""The per-layer readers on a small recorded trace of two frames."""

import dataclasses

import pytest

from perfbench import harness, tracing

CAM = "void (anonymous namespace)::camera_wl_kernel<false>(float const*, int)"
B6 = "(anonymous namespace)::closest_wl_g_kernel(float const*, float const*)"
EW = "void at::native::elementwise_kernel<128, 2>(int, at::native::Func)"
D2H = "Memcpy DtoH (Device -> Pageable)"


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _chrome():
    ev = []
    for f in (0, 300):
        ev += [_x("frame", "user_annotation", f, 300),
               _x("to_rgb8", "user_annotation", f + 240, 60),
               _x("cudaMemcpyAsync", "cuda_runtime", f + 245, 30),
               _x(CAM, "kernel", f + 10, 100), _x(EW, "kernel", f + 120, 50),
               _x(B6, "kernel", f + 170, 30),
               _x(D2H, "gpu_memcpy", f + 250, 20)]
    return {"traceEvents": ev}


PORT = frozenset({"camera_wl_kernel", "closest_wl_g_kernel"})
EXPECTED = {"trace_ms.frame": 0.13, "shade_ms.frame": 0.05,
            "readback_ms.frame": 0.02, "kernels_per_frame": 3.0,
            "closest_g_ms.frame": 0.03,
            "device_idle_pct.frame": 100.0 / 3.0}


def _run(tr, kind="frame"):
    return dataclasses.make_dataclass("Run", ["kind", "trace", "host"])(
        kind, tr, {"scene_pack_s": 1.25})


@pytest.mark.parametrize("device_only", [False, True])
@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_values(metric, device_only):
    tr = (tracing.parse(_chrome(), "frame", PORT, 600.0, 2) if device_only
          else tracing.parse(_chrome(), "frame", PORT))
    assert tr.iters == 2
    assert harness.load_reader(metric)(_run(tr)) == pytest.approx(
        EXPECTED[metric])


def test_readers_of_the_other_kind_read_nothing():
    tr = tracing.parse(_chrome(), "frame", PORT)
    for m in ("trace_ms.step", "shade_ms.step", "kernels_per_step",
              "device_idle_pct.step"):
        assert harness.load_reader(m)(_run(tr)) is None
    empty = tracing.parse({"traceEvents": []}, "frame", PORT)
    assert harness.load_reader("trace_ms.frame")(_run(empty)) is None
    assert harness.load_reader("scene_pack_s")(_run(tr)) == 1.25


def test_breakdown_and_busy():
    tr = tracing.parse(_chrome(), "frame", PORT)
    assert tr.busy_us() == pytest.approx(400.0)
    b = tracing.breakdown(tr, tr)
    assert b["device_ops"][0] == [CAM, pytest.approx(200e-6)]
    assert b["idle_gaps"][0] == ["frame", pytest.approx(50e-6)]
    assert ["to_rgb8/cudaMemcpyAsync", pytest.approx(40e-6)] in b["idle_gaps"]


def test_port_kernel_names_from_sources():
    names = tracing.port_kernel_names(harness.PORT / "csrc")
    assert {"camera_wl_kernel", "shadow_wl_kernel", "closest_wl_g_kernel",
            "words_cluster_kernel"} <= names
    tr = tracing.parse(_chrome(), "frame", names)
    assert tr.is_port_kernel(CAM) and tr.is_port_kernel(B6)
    assert not tr.is_port_kernel(EW)
