"""Kernels launched on the device a frame (a count, averaged over the
traced frames)."""


def read(run):
    tr = run.trace
    if (run.kind != "frame" or tr is None or not tr.iters
            or not tr.device_ops):
        return None
    return sum(1 for _, cat, _, _ in tr.device_ops if cat == "kernel") \
        / tr.iters
