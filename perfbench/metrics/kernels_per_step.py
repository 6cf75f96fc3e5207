"""Kernels launched on the device a step (a count, averaged over the
traced steps)."""


def read(run):
    tr = run.trace
    if (run.kind != "step" or tr is None or not tr.iters
            or not tr.device_ops):
        return None
    return sum(1 for _, cat, _, _ in tr.device_ops if cat == "kernel") \
        / tr.iters
