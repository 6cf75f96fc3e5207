"""Device-to-host copy time a frame (ms): the frame's readback."""


def read(run):
    tr = run.trace
    if (run.kind != "frame" or tr is None or not tr.iters
            or not tr.device_ops):
        return None
    us = sum(dur for name, cat, _, dur in tr.device_ops
             if cat == "gpu_memcpy" and "DtoH" in name)
    return us / tr.iters / 1e3
