"""Device time a frame (ms) in kernels that are not the program's own:
elementwise shading, gathers, reductions, autograd's backward."""


def read(run):
    tr = run.trace
    if (run.kind != "frame" or tr is None or not tr.iters
            or not tr.device_ops):
        return None
    us = sum(dur for name, cat, _, dur in tr.device_ops
             if cat == "kernel" and not tr.is_port_kernel(name))
    return us / tr.iters / 1e3
