"""Device time a frame (ms) in B6, the closest hit of rays with their own
origins on leaf tables (``closest_wl_g_kernel``): the bounce rays."""

import re

_B6 = re.compile(r"(?<!\w)closest_wl_g_kernel\s*[<(]")


def read(run):
    tr = run.trace
    if (run.kind != "frame" or tr is None or not tr.iters
            or not tr.device_ops):
        return None
    ops = [dur for name, cat, _, dur in tr.device_ops
           if cat == "kernel" and _B6.search(name)]
    return sum(ops) / tr.iters / 1e3 if ops else None
