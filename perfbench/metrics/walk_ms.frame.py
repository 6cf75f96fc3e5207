"""Device time a frame (ms) in the walk kernels of node tables
(``csrc/walk.cu``: ``walk_camera_kernel``, ``walk_shadow_kernel``,
``walk_closest_g_kernel``, ``walk_shadow_g_kernel``): the traversal
alone, without the hit-row gather or any other of the program's
kernels."""

import re

_WALK = re.compile(r"(?<!\w)(?:walk_camera_kernel|walk_shadow_kernel"
                   r"|walk_closest_g_kernel|walk_shadow_g_kernel)\s*[<(]")


def read(run):
    tr = run.trace
    if (run.kind != "frame" or tr is None or not tr.iters
            or not tr.device_ops):
        return None
    ops = [dur for name, cat, _, dur in tr.device_ops
           if cat == "kernel" and _WALK.search(name)]
    return sum(ops) / tr.iters / 1e3 if ops else None
