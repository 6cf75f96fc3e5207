"""The comparison that decides ``correct``.

Frames: for each kept frame of the window (a sample drawn from the
seed), the plain reference renders a sample of its pixels, drawn from
the seed, from the same inputs and camera, and the RGB8 values are
compared: ``px_off``, the share of sampled pixels where a channel is
more than one level from the reference's, and ``mean_diff``, the mean
absolute difference in levels over every sampled channel.

Steps: for each kept step, the reference computes the loss and the
gradients of the whole frame. ``loss_gap`` is the relative gap of the
losses; ``grad_gap`` the worst leaf's gap, measured against the larger
of the reference leaf's norm and the median leaf norm: for the
per-triangle leaves, whose row order is the program's own, the larger of
the gap of their per-component sums over the rows (a vector's norm) and
the largest gap of their per-component norms; for the others the norm of
the difference.

``control`` puts the reference computed in that dtype in the program's
place: its pixels, or its loss and gradients, are compared in the same
way.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.render import (Opts, Scene, frame_pixels, step, to_rgb8)

PER_TRIANGLE = ("tri_a", "tri_ba", "tri_ca")
LEVEL_TOL = 1  # levels of RGB8 a pixel may differ by without counting


def ref_opts(cfg: dict, trf: dict) -> Opts:
    o = {**cfg.get("options", {}), **trf.get("options", {})}
    return Opts(reflections=o.get("reflections", True),
                transparency=o.get("transparency", True),
                shadows=o.get("shadows", True),
                supersample=o.get("supersample", False),
                max_bounces=o.get("max_bounces", 1),
                ambient=o.get("ambient", 0.1))


def sample_pixels(trf: dict, seed: int, index: int, device):
    """(px, py) of the pixels compared in frame ``index``."""
    w, h = trf["width"], trf["height"]
    n = min(trf["check"]["pixels"], w * h)
    flat = np.random.default_rng([seed, 3, index]).choice(w * h, n,
                                                          replace=False)
    flat = torch.from_numpy(flat).to(device)
    return flat % w, flat // w


def frame_numbers(cfg, trf, inp, kept, seed, device, control=None) -> dict:
    sc = Scene(inp)
    ctrl = None if control is None else Scene(inp, control)
    opts = ref_opts(cfg, trf)
    w, h = trf["width"], trf["height"]
    off = n = 0
    total = 0.0
    for i, (pos, tgt), out in kept:
        px, py = sample_pixels(trf, seed, i, device)
        pos, tgt = pos.to(device), tgt.to(device)
        ref = to_rgb8(frame_pixels(sc, pos, tgt, w, h, opts, px, py))
        if ctrl is None:
            got = torch.from_numpy(np.ascontiguousarray(out)).to(device)
            got = got[py, px]
        else:
            got = to_rgb8(frame_pixels(ctrl, pos, tgt, w, h, opts, px, py))
        diff = (got.int() - ref.int()).abs()
        off += int((diff.amax(1) > LEVEL_TOL).sum())
        total += float(diff.double().sum())
        n += px.numel()
    return {"px_off": off / max(n, 1), "mean_diff": total / max(3 * n, 1)}


def step_numbers(cfg, trf, inp, kept, seed, device, target,
                 control=None) -> dict:
    sc = Scene(inp)
    ctrl = None if control is None else Scene(inp, control)
    opts = ref_opts(cfg, trf)
    w, h = trf["width"], trf["height"]
    loss_gap = grad_gap = 0.0
    for _, (pos, tgt), out in kept:
        pos, tgt = pos.to(device), tgt.to(device)
        rl, rg = step(sc, pos, tgt, w, h, target, opts)
        loss, grads = out if ctrl is None else step(ctrl, pos, tgt, w, h,
                                                     target, opts)
        rl = float(rl)
        loss_gap = max(loss_gap, abs(float(loss) - rl) / abs(rl))
        norm = {k: float(torch.linalg.vector_norm(g.double()))
                for k, g in rg.items()}
        scale = float(np.median(list(norm.values())))
        for k, g in rg.items():
            p = grads[k].double()
            if k in PER_TRIANGLE:
                (ps, pn), (rs, rn) = _row_stats(p), _row_stats(g)
                gap = max(float(torch.linalg.vector_norm(ps - rs)),
                          float((pn - rn).abs().max()))
            else:
                gap = float(torch.linalg.vector_norm(
                    p.reshape(g.shape) - g.double()))
            grad_gap = max(grad_gap, gap / max(norm[k], scale))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap}


def _row_stats(g):
    """Order-free statistics of a per-triangle leaf (T, 3): the sums over
    the rows and the norms of the three components."""
    g = g.double().reshape(-1, 3)
    return g.sum(0), torch.sqrt((g * g).sum(0))


def numbers(kind, cfg, trf, inp, kept, seed, device, control=None) -> dict:
    """The numbers compared, for the program's kept outputs, or with
    ``control`` for the reference in that dtype put in their place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if kind == "frame":
        return frame_numbers(cfg, trf, inp, kept, seed, device, control)
    from .harness import target_image

    return step_numbers(cfg, trf, inp, kept, seed, device,
                        target_image(trf, seed, device), control)


def compare(kind, cfg, trf, inp, kept, limits, seed, device) -> dict:
    """{name: {"value", "limit"}} of every number the cell's limits name."""
    got = numbers(kind, cfg, trf, inp, kept, seed, device)
    return {k: {"value": got[k], "limit": limits[k]} for k in limits}
