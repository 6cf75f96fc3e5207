"""The volume march kernel (V1, ``csrc/volume.cu``): the min/max-brick
march of ``volume.vtree`` over every ray of a frame.

It replaces the JAX package's ``volume/vtree.py:_march``, a
``lax.while_loop`` of jnp ops (not a Pallas kernel) that XLA compiles into
one loop on the TPU. In eager PyTorch the same loop is ~50 launches and a
host sync (is any ray live?) per step, over hundreds of steps; here it is
one thread per ray. A tensor on the CPU takes the plain version,
``volume.vtree._march_plain``; on the card the kernel equals it bit for
bit. Its launch counter is ``march.launches``, in ``ops.traverse``'s
registry (``reset_launch_counts``, ``launch_counts``).
"""

from __future__ import annotations

import torch

MODES = {"iso": 0, "mip": 1}


def march(vt, o, d, t0, t1, iso: float, mode: str, max_steps: int):
    """V1: the march of rays ``o``/``d`` (R, 3) in voxel space (zyx) over
    [``t0``, ``t1``] (R,) through the pyramid ``vt`` (``volume.vtree.VTree``),
    ``mode`` "iso" (first crossing of ``iso``) or "mip" (maximum), at most
    ``max_steps`` steps. ``o`` may be one origin expanded over the rays
    (stride 0, as ``volume_rays`` gives it), which the kernel reads as
    one. Returns (best, hit_t) (R,), as ``_march_plain`` gives them, the
    mip mode's extra sample of a ray done before the last ray included
    (ROADMAP C19).

    Iso mode is one launch of ``march_kernel``; mip mode is two, each
    counted: ``march_kernel`` and ``mip_extra_kernel`` for C19."""
    from .traverse import _check, _launched, _on_cuda, _ptr, _stream

    if not _on_cuda(t0):
        from ..volume.vtree import _march_plain

        return _march_plain(vt, o, d, t0, t1, iso, mode, max_steps)
    from ._build import library

    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: iso or mip")
    dev = t0.device
    r = t0.shape[0]
    shape = tuple(vt.shape)
    cells = lambda c: tuple((n + c - 1) // c for n in shape)
    tables = (vt.vol, vt.brick_max, vt.brick_min, vt.coarse_max)
    for name, t, s in zip(("vol", "brick_max", "brick_min", "coarse_max"),
                          tables, (shape, cells(4), cells(4), cells(16))):
        _check(t, name, torch.float32, s, dev)
    if tuple(o.shape) != (r, 3):
        raise ValueError(f"o has shape {tuple(o.shape)}, expected {(r, 3)}")
    o_stride = 0 if o.stride(0) == 0 else 3
    _check(o[:1] if o_stride == 0 else o, "o", torch.float32,
           (1, 3) if o_stride == 0 else (r, 3), dev)
    for name, t, s in (("d", d, (r, 3)), ("t0", t0, (r,)), ("t1", t1, (r,))):
        _check(t, name, torch.float32, s, dev)
    best, hit_t = (torch.empty(r, dtype=torch.float32, device=dev)
                   for _ in range(2))
    lib = library()
    vol = (*(_ptr(x) for x in tables), _ptr(o), o_stride)
    if mode == "iso":
        scratch = (None, None, None)
    else:  # the frozen t and k_i of each ray, K
        t = torch.empty(r, dtype=torch.float32, device=dev)
        steps = torch.empty(r, dtype=torch.int32, device=dev)
        k_max = torch.zeros(1, dtype=torch.int32, device=dev)
        scratch = (_ptr(t), _ptr(steps), _ptr(k_max))
    _launched(lib.snail_march(
        *vol, *(_ptr(x) for x in (d, t0, t1)), float(iso), *shape, r,
        MODES[mode], max_steps, _ptr(best), _ptr(hit_t), *scratch,
        _stream()), "march")
    march.launches += 1
    if mode == "mip":
        _launched(lib.snail_march_mip_extra(
            *vol, _ptr(d), *shape, r, *scratch, _ptr(best), _stream()),
            "march mip_extra")
        march.launches += 1
    return best, hit_t
