"""The hit-row gather of the forward frame (``csrc/shade.cu``
``surface_gather_kernel``): the ``sh_pack`` columns that one traced
wavefront's shading reads, each in a contiguous plane.

The JAX package takes the rows with a jnp gather that XLA fuses into the
shading; it has no kernel here to port. The kernel reads only the 16-byte
chunks of each ray's row that hold a requested column and writes each
column to its own (R,) plane, so the shading's elementwise ops read
contiguous planes in place of stride-32 views of whole rows. A tensor on
the CPU takes the plain version (``index_select`` of the rows, then the
columns); on the card the kernel equals it bit for bit. Its launch
counter is ``surface_rows.launches``, in ``ops.traverse``'s registry
(``reset_launch_counts``, ``launch_counts``); while tracing is on, each
gather adds its rays to the counter ``gather.rows`` and its columns to
``gather.cols``.
"""

from __future__ import annotations

import torch

from ..core.vecmath import BIG
from ..utils import trace

SH_COLS = 32  # columns of a sh_pack row


def surface_rows(sh_pack, dist, tri, cols):
    """(len(cols), R) float32: plane k holds column ``cols[k]`` of each
    ray's ``sh_pack`` (T, 32) row, ``cols`` strictly increasing in [0,
    32). A ray's row is ``tri`` (R,) where 0 < ``dist`` (R,) < BIG (a hit)
    and row 0 otherwise (a miss), as ``render.fast``'s shading reads it; a
    hit whose ``tri`` lies outside the table (the traversal gives none)
    reads row 0 too, on the card and on the CPU alike.

    On the card: ``sh_pack`` float32, contiguous, 16-byte aligned;
    ``dist`` float32 and ``tri`` int32, contiguous, on its device."""
    cols = tuple(int(c) for c in cols)
    if any(not 0 <= c < SH_COLS for c in cols) or any(
            a >= b for a, b in zip(cols, cols[1:])):
        raise ValueError(f"columns {cols}: strictly increasing, in "
                         f"[0, {SH_COLS})")
    r = dist.shape[0]
    trace.count("gather.rows", r)
    trace.count("gather.cols", len(cols))
    from .traverse import _check, _launched, _on_cuda, _ptr, _stream

    if not _on_cuda(dist):
        hit = (dist > 0.0) & (dist < BIG)
        row = torch.where(hit & (tri >= 0) & (tri < sh_pack.shape[0]), tri,
                          0)
        return sh_pack.index_select(0, row.long()).T[list(cols)]
    from ._build import library

    dev = dist.device
    _check(sh_pack, "sh_pack", torch.float32, (sh_pack.shape[0], SH_COLS),
           dev)
    if sh_pack.data_ptr() % 16:
        raise ValueError("sh_pack is not 16-byte aligned")
    _check(dist, "dist", torch.float32, (r,), dev)
    _check(tri, "tri", torch.int32, (r,), dev)
    out = torch.empty((len(cols), r), dtype=torch.float32, device=dev)
    if r == 0 or not cols:
        return out
    mask = sum(1 << c for c in cols)
    _launched(library().snail_surface_gather(
        _ptr(sh_pack), sh_pack.shape[0], _ptr(dist), _ptr(tri), r, mask,
        _ptr(out), _stream()), "surface_gather")
    surface_rows.launches += 1
    return out
