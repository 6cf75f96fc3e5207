"""Rendering and training over several devices (``snail_tpu.parallel``),
on ``torch.distributed``: one process per device."""

from . import distributed
from .mesh import (Mesh, make_mesh, render_frame_sharded, shard_rays,
                   train_step_sharded)

__all__ = [
    "Mesh",
    "make_mesh",
    "render_frame_sharded",
    "train_step_sharded",
    "shard_rays",
    "distributed",
]
