"""Traversal and render statistics (``snail_tpu.utils.stats``, the
reference's TreeStats, src/tree_stats.h:36-130: counters for
intersections, loop iterations and rays, shown on the HUD by GenInfo
"in:.. it:.. ms:.."). Spans of the program's stages, with time, are
``utils.trace``'s.

The counters come from the counting kernels through
``render.fast.render_frame_fast_stats``, under the JAX package's names:
on a scene with leaf tables B8a/B8b (``csrc/worklist.cu`` ``Counters``),
on one with node tables the walk's B9e/B9f (``csrc/walk.cuh``
``WalkCounts``), summed over each packet's warps:

  name        worklist (B8a/B8b)              walk (B9e/B9f)
  nodes       populated words a warp tests    node rows a warp loads
              at the leaf level (B8b: after
              its block and word skips)
  leaves      leaves a warp keeps             leaf rows among them
  quarters    (leaf, warp) pairs intersected  (leaf, warp) pairs intersected
  tri_blocks  triangles tested per pair       triangles tested per pair
  chunks      bands a warp enters             stack pops

:func:`tree_stats_from_counters` turns the dict into a :class:`TreeStats`
as the render server does.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TreeStats:
    intersects: int = 0
    loop_iters: int = 0
    rays: int = 0
    runs: int = 0

    def __iadd__(self, other: "TreeStats") -> "TreeStats":
        self.intersects += other.intersects
        self.loop_iters += other.loop_iters
        self.rays += other.rays
        self.runs += other.runs
        return self

    def gen_info(self, ms: float, mrays: float) -> str:
        """HUD string (reference TreeStats::GenInfo)."""
        return (
            f"in:{self.intersects // 1000}k it:{self.loop_iters // 1000}k "
            f"ms:{ms:.2f} MRays/s:{mrays:.1f}"
        )

    def reset(self) -> None:
        self.__init__()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def tree_stats_from_counters(kstats: dict, n_lights: int) -> TreeStats:
    """A frame's :class:`TreeStats` from the counter dict of
    ``render_frame_fast_stats`` (the conversion of the JAX package's
    server, apps/server.py:111-121): ray-triangle tests are tri_blocks
    times the rays of one (RAYS_PER_TRI_BLOCK), loop iterations ``nodes``
    (the bit words scanned, or the node rows walked), runs the primary
    wavefront and one per light."""
    from ..ops.traverse import RAYS_PER_TRI_BLOCK  # ops imports utils

    return TreeStats(intersects=kstats["tri_blocks"] * RAYS_PER_TRI_BLOCK,
                     loop_iters=kstats["nodes"], rays=kstats["rays"],
                     runs=1 + n_lights)

