"""Smoothed FPS counter (reference src/frame_counter.{h,cpp}) plus the
min/max/avg accounting the distributed client keeps (client.cpp:215-252,
reset keys X/Z); a copy of ``snail_tpu.utils.frame_counter``."""

from __future__ import annotations

import time


class FrameCounter:
    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self._last = None
        self.fps = 0.0
        self.fps_min = float("inf")
        self.fps_max = 0.0
        self._frames = 0
        self._t0 = None

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            inst = 1.0 / dt if dt > 0 else 0.0
            self.fps = (
                inst
                if self.fps == 0.0
                else self.smoothing * self.fps + (1 - self.smoothing) * inst
            )
            self.fps_min = min(self.fps_min, inst)
            self.fps_max = max(self.fps_max, inst)
        else:
            self._t0 = now
        self._last = now
        self._frames += 1
        return self.fps

    @property
    def fps_avg(self) -> float:
        if self._t0 is None or self._frames < 2:
            return 0.0
        return (self._frames - 1) / (self._last - self._t0)

    def reset(self) -> None:
        self.__init__(self.smoothing)
