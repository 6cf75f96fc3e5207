"""Host-side records: the traversal counters' ``TreeStats``, the frame
counter and image IO (PIL imported where a file is read or written)."""

from .frame_counter import FrameCounter
from .image import compare_img, load_image, save_image
from .stats import TreeStats

__all__ = ["FrameCounter", "TreeStats", "compare_img", "load_image",
           "save_image"]
