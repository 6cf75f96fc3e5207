from .build import BVH, build_bvh, build_bvh_fast
from .cache import build_or_load, load_bvh, save_bvh

__all__ = ["BVH", "build_bvh", "build_bvh_fast", "build_or_load", "load_bvh",
           "save_bvh"]
