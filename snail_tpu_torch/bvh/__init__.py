from .build import BVH, build_bvh, build_bvh_fast

__all__ = ["BVH", "build_bvh", "build_bvh_fast"]
