from .vjp import diff_closest_hit

__all__ = ["diff_closest_hit"]
