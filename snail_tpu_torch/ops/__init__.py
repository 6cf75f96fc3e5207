from .intersect import (intersect_any_brute_force, intersect_brute_force,
                        intersect_tris)

__all__ = ["intersect_any_brute_force", "intersect_brute_force",
           "intersect_tris"]
