from .base_scene import BaseScene, FlatGeometry, SceneObject
from .materials import MaterialTable
from .scene import TracedScene, make_traced_scene, traced_scene_from_numpy

__all__ = ["BaseScene", "FlatGeometry", "SceneObject", "MaterialTable",
           "TracedScene", "make_traced_scene", "traced_scene_from_numpy"]
