from .base_scene import BaseScene, FlatGeometry, SceneObject
from .lights import default_scene_lights, make_light
from .materials import MaterialDesc, MaterialTable, load_material_descs
from .scene import (TracedScene, load_scene, make_traced_scene,
                    traced_scene_from_numpy, with_sat)
from .wavefront import load_wavefront_obj

__all__ = ["BaseScene", "FlatGeometry", "SceneObject", "MaterialDesc",
           "MaterialTable", "TracedScene", "default_scene_lights",
           "load_material_descs", "load_scene", "load_wavefront_obj",
           "make_light", "make_traced_scene", "traced_scene_from_numpy",
           "with_sat"]
