"""The material table (``snail_tpu.scene.materials.MaterialTable``), NumPy.

Only what the forward frame needs: the SoA table and its default build.
``.mtl`` parsing and textures are later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class MaterialTable:
    """SoA per-material parameters, gathered by mat_id during shading.

    Index 0 is the default material (the reference's ``defaultMat``,
    scene_inl.h:262): white diffuse, N.L shading, opaque, no texture."""

    diffuse: np.ndarray  # float32[M, 3] Kd
    specular: np.ndarray  # float32[M, 3] Ks
    emissive: np.ndarray  # float32[M, 3] Ke
    dissolve: np.ndarray  # float32[M]   d (1 = opaque)
    reflectivity: np.ndarray  # float32[M] blend factor for mirror bounce
    flags: np.ndarray  # int32[M] F_* bits
    diffuse_tex: np.ndarray  # int32[M] texture id or -1
    dissolve_tex: np.ndarray  # int32[M] texture id or -1
    names: List[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def build(mat_names: Dict[str, int]) -> "MaterialTable":
        """The default table for a scene's material-name registry: every
        name gets the default material, as in the JAX package's
        ``MaterialTable.build(mat_names, [])``."""
        m = max(mat_names.values()) + 1 if mat_names else 1
        tbl = MaterialTable(
            diffuse=np.ones((m, 3), np.float32),
            specular=np.zeros((m, 3), np.float32),
            emissive=np.zeros((m, 3), np.float32),
            dissolve=np.ones(m, np.float32),
            reflectivity=np.zeros(m, np.float32),
            flags=np.zeros(m, np.int32),
            diffuse_tex=np.full(m, -1, np.int32),
            dissolve_tex=np.full(m, -1, np.int32),
            names=[""] * m,
        )
        for name, mid in mat_names.items():
            tbl.names[mid] = name
        return tbl
