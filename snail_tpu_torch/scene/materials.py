"""Materials: `.mtl` parsing and the material table, a NumPy copy of
``snail_tpu.scene.materials``.

Parsing mirrors the reference's ``LoadMaterialDescs``
(src/shading/material.cpp:59-123): Ka/Kd/Ks/Ke colors (single-value colors
broadcast), Tf, illum, d (dissolve), Ns, Ni, and the map_* texture names.

Where the reference builds a polymorphic material object per name
(``MakeMaterials``, src/shading/material.cpp:168-192: diffuse+dissolve maps
-> TransparentMaterial, diffuse map -> TexMaterial, else UberMaterial), the
rebuild builds a :class:`MaterialTable` — SoA parameter arrays indexed by
material id — because on TPU "virtual dispatch" is a gather + masked blend.
The material *kind* collapses into data: a texture id of -1 means "use the
constant Kd"; a dissolve texture id of -1 plus dissolve factor 1 means
opaque.

Reference material semantics reproduced in the integrator:
- SimpleMaterial: diffuse = color * |dir.n|           (simple_material.h:19-24)
- TexMaterial:    diffuse = tex(uv,mip) * (dir.n)     (tex_material.h:16-24)
- TransparentMaterial: diffuse = ctex * (dir.n), opacity = ttex.x
                                                     (transparent_material.h:17-36)
- UberMaterial:   diffuse = Kd * |dir.n|, specular = Ks, opacity = d
                                                     (uber_material.h:12-27)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

# Material flags (reference shading/material.h:12-17)
F_TEXCOORDS = 1
F_REFLECTION = 2
F_REFRACTION = 4
F_TRANSPARENCY = 8


@dataclasses.dataclass
class MaterialDesc:
    """One parsed `.mtl` entry (reference MaterialDesc,
    src/shading/material.h:54-70)."""

    name: str = ""
    ambient: tuple = (0.0, 0.0, 0.0)
    diffuse: tuple = (1.0, 1.0, 1.0)
    specular: tuple = (0.0, 0.0, 0.0)
    emissive: tuple = (0.0, 0.0, 0.0)
    transmission: tuple = (0.0, 0.0, 0.0)
    illumination_model: int = 0
    dissolve_factor: float = 0.0
    specular_exponent: float = 0.0
    refraction_index: float = 0.0
    ambient_map: str = ""
    diffuse_map: str = ""
    specular_map: str = ""
    emissive_map: str = ""
    exponent_map: str = ""
    dissolve_map: str = ""


def _read_color(tok: List[str]) -> tuple:
    # single value broadcasts to rgb (reference ReadColor,
    # src/shading/material.cpp:35-51)
    if not tok:
        return (0.0, 0.0, 0.0)
    x = float(tok[0])
    if len(tok) < 3:
        return (x, x, x)
    return (x, float(tok[1]), float(tok[2]))


def load_material_descs(path: str) -> List[MaterialDesc]:
    mats: List[MaterialDesc] = []
    cur: Optional[MaterialDesc] = None
    try:
        fh = open(path, "r", errors="replace")
    except OSError:
        return mats
    with fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            tok = line.split()
            key, args = tok[0], tok[1:]
            if key == "newmtl":
                if cur is not None and cur.name:
                    mats.append(cur)
                cur = MaterialDesc(name=args[0] if args else "")
            elif cur is None:
                continue
            elif key == "Ka":
                cur.ambient = _read_color(args)
            elif key == "Kd":
                cur.diffuse = _read_color(args)
            elif key == "Ks":
                cur.specular = _read_color(args)
            elif key == "Ke":
                cur.emissive = _read_color(args)
            elif key == "Tf":
                cur.transmission = _read_color(args)
            elif key == "illum":
                cur.illumination_model = int(float(args[0]))
            elif key == "d":
                if args and args[0] != "-halo":
                    cur.dissolve_factor = float(args[0])
            elif key == "Ns":
                cur.specular_exponent = float(args[0])
            elif key == "Ni":
                cur.refraction_index = float(args[0])
            elif key == "map_Ka":
                cur.ambient_map = args[-1]
            elif key == "map_Kd":
                cur.diffuse_map = args[-1]
            elif key == "map_Ks":
                cur.specular_map = args[-1]
            elif key == "map_Ke":
                cur.emissive_map = args[-1]
            elif key == "map_Ns":
                cur.exponent_map = args[-1]
            elif key == "map_d":
                cur.dissolve_map = args[-1]
    if cur is not None and cur.name:
        mats.append(cur)
    return mats


@dataclasses.dataclass
class MaterialTable:
    """SoA per-material parameters, gathered by mat_id during shading.

    Index 0 is the default material (the reference's ``defaultMat`` used when
    a triangle's material name is unknown, scene_inl.h:262): white diffuse,
    N.L shading, opaque, no texture.
    """

    diffuse: np.ndarray  # float32[M, 3] Kd
    specular: np.ndarray  # float32[M, 3] Ks
    emissive: np.ndarray  # float32[M, 3] Ke
    dissolve: np.ndarray  # float32[M]   d (1 = opaque)
    reflectivity: np.ndarray  # float32[M] blend factor for mirror bounce
    flags: np.ndarray  # int32[M] F_* bits
    diffuse_tex: np.ndarray  # int32[M] texture id or -1
    dissolve_tex: np.ndarray  # int32[M] texture id or -1
    names: List[str] = dataclasses.field(default_factory=list)

    @property
    def num_materials(self) -> int:
        return len(self.diffuse)

    @staticmethod
    def build(
        mat_names: Dict[str, int],
        descs: Sequence[MaterialDesc] = (),
        tex_ids: Optional[Dict[str, int]] = None,
        reflectivity: Optional[Dict[str, float]] = None,
    ) -> "MaterialTable":
        """Assemble the table for a scene's material-name registry.

        ``mat_names`` maps name -> scene mat id (BaseScene.mat_names, the
        usemtl registry); ``descs`` come from the `.mtl`; names missing from
        ``descs`` get the default material (reference UpdateMaterialIds
        mapping unknown names to ~0 -> defaultMat, bvh/tree.cpp:376-386);
        with no ``descs``, every name gets the default material.
        """
        tex_ids = tex_ids or {}
        reflectivity = reflectivity or {}
        by_name = {d.name: d for d in descs}
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
            d = by_name.get(name)
            if d is None:
                continue
            tbl.diffuse[mid] = d.diffuse
            tbl.specular[mid] = d.specular
            tbl.emissive[mid] = d.emissive
            # reference UberMaterial treats d as opacity directly
            tbl.dissolve[mid] = d.dissolve_factor if d.dissolve_factor > 0 else 1.0
            tbl.reflectivity[mid] = reflectivity.get(name, 0.0)
            flags = 0
            dt = tex_ids.get(d.diffuse_map, -1) if d.diffuse_map else -1
            tt = tex_ids.get(d.dissolve_map, -1) if d.dissolve_map else -1
            if dt >= 0:
                flags |= F_TEXCOORDS
            if tt >= 0:
                flags |= F_TEXCOORDS | F_TRANSPARENCY
            if reflectivity.get(name, 0.0) > 0:
                flags |= F_REFLECTION
            tbl.diffuse_tex[mid] = dt
            tbl.dissolve_tex[mid] = tt
            tbl.flags[mid] = flags
        return tbl
