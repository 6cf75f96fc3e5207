"""The device scene (``snail_tpu.scene.scene.TracedScene``), with only what
the forward frame reads: triangle rows, leaf tables, shading rows,
materials and lights, as tensors on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..core.types import Light
from ..ops.traverse import LeafTables, pack_leaf_tables, pack_tri_rows
from .base_scene import FlatGeometry
from .materials import MaterialTable

LEAF_PAD = 64  # degenerate triangles appended, as in the JAX package


@dataclasses.dataclass(frozen=True)
class TracedScene:
    """tri_rows float32 (T, 16): a, ba, ca, n = ba x ca, pad — triangles
    permuted to the BVH's leaf order and padded with LEAF_PAD degenerate
    rows (the reference reorders at build, bvh/tree.cpp:245-253).
    sh_pack float32 (T, 32): n0, n_e1, n_e2, uv0, uv_e1, uv_e2, mat id,
    then the triangle's material row written out in full (16:32).
    mat_pack float32 (M, 16): kd, ks, reflect, dissolve, difftex, disstex,
    emissive, flags, pad."""

    tri_rows: torch.Tensor
    leaves: LeafTables
    root_lo: torch.Tensor
    root_hi: torch.Tensor
    sh_pack: torch.Tensor
    mat_pack: torch.Tensor
    lights: Optional[Light]
    has_refl: bool
    has_transp: bool
    textured: bool = False  # texture atlases are a later slice
    num_tris: int = 0

    @property
    def device(self) -> torch.device:
        return self.tri_rows.device

    def to(self, device) -> "TracedScene":
        mv = lambda t: t.to(device)
        return dataclasses.replace(
            self, tri_rows=mv(self.tri_rows), leaves=self.leaves.to(device),
            root_lo=mv(self.root_lo), root_hi=mv(self.root_hi),
            sh_pack=mv(self.sh_pack), mat_pack=mv(self.mat_pack),
            lights=None if self.lights is None else self.lights.to(device))


def _mat_pack(materials: MaterialTable) -> np.ndarray:
    m = len(materials.diffuse)
    mat_pack = np.zeros((m, 16), np.float32)
    mat_pack[:, 0:3] = materials.diffuse
    mat_pack[:, 3:6] = materials.specular
    mat_pack[:, 6] = materials.reflectivity
    mat_pack[:, 7] = materials.dissolve
    mat_pack[:, 8] = materials.diffuse_tex.astype(np.float32)
    mat_pack[:, 9] = materials.dissolve_tex.astype(np.float32)
    mat_pack[:, 10:13] = materials.emissive
    mat_pack[:, 13] = materials.flags.astype(np.float32)
    return mat_pack


def _sh_pack(g: FlatGeometry, mat_pack: np.ndarray) -> np.ndarray:
    sh_pack = np.zeros((len(g.a), 32), np.float32)
    sh_pack[:, 0:3] = g.n0
    sh_pack[:, 3:6] = g.n_e1
    sh_pack[:, 6:9] = g.n_e2
    sh_pack[:, 9:11] = g.uv0
    sh_pack[:, 11:13] = g.uv_e1
    sh_pack[:, 13:15] = g.uv_e2
    sh_pack[:, 15] = g.mat_id.astype(np.float32)
    sh_pack[:, 16:32] = mat_pack[np.clip(g.mat_id, 0, len(mat_pack) - 1)]
    return sh_pack


def make_traced_scene(geom: FlatGeometry, bvh,
                      materials: Optional[MaterialTable] = None,
                      lights: Optional[Light] = None,
                      device="cpu") -> TracedScene:
    """Assemble the device scene from host-built pieces: ``geom`` as
    flattened, ``bvh`` from ``snail_tpu.bvh.build_bvh`` (leaf size at most
    ``ops.traverse.IVAL_LEAF``)."""
    g = geom.permuted(bvh.order).padded(LEAF_PAD)
    if materials is None:
        materials = MaterialTable.build({"": 0})
    mat_pack = _mat_pack(materials)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return TracedScene(
        tri_rows=dev(pack_tri_rows(g.a, g.ba, g.ca)),
        leaves=pack_leaf_tables(bvh.node_lo, bvh.node_hi, bvh.child,
                                bvh.count).to(device),
        root_lo=dev(bvh.node_lo[0].astype(np.float32)),
        root_hi=dev(bvh.node_hi[0].astype(np.float32)),
        sh_pack=dev(_sh_pack(g, mat_pack)),
        mat_pack=dev(mat_pack),
        lights=None if lights is None else lights.to(device),
        has_refl=bool(np.any(materials.reflectivity > 0.0)),
        has_transp=bool(np.any(materials.dissolve < 1.0)),
        num_tris=geom.num_tris,
    )


def traced_scene_from_numpy(arrays: Mapping[str, np.ndarray],
                            device="cpu") -> TracedScene:
    """The port's scene from the JAX ``TracedScene``'s fields as NumPy
    arrays, keyed by their JAX names: node_lo, node_hi, node_child,
    node_count, tri_a, tri_ba, tri_ca, sh_pack, mat_pack, mat_reflect,
    mat_dissolve, optionally tex_atlas, and the lights as light_pos,
    light_color, light_radius (absent: no lights)."""
    a = {k: np.asarray(v) for k, v in arrays.items() if v is not None}
    dev = lambda x: torch.from_numpy(np.array(x, np.float32)).to(device)
    lights = None
    if "light_pos" in a:
        lights = Light.make(a["light_pos"], a["light_color"],
                            a["light_radius"], device=device)
    return TracedScene(
        tri_rows=dev(pack_tri_rows(a["tri_a"], a["tri_ba"], a["tri_ca"])),
        leaves=pack_leaf_tables(a["node_lo"], a["node_hi"], a["node_child"],
                                a["node_count"]).to(device),
        root_lo=dev(a["node_lo"][0]),
        root_hi=dev(a["node_hi"][0]),
        sh_pack=dev(a["sh_pack"]),
        mat_pack=dev(a["mat_pack"]),
        lights=lights,
        has_refl=bool(np.any(a["mat_reflect"] > 0.0)),
        has_transp=bool(np.any(a["mat_dissolve"] < 1.0)),
        textured="tex_atlas" in a,
        num_tris=len(a["tri_a"]) - LEAF_PAD,
    )
