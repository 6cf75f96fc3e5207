"""The device scene (``snail_tpu.scene.scene.TracedScene``), with what the
forward and differentiable frames read: triangle rows, the traversal's
tables (worklist leaf tables, or with ``walk=True`` the node tree of the
walk kernels; a BVH whose leaves hold more than IVAL_LEAF triangles
always gets the node tree, for the fat-leaf kernels, and so does one of
more leaves than leaf tables hold, WL_MAX_LP), shading rows,
materials, the primal triangle and material arrays that gradients flow
to, lights and texture atlases, as tensors on one device; and the
one-call start-up ``load_scene`` (OBJ -> flip/generate normals -> BVH
build or cache -> MTL -> textures -> lights).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..core.types import Light, resolve_device
from ..ops.traverse import (IVAL_LEAF, LEAF_BLOCK, WL_MAX_LP, LeafTables,
                             NodeTables, pack_leaf_tables, pack_node_tables,
                             pack_tri_rows, tree_depth)
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
    emissive, flags, pad.

    The traversal's tables, one kind per scene: ``leaves``, the worklist
    kernels' leaf tables, or ``nodes``, the node tree (a scene built with
    ``walk=True``, the port's explicit form of the JAX package's
    ``SNAIL_WL=0``, or one whose leaves hold more than IVAL_LEAF
    triangles, which the JAX package gives no leaf tables, or more than
    WL_MAX_LP leaves, more than the words passes take); the entry
    points route by which one the scene holds, and a node tree by its
    ``leaf_max`` (walk or fat-leaf kernels). ``depth``: the BVH's depth
    (root 0).

    The primal arrays, the parameters of ``render_frame_fast_diff``:
    tri_a, tri_ba, tri_ca float32 (T, 3) in the order and padding of
    tri_rows; sh_mat int32 (T,) the material id of each triangle;
    mat_diffuse, mat_specular float32 (M, 3). The kernels trace tri_rows
    as built: replacing tri_a (a gradient step) does not move the rows,
    as the JAX package's pk_tris is not rebuilt either (ROADMAP C9).

    Textures (None: an untextured scene): tex_atlas float32 (NT, 2H, W, 3)
    and tex_meta int32 (NT, 4), the pyramid atlas of ``scene.textures``;
    tex_sat float32 (NT, H, W, 3), its summed-area tables (:func:`with_sat`).
    has_diss_tex: a material reads a dissolve map (the portable
    integrator's opacity; the packed frame reads none, as the JAX
    package's)."""

    tri_rows: torch.Tensor
    leaves: Optional[LeafTables]
    root_lo: torch.Tensor
    root_hi: torch.Tensor
    sh_pack: torch.Tensor
    mat_pack: torch.Tensor
    tri_a: torch.Tensor
    tri_ba: torch.Tensor
    tri_ca: torch.Tensor
    sh_mat: torch.Tensor
    mat_diffuse: torch.Tensor
    mat_specular: torch.Tensor
    lights: Optional[Light]
    has_refl: bool
    has_transp: bool
    num_tris: int = 0
    nodes: Optional[NodeTables] = None
    depth: int = 0
    tex_atlas: Optional[torch.Tensor] = None
    tex_meta: Optional[torch.Tensor] = None
    tex_sat: Optional[torch.Tensor] = None
    has_diss_tex: bool = False

    @property
    def device(self) -> torch.device:
        return self.tri_rows.device

    def with_lights(self, lights: Optional[Light]) -> "TracedScene":
        return dataclasses.replace(self, lights=lights)

    def to(self, device) -> "TracedScene":
        mv = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, leaves=None if self.leaves is None else self.leaves.to(device),
            nodes=None if self.nodes is None else self.nodes.to(device),
            lights=None if self.lights is None else self.lights.to(device),
            **{name: mv(getattr(self, name)) for name in _TENSORS})


_TENSORS = ("tri_rows", "root_lo", "root_hi", "sh_pack", "mat_pack", "tri_a",
            "tri_ba", "tri_ca", "sh_mat", "mat_diffuse", "mat_specular",
            "tex_atlas", "tex_meta", "tex_sat")


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


def _tables(walk: bool, lo, hi, child, count, axis, first, device):
    """(leaves, nodes): the traversal tables of one kind, on ``device``:
    node tables with ``walk``, for leaves over IVAL_LEAF triangles (as
    ``make_traced_scene``'s ``_pack_wl`` :187-194 packs no leaf tables
    there) or for more leaves than leaf tables hold (WL_MAX_LP slots),
    else leaf tables."""
    lp = -(-int(np.count_nonzero(count)) // LEAF_BLOCK) * LEAF_BLOCK
    if walk or int(np.max(count)) > IVAL_LEAF or lp > WL_MAX_LP:
        return None, pack_node_tables(lo, hi, child, count, axis,
                                      first).to(device)
    return pack_leaf_tables(lo, hi, child, count).to(device), None


def make_traced_scene(geom: FlatGeometry, bvh,
                      materials: Optional[MaterialTable] = None,
                      lights: Optional[Light] = None, textures=None,
                      device="cuda", walk: bool = False) -> TracedScene:
    """Assemble the device scene from host-built pieces: ``geom`` as
    flattened, ``bvh`` from ``snail_tpu_torch.bvh.build_bvh`` (leaf size at
    most ``ops.traverse.LEAF_PAD``), ``textures`` an (atlas, meta) pair of
    ``scene.textures.build_pyramid_atlas`` or None, on ``device`` (the card
    unless the caller asks for the CPU); with ``walk``, leaves over
    ``ops.traverse.IVAL_LEAF`` triangles or more than
    ``ops.traverse.WL_MAX_LP`` leaves, node tables and no leaf tables."""
    device = resolve_device(device)
    g = geom.permuted(bvh.order).padded(LEAF_PAD)
    if materials is None:
        materials = MaterialTable.build({"": 0})
    mat_pack = _mat_pack(materials)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    leaves, nodes = _tables(walk, bvh.node_lo, bvh.node_hi, bvh.child,
                            bvh.count, bvh.axis, bvh.first_node, device)
    return TracedScene(
        tri_rows=dev(pack_tri_rows(g.a, g.ba, g.ca)),
        leaves=leaves,
        root_lo=dev(bvh.node_lo[0].astype(np.float32)),
        root_hi=dev(bvh.node_hi[0].astype(np.float32)),
        sh_pack=dev(_sh_pack(g, mat_pack)),
        mat_pack=dev(mat_pack),
        tri_a=dev(g.a),
        tri_ba=dev(g.ba),
        tri_ca=dev(g.ca),
        sh_mat=dev(g.mat_id.astype(np.int32)),
        mat_diffuse=dev(materials.diffuse),
        mat_specular=dev(materials.specular),
        lights=None if lights is None else lights.to(device),
        has_refl=bool(np.any(materials.reflectivity > 0.0)),
        has_transp=bool(np.any(materials.dissolve < 1.0)),
        num_tris=geom.num_tris,
        nodes=nodes,
        depth=bvh.depth,
        tex_atlas=None if textures is None else dev(textures[0]),
        tex_meta=None if textures is None else dev(textures[1]),
        has_diss_tex=bool(np.any(materials.dissolve_tex >= 0)),
    )


def traced_scene_from_numpy(arrays: Mapping[str, np.ndarray],
                            device="cuda", walk: bool = False) -> TracedScene:
    """The port's scene from the JAX ``TracedScene``'s fields as NumPy
    arrays, keyed by their JAX names: node_lo, node_hi, node_child,
    node_count, tri_a, tri_ba, tri_ca, sh_mat, sh_pack, mat_pack,
    mat_diffuse, mat_specular, mat_reflect, mat_dissolve, optionally
    tex_atlas, tex_meta and tex_sat (absent: untextured), and the lights
    as light_pos, light_color, light_radius (absent: no lights); with
    ``walk``, leaves over IVAL_LEAF triangles
    or more than WL_MAX_LP leaves, also node_axis and node_first, for node
    tables in place of the leaf tables. The triangle rows are packed from
    tri_a, tri_ba and tri_ca as given. On ``device``: the card unless the
    caller asks for the CPU."""
    device = resolve_device(device)
    a = {k: np.asarray(v) for k, v in arrays.items() if v is not None}
    dev = lambda x: torch.from_numpy(np.array(x, np.float32)).to(device)
    opt = lambda k, dt: (torch.from_numpy(np.array(a[k], dt)).to(device)
                         if k in a else None)
    lights = None
    if "light_pos" in a:
        lights = Light.make(a["light_pos"], a["light_color"],
                            a["light_radius"], device=device)
    leaves, nodes = _tables(
        walk, a["node_lo"], a["node_hi"], a["node_child"], a["node_count"],
        a.get("node_axis"), a.get("node_first"), device)
    return TracedScene(
        tri_rows=dev(pack_tri_rows(a["tri_a"], a["tri_ba"], a["tri_ca"])),
        leaves=leaves,
        root_lo=dev(a["node_lo"][0]),
        root_hi=dev(a["node_hi"][0]),
        sh_pack=dev(a["sh_pack"]),
        mat_pack=dev(a["mat_pack"]),
        tri_a=dev(a["tri_a"]),
        tri_ba=dev(a["tri_ba"]),
        tri_ca=dev(a["tri_ca"]),
        sh_mat=torch.from_numpy(np.array(a["sh_mat"], np.int32)).to(device),
        mat_diffuse=dev(a["mat_diffuse"]),
        mat_specular=dev(a["mat_specular"]),
        lights=lights,
        has_refl=bool(np.any(a["mat_reflect"] > 0.0)),
        has_transp=bool(np.any(a["mat_dissolve"] < 1.0)),
        num_tris=len(a["tri_a"]) - LEAF_PAD,
        nodes=nodes,
        depth=tree_depth(a["node_child"], a["node_count"]),
        tex_atlas=opt("tex_atlas", np.float32),
        tex_meta=opt("tex_meta", np.int32),
        tex_sat=opt("tex_sat", np.float32),
        has_diss_tex=bool(np.any(a["mat_pack"][:, 9] >= 0)),
    )


def with_sat(scene: TracedScene) -> TracedScene:
    """Attach summed-area tables for RenderOpts(tex_filter="sat")
    (reference SATSampler, sampling/sat_sampler.h:10-57), built on the
    host (``textures.build_sat_atlas``); an untextured scene as it is."""
    from .textures import build_sat_atlas

    if scene.tex_atlas is None:
        return scene
    sat = build_sat_atlas(scene.tex_atlas.cpu().numpy())
    return dataclasses.replace(
        scene, tex_sat=torch.from_numpy(sat).to(scene.device))


def _load_geom_cached(obj_path, cache_dir, flip_normals, gen_normals):
    """OBJ parse with a flattened-geometry npz cache beside the BVH cache
    (the JAX package's ``.geom.npz``, its format and key unchanged, so a
    file written by either package is read by the other). Returns
    (FlatGeometry, the BaseScene or, from the cache, an object with its
    ``mat_names`` and ``mtl_libs``)."""
    import json
    import os
    import zipfile

    from .wavefront import load_wavefront_obj

    st = os.stat(obj_path)
    key = f"{st.st_size}:{int(st.st_mtime)}:{flip_normals}:{gen_normals}:g1"
    path = None
    if cache_dir:
        name = os.path.splitext(os.path.basename(obj_path))[0]
        path = os.path.join(cache_dir, f"{name}.geom.npz")
        if os.path.exists(path):
            try:
                z = np.load(path, allow_pickle=False)
                if str(z["key"]) == key:
                    fields = [f.name for f in dataclasses.fields(FlatGeometry)]
                    geom = FlatGeometry(**{f: z[f] for f in fields})
                    meta = json.loads(str(z["meta"]))
                    return geom, _CachedBaseMeta(meta["mat_names"],
                                                 meta["mtl_libs"])
            except (OSError, KeyError, ValueError, zipfile.BadZipFile):
                pass  # an unreadable or stale cache file is rebuilt
    base = load_wavefront_obj(obj_path)
    if flip_normals:
        base.flip_normals()
    if gen_normals:
        base.gen_normals()
    geom = base.flatten()
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(
            path,
            key=key,
            meta=json.dumps({"mat_names": base.mat_names,
                             "mtl_libs": base.mtl_libs}),
            **{f.name: getattr(geom, f.name)
               for f in dataclasses.fields(FlatGeometry)},
        )
    return geom, base


@dataclasses.dataclass
class _CachedBaseMeta:
    """Stand-in for BaseScene when geometry comes from the npz cache: only
    the loader metadata the rest of load_scene reads."""

    mat_names: dict
    mtl_libs: list


def load_scene(obj_path: str, mtl_path: Optional[str] = None,
               tex_dir: Optional[str] = None,
               cache_dir: Optional[str] = None, flip_normals: bool = True,
               gen_normals: bool = True, lights: Optional[Light] = None,
               leaf_size: int = 32, device="cuda",
               walk: bool = False) -> TracedScene:
    """One-call scene load, the rtracer start-up path (rtracer.cpp:518-587:
    load OBJ -> FlipNormals -> GenNormals -> BVH::Construct ->
    materials/textures -> UpdateMaterialIds), as ``snail_tpu.scene.scene
    .load_scene``: the geometry and the BVH (binned SAH) read from or
    written to ``cache_dir`` (None: no cache; the files are the JAX
    package's), the ``.mtl`` from ``mtl_path`` or the OBJ's first
    ``mtllib`` beside it, its maps from ``tex_dir``, and one default light
    above the scene unless ``lights`` are given. On ``device`` (the card
    unless the caller asks for the CPU); ``walk`` as in
    :func:`make_traced_scene`."""
    import os

    from ..bvh.cache import build_or_load
    from .lights import default_scene_lights
    from .materials import load_material_descs

    device = resolve_device(device)
    geom, base = _load_geom_cached(obj_path, cache_dir, flip_normals,
                                   gen_normals)
    lo, hi = geom.bounds()
    name = os.path.splitext(os.path.basename(obj_path))[0]
    bvh = build_or_load(lo, hi, cache_dir=cache_dir, name=name,
                        leaf_size=leaf_size)

    descs = []
    if mtl_path is None:
        for lib in base.mtl_libs:
            cand = os.path.join(os.path.dirname(obj_path), lib)
            if os.path.exists(cand):
                mtl_path = cand
                break
    if mtl_path and os.path.exists(mtl_path):
        descs = load_material_descs(mtl_path)

    textures, tex_ids = None, {}
    if tex_dir and descs:
        from .textures import load_texture_atlas

        textures, tex_ids = load_texture_atlas(descs, tex_dir)

    mats = MaterialTable.build(base.mat_names, descs, tex_ids)
    if lights is None:
        lights = default_scene_lights(lo.min(axis=0), hi.max(axis=0),
                                      device=device)
    return make_traced_scene(geom, bvh, mats, lights, textures,
                             device=device, walk=walk)
