"""Doom 3 ``.proc`` level loader + ``materials.mtr`` material-to-texture map
and the ``.list`` multi-OBJ concatenation — rebuilds of the reference's
``BaseScene::LoadDoom3Proc`` (src/formats/doom3_proc.cpp:10-159) and the
``.list`` loader branch (src/rtracer.cpp:524-545). A NumPy copy of ``snail_tpu.scene.doom3``.

Format notes (mirroring the reference's parser exactly):

- ``materials.mtr``: ``<name> { ... diffusemap [map] <tex> ... }`` blocks;
  ``table`` blocks are skipped; textures get ``.tga`` appended when missing
  (doom3_proc.cpp:12-47).
- ``.proc``: ``model { "<name>" <nSurfaces> { "<mat>" <nVerts> <nInds>
  ( x z y u v nx nz ny ) ... i0 i2 i1 ... } }`` — note the Y/Z swizzle on
  positions + normals and the winding swap on indices
  (doom3_proc.cpp:100-119); surfaces with ``decals/`` or ``sfx/`` materials
  are dropped (doom3_proc.cpp:74-79).
- ``.list``: one OBJ filename per line, objects over 800k tris skipped,
  stop after 4M total (rtracer.cpp:536-544).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np

from .base_scene import BaseScene, SceneObject
from .wavefront import load_wavefront_obj


def load_mat2texture_map(mtr_path: str) -> Dict[str, str]:
    """Parse materials.mtr -> {material name: texture file}
    (doom3_proc.cpp:10-47)."""
    out: Dict[str, str] = {}
    with open(mtr_path, "r", errors="replace") as f:
        toks = f.read().split()
    i = 0
    n = len(toks)
    while i < n:
        mat = toks[i]
        i += 1
        if i >= n:
            break
        if mat == "table":
            i += 1  # the table's name
            depth = 0
            if i < n and toks[i] == "{":
                depth = 1
                i += 1
            while depth and i < n:
                if toks[i] == "}":
                    depth -= 1
                elif toks[i] == "{":
                    depth += 1
                i += 1
            continue
        tex = ""
        if toks[i] != "{":
            continue
        depth = 1
        i += 1
        while depth and i < n:
            t = toks[i]
            if t == "}":
                depth -= 1
            elif t == "{":
                depth += 1
            elif t == "diffusemap":
                i += 1
                tex = toks[i]
                if tex == "map":
                    i += 1
                    tex = toks[i]
            i += 1
        if tex and not tex.endswith(".tga"):
            tex = tex + ".tga"
        out[mat] = tex
    return out


def load_doom3_proc(path: str, mtr_path: Optional[str] = None) -> BaseScene:
    """Load a Doom 3 compiled level (doom3_proc.cpp:133-159)."""
    scene = BaseScene()
    scene.mat_names = {"": 0}
    mat2tex: Dict[str, str] = {}
    if mtr_path is None:
        cand = os.path.join(os.path.dirname(path), "materials.mtr")
        if os.path.exists(cand):
            mtr_path = cand
    if mtr_path and os.path.exists(mtr_path):
        mat2tex = load_mat2texture_map(mtr_path)

    with open(path, "r", errors="replace") as f:
        text = f.read()
    # real .proc files carry /* surface N */ and // comments
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    toks = re.findall(r"[{}()]|[^\s{}()]+", text)
    i = 0
    n = len(toks)

    def read_model(i: int):
        assert toks[i] == "{", toks[i]
        i += 1
        name = toks[i].strip('"')
        n_surfaces = int(toks[i + 1])
        i += 2
        verts, uvs, normals = [], [], []
        tri_v, tri_mat = [], []
        for _ in range(n_surfaces):
            assert toks[i] == "{", toks[i]
            i += 1
            mat_name = toks[i].strip('"')
            n_verts = int(toks[i + 1])
            n_inds = int(toks[i + 2])
            i += 3
            n_tris = n_inds // 3
            if "decals/" in mat_name or "sfx/" in mat_name:
                while toks[i] != "}":
                    i += 1
                i += 1
                continue
            tex = mat2tex.get(mat_name, "")
            if tex in scene.mat_names:
                mat_id = scene.mat_names[tex]
            else:
                mat_id = len(scene.mat_names)
                scene.mat_names[tex] = mat_id
            base = len(verts)
            for _ in range(n_verts):
                assert toks[i] == "(", toks[i]
                x, z, y = float(toks[i + 1]), float(toks[i + 2]), float(toks[i + 3])
                u, v = float(toks[i + 4]), float(toks[i + 5])
                nx, nz, ny = (float(toks[i + 6]), float(toks[i + 7]),
                              float(toks[i + 8]))
                assert toks[i + 9] == ")", toks[i + 9]
                i += 10
                verts.append((x, y, z))
                uvs.append((u, v))
                normals.append((nx, ny, nz))
            for _ in range(n_tris):
                i0, i1, i2 = int(toks[i]), int(toks[i + 1]), int(toks[i + 2])
                i += 3
                # winding swap (doom3_proc.cpp stores indices 0,2,1)
                tri_v.append((base + i0, base + i2, base + i1))
                tri_mat.append(mat_id)
            assert toks[i] == "}", toks[i]
            i += 1
        assert toks[i] == "}", toks[i]
        i += 1
        if tri_v:
            tv = np.asarray(tri_v, np.int32)
            obj = SceneObject(
                verts=np.asarray(verts, np.float32),
                uvs=np.asarray(uvs, np.float32),
                normals=np.asarray(normals, np.float32),
                tri_v=tv,
                tri_vt=tv.copy(),
                tri_vn=tv.copy(),
                tri_mat=np.asarray(tri_mat, np.int32),
                name=name,
            )
            scene.objects.append(obj)
        return i

    depth = 0
    while i < n:
        t = toks[i]
        if t == "model" and depth == 0:
            i = read_model(i + 1)
            continue
        if t == "{":
            depth += 1
        elif t == "}":
            depth -= 1
        i += 1
    return scene


def load_list(path: str, scene_dir: Optional[str] = None,
              max_obj_tris: int = 800_000,
              max_total_tris: int = 4_000_000) -> BaseScene:
    """``.list``: concatenate OBJ files, one per line (rtracer.cpp:524-545)."""
    scene = BaseScene()
    base_dir = scene_dir if scene_dir is not None else os.path.dirname(path)
    total = 0
    with open(path) as f:
        for line in f:
            name = line.strip()
            if not name:
                continue
            sub = load_wavefront_obj(os.path.join(base_dir, name))
            sub.objects = [o for o in sub.objects if o.num_tris < max_obj_tris]
            scene.join(sub)
            total += sum(o.num_tris for o in sub.objects)
            if total > max_total_tris:
                break
    return scene


def load_any(path: str, **kw) -> BaseScene:
    """Extension dispatch (the rtracer loader switch, rtracer.cpp:518-547)."""
    if path.endswith(".proc"):
        return load_doom3_proc(path, **kw)
    if path.endswith(".list"):
        return load_list(path, **kw)
    if path.endswith(".obj"):
        return load_wavefront_obj(path)
    if path.endswith(".v3o"):
        from .desperados2 import load_v3o

        return load_v3o(path, **kw)
    raise ValueError(f"Unrecognized format: {path}")
