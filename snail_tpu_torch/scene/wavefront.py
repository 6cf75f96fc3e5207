"""Wavefront OBJ loader (reference src/formats/wavefront_obj.cpp:66-205), a
NumPy copy of ``snail_tpu.scene.wavefront``.

Behavioral parity with the reference parser:
- `usemtl` registers material names in first-seen order, with the unnamed
  default material at id 0 (wavefront_obj.cpp:82-83, 172-180).
- Faces with 4 vertices are split into two triangles with the reference's
  peculiar fan: (0,1,2) then (2,1,3) after its pointer-swap trick
  (wavefront_obj.cpp:160-165: p1<-p3, swap(p0,p2) => second tri uses
  old p2, old p1, old p3). N-gons beyond 4 are fan-triangulated.
- Negative indices are relative to the current pool size
  (wavefront_obj.cpp:125-141).
- Missing uv/normal indices become -1 ("not used", base_scene.h:45).
- Degenerate faces are dropped afterwards via Repair()
  (wavefront_obj.cpp:185-186).

The whole file becomes a single SceneObject, matching the reference (the `o`
keyword is ignored, wavefront_obj.cpp:94-100).
"""

from __future__ import annotations

import numpy as np

from .base_scene import BaseScene, SceneObject


def load_wavefront_obj(path: str, repair: bool = True) -> BaseScene:
    scene = BaseScene()
    verts: list = []
    uvs: list = []
    normals: list = []
    tri_v: list = []
    tri_vt: list = []
    tri_vn: list = []
    tri_mat: list = []
    last_mat = 0

    def parse_corner(tok: str):
        # "v", "v/vt", "v//vn", "v/vt/vn"; negative = relative
        parts = tok.split("/")
        v = int(parts[0])
        v = v - 1 if v > 0 else len(verts) + v
        vt = vn = -1
        if len(parts) > 1 and parts[1]:
            vt = int(parts[1])
            vt = vt - 1 if vt > 0 else len(uvs) + vt
        if len(parts) > 2 and parts[2]:
            vn = int(parts[2])
            vn = vn - 1 if vn > 0 else len(normals) + vn
        if vn >= len(normals):
            vn = -1  # tolerate bad normal indices like the reference
        return v, vt, vn

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            kind = tok[0]
            if kind == "v":
                verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif kind == "vt":
                uvs.append([float(tok[1]), float(tok[2]) if len(tok) > 2 else 0.0])
            elif kind == "vn":
                normals.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif kind == "f":
                corners = [parse_corner(t) for t in tok[1:]]
                if len(corners) < 3:
                    continue
                # reference quad order: (0,1,2) + (2,1,3); general fan after.
                order = [(0, 1, 2)]
                if len(corners) == 4:
                    order.append((2, 1, 3))
                else:
                    for i in range(3, len(corners)):
                        order.append((0, i - 1, i))
                for (i, j, k) in order:
                    tri_v.append([corners[i][0], corners[j][0], corners[k][0]])
                    tri_vt.append([corners[i][1], corners[j][1], corners[k][1]])
                    tri_vn.append([corners[i][2], corners[j][2], corners[k][2]])
                    tri_mat.append(last_mat)
            elif kind == "usemtl":
                name = tok[1] if len(tok) > 1 else ""
                if name not in scene.mat_names:
                    scene.mat_names[name] = len(scene.mat_names)
                last_mat = scene.mat_names[name]
            elif kind == "mtllib":
                scene.mtl_libs.append(tok[1])

    obj = SceneObject(
        verts=np.asarray(verts, np.float32).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        tri_v=np.asarray(tri_v, np.int32).reshape(-1, 3),
        tri_vt=np.asarray(tri_vt, np.int32).reshape(-1, 3),
        tri_vn=np.asarray(tri_vn, np.int32).reshape(-1, 3),
        tri_mat=np.asarray(tri_mat, np.int32).reshape(-1),
    )
    if repair:
        obj.repair()
    scene.objects.append(obj)
    return scene
