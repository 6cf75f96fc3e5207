"""The port's host scene pieces against the JAX package's: procedural
scenes, the traced scene's arrays, the leaf tables and the shared-origin
triangle table. Arrays built by the same NumPy code must be identical."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snail_tpu.bvh import build_bvh
from snail_tpu.core.types import Light as JLight
from snail_tpu.ops import traverse_pallas as tp
from snail_tpu.scene import procedural as jproc
from snail_tpu.scene.scene import make_traced_scene as j_make_traced_scene

from snail_tpu_torch.core.types import Camera, Light
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene.bench_scenes import bench_scene
from snail_tpu_torch.scene.materials import MaterialTable
from snail_tpu_torch.scene.scene import (make_traced_scene,
                                         traced_scene_from_numpy)

SCENES = [
    ("box", lambda m: m.box_scene()),
    ("cornell", lambda m: m.cornell_scene()),
    ("city4", lambda m: m.city_scene(4)),
    ("city6_seed3", lambda m: m.city_scene(6, seed=3)),
    ("terrain16", lambda m: m.terrain_scene(16)),
    ("soup300_seed2", lambda m: m.soup_scene(300, seed=2)),
]


@pytest.mark.parametrize("name,make", SCENES, ids=[s[0] for s in SCENES])
def test_procedural_arrays_identical(name, make):
    jg = make(jproc).flatten()
    pg = make(pproc).flatten()
    for f in dataclasses.fields(jg):
        a, b = getattr(jg, f.name), getattr(pg, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.fixture(scope="module")
def city():
    """city_scene(6) at leaf 4: both packages' scenes on one BVH."""
    g = pproc.city_scene(6).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=4)
    jscene = j_make_traced_scene(
        jproc.city_scene(6).flatten(), bvh,
        lights=JLight.make((0.0, 30.0, 0.0), (1.0, 1.0, 1.0), 120.0))
    pscene = make_traced_scene(
        g, bvh, lights=Light.make((0.0, 30.0, 0.0), (1.0, 1.0, 1.0), 120.0,
                                  device="cpu"), device="cpu")
    return jscene, pscene, bvh


PRIMAL = ("tri_a", "tri_ba", "tri_ca", "sh_mat", "mat_diffuse",
          "mat_specular")


def _jax_fields(jscene):
    out = {k: np.asarray(getattr(jscene, k)) for k in (
        "node_lo", "node_hi", "node_child", "node_count", "sh_pack",
        "mat_pack", "mat_reflect", "mat_dissolve") + PRIMAL}
    out["light_pos"] = np.asarray(jscene.lights.pos)
    out["light_color"] = np.asarray(jscene.lights.color)
    out["light_radius"] = np.asarray(jscene.lights.radius)
    return out


def test_traced_scene_arrays_match_jax(city):
    jscene, pscene, _ = city
    np.testing.assert_array_equal(pscene.sh_pack.numpy(),
                                  np.asarray(jscene.sh_pack))
    np.testing.assert_array_equal(pscene.mat_pack.numpy(),
                                  np.asarray(jscene.mat_pack))
    rows = pscene.tri_rows.numpy()
    np.testing.assert_array_equal(rows[:, 0:3], np.asarray(jscene.tri_a))
    np.testing.assert_array_equal(rows[:, 3:6], np.asarray(jscene.tri_ba))
    np.testing.assert_array_equal(rows[:, 6:9], np.asarray(jscene.tri_ca))
    # the JAX package's kernel rows carry the same unnormalized normal
    np.testing.assert_array_equal(rows[:, 9:12],
                                  np.asarray(jscene.pk_tris)[:, 9:12])
    assert not rows[:, 12:].any()
    np.testing.assert_array_equal(pscene.root_lo.numpy(),
                                  np.asarray(jscene.node_lo[0]))
    np.testing.assert_array_equal(pscene.root_hi.numpy(),
                                  np.asarray(jscene.node_hi[0]))
    assert (pscene.has_refl, pscene.has_transp) == (jscene.has_refl,
                                                    jscene.has_transp)
    assert pscene.num_tris == jscene.num_tris
    for name in PRIMAL:
        a, b = getattr(pscene, name).numpy(), np.asarray(getattr(jscene, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_leaf_tables_match_jax(city):
    jscene, pscene, _ = city
    lt = pscene.leaves
    n = jscene.wl_nl
    assert lt.n_leaf == n and lt.lp == jscene.lf_boxv.shape[1] * 1024
    # JAX planar boxes: leaf t at [:, t >> 10, (t >> 7) & 7, t & 127]
    jbox = np.asarray(jscene.lf_boxv).reshape(6, -1)
    np.testing.assert_array_equal(lt.box.numpy()[:, :n], jbox[:, :n])
    lfc = np.asarray(jscene.wl_lfc)[:n]
    np.testing.assert_array_equal(lt.first.numpy()[:n], lfc >> 7)
    np.testing.assert_array_equal(lt.count.numpy()[:n], lfc & 0x7F)
    assert not lt.count.numpy()[n:].any()


def test_traced_scene_from_numpy_round_trips(city):
    jscene, pscene, _ = city
    rt = traced_scene_from_numpy(_jax_fields(jscene), device="cpu")
    for name in ("tri_rows", "sh_pack", "mat_pack", "root_lo",
                 "root_hi") + PRIMAL:
        a, b = getattr(rt, name), getattr(pscene, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for name in ("box", "first", "count"):
        assert torch.equal(getattr(rt.leaves, name),
                           getattr(pscene.leaves, name)), name
    assert rt.leaves.n_leaf == pscene.leaves.n_leaf
    for name in ("pos", "color", "radius"):
        assert torch.equal(getattr(rt.lights, name),
                           getattr(pscene.lights, name)), name
    assert (rt.has_refl, rt.has_transp, rt.tex_atlas, rt.num_tris) == (
        pscene.has_refl, pscene.has_transp, None, pscene.num_tris)
    # the parameters carry across as given: an edited vertex table arrives
    # with its rows packed from it
    fields = _jax_fields(jscene)
    fields["tri_a"] = fields["tri_a"] + np.float32(0.25)
    moved = traced_scene_from_numpy(fields, device="cpu")
    np.testing.assert_array_equal(moved.tri_a.numpy(), fields["tri_a"])
    np.testing.assert_array_equal(moved.tri_rows.numpy()[:, 0:3],
                                  fields["tri_a"])


def test_traced_scene_from_numpy_carries_textures(city):
    """The JAX scene's atlas, meta and SATs arrive as they are given."""
    from snail_tpu.scene.scene import with_sat as j_with_sat
    from snail_tpu.scene.textures import checker_atlas as j_checker_atlas

    jscene, _, _ = city
    jt = j_with_sat(j_checker_atlas(jscene))
    fields = _jax_fields(jt)
    fields.update({k: np.asarray(getattr(jt, k))
                   for k in ("tex_atlas", "tex_meta", "tex_sat")})
    rt = traced_scene_from_numpy(fields, device="cpu")
    for k in ("tex_atlas", "tex_meta", "tex_sat", "sh_pack", "mat_pack"):
        a, b = getattr(rt, k).numpy(), fields[k]
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert not rt.has_diss_tex


def test_scene_to_device_keeps_every_tensor(city):
    _, pscene, _ = city
    moved = pscene.to("cpu")
    assert moved.device == torch.device("cpu")
    assert torch.equal(moved.leaves.box, pscene.leaves.box)
    assert torch.equal(moved.lights.pos, pscene.lights.pos)
    assert moved.leaves.n_leaf == pscene.leaves.n_leaf
    # every tensor field goes: "meta" tensors have a device and no data
    from snail_tpu_torch.scene.scene import with_sat
    from snail_tpu_torch.scene.textures import checker_atlas

    textured = with_sat(checker_atlas(pscene))
    meta = textured.to("meta")
    for f in dataclasses.fields(meta):
        t = getattr(meta, f.name)
        if isinstance(t, torch.Tensor):
            assert t.device.type == "meta", f.name
            assert t.shape == getattr(textured, f.name).shape, f.name
    assert meta.tex_sat.device.type == "meta"
    assert pscene.to("meta").tex_atlas is None
    assert meta.leaves.box.device.type == "meta"
    assert meta.lights.pos.device.type == "meta"


def test_pack_leaf_tables_rejects_big_leaves():
    g = pproc.city_scene(4).flatten()
    lo, hi = g.bounds()
    bvh = build_bvh(lo, hi, leaf_size=64)
    assert bvh.count.max() > pt.IVAL_LEAF
    with pytest.raises(ValueError, match="IVAL_LEAF"):
        pt.pack_leaf_tables(bvh.node_lo, bvh.node_hi, bvh.child, bvh.count)


def test_material_table_default_matches_jax():
    from snail_tpu.scene.materials import MaterialTable as JTable

    names = {"": 0, "a": 1, "b": 2}
    j, p = JTable.build(names, []), MaterialTable.build(names)
    for f in dataclasses.fields(j):
        np.testing.assert_array_equal(np.asarray(getattr(j, f.name)),
                                      np.asarray(getattr(p, f.name)))


def _objects(m):
    """Two meshes of ``m``'s SceneObject: a box-like soup with a
    degenerate triangle, missing normals and uvs, and one with neither."""
    rng = np.random.default_rng(4)
    verts = rng.normal(size=(8, 3)).astype(np.float32)
    tri_v = np.array([[0, 1, 2], [2, 1, 3], [4, 5, 6], [0, 0, 1],
                      [5, 6, 7]], np.int32)
    a = m.SceneObject(
        verts=verts, uvs=rng.random((4, 2)).astype(np.float32),
        normals=rng.normal(size=(3, 3)).astype(np.float32), tri_v=tri_v,
        tri_vt=np.array([[0, 1, 2], [2, 1, 3], [-1, -1, -1], [0, 0, 1],
                         [1, 2, 3]], np.int32),
        tri_vn=np.array([[0, 1, 2], [-1, 1, 2], [-1, -1, -1], [0, 0, 0],
                         [2, 2, 2]], np.int32),
        tri_mat=np.array([0, 1, 1, 0, 2], np.int32), name="a")
    b = m.SceneObject(
        verts=verts[:4] + 3, uvs=np.zeros((0, 2), np.float32),
        normals=np.zeros((0, 3), np.float32), tri_v=tri_v[:2].copy(),
        tri_vt=np.full((2, 3), -1, np.int32),
        tri_vn=np.full((2, 3), -1, np.int32),
        tri_mat=np.array([1, 0], np.int32), name="b")
    return a, b


def _scene_of(m, names):
    s = m.BaseScene()
    s.objects.extend(_objects(m))
    s.mat_names = dict(names)
    return s


def _assert_same_scene(j, p):
    assert j.mat_names == p.mat_names and j.mtl_libs == p.mtl_libs
    assert j.num_tris == p.num_tris and len(j.objects) == len(p.objects)
    for oj, op in zip(j.objects, p.objects):
        for f in dataclasses.fields(oj):
            a, b = getattr(oj, f.name), getattr(op, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name


@pytest.mark.parametrize("step", ["repair", "flip_normals", "swap_yz",
                                  "gen_normals", "join", "all"])
def test_base_scene_methods_match_jax(step):
    """SceneObject.repair, flip_normals and swap_yz, and BaseScene's
    flip_normals, swap_yz, gen_normals, bbox and join, on both packages'
    copies of the same meshes: every array equal."""
    from snail_tpu.scene import base_scene as jbs

    from snail_tpu_torch.scene import base_scene as pbs

    names = {"": 0, "red": 1, "blue": 2}
    j, p = _scene_of(jbs, names), _scene_of(pbs, names)
    steps = (["repair", "flip_normals", "swap_yz", "gen_normals", "join"]
             if step == "all" else [step])
    for s in steps:
        for scene in (j, p):
            if s == "repair":
                for o in scene.objects:
                    o.repair()
            elif s == "join":
                other = _scene_of(jbs if scene is j else pbs,
                                  {"": 0, "blue": 1, "green": 2})
                scene.join(other)
            else:
                getattr(scene, s)()
    _assert_same_scene(j, p)
    for a, b in zip(j.bbox(), p.bbox()):
        np.testing.assert_array_equal(a, b)
    if step == "join":
        assert list(p.mat_names) == ["", "red", "blue", "green"]
        assert p.objects[2].tri_mat.tolist() == [0, 2, 2, 0, 3]
    jg, pg = j.flatten(), p.flatten()
    for f in dataclasses.fields(jg):
        np.testing.assert_array_equal(getattr(jg, f.name),
                                      getattr(pg, f.name), err_msg=f.name)


def test_shared_rows_match_jax(city):
    jscene, pscene, _ = city
    origin = np.array([3.5, 7.25, -11.0], np.float32)
    jr = np.asarray(tp.shared_rows(jscene.pk_tris, jnp.asarray(origin)))
    pr = pt.shared_rows(pscene.tri_rows, torch.from_numpy(origin)).numpy()
    np.testing.assert_allclose(pr[:, :10], jr[:, :10], rtol=1e-6, atol=1e-5)
    assert not pr[:, 10:].any()


def test_kernel_ray_index_matches_jax():
    for w, h in ((64, 64), (128, 64), (192, 128)):
        np.testing.assert_array_equal(pt.kernel_ray_index(w, h),
                                      tp.kernel_ray_index(w, h))


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    """Scenes, cameras and lights are built on the card unless the caller
    asks for the CPU: with no card and no device argument they raise
    rather than run the plain versions unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = pproc.box_scene().flatten()
    bvh = build_bvh(*g.bounds(), leaf_size=8)
    for build in (lambda: Camera.look_at(pos=(0.0, 0.0, 5.0),
                                         target=(0.0, 0.0, 0.0)),
                  lambda: Light.make((0.0, 3.0, 0.0), (1.0, 1.0, 1.0), 9.0),
                  lambda: make_traced_scene(g, bvh),
                  lambda: bench_scene("city", 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert make_traced_scene(g, bvh, device="cpu").device.type == "cpu"
