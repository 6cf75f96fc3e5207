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

from snail_tpu_torch.core.types import Light
from snail_tpu_torch.ops import traverse as pt
from snail_tpu_torch.scene import procedural as pproc
from snail_tpu_torch.scene.materials import MaterialTable
from snail_tpu_torch.scene.scene import (make_traced_scene,
                                         traced_scene_from_numpy)

SCENES = [
    ("box", lambda m: m.box_scene()),
    ("cornell", lambda m: m.cornell_scene()),
    ("city4", lambda m: m.city_scene(4)),
    ("city6_seed3", lambda m: m.city_scene(6, seed=3)),
    ("terrain16", lambda m: m.terrain_scene(16)),
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
        g, bvh, lights=Light.make((0.0, 30.0, 0.0), (1.0, 1.0, 1.0), 120.0))
    return jscene, pscene, bvh


def _jax_fields(jscene):
    out = {k: np.asarray(getattr(jscene, k)) for k in (
        "node_lo", "node_hi", "node_child", "node_count", "tri_a", "tri_ba",
        "tri_ca", "sh_pack", "mat_pack", "mat_reflect", "mat_dissolve")}
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
    rt = traced_scene_from_numpy(_jax_fields(jscene))
    for name in ("tri_rows", "sh_pack", "mat_pack", "root_lo", "root_hi"):
        assert torch.equal(getattr(rt, name), getattr(pscene, name)), name
    for name in ("box", "first", "count"):
        assert torch.equal(getattr(rt.leaves, name),
                           getattr(pscene.leaves, name)), name
    assert rt.leaves.n_leaf == pscene.leaves.n_leaf
    for name in ("pos", "color", "radius"):
        assert torch.equal(getattr(rt.lights, name),
                           getattr(pscene.lights, name)), name
    assert (rt.has_refl, rt.has_transp, rt.textured, rt.num_tris) == (
        pscene.has_refl, pscene.has_transp, False, pscene.num_tris)


def test_scene_to_device_keeps_every_tensor(city):
    _, pscene, _ = city
    moved = pscene.to("cpu")
    assert moved.device == torch.device("cpu")
    assert torch.equal(moved.leaves.box, pscene.leaves.box)
    assert torch.equal(moved.lights.pos, pscene.lights.pos)
    assert moved.leaves.n_leaf == pscene.leaves.n_leaf


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
