"""The port's BVH builder (snail_tpu_torch.bvh) against the JAX package's
(snail_tpu.bvh): the same triangle boxes give the same tree, every node
array equal and the same triangle order, so both packages trace the same
leaves and a triangle id means the same thing in both."""

import dataclasses

import numpy as np
import pytest

from snail_tpu.bvh import build as jbuild
from snail_tpu.scene import procedural as jproc

from snail_tpu_torch.bvh import build as pbuild
from snail_tpu_torch.scene import procedural as pproc

SCENES = {
    "cornell": lambda m: m.cornell_scene(),
    "city_4": lambda m: m.city_scene(4),
    "terrain_64": lambda m: m.terrain_scene(64),
}


def _assert_same_tree(p, j):
    for f in dataclasses.fields(j):
        a, b = getattr(p, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("leaf", [8, 16, 32])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_bvh_matches_jax(name, leaf):
    lo, hi = SCENES[name](pproc).flatten().bounds()
    jlo, jhi = SCENES[name](jproc).flatten().bounds()
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    p = pbuild.build_bvh(lo, hi, leaf_size=leaf)
    _assert_same_tree(p, jbuild.build_bvh(lo, hi, leaf_size=leaf))
    assert p.count.max() <= leaf and p.sah_cost() > 0


@pytest.mark.parametrize("name", ["city_4", "terrain_64"])
def test_build_bvh_fast_matches_jax(name):
    """The level-synchronous builder, which build_bvh takes above 200k
    triangles (the 1 Mtri bench terrain), called directly."""
    lo, hi = SCENES[name](pproc).flatten().bounds()
    p = pbuild.build_bvh_fast(lo, hi, leaf_size=16)
    _assert_same_tree(p, jbuild.build_bvh_fast(lo, hi, leaf_size=16))


def test_build_bvh_sweep_matches_jax():
    lo, hi = SCENES["city_4"](pproc).flatten().bounds()
    p = pbuild.build_bvh(lo, hi, leaf_size=8, method="sweep")
    _assert_same_tree(p, jbuild.build_bvh(lo, hi, leaf_size=8,
                                          method="sweep"))
