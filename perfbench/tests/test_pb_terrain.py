"""The benchmark's frozen terrain generator gives the program's terrain."""

import numpy as np
import pytest

from perfbench.generators.terrain import terrain
from snail_tpu_torch.scene.procedural import terrain_scene


@pytest.mark.parametrize("n", [8, 16, 33, 100])
def test_frozen_terrain_equals_program_terrain(n):
    verts, tri_v = terrain(n)
    obj = terrain_scene(n).objects[0]
    assert np.array_equal(verts.numpy(), obj.verts)
    assert np.array_equal(tri_v.numpy(), obj.tri_v)
