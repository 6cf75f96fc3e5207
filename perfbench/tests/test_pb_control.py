"""The control, the reference computed in bfloat16 in the program's
place, fails each cell's limits (on a tiny terrain, on the CPU)."""

import pytest

from perfbench import readings

from .conftest import WORKLOADS, tiny_spec


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits(workload, cache):
    spec = tiny_spec(workload)
    rows = list(readings.read(spec, [5], [2**31 + 3, 7], 0.2, "cpu", cache))
    prog = rows[0]
    assert all(prog[k] <= v for k, v in spec["limits"].items()), prog
    for ctrl in rows[1:]:
        assert ctrl["side"] == "control"
        assert any(ctrl[k] > v for k, v in spec["limits"].items()), ctrl
