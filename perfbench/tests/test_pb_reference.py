"""The plain reference agrees with the program's CPU path, run through
the whole harness on a tiny terrain (every cell, traced and not)."""

import pytest

from .conftest import WORKLOADS, run_tiny, tiny_spec


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_cell_is_correct(workload, trace, cache):
    res = run_tiny(tiny_spec(workload), cache, trace=trace)
    assert res["correct"], res["checked"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checked"
    for name, v in res["checked"].items():
        # the CPU path and the reference compute the same floats here
        assert v["value"] <= 1e-5, (name, v)
    if trace:
        assert "breakdown" in res and "window_s" in res["device"]
    else:
        assert "setup_s" in res["metrics"]


def test_tiny_cell_on_node_tables_is_correct(cache):
    """A configuration with ``"tables": "nodes"`` runs the program's walk
    kernels (node tables) and stays correct."""
    spec = tiny_spec("terrain_10m.view")
    spec["config"]["tables"] = "nodes"
    spec["config"]["name"] += "_nodes"
    res = run_tiny(spec, cache)
    assert res["correct"], res["checked"]
