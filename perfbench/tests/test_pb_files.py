"""Every configuration, traffic mix, limit file and metric reader that
BENCHMARK.json names loads through the harness by name."""

import re

import pytest

from perfbench import harness

from .conftest import BENCH, WORKLOADS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_load(workload):
    spec = harness.cell_spec(BENCH, workload)
    assert spec["traffic"]["kind"] in ("frame", "step")
    assert spec["config"]["name"] == spec["workload"]["config"]
    assert set(spec["limits"]) <= {"px_off", "mean_diff", "loss_gap",
                                   "grad_gap"}
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s",
                                                       "peak_mib"}
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_load(metric):
    assert callable(harness.load_reader(metric))


def test_names_and_configs():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.REPO / c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        n = cfg["generator"]["n"]
        assert cfg["triangles"] == 2 * n * n


def test_unknown_generator_is_refused():
    with pytest.raises(KeyError, match="generators/city.py"):
        harness.load_generator("city")
