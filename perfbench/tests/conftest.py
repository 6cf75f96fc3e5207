"""Shared helpers of the benchmark's CPU tests: each cell of
BENCHMARK.json cut to a tiny terrain and a 64 x 64 frame, run on the CPU
through the plain versions of the program's kernels."""

import copy
import json
from pathlib import Path

import pytest

from perfbench import harness

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def tiny_spec(workload: str, n: int = 16, size: int = 64) -> dict:
    spec = copy.deepcopy(harness.cell_spec(BENCH, workload))
    spec["config"]["generator"]["n"] = n
    spec["config"]["name"] += f"_tiny{n}"
    spec["traffic"].update(width=size, height=size)
    spec["traffic"]["check"]["pixels"] = 1024
    spec["traffic"]["trace_iters"] = 3
    return spec


@pytest.fixture
def cache(tmp_path) -> Path:
    return tmp_path / "scenes"


SEED = 2**31 + 17


def run_tiny(spec, cache, seed=SEED, seconds=0.3, trace=False):
    import time

    return harness.run_cell(spec, seed, seconds, trace, "cpu",
                            time.perf_counter(), cache)
