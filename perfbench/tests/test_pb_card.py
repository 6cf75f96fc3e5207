"""On the card: each cell runs briefly through the command and comes out
correct, with the result line the contract asks for. Skips without a
card; run on the chip with ``python3 -m pytest perfbench/tests -m cuda``."""

import json
import subprocess
import sys

import pytest

from perfbench import harness

from .conftest import WORKLOADS


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checked"]
    assert res["device"]["platform"] == "gpu"
