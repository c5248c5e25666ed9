"""On a card: every cell runs end to end for a short window and comes out
correct, with a result line in the contract's shape. Skips without a
card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from perfbench.harness import bench as hb


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      hb.benchmark()["workloads"]])
def test_cell_runs_correct(card, workload):
    p = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", workload,
         "--seed", str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"],
        cwd=hb.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
