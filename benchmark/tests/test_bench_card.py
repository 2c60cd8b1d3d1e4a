"""On the card: every cell runs through ``benchmark/run.py`` with a short
window and comes out correct, with the result line's keys."""

import json
import subprocess
import sys

import pytest

from perfkit import spec

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "987654321012", "--seconds", "10", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
