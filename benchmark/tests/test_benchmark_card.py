"""On the card: every cell runs through the command for a few seconds,
untraced and traced, and comes out correct with its metrics."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "3", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    want = {m["name"] for m in harness.metric_specs(cell, BENCH,
                                                     bool(trace))}
    assert set(res["metrics"]) <= want and res["metrics"]
    assert r.stderr.strip().splitlines()[-1].startswith("check ")
