"""The benchmark on the card: each cell runs and is correct, and the control
(the program's MSM on scalars cut to 240 bits) is not. Skips without a card;
on the card: ``python3 -m pytest benchmark/tests -q -m chip``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from bench_support import ROOT

CELLS = ["prover-b8", "kzg-commit-k20", "prover-b16"]


def _run(args, timeout=900):
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                         cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(cuda_device, workload, trace):
    line = _run(["benchmark.run", "--workload", workload, "--seed", str(2**31 + 3),
                 "--seconds", "3", "--trace", str(trace)])[-1]
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "compared"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_on_the_card(cuda_device, workload):
    lines = _run(["benchmark.control", "--workload", workload, "--control", str(2**31 + 5),
                  "--seconds", "2"])
    assert lines and not lines[-1]["correct"]
    assert lines[-1]["compared"]["mismatched"]["value"] > 0
