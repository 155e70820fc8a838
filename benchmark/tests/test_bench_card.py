"""Runs that need the card: a short run of every cell through run.py, as
the benchmark command starts it, and the window's size kept for a checkout's runs.
The card tests skip inside the test where there is no CUDA card."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, WORKLOADS
from core.cell import Cell
from core.run_cell import window_steps


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card_is_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "2147483700",
                        "--seconds", "4", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


def test_window_steps_whole_chunks_and_kept(tmp_path):
    cell = Cell("oven_256.long")
    # 2000 warm-up steps in 1.4 s, 0.4 s of them outside the loop: 0.5 ms a step
    assert window_steps(cell, 20.0, 1.4, 1.0, 2000) == 39000
    assert window_steps(cell, 0.1, 1.4, 1.0, 2000) == 1000  # at least one chunk
    saved = tmp_path / "w.json"
    first = window_steps(cell, 20.0, 1.4, 1.0, 2000, saved)
    assert window_steps(cell, 20.0, 0.7, 0.5, 2000, saved) == first  # a later, faster run keeps the size
    assert window_steps(cell, 10.0, 0.7, 0.5, 2000, saved) == 39000  # another length sizes anew
