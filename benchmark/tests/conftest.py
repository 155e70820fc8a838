"""The benchmark's own CPU tests (``python -m pytest benchmark/tests``).

They import the harness as ``core`` and ``reference`` (benchmark/ on the
path, as run.py has it) and the program from the repository root.  A
test that needs a CUDA card is marked ``card`` and skips inside the test
where there is none.
"""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

import pytest  # noqa: E402

from core.cell import Cell, load_benchmark  # noqa: E402

# a 16^3 cavity (the 5 mm source patch fits), output every 10 steps, 20 warm-up steps
TINY_CONFIG = {"box_m": [0.016, 0.016, 0.016], "cells": [16, 16, 16]}
TINY_TRAFFIC = {"output_every": 10, "warm_steps": 20}
TINY_PROBES = [[4, 8, 8], [8, 8, 8], [12, 4, 4]]
# every cell of BENCHMARK.json, and those whose configuration states each field storage
WORKLOADS = tuple(w["name"] for w in load_benchmark()["workloads"])
FP32_WORKLOADS = tuple(w for w in WORKLOADS if Cell(w).dtype == "float32")
BF16_WORKLOADS = tuple(w for w in WORKLOADS if Cell(w).dtype == "bfloat16")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips inside the test without one)")


def tiny_traffic(workload: str) -> dict:
    over = dict(TINY_TRAFFIC)
    if workload.endswith(".probes"):
        over["probes"] = TINY_PROBES
    return over


@pytest.fixture
def run_tiny():
    """run_cell on the CPU at 16^3: (workload, seed, **kw) -> result
    (``traffic_over`` replaces keys of the tiny traffic; ``program_dtype``
    and ``say`` go to run_cell)."""
    from core.run_cell import run_cell

    def run(workload: str, seed: int = 20260101, trace: bool = False, config_over=None, seconds: float = 0.3,
            traffic_over=None, program_dtype=None, say=lambda m: None):
        cfg = dict(TINY_CONFIG, **(config_over or {}))
        traffic = dict(tiny_traffic(workload), **(traffic_over or {}))
        return run_cell(workload, seed, seconds, trace, device="cpu", config_over=cfg, traffic_over=traffic,
                        state_dir=None, say=say, program_dtype=program_dtype)

    return run
