"""No module that the harness or the reference loads has the top-level
name jax, jaxlib, flax or fdtd_tpu (compared whole: fdtd_tpu_torch begins
with fdtd_tpu), and the reference loads no module of the program."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set:
    code = PROBE.format(bench=BENCH, root=ROOT, body=body)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    mods = _top_level("import reference.plain, core.compare, core.seeded, core.opcount, core.trace, core.kernels")
    assert not mods & {"jax", "jaxlib", "flax", "fdtd_tpu", "fdtd_tpu_torch"}


@pytest.mark.parametrize("workload", ["oven_water_256.probes", "oven_256.dft4", "debye_256.sar"])
def test_a_whole_run_loads_no_jax(workload):
    body = f"""
from core.run_cell import run_cell
over = {{"output_every": 10, "warm_steps": 20}}
if {workload!r}.endswith(".probes"):
    over["probes"] = [[4, 8, 8], [8, 8, 8], [12, 4, 4]]
r = run_cell({workload!r}, 11, 0.2, True, device="cpu", config_over={{"box_m": [0.016] * 3, "cells": [16] * 3}},
             traffic_over=over, state_dir=None, say=lambda m: None)
assert r["correct"], r["checks"]
import run
assert run.forbidden_modules() == []
"""
    mods = _top_level(body)
    assert "fdtd_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "fdtd_tpu"}


def test_forbidden_names_compare_whole_top_level_names():
    sys.path.insert(0, BENCH)
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["fdtd_tpu_torch_fake"] = sys
        sys.modules["jaxtyping_fake"] = sys
        assert "fdtd_tpu" not in run.forbidden_modules()
        sys.modules["fdtd_tpu.params"] = sys
        assert "fdtd_tpu" in run.forbidden_modules()
    finally:
        for k in list(sys.modules):
            if k not in saved:
                del sys.modules[k]
