"""run.py refuses to run without the CUDA devices a cell asks for, and
never falls back to the CPU; nor does it run without the program."""

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

RUN = [sys.executable, "benchmark/run.py", "--workload", "oven_256.long", "--seed", "3000000001",
       "--seconds", "1", "--trace", "0"]


def _result_lines(out: str) -> list:
    found = []
    for line in out.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "correct" in obj:
            found.append(obj)
    return found


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(RUN, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 3, r.stderr
    assert "does not run on the CPU" in r.stderr
    assert not _result_lines(r.stdout)


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "_state"))
    r = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not _result_lines(r.stdout)


def test_bad_arguments_exit_2():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "oven_256.long"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and not _result_lines(r.stdout)
