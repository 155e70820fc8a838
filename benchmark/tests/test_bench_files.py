"""BENCHMARK.json, the configuration, traffic, limit and reader files: each
parses, each is found by the name BENCHMARK.json gives, and the file keeps
to the limits of the file's format (names, units, keys, bounds)."""

import json
import re

import numpy as np
import pytest

from core import opcount
from core.cell import BENCH_DIR, ROOT, Cell, load_benchmark, load_maps, simulation_time
from core.run_cell import load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files_parse(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["source"].startswith("https://")
    assert 1 <= len(entry["source"]) <= 200 and 1 <= len(entry["why"]) <= 200
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == entry["name"] and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    assert {"assumed", "box_m", "spatial_step_m", "time_step_s", "dtype", "source_hz"} <= set(data)


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workloads_find_their_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200
    cell = Cell(entry["name"])
    cell.check_grid()
    assert cell.grid == (256, 256, 256)
    assert cell.traffic["name"] == entry["traffic"]
    assert cell.output_every > 0 and cell.traffic["warm_steps"] % cell.output_every == 0
    limits = cell.limits()
    assert limits["window_bad"] == 0 and all(v >= 0 for v in limits.values())
    for k, j, i in cell.probes:
        assert 0 <= k < 256 and 0 <= j < 256 and 0 <= i < 256


def test_every_metric_is_named_and_read():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"mcells_per_s", "device_peak_gib", "setup_s"} <= e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    names = set()
    for m in BENCH["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        names.add(m["name"])
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells and "\n" not in m["layer"]
        assert callable(load_reader(m["name"]))
        names.add(m["name"])
    assert len(names) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    with pytest.raises(FileNotFoundError):
        load_reader("no_such_metric")


def test_every_cell_reports_the_metrics_it_must():
    for w in BENCH["workloads"]:
        cell = Cell(w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer
        # each per-layer metric of the cell moves an end-to-end metric that the cell reports
        e2e = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in e2e for m in cell.per_layer), w["name"]


def test_a_split_metric_is_read_by_its_quantity_s_reader():
    trace = {"window": [0.0, 10.0], "steps": 2, "device_ops": [], "ranges": {},
             "cpu_ops": [["fdtd.coefs", 1.0, 4.0]]}
    ctx = {"ops_per_step": 0.0, "peak_flops": 67e12, "cells": 1, "steps": 2}
    assert load_reader("coefs_s.probes")(trace, ctx) == load_reader("coefs_s")(trace, ctx) == pytest.approx(3e-6)
    with pytest.raises(FileNotFoundError):
        load_reader("no_such_metric.probes")


def test_load_maps_place_the_water_block():
    eps, sigma = load_maps(Cell("oven_water_256.sar"))
    assert eps.shape == (256, 256, 256)
    inside = (slice(76, 179),) * 3
    assert (eps[inside] == 78.0).all() and (sigma[inside] == 1.7).all()
    assert eps.sum() == 256 ** 3 - 103 ** 3 + 78.0 * 103 ** 3
    assert load_maps(Cell("oven_256.long")) is None


def test_load_maps_state_the_debye_block():
    eps_inf, sigma, d_eps, tau = load_maps(Cell("debye_256.sar"))
    inside = (slice(76, 179),) * 3
    assert (eps_inf[inside] == 5.2).all() and (sigma[inside] == 0.27).all()
    assert (d_eps[inside] == 74.90304).all() and (tau[inside] == 9.36e-12).all()
    out = np.ones(eps_inf.shape, bool)
    out[inside] = False
    assert (eps_inf[out] == 1.0).all() and not sigma[out].any() and not d_eps[out].any() and not tau[out].any()


# the counts and maps of the cells that came before the Debye load, pinned as they were
@pytest.mark.parametrize("workload,ops,sums", [
    ("oven_256.long", 502840596.474, None),
    ("oven_water_256.sar", 888324116.474, (100917195.0, 1857635.8999999904)),
    ("oven_256.dft4", 1509473556.474, None),
    ("oven_water_256.probes", 888324170.474, (100917195.0, 1857635.8999999904)),
])
def test_earlier_cells_keep_their_counts_and_maps(workload, ops, sums):
    cell = Cell(workload)
    assert opcount.for_cell(cell) == ops
    maps = load_maps(cell)
    assert (maps is None) == (sums is None)
    if maps is not None:
        assert len(maps) == 2 and tuple(float(m.sum()) for m in maps) == sums


def test_the_bf16_oven_is_the_water_oven_but_for_storage():
    bf16, fp32 = Cell("oven_water_256_bf16.sar"), Cell("oven_water_256.sar")
    assert (bf16.dtype, fp32.dtype) == ("bfloat16", "float32")
    own = {"name", "source", "deployment", "dtype", "assumed"}
    assert {k: v for k, v in bf16.config.items() if k not in own} == {k: v for k, v in fp32.config.items() if k not in own}
    assert bf16.traffic == fp32.traffic and bf16.chips == 1
    assert bf16.limits() == json.loads((BENCH_DIR / "limits" / "oven_water_256_bf16.sar.json").read_text())
    assert all(np.array_equal(a, b) for a, b in zip(load_maps(bf16), load_maps(fp32)))
    # the same readers: on stream the SAR increment lies inside the sweep, so no sar_ms_per_step
    assert [m["name"] for m in bf16.per_layer] == [m["name"] for m in fp32.per_layer]
    assert "sar_ms_per_step" not in {m["name"] for m in bf16.per_layer}
    assert [m["name"] for m in bf16.end_to_end] == [m["name"] for m in fp32.end_to_end]


@pytest.mark.parametrize("steps", [1, 7, 1000, 26000])
def test_simulation_time_gives_the_steps(steps):
    dt = 1e-12
    limit = simulation_time(dt, steps)
    t, n = 0.0, 0
    while t <= limit:
        n += 1
        t += dt
    assert n == steps


def test_file_names_use_name_characters():
    for path in BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or "_state" in path.parts or path.is_dir():
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path
