"""The readers of the program's own spans (coefs_s, resume_s, finalize_s,
loop_idle_pct, enqueue_ms_per_step) on canned summaries with known
answers, and on one traced CPU run of a tiny cell."""

import pytest

from core.run_cell import load_reader

SPAN_METRICS = ("coefs_s", "resume_s", "finalize_s", "loop_idle_pct", "enqueue_ms_per_step")


def canned(steps=4):
    # window 0..1000 us: fdtd.run 10..990 holds fdtd.coefs 20..120, fdtd.resume
    # 130..180, fdtd.loop 200..800 with two chunks 210..260 and 500..530, and
    # fdtd.finalize 800..950; device work 300..500 and 600..700 inside the loop,
    # 850..900 outside it; a coefs span after the window does not count
    return {
        "window": [0.0, 1000.0], "steps": steps,
        "device_ops": [["k", 300.0, 200.0, "kernel"], ["k", 600.0, 100.0, "kernel"],
                       ["Memcpy DtoH (Device -> Pageable)", 850.0, 50.0, "memcpy"]],
        "ranges": {},
        "cpu_ops": [["fdtd.run", 10.0, 990.0], ["fdtd.coefs", 20.0, 120.0], ["fdtd.resume", 130.0, 180.0],
                    ["fdtd.loop", 200.0, 800.0], ["fdtd.chunk", 210.0, 260.0], ["aten::add", 220.0, 230.0],
                    ["fdtd.chunk", 500.0, 530.0], ["fdtd.finalize", 800.0, 950.0], ["fdtd.coefs", 1100.0, 1500.0]],
    }


def read(name, trace):
    return load_reader(name)(trace, {"ops_per_step": 0.0, "peak_flops": 67e12, "cells": 1, "steps": trace["steps"]})


@pytest.mark.parametrize("name, want", [
    ("coefs_s", 100e-6), ("resume_s", 50e-6), ("finalize_s", 150e-6),
    ("loop_idle_pct", 50.0),  # 300 of the loop's 600 us busy
    ("enqueue_ms_per_step", 0.02),  # 80 us of chunks over 4 steps
])
def test_span_readers_on_a_canned_summary(name, want):
    assert read(name, canned()) == pytest.approx(want)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_read_nothing_without_their_span(name):
    t = canned()
    t["cpu_ops"] = [c for c in t["cpu_ops"] if not c[0].startswith("fdtd.")]
    assert read(name, t) is None


def test_loop_idle_pct_clips_work_to_the_loop():
    t = canned()
    t["device_ops"].append(["k", 750.0, 100.0, "kernel"])  # half of it inside the loop
    assert read("loop_idle_pct", t) == pytest.approx(100.0 * (1 - 350.0 / 600.0))
    t["cpu_ops"].append(["fdtd.loop", 960.0, 980.0])  # a second loop span, idle
    assert read("loop_idle_pct", t) == pytest.approx(100.0 * (1 - 350.0 / 620.0))


def test_a_traced_cpu_run_reads_every_span_metric(run_tiny):
    got = {}
    for workload in ("oven_water_256.probes", "oven_256.dft4"):
        r = run_tiny(workload, trace=True)
        assert r["correct"], r["checks"]
        got[workload] = r["metrics"]
    probes, dft4 = got["oven_water_256.probes"], got["oven_256.dft4"]
    # the probes cell reads the same spans under the names that move setup_s
    for name in ("coefs_s", "resume_s", "loop_idle_pct", "enqueue_ms_per_step"):
        assert probes[f"{name}.probes"]["value"] >= 0, name
        assert name not in probes
    assert "finalize_s" not in probes and "finalize_s.probes" not in probes  # a reader the cell does not list
    assert dft4["finalize_s"]["value"] > 0 and "coefs_s" not in dft4
    assert probes["window_mcells_per_s"]["value"] > 0 and "window_mcells_per_s" not in dft4
    assert 0 <= probes["loop_idle_pct.probes"]["value"] <= 100
    assert 0 <= dft4["loop_idle_pct"]["value"] <= 100
