"""The per-layer readers and the trace reduction on canned profiler
events, with known answers."""

import pytest
import torch

from core import kernels
from core import trace as tr
from core.run_cell import load_reader

RING = "void (anonymous namespace)::ring_kernel<float, 4, 32, false, false, false, false, false, false, false, false>(Args)"
RING_SAR = "void (anonymous namespace)::ring_kernel<float, 4, 24, true, true, false, true, false, false, false, false>(Args)"
# K3-lossy-SAR at bf16 storage, as the profiler demangles it (the kernel table's template arguments)
RING_SAR_BF16 = ("void (anonymous namespace)::ring_kernel<__nv_bfloat16, 4, 24, 1, true, true, false, true, false, false, "
                 "false>(Args)")
FOLD = "void (anonymous namespace)::dft_fold_kernel<4, 2>(float const*, float*, int)"
ACCUM = "void (anonymous namespace)::dft_accum_kernel<float, false>(float const*)"
MARCH_H = "void (anonymous namespace)::march_kernel<float, false, false, false, 2, 2, 128, 4, 16, false>(Args)"
ELEM = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>(int, float)"


def canned(steps=10):
    # window 0..1000 us; a field update at 100-300 and 400-600, a fold 600-650,
    # an elementwise kernel 700-750 inside a sar range, a copy 800-810, a kernel
    # after the window
    return {
        "window": [0.0, 1000.0], "steps": steps,
        "device_ops": [[RING, 100.0, 200.0, "kernel"], [RING_SAR, 400.0, 200.0, "kernel"],
                       [FOLD, 600.0, 50.0, "kernel"], [ELEM, 700.0, 50.0, "kernel"],
                       ["Memcpy HtoD (Pageable -> Device)", 800.0, 10.0, "memcpy"],
                       [RING, 1200.0, 100.0, "kernel"]],
        "ranges": {"sar_increment": [[690.0, 760.0, 50.0], [1100.0, 1150.0, 7.0]]},
        "cpu_ops": [["aten::copy_", 20.0, 90.0], ["cudaLaunchKernel", 300.0, 390.0], ["aten::add", 650.0, 700.0]],
    }


def read(name, trace, ops=0.0):
    return load_reader(name)(trace, {"ops_per_step": ops, "peak_flops": 67e12, "cells": 1, "steps": trace["steps"]})


def test_busy_and_idle():
    t = canned()
    assert tr.busy_intervals(t) == [(100.0, 300.0), (400.0, 650.0), (700.0, 750.0), (800.0, 810.0)]
    assert tr.busy_us(t) == 510.0 and tr.window_us(t) == 1000.0
    assert read("device_idle_pct", t) == pytest.approx(49.0)


def test_kernel_times_per_step():
    t = canned(steps=10)
    assert read("sweep_ms_per_step", t) == pytest.approx(0.04)  # 400 us of ring kernels / 10 steps
    assert read("dft_ms_per_step", t) == pytest.approx(0.005)
    assert read("sar_ms_per_step", t) == pytest.approx(0.005)  # the range inside the window only
    assert read("prologue_s", t) == pytest.approx(100e-6)
    # 500 us of kernels a 10-step window is 50 us a step; 67e6 operations a step need 1 us
    assert read("kernels_roofline_pct", t, ops=67e6) == pytest.approx(2.0)


def test_nothing_to_read_gives_nothing():
    t = canned()
    t["device_ops"] = [d for d in t["device_ops"] if kernels.base(d[0]) not in kernels.DFT]
    t["ranges"] = {}
    assert read("dft_ms_per_step", t) is None and read("sar_ms_per_step", t) is None
    t["device_ops"] = []
    for name in ("sweep_ms_per_step", "kernels_roofline_pct", "prologue_s", "device_idle_pct"):
        assert read(name, t) is None


def test_kernel_names_group_as_the_launch_counters():
    assert kernels.group(RING) == "yee_stream"
    assert kernels.group(RING_SAR) == "yee_stream_lossy_sar"
    assert kernels.group(RING_SAR_BF16) == "yee_stream_lossy_sar" and kernels.base(RING_SAR_BF16) == "ring_kernel"
    assert kernels.group(MARCH_H) == "yee_update_h"
    assert kernels.group(FOLD) == "dft_fold" and kernels.group(ACCUM) == "dft_accum"
    assert kernels.group(ELEM) == "other" and kernels.label(ELEM) == "void at::native::vectorized_elementwise_kernel"
    assert kernels.base(MARCH_H) in kernels.FIELD_UPDATE and kernels.base(ELEM) is None


def test_breakdown_names_ops_and_host_gaps():
    b = tr.breakdown(canned(), kernels.label, first_update=100.0)
    assert b["device_ops"][0] == ["yee_stream", pytest.approx(200e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(100e-6)  # 0..100, mid 50
    assert gaps["cudaLaunchKernel"] == pytest.approx(100e-6)  # 300..400
    assert gaps["host code outside torch ops"] == pytest.approx(240e-6)  # 750..800 and 810..1000
    assert sum(gaps.values()) == pytest.approx(490e-6)


class _Ev:
    def __init__(self, name, device, start_us, end_us, corr=0, linked=0, annotation=False):
        self._v = (name, device, int(start_us * 1e3), int(end_us * 1e3), corr, linked, annotation)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def end_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def is_user_annotation(self): return self._v[6]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_summarize_attributes_kernels_to_ranges():
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = [
        _Ev(tr.SPAN, CPU, 0, 1000, corr=1),
        _Ev("sar_increment", CPU, 500, 600, corr=2),
        _Ev("aten::mul", CPU, 510, 520, corr=3),  # launches kernel 30 inside the range
        _Ev("cudaLaunchKernel", CPU, 512, 515, corr=30, linked=3),
        _Ev("aten::add", CPU, 610, 620, corr=4),  # launches kernel 40 outside it
        _Ev(ELEM, CUDA, 530, 560, corr=30, linked=3),
        _Ev(ELEM, CUDA, 630, 640, corr=40, linked=4),
        _Ev("sar_increment", CUDA, 530, 560, annotation=True),  # the device-side copy of the range
        _Ev(RING, CUDA, 100, 400, corr=50, linked=9),
    ]
    s = tr.summarize(_Prof(evs), steps=4, range_labels=("sar_increment",))
    assert s["window"] == [0.0, 1000.0] and s["steps"] == 4
    assert [d[0] for d in s["device_ops"]] == [RING, ELEM, ELEM]
    assert s["ranges"]["sar_increment"] == [[500.0, 600.0, 30.0]]
    assert read("sar_ms_per_step", s) == pytest.approx(0.03 / 4)
    assert tr.busy_us(s) == 340.0


def test_window_rate_reads_the_host_time_of_the_call():
    t = canned(steps=10)
    ctx = {"ops_per_step": 0.0, "peak_flops": 67e12, "cells": 4_000_000, "steps": 10, "window_s": 0.5}
    assert load_reader("window_mcells_per_s")(t, ctx) == pytest.approx(80.0)  # 4e7 cell updates in 0.5 s
    assert load_reader("window_mcells_per_s")(t, {**ctx, "window_s": 0.0}) is None
