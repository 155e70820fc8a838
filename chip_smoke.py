#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fdtd_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It fails (non-zero exit, no result line) without CUDA or without the
package beside it.  Phases, each printing one line or more:

1. the device: nvidia-smi name and power limit, torch/CUDA/nvcc versions;
2. the build of the Hopper kernels from csrc/, one nvcc per source, all
   started together (seconds, ptxas report);
3. each kernel against its plain torch version on the card, fp32 and bf16,
   both modes, random fields on a non-cubic non-integer box with the source
   patch, and the TE101 seed on the non-integer box whose i=maxi Ey column
   is non-zero: max |diff| must be 0.  The stream kernel at s = 8, 4 and 2
   (tiles that do not divide the box), and one sweep at 256^3 with the
   main path's plan;
4. validation: configs/reference.txt (50^3, fp32) through
   run_simulation(backend="twopass") with snapshots: e_r(Ey) < 0.007,
   energy drift < 2e-3, the .vtr cadence, one launch per kernel per step;
   then through backend="stream" as one chunk (200 // s sweeps and 200 % s
   twopass steps);
5. the main path at full size: the CLI on configs/bench_256.txt (256^3,
   computation mode, fp32, 1000 steps; auto picks stream), then the same
   scene through run_simulation with backend twopass and with backend
   stream, the launch counts read around each (equal final fields), then
   64 steps of stream, twopass and torch at 256^3 in both modes and 16
   steps of stream and twopass at 512^3 (equal fields);
6. timing at 256^3: Mcells/s of stream, twopass and torch in fp32 and
   bf16, and each kernel's time beside its plain version's.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_TIMED = 48  # steps per timed run (a multiple of every steps-per-sweep)
N_WARM = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)
    print(f"PASS: {msg}", flush=True)


def run_cmd(cmd: list[str]) -> str:
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        fail(f"{' '.join(cmd)} exited {r.returncode}: {r.stderr.strip()}")
    return r.stdout.strip()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "fdtd_tpu_torch")):
        fail(f"the fdtd_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, HERE)
    os.chdir(HERE)

    import numpy as np

    from fdtd_tpu_torch import analytic, diagnostics
    from fdtd_tpu_torch.convert import state_from_numpy
    from fdtd_tpu_torch.grid import COMPONENTS
    from concurrent.futures import ThreadPoolExecutor

    from fdtd_tpu_torch.ops import build, curl, stream, stream_plan, yee
    from fdtd_tpu_torch.params import Mode, Params, load_parameters, time_values
    from fdtd_tpu_torch.runner import initial_state, resolve_backend, run_simulation
    from fdtd_tpu_torch.source import apply_source, make_source_plan, profile_tensor, sweep_drive_rows
    from fdtd_tpu_torch.state import FieldState, field_dtype, update_coefs
    from fdtd_tpu_torch.step import make_chunk_runner, scan_inputs

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    nvcc = build.find_nvcc()
    nvcc_ver = run_cmd([nvcc, "--version"]).splitlines()[-1] if nvcc else "not found"
    print(smi, flush=True)
    print(f"versions: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, nvcc {nvcc_ver}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    sources = (yee.KERNEL_SOURCE, stream.KERNEL_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        lib_paths = list(pool.map(build.build, sources))
    build_s = time.perf_counter() - t0
    for lib_path in lib_paths:
        log = lib_path.with_suffix(".log").read_text() if lib_path.with_suffix(".log").exists() else ""
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas {lib_path.name}: {line.strip()}")
    print(f"build: {', '.join(lp.name for lp in lib_paths)} in {build_s:.2f} s", flush=True)

    # -- 3. kernel vs plain ------------------------------------------------
    max_err = {"yee_update_h": 0.0, "yee_update_e": 0.0, "yee_stream": 0.0}

    def maxdiff(a: FieldState, b: FieldState) -> float:
        return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a.tensors(), b.tensors()))

    def compare(p: Params, arrays: dict, steps: int, label: str) -> None:
        dt = field_dtype(p)
        coefs = update_coefs(p)
        patch = make_source_plan(p).patch if p.mode == Mode.COMPUTATION else None
        k_state = state_from_numpy(arrays, dev, dt)
        p_state = state_from_numpy(arrays, dev, dt)
        err = {"yee_update_h": 0.0, "yee_update_e": 0.0}
        for _ in range(steps):
            yee.update_h(p, k_state, coefs, patch)
            curl.update_h(p, p_state, coefs, patch)
            torch.cuda.synchronize()
            err["yee_update_h"] = max(err["yee_update_h"], maxdiff(k_state, p_state))
            yee.update_e(p, k_state, coefs)
            curl.update_e(p, p_state, coefs)
            torch.cuda.synchronize()
            err["yee_update_e"] = max(err["yee_update_e"], maxdiff(k_state, p_state))
        for name, d in err.items():
            max_err[name] = max(max_err[name], d)
            check(d == 0.0, f"{name} == plain over {steps} steps, {label}: max|diff| = {d!r}")

    ragged: set = set()

    def sweep_inputs(p: Params, arrays: dict, s: int):
        """The state with step 1 hard-set, the sweep's drive, and the plan."""
        dt = field_dtype(p)
        st = state_from_numpy(arrays, dev, dt)
        drive = None
        if p.mode == Mode.COMPUTATION:
            src = make_source_plan(p)
            amps = torch.tensor(rng.uniform(-1.0, 1.0, s), dtype=torch.float64, device=dev)
            prof = profile_tensor(src, dev)
            apply_source(src, st, amps[0], prof)
            ez_rows, hx_rows = sweep_drive_rows(src, amps, s, dt, prof)
            drive = stream.SweepDrive(src.patch, ez_rows[0], hx_rows[0])
        return st, drive, stream_plan.plan_for(p, s)

    def compare_sweep(p: Params, arrays: dict, s: int, label: str) -> None:
        st, drive, plan = sweep_inputs(p, arrays, s)
        coefs = update_coefs(p)
        out = FieldState(*(torch.full_like(t, float("nan")) for t in st.tensors()))
        stream.sweep(p, st, out, coefs, plan, drive)
        want = stream.plain_sweep(p, st, coefs, s, drive)
        torch.cuda.synchronize()
        d = maxdiff(out, want)
        max_err["yee_stream"] = max(max_err["yee_stream"], d)
        K1, J1, I1 = p.padded_shape
        if K1 % plan.tk or J1 % plan.tj or I1 % plan.ti:
            ragged.add((s, p.padded_shape))
        check(d == 0.0, f"yee_stream == plain_sweep, s={s} tile (k,j,i)=({plan.tk},{plan.tj},{plan.ti}) "
                        f"{plan.blocks} blocks, {label}: max|diff| = {d!r}")

    rng = np.random.default_rng(1234)
    for dtype in ("float32", "bfloat16"):
        for mode in (Mode.VALIDATION, Mode.COMPUTATION):
            # K, J, I = 70, 50, 61: non-cubic, and x/y/z not multiples of dx
            p = Params(length=0.0615, width=0.0505, height=0.0705, spatial_step=0.001,
                       time_step=1e-12, simulation_time=1e-11, sampling_rate=5,
                       mode=mode, dtype=dtype)
            arrays = {c: rng.uniform(-1.0, 1.0, p.padded_shape) for c in COMPONENTS}
            compare(p, arrays, 2, f"{dtype} {mode.name} random {p.padded_shape}")
            for s in stream_plan.STEPS:
                compare_sweep(p, arrays, s, f"{dtype} {mode.name} random {p.padded_shape}")
        # the non-integer box of tests/test_pallas.py: TE101 seed, Ey at i=maxi non-zero
        p = Params(length=0.0125, width=0.012, height=0.012, spatial_step=0.001,
                   time_step=1e-12, simulation_time=1e-11, sampling_rate=5,
                   mode=Mode.VALIDATION, dtype=dtype)
        seed = initial_state(p, "cpu")
        check(float(seed.ey[:, : p.maxj, p.maxi].abs().max()) > 1e-3, "the i=maxi Ey column is non-zero")
        seed_arrays = {c: getattr(seed, c).to(torch.float64).numpy() for c in COMPONENTS}
        compare(p, seed_arrays, 8, f"{dtype} TE101 non-integer box {p.padded_shape}")
        for s in stream_plan.STEPS:
            compare_sweep(p, seed_arrays, s, f"{dtype} TE101 non-integer box {p.padded_shape}")
    check(bool(ragged), f"stream tiles that do not divide the box were checked: {sorted(ragged)}")

    # one sweep at 256^3 with the main path's plan, both dtypes
    p_main = load_parameters("configs/bench_256.txt", dtype="float32")
    main_plan = stream_plan.pick_plan(p_main)
    print(f"main path plan at 256^3: {main_plan} ({main_plan.blocks} blocks of "
          f"{main_plan.threads} threads, {main_plan.smem_bytes} B shared memory)", flush=True)
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(p_main, dtype=dtype)
        arrays = {c: rng.uniform(-1.0, 1.0, pd.padded_shape).astype(np.float32) for c in COMPONENTS}
        compare_sweep(pd, arrays, main_plan.s, f"{dtype} COMPUTATION random 256^3, main plan")
        del arrays

    # -- 4. validation through the kernels ---------------------------------
    p = load_parameters("configs/reference.txt", dtype="float32")
    ts = time_values(p)
    n = len(ts)
    with tempfile.TemporaryDirectory() as out:
        yee.reset_launches()
        res = run_simulation(p, dev, out_dir=out, backend="twopass",
                             diagnostics_log=os.path.join(out, "diag.jsonl"), log=lambda m: None)
        counts = dict(yee.launches)
        files = sorted(os.path.basename(f) for f in glob.glob(os.path.join(out, "*.vtr")))
        with open(os.path.join(out, "diag.jsonl")) as f:
            diag_lines = f.read().splitlines()
    e_r = analytic.relative_l2_error(p, res.state, float(ts[-1]))["ey"]
    check(e_r < 0.007, f"validation 50^3 fp32 e_r(Ey) = {e_r!r} < 0.007")
    e0 = float(diagnostics.total_energy(p, initial_state(p, dev).to(dtype=torch.float64)))
    e1 = float(diagnostics.total_energy(p, res.state.to(dtype=torch.float64)))
    check(abs(e1 - e0) / e0 < 2e-3, f"validation energy drift {abs(e1 - e0) / e0!r} < 2e-3")
    rate = p.sampling_rate
    expected = sorted(["result0001.vtr"] + [f"result{m:04d}.vtr" for m in range(rate, n + 1, rate)])
    check(files == expected, f"snapshot cadence: {len(files)} files, result0001 then every {rate} steps")
    check(len(diag_lines) == 1 + n // rate, f"energy log has {len(diag_lines)} lines")
    check(counts == {"yee_update_h": n, "yee_update_e": n},
          f"validation launch counts {counts} == {n} steps")

    # the same scene through stream, as one chunk (rate-2 chunks never
    # reach a sweep: they would all run on twopass)
    p1 = dataclasses.replace(p, sampling_rate=n)
    s_val = stream_plan.pick_plan(p1).s
    with tempfile.TemporaryDirectory() as out:
        yee.reset_launches()
        stream.reset_launches()
        res = run_simulation(p1, dev, out_dir=out, backend="stream", write_snapshots=False,
                             log=lambda m: None)
        counts = {**yee.launches, **stream.launches}
    e_r = analytic.relative_l2_error(p1, res.state, float(ts[-1]))["ey"]
    check(e_r < 0.007, f"validation 50^3 fp32 through stream (s={s_val}) e_r(Ey) = {e_r!r} < 0.007")
    e1 = float(diagnostics.total_energy(p1, res.state.to(dtype=torch.float64)))
    check(abs(e1 - e0) / e0 < 2e-3, f"validation through stream energy drift {abs(e1 - e0) / e0!r} < 2e-3")
    want = {"yee_update_h": n % s_val, "yee_update_e": n % s_val, "yee_stream": n // s_val}
    check(counts == want, f"validation through stream launch counts {counts} == {want}")

    # -- 5. the main path at 256^3 -----------------------------------------
    with tempfile.TemporaryDirectory() as out:
        diag = os.path.join(out, "diag.jsonl")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "fdtd_tpu_torch", "configs/bench_256.txt", "--no-output",
             "--diag-log", diag, "--out", out],
            capture_output=True, text=True, timeout=600,
        )
        cli_s = time.perf_counter() - t0
        print(r.stdout.strip().splitlines()[-2] if r.stdout.strip() else "(no CLI output)")
        check(r.returncode == 0 and "Simulation complete!" in r.stdout,
              f"CLI 256^3 x 1000 steps exit {r.returncode} in {cli_s:.1f} s {r.stderr.strip()[-300:]}")
        with open(diag) as f:
            rec = json.loads(f.readline())
        check(rec["iteration"] == 0, "CLI energy log holds the step-0 line")

    p = load_parameters("configs/bench_256.txt", dtype="float32")
    n = len(time_values(p))
    check(resolve_backend(p, "auto", dev) == "stream", "auto resolves to stream at 256^3 fp32")
    finals = {}
    main_counts = {}
    for backend in ("twopass", "stream"):
        yee.reset_launches()
        stream.reset_launches()
        res = run_simulation(p, dev, write_snapshots=False, backend=backend, log=lambda m: None)
        counts = {**yee.launches, **stream.launches}
        s_b = main_plan.s if backend == "stream" else 1
        want = ({"yee_update_h": n, "yee_update_e": n, "yee_stream": 0} if backend == "twopass" else
                {"yee_update_h": n % s_b, "yee_update_e": n % s_b, "yee_stream": n // s_b})
        check(counts == want and n == 1000, f"main path {backend} launch counts {counts} == {want}")
        if backend == "twopass":
            main_counts.update(yee_update_h=counts["yee_update_h"], yee_update_e=counts["yee_update_e"])
        else:
            main_counts["yee_stream"] = counts["yee_stream"]
        e_e = float(diagnostics.e_energy(p, res.state))
        e_h = float(diagnostics.h_energy(p, res.state))
        check(math.isfinite(e_e + e_h) and e_e > 0 and e_h > 0,
              f"256^3 {backend} final energies E={e_e!r} H={e_h!r} finite and non-zero "
              f"({res.mcells_per_s:.1f} Mcells/s over {res.iterations} steps)")
        check(all(tuple(s.shape) == p.padded_shape and bool(torch.isfinite(s).all())
                  for s in res.state.tensors()), f"all six final fields finite, shape {p.padded_shape}")
        finals[backend] = res.state
        del res
    d = maxdiff(finals["stream"], finals["twopass"])
    check(d == 0.0, f"256^3 1000 steps: stream == twopass, max|diff| = {d!r}")
    del finals

    def equal_runs(pm: Params, steps: int, backends: tuple) -> None:
        ts, amps = scan_inputs(pm, time_values(pm)[:steps])
        states = {}
        for backend in backends:
            s = initial_state(pm, dev)
            make_chunk_runner(pm, dev, backend=backend)(s, (ts, amps))
            states[backend] = s
        torch.cuda.synchronize()
        for a, b in zip(backends, backends[1:]):
            d = maxdiff(states[a], states[b])
            check(d == 0.0, f"{pm.maxk}^3 {pm.mode.name} {steps} steps: {a} == {b}, max|diff| = {d!r}")

    for mode in (Mode.COMPUTATION, Mode.VALIDATION):
        equal_runs(dataclasses.replace(p, mode=mode), 64, ("stream", "twopass", "torch"))
    p512 = load_parameters("configs/bench_256.txt", dtype="float32")
    p512 = dataclasses.replace(p512, length=0.512, width=0.512, height=0.512)
    equal_runs(p512, 16, ("stream", "twopass"))
    torch.cuda.empty_cache()

    # -- 6. timing ---------------------------------------------------------
    rates: dict[str, list[float]] = {}
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(p, dtype=dtype)
        ts, amps = scan_inputs(pd, time_values(pd)[: N_WARM + N_TIMED])
        for backend in ("stream", "twopass", "torch", "torch", "twopass", "stream"):
            s = initial_state(pd, dev)
            run = make_chunk_runner(pd, dev, backend=backend)
            run(s, (ts[:N_WARM], amps[:N_WARM]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(s, (ts[N_WARM:], amps[N_WARM:]))
            torch.cuda.synchronize()
            dt_s = time.perf_counter() - t0
            rates.setdefault(f"{backend} {dtype}", []).append(pd.cell_count * N_TIMED / dt_s / 1e6)
            del s
    for key, vals in rates.items():
        print(f"timing 256^3 {key}: Mcells/s {vals} (2 runs of {N_TIMED} steps, {smi})")

    def event_ms(fn, reps=20) -> float:
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    s = initial_state(dataclasses.replace(p, mode=Mode.VALIDATION), dev)
    coefs = update_coefs(p)
    patch = make_source_plan(p).patch
    arrays = {c: rng.uniform(-1.0, 1.0, p.padded_shape).astype(np.float32) for c in COMPONENTS}
    st, drive, plan = sweep_inputs(p, arrays, main_plan.s)
    del arrays
    out = FieldState(*(torch.empty_like(t) for t in st.tensors()))
    ms = {
        "yee_update_h": (event_ms(lambda: yee.update_h(p, s, coefs, patch)),
                         event_ms(lambda: curl.update_h(p, s, coefs, patch))),
        "yee_update_e": (event_ms(lambda: yee.update_e(p, s, coefs)),
                         event_ms(lambda: curl.update_e(p, s, coefs))),
        "yee_stream": (event_ms(lambda: stream.sweep(p, st, out, coefs, plan, drive)),
                       event_ms(lambda: stream.plain_sweep(p, st, coefs, plan.s, drive, out), reps=5)),
    }
    for name, (k_ms, p_ms) in ms.items():
        per = f" per sweep of {plan.s} steps" if name == "yee_stream" else " per pass"
        print(f"timing 256^3 fp32 {name}: kernel {k_ms!r} ms, plain {p_ms!r} ms{per} ({smi})")
    # every plan the picker ranks, in both dtypes (the picker's choice above)
    for dtype in ("float32", "bfloat16"):
        st_d = st.to(dtype=field_dtype(dataclasses.replace(p, dtype=dtype)))
        out_d = FieldState(*(torch.empty_like(t) for t in st_d.tensors()))
        for s_try in stream_plan.STEPS:
            pl = stream_plan.plan_for(dataclasses.replace(p, dtype=dtype), s_try)
            k_ms = event_ms(lambda: stream.sweep(p, st_d, out_d, coefs, pl))
            print(f"timing 256^3 {dtype} yee_stream s={s_try} tile (k,j,i)=({pl.tk},{pl.tj},{pl.ti}) "
                  f"{pl.blocks} blocks: {k_ms!r} ms per sweep, {k_ms / s_try!r} ms per step, "
                  f"modelled {pl.bytes_per_cell_step!r} B per cell and step ({smi})")
        del st_d, out_d

    # least time for the same work: each input read once, each output
    # written once (bytes), or the flops at the fp32 peak, whichever is larger
    cells = math.prod(p.padded_shape)
    item = 4
    bytes_moved = {"yee_update_h": 9 * item * cells, "yee_update_e": 9 * item * cells,
                   "yee_stream": 12 * item * cells}
    flops = {"yee_update_h": 15 * cells, "yee_update_e": 15 * cells, "yee_stream": 30 * plan.s * cells}
    replaces = {"yee_update_h": "fdtd_tpu/ops/pallas_fused.py:332",
                "yee_update_e": "fdtd_tpu/ops/pallas_fused.py:412",
                "yee_stream": "fdtd_tpu/ops/pallas_stream.py:207"}
    sources = {"yee_update_h": "fdtd_tpu_torch/csrc/yee_twopass.cu",
               "yee_update_e": "fdtd_tpu_torch/csrc/yee_twopass.cu",
               "yee_stream": "fdtd_tpu_torch/csrc/yee_stream.cu"}
    kernels = []
    for name in ("yee_update_h", "yee_update_e", "yee_stream"):
        t_bytes = bytes_moved[name] / HBM_BYTES_PER_S * 1e3
        t_ops = flops[name] / FP32_FLOPS * 1e3
        print(f"bound 256^3 {name}: fp32 {max(t_bytes, t_ops)!r} ms, bf16 "
              f"{max(t_bytes / 2, t_ops)!r} ms ({'bytes' if t_bytes / 2 >= t_ops else 'operations'})")
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": main_counts[name], "max_abs_err": max_err[name],
            "ms": ms[name][0], "plain_ms": ms[name][1],
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
