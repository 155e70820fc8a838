"""One run of one cell: set-up, the timed window, the check.

Set-up: the seeded state is drawn on the device and written as a
checkpoint under ``TMPDIR``; on a checkout's first run of the cell a
call of ``output_every`` steps builds the program's kernels (its time is
printed as the compile seconds); then a warm-up call of ``warm_steps``
steps, whose outputs the check compares and whose rate sizes the window.

The window: one call of ``fdtd_tpu_torch.runner.run_simulation`` from
that checkpoint through the public resume path (``backend="auto"``, no
snapshots, the energy log every ``output_every`` steps), for a schedule
of whole ``output_every`` chunks sized to last about ``seconds``.  The
host clock runs around the call, which ends in the program's own
synchronize; the call's prologue (coefficients, plan, state, runner, the
checkpoint's load) is inside.  With ``trace`` the same call runs under
``torch.profiler`` inside the benchmark's span.

After the window: the plain reference follows the first ``warm_steps``
steps from the same checkpoint, in the field storage the configuration
states and, at bfloat16, rounding where the program's plan stores
(:func:`plan_and_cadence`), and :mod:`core.compare` holds the warm-up
call's outputs and the window's first records against it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import compare, opcount, seeded
from . import trace as tr
from .cell import BENCH_DIR, Cell, is_debye, load_maps, simulation_time
from .kernels import FIELD_UPDATE, base, label

STATE_DIR = BENCH_DIR / "_state"  # built-kernel markers and library caches, inside the checkout
SAR_LABEL = "sar_increment"  # the program's profiler range of its per-step SAR increment


class NoCard(RuntimeError):
    """The run asks for more CUDA devices than the machine has."""


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _stdout(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> tuple[str, str]:
    """(name, power limit) from nvidia-smi, or the torch name and
    'unknown'."""
    import torch

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        name, limit = (s.strip() for s in out[0].split(",", 1))
        return name, limit
    except Exception:
        return torch.cuda.get_device_name(0), "unknown"


def nvcc_present() -> bool:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.access(os.path.join(home, "bin", "nvcc"), os.X_OK) or shutil.which("nvcc") is not None


def load_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py`` or, for a metric
    ``<reader>.<part>`` that has no file of its own (one quantity split by
    the end-to-end metric it moves in some cells), of ``metrics/<reader>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = BENCH_DIR / "metrics" / f"{name.split('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path} for the per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _log_records(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@dataclasses.dataclass
class Program:
    """The program's public entry, with the cell's inputs."""

    cell: Cell
    device: object
    run_dir: str
    dtype: str

    def __post_init__(self):
        from fdtd_tpu_torch import dft, monitors, params, state
        from fdtd_tpu_torch.ops import dispersive

        c = self.cell
        self._params, self._mode = params.Params, params.Mode
        self._source = params.SourceConfig(frequency=float(c.config["source_hz"]),
                                           aprime=float(c.config["source_patch_m"][0]),
                                           bprime=float(c.config["source_patch_m"][1]))
        self.maps = load_maps(c)
        self.debye = is_debye(c)
        self.materials = None
        if self.maps is not None:
            self.materials = state.Materials(eps_r=self.maps[0], sigma=self.maps[1])
        if self.debye:
            self.materials = dispersive.DebyeMaterials(base=self.materials, d_eps=self.maps[2], tau=self.maps[3])
        self.dft = dft.DftConfig(c.dft_hz) if c.dft_hz else None
        self.probes = monitors.ProbeSet(c.probes) if c.probes else None

    def params(self, steps: int, dtype: str | None = None):
        c = self.cell
        lx, ly, lz = c.box
        dt = float(c.config["time_step_s"])
        return self._params(length=lx, width=ly, height=lz, spatial_step=float(c.config["spatial_step_m"]),
                            time_step=dt, simulation_time=simulation_time(dt, steps),
                            sampling_rate=c.output_every,
                            mode=self._mode.COMPUTATION if c.config["mode"] == "computation" else self._mode.VALIDATION,
                            dtype=dtype or self.dtype, source=self._source)

    def call(self, steps: int, diag: str):
        """One ``run_simulation`` call of ``steps`` steps from the seeded
        checkpoint (looked up on the module each time, so a test can put a
        broken entry in its place)."""
        from fdtd_tpu_torch import runner

        return runner.run_simulation(self.params(steps), self.device, out_dir=self.run_dir,
                                     materials=self.materials, backend="auto", write_snapshots=False,
                                     accumulate_power=self.cell.sar, resume=True, log=_stderr,
                                     diagnostics_log=diag, dft=self.dft, probes=self.probes)

    def plan(self, dtype: str | None = None) -> dict:
        """The backend and sweep plan the program picks for this scene at
        ``dtype`` (default the one it runs): {'backend', 's', 'fold'},
        's' and 'fold' None off ``stream``, read through the program's
        ``runner.resolve_backend`` and ``stream_plan.pick_plan``; raises
        where they cannot be read."""
        import torch

        from fdtd_tpu_torch import runner
        from fdtd_tpu_torch.ops import stream_plan

        p = self.params(self.cell.output_every, dtype)
        backend = runner.resolve_backend(p, "auto", self.device, self.materials, self.cell.sar, None, None,
                                         self.dft, self.probes)
        if backend != "stream":
            return {"backend": backend, "s": None, "fold": None}
        free = torch.cuda.mem_get_info(self.device)[0] if torch.device(self.device).type == "cuda" else None
        plan = stream_plan.pick_plan(p, memory_bytes=free, lossy=self.materials is not None and not self.debye,
                                     het=False, sar=self.cell.sar, pml=None, ade=self.debye, dft=self.dft)
        if plan is None:
            raise RuntimeError(f"resolve_backend picked stream, but pick_plan found no plan at {p.dtype}")
        return {"backend": backend, "s": plan.s, "fold": getattr(plan, "fold", None)}


def round_every(dtype: str, plan: dict | None) -> int:
    """The steps between the program's stores of the fields, which the
    reference rounds at (``reference.plain.Scene``): 1 at float32, whose
    stores round nothing; at bfloat16 the sweep depth s on ``stream`` and
    1 on the per-step backends, from ``plan`` (:meth:`Program.plan`), which
    a bf16 run has to have read: it never falls back to 1."""
    if dtype == "float32":
        return 1
    if plan is None:
        raise RuntimeError(f"the program's plan was not read: a {dtype} reference rounds where the plan stores")
    return plan["s"] if plan["backend"] == "stream" else 1


def plan_and_cadence(prog: Program, cell: Cell) -> tuple[str, int]:
    """The run's plan line and the reference's cadence.  The program's plan
    is read for the log and, where the configuration states bfloat16, for
    the reference: at the stated dtype, also when a control runs the
    program at another.  A plan that cannot be read is printed at float32
    and raises at bfloat16."""
    try:
        plan = prog.plan()
        line = f"plan: backend {plan['backend']}"
        if plan["backend"] == "stream":
            line += f", s {plan['s']}, fold {plan['fold']}" + (", ADE sweep" if prog.debye else "")
    except Exception as e:
        plan, line = None, f"plan: not read ({type(e).__name__}: {e})"
    if cell.dtype != "float32" and prog.dtype != cell.dtype:
        plan = prog.plan(cell.dtype)
        line += f" (at {prog.dtype}; at the stated {cell.dtype}: backend {plan['backend']}, s {plan['s']})"
    every = round_every(cell.dtype, plan)
    what = "stores float32" if cell.dtype == "float32" else f"rounds to {cell.dtype} every {every} step(s)"
    return f"{line}; the reference {what}", every


def _host_outputs(res, cell: Cell, steps: int, diag: str) -> dict:
    """The outputs of a call the check needs, as host arrays."""
    out = {"steps": steps, "log": _log_records(diag),
           "state": {n: getattr(res.state, n).detach().float().cpu().numpy() for n in seeded.COMPONENTS}}
    if cell.sar:
        out["power"] = res.power_j.detach().float().cpu().numpy()
    if cell.dft_hz:
        scale = res.dft.steps / 2.0  # the phasors are (2/N) times the sums
        out["dft"] = {"re": res.dft.phasors.real * scale, "im": res.dft.phasors.imag * scale}
    if cell.probes:
        out["probes"] = np.asarray(res.probes.values, np.float32)
    return out


def _window_outputs(res, cell: Cell, steps: int, diag: str, check_steps: int) -> dict:
    """What the check reads of the window: its energy records, its first
    ``check_steps`` probe rows, the records due and those missing or not
    finite (``failed``), and ``bad``: those plus each final output that is
    not finite."""
    import torch

    log = _log_records(diag)
    got = {r["iteration"]: r for r in log}
    due = range(cell.output_every, steps + 1, cell.output_every)
    failed = sum(1 for it in due if it not in got or not math.isfinite(got[it].get("total", math.nan)))
    finite = [bool(torch.isfinite(getattr(res.state, n)).all()) for n in seeded.COMPONENTS]
    out = {"steps": check_steps, "log": log, "attempted": len(due), "failed": failed}
    if cell.sar:
        finite.append(bool(torch.isfinite(res.power_j).all()))
    if cell.dft_hz:
        finite.append(bool(np.isfinite(res.dft.phasors).all()))
    if cell.probes:
        values = np.asarray(res.probes.values, np.float32)
        finite.append(bool(np.isfinite(values).all()))
        out["probes"] = values[:check_steps].copy()
    out["bad"] = failed + finite.count(False)
    return out


def seeded_pol(cell: Cell, seed: int, maps, device):
    """The seeded polarization of a Debye load (:func:`seeded.seeded_polarization`,
    at eps0 d_eps times the seeded E's amplitude), or None."""
    if not is_debye(cell):
        return None
    amp = seeded.polarization_amplitude(cell.config["load"]["d_eps"], cell.traffic["seeded_fields"]["e_v_per_m"])
    return seeded.seeded_polarization(cell.grid, seed, amp, maps[2], device)


def reference_outputs(cell: Cell, ckpt: str, steps: int, device, seed: int, every: int = 1) -> dict:
    """The plain reference over ``steps`` steps from the checkpoint's
    fields and, in a Debye load, the polarization drawn again from
    ``seed`` (not read back: a program that resumes a P other than the
    seeded one is caught), in the configuration's storage dtype, rounded
    every ``every`` steps (:func:`round_every`)."""
    from reference.plain import Reference, Scene

    maps = load_maps(cell)
    sc = Scene(cell.grid, cell.box, cell.config["spatial_step_m"], cell.config["time_step_s"],
               cell.config["source_hz"], cell.config["source_patch_m"], maps=maps, sar=cell.sar,
               dft_hz=cell.dft_hz, probes=cell.probes, output_every=cell.output_every, dtype=cell.dtype,
               round_every=every)
    pol = seeded_pol(cell, seed, maps, device)
    if pol is not None:
        pol = dict(zip(("x", "y", "z"), pol))
    return Reference(sc, device).follow(seeded.read_checkpoint_fields(ckpt), steps, pol)


def window_steps(cell: Cell, seconds: float, t_warm: float, loop_s: float, warm_steps: int, saved=None) -> int:
    """The window's steps: whole output chunks, as many as last about
    ``seconds`` at the warm-up call's rate (its loop's time a step, and its
    prologue and epilogue once).  With ``saved`` (a file in the
    checkout), the first run of the cell sizes the window and later runs
    of the same length reuse its size, so that every run of a checkout
    does the same work."""
    if saved is not None and saved.exists():
        got = json.loads(saved.read_text())
        if got.get("seconds") == seconds:
            return int(got["steps"])
    per_step = loop_s / warm_steps
    fixed = t_warm - loop_s
    steps = max(1, round((seconds - fixed) / per_step / cell.output_every)) * cell.output_every
    if saved is not None:
        saved.parent.mkdir(parents=True, exist_ok=True)
        saved.write_text(json.dumps({"seconds": seconds, "steps": steps, "step_s": per_step, "fixed_s": fixed}) + "\n")
    return steps


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             config_over: dict | None = None, traffic_over: dict | None = None, state_dir=STATE_DIR,
             t_start: float | None = None, say=_stdout, program_dtype: str | None = None) -> dict:
    """Run ``workload`` once; returns the result line's object (with the
    keys ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    ``breakdown`` when traced, and ``checks`` last) and, under
    ``_info``, the set-up phases and the window's size.
    ``program_dtype``: the control, the program run at another field
    storage than the configuration states (the reference keeps the
    stated one)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    phases: dict[str, float] = {}
    cell = Cell(workload, config_over=config_over, traffic_over=traffic_over)
    cell.check_grid()
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{workload} needs {cell.chips} CUDA device(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        dev = torch.device("cuda", 0)
        phases["imports"] = time.perf_counter() - t_start
        torch.cuda.init()
        torch.empty(1, device=dev)
        phases["cuda_init"] = time.perf_counter() - t_start - phases["imports"]
        name, power_limit = card_info()
        say(f"card: {name}, power.limit {power_limit}")
        say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc {'present' if nvcc_present() else 'absent'}")
    else:
        dev = torch.device(device)
        name = f"host {device}"
    phases["card_info"] = time.perf_counter() - t_start - sum(phases.values())
    prog = Program(cell, dev, "", program_dtype or cell.dtype)
    phases["program_import"] = time.perf_counter() - t_start - sum(phases.values())
    run_dir = tempfile.mkdtemp(prefix="bench-run-")
    prog.run_dir = run_dir
    try:
        return _run(cell, prog, dev, name, seed, seconds, trace, state_dir, t_start, phases, say)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _run(cell, prog, dev, card, seed, seconds, trace, state_dir, t_start, phases, say) -> dict:
    import torch

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def mark() -> float:
        return time.perf_counter() - t_start - sum(phases.values())

    line, every = plan_and_cadence(prog, cell)
    say(line)
    amp = cell.traffic["seeded_fields"]
    fields = seeded.seeded_fields(cell.grid, seed, amp["e_v_per_m"], amp["h_a_per_m"], dev)
    pol = seeded_pol(cell, seed, prog.maps, dev)
    ckpt = seeded.write_checkpoint(prog.run_dir, fields, cell.grid if cell.sar else None, pol)
    del fields, pol
    phases["seeded_checkpoint"] = mark()

    compile_s = 0.0
    marker = state_dir / f"{cell.name}.built" if state_dir is not None and cuda else None
    if marker is not None and not marker.exists():
        t0 = time.perf_counter()
        res = prog.call(cell.output_every, os.path.join(prog.run_dir, "compile.jsonl"))
        del res
        sync()
        compile_s = time.perf_counter() - t0
        marker.parent.mkdir(parents=True, exist_ok=True)
        marker.write_text(f"{compile_s}\n")
    phases["compile_call"] = mark()
    say(f"compile_s: {compile_s:.3f}" + ("" if compile_s else " (kernels already built in this checkout)"))

    warm_steps = int(cell.traffic["warm_steps"])
    diag = os.path.join(prog.run_dir, "warm.jsonl")
    t0 = time.perf_counter()
    res = prog.call(warm_steps, diag)
    sync()
    t_warm = time.perf_counter() - t0
    warm = _host_outputs(res, cell, warm_steps, diag)
    loop_s = res.wall_seconds if 0 < res.wall_seconds <= t_warm else t_warm
    del res
    phases["warm_call"] = mark()

    steps = window_steps(cell, seconds, t_warm, loop_s, warm_steps,
                         state_dir / f"{cell.name}.window.json" if state_dir is not None and cuda else None)
    if trace and cell.traffic.get("trace_max_steps"):
        # a traced window at most this long: the profiler keeps every host op of the call
        steps = min(steps, int(cell.traffic["trace_max_steps"]))
    check_steps = min(warm_steps, steps)

    if cuda:
        torch.cuda.empty_cache()
        peak_setup = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    diag = os.path.join(prog.run_dir, "window.jsonl")
    phases["window_prep"] = mark()
    setup_s = time.perf_counter() - t_start
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        span = torch.profiler.record_function(tr.SPAN)
        span.__enter__()
    t0 = time.perf_counter()
    res = prog.call(steps, diag)
    sync()
    window_s = time.perf_counter() - t0
    if trace:
        span.__exit__(None, None, None)
        t1 = time.perf_counter()
        prof.__exit__(None, None, None)
        info_trace_stop = time.perf_counter() - t1
    peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    memory_peak = max(peak_setup, peak_window) if cuda else 0
    window = _window_outputs(res, cell, steps, diag, check_steps)
    window_loop_s = res.wall_seconds
    del res
    if cuda:
        torch.cuda.empty_cache()

    result: dict = {"correct": False, "attempted": window["attempted"], "failed": window["failed"]}
    device = {"platform": "gpu" if cuda else dev.type, "kind": card, "count": 1 if cuda else 0,
              "memory_peak_bytes": int(memory_peak)}
    info = {"steps": steps, "window_s": window_s, "window_loop_s": window_loop_s, "setup_s": setup_s,
            "compile_s": compile_s, "phases": phases, "warm_s": t_warm, "warm_loop_s": loop_s}
    if trace:
        t0 = time.perf_counter()
        summary = tr.summarize(prof, steps, (SAR_LABEL,))
        del prof
        info["trace_stop_s"] = info_trace_stop
        info["summarize_s"] = time.perf_counter() - t0
        ctx = {"ops_per_step": opcount.for_cell(cell), "peak_flops": opcount.PEAK_FP32_FLOPS,
               "cells": cell.cells, "steps": steps, "window_s": window_s}
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(summary, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        starts = [s for n, s, _, k in tr.in_window(summary) if k == "kernel" and base(n) in FIELD_UPDATE]
        result["metrics"] = metrics
        device.update(busy_s=tr.busy_us(summary) / 1e6, window_s=tr.window_us(summary) / 1e6)
        result["breakdown"] = tr.breakdown(summary, label, min(starts) if starts else None)
        info["trace_events"] = {"device": len(summary["device_ops"]), "host": len(summary["cpu_ops"])}
        info["trace_read_s"] = time.perf_counter() - t0
        del summary
    else:
        values = {"mcells_per_s": cell.cells * steps / window_s / 1e6,
                  "device_peak_gib": peak_window / 2 ** 30,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    result["device"] = device

    t0 = time.perf_counter()
    ref = reference_outputs(cell, ckpt, warm_steps, dev, seed, every)
    found = compare.checks(warm, window, ref, cell.limits())
    del ref
    if cuda:
        torch.cuda.empty_cache()
    info["reference_s"] = time.perf_counter() - t0
    result["correct"] = compare.correct(found)
    result["_info"] = info
    result["checks"] = found
    return result

