"""Where the time of a chunk goes: device time per step by kernel, and the
device's idle share, per backend and dtype.

    python -m fdtd_tpu_torch.profile_chunk [--n 256] [--steps 48]
        [--backends stream twopass torch] [--dtypes float32 bfloat16]

For each backend and dtype it builds the n^3 computation scene of
``configs/bench_256.txt`` (rescaled to n), runs a warm-up chunk, times an
unprofiled chunk of ``--steps`` steps on the host clock (between
``torch.cuda.synchronize()`` calls), then profiles the same chunk with
``torch.profiler`` (CPU and CUDA activity) and sums the self device time of
every kernel.  One JSON line per (backend, dtype):

- ``wall_ms_per_step``: unprofiled host time per step;
- ``device_ms_per_step``: summed kernel time per step (profiled run);
- ``kernels_ms_per_step``: that sum split by kernel group (``yee_stream``,
  ``yee_update_h``, ``yee_update_e``, ``other``: the source's small
  launches and, for ``torch``, every elementwise kernel);
- ``idle_share``: 1 - device / unprofiled wall;
- ``idle_share_profiled``: the same against the profiled wall (the
  profiler adds host time per launch).

Needs a CUDA device: without one it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .params import Mode, Params, time_values
from .runner import initial_state
from .step import make_chunk_runner, scan_inputs

# demangled names of the kernels in csrc/ ("::e_kernel<" and not "e_kernel":
# PyTorch's own elementwise_kernel contains the latter)
GROUPS = (("::stream_kernel<", "yee_stream"), ("::h_kernel<", "yee_update_h"),
          ("::e_kernel<", "yee_update_e"))


def scene(n: int, dtype: str) -> Params:
    """configs/bench_256.txt at n^3: dx 1 mm, dt 1 ps, computation mode."""
    return Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=0.001,
                  time_step=1e-12, simulation_time=1e-9, sampling_rate=1000000,
                  mode=Mode.COMPUTATION, dtype=dtype)


def _group(name: str) -> str:
    for key, group in GROUPS:
        if key in name:
            return group
    return "other"


def profile(p: Params, backend: str, steps: int, warm: int, dev: torch.device) -> dict:
    ts, amps = scan_inputs(p, time_values(p)[: warm + 2 * steps])
    run = make_chunk_runner(p, dev, backend=backend)
    s = initial_state(p, dev)
    run(s, (ts[:warm], amps[:warm]))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    run(s, (ts[warm : warm + steps], amps[warm : warm + steps]))
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(s, (ts[warm + steps :], amps[warm + steps :]))
        torch.cuda.synchronize(dev)
        wall_prof = (time.perf_counter() - t0) * 1e3 / steps
    by_group: dict[str, float] = {}
    launches: dict[str, int] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kind = getattr(ev, "device_type", None)
        if us <= 0 or (kind is not None and kind != torch.autograd.DeviceType.CUDA):
            continue
        g = _group(ev.key)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3 / steps
        launches[g] = launches.get(g, 0) + ev.count
    device = sum(by_group.values())
    return {
        "backend": backend, "dtype": p.dtype, "n": p.maxk, "steps": steps,
        "wall_ms_per_step": wall, "wall_ms_per_step_profiled": wall_prof,
        "device_ms_per_step": device, "kernels_ms_per_step": by_group,
        "launches_per_step": {g: c / steps for g, c in launches.items()},
        "idle_share": 1.0 - device / wall, "idle_share_profiled": 1.0 - device / wall_prof,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fdtd_tpu_torch.profile_chunk", description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256, help="cells per side (default 256)")
    ap.add_argument("--steps", type=int, default=48, help="steps per measured chunk (default 48)")
    ap.add_argument("--warm", type=int, default=8, help="warm-up steps (default 8)")
    ap.add_argument("--backends", nargs="+", default=["stream", "twopass", "torch"])
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: profile_chunk measures a CUDA device and none is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    for dtype in args.dtypes:
        for backend in args.backends:
            rec = profile(scene(args.n, dtype), backend, args.steps, args.warm, dev)
            rec["card"] = card
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
