"""Where the time of a chunk goes: device time per step by kernel, and the
device's idle share, per scene, backend and dtype.

    python -m fdtd_tpu_torch.profile_chunk [--n 256] [--steps 48]
        [--scenes vacuum heating pml dispersive dft shard sweep] [--backends stream twopass torch]
        [--dtypes float32 bfloat16] [--members 4]

Scenes: ``vacuum`` is the n^3 computation scene of ``configs/bench_256.txt``
(rescaled to n); ``heating`` is the same box with the default water block
(``--water-block``) and the SAR accumulator (``--sar``), the workload of
``configs/heating_256.txt``; ``pml`` is the vacuum scene with 10-cell CPML
walls (``--pml 10``); ``dispersive`` is the heating scene's block as a
Debye medium (``--water-block --dispersive --sar``); ``dft`` is the heating scene with the E
phasors at 2.45e10 Hz (``--water-block --sar --dft 2.45e10``: the DFT bands of the sweep on
``stream``, the ``dft_accum`` kernel after each step on ``twopass``); ``shard`` is the vacuum, heating, pml,
dft and dispersive scenes with ``--shard 4`` (four z slabs on the one card: the per-shard kernels and the halo
copies; the dispersive one on ``torch`` only, the torch ADE ops it runs whatever the backend); ``sweep`` is a
``frequency_sweep`` of ``--members`` frequencies on the vacuum scene (``twopass``: the batched two-pass kernels, one
launch each a step, and, for comparison, the two-pass kernels one launch a member and half-step; ``torch``; a step is
every member's step).  For each scene, backend and dtype it runs a
warm-up chunk, times an unprofiled chunk of ``--steps`` steps on the host
clock (between ``torch.cuda.synchronize()`` calls), then profiles the same
chunk with ``torch.profiler`` (CPU and CUDA activity) and sums the self
device time of every kernel.  One JSON line per (scene, backend, dtype):

- ``wall_ms_per_step``: unprofiled host time per step;
- ``device_ms_per_step``: summed kernel time per step (profiled run);
- ``kernels_ms_per_step``: that sum split by kernel variant (the names of
  the launch counters: ``yee_stream``, ``yee_stream_lossy_sar``,
  ``yee_update_h``, ``yee_update_e_lossy``, ``yee_update_e_ade_sar``,
  ``yee_stream_lossy_sar_dft``, ``dft_accum``, ``yee_stream_shard``, ``yee_stream_pml`` and
  ``yee_stream_pml_interior``: the CPML sweep's shell and interior launches, ...), ``halo_exchange`` (the copies
  of a sharded run's halo planes: the device time of the profiler range ``parallel.mesh.exchange`` opens,
  taken out of ``other``), ``sar_increment`` (the per-step deposition: the ``sar_accum`` kernel on
  ``twopass`` and on the trailing steps of ``stream``, torch ops on ``torch`` and for Debye work: the device
  time of the profiler range ``ops.sar.accumulate_power``, ``diagnostics.accumulate_power`` and
  ``accumulate_work`` open, taken out of ``other``) and
  ``other`` (the source's small launches and, for ``torch``, every
  elementwise kernel of the update);
- ``idle_share_profiled``: 1 - device / profiled wall, both of the same
  profiled chunk (the profiler adds host time per launch, so the share is
  an upper bound of the unprofiled chunk's).

Needs a CUDA device: without one it exits with an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from . import diagnostics, sweep
from .dft import DftConfig, dft_weights, zero_dft_acc
from .ops.cpml import PMLConfig, init_psi
from .ops.dispersive import water_debye_load, zero_polarization
from .ops.stream import INTERIOR
from .ops.stream_plan import variant_name
from .params import Mode, Params, time_values
from .parallel import mesh as shard_mesh
from .runner import initial_state, sharded_runner
from .source import drive_values, make_source_plan
from .state import water_block
from .step import make_chunk_runner, make_step, scan_inputs, zero_power_acc

SCENES = ("vacuum", "heating", "pml", "dispersive", "dft", "shard", "sweep")
PML_CELLS = 10  # the pml scene's slab depth (--pml 10)
DFT_HZ = 2.45e10  # the dft scene's frequency (--dft 2.45e10)
SHARD_SPEC = "4"  # the shard scene's mesh (--shard 4)
# demangled names of the kernels in csrc/ ("::e_kernel<" and not "e_kernel":
# PyTorch's own elementwise_kernel contains the latter), with their template
# flags after the type: pml <T, S, BJ, CR, LOSSY, DFT> (the CPML sweep's
# shell), ring <T, S, BJ, CR, LOSSY, HET, SAR, ADE, DFT, BOX>, h <T, HET,
# BOX>, e <T, LOSSY, BOX>, march <T, E, MAT, PML, AH, BJ, BI, NB, CB, BATCH>
# (the vacuum, batched and CPML passes), ade_e <T, SAR>, dft_accum <T, BOX>;
# BATCH: a sweep's batched launch ("_batch"); BOX: a shard's launch (the counter's name with "_shard"), or in an
# unsharded CPML scene the CPML sweep's interior ("_interior")
_KERNEL = re.compile(r"::(pml_kernel|ring_kernel|march_kernel|h_kernel|e_kernel|ade_e_kernel|dft_accum_kernel)"
                     r"<([^>]*)>")


def scene(n: int, dtype: str) -> Params:
    """configs/bench_256.txt at n^3: dx 1 mm, dt 1 ps, computation mode."""
    return Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=0.001,
                  time_step=1e-12, simulation_time=1e-9, sampling_rate=1000000,
                  mode=Mode.COMPUTATION, dtype=dtype)


def _group(name: str, pml: bool = False, shard: bool = False) -> str:
    """The launch-counter name of a kernel of csrc/, else ``other``
    (``pml``: an unsharded CPML scene, whose box sweeps are the CPML
    sweep's interior; ``shard``: a sharded scene, whose march_kernel
    passes are the shards')."""
    m = _KERNEL.search(name)
    if m is None:
        return "other"
    flags = [a.strip() == "true" for a in m.group(2).split(",")[1:] if a.strip() in ("true", "false")]
    if m.group(1) == "dft_accum_kernel":
        return "dft_accum" + ("_shard" if flags[:1] == [True] else "")
    if m.group(1) == "pml_kernel":
        return variant_name(flags[1], False, False, True, False, flags[2])
    if m.group(1) == "ring_kernel":
        lossy, het, sar, ade, dft, box = flags[1:7]
        if box and pml:
            return variant_name(lossy, het, sar, True, ade, dft) + INTERIOR
        return variant_name(lossy, het, sar, False, ade, dft) + ("_shard" if box else "")
    if m.group(1) == "ade_e_kernel":
        return "yee_update_e_ade" + ("_sar" if flags[0] else "")
    if m.group(1) == "march_kernel":
        e, mat, pml_pass = flags[:3]
        if flags[3:4] == [True]:
            return "yee_update_e_batch" if e else "yee_update_h_batch"
        return ({(False, False): "yee_update_h", (False, True): "yee_update_h_het", (True, False): "yee_update_e",
                 (True, True): "yee_update_e_lossy"}[e, mat] + ("_pml" if pml_pass else "")
                + ("_shard" if shard else ""))
    suffix = "_shard" if flags[1] else ""
    if m.group(1) == "h_kernel":
        return ("yee_update_h_het" if flags[0] else "yee_update_h") + suffix
    return ("yee_update_e_lossy" if flags[0] else "yee_update_e") + suffix


def profile(p: Params, backend: str, steps: int, warm: int, dev: torch.device,
            heating: bool = False, pml: PMLConfig | None = None, debye: bool = False,
            dft: DftConfig | None = None, shard: str | None = None) -> dict:
    tv = time_values(p)[: warm + 2 * steps]
    ts, amps = scan_inputs(p, tv)
    cw, sw = dft_weights(dft, tv) if dft is not None else (None, None)
    mats = water_debye_load(p) if debye else water_block(p) if heating else None
    sar = heating or debye
    s = initial_state(p, dev)
    power = zero_power_acc(p, dev) if sar else None
    psi = init_psi(p, pml, dev) if pml is not None else None
    pol = zero_polarization(p, dev) if debye else None
    dacc = zero_dft_acc(p, dft, dev) if dft is not None else None
    if shard is not None:
        mesh, run_shards = sharded_runner(p, shard, dev, mats, sar, backend, log=lambda m: None, pml=pml, dft=dft)
        shards = shard_mesh.scatter(p, s, mesh, run_shards.depth, power, psi, pml, pol, dacc)
    else:
        run = make_chunk_runner(p, dev, mats, backend, accumulate_power=sar, pml=pml, dft=dft)

    def chunk(a: int, b: int) -> None:
        xs = (ts[a:b], amps[a:b]) + ((cw[a:b], sw[a:b]) if dft is not None else ())
        if shard is not None:
            run_shards(shards, xs)
        else:
            run(s, xs, power, psi, pol, dacc)

    rec = measure(chunk, dev, steps, warm, pml is not None and not shard, shard is not None)
    return {
        "scene": ("dft" if dft is not None else "dispersive" if debye else "heating" if heating
                  else "pml" if pml is not None else "vacuum") + (f" --shard {shard}" if shard else ""),
        "backend": backend, "dtype": p.dtype, "n": p.maxk, "steps": steps, **rec,
    }


def measure(chunk, dev: torch.device, steps: int, warm: int, pml: bool = False, shard: bool = False) -> dict:
    """Time ``chunk(a, b)`` (steps [a, b) of a run) on the host clock and
    under the profiler: a warm-up of ``warm`` steps, an unprofiled chunk of
    ``steps`` and a profiled one; the record's timing keys (the module
    docstring).  ``pml``: an unsharded CPML scene (its box sweeps are the
    CPML sweep's interior); ``shard``: a sharded scene."""
    chunk(0, warm)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    chunk(warm, warm + steps)
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3 / steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        chunk(warm + steps, warm + 2 * steps)
        torch.cuda.synchronize(dev)
        wall_prof = (time.perf_counter() - t0) * 1e3 / steps
    by_group: dict[str, float] = {}
    launches: dict[str, int] = {}
    ranges = {diagnostics.SAR_LABEL: 0.0, shard_mesh.HALO_LABEL: 0.0}
    for ev in prof.key_averages():
        kind = getattr(ev, "device_type", None)
        if ev.key in ranges:
            # the host-side range: the kernels its ops launched (the
            # device-side annotation spans the gaps between them too)
            if kind is None or kind == torch.autograd.DeviceType.CPU:
                total = getattr(ev, "device_time_total", None)
                ranges[ev.key] += (ev.cuda_time_total if total is None else total) / 1e3 / steps
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0 or (kind is not None and kind != torch.autograd.DeviceType.CUDA):
            continue
        g = _group(ev.key, pml, shard)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3 / steps
        launches[g] = launches.get(g, 0) + ev.count
    device = sum(by_group.values())
    for label, ms in ranges.items():
        if ms:
            # the increment's and the copies' kernels are torch kernels, summed in "other"
            by_group[label] = ms
            by_group["other"] = by_group.get("other", 0.0) - ms
    return {
        "wall_ms_per_step": wall, "wall_ms_per_step_profiled": wall_prof,
        "device_ms_per_step": device, "kernels_ms_per_step": by_group,
        "launches_per_step": {g: c / steps for g, c in launches.items()},
        "idle_share_profiled": 1.0 - device / wall_prof,
    }


def profile_sweep(p: Params, members: int, backend: str, steps: int, warm: int, dev: torch.device,
                  batched: bool = True) -> dict:
    """A ``frequency_sweep`` of ``members`` frequencies (2.45e10 Hz and
    up, 5% apart) on ``backend``, measured as :func:`measure` measures a
    chunk (a step: every member's step).  ``twopass``: the batched K1/K2,
    one launch each a step (``batched``), or one launch a member and
    half-step; ``torch``: the torch ops member by member."""
    freqs = [2.45e10 * (1.0 + 0.05 * b) for b in range(members)]
    ts = time_values(p)[: warm + 2 * steps]
    states = sweep.initial_batch(p, members, dev)
    rows = torch.as_tensor(np.stack([drive_values(make_source_plan(dataclasses.replace(
        p, source=dataclasses.replace(p.source, frequency=f))), ts) for f in freqs]), device=dev)
    batched = batched and backend == "twopass"
    if batched:
        step = sweep.batch_step(p, dev)
        amps_t = rows.T.contiguous()

        def chunk(a: int, b: int) -> None:
            for n in range(a, b):
                step(states, amps_t[n])
    else:
        views = [sweep.member(states, b) for b in range(members)]
        steps_ = [make_step(p, dev, backend=backend)] * members

        def chunk(a: int, b: int) -> None:
            sweep.run_steps(steps_, views, ts[a:b], [r[a:b] for r in rows])

    return {"scene": f"sweep x{members}" + (" batched" if batched else ""), "backend": backend, "dtype": p.dtype,
            "n": p.maxk, "steps": steps, **measure(chunk, dev, steps, warm)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fdtd_tpu_torch.profile_chunk", description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256, help="cells per side (default 256)")
    ap.add_argument("--steps", type=int, default=48, help="steps per measured chunk (default 48)")
    ap.add_argument("--warm", type=int, default=8, help="warm-up steps (default 8)")
    ap.add_argument("--scenes", nargs="+", default=list(SCENES), choices=SCENES)
    ap.add_argument("--backends", nargs="+", default=["stream", "twopass", "torch"])
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--members", type=int, default=4, help="members of the sweep scene (default 4)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: profile_chunk measures a CUDA device and none is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    for name in args.scenes:
        for dtype in args.dtypes:
            for backend in args.backends:
                if name == "sweep":
                    for batched in ((True, False) if backend == "twopass" else (False,) if backend == "torch" else ()):
                        rec = profile_sweep(scene(args.n, dtype), args.members, backend, args.steps, args.warm, dev,
                                            batched)
                        print(json.dumps({**rec, "card": card}), flush=True)
                    continue
                # the shard scene: the other scenes on the mesh
                for sub in (SCENES[:5] if name == "shard" else (name,)):
                    if name == "shard" and sub == "dispersive" and backend != "torch":
                        continue
                    rec = profile(scene(args.n, dtype), backend, args.steps, args.warm, dev,
                                  heating=sub in ("heating", "dft"),
                                  pml=PMLConfig(cells=PML_CELLS) if sub == "pml" else None,
                                  debye=sub == "dispersive",
                                  dft=DftConfig((DFT_HZ,)) if sub == "dft" else None,
                                  shard=SHARD_SPEC if name == "shard" else None)
                    rec["card"] = card
                    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
