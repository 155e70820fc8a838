#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fdtd_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It fails (non-zero exit, no result line) without CUDA or without the
package beside it.  Phases, each printing one line or more:

1. the device: nvidia-smi name and power limit, torch/CUDA/nvcc versions;
2. the build of the Hopper kernels from csrc/, one nvcc per source and
   one for the sweeps' means mode (yee_stream.cu with YEE_STREAM_FOLD), all
   started together (seconds, ptxas report);
3. each kernel against its plain torch version on the card, fp32 and bf16,
   both modes, random fields on a non-cubic non-integer box with the source
   patch, and the TE101 seed on the non-integer box whose i=maxi Ey column
   is non-zero: max |diff| must be 0.  The stream kernel at s = 8, 4 and 2
   (tiles that do not divide the box), and one sweep at 256^3 with the
   main path's plan.  The material variants on a water block + ferrite
   slab scene on the same box: the het-mu H and lossy E kernels in both
   modes, and the four stream variants (lossy, lossy + SAR, lossy + het,
   lossy + het + SAR) in computation mode at s = 8, 4, 2, fields and the
   SAR accumulator; one heating sweep at 256^3 with each SAR plan; the
   two-pass CPML passes (march_kernel) also with 24-cell walls, where the
   source patch reaches into the j slabs, and at 257^3 with --pml 10
   (vacuum and the ferrite scene), fields and psi from random psi; bf16
   on 64^3 (65-wide rows that start on odd elements, the arrays' last
   element even): every stream variant at s = 8, 4, 2 and the Debye sweeps;
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
6. the heating path at full size: the CLI on configs/heating_256.txt
   --water-block --sar (auto picks stream; sar.vtr written, peak > 0),
   the same scene through run_simulation with twopass and with stream
   (1000 steps; launch counts; fields and SAR equal bit for bit), then 66
   steps (16 sweeps and 2 trailing two-pass steps with their SAR) of
   stream, twopass and torch with --ferrite-slab added (SAR on), and of
   stream and twopass without SAR (water, water + ferrite), from random
   fields; twopass's peak device memory against its model, and the model
   at 1024^3 fp32 (stream refused, twopass fits the free memory);
6b. the CPML path (--pml 10) at full size: the CPML kernels of phase 3
   (the two-pass variants vacuum and het-mu + lossy with a load reaching
   into the absorber, both modes; the sweep vacuum and lossy at s = 2, the
   one depth it is built at, both its launches (the psi-free interior on
   the K3 sweep, the shell on pml_kernel), and at the --pml 10 plan at
   256^3; fields and all twelve psi, from random psi so every term is
   engaged) are checked bit for bit first; then the CLI on
   configs/bench_256.txt --pml 10 at a sampling rate of 500 (auto picks
   stream; snapshots and a radiated_W log), the same scene through
   run_simulation with twopass and with stream in fp32 and bf16 (1000
   steps; launch counts; auto must pick stream exactly in the dtypes where
   it ran faster) and with torch in fp32 (fields and psi equal to twopass's
   and stream's bit for bit), 64 steps of stream, twopass
   and torch with --water-block from random fields, 66 steps of twopass and
   torch with --water-block --ferrite-slab --sar (auto: twopass), the
   absorption test of tests/test_pml.py through twopass and the gaussian
   ring-down through stream and twopass (24^3, where the source clears the
   slabs), and the allocator's peak over one snapshot and one log record
   at 256^3 in forced k slabs against the model;
6c. the Debye path (--water-block --dispersive --sar) at full size: the
   ADE kernels of phase 3 (the two-pass ADE E pass with and without its
   SAR work, and the ADE sweep with and without SAR at the depth each is
   built at, ragged tiles and the 256^3 plans; fields, P and the SAR map,
   from random P) are checked bit for bit first; then the CLI on
   configs/heating_256.txt --water-block --dispersive --sar (auto picks
   stream; sar.vtr written), the same scene through run_simulation with
   twopass and with stream (1000 steps; launch counts; fields, P and SAR
   equal bit for bit), 66 steps without SAR and 67 with it of stream,
   twopass and torch (each with trailing two-pass steps), twopass's peak
   device memory against its model and the verdicts at 512^3 and 1024^3,
   and Debye x CPML on the card (torch ops: a 256^3 --pml 10 run, finite,
   and the ring-down of tests/test_dispersive.py at 32^3, absorbing);
6d. the monitor path (--dft, --probe) at full size: the dft_accum kernel
   (fp32 and bf16, nf = 1, 2 and 3, ragged and 256^3) and the DFT bands of
   every sweep variant (fp32 and bf16, nf = 1 and 2, ragged tiles and the
   256^3 plans; fields, sums from random starting sums, SAR map, psi and
   P) against their plain versions bit for bit; then the CLI on
   configs/heating_256.txt --water-block --sar --dft 2.45e10 (auto picks
   the lossy + SAR sweep with the bands; dft_00.vtr and sar.vtr), 1000
   steps of the heating scene, of --pml 10 (fp32 and bf16; auto held to
   the faster backend, each the median of three runs in turns; fp32 on
   torch too) and of the Debye scene with
   --dft 2.45e10 through stream and through twopass + dft_accum (launch
   counts; phasors, fields, SAR, psi and P equal bit for bit), 66 or 67
   steps of every variant with nf = 2 (trailing two-pass steps with
   dft_accum) through stream, twopass and torch, and three probes with
   --dft-fields eh on twopass and torch (bit for bit; the CLI's
   probes.csv layout with two);
6e. the DFT bands' means mode (more frequencies than a block's shared
   memory holds; ``phase_means``): the fold kernel against plain_fold
   (random means and sums, 1 to 33 frequencies, 1 to 32 levels, nc 3 and
   6, the whole grid and each shard's part of ragged 1-D and 2-D meshes);
   each means-mode sweep (the nine variants, ragged tiles; the five
   shard variants on ragged 4-slab and 2 x 3 meshes) against plain_sweep,
   fp32 and bf16, fields, buffer, map, psi, P; shards too thin for the
   s = 4 halo (four planes) with 3 to 5 frequencies: the vacuum bands at
   s = 2 against plain_sweep, and routed, against twopass + dft_accum;
   128^3 with 16 frequencies over 2.40e10-2.50e10 Hz on vacuum, heating +
   SAR, --pml 10 and Debye + SAR (auto picks the means mode), fp32 bit for
   bit to twopass + dft_accum and bf16 to the bands run in groups of
   frequencies, with launch counts and Mcells/s (each runner warmed by a
   chunk, then three runs of 1000 steps in turns against twopass +
   dft_accum: the median and the spread); vacuum and heating with --shard
   4 against the unsharded runs; every variant with six frequencies
   through stream, twopass and torch (67 steps); the CLI on
   configs/bench_256.txt --dft with four frequencies (1000 steps, auto)
   against twopass + dft_accum's sums; heating_256 --water-block --sar
   --dft --shard 4 against twopass + dft_accum with three frequencies (the
   bands hold them) and eight (each shard's means mode and fold at full
   size); the means-mode kernels' and the fold's
   times at 128^3 beside their bounds, plain versions and (the fold)
   torch.addmm, and the bands against the means mode at one frequency; at
   256^3 (the fold at 3, 4, 5, 6 and 16 frequencies and 32 levels,
   against plain_fold bit for bit and beside torch.addmm; K3-DFT, K11-DFT
   and K11-lossy-DFT means) with, where a
   checkout of PARENT is present, the parent's kernels in turns (parent,
   this, this, parent); one counted 1000-step chunk of bench_256 --pml 10
   --dft x6 (shell, interior and fold launches) against twopass +
   dft_accum bit for bit (fields, psi, sums); the routed bench_256 --dft x4
   (CLI) and bench_256 --pml 10 --dft x6 against twopass + dft_accum, the
   median of three warmed runs in turns with their spread;
6f. the per-step SAR increment kernel (``phase_sar``, ``sar_accum``):
   against diagnostics.accumulate_power on the card bit for bit at 64^3
   and 256^3, fp32 and bf16, the whole grid and a middle slab of --shard
   4, from random fields, sigma and map; its 256^3 times beside its byte
   bound and the plain torch ops'; heating_256 --water-block --sar, 1000
   steps, on twopass (a sar_accum launch a step), torch (none) and
   twopass --shard 4 (four sar_accum_shard a step), fields and map equal
   bit for bit;
7. the sharded path (--shard): every per-shard kernel (K1/K2-shard,
   vacuum and the material variants; K3-shard, vacuum, lossy, lossy + SAR,
   het, het + SAR at s = 8, 4, 2) against its plain version on every shard
   of 4-slab, 3-slab (fp32) and 2 x 3 meshes (ragged shards, both modes,
   fp32 and bf16; bf16 on a 4-slab of 64^3, ni = 65) and of the 256^3 shard plans, owned cells bit for bit; 1000 steps
   of configs/bench_256.txt with --shard 4 and --shard 2x2 on auto, stream
   and twopass, and of the heating scene with --shard 4 on stream and
   twopass, equal to the unsharded runs bit for bit (fields, SAR map),
   with launch counts and Mcells/s; the other loads on 4 slabs (66 steps),
   512^3 with --shard 4 (16 steps); the CLI (bench_256 at a sampling rate
   of 500 and the heating scene with --shard 4 write the unsharded
   snapshots, sar.vtr and energy log); the halo copies' time per sweep and
   step; each shard kernel's time on a middle slab of --shard 4 beside its
   plain version;
7b. CPML, Debye media and the monitors under --shard: K10-shard (H and E,
   vacuum and het-mu / lossy, from random psi: a 10-cell absorber whose k
   and j slabs straddle shards), K4-shard (nf = 1, 2, 3) and K3-shard-DFT
   (the five shardable variants, nf = 1 and 2, from random sums and map)
   against their plain versions on every shard of 4-slab, 3-slab (fp32)
   and 2 x 3 meshes (ragged, both modes, fp32 and bf16) and of the 256^3 geometries,
   bit for bit; 1000 steps with --shard 4 of bench_256 --pml 10, the
   heating scene with --dft 2.45e10 (auto: the sweep with the bands, and
   twopass + dft_accum), bench_256 --pml 10 --dft 2.45e10, the Debye scene
   (torch ops) and three probes with --dft-fields eh, each equal to its
   unsharded run bit for bit (fields, SAR map, psi, P, phasors, probe
   rows) with launch counts, Mcells/s and the allocator's peak against
   stream_plan.shard_bytes; the CPML load and the DFT variants (nf = 2) on
   4 slabs (66 steps); the CLI with --shard 4 --pml 10 and with the heating
   scene's --dft 2.45e10 writing the unsharded snapshots, dft_00.vtr,
   sar.vtr and energy log; each new shard kernel's time on a middle slab of
   --shard 4 beside its plain version;
10. (after 7b, before 8) the thermal solve, the coupled cook and the
   sweeps: run_thermal on phase 6's 256^3 heating SAR map (normalized to
   1 kW, a 2 s cook, fp64 and fp32: the fp64 heat content equals Q t to
   1e-5, fp32 within 2^-14 of the peak rise of fp64), the thermal step's
   time beside its byte bound; the CLI's coupled cook
   configs/heating_256.txt --water-block --sar --coupled 3 --thermal 10
   --thermal-power 1000 on auto (the lossy + SAR sweep, 3 x 250 launches,
   interval checkpoints) and on twopass: temperature.vtr,
   temperature_NN.vtr and coupled.jsonl equal byte for byte, each
   interval's materials build, update_coefs, EM run and thermal solve
   timed; the cook resumed from its checkpoint after interval 2 equal to
   the uninterrupted one; --rotate 10 --load-center 0.35,0.5 over 2
   intervals (both frames, angles 150 and 450 degrees); then
   frequency_sweep(backend="pallas_fused") of 4 members at 256^3, 200
   steps through the batched K1/K2 (march_kernel with BATCH; 200 launches
   each), equal bit for bit to four single twopass runs; the batched
   kernels against their plain versions and the per-member kernels (a
   ragged 35 x 29 x 31 x 8 batch: narrow tiles, edge blocks and every
   lead of a 16-byte chunk, the members' leads against
   stream_plan.member_lead; 64^3 x 8 and 256^3 x 4; fp32 and bf16) and
   their times beside the per-member launches' with their bound shares;
   the device's idle share of a sweep, batched and per member (64^3 x 8,
   256^3 x 4);
8. timing at 256^3: Mcells/s of stream, twopass and torch in fp32 and
   bf16, vacuum, heating, --pml 10 and dispersive, without and with --dft
   (nf = 1), and each kernel's time beside its plain version's and its
   bound (a CPML sweep's entry: both its launches; its "_interior" entry:
   the interior's launch alone, timed without the shell's), and every
   vacuum stream plan's; one line per redesigned sweep (ring_kernel, K3 and
   K12) with its time a step beside the first design's (commit 04e00ef),
   its registers and spills, and the 1000-step stream rates of phases
   5-6d beside the first design's, and the 1000-step --pml 10 rates of
   both backends;
9. machine code: python -m fdtd_tpu_torch.sass_compare against a checkout
   of the parent commit, PARENT (from the repository's git history, else
   scratch_chip/parent; compiled on the host from the end of phase 2 on,
   beside the card's phases): every kernel of the default builds but the
   parent's fold (dft_fold_kernel, redesigned) keeps its instructions,
   each listed (the means mode's FOLD instantiations are a build of their
   own and not compared).  Without such a checkout it says so and skips the
   comparison (and phase 6e's runs of the parent's kernels).

Each phase prints its seconds; the Debye maps (host fp64, several
seconds at 256^3) are built once per dtype (phase 3) and passed to the
runners.  Phase 5 runs the CLI as ``python -m fdtd_tpu_torch`` in a
process of its own; the later CLI runs call its entry point (``cli.main``)
in this process, output captured, so that each does not pay the start-up
of Python, torch and a CUDA context again.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_TIMED = 48  # steps per timed run (a multiple of every steps-per-sweep)
N_WARM = 8
N_LOADS = 66  # steps of the load comparisons at 256^3 (not a multiple of the sweep's s)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PML_STEPS_RINGDOWN = 1200  # the gaussian ring-down of tests/test_pml.py
THERMAL_WATTS = 1000.0  # phase 10: the heating SAR map normalized to a 1 kW magnetron
THERMAL_COOK_S = 2.0  # phase 10: the thermal solve's cook (about 330 steps)
THERMAL_FP32_BAR = 2.0**-14  # phase 10: fp32 against fp64 rise, of the peak rise
SWEEP_MEMBERS = 4  # phase 10: the 256^3 frequency sweep's members
# phases 7 and 7b: the meshes of the shard kernels' checks on ragged boxes
SHARD_MESHES = {"float32": ((4, 1, 1), (3, 1, 1), (2, 3, 1)), "bfloat16": ((4, 1, 1), (2, 3, 1))}
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
# the sweeps' first design (commit 04e00ef), measured by this script on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md kernel table): steps a sweep and
# fp32 ms a sweep at 256^3 (a shard's: a middle slab of --shard 4), and the
# 1000-step stream rates in Mcells/s
FIRST_SWEEPS = {
    "yee_stream": (4, 0.98256), "yee_stream_lossy": (4, 1.87572), "yee_stream_lossy_sar": (4, 3.19993),
    "yee_stream_lossy_het": (4, 2.24609), "yee_stream_lossy_het_sar": (4, 3.67390), "yee_stream_dft": (4, 2.56431),
    "yee_stream_lossy_dft": (4, 3.81382), "yee_stream_lossy_sar_dft": (4, 4.41382),
    "yee_stream_lossy_het_dft": (4, 4.30844), "yee_stream_lossy_het_sar_dft": (4, 5.02964),
    "yee_stream_ade": (4, 3.12060), "yee_stream_ade_sar": (2, 2.98542), "yee_stream_ade_dft": (4, 5.89640),
    "yee_stream_ade_sar_dft": (2, 4.15782), "yee_stream_shard": (4, 0.28770), "yee_stream_lossy_shard": (4, 0.55776),
    "yee_stream_lossy_sar_shard": (4, 0.91300), "yee_stream_lossy_het_shard": (4, 0.67459),
    "yee_stream_lossy_het_sar_shard": (4, 1.13420), "yee_stream_dft_shard": (4, 0.68137),
    "yee_stream_lossy_dft_shard": (4, 1.08552), "yee_stream_lossy_sar_dft_shard": (4, 1.24542),
    "yee_stream_lossy_het_dft_shard": (4, 1.21617), "yee_stream_lossy_het_sar_dft_shard": (4, 1.38074),
}
FIRST_RATES = {"bench_256 stream": 68203.0, "heating_256 stream": 20775.8,
             "heating_256 --water-block --dispersive --sar stream": 11059.1,
             "heating_256 --water-block --sar --dft 2.45e10 stream": 14784.8}
# auto's --pml 10 routing at 256^3 (phase 6b): two backends whose 1000-step
# rates, each the mean of two runs in turns, differ by less than this share of
# the faster are tied, and auto's rule (stream) stands.  With the march core
# twopass and stream run bf16 --pml 10 within 0.4-0.9% of each other, and a
# backend's own 1000-step rate moved by up to 1.05% from one smoke to the next
# on an NVIDIA H100 80GB HBM3 at 700 W
ROUTE_TIE = 0.02
# the parent commit, whose machine code phase 9 compares with and whose
# means-mode kernels phase 6e times beside this tree's
PARENT = "93353f4"
# phase 6e: the means mode of the DFT bands and the fold kernel
MEANS_N = 128  # the grid of the 16-frequency scenes: configs/heating_256.txt scaled to 128^3
MEANS_FREQS = tuple(2.40e10 + k * (1e9 / 15) for k in range(16))  # 16 frequencies over 2.40e10-2.50e10 Hz
MEANS_STEPS = 200  # steps of those scenes (two chunks of the config's 100-step sampling rate)
MEANS_NF = 6  # frequencies of the kernel checks and the every-variant runs: past every built shape's bands
RATE_STEPS = 1000  # the 16-frequency scenes' timed runs: steps a run, after a chunk that warms the runner
RATE_REPS = 3  # and runs of each backend, in turns; the median and the spread are reported
MEANS_256_NF = (3, 4, 5, 6, 16)  # the 256^3 folds' frequencies (32 levels): 3-6, where the means mode starts
PML_DFT_NF = 6  # bench_256 --pml 10 --dft: frequencies past the CPML bands' five
THIN_NF = (3, 4, 5)  # shards too thin for the s = 4 halo: frequencies past its bands that the s = 2 bands hold
RAGGED_BATCH = 8  # phase 10: members of the ragged batch (35 x 29 x 31 a member, odd: 8 members take every lead)


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


def run_cli(args: list[str], cli=None) -> subprocess.CompletedProcess:
    """``python -m fdtd_tpu_torch ARGS`` run in this process (``cli.main``,
    the module's entry point; ``cli``: another checkout's), its output
    captured: a process of its own would pay Python's, torch's and the CUDA
    context's start-up (several seconds) again for every run.  Phase 5 runs
    the module in a process."""
    import io
    import traceback

    import torch

    if cli is None:
        from fdtd_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(args)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        except Exception:  # reported as a failing exit, as the module's process would
            traceback.print_exc()
            rc = 1
    torch.cuda.empty_cache()
    return subprocess.CompletedProcess(["fdtd_tpu_torch", *args], rc, out.getvalue(), err.getvalue())


def absdiff(x, y) -> float:
    """Largest |x - y| of two tensors, a NaN counted as inf (``max`` over
    floats would drop it)."""
    import torch

    return float(torch.nan_to_num((x.float() - y.float()).abs(), nan=math.inf).max())


def maxdiff(a, b) -> float:
    """Largest |a - b| over the tensors of two states (or P or psi sets, or
    tuples of tensors)."""
    ta, tb = (x.tensors() if hasattr(x, "tensors") else tuple(x) for x in (a, b))
    return max(absdiff(x, y) for x, y in zip(ta, tb))


def event_ms(fn, reps=20, queued=True) -> float:
    """Milliseconds a call of ``fn`` keeps the card busy, over ``reps``
    calls between two CUDA events.  ``queued``: a spin kernel (about 25 ms)
    runs first, so the calls are all enqueued before the first event starts
    and the host's time per launch (tens of microseconds for a shard
    kernel's wrapper) is not counted; without it the events take the host's
    pace too (the halo copies: a launch a copy)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_means(dev, smi: str, rng, n: int = MEANS_N, steps: int = MEANS_STEPS, full_size: bool = True,
                water256=None, parent=None) -> list[dict]:
    """Phase 6e: the means mode of the sweeps' DFT bands (``StreamPlan.
    fold``) and the fold kernel (``csrc/dft_accum.cu::dft_fold_kernel``).
    The fold against ``plain_fold`` from random means, weights and sums; each
    means-mode instantiation (the nine sweep variants, ragged tiles, and
    the five shard variants on ragged 1-D and 2-D meshes) against its plain
    sweep, from random fields, psi, P and map; the 16-frequency scenes at
    ``n``^3 (vacuum, heating + SAR, --pml 10, Debye + SAR; fp32 and bf16),
    which auto sends to the means mode, through their chunk runners:
    fp32 against twopass + dft_accum bit for bit, bf16 against the bands
    (the frequencies in groups the bands hold) bit for bit, each with its
    Mcells/s beside twopass + dft_accum's (:func:`time_turns`); vacuum and
    heating with --shard 4 against the unsharded runs; shards too thin for
    the s = 4 halo on the s = 2 bands (``THIN_NF``); every variant with six
    frequencies through stream, twopass and torch; with ``full_size`` the
    CLI on configs/bench_256.txt --dft with four frequencies (auto, 1000
    steps; its dft_NN.vtr against twopass + dft_accum's sums) and
    heating_256 --water-block --sar --dft --shard 4 with three frequencies
    (the bands) and eight (the means mode) against twopass + dft_accum
    (``water256``: the scene's load, built once); then at 256^3 the fold
    (3-6 and 16 frequencies) beside torch.addmm, the K3-DFT, K11-DFT and
    K11-lossy-DFT means sweeps, each beside ``parent``'s (the PARENT
    checkout's package, when there is one) in turns, one counted chunk of
    bench_256 --pml 10 --dft x6 against twopass + dft_accum bit for bit, and
    the routed rates of bench_256 --dft x4 and --pml 10 --dft x6 against
    twopass + dft_accum.
    Returns the JSON rows of the kernels it drives on those paths, timed at
    the ``n``^3 scenes' shapes beside their bounds and plain versions (the
    fold beside torch.addmm)."""
    import numpy as np
    import torch

    from fdtd_tpu_torch import cli
    from fdtd_tpu_torch.convert import state_from_numpy
    from fdtd_tpu_torch.dft import DftConfig, dft_weights, zero_dft_acc
    from fdtd_tpu_torch.grid import COMPONENTS, Box
    from fdtd_tpu_torch.io.vtr import read_vtr_cell_arrays
    from fdtd_tpu_torch.ops import dft as dft_ops
    from fdtd_tpu_torch.ops import stream, stream_plan, yee
    from fdtd_tpu_torch.ops.cpml import E_TERMS, H_TERMS, PMLConfig, PsiState, init_psi, make_cpml, psi_shapes
    from fdtd_tpu_torch.ops.dispersive import (DebyeMaterials, PolState, debye_coefs, water_debye_load,
                                               zero_polarization)
    from fdtd_tpu_torch.parallel import mesh as shard_mesh
    from fdtd_tpu_torch.parallel import sharded_fast
    from fdtd_tpu_torch.parallel.sharded_step import shard_coefs
    from fdtd_tpu_torch.params import Mode, Params, load_parameters, time_values
    from fdtd_tpu_torch.runner import initial_state, resolve_backend
    from fdtd_tpu_torch.source import apply_source, make_source_plan, profile_tensor, sweep_drive_rows
    from fdtd_tpu_torch.state import FieldState, ferrite_slab, field_dtype, update_coefs, water_block
    from fdtd_tpu_torch.step import make_chunk_runner, scan_inputs, zero_power_acc

    t_phase = time.perf_counter()
    err: dict[str, float] = {}  # kernel -> max|diff| against its plain version
    launches: dict[str, int] = {}  # kernel -> launches on its path's run
    paths: dict[str, str] = {}
    nan = float("nan")
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)

    def note(name: str, d: float) -> None:
        err[name] = max(err.get(name, 0.0), d)

    def counts_now() -> dict:
        return {**yee.launches, **stream.launches, **dft_ops.launches}

    def reset_counts() -> None:
        yee.reset_launches()
        stream.reset_launches()
        dft_ops.reset_launches()

    def rand(shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def sums_like(nf: int, cells: tuple, nc: int = 3) -> tuple:
        return tuple(rand((nf, nc) + tuple(cells)) for _ in range(2))

    # -- (a) the fold against plain_fold ---------------------------------------------------------
    def grid(k: int, j: int, i: int) -> Params:
        """A computation-mode grid of k x j x i cells."""
        return Params(length=(i + 0.5) * 1e-3, width=(j + 0.5) * 1e-3, height=(k + 0.5) * 1e-3, spatial_step=0.001,
                      time_step=1e-12, simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION,
                      dtype="float32")

    fold_grids = [(grid(35, 29, 31), ((1, 1, 3), (5, 7, 3), (16, 32, 3), (33, 32, 6)), ((4, 1, 1), (2, 3, 1)))]
    fold_grids.append((grid(n, n, n), ((4, 32, 3), (16, 32, 3)), ((4, 1, 1),)))
    for pf, cases, meshes in fold_grids:
        cells = (pf.maxk, pf.maxj, pf.maxi)
        means = rand(stream.means_shape(pf, stream_plan.FOLD_DEPTH))
        for nf, depth, nc in cases:
            w = rand((depth, 2, nf))
            d0 = sums_like(nf, cells, nc)
            k, q = tuple(t.clone() for t in d0), tuple(t.clone() for t in d0)
            dft_ops.fold(means, w, k)
            dft_ops.plain_fold(means, w, q)
            torch.cuda.synchronize()
            d = maxdiff(k, q)
            moved = float((q[0][:, :3] - d0[0][:, :3]).abs().max())
            kept = maxdiff((k[0][:, 3:], k[1][:, 3:]), (d0[0][:, 3:], d0[1][:, 3:])) if nc == 6 else 0.0
            # each shard folds its cells' buffer into its part of the sums: the whole grid's sums there
            ds = 0.0
            for shape in meshes:
                for box in shard_mesh.shard_boxes(pf, shard_mesh.make_mesh(shape, dev.type), 1):
                    part = (slice(None),) * 2 + tuple(slice(a, b) for a, b in zip(*box.cells(pf)))
                    ks = tuple(t[part].contiguous() for t in d0)
                    dft_ops.fold(means[part].contiguous(), w, ks)
                    torch.cuda.synchronize()
                    ds = max(ds, maxdiff(ks, tuple(t[part] for t in q)))
            note("dft_fold", max(d, kept, ds))
            check(d == 0.0 and kept == 0.0 and ds == 0.0 and moved > 0,
                  f"dft_fold == plain_fold, {cells} cells, nf={nf}, {depth} levels, nc={nc}: max|diff| = {d!r} "
                  f"(H components kept: {kept!r}; the shards of {meshes} meshes: {ds!r}; sums moved {moved!r})")
            del d0, k, q
        del means

    # -- (b) each means-mode instantiation against its plain sweep -------------------------------
    def sweep_inputs(pm: Params, arrays: dict, s: int, box=None, st=None):
        """The state with step 1 hard-set (a shard's: ``st``) and the sweep's drive."""
        dt = field_dtype(pm)
        st = state_from_numpy(arrays, dev, dt) if st is None else st
        src = make_source_plan(pm)
        amps = torch.tensor(rng.uniform(-1.0, 1.0, s), dtype=torch.float64, device=dev)
        prof = profile_tensor(src, dev)
        apply_source(src, st, amps[0], prof, box)
        ez_rows, hx_rows = sweep_drive_rows(src, amps, s, dt, prof)
        return st, stream.SweepDrive(src.patch, ez_rows[0], hx_rows[0])

    def random_psi(pm: Params, cfg: PMLConfig) -> PsiState:
        shapes = psi_shapes(pm, cfg)
        return PsiState(**{t: rand(shapes[t], -1e-2, 1e-2).to(field_dtype(pm)) for t in PsiState.names()})

    def random_pol(pm: Params, dc) -> PolState:
        return PolState(*(torch.where(dc.k2[c] > 0, rand(pm.padded_shape, -1e-9, 1e-9).to(field_dtype(pm)), 0.0)
                          for c in "xyz"))

    def check_sweep(pm: Params, arrays: dict, label: str, mats=None, sar: bool = False, pml=None, dc=None):
        """One means-mode sweep against plain_sweep: fields, the buffer's
        levels, the SAR map, psi and P (from random psi, P and map)."""
        cfg = DftConfig(MEANS_FREQS[:MEANS_NF])
        coefs = update_coefs(pm, None if dc is not None else mats, dev)
        plan = stream_plan.pick_plan(pm, lossy=coefs.lossy, het=coefs.heterogeneous_mu, sar=sar, pml=pml,
                                     ade=dc is not None, dft=cfg)
        st, drive = sweep_inputs(pm, arrays, plan.s)
        cp = make_cpml(pm, pml, coefs, dev) if pml is not None else None
        psi = random_psi(pm, pml) if pml is not None else None
        pol = random_pol(pm, dc) if dc is not None else None
        acc0 = rand((pm.maxk, pm.maxj, pm.maxi), 0.0, 1e-11) if sar else None
        mshape = stream.means_shape(pm, plan.s)

        def outs(fill: float):
            return (FieldState(*(torch.full_like(t, fill) for t in st.tensors())),
                    PsiState(*(torch.full_like(t, fill) for t in psi.tensors())) if psi is not None else None,
                    PolState(*(torch.full_like(t, fill) for t in pol.tensors())) if pol is not None else None,
                    acc0.clone() if sar else None, torch.full(mshape, fill, device=dev))

        ko, po = outs(nan), outs(0.0)
        stream.sweep(pm, st, ko[0], coefs, plan, drive, ko[3], cp, psi, ko[1], dc, pol, ko[2], means=ko[4])
        stream.plain_sweep(pm, st, coefs, plan.s, drive, po[0], po[3], cp, psi, po[1], dc, pol, po[2], means=po[4])
        torch.cuda.synchronize()
        d = max(maxdiff(ko[0], po[0]), absdiff(ko[4], po[4]), maxdiff(ko[1], po[1]) if psi is not None else 0.0,
                maxdiff(ko[2], po[2]) if pol is not None else 0.0, absdiff(ko[3], po[3]) if sar else 0.0)
        note(plan.kernel, d)
        if plan.core is not None:
            note(plan.kernel + stream.INTERIOR, d)
        K1, J1, I1 = pm.padded_shape
        ragged = bool(K1 % plan.tk or J1 % plan.tj or I1 % plan.ti)
        check(plan.fold > 0 and d == 0.0 and float(po[4].abs().max()) > 0,
              f"{plan.kernel} == plain_sweep (means mode), s={plan.s} tile (k,j,i)=({plan.tk},{plan.tj},{plan.ti}) "
              f"{plan.blocks} blocks{' (ragged)' if ragged else ''}, {label}: fields, means"
              f"{', map' if sar else ''}{', psi' if psi else ''}{', P' if pol else ''} max|diff| = {d!r}")

    def check_shards(pk: Params, arrays: dict, shape: tuple, label: str, mats=None, sar: bool = False):
        """Every shard's means-mode sweep (at the picker's depth for the
        mesh) against plain_sweep on the shard's arrays: owned cells, the
        shard's buffer levels and map part."""
        cfg = DftConfig(MEANS_FREQS[:MEANS_NF])
        mesh = shard_mesh.make_mesh(shape, dev.type)
        host = update_coefs(pk, mats, "cpu")
        plans = sharded_fast.pick_shard_plan(pk, mesh, None, host.lossy, host.heterogeneous_mu, sar, {}, cfg)
        s = plans[0].s
        canon = state_from_numpy(arrays, dev, field_dtype(pk))
        acc0 = rand((pk.maxk, pk.maxj, pk.maxi), 0.0, 1e-11) if sar else None
        shards = shard_mesh.scatter(pk, canon, mesh, s + 1, acc0)
        d = 0.0
        for sh, plan in zip(shards, plans):
            cf = shard_coefs(pk, host, sh.box, dev)
            st, drive = sweep_inputs(pk, None, s, sh.box, sh.state.clone())
            mshape = stream.means_shape(pk, s, sh.box)
            out, want = (FieldState(*(torch.full_like(t, nan) for t in st.tensors())) for _ in range(2))
            mk, mp = torch.full(mshape, nan, device=dev), torch.zeros(mshape, device=dev)
            aa, ab = (sh.power.clone(), sh.power.clone()) if sar else (None, None)
            stream.sweep(pk, st, out, cf, plan, drive, aa, box=sh.box, means=mk)
            stream.plain_sweep(pk, st, cf, s, drive, want, ab, box=sh.box, means=mp)
            torch.cuda.synchronize()
            d = max(d, max(absdiff(x[sh.box.owned], y[sh.box.owned]) for x, y in zip(out.tensors(), want.tensors())),
                    absdiff(mk, mp), absdiff(aa, ab) if sar else 0.0)
        name = plans[0].kernel + "_shard"
        note(name, d)
        check(plans[0].fold > 0 and d == 0.0,
              f"{name} == plain_sweep on every shard of a {shape} mesh at s={s}, {label}: owned cells, means"
              f"{', map' if sar else ''} max|diff| = {d!r}")

    def check_thin_shards(pt: Params, arrays: dict, nf: int, label: str) -> None:
        """Shards too thin for the s = 4 halo: every shard's vacuum sweep
        with the bands at s = 2 (yee_stream_dft_shard on the CPML interior's
        box instantiation, nf within its cap) against plain_sweep on the
        shard's arrays: owned cells and the shard's sums."""
        cfg = DftConfig(MEANS_FREQS[:nf])
        mesh = shard_mesh.make_mesh((4, 1, 1), dev.type)
        host = update_coefs(pt, None, "cpu")
        plans = sharded_fast.pick_shard_plan(pt, mesh, None, dft=cfg)
        s = plans[0].s
        shards = shard_mesh.scatter(pt, state_from_numpy(arrays, dev, field_dtype(pt)), mesh, s + 1, None, None,
                                    None, None, sums_like(nf, (pt.maxk, pt.maxj, pt.maxi)))
        d = 0.0
        for sh, plan in zip(shards, plans):
            cf = shard_coefs(pt, host, sh.box, dev)
            st, drive = sweep_inputs(pt, None, s, sh.box, sh.state.clone())
            wts = rand((s, 2, nf))
            out, want = (FieldState(*(torch.full_like(t, nan) for t in st.tensors())) for _ in range(2))
            da, db = tuple(t.clone() for t in sh.dacc), tuple(t.clone() for t in sh.dacc)
            stream.sweep(pt, st, out, cf, plan, drive, dacc=da, wts=wts, box=sh.box)
            stream.plain_sweep(pt, st, cf, s, drive, want, dacc=db, wts=wts, box=sh.box)
            torch.cuda.synchronize()
            d = max(d, max(absdiff(x[sh.box.owned], y[sh.box.owned]) for x, y in zip(out.tensors(), want.tensors())),
                    maxdiff(da, db))
        name = plans[0].kernel + "_shard"
        check((name, s, plans[0].fold) == ("yee_stream_dft_shard", 2, 0) and d == 0.0,
              f"{name} == plain_sweep on every shard of a 4-slab mesh at s={s} (shards of "
              f"{[sh.box.own_hi[0] - sh.box.own_lo[0] for sh in shards]} planes), {label}: owned cells, sums "
              f"max|diff| = {d!r}")

    pml_check = PMLConfig(cells=6)
    for dtype in ("float32", "bfloat16"):
        pr = Params(length=0.0615, width=0.0505, height=0.0705, spatial_step=0.001, time_step=1e-12,
                    simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype=dtype)
        arrays = {c: rng.uniform(-1.0, 1.0, pr.padded_shape) for c in COMPONENTS}
        wb, fe = water_block(pr), ferrite_slab(pr, base=water_block(pr))
        wide = water_block(pr, lo=(0.02,) * 3, hi=(0.98,) * 3)
        dm = water_debye_load(pr, lo=(0.05,) * 3, hi=(0.95,) * 3, sigma_ion25=0.5)
        dc = debye_coefs(pr, dm, dev)
        lab = f"{dtype} random {pr.padded_shape} nf={MEANS_NF}"
        check_sweep(pr, arrays, lab)
        check_sweep(pr, arrays, lab + " water", wb)
        check_sweep(pr, arrays, lab + " water + SAR", wb, True)
        check_sweep(pr, arrays, lab + " water + ferrite", fe)
        check_sweep(pr, arrays, lab + " water + ferrite + SAR", fe, True)
        check_sweep(pr, arrays, lab + " CPML", pml=pml_check)
        check_sweep(pr, arrays, lab + " water into the CPML slabs", wide, pml=pml_check)
        check_sweep(pr, arrays, lab + " Debye", dm, dc=dc)
        check_sweep(pr, arrays, lab + " Debye + SAR", dm, True, dc=dc)
        # K, J, I = 34, 26, 30: 35 planes over 4 (9, 9, 9, 8); 2 x 3: j over 3
        pk = Params(length=0.0305, width=0.0265, height=0.0345, spatial_step=0.001, time_step=1e-12,
                    simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype=dtype)
        arrays_k = {c: rng.uniform(-1.0, 1.0, pk.padded_shape) for c in COMPONENTS}
        wb_k = water_block(pk)
        fe_k = ferrite_slab(pk, base=water_block(pk, lo=(0.0, 0.1, 0.1), hi=(0.9, 0.9, 0.9)))
        for shape in ((4, 1, 1), (2, 3, 1)):
            lab_k = f"{dtype} random {pk.padded_shape} nf={MEANS_NF}"
            check_shards(pk, arrays_k, shape, lab_k)
            for mats_k, sar_k, scene_k in ((wb_k, False, "water"), (wb_k, True, "water + SAR"),
                                           (fe_k, False, "water + ferrite"), (fe_k, True, "water + ferrite + SAR")):
                check_shards(pk, arrays_k, shape, f"{lab_k} {scene_k}", mats_k, sar_k)
        # K = 15: 16 planes over 4, too few for the s = 4 halo: the vacuum bands at s = 2 up to their cap
        pt = dataclasses.replace(pk, height=0.0155)
        arrays_t = {c: rng.uniform(-1.0, 1.0, pt.padded_shape) for c in COMPONENTS}
        for nf in THIN_NF:
            check_thin_shards(pt, arrays_t, nf, f"{dtype} random {pt.padded_shape} nf={nf}")
        del arrays, arrays_k, arrays_t, dc
    print(f"phase 6e (a, b) fold and means-mode kernels vs plain: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- (c) the 16-frequency scenes at n^3 --------------------------------------------------------
    def run_scene(pm: Params, backend: str, mats, sar: bool, pml, dft, dc=None, shard: bool = False):
        """The scene's steps through the chunk runner ``run_simulation``
        builds for ``backend`` (``shard``: the sharded stream runner of
        --shard 4), in the chunks its sampling rate gives; the state, map,
        psi, P and sums stay on the card (``run_simulation``'s phasors are
        a host fp64 copy of every frequency).  Returns those, the launch
        counts and the chunks' seconds."""
        tv = time_values(pm)
        ts, amps = scan_inputs(pm, tv)
        cw, sw = dft_weights(dft, tv)
        s = initial_state(pm, dev)
        power = zero_power_acc(pm, dev) if sar else None
        psi = init_psi(pm, pml, dev) if pml is not None else None
        pol = zero_polarization(pm, dev) if dc is not None else None
        dacc = zero_dft_acc(pm, dft, dev)
        if shard:
            mesh = shard_mesh.make_mesh((4, 1, 1), dev.type)
            run = sharded_fast.make_sharded_stream_runner(pm, mesh, mats, sar, dft=dft)
            shards = shard_mesh.scatter(pm, s, mesh, run.depth, power, None, None, None, dacc)
        else:
            run = make_chunk_runner(pm, dev, mats, backend, accumulate_power=sar, pml=pml, dft=dft, dc=dc)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in range(0, len(tv), pm.sampling_rate):
            chunk = tuple(x[a:a + pm.sampling_rate] for x in (ts, amps, cw, sw))
            if shard:
                run(shards, chunk)
            else:
                run(s, chunk, power, psi, pol, dacc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts_now()
        if shard:
            shard_mesh.gather(pm, shards, s, power, None, None, None, dacc)
        return (s, power, psi, pol, dacc), got, wall

    def time_turns(pm: Params, mats, sar: bool, pml, dft, dc=None) -> dict:
        """backend -> (median, min, max) Mcells/s of stream and twopass on
        the scene: each runner warmed by one chunk (its spare state and
        means buffer allocated), then ``RATE_REPS`` runs of ``RATE_STEPS``
        steps each, in turns (stream, twopass, stream, ...), in the chunks
        of the scene's sampling rate."""
        chunk = pm.sampling_rate
        pt_ = dataclasses.replace(pm, simulation_time=(chunk + RATE_STEPS - 0.5) * pm.time_step)
        tv = time_values(pt_)
        xs = scan_inputs(pt_, tv) + dft_weights(dft, tv)
        runs = {}
        for backend in ("stream", "twopass"):
            args = (initial_state(pm, dev), zero_power_acc(pm, dev) if sar else None,
                    init_psi(pm, pml, dev) if pml is not None else None,
                    zero_polarization(pm, dev) if dc is not None else None, zero_dft_acc(pm, dft, dev))
            run = make_chunk_runner(pm, dev, mats, backend, accumulate_power=sar, pml=pml, dft=dft, dc=dc)
            run(args[0], tuple(x[:chunk] for x in xs), *args[1:])
            runs[backend] = (run, args)
        walls = {b: [] for b in runs}
        for _ in range(RATE_REPS):
            for backend, (run, args) in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for a in range(chunk, chunk + RATE_STEPS, chunk):
                    run(args[0], tuple(x[a:a + chunk] for x in xs), *args[1:])
                torch.cuda.synchronize()
                walls[backend].append(time.perf_counter() - t0)
        del runs
        torch.cuda.empty_cache()
        return {b: tuple(pm.cell_count * RATE_STEPS / w / 1e6 for w in (sorted(ws)[len(ws) // 2], max(ws), min(ws)))
                for b, ws in walls.items()}

    def rate_txt(r) -> str:
        return f"{r[0]!r} (median of {RATE_REPS} runs of {RATE_STEPS} steps; {r[1]!r}-{r[2]!r})"

    def diff_runs(a, b) -> float:
        return max((maxdiff(x, y) if hasattr(x, "tensors") or isinstance(x, tuple) else absdiff(x, y))
                   for x, y in zip(a, b) if x is not None)

    def addmm_ms(w, sums, depth: int) -> float:
        """torch.addmm of the fold's weights (cos and -sin stacked, (2 nf, D)) and cell means ((D, 3 cells))
        onto a stacked (2 nf, 3 cells) copy of the sums: one PyTorch call that computes the fold (not its
        rounding order)."""
        nf_ = w.shape[2]
        lhs = torch.cat([w[:, 0, :].T, -w[:, 1, :].T]).contiguous()
        stacked = torch.cat([sums[0].reshape(nf_, -1), sums[1].reshape(nf_, -1)])
        m2 = rand((depth, stacked.shape[1]))
        return event_ms(lambda: stacked.addmm_(lhs, m2))

    base = load_parameters("configs/heating_256.txt", dtype="float32")
    pn = dataclasses.replace(base, length=n * base.spatial_step, width=n * base.spatial_step,
                             height=n * base.spatial_step, simulation_time=steps * base.time_step)
    nn = len(time_values(pn))
    cfg16 = DftConfig(MEANS_FREQS)
    pml10 = PMLConfig(cells=10)
    water_n = water_block(pn)
    debye_n = water_debye_load(pn)
    dcs = {dtype: debye_coefs(dataclasses.replace(pn, dtype=dtype), debye_n, dev) for dtype in ("float32", "bfloat16")}
    rates: dict[str, float] = {}
    scene_plans: dict[str, stream_plan.StreamPlan] = {}
    t_c = time.perf_counter()
    for label, mats, sar, pml in (("vacuum", None, False, None), ("heating + SAR", water_n, True, None),
                                  ("--pml 10", None, False, pml10), ("Debye + SAR", debye_n, True, None)):
        debye_s = isinstance(mats, DebyeMaterials)
        for dtype in ("float32", "bfloat16"):
            pd = dataclasses.replace(pn, dtype=dtype)
            dc = dcs[dtype] if debye_s else None
            routed = resolve_backend(pd, "auto", dev, mats, sar, pml, dft=cfg16)
            plan = stream_plan.pick_plan(pd, lossy=mats is not None and not debye_s, sar=sar, pml=pml, ade=debye_s,
                                         dft=cfg16)
            check(routed == "stream" and plan.fold > 0,
                  f"{n}^3 {label} {dtype} with {cfg16.nf} frequencies: auto resolves to {routed}, plan "
                  f"{plan.kernel} s={plan.s} with a {plan.fold}-level buffer")
            res, got = {}, {}
            for backend in ("stream", "twopass"):
                res[backend], got[backend], _ = run_scene(pd, backend, mats, sar, pml, cfg16, dc)
            for backend, r_ in time_turns(pd, mats, sar, pml, cfg16, dc).items():
                rates[f"{label} {dtype} {backend}"] = r_
            chunk = pd.sampling_rate
            sweeps = nn // chunk * (chunk // plan.s) + (nn % chunk) // plan.s
            folds = nn // chunk * -(-(chunk // plan.s * plan.s) // plan.fold) + (
                -(-((nn % chunk) // plan.s * plan.s) // plan.fold))
            trail = nn // chunk * (chunk % plan.s) + (nn % chunk) % plan.s
            ga = got["stream"]
            check(ga[plan.kernel] == sweeps and ga["dft_fold"] == folds and ga["dft_accum"] == trail
                  and (plan.core is None or ga[plan.kernel + stream.INTERIOR] == sweeps)
                  and got["twopass"]["dft_accum"] == nn,
                  f"{n}^3 {label} {dtype}: stream {ga[plan.kernel]} {plan.kernel} launches (want {sweeps}), dft_fold "
                  f"{ga['dft_fold']} (want {folds}), dft_accum {ga['dft_accum']} (want {trail}); twopass dft_accum "
                  f"{got['twopass']['dft_accum']} (want {nn})")
            if dtype == "float32":
                for name in (plan.kernel, "dft_fold") + ((plan.kernel + stream.INTERIOR,) if plan.core else ()):
                    if name not in launches:
                        launches[name] = ga[name]
                        paths[name] = f"{n}^3 {label} --dft x{cfg16.nf} auto ({nn} steps)"
                scene_plans[label] = plan
            peak = float(res["stream"][4][0].abs().max())
            txt = (f"{rate_txt(rates[f'{label} {dtype} stream'])} against "
                   f"{rate_txt(rates[f'{label} {dtype} twopass'])} Mcells/s ({smi})")
            if dtype == "float32":
                d = diff_runs(res["stream"], res["twopass"])
                check(d == 0.0 and peak > 0,
                      f"{n}^3 {label} fp32 --dft x{cfg16.nf}, {nn} steps: stream (means mode) == twopass + dft_accum, "
                      f"sums, fields{', SAR' if sar else ''}{', psi' if pml else ''}{', P' if debye_s else ''} "
                      f"max|diff| = {d!r} (sums peak {peak!r}); {txt}")
            else:
                # a bf16 sweep rounds the fields once a sweep, a bf16 twopass step once a step, so the two
                # differ by bf16 round-off; the means mode is held to the bands instead: the frequencies in
                # groups the bands hold, one stream run a group, bit for bit (the fields do not depend on
                # them, and each frequency's sums take the same operations in the same order)
                cap = stream_plan.pick_plan(pd, lossy=mats is not None and not debye_s, sar=sar, pml=pml, ade=debye_s,
                                            dft=DftConfig(cfg16.frequencies[:1])).dft_max_nf
                bands_name = plan.kernel.removesuffix("_means")
                d = 0.0
                for i in range(0, cfg16.nf, cap):
                    part, got_b, _ = run_scene(pd, "stream", mats, sar, pml, DftConfig(cfg16.frequencies[i:i + cap]),
                                               dc)
                    check(got_b[bands_name] > 0 and got_b["dft_fold"] == 0, f"{bands_name} ran the group")
                    d = max(d, diff_runs(res["stream"][:4], part[:4]),
                            maxdiff(tuple(t[i:i + cap] for t in res["stream"][4]), part[4]))
                    del part
                rel = float((res["stream"][4][0] - res["twopass"][4][0]).abs().max()) / peak
                check(d == 0.0 and peak > 0,
                      f"{n}^3 {label} bf16 --dft x{cfg16.nf}, {nn} steps: stream (means mode) == {-(-cfg16.nf // cap)} "
                      f"stream runs of the bands ({bands_name}, at most {cap} frequencies a run), sums, fields"
                      f"{', SAR' if sar else ''} max|diff| = {d!r}; twopass + dft_accum {rel!r} of the sums' peak off "
                      f"it (bf16 round-off a step against a sweep); {txt}")
            del res
            torch.cuda.empty_cache()
    # vacuum and heating with --shard 4 (fp32): equal to the unsharded stream run
    for label, mats, sar in (("vacuum", None, False), ("heating + SAR", water_n, True)):
        one, _, _ = run_scene(pn, "stream", mats, sar, None, cfg16)
        four, got, wall = run_scene(pn, "stream", mats, sar, None, cfg16, shard=True)
        name = stream_plan.variant_name(mats is not None, False, sar, dft=True, means=True) + "_shard"
        d = diff_runs(one, four)
        check(got[name] > 0 and got["dft_fold"] > 0 and d == 0.0,
              f"{n}^3 {label} fp32 --dft x{cfg16.nf} --shard 4 ({got[name]} {name} launches, {got['dft_fold']} folds) "
              f"== unsharded: sums, fields{', SAR' if sar else ''} max|diff| = {d!r}; "
              f"{pn.cell_count * nn / wall / 1e6!r} Mcells/s ({smi})")
        launches[name] = got[name]
        paths[name] = f"{n}^3 {label} --dft x{cfg16.nf} --shard 4 auto ({nn} steps)"
        del one, four
    # shards too thin for the s = 4 halo (16 planes over 4): the s = 2 bands, routed, == twopass + dft_accum
    pt = Params(length=0.0305, width=0.0265, height=0.0155, spatial_step=0.001, time_step=1e-12,
                simulation_time=2.05e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype="float32")
    for nf in THIN_NF:
        cfg = DftConfig(MEANS_FREQS[:nf])
        four, got, _ = run_scene(pt, "stream", None, False, None, cfg, shard=True)
        ref, got2, _ = run_scene(pt, "twopass", None, False, None, cfg)
        d = diff_runs(four, ref)
        n_t = len(time_values(pt))
        check(got["yee_stream_dft_shard"] > 0 and got["dft_fold"] == 0 and got2["dft_accum"] == n_t and d == 0.0
              and float(ref[4][0].abs().max()) > 0,
              f"{pt.padded_shape} vacuum fp32 --dft x{nf} --shard 4 ({n_t} steps, shards of 4 planes): "
              f"{got['yee_stream_dft_shard']} yee_stream_dft_shard launches (the s = 2 bands), {got['dft_fold']} "
              f"folds == twopass + dft_accum ({got2['dft_accum']} launches): sums, fields max|diff| = {d!r}")
        del four, ref
    print(f"phase 6e (c) the {n}^3 16-frequency scenes: {time.perf_counter() - t_c:.1f} s", flush=True)

    # every variant with six frequencies, 67 steps (trailing two-pass steps
    # at s = 2 and 4), stream == twopass == torch (fp32)
    cfg6 = DftConfig(MEANS_FREQS[:MEANS_NF])
    ferrite_n = ferrite_slab(pn, base=water_n)
    p67 = dataclasses.replace(pn, simulation_time=67 * pn.time_step)
    tv = time_values(p67)
    xs = scan_inputs(p67, tv) + dft_weights(cfg6, tv)
    init = {c: rng.uniform(-1.0, 1.0, p67.padded_shape).astype(np.float32) for c in COMPONENTS}
    for label, mats, sar, pml in (("vacuum", None, False, None), ("water", water_n, False, None),
                                  ("water + SAR", water_n, True, None), ("ferrite", ferrite_n, False, None),
                                  ("ferrite + SAR", ferrite_n, True, None), ("--pml 10", None, False, pml10),
                                  ("water --pml 10", water_n, False, pml10), ("Debye", debye_n, False, None),
                                  ("Debye + SAR", debye_n, True, None)):
        debye_v = isinstance(mats, DebyeMaterials)
        got = {}
        for backend in ("stream", "twopass", "torch"):
            s = state_from_numpy(init, dev, torch.float32)
            power = zero_power_acc(p67, dev) if sar else None
            psi = init_psi(p67, pml, dev) if pml is not None else None
            pol = zero_polarization(p67, dev) if debye_v else None
            sums = zero_dft_acc(p67, cfg6, dev)
            run = make_chunk_runner(p67, dev, mats, backend, accumulate_power=sar, pml=pml, dft=cfg6,
                                    dc=dcs["float32"] if debye_v else None)
            reset_counts()
            run(s, xs, power, psi, pol, sums)
            torch.cuda.synchronize()
            got[backend] = (counts_now(), (s, power, psi, pol, sums), getattr(run, "plan", None))
        plan = got["stream"][2]
        trail = len(tv) % plan.s
        ca = got["stream"][0]
        d = max(max((maxdiff(x, y) if hasattr(x, "tensors") or isinstance(x, tuple) else absdiff(x, y))
                    for x, y in zip(got["stream"][1], got[b][1]) if x is not None) for b in ("twopass", "torch"))
        check(plan.fold > 0 and ca[plan.kernel] == len(tv) // plan.s and ca["dft_accum"] == trail and ca["dft_fold"] > 0
              and d == 0.0,
              f"{n}^3 {label} --dft x{MEANS_NF} 67 steps: stream ({ca[plan.kernel]} {plan.kernel}, {ca['dft_fold']} "
              f"folds, {trail} trailing steps with dft_accum) == twopass == torch, max|diff| = {d!r}")
        for name in (plan.kernel, plan.kernel + stream.INTERIOR) if plan.core else (plan.kernel,):
            if name not in launches:
                launches[name] = ca[name]
                paths[name] = f"{n}^3 {label} --dft x{MEANS_NF} stream (67 steps)"
                scene_plans.setdefault(label, plan)
        del got
    torch.cuda.empty_cache()

    # -- (d, e) the CLI on bench_256 --dft x4, heating_256 --dft x3 --shard 4 -----------------------
    if full_size:
        t_d = time.perf_counter()
        freqs4 = MEANS_FREQS[::5]
        pb = load_parameters("configs/bench_256.txt", dtype="float32")
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts()
            t0 = time.perf_counter()
            r = run_cli(["configs/bench_256.txt", "--dft", ",".join(map(repr, freqs4)), "--out", tmp], cli)
            got = counts_now()
            wall = time.perf_counter() - t0
            files = sorted(glob.glob(os.path.join(tmp, "dft_*.vtr")))
            check(r.returncode == 0 and len(files) == 4 and got["yee_stream_dft_means"] == 250
                  and got["dft_fold"] == 32 and got["dft_accum"] == 0,
                  f"CLI bench_256 --dft x4 (auto) exit {r.returncode} in {wall:.1f} s: {len(files)} dft_NN.vtr; the means "
                  f"mode, {got['yee_stream_dft_means']} yee_stream_dft_means launches (250 sweeps of 4 steps), "
                  f"{got['dft_fold']} dft_fold (32 folds of a 32-level buffer), {got['dft_accum']} dft_accum "
                  f"{r.stderr.strip()[-300:]}")
            launches.setdefault("yee_stream_dft_means", got["yee_stream_dft_means"])
            # the files' phasors are the sums in fp64 times 2/N: those of twopass + dft_accum, bit for bit
            ref, _, _ = run_scene(pb, "twopass", None, False, None, DftConfig(freqs4))
            scale = 2.0 / len(time_values(pb))
            d, peak = 0.0, 0.0
            for fi, path in enumerate(files):
                arrs = read_vtr_cell_arrays(path)
                for c, comp in enumerate(("ex", "ey", "ez")):
                    for part, sums in (("re", ref[4][0]), ("im", ref[4][1])):
                        want = sums[fi, c].double() * scale
                        d = max(d, absdiff(torch.from_numpy(arrs[f"{comp}_{part}"]).to(dev), want))
                peak = max(peak, float(arrs["e_mag"].max()))
                del arrs
            check(d == 0.0 and peak > 0,
                  f"CLI bench_256 --dft x4 (1000 steps, auto): dft_00..03.vtr == twopass + dft_accum's phasors, "
                  f"max|diff| = {d!r} (e_mag peak {peak!r})")
            del ref
        # heating_256 --water-block --sar --dft --shard 4: three frequencies, which the lossy + SAR bands
        # hold (the bands, fold 0), and eight, past them (the means mode, each shard folding its part)
        ph = load_parameters("configs/heating_256.txt", dtype="float32")
        water = water256 if water256 is not None else water_block(ph)
        n_h = len(time_values(ph))
        for cfg_h in (DftConfig(MEANS_FREQS[::7][:3]), DftConfig(MEANS_FREQS[::2])):
            plan_h = sharded_fast.pick_shard_plan(ph, shard_mesh.make_mesh((4, 1, 1), dev.type), lossy=True, sar=True,
                                                  dft=cfg_h)[0]
            k_h = plan_h.kernel + "_shard"
            four, got, wall4 = run_scene(ph, "stream", water, True, None, cfg_h, shard=True)
            ref, got2, wall1 = run_scene(ph, "twopass", water, True, None, cfg_h)
            d = diff_runs(four, ref)
            chunk = ph.sampling_rate
            per = chunk // plan_h.s * plan_h.s  # the levels a chunk buffers
            folds = 4 * (n_h // chunk) * -(-per // plan_h.fold) if plan_h.fold else 0
            means = cfg_h.nf > plan_h.dft_max_nf
            check((plan_h.fold > 0) == means and got[k_h] == 4 * (n_h // chunk) * (chunk // plan_h.s) and got["dft_fold"] == folds
                  and got2["dft_accum"] == n_h and d == 0.0,
                  f"heating_256 --water-block --sar --dft x{cfg_h.nf} --shard 4 ({n_h} steps): the sharded sweep "
                  f"({'the means mode' if means else 'the bands'}: {got[k_h]} {k_h} launches, {plan_h.fold}-level "
                  f"buffer, {got['dft_fold']} folds, want {folds}) == unsharded twopass + dft_accum "
                  f"({got2['dft_accum']} launches): sums, fields, SAR max|diff| = {d!r}; "
                  f"{ph.cell_count * n_h / wall4 / 1e6!r} against {ph.cell_count * n_h / wall1 / 1e6!r} Mcells/s "
                  f"(one run each) ({smi})")
            del four, ref
        del water
        torch.cuda.empty_cache()
        print(f"phase 6e (d, e) the CLI and the 256^3 runs: {time.perf_counter() - t_d:.1f} s", flush=True)

    # -- (f) 256^3: the fold and the means-mode sweeps beside the parent's, the routed rates ------------
    if full_size:
        from fdtd_tpu_torch import profile_chunk, tune_stream

        t_f = time.perf_counter()
        big = profile_chunk.scene(256, "float32")  # configs/bench_256.txt's grid
        cells_b = big.maxk * big.maxj * big.maxi
        depth = stream_plan.FOLD_DEPTH
        fold_step: dict[tuple, float] = {}  # (tree, nf) -> ms of a 32-level fold a step
        for nf in MEANS_256_NF:
            cells_256 = (big.maxk, big.maxj, big.maxi)
            means = rand(stream.means_shape(big, depth))
            w = rand((depth, 2, nf))
            sums = sums_like(nf, cells_256)
            k, q = tuple(t.clone() for t in sums), tuple(t.clone() for t in sums)
            dft_ops.fold(means, w, k)
            dft_ops.plain_fold(means, w, q)
            torch.cuda.synchronize()
            d = maxdiff(k, q)
            note("dft_fold", d)
            check(d == 0.0, f"dft_fold == plain_fold at 256^3, nf={nf}, {depth} levels: max|diff| = {d!r}")
            del k, q
            mine = lambda: dft_ops.fold(means, w, sums)  # noqa: E731
            txt = ""
            if parent is not None:
                theirs = tune_stream.parent_fold(parent, cells_256, nf, depth, dev, gen)
                first = event_ms(theirs)
                t = (event_ms(mine) + event_ms(mine)) / 2
                tp = (first + event_ms(theirs)) / 2
                fold_step[("parent", nf)] = tp / depth
                txt = f"; {PARENT}'s {tp!r} ms in turns (x{tp / t!r})"
                del theirs
            else:
                t = event_ms(mine)
            fold_step[("this", nf)] = t / depth
            t_lib = addmm_ms(w, sums, depth)
            b = max((12 * depth + 2 * 2 * 4 * nf * 3) * cells_b / HBM_BYTES_PER_S,
                    12 * depth * nf * cells_b / FP32_FLOPS) * 1e3
            print(f"means mode 256^3 dft_fold nf={nf}, {depth} levels: {t!r} ms, {b / t!r} of its bound {b!r} ms"
                  f"{txt}; torch.addmm {t_lib!r} ms ({smi})", flush=True)
            del means, w, sums, mine
            torch.cuda.empty_cache()
        rng_b = np.random.default_rng(15)
        for scene_name, nf in (("vacuum_dft", 4), ("pml_dft", PML_DFT_NF), ("lossy_pml_dft", PML_DFT_NF)):
            for dtype in ("float32", "bfloat16"):
                pd = dataclasses.replace(big, dtype=dtype)
                lossy_, _, _, _, _, pml_ = tune_stream.SCENES[scene_name]
                plan = stream_plan.pick_plan(pd, lossy=lossy_, pml=pml10 if pml_ else None, dft=cfg16)
                case = tune_stream.make_case(pd, scene_name, plan.s, plan.bj, plan.cr, dev, rng_b, means=True)
                outs = case.outputs()
                mine = lambda: case.run(outs)  # noqa: E731
                bound = tune_stream.bound_ms(case)
                txt = ""
                if parent is not None:
                    pplan, theirs = tune_stream.parent_means_run(parent, pd, scene_name, dev, rng_b, case)
                    first = event_ms(theirs)
                    t = (event_ms(mine) + event_ms(mine)) / 2
                    tp = (first + event_ms(theirs)) / 2
                    a_step = {q: t / plan.s + fold_step[("this", q)] for q in MEANS_256_NF}
                    p_step = {q: tp / pplan.s + fold_step[("parent", q)] for q in MEANS_256_NF}
                    txt = (f"; {PARENT}'s (s={pplan.s} bj={pplan.bj}) {tp!r} ms in turns (x{tp / pplan.s / (t / plan.s)!r} "
                           f"a step); with its 32-level fold a step, "
                           + ", ".join(f"nf={q}: {a_step[q]!r} against {p_step[q]!r} (x{p_step[q] / a_step[q]!r})"
                                       for q in MEANS_256_NF))
                    del theirs
                else:
                    t = event_ms(mine)
                print(f"means mode 256^3 {plan.kernel} {dtype} (s={plan.s} bj={plan.bj}"
                      f"{f' interior bj={plan.core.bj}' if plan.core else ''}): {t!r} ms a sweep, {t / plan.s!r} a step, "
                      f"{bound / t!r} of its bound {bound!r} ms{txt} ({smi})", flush=True)
                del case, outs, mine
                torch.cuda.empty_cache()
        # the routed runs: bench_256 --dft x4 (vacuum) and --pml 10 --dft x6, a 1000-step chunk each (the CLI's)
        pr = dataclasses.replace(load_parameters("configs/bench_256.txt", dtype="float32"), sampling_rate=RATE_STEPS)
        # first one counted chunk of --pml 10 --dft x6 against twopass + dft_accum: the shell, interior and fold
        # launches, fields, psi and sums bit for bit
        cfg6 = DftConfig(MEANS_FREQS[::3][:PML_DFT_NF])
        plan6 = stream_plan.pick_plan(pr, pml=pml10, dft=cfg6)
        mine, got, wall = run_scene(pr, "stream", None, False, pml10, cfg6)
        ref, got2, _ = run_scene(pr, "twopass", None, False, pml10, cfg6)
        n6 = len(time_values(pr))
        swept = n6 // plan6.s * plan6.s
        want = {plan6.kernel: n6 // plan6.s, plan6.kernel + stream.INTERIOR: n6 // plan6.s,
                "dft_fold": -(-swept // plan6.fold), "dft_accum": n6 - swept}
        d = diff_runs(mine, ref)
        check(plan6.fold > 0 and plan6.core is not None and all(got[k] == v for k, v in want.items())
              and got2["dft_accum"] == n6 and d == 0.0,
              f"bench_256 --pml 10 --dft x{PML_DFT_NF} ({n6} steps, one chunk): the means mode's launches "
              f"{ {k: got[k] for k in want} } (want {want}; {plan6.fold}-level buffer) == twopass + dft_accum "
              f"({got2['dft_accum']} dft_accum): fields, psi, sums max|diff| = {d!r}; "
              f"{pr.cell_count * n6 / wall / 1e6!r} Mcells/s (one run, cold)")
        for k in (plan6.kernel, plan6.kernel + stream.INTERIOR):
            launches.setdefault(k, got[k])
        del mine, ref
        torch.cuda.empty_cache()
        for label, pml_, cfg_ in (("bench_256 --dft x4", None, DftConfig(MEANS_FREQS[::5])),
                                  (f"bench_256 --pml 10 --dft x{PML_DFT_NF}", pml10,
                                   DftConfig(MEANS_FREQS[::3][:PML_DFT_NF]))):
            routed = resolve_backend(pr, "auto", dev, None, False, pml_, dft=cfg_)
            plan = stream_plan.pick_plan(pr, pml=pml_, dft=cfg_)
            check(routed == "stream" and plan.fold > 0, f"{label}: auto resolves to {routed}, {plan.kernel}")
            r = time_turns(pr, None, False, pml_, cfg_)
            print(f"rate 256^3 {label} (auto, {plan.kernel}): stream {rate_txt(r['stream'])} against twopass + "
                  f"dft_accum {rate_txt(r['twopass'])} Mcells/s (x{r['stream'][0] / r['twopass'][0]!r} of the "
                  f"medians) ({smi})", flush=True)
        torch.cuda.empty_cache()
        print(f"phase 6e (f) 256^3 means mode and fold: {time.perf_counter() - t_f:.1f} s", flush=True)

    # -- timing at the n^3 scenes' shapes, the bounds, the kernels' rows ----------------------------
    ms: dict[str, tuple] = {}  # kernel -> (fp32 ms, bf16 ms, plain fp32 ms)
    bands_ms: dict[str, tuple] = {}  # kernel -> fp32 ms a step of the bands (nf = 1) and of the means mode
    cells = math.prod(pn.padded_shape)
    cells_k = pn.maxk * pn.maxj * pn.maxi
    arrays = {c: rng.uniform(-1.0, 1.0, pn.padded_shape).astype(np.float32) for c in COMPONENTS}
    shapes10 = psi_shapes(pn, pml10)
    psi_n = sum(math.prod(shapes10[t]) for t in H_TERMS + E_TERMS)
    bounds: dict[str, tuple] = {}
    for label, mats, sar, pml in (("vacuum", None, False, None), ("water", water_n, False, None),
                                  ("heating + SAR", water_n, True, None), ("ferrite", ferrite_n, False, None),
                                  ("ferrite + SAR", ferrite_n, True, None), ("--pml 10", None, False, pml10),
                                  ("water --pml 10", water_n, False, pml10), ("Debye", debye_n, False, None),
                                  ("Debye + SAR", debye_n, True, None)):
        debye_v = isinstance(mats, DebyeMaterials)
        plan = scene_plans[label]
        t_k = {}
        for dtype in ("float32", "bfloat16"):
            pd = dataclasses.replace(pn, dtype=dtype)
            coefs = update_coefs(pd, None if debye_v else mats, dev)
            st, drive = sweep_inputs(pd, arrays, plan.s)
            out_s = FieldState(*(torch.empty_like(t) for t in st.tensors()))
            cp = make_cpml(pd, pml, coefs, dev) if pml is not None else None
            psi_i = init_psi(pd, pml, dev) if pml is not None else None
            psi_o = init_psi(pd, pml, dev) if pml is not None else None
            dc = dcs[dtype] if debye_v else None
            pol_i = zero_polarization(pd, dev) if debye_v else None
            pol_o = zero_polarization(pd, dev) if debye_v else None
            acc = zero_power_acc(pd, dev) if sar else None
            buf = torch.zeros(stream.means_shape(pd, plan.s), device=dev)

            def sweep_k(pl=plan):
                stream.sweep(pd, st, out_s, coefs, pl, drive, acc, cp, psi_i, psi_o, dc, pol_i, pol_o, means=buf)

            t_k[dtype] = event_ms(sweep_k)
            if plan.core is not None:
                t_k[dtype + " interior"] = event_ms(lambda: sweep_k(dataclasses.replace(plan, pml_blocks=())))
            if dtype == "float32":
                t_k["plain"] = event_ms(lambda: stream.plain_sweep(pd, st, coefs, plan.s, drive, out_s, acc, cp, psi_i,
                                                                   psi_o, dc, pol_i, pol_o, means=buf), reps=2)
                if plan.core is not None:
                    core = plan.core
                    box = Box((0, 0, 0), pd.padded_shape, core.origin,
                                         tuple(o + w for o, w in zip(core.origin, core.window)))
                    mbox = torch.zeros(stream.means_shape(pd, plan.s, box), device=dev)
                    t_k["plain interior"] = event_ms(lambda: stream.plain_sweep(pd, st, coefs, plan.s, drive, out_s,
                                                                                box=box, means=mbox), reps=2)
                # the bands at one frequency, the same shape: what the means mode would replace there
                one = DftConfig(MEANS_FREQS[:1])
                plan_b = stream_plan.pick_plan(pd, lossy=coefs.lossy, het=coefs.heterogeneous_mu, sar=sar, pml=pml,
                                               ade=debye_v, dft=one)
                d1 = zero_dft_acc(pd, one, dev)
                w1 = rand((plan.s, 2, 1))
                t_k["bands"] = event_ms(lambda: stream.sweep(pd, st, out_s, coefs, plan_b, drive, acc, cp, psi_i, psi_o,
                                                             dc, pol_i, pol_o, d1, w1))
                bands_ms[plan.kernel] = (t_k["bands"] / plan.s, t_k["float32"] / plan.s)
                del d1
            del st, out_s, cp, psi_i, psi_o, pol_i, pol_o, acc, buf, coefs
        lossy, het = mats is not None and not debye_v, mats is not None and not debye_v and mats.mu_r is not None
        name = plan.kernel
        for item, dtype in ((4, "float32"), (2, "bfloat16")):
            if debye_v:  # fields and P in and out, 15 maps; SAR: 3 sigma, the map in and out
                b = (33 + (3 if sar else 0)) * item * cells + (8 * cells_k if sar else 0)
                f = plan.s * (51 * cells + (21 * cells + 19 * cells_k if sar else 0))
            else:  # fields in and out, coefficients, sigma, the map in and out, psi in and out
                b = ((12 + (6 if lossy else 0) + (3 if het else 0)) * item * cells
                     + ((item + 8) * cells_k if sar else 0) + (2 * item * psi_n if pml else 0))
                f = plan.s * (cells * (15 + (18 if lossy else 15)) + (20 * cells_k if sar else 0)
                              + (5 * psi_n if pml else 0))
            # the means: 12 B a cell and level written, 12 operations a cell and level
            bounds.setdefault(name, {})[dtype] = (b + 12 * plan.s * cells_k, f + 12 * plan.s * cells_k)
            if plan.core is not None:
                core = plan.core
                v = math.prod(core.window)
                c_in = math.prod(min(o + w, t) - o for o, w, t in zip(core.origin, core.window,
                                                                      (pn.maxk, pn.maxj, pn.maxi)))
                bounds.setdefault(name + stream.INTERIOR, {})[dtype] = (
                    (12 + (6 if lossy else 0)) * item * v + 12 * plan.s * c_in,
                    plan.s * (v * (15 + (18 if lossy else 15)) + 12 * c_in))
        ms[name] = (t_k["float32"], t_k["bfloat16"], t_k["plain"])
        if plan.core is not None:
            ms[name + stream.INTERIOR] = (t_k["float32 interior"], t_k["bfloat16 interior"], t_k["plain interior"])
    # a middle slab of --shard 4 (its box with s + 1 halo planes), fp32 and bf16
    for label, mats, sar in (("vacuum", None, False), ("heating + SAR", water_n, True)):
        name = stream_plan.variant_name(mats is not None, False, sar, dft=True, means=True) + "_shard"
        t_k = {}
        for dtype in ("float32", "bfloat16"):
            pd = dataclasses.replace(pn, dtype=dtype)
            mesh = shard_mesh.make_mesh((4, 1, 1), dev.type)
            plans = sharded_fast.pick_shard_plan(pd, mesh, None, sar, False, sar, {}, cfg16)
            host = update_coefs(pd, mats, "cpu")
            canon = state_from_numpy(arrays, dev, field_dtype(pd))
            shards = shard_mesh.scatter(pd, canon, mesh, plans[0].s + 1, zero_power_acc(pd, dev) if sar else None)
            sh, plan = shards[1], plans[1]
            cf = shard_coefs(pd, host, sh.box, dev)
            st, drive = sweep_inputs(pd, None, plan.s, sh.box, sh.state.clone())
            out_s = FieldState(*(torch.empty_like(t) for t in st.tensors()))
            buf = torch.zeros(stream.means_shape(pd, plan.s, sh.box), device=dev)
            t_k[dtype] = event_ms(lambda: stream.sweep(pd, st, out_s, cf, plan, drive, sh.power, box=sh.box, means=buf))
            if dtype == "float32":
                t_k["plain"] = event_ms(lambda: stream.plain_sweep(pd, st, cf, plan.s, drive, out_s, sh.power,
                                                                   box=sh.box, means=buf), reps=2)
            v_in, v_own, c_own = math.prod(sh.box.shape), math.prod(
                h - lo for lo, h in zip(sh.box.own_lo, sh.box.own_hi)), math.prod(sh.box.cell_shape(pd))
            item = 4 if dtype == "float32" else 2
            bounds.setdefault(name, {})[dtype] = (
                (6 + (6 if sar else 0)) * item * v_in + 6 * item * v_own + ((item + 8) * c_own if sar else 0)
                + 12 * plan.s * c_own,
                plan.s * (v_own * (15 + (18 if sar else 15)) + (20 * c_own if sar else 0) + 12 * c_own))
            del canon, shards, st, out_s, buf, cf
        ms[name] = (t_k["float32"], t_k["bfloat16"], t_k["plain"])
    # the fold at the scenes' shape: 16 frequencies, a 32-level buffer; torch.addmm of the same weights
    # (cos and -sin stacked, (2 nf, D)) and means ((D, 3 cells)) onto a stacked (2 nf, 3 cells) copy of
    # the sums: one PyTorch call that computes the fold (not its rounding order)
    depth = stream_plan.FOLD_DEPTH
    means = rand(stream.means_shape(pn, depth))
    w = rand((depth, 2, cfg16.nf))
    sums = sums_like(cfg16.nf, (pn.maxk, pn.maxj, pn.maxi))
    t_fold = event_ms(lambda: dft_ops.fold(means, w, sums))
    t_fold1 = event_ms(lambda: dft_ops.fold(means, w[:, :, :1].contiguous(), tuple(t[:1] for t in sums)))
    t_plain = event_ms(lambda: dft_ops.plain_fold(means, w, sums), reps=2)
    t_lib = addmm_ms(w, sums, depth)
    ms["dft_fold"] = (t_fold, t_fold, t_plain)
    fb = 12 * depth * cells_k + 2 * 2 * 4 * cfg16.nf * 3 * cells_k
    bounds["dft_fold"] = {dt_: (fb, 12 * depth * cfg16.nf * cells_k) for dt_ in ("float32", "bfloat16")}
    del means, sums, arrays
    torch.cuda.empty_cache()

    rows = []
    for name in sorted(ms):
        k32, k16, kp = ms[name]
        b32 = bounds[name]["float32"]
        bound = {}
        for dtype, (b, f) in bounds[name].items():
            t_b, t_f = b / HBM_BYTES_PER_S * 1e3, f / FP32_FLOPS * 1e3
            bound[dtype] = (max(t_b, t_f), "bytes" if t_b >= t_f else "operations")
        shape = (f"{n}^3, a middle slab of --shard 4" if name.endswith("_shard") else
                 f"{n}^3, {cfg16.nf} frequencies, a {depth}-level buffer" if name == "dft_fold" else f"{n}^3")
        lib_txt = f", torch.addmm {t_lib!r} ms" if name == "dft_fold" else ""
        print(f"means mode {name} ({shape}): fp32 {k32!r} ms ({bound['float32'][0] / k32!r} of its bound "
              f"{bound['float32'][0]!r} ms, {bound['float32'][1]}; {b32[0] / cells!r} B a padded cell), bf16 {k16!r} "
              f"ms ({bound['bfloat16'][0] / k16!r} of {bound['bfloat16'][0]!r}), plain fp32 {kp!r} ms{lib_txt}; "
              f"launches {launches.get(name, 0)} on {paths.get(name)} ({smi})")
        check(launches.get(name, 0) > 0, f"{name} was launched on its path ({paths.get(name)})")
        rows.append({
            "name": name, "route": "cuda",
            "source": "fdtd_tpu_torch/csrc/" + ("dft_accum.cu" if name == "dft_fold" else "yee_stream.cu"),
            "replaces": ("none (the fold of the means mode, which the TPU's VMEM bands do not need)"
                         if name == "dft_fold" else "fdtd_tpu/ops/pallas_stream.py:1538" if name.endswith("_shard")
                         else "fdtd_tpu/ops/pallas_dispersive.py:464" if name.startswith("yee_stream_ade")
                         else "fdtd_tpu/ops/pallas_stream_pml.py:329" if "_pml" in name
                         else "fdtd_tpu/ops/pallas_stream.py:207"),
            "launches": launches.get(name, 0), "max_abs_err": err.get(name, 0.0), "ms": k32, "plain_ms": kp,
            "bound_ms": bound["float32"][0], "bound_by": bound["float32"][1],
            "library_ms": t_lib if name == "dft_fold" else None, "path": paths.get(name),
        })
    for key, r_ in rates.items():
        print(f"rate {n}^3 --dft x{cfg16.nf} {key}: {rate_txt(r_)} Mcells/s ({smi})")
    for key in sorted({k.rsplit(" ", 1)[0] for k in rates}):
        s_, t_ = rates[key + " stream"], rates[key + " twopass"]
        print(f"ratio {n}^3 --dft x{cfg16.nf} {key} stream / twopass: x{s_[0] / t_[0]!r} of the medians "
              f"(x{s_[1] / t_[2]!r}-x{s_[2] / t_[1]!r} over the runs' extremes) ({smi})")
    for name, (b_ms, m_ms) in bands_ms.items():
        f_ms = t_fold1 / depth
        print(f"bands vs means {name} ({n}^3, one frequency, fp32): the bands {b_ms!r} ms a step, the means mode "
              f"{m_ms!r} + its fold {f_ms!r} = {m_ms + f_ms!r} ms a step (x{b_ms / (m_ms + f_ms)!r}) ({smi})")
    return rows


def phase_sar(dev, smi: str, water256=None) -> list[dict]:
    """Phase 6f: the per-step SAR increment kernel (``csrc/dft_accum.cu::
    sar_accum_kernel``, ``ops/sar.py``) against its plain version
    (``diagnostics.accumulate_power``, torch ops on the card) bit for bit,
    at 64^3 and 256^3, fp32 and bf16, on the whole grid and on a middle
    slab of --shard 4, from random fields, sigma and a non-zero starting
    map; at 256^3 its time beside its byte bound and the plain version's;
    then configs/heating_256.txt --water-block --sar, 1000 steps, on
    twopass (one ``sar_accum`` launch a step), on torch (none) and on
    twopass with --shard 4 (four ``sar_accum_shard`` a step): equal maps
    and fields bit for bit (``water256``: the scene's load, built once).
    Returns the kernel's JSON rows."""
    import torch

    from fdtd_tpu_torch import diagnostics
    from fdtd_tpu_torch.ops import sar as sar_ops
    from fdtd_tpu_torch.parallel import mesh as shard_mesh
    from fdtd_tpu_torch.params import Mode, Params, load_parameters, time_values
    from fdtd_tpu_torch.runner import run_simulation
    from fdtd_tpu_torch.state import FieldState, water_block

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)

    def rand(shape, lo: float, hi: float, dtype):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype)

    ms: dict[str, dict] = {}  # kernel -> {dtype: (kernel ms, plain ms, bound ms, bound by)}
    for n in (64, 256):
        for dtype, tdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            pn = Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=1e-3, time_step=1e-12,
                        simulation_time=1e-9, sampling_rate=10**6, mode=Mode.COMPUTATION, dtype=dtype)
            cells = (pn.maxk, pn.maxj, pn.maxi)
            st = FieldState(*(rand(pn.padded_shape, -300.0, 300.0, tdt) for _ in range(6)))
            sigma = rand(cells, 0.0, 2.0, tdt)
            acc0 = rand(cells, 0.0, 1e-6, torch.float32)
            middle = shard_mesh.shard_boxes(pn, shard_mesh.Mesh((4, 1, 1), (dev,) * 4), 1)[1]
            for box in (None, middle):
                if box is None:
                    s_, sg, a0 = st, sigma, acc0
                else:
                    s_ = FieldState(*(shard_mesh.part(t, box.lo, box.hi, dev) for t in st.tensors()))
                    sg, a0 = (shard_mesh.part(t, *box.cells(pn), dev) for t in (sigma, acc0))
                want, got = a0.clone(), a0.clone()
                diagnostics.accumulate_power(pn, s_, sg, want, box)
                sar_ops.accumulate_power(pn, s_, sg, got, box)
                torch.cuda.synchronize()
                name = "sar_accum" + ("_shard" if box is not None else "")
                label = "a middle slab of --shard 4" if box is not None else "the whole grid"
                check(torch.equal(got, want) and absdiff(want, a0) > 0,
                      f"{name} {n}^3 {dtype} on {label}: kernel == plain bit for bit (max|diff| "
                      f"{absdiff(got, want)!r}, increment up to {absdiff(want, a0)!r})")
                if n == 256:
                    t_k = event_ms(lambda: sar_ops.accumulate_power(pn, s_, sg, got, box))
                    t_p = event_ms(lambda: diagnostics.accumulate_power(pn, s_, sg, want, box), reps=5)
                    item = 4 if dtype == "float32" else 2
                    n_cells = math.prod(box.cell_shape(pn) if box is not None else cells)
                    e_vals = math.prod(box.shape if box is not None else pn.padded_shape)
                    t_b = (3 * item * e_vals + (item + 8) * n_cells) / HBM_BYTES_PER_S * 1e3
                    t_f = 20 * n_cells / FP32_FLOPS * 1e3
                    ms.setdefault(name, {})[dtype] = (t_k, t_p, max(t_b, t_f), "bytes" if t_b >= t_f else "operations")
                del want, got
            del st, sigma, acc0
    torch.cuda.empty_cache()
    t_runs = time.perf_counter()
    ph = load_parameters("configs/heating_256.txt", dtype="float32")
    water = water256 if water256 is not None else water_block(ph)
    nh = len(time_values(ph))
    runs = {}
    for tag, backend, shard in (("twopass", "twopass", None), ("torch", "torch", None),
                                ("twopass --shard 4", "twopass", "4")):
        sar_ops.reset_launches()
        res = run_simulation(ph, dev, materials=water, accumulate_power=True, write_snapshots=False, backend=backend,
                             shard=shard, log=lambda m: None)
        runs[tag] = (res.state, res.power_j, dict(sar_ops.launches), res.mcells_per_s)
        del res
    want = {"twopass": {"sar_accum": nh, "sar_accum_shard": 0}, "torch": {"sar_accum": 0, "sar_accum_shard": 0},
            "twopass --shard 4": {"sar_accum": 0, "sar_accum_shard": 4 * nh}}
    for tag, (state, power, counts, rate) in runs.items():
        d, d_acc = maxdiff(state, runs["torch"][0]), absdiff(power, runs["torch"][1])
        check(counts == want[tag] and d == 0.0 and d_acc == 0.0 and float(power.max()) > 0,
              f"heating_256 --water-block --sar {tag}, {nh} steps: launches {counts} == {want[tag]}; against "
              f"torch fields max|diff| {d!r}, SAR max|diff| {d_acc!r} ({rate!r} Mcells/s)")
    runs_s = time.perf_counter() - t_runs
    del runs
    torch.cuda.empty_cache()
    rows = []
    for name, by_dtype in ms.items():
        k32, p32, b32, by = by_dtype["float32"]
        k16, p16, b16, _ = by_dtype["bfloat16"]
        shard = name.endswith("_shard")
        where = "a middle slab of --shard 4" if shard else "the whole grid"
        print(f"kernel 256^3 {name} ({where}): fp32 {k32!r} ms ({b32 / k32!r} of its bound {b32!r} ms, "
              f"{by}), bf16 {k16!r} ms ({b16 / k16!r} of {b16!r}); plain torch ops fp32 {p32!r} / bf16 {p16!r} ms "
              f"(x{p32 / k32!r} / x{p16 / k16!r}) ({smi})")
        rows.append({
            "name": name, "route": "cuda", "source": "fdtd_tpu_torch/csrc/dft_accum.cu",
            "replaces": "none (the XLA fusion of the per-step increment, fdtd_tpu/step.py:384-397)",
            "launches": 4 * nh if shard else nh, "max_abs_err": 0.0, "ms": k32, "plain_ms": p32,
            "bound_ms": b32, "bound_by": by, "library_ms": None,
            "path": f"heating_256 --water-block --sar twopass{' --shard 4' if shard else ''} ({nh} steps)",
        })
    print(f"phase 6f the SAR increment kernel: {time.perf_counter() - t_phase:.1f} s, of which the three "
          f"{nh}-step runs {runs_s:.1f} s", flush=True)
    return rows


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
    from fdtd_tpu_torch.grid import COMPONENTS, Box
    from concurrent.futures import ThreadPoolExecutor

    from fdtd_tpu_torch.dft import DftConfig, dft_weights, zero_dft_acc
    from fdtd_tpu_torch.monitors import ProbeSet
    from fdtd_tpu_torch.ops import build, cpml, curl, stream, stream_plan, yee
    from fdtd_tpu_torch.ops import dft as dft_ops
    from fdtd_tpu_torch.ops.cpml import PMLConfig, PsiState, init_psi, make_cpml, psi_shapes
    from fdtd_tpu_torch.ops.dispersive import (DebyeMaterials, PolState, debye_coefs, update_e_ade,
                                               water_debye_load, zero_polarization, zero_work)
    from fdtd_tpu_torch.params import Mode, Params, load_parameters, time_values
    from fdtd_tpu_torch.io.snapshots import aggregate_all
    from fdtd_tpu_torch.runner import initial_state, resolve_backend, run_simulation
    from fdtd_tpu_torch.source import apply_source, make_source_plan, profile_tensor, sweep_drive_rows
    from fdtd_tpu_torch.state import FieldState, ferrite_slab, field_dtype, update_coefs, water_block
    from fdtd_tpu_torch.step import make_chunk_runner, scan_inputs, zero_power_acc

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - t_phase[0]:.1f} s (total {now - t_start:.1f} s)", flush=True)
        t_phase[0] = now

    PML_CHECK = PMLConfig(cells=6)  # the kernel checks' absorber
    PML10 = PMLConfig(cells=10)  # --pml 10
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    nvcc = build.find_nvcc()
    nvcc_ver = run_cmd([nvcc, "--version"]).splitlines()[-1] if nvcc else "not found"
    free0, total0 = torch.cuda.mem_get_info(dev)
    print(smi, flush=True)
    print(f"versions: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, nvcc {nvcc_ver}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"device memory {free0} B free of {total0} B", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    # the three sources, and the sweeps' means mode (a build of yee_stream.cu of its own)
    builds = ((yee.KERNEL_SOURCE, ()), (stream.KERNEL_SOURCE, ()), (dft_ops.KERNEL_SOURCE, ()),
              (stream.KERNEL_SOURCE, stream.FOLD_DEFINES))
    with ThreadPoolExecutor(len(builds)) as pool:
        lib_paths = list(pool.map(lambda b: build.build(b[0], defines=b[1]), builds))
    build_s = time.perf_counter() - t0
    for lib_path in lib_paths:
        log = lib_path.with_suffix(".log").read_text() if lib_path.with_suffix(".log").exists() else ""
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas {lib_path.name}: {line.strip()}")
    print(f"build: {', '.join(lp.name for lp in lib_paths)} in {build_s:.2f} s", flush=True)
    # the parent commit's package (PARENT: the repository's git history, else
    # scratch_chip/parent): its machine code against this tree's (phase 9,
    # compiled on the host beside the card's phases, read at the end), and
    # its means-mode kernels, for phase 6e's 256^3 times in turns
    sass_dir = tempfile.TemporaryDirectory()
    parent_dir = os.path.join(HERE, "scratch_chip", "parent")
    if shutil.which("git") and subprocess.run(["git", "-C", HERE, "cat-file", "-e", PARENT],
                                              capture_output=True).returncode == 0:
        archive = subprocess.run(["git", "-C", HERE, "archive", PARENT, "fdtd_tpu_torch"],
                                 capture_output=True, check=True).stdout
        subprocess.run(["tar", "-x", "-C", sass_dir.name], input=archive, check=True)
        parent_dir = sass_dir.name
    sass_proc = parent_pkg = None
    if os.path.isdir(os.path.join(parent_dir, "fdtd_tpu_torch", "csrc")):
        sass_proc = subprocess.Popen([sys.executable, "-m", "fdtd_tpu_torch.sass_compare", parent_dir, "--json",
                                      os.path.join(sass_dir.name, "sass.json")], cwd=HERE, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        atexit.register(lambda: sass_proc.poll() is None and sass_proc.kill())
    if os.path.isfile(os.path.join(parent_dir, "fdtd_tpu_torch", "__init__.py")):
        from fdtd_tpu_torch.tune_stream import load_parent

        parent_pkg = load_parent(parent_dir)
        for sub in ("state", "ops.cpml", "ops.dft"):
            __import__(f"{parent_pkg.__name__}.{sub}")
    phase_done("1-2 device and build")

    # -- 3. kernel vs plain ------------------------------------------------
    max_err: dict[str, float] = {}

    def record_err(name: str, d: float) -> None:
        max_err[name] = max(max_err.get(name, 0.0), d)

    def compare(p: Params, arrays: dict, steps: int, label: str, coefs=None) -> None:
        """The two-pass kernels against their plain versions; ``coefs``
        with materials picks the het-mu H and lossy E variants."""
        dt = field_dtype(p)
        coefs = coefs or update_coefs(p)
        h_name = "yee_update_h_het" if coefs.heterogeneous_mu else "yee_update_h"
        e_name = "yee_update_e_lossy" if coefs.lossy else "yee_update_e"
        patch = make_source_plan(p).patch if p.mode == Mode.COMPUTATION else None
        k_state = state_from_numpy(arrays, dev, dt)
        p_state = state_from_numpy(arrays, dev, dt)
        err = {h_name: 0.0, e_name: 0.0}
        for _ in range(steps):
            yee.update_h(p, k_state, coefs, patch)
            curl.update_h(p, p_state, coefs, patch)
            torch.cuda.synchronize()
            err[h_name] = max(err[h_name], maxdiff(k_state, p_state))
            yee.update_e(p, k_state, coefs)
            curl.update_e(p, p_state, coefs)
            torch.cuda.synchronize()
            err[e_name] = max(err[e_name], maxdiff(k_state, p_state))
        for name, d in err.items():
            record_err(name, d)
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

    def compare_sweep(p: Params, arrays: dict, s: int, label: str, coefs=None, sar: bool = False) -> None:
        """One sweep of the stream kernel against plain_sweep; ``coefs``
        with materials (and ``sar``) picks the material variant."""
        st, drive, _ = sweep_inputs(p, arrays, s)
        coefs = coefs or update_coefs(p)
        plan = stream_plan.plan_for(p, s, coefs.lossy, coefs.heterogeneous_mu, sar)
        acc_k = acc_p = None
        if sar:
            acc0 = torch.tensor(rng.uniform(0.0, 1e-11, (p.maxk, p.maxj, p.maxi)), dtype=torch.float32,
                                device=dev)
            acc_k, acc_p = acc0.clone(), acc0.clone()
        out = FieldState(*(torch.full_like(t, float("nan")) for t in st.tensors()))
        stream.sweep(p, st, out, coefs, plan, drive, acc_k)
        want = stream.plain_sweep(p, st, coefs, s, drive, acc=acc_p)
        torch.cuda.synchronize()
        d = maxdiff(out, want)
        d_acc = absdiff(acc_k, acc_p) if sar else 0.0
        record_err(plan.kernel, max(d, d_acc))
        K1, J1, I1 = p.padded_shape
        if K1 % plan.tk or J1 % plan.tj or I1 % plan.ti:
            ragged.add((plan.kernel, s, p.padded_shape))
        sar_txt = ""
        if sar:
            moved = float((acc_p - acc0).abs().max())
            check(moved > 0, f"{plan.kernel} s={s} {label}: the sweep deposits (max increment {moved!r})")
            sar_txt = f", accumulator max|diff| = {d_acc!r}"
        check(d == 0.0 and d_acc == 0.0,
              f"{plan.kernel} == plain_sweep, s={s} tile (k,j,i)=({plan.tk},{plan.tj},{plan.ti}) "
              f"{plan.blocks} blocks, {label}: fields max|diff| = {d!r}{sar_txt}")

    def random_psi(p: Params, cfg: PMLConfig) -> PsiState:
        """Non-zero psi in every term (all twelve engaged from the start)."""
        shapes = psi_shapes(p, cfg)
        return PsiState(**{n: torch.tensor(rng.uniform(-1e-2, 1e-2, shapes[n]), dtype=field_dtype(p),
                                           device=dev) for n in PsiState.names()})

    def compare_pml(p: Params, arrays: dict, steps: int, label: str, coefs=None, cfg=None) -> None:
        """The CPML two-pass kernels against Cpml.plain_h/plain_e: fields
        and the twelve psi; ``coefs`` with materials picks the het-mu H and
        lossy E variants; ``cfg`` the absorber (default PML_CHECK)."""
        dt = field_dtype(p)
        coefs = coefs or update_coefs(p)
        cfg = cfg or PML_CHECK
        cp = make_cpml(p, cfg, coefs, dev)
        h_name = "yee_update_h_het_pml" if coefs.heterogeneous_mu else "yee_update_h_pml"
        e_name = "yee_update_e_lossy_pml" if coefs.lossy else "yee_update_e_pml"
        patch = make_source_plan(p).patch if p.mode == Mode.COMPUTATION else None
        k_state, p_state = state_from_numpy(arrays, dev, dt), state_from_numpy(arrays, dev, dt)
        k_psi = random_psi(p, cfg)
        p_psi, psi0 = k_psi.clone(), k_psi.clone()
        err = {h_name: 0.0, e_name: 0.0}
        for _ in range(steps):
            yee.update_h(p, k_state, coefs, patch, cp, k_psi)
            cp.plain_h(p, p_state, coefs, p_psi, patch)
            torch.cuda.synchronize()
            err[h_name] = max(err[h_name], maxdiff(k_state, p_state), maxdiff(k_psi, p_psi))
            yee.update_e(p, k_state, coefs, cp, k_psi)
            cp.plain_e(p, p_state, coefs, p_psi)
            torch.cuda.synchronize()
            err[e_name] = max(err[e_name], maxdiff(k_state, p_state), maxdiff(k_psi, p_psi))
        moved = sum(not torch.equal(a, b) for a, b in zip(k_psi.tensors(), psi0.tensors()))
        for name, d in err.items():
            record_err(name, d)
            check(d == 0.0 and moved == 12,
                  f"{name} == plain over {steps} steps, fields and psi ({moved} of 12 terms advanced), "
                  f"{label}: max|diff| = {d!r}")

    def compare_sweep_pml(p: Params, arrays: dict, s: int, label: str, coefs=None, cfg=None) -> None:
        """One CPML sweep against plain_sweep: fields and both psi sets."""
        cfg = cfg or PML_CHECK
        st, drive, _ = sweep_inputs(p, arrays, s)
        coefs = coefs or update_coefs(p)
        cp = make_cpml(p, cfg, coefs, dev)
        plan = stream_plan.plan_for(p, s, coefs.lossy, pml=cfg)
        psi = random_psi(p, cfg)
        out = FieldState(*(torch.full_like(t, float("nan")) for t in st.tensors()))
        psi_out = PsiState(*(torch.full_like(t, float("nan")) for t in psi.tensors()))
        stream.sweep(p, st, out, coefs, plan, drive, None, cp, psi, psi_out)
        want_psi = PsiState(*(torch.empty_like(t) for t in psi.tensors()))
        want = stream.plain_sweep(p, st, coefs, s, drive, None, None, cp, psi, want_psi)
        torch.cuda.synchronize()
        d = max(maxdiff(out, want), maxdiff(psi_out, want_psi))
        moved = sum(not torch.equal(a, b) for a, b in zip(psi_out.tensors(), psi.tensors()))
        record_err(plan.kernel, d)
        if plan.core is not None:  # the interior's launch wrote its window of the same outputs
            record_err(plan.kernel + stream.INTERIOR, d)
        K1, J1, I1 = p.padded_shape
        if K1 % plan.tk or J1 % plan.tj or I1 % plan.ti:
            ragged.add((plan.kernel, s, p.padded_shape))
        check(d == 0.0 and moved == 12,
              f"{plan.kernel} == plain_sweep, s={s} tile (k,j,i)=({plan.tk},{plan.tj},{plan.ti}) "
              f"{plan.blocks} blocks, {label}: fields and psi max|diff| = {d!r} ({moved} of 12 terms advanced)")

    def random_pol(p: Params, dc) -> PolState:
        """Random P of order eps0*d_eps on the edges the Debye load relaxes
        on (k2 > 0), zero elsewhere (as a real state)."""
        return PolState(*(torch.where(dc.k2[c] > 0, torch.tensor(rng.uniform(-1e-9, 1e-9, p.padded_shape),
                                                                 dtype=field_dtype(p), device=dev), 0.0)
                          for c in "xyz"))

    def compare_ade(p: Params, arrays: dict, steps: int, label: str, dm) -> None:
        """The ADE E kernel (with and without its SAR work) against
        update_e_ade, each step after the vacuum H kernel and its plain
        version: fields, P and the three work arrays."""
        dt = field_dtype(p)
        dc, coefs = debye_coefs(p, dm, dev), update_coefs(p)
        patch = make_source_plan(p).patch if p.mode == Mode.COMPUTATION else None
        for sar in (False, True):
            name = "yee_update_e_ade_sar" if sar else "yee_update_e_ade"
            k_state, p_state = state_from_numpy(arrays, dev, dt), state_from_numpy(arrays, dev, dt)
            k_pol = random_pol(p, dc)
            p_pol, pol0 = k_pol.clone(), k_pol.clone()
            k_w = tuple(torch.full_like(w, float("nan")) for w in zero_work(p, dev)) if sar else None
            p_w = zero_work(p, dev) if sar else None
            err = 0.0
            for _ in range(steps):
                yee.update_h(p, k_state, coefs, patch)
                curl.update_h(p, p_state, coefs, patch)
                yee.update_e_ade(p, k_state, k_pol, dc, k_w)
                update_e_ade(p, p_state, p_pol, dc, p_w)
                torch.cuda.synchronize()
                err = max(err, maxdiff(k_state, p_state), maxdiff(k_pol, p_pol), maxdiff(k_w, p_w) if sar else 0.0)
            moved = sum(not torch.equal(a, b) for a, b in zip(k_pol.tensors(), pol0.tensors()))
            w_peak = max(float(w.abs().max()) for w in p_w) if sar else 1.0
            record_err(name, err)
            check(err == 0.0 and moved == 3 and w_peak > 0,
                  f"{name} == update_e_ade over {steps} steps, fields, P ({moved} of 3 moved)"
                  f"{' and work' if sar else ''}, {label}: max|diff| = {err!r}")

    def compare_sweep_ade(p: Params, arrays: dict, label: str, dm, sar: bool, dc=None) -> None:
        """One ADE sweep at the depth its variant is built at against
        plain_sweep: fields, both P sets and the SAR map (``dc``: the maps
        of ``dm``, built here when None)."""
        dc, coefs = dc or debye_coefs(p, dm, dev), update_coefs(p)
        plan = stream_plan.pick_plan(p, sar=sar, ade=True)
        st, drive, _ = sweep_inputs(p, arrays, plan.s)
        pol = random_pol(p, dc)
        acc_k = acc_p = acc0 = None
        if sar:
            acc0 = torch.tensor(rng.uniform(0.0, 1e-11, (p.maxk, p.maxj, p.maxi)), dtype=torch.float32, device=dev)
            acc_k, acc_p = acc0.clone(), acc0.clone()
        out = FieldState(*(torch.full_like(t, float("nan")) for t in st.tensors()))
        pol_out = PolState(*(torch.full_like(t, float("nan")) for t in pol.tensors()))
        stream.sweep(p, st, out, coefs, plan, drive, acc_k, dc=dc, pol=pol, pol_out=pol_out)
        want_pol = PolState(*(torch.empty_like(t) for t in pol.tensors()))
        want = stream.plain_sweep(p, st, coefs, plan.s, drive, None, acc_p, dc=dc, pol=pol, pol_out=want_pol)
        torch.cuda.synchronize()
        d = max(maxdiff(out, want), maxdiff(pol_out, want_pol))
        d_acc = absdiff(acc_k, acc_p) if sar else 0.0
        moved = float((acc_p - acc0).abs().max()) if sar else 1.0
        record_err(plan.kernel, max(d, d_acc))
        K1, J1, I1 = p.padded_shape
        if K1 % plan.tk or J1 % plan.tj or I1 % plan.ti:
            ragged.add((plan.kernel, plan.s, p.padded_shape))
        check(d == 0.0 and d_acc == 0.0 and moved > 0,
              f"{plan.kernel} == plain_sweep, s={plan.s} tile (k,j,i)=({plan.tk},{plan.tj},{plan.ti}) "
              f"{plan.blocks} blocks, {label}: fields and P max|diff| = {d!r}"
              f"{f', accumulator {d_acc!r} (max increment {moved!r})' if sar else ''}")

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
            # the material variants: a water block and a ferrite slab
            mats = ferrite_slab(p, base=water_block(p))
            het_coefs = update_coefs(p, mats, dev)
            compare(p, arrays, 2, f"{dtype} {mode.name} water + ferrite {p.padded_shape}", het_coefs)
            if mode != Mode.COMPUTATION:
                continue  # materials stream in computation mode only
            # CPML: the two-pass variants (vacuum; het-mu H + lossy E with a
            # load that reaches into the absorber) in both modes
            overlap = update_coefs(p, ferrite_slab(p, base=water_block(p, lo=(0.02,) * 3, hi=(0.98,) * 3)), dev)
            compare_pml(p, arrays, 2, f"{dtype} {mode.name} random {p.padded_shape}")
            compare_pml(p, arrays, 2, f"{dtype} {mode.name} water + ferrite into the slabs", overlap)
            # 24-cell walls: the source patch (j 21..27) reaches into the j slabs (j < 24)
            thick = PMLConfig(cells=24)
            j0p, _j1p, _i0p, _i1p = make_source_plan(p).patch
            check(j0p < thick.cells, f"the source patch {make_source_plan(p).patch} lies partly in the 24-cell j slab")
            compare_pml(p, arrays, 2, f"{dtype} {mode.name} 24-cell walls, the source patch in the j slab", cfg=thick)
            compare_pml(p, arrays, 2, f"{dtype} {mode.name} 24-cell walls, water + ferrite", overlap, cfg=thick)
            del overlap
            if mode == Mode.COMPUTATION:
                # the CPML sweep, vacuum and lossy (a load into the slabs)
                wide = update_coefs(p, water_block(p, lo=(0.02,) * 3, hi=(0.98,) * 3), dev)
                for s in stream_plan.BLOCK_J_PML:
                    compare_sweep_pml(p, arrays, s, f"{dtype} random {p.padded_shape}")
                    compare_sweep_pml(p, arrays, s, f"{dtype} water into the slabs {p.padded_shape}", wide)
                del wide
            lossy_coefs = update_coefs(p, water_block(p), dev)
            for coefs_m, scene_m in ((lossy_coefs, "water"), (het_coefs, "water + ferrite")):
                for sar in (False, True):
                    for s in stream_plan.STEPS:
                        compare_sweep(p, arrays, s, f"{dtype} {scene_m} random {p.padded_shape}",
                                      coefs_m, sar)
            # Debye: the ADE E pass and the ADE sweep (a salty load over most of the box)
            debye_m = water_debye_load(p, lo=(0.05,) * 3, hi=(0.95,) * 3, sigma_ion25=0.5)
            compare_ade(p, arrays, 2, f"{dtype} Debye random {p.padded_shape}", debye_m)
            for sar in (False, True):
                compare_sweep_ade(p, arrays, f"{dtype} Debye random {p.padded_shape}", debye_m, sar)
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
    # bf16 rows that ring_kernel's warps stage whole: the boxes above have an
    # even pitch (62: rows that start on even elements) or rows of 13, so a
    # 64^3 grid (65-wide rows that start on odd elements and take 17 words;
    # 65^3 elements, the last of them even) runs every built variant at
    # every built depth, and the Debye sweeps
    p = Params(length=0.064, width=0.064, height=0.064, spatial_step=0.001, time_step=1e-12,
               simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype="bfloat16")
    arrays = {c: rng.uniform(-1.0, 1.0, p.padded_shape) for c in COMPONENTS}
    label = f"bfloat16 odd pitch {p.padded_shape}"
    for s in stream_plan.STEPS:
        compare_sweep(p, arrays, s, f"{label} random")
    for mats, scene_m in ((water_block(p), "water"), (ferrite_slab(p, base=water_block(p)), "water + ferrite")):
        coefs_m = update_coefs(p, mats, dev)
        for sar in (False, True):
            for s in stream_plan.STEPS:
                compare_sweep(p, arrays, s, f"{label} {scene_m}", coefs_m, sar)
    for sar in (False, True):
        compare_sweep_ade(p, arrays, f"{label} Debye", water_debye_load(p, lo=(0.05,) * 3, hi=(0.95,) * 3), sar)
    check(bool(ragged), f"stream tiles that do not divide the box were checked: {sorted(ragged)}")

    # update_coefs is a pure function of the grid, the step, the dtype and
    # the materials, and its fp64 host build takes seconds at 256^3: the
    # smoke memoizes it by those (the 256^3 scenes share their grid and
    # step), so the checks below and the later phases' runners share builds
    import fdtd_tpu_torch.parallel.sharded_step as sharded_step_mod
    import fdtd_tpu_torch.step as step_mod
    coef_cache: dict = {}

    def coef_key(pm: Params, mats, device) -> tuple:
        return (pm.padded_shape, pm.spatial_step, pm.time_step, pm.dtype, id(mats), str(device))

    def memo_update_coefs(pm: Params, mats=None, device=None):
        key = coef_key(pm, mats, device)
        if key not in coef_cache:
            coef_cache[key] = (mats, update_coefs(pm, mats, device))  # mats kept: its id stays unique
        return coef_cache[key][1]

    def coefs_of(pm: Params, mats):
        """The update coefficients of ``mats`` (not Debye) for ``pm``'s grid
        and dtype on the card, the runners' build."""
        return memo_update_coefs(pm, mats, dev)

    # one sweep at 256^3 with the main path's plan, both dtypes
    p_main = load_parameters("configs/bench_256.txt", dtype="float32")
    ph = load_parameters("configs/heating_256.txt", dtype="float32")
    check((ph.padded_shape, ph.spatial_step, ph.time_step) == (p_main.padded_shape, p_main.spatial_step,
                                                               p_main.time_step),
          "the heating scene's grid and step are the main path's: the 256^3 checks' maps serve its runs")
    water = water_block(ph)  # the heating scene's load (--water-block), and with the ferrite shelf
    ferrite = ferrite_slab(ph, base=water)
    dc_by_dtype = {}  # the Debye maps of the 256^3 scenes per dtype
    main_plan = stream_plan.pick_plan(p_main)
    print(f"main path plan at 256^3: {main_plan} ({main_plan.blocks} blocks of "
          f"{main_plan.threads} threads, {main_plan.smem_bytes} B shared memory)", flush=True)
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(p_main, dtype=dtype)
        arrays = {c: rng.uniform(-1.0, 1.0, pd.padded_shape).astype(np.float32) for c in COMPONENTS}
        compare_sweep(pd, arrays, main_plan.s, f"{dtype} COMPUTATION random 256^3, main plan")
        # the two-pass CPML passes (march_kernel) on the whole 257^3 grid,
        # vacuum and het-mu H + lossy E with the ferrite scene, from random psi
        compare_pml(pd, arrays, 1, f"{dtype} COMPUTATION random 256^3 --pml 10", cfg=PML10)
        compare_pml(pd, arrays, 1, f"{dtype} COMPUTATION random 256^3 ferrite + --pml 10", coefs_of(pd, ferrite),
                    cfg=PML10)
        # the CPML plan of the --pml 10 path, vacuum and lossy
        pml_plan = stream_plan.pick_plan(pd, pml=PML10)
        compare_sweep_pml(pd, arrays, pml_plan.s, f"{dtype} random 256^3, --pml 10 plan", cfg=PML10)
        compare_sweep_pml(pd, arrays, pml_plan.s, f"{dtype} water random 256^3, --pml 10 plan",
                          coefs_of(pd, water), cfg=PML10)
        # the heating plans: water + SAR, and water + ferrite + SAR
        for mats, scene_m in ((water, "heating"), (ferrite, "heating + ferrite")):
            coefs_m = coefs_of(pd, mats)
            plan_m = stream_plan.pick_plan(pd, lossy=True, het=coefs_m.heterogeneous_mu, sar=True)
            compare_sweep(pd, arrays, plan_m.s, f"{dtype} {scene_m} random 256^3, its plan", coefs_m, True)
            del coefs_m
        # the Debye plans (--water-block --dispersive, with and without --sar);
        # the maps (host fp64, several seconds) stay for the Debye path's runs
        # (phases 6c, 6d and 8: the same grid, step, load and dtype)
        dm_d = water_debye_load(pd)
        t0 = time.perf_counter()
        dc_by_dtype[dtype] = debye_coefs(pd, dm_d, dev)
        torch.cuda.synchronize()
        if dtype == "float32":
            debye_build_s = time.perf_counter() - t0  # the set-up a Debye run pays (phase 8 prints it)
        for sar in (False, True):
            compare_sweep_ade(pd, arrays, f"{dtype} Debye random 256^3, its plan", dm_d, sar, dc_by_dtype[dtype])
        del arrays

    phase_done("3 kernels vs plain")

    def counts_now() -> dict:
        return {**yee.launches, **stream.launches, **dft_ops.launches}

    def reset_counts() -> None:
        yee.reset_launches()
        stream.reset_launches()
        dft_ops.reset_launches()

    def expect(**nonzero) -> dict:
        """Every launch counter 0 except those named."""
        return {**dict.fromkeys(counts_now(), 0), **nonzero}

    # -- 4. validation through the kernels ---------------------------------
    p = load_parameters("configs/reference.txt", dtype="float32")
    ts = time_values(p)
    n = len(ts)
    with tempfile.TemporaryDirectory() as out:
        reset_counts()
        res = run_simulation(p, dev, out_dir=out, backend="twopass",
                             diagnostics_log=os.path.join(out, "diag.jsonl"), log=lambda m: None)
        counts = counts_now()
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
    check(counts == expect(yee_update_h=n, yee_update_e=n),
          f"validation launch counts {counts} == {n} steps")

    # the same scene through stream, as one chunk (rate-2 chunks never
    # reach a sweep: they would all run on twopass)
    p1 = dataclasses.replace(p, sampling_rate=n)
    s_val = stream_plan.pick_plan(p1).s
    with tempfile.TemporaryDirectory() as out:
        reset_counts()
        res = run_simulation(p1, dev, out_dir=out, backend="stream", write_snapshots=False,
                             log=lambda m: None)
        counts = counts_now()
    e_r = analytic.relative_l2_error(p1, res.state, float(ts[-1]))["ey"]
    check(e_r < 0.007, f"validation 50^3 fp32 through stream (s={s_val}) e_r(Ey) = {e_r!r} < 0.007")
    e1 = float(diagnostics.total_energy(p1, res.state.to(dtype=torch.float64)))
    check(abs(e1 - e0) / e0 < 2e-3, f"validation through stream energy drift {abs(e1 - e0) / e0!r} < 2e-3")
    want = expect(yee_update_h=n % s_val, yee_update_e=n % s_val, yee_stream=n // s_val)
    check(counts == want, f"validation through stream launch counts {counts} == {want}")
    phase_done("4 validation")

    # -- 5. the main path at 256^3 -----------------------------------------
    # configs/bench_256.txt with a snapshot every 500 steps; the outputs stay
    # for the sharded run of phase 7 to be held against
    bench_cli = tempfile.mkdtemp()
    params500 = os.path.join(bench_cli, "bench_256_500.txt")
    with open("configs/bench_256.txt") as f:
        vals = f.read().split()
    vals[6] = "500"
    with open(params500, "w") as f:
        f.write("\n".join(vals) + "\n")
    diag = os.path.join(bench_cli, "one.jsonl")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "fdtd_tpu_torch", params500, "--diag-log", diag, "--out", os.path.join(bench_cli, "one")],
        capture_output=True, text=True, timeout=600,
    )
    cli_s = time.perf_counter() - t0
    print(r.stdout.strip().splitlines()[-2] if r.stdout.strip() else "(no CLI output)")
    check(r.returncode == 0 and "Simulation complete!" in r.stdout,
          f"CLI 256^3 x 1000 steps (a snapshot every 500) exit {r.returncode} in {cli_s:.1f} s "
          f"{r.stderr.strip()[-300:]}")
    with open(diag) as f:
        rec = json.loads(f.readline())
    check(rec["iteration"] == 0, "CLI energy log holds the step-0 line")

    p = load_parameters("configs/bench_256.txt", dtype="float32")
    n = len(time_values(p))
    check(resolve_backend(p, "auto", dev) == "stream", "auto resolves to stream at 256^3 fp32")
    finals = {}
    main_rates: dict[str, float] = {}  # the 1000-step runs' Mcells/s, beside the sharded runs' (phase 7)
    main_counts = {}  # kernel -> launches on the run of its path
    paths = {}  # kernel -> the path whose run gave its launches
    for backend in ("twopass", "stream"):
        reset_counts()
        res = run_simulation(p, dev, write_snapshots=False, backend=backend, log=lambda m: None)
        counts = counts_now()
        s_b = main_plan.s if backend == "stream" else 1
        want = (expect(yee_update_h=n, yee_update_e=n) if backend == "twopass" else
                expect(yee_update_h=n % s_b, yee_update_e=n % s_b, yee_stream=n // s_b))
        check(counts == want and n == 1000, f"main path {backend} launch counts {counts} == {want}")
        for name in (("yee_update_h", "yee_update_e") if backend == "twopass" else ("yee_stream",)):
            main_counts[name] = counts[name]
            paths[name] = f"bench_256 {backend}"
        e_e = float(diagnostics.e_energy(p, res.state))
        e_h = float(diagnostics.h_energy(p, res.state))
        check(math.isfinite(e_e + e_h) and e_e > 0 and e_h > 0,
              f"256^3 {backend} final energies E={e_e!r} H={e_h!r} finite and non-zero "
              f"({res.mcells_per_s:.1f} Mcells/s over {res.iterations} steps)")
        check(all(tuple(s.shape) == p.padded_shape and bool(torch.isfinite(s).all())
                  for s in res.state.tensors()), f"all six final fields finite, shape {p.padded_shape}")
        finals[backend] = res.state
        main_rates[f"bench_256 {backend}"] = res.mcells_per_s
        del res
    d = maxdiff(finals["stream"], finals["twopass"])
    check(d == 0.0, f"256^3 1000 steps: stream == twopass, max|diff| = {d!r}")
    bench_ref = finals["stream"]  # the unsharded state phase 7 holds the sharded runs against
    del finals

    # from here on the runners look update_coefs up in the memo of phase 3,
    # so the runners of a scene share one build (a memory check drops its
    # scene's entry to count the build it makes)
    step_mod.update_coefs = sharded_step_mod.update_coefs = memo_update_coefs

    def equal_runs(pm: Params, steps: int, backends: tuple, mats=None, sar: bool = False,
                   label: str = "", pml: PMLConfig | None = None, dft=None, dc=None) -> dict:
        """``steps`` steps of each backend from the mode's initial state
        (with materials or CPML: from random fields, so that every cell of
        the load deposits, and every psi term engages, from the first
        step); the fields (and SAR maps, with ``pml`` the twelve psi, in a
        Debye medium P, with ``dft`` the phasor sums) must be equal.
        ``dc``: the Debye maps of ``mats``, when built.  Returns each
        backend's launch counts."""
        tv = time_values(pm)[:steps]
        ts, amps = scan_inputs(pm, tv)
        xs = (ts, amps) + (dft_weights(dft, tv) if dft is not None else ())
        init = None
        if mats is not None or pml is not None:
            init = {c: rng.uniform(-1.0, 1.0, pm.padded_shape).astype(np.float32) for c in COMPONENTS}
        debye = isinstance(mats, DebyeMaterials)
        states, powers, counts, psis, pols, daccs = {}, {}, {}, {}, {}, {}
        for backend in backends:
            s = initial_state(pm, dev) if init is None else state_from_numpy(init, dev, field_dtype(pm))
            powers[backend] = zero_power_acc(pm, dev) if sar else None
            psis[backend] = init_psi(pm, pml, dev) if pml is not None else None
            pols[backend] = zero_polarization(pm, dev) if debye else None
            daccs[backend] = zero_dft_acc(pm, dft, dev) if dft is not None else None
            run_b = make_chunk_runner(pm, dev, mats, backend, accumulate_power=sar, pml=pml, dft=dft, dc=dc)
            reset_counts()
            run_b(s, xs, powers[backend], psis[backend], pols[backend], daccs[backend])
            torch.cuda.synchronize()
            counts[backend] = counts_now()
            states[backend] = s
        if pml is not None:
            engaged = sum(float(t.abs().max()) > 0 for t in psis[backends[0]].tensors())
            check(engaged == 12, f"{pm.maxk}^3 {label}{steps} steps: {engaged} of 12 psi terms engaged")
        if debye:
            moved = sum(float(t.abs().max()) > 0 for t in pols[backends[0]].tensors())
            check(moved == 3, f"{pm.maxk}^3 {label}{steps} steps: P moved in {moved} of 3 components")
        for a, b in zip(backends, backends[1:]):
            d = maxdiff(states[a], states[b])
            if pml is not None:
                d = max(d, maxdiff(psis[a], psis[b]))
            if debye:
                d = max(d, maxdiff(pols[a], pols[b]))
            if dft is not None:
                d = max(d, maxdiff(daccs[a], daccs[b]))
            d_acc = absdiff(powers[a], powers[b]) if sar else 0.0
            sar_txt = f", SAR max|diff| = {d_acc!r} (peak {float(powers[a].abs().max())!r})" if sar else ""
            check(d == 0.0 and d_acc == 0.0 and (not sar or float(powers[a].abs().max()) > 0),
                  f"{pm.maxk}^3 {pm.mode.name} {label}{steps} steps: {a} == {b}, "
                  f"max|diff| = {d!r}{sar_txt}")
        return counts

    for mode in (Mode.COMPUTATION, Mode.VALIDATION):
        equal_runs(dataclasses.replace(p, mode=mode), 64, ("stream", "twopass", "torch"))
    p512 = load_parameters("configs/bench_256.txt", dtype="float32")
    p512 = dataclasses.replace(p512, length=0.512, width=0.512, height=0.512)
    equal_runs(p512, 16, ("stream", "twopass"))
    torch.cuda.empty_cache()
    phase_done("5 main path")

    # -- 6. the heating path at 256^3 --------------------------------------
    nh = len(time_values(ph))
    heat_plan = stream_plan.pick_plan(ph, lossy=True, sar=True)
    print(f"heating plan at 256^3: {heat_plan} ({heat_plan.blocks} blocks of {heat_plan.threads} "
          f"threads, {heat_plan.smem_bytes} B shared memory)", flush=True)
    # its outputs (a snapshot every 100 steps, the config's rate) stay for
    # the sharded run of phase 7 to be held against; the later heating CLI
    # runs write a snapshot every 500 steps (a params copy), as the bench CLI
    # runs do
    heat_cli = tempfile.mkdtemp()
    heat500 = os.path.join(tempfile.mkdtemp(), "heating_256_500.txt")
    with open("configs/heating_256.txt") as f:
        vals = f.read().split()
    vals[6] = "500"
    with open(heat500, "w") as f:
        f.write("\n".join(vals) + "\n")
    t0 = time.perf_counter()
    r = run_cli(["configs/heating_256.txt", "--water-block", "--sar", "--out", heat_cli])
    cli_s = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    for line in lines[-3:]:
        print(line)
    sar_path = os.path.join(heat_cli, "sar.vtr")
    peak_line = [line for line in lines if line.startswith("SAR map written to")]
    peak = float(peak_line[0].split("(peak ")[1].split()[0]) if peak_line else float("nan")
    n_vtr = len(glob.glob(os.path.join(heat_cli, "result*.vtr")))
    check(r.returncode == 0 and "Simulation complete!" in r.stdout and os.path.exists(sar_path)
          and peak > 0,
          f"CLI heating_256 --water-block --sar exit {r.returncode} in {cli_s:.1f} s: sar.vtr "
          f"{os.path.getsize(sar_path) if os.path.exists(sar_path) else 0} B, peak {peak!r} J/m^3, "
          f"{n_vtr} snapshots {r.stderr.strip()[-300:]}")
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(ph, dtype=dtype)
        check(resolve_backend(pd, "auto", dev, water, accumulate_power=True) == "stream",
              f"auto resolves to stream for heating at 256^3 {dtype}")
    finals, powers = {}, {}
    for backend in ("twopass", "stream"):
        reset_counts()
        res = run_simulation(ph, dev, materials=water, accumulate_power=True, write_snapshots=False,
                             backend=backend, log=lambda m: None)
        counts = counts_now()
        sh = heat_plan.s
        want = (expect(yee_update_h=nh, yee_update_e_lossy=nh) if backend == "twopass" else
                expect(yee_update_h=nh % sh, yee_update_e_lossy=nh % sh, yee_stream_lossy_sar=nh // sh))
        check(counts == want and nh == 1000, f"heating path {backend} launch counts {counts} == {want}")
        for name in (("yee_update_e_lossy",) if backend == "twopass" else ("yee_stream_lossy_sar",)):
            main_counts[name] = counts[name]
            paths[name] = f"heating_256 --water-block --sar {backend}"
        pw = res.power_j
        check(pw is not None and pw.dtype == torch.float32 and tuple(pw.shape) == (ph.maxk, ph.maxj, ph.maxi)
              and bool(torch.isfinite(pw).all()) and float(pw.max()) > 0
              and all(bool(torch.isfinite(t).all()) for t in res.state.tensors()),
              f"heating 256^3 {backend}: SAR map finite, peak {float(pw.max())!r} J/m^3 "
              f"({res.mcells_per_s:.1f} Mcells/s over {res.iterations} steps)")
        finals[backend], powers[backend] = res.state, pw
        main_rates[f"heating_256 {backend}"] = res.mcells_per_s
        del res
    d = maxdiff(finals["stream"], finals["twopass"])
    d_acc = absdiff(powers["stream"], powers["twopass"])
    check(d == 0.0 and d_acc == 0.0,
          f"heating 256^3 1000 steps: stream == twopass, fields max|diff| = {d!r}, SAR max|diff| = {d_acc!r}")
    heat_ref = (finals["stream"], powers["stream"])  # held against the sharded heating runs (phase 7)
    heat_sar = powers["stream"]  # the heat source of phase 10's thermal solve
    del finals, powers

    # a step count that leaves n % s trailing two-pass steps, so that
    # stream's per-step SAR increment after its sweeps is held too
    sf = stream_plan.pick_plan(ph, lossy=True, het=True, sar=True).s
    check(N_LOADS % sf != 0, f"{N_LOADS} steps leave {N_LOADS % sf} trailing two-pass steps at s={sf}")
    counts = equal_runs(ph, N_LOADS, ("stream", "twopass", "torch"), ferrite, True, "water + ferrite + SAR ")
    check(counts["stream"] == expect(yee_stream_lossy_het_sar=N_LOADS // sf, yee_update_h_het=N_LOADS % sf,
                                     yee_update_e_lossy=N_LOADS % sf)
          and counts["twopass"] == expect(yee_update_h_het=N_LOADS, yee_update_e_lossy=N_LOADS),
          f"water + ferrite + SAR launch counts {counts['stream']} / {counts['twopass']}")
    main_counts["yee_stream_lossy_het_sar"] = counts["stream"]["yee_stream_lossy_het_sar"]
    main_counts["yee_update_h_het"] = counts["twopass"]["yee_update_h_het"]
    paths["yee_stream_lossy_het_sar"] = f"heating_256 --water-block --ferrite-slab --sar stream ({N_LOADS} steps)"
    paths["yee_update_h_het"] = f"heating_256 --water-block --ferrite-slab --sar twopass ({N_LOADS} steps)"
    for mats, name, scene_m in ((water, "yee_stream_lossy", "--water-block"),
                                (ferrite, "yee_stream_lossy_het", "--water-block --ferrite-slab")):
        counts = equal_runs(ph, N_LOADS, ("stream", "twopass"), mats, False, f"{scene_m} ")
        sm = stream_plan.pick_plan(ph, lossy=True, het=mats.mu_r is not None).s
        h_m = "yee_update_h_het" if mats.mu_r is not None else "yee_update_h"
        check(counts["stream"] == expect(**{name: N_LOADS // sm, h_m: N_LOADS % sm,
                                            "yee_update_e_lossy": N_LOADS % sm}),
              f"{scene_m} stream launch counts {counts['stream']}")
        main_counts[name] = counts["stream"][name]
        paths[name] = f"heating_256 {scene_m} stream ({N_LOADS} steps)"
    torch.cuda.empty_cache()

    # twopass's device memory: the allocator's peak over a water + ferrite
    # + SAR chunk against the model (one state, the material arrays, the
    # SAR slab temporaries), and the model where no stream plan fits
    coef_cache.pop(coef_key(ph, ferrite, dev), None)  # the build this check counts
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    s_m, pw_m = initial_state(ph, dev), zero_power_acc(ph, dev)
    make_chunk_runner(ph, dev, ferrite, "twopass", accumulate_power=True)(
        s_m, scan_inputs(ph, time_values(ph)[:4]), pw_m)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    model = stream_plan.twopass_bytes(ph, True, True, True)
    check(0 < peak <= model, f"twopass 256^3 water + ferrite + SAR peak device memory {peak} B <= model "
                             f"{model} B ({peak / model!r} of it)")
    del s_m, pw_m
    torch.cuda.empty_cache()
    phase_done("6 heating path")
    p1024 = dataclasses.replace(ph, length=1.024, width=1.024, height=1.024)
    need_tp = stream_plan.twopass_bytes(p1024, True, True, True)
    need_st = 2 * stream_plan.state_bytes(p1024) + stream_plan.material_bytes(p1024, True, True, True) \
        + stream_plan.sar_work_bytes(p1024)
    check(not stream_plan.supported(p1024, free0, True, True, True)
          and stream_plan.twopass_fits(p1024, free0, True, True, True),
          f"1024^3 fp32 water + ferrite + SAR: stream needs {need_st} B, twopass {need_tp} B; "
          f"{stream_plan.MEMORY_MARGIN} of the {free0} B free at start: stream refused, twopass fits")

    # -- 6b. the CPML path at 256^3 (--pml 10) ------------------------------
    pml_main = stream_plan.pick_plan(p, pml=PML10)
    print(f"--pml 10 plan at 256^3: {pml_main} ({pml_main.blocks} blocks of {pml_main.threads} threads, "
          f"{pml_main.smem_bytes} B shared memory)", flush=True)
    # the CLI's outputs stay for the sharded CLI of phase 7b to be held against
    pml_cli = tempfile.mkdtemp()
    with contextlib.nullcontext(pml_cli) as out:
        # bench_256.txt with a sampling rate of 500: snapshots 1, 500, 1000
        params_pml = os.path.join(out, "bench_256_rate500.txt")
        with open("configs/bench_256.txt") as f:
            vals = f.read().split()
        vals[6] = "500"
        with open(params_pml, "w") as f:
            f.write("\n".join(vals) + "\n")
        diag = os.path.join(out, "diag.jsonl")
        t0 = time.perf_counter()
        r = run_cli([params_pml, "--pml", "10", "--diag-log", diag, "--out", os.path.join(out, "r")])
        cli_s = time.perf_counter() - t0
        print(r.stdout.strip().splitlines()[-2] if r.stdout.strip() else "(no CLI output)")
        files = sorted(os.path.basename(f) for f in glob.glob(os.path.join(out, "r", "*.vtr")))
        recs = []
        if os.path.exists(diag):
            with open(diag) as f:
                recs = [json.loads(line) for line in f]
        radiated = [rec.get("radiated_W") for rec in recs]
        check(r.returncode == 0 and "Simulation complete!" in r.stdout
              and files == ["result0001.vtr", "result0500.vtr", "result1000.vtr"]
              and [rec["iteration"] for rec in recs] == [0, 500, 1000]
              and all(x is not None and math.isfinite(x) for x in radiated) and radiated[-1] != 0,
              f"CLI bench_256 --pml 10 (rate 500) exit {r.returncode} in {cli_s:.1f} s: {files}, "
              f"radiated_W {radiated} {r.stderr.strip()[-300:]}")
    # 1000 steps on twopass and on stream in fp32 and bf16, in turns: auto
    # picks stream in exactly the dtypes where it runs faster than twopass
    # here, and keeps stream where the two are tied (ROUTE_TIE)
    finals, final_psi = {}, {}
    for dtype in ("float32", "bfloat16"):
        pd_ = dataclasses.replace(p, dtype=dtype)
        tag = "" if dtype == "float32" else " bf16"
        for backend in ("twopass", "stream") + (("torch",) if dtype == "float32" else ()):
            reset_counts()
            res = run_simulation(pd_, dev, write_snapshots=False, backend=backend, pml=PML10, log=lambda m: None)
            counts = counts_now()
            sp = pml_main.s
            want = (expect(yee_update_h_pml=n, yee_update_e_pml=n) if backend == "twopass" else expect()
                    if backend == "torch" else
                    expect(yee_update_h_pml=n % sp, yee_update_e_pml=n % sp, yee_stream_pml=n // sp,
                           yee_stream_pml_interior=n // sp))
            check(counts == want and n == 1000, f"--pml 10 path {dtype} {backend} launch counts {counts} == {want}")
            if dtype == "float32":
                for name in (("yee_update_h_pml", "yee_update_e_pml") if backend == "twopass" else () if
                             backend == "torch" else ("yee_stream_pml", "yee_stream_pml_interior")):
                    main_counts[name] = counts[name]
                    paths[name] = f"bench_256 --pml 10 {backend}"
                finals[backend], final_psi[backend] = res.state, res.psi
            e_tot = float(diagnostics.total_energy(pd_, res.state))
            check(math.isfinite(e_tot) and e_tot > 0
                  and all(bool(torch.isfinite(t).all()) for t in res.state.tensors())
                  and all(bool(torch.isfinite(t).all()) for t in res.psi.tensors()),
                  f"--pml 10 256^3 {dtype} {backend}: fields and psi finite, energy {e_tot!r} "
                  f"({res.mcells_per_s:.1f} Mcells/s over {res.iterations} steps)")
            main_rates[f"bench_256 --pml 10{tag} {backend}"] = res.mcells_per_s
            del res
        # the second half of the turns (twopass, stream, stream, twopass):
        # each backend's rate is the mean of its two runs
        runs = {}
        for backend in ("stream", "twopass"):
            first = main_rates[f"bench_256 --pml 10{tag} {backend}"]
            res = run_simulation(pd_, dev, write_snapshots=False, backend=backend, pml=PML10, log=lambda m: None)
            runs[backend] = (first, res.mcells_per_s)
            main_rates[f"bench_256 --pml 10{tag} {backend}"] = (first + res.mcells_per_s) / 2
            del res
        reset_counts()
        r_st, r_tp = (main_rates[f"bench_256 --pml 10{tag} {b}"] for b in ("stream", "twopass"))
        gap = abs(r_st - r_tp) / max(r_st, r_tp)
        routed = resolve_backend(pd_, "auto", dev, pml=PML10)
        check((routed == "stream" if gap < ROUTE_TIE else routed == ("stream" if r_st > r_tp else "twopass"))
              and resolve_backend(pd_, "twopass", dev, pml=PML10) == "twopass",
              f"auto resolves to {routed} for --pml 10 at 256^3 {dtype}: stream {r_st:.1f} against twopass "
              f"{r_tp:.1f} Mcells/s over 1000 steps, each the mean of two runs in turns {runs} (gap {gap!r}"
              f"{'; within ROUTE_TIE, a tie: auto keeps stream' if gap < ROUTE_TIE else ''}); twopass is admitted "
              f"when asked")
    d = max(maxdiff(finals[b], finals["twopass"]) for b in ("stream", "torch"))
    d = max(d, *(maxdiff(final_psi[b], final_psi["twopass"]) for b in ("stream", "torch")))
    check(d == 0.0, f"--pml 10 256^3 1000 steps fp32: stream == twopass == torch, fields and psi max|diff| = {d!r}")
    pml_ref = (finals["twopass"], final_psi["twopass"])  # held against the sharded CPML run (phase 7b)
    del finals, final_psi
    # 64 steps from random fields: stream = twopass = torch with --water-block
    # (in vacuum the 1000-step runs above hold the three backends equal)
    counts = equal_runs(p, 64, ("stream", "twopass", "torch"), water, False, "--water-block --pml 10 ", PML10)
    sw_ = stream_plan.pick_plan(p, lossy=True, pml=PML10).s
    check(counts["stream"] == expect(yee_stream_lossy_pml=64 // sw_, yee_stream_lossy_pml_interior=64 // sw_,
                                     yee_update_h_pml=64 % sw_, yee_update_e_lossy_pml=64 % sw_),
          f"--water-block --pml 10 stream launch counts {counts['stream']}")
    for name in ("yee_stream_lossy_pml", "yee_stream_lossy_pml_interior"):
        main_counts[name] = counts["stream"][name]
        paths[name] = "bench_256 --water-block --pml 10 stream (64 steps)"
    # --water-block --ferrite-slab --sar --pml 10: the CPML sweep's gates
    # refuse het-mu and SAR, so auto runs twopass; held against torch
    check(resolve_backend(p, "auto", dev, ferrite, True, PML10) == "twopass",
          "auto resolves to twopass for --water-block --ferrite-slab --sar --pml 10")
    counts = equal_runs(p, N_LOADS, ("twopass", "torch"), ferrite, True, "--water-block --ferrite-slab --sar "
                        "--pml 10 ", PML10)
    check(counts["twopass"] == expect(yee_update_h_het_pml=N_LOADS, yee_update_e_lossy_pml=N_LOADS),
          f"--water-block --ferrite-slab --sar --pml 10 twopass launch counts {counts['twopass']}")
    for name in ("yee_update_h_het_pml", "yee_update_e_lossy_pml"):
        main_counts[name] = counts["twopass"][name]
        paths[name] = f"bench_256 --water-block --ferrite-slab --sar --pml 10 twopass ({N_LOADS} steps)"
    torch.cuda.empty_cache()

    # physics through the kernels: the absorption test (twopass) and the
    # gaussian ring-down (stream and twopass) of tests/test_pml.py
    def box(n_: int, steps: int, mode: Mode) -> Params:
        return Params(length=n_ * 1e-3, width=n_ * 1e-3, height=n_ * 1e-3, spatial_step=0.001,
                      time_step=1e-12, simulation_time=steps * 1e-12, sampling_rate=10**9,
                      mode=mode, dtype="float32")

    pa = box(32, 400, Mode.VALIDATION)
    K1, J1, I1 = pa.padded_shape
    kk, jj, ii = np.ogrid[:K1, :J1, :I1]
    g = np.broadcast_to(np.exp(-((kk - 16) ** 2 + (jj - 16) ** 2 + (ii - 16) ** 2) / 18.0), (K1, J1, I1))
    pulse = {c: np.zeros((K1, J1, I1)) for c in COMPONENTS}
    pulse["ex"][:, 1:, :] = g[:, 1:, :] - g[:, :-1, :]  # E = discrete curl of A_z g: all radiative
    pulse["ey"][:, :, 1:] = -(g[:, :, 1:] - g[:, :, :-1])
    pulse["ey"][:, pa.maxj:, :] = 0.0
    xs_a = scan_inputs(pa, time_values(pa)[:400])
    s0 = state_from_numpy(pulse, dev, torch.float32)
    e0 = float(diagnostics.total_energy(pa, s0))
    pec, absorbed, psi_a = s0.clone(), s0.clone(), init_psi(pa, PMLConfig(cells=8), dev)
    reset_counts()
    make_chunk_runner(pa, dev, backend="twopass")(pec, xs_a)
    make_chunk_runner(pa, dev, backend="twopass", pml=PMLConfig(cells=8))(absorbed, xs_a, None, psi_a)
    torch.cuda.synchronize()
    e_pec, e_pml = float(diagnostics.total_energy(pa, pec)), float(diagnostics.total_energy(pa, absorbed))
    check(e_pec > 0.2 * e0 and e_pml < 1e-3 * e_pec and e_pml < 1e-3 * e0
          and counts_now()["yee_update_h_pml"] == 400,
          f"absorption 32^3 x 400 steps through twopass (8-cell CPML): E_pml/E_pec = {e_pml / e_pec!r} "
          f"< 1e-3, E_pec/E_0 = {e_pec / e0!r} > 0.2")
    pr = box(24, PML_STEPS_RINGDOWN, Mode.COMPUTATION)
    pr = dataclasses.replace(pr, source=dataclasses.replace(pr.source, envelope="gaussian", pulse_width=8e-11))
    ring = PMLConfig(cells=4)
    tv = time_values(pr)
    for backend in ("stream", "twopass"):
        st_r, psi_r = initial_state(pr, dev), init_psi(pr, ring, dev)
        run_r = make_chunk_runner(pr, dev, backend=backend, pml=ring)
        reset_counts()
        run_r(st_r, scan_inputs(pr, tv[:300]), None, psi_r)
        e_mid = float(diagnostics.total_energy(pr, st_r))
        run_r(st_r, scan_inputs(pr, tv[300:]), None, psi_r)
        torch.cuda.synchronize()
        e_end = float(diagnostics.total_energy(pr, st_r))
        used = {k: v for k, v in counts_now().items() if v}
        ran = (used.get("yee_stream_pml", 0) == PML_STEPS_RINGDOWN // run_r.plan.s if backend == "stream"
               else used == {"yee_update_h_pml": PML_STEPS_RINGDOWN, "yee_update_e_pml": PML_STEPS_RINGDOWN})
        check(e_mid > 0 and e_end < 2e-2 * e_mid and ran,
              f"gaussian ring-down 24^3 x {PML_STEPS_RINGDOWN} steps through {backend} (4-cell CPML): "
              f"E_end/E_mid = {e_end / e_mid!r} < 2e-2; launches {used}")

    phase_done("6b CPML path")

    # -- 6c. the Debye path at 256^3 (--water-block --dispersive --sar) -----
    debye = water_debye_load(ph)
    dc_debye = dc_by_dtype["float32"]  # built once (phase 3) for every run of the scene
    ade_plan = stream_plan.pick_plan(ph, sar=True, ade=True)
    s_ade = ade_plan.s
    print(f"Debye + SAR plan at 256^3: {ade_plan} ({ade_plan.blocks} blocks of {ade_plan.threads} threads, "
          f"{ade_plan.smem_bytes} B shared memory); without SAR: {stream_plan.pick_plan(ph, ade=True)}", flush=True)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        r = run_cli([heat500, "--water-block", "--dispersive", "--sar", "--out", out])
        cli_s = time.perf_counter() - t0
        lines = r.stdout.strip().splitlines()
        for line in lines[-3:]:
            print(line)
        sar_path = os.path.join(out, "sar.vtr")
        peak_line = [line for line in lines if line.startswith("SAR map written to")]
        peak = float(peak_line[0].split("(peak ")[1].split()[0]) if peak_line else float("nan")
        n_vtr = len(glob.glob(os.path.join(out, "result*.vtr")))
        check(r.returncode == 0 and "Simulation complete!" in r.stdout and os.path.exists(sar_path)
              and math.isfinite(peak) and peak > 0,
              f"CLI heating_256 --water-block --dispersive --sar exit {r.returncode} in {cli_s:.1f} s: sar.vtr "
              f"{os.path.getsize(sar_path) if os.path.exists(sar_path) else 0} B, peak {peak!r} J/m^3, "
              f"{n_vtr} snapshots {r.stderr.strip()[-300:]}")
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(ph, dtype=dtype)
        notices: list[str] = []
        routed = (resolve_backend(pd, "auto", dev, debye, True), resolve_backend(pd, "auto", dev, debye, True, PML10,
                                                                                  notices.append))
        try:
            resolve_backend(pd, "twopass", dev, debye, True, PML10)
            refused = False
        except ValueError as e:
            refused = "--backend torch" in str(e)
        check(routed == ("stream", "torch") and len(notices) == 1 and refused,
              f"Debye at 256^3 {dtype}: auto resolves to {routed[0]}, with --pml 10 to {routed[1]} "
              f"({notices[0] if notices else 'no notice'}); twopass with --pml refused: {refused}")
    finals, powers, pols = {}, {}, {}
    for backend in ("twopass", "stream"):
        reset_counts()
        res = run_simulation(ph, dev, materials=debye, accumulate_power=True, write_snapshots=False,
                             backend=backend, log=lambda m: None, dc=dc_debye)
        counts = counts_now()
        want = (expect(yee_update_h=nh, yee_update_e_ade_sar=nh) if backend == "twopass" else
                expect(yee_update_h=nh % s_ade, yee_update_e_ade_sar=nh % s_ade, yee_stream_ade_sar=nh // s_ade))
        check(counts == want and nh == 1000, f"Debye path {backend} launch counts {counts} == {want}")
        name = "yee_update_e_ade_sar" if backend == "twopass" else "yee_stream_ade_sar"
        main_counts[name] = counts[name]
        paths[name] = f"heating_256 --water-block --dispersive --sar {backend}"
        pw = res.power_j
        check(pw is not None and bool(torch.isfinite(pw).all()) and float(pw.max()) > 0
              and all(bool(torch.isfinite(t).all()) for t in res.state.tensors() + res.pol.tensors())
              and float(res.pol.pz.abs().max()) > 0,
              f"Debye 256^3 {backend}: fields, P and SAR finite, SAR peak {float(pw.max())!r} J/m^3, "
              f"|Pz| max {float(res.pol.pz.abs().max())!r} ({res.mcells_per_s:.1f} Mcells/s over {res.iterations} steps)")
        finals[backend], powers[backend], pols[backend] = res.state, pw, res.pol
        main_rates[f"heating_256 --water-block --dispersive --sar {backend}"] = res.mcells_per_s
        del res
    d = max(maxdiff(finals["stream"], finals["twopass"]), maxdiff(pols["stream"], pols["twopass"]))
    d_acc = absdiff(powers["stream"], powers["twopass"])
    check(d == 0.0 and d_acc == 0.0,
          f"Debye 256^3 1000 steps: stream == twopass, fields and P max|diff| = {d!r}, SAR max|diff| = {d_acc!r}")
    debye_ref = (finals["stream"], powers["stream"], pols["stream"])  # held against the sharded Debye run (7b)
    del finals, powers, pols
    # without SAR and with it (s = 2: 33 sweeps + 1 trailing step), from
    # random fields: stream == twopass == torch
    s_nosar = stream_plan.pick_plan(ph, ade=True).s
    for steps_d, sar, name in ((N_LOADS + 1, False, "yee_stream_ade"), (N_LOADS + 1, True, "yee_stream_ade_sar")):
        s_d = s_ade if sar else s_nosar
        e_name = "yee_update_e_ade_sar" if sar else "yee_update_e_ade"
        check(steps_d % s_d != 0, f"{steps_d} steps leave {steps_d % s_d} trailing two-pass steps at s={s_d}")
        counts = equal_runs(ph, steps_d, ("stream", "twopass", "torch"), debye, sar,
                            f"--dispersive{' --sar' if sar else ''} ", dc=dc_debye)
        check(counts["stream"] == expect(**{name: steps_d // s_d, "yee_update_h": steps_d % s_d,
                                            e_name: steps_d % s_d})
              and counts["twopass"] == expect(yee_update_h=steps_d, **{e_name: steps_d})
              and counts["torch"] == expect(),
              f"--dispersive{' --sar' if sar else ''} launch counts {counts['stream']} / {counts['twopass']}")
        if not sar:
            main_counts[name], main_counts[e_name] = counts["stream"][name], counts["twopass"][e_name]
            paths[name] = f"heating_256 --water-block --dispersive stream ({steps_d} steps)"
            paths[e_name] = f"heating_256 --water-block --dispersive twopass ({steps_d} steps)"
    torch.cuda.empty_cache()
    # twopass's device memory with Debye + SAR against its model; the verdicts at 512^3 and 1024^3
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    s_m, pw_m, pol_m = initial_state(ph, dev), zero_power_acc(ph, dev), zero_polarization(ph, dev)
    make_chunk_runner(ph, dev, debye, "twopass", accumulate_power=True)(  # the maps count: built here
        s_m, scan_inputs(ph, time_values(ph)[:4]), pw_m, None, pol_m)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    model = stream_plan.twopass_bytes(ph, sar=True, ade=True)
    check(0 < peak <= model, f"twopass 256^3 Debye + SAR peak device memory {peak} B <= model {model} B "
                             f"({peak / model!r} of it)")
    del s_m, pw_m, pol_m
    torch.cuda.empty_cache()
    verdicts = {}
    for n_side in (512, 1024):
        pn = dataclasses.replace(ph, length=n_side * 1e-3, width=n_side * 1e-3, height=n_side * 1e-3)
        verdicts[n_side] = (stream_plan.stream_bytes(pn, sar=True, ade=True),
                            stream_plan.twopass_bytes(pn, sar=True, ade=True),
                            stream_plan.supported(pn, free0, sar=True, ade=True),
                            stream_plan.twopass_fits(pn, free0, sar=True, ade=True))
    check(verdicts[512][2] and verdicts[512][3] and not verdicts[1024][2] and not verdicts[1024][3],
          f"Debye + SAR fp32 (stream B, twopass B, stream fits, twopass fits) with {free0} B free: "
          f"512^3 {verdicts[512]}, 1024^3 {verdicts[1024]}")

    # Debye x CPML on the card: torch ops (no kernel composes them), a
    # --pml 10 run at 256^3 and the ring-down of tests/test_dispersive.py
    p40 = dataclasses.replace(p, simulation_time=40 * p.time_step)
    notices = []
    reset_counts()
    res = run_simulation(p40, dev, materials=water_debye_load(p40), pml=PML10, accumulate_power=True,
                         write_snapshots=False, log=notices.append)
    check(res.iterations == 40 and counts_now() == expect() and any("torch ADE+CPML" in m for m in notices)
          and all(bool(torch.isfinite(t).all()) for t in res.state.tensors() + res.pol.tensors() + res.psi.tensors())
          and float(res.power_j.max()) >= 0 and float(diagnostics.total_energy(p40, res.state)) > 0,
          f"--water-block --dispersive --sar --pml 10 256^3 x 40 steps on torch ops: finite, no kernel launched, "
          f"{res.mcells_per_s:.1f} Mcells/s; {notices[0] if notices else 'no notice'}")
    del res
    K, J, I = pa.maxk, pa.maxj, pa.maxi
    d_eps = np.zeros((K, J, I))
    d_eps[12:20, 12:20, 12:20] = 6.0
    cube = DebyeMaterials(base=dataclasses.replace(water_block(pa), eps_r=np.ones((K, J, I)), sigma=None),
                          d_eps=d_eps, tau=np.full((K, J, I), 2e-12))
    energies = {}
    for key, mats_r, pml_r in (("dielectric", cube, None), ("radiation", None, PMLConfig(cells=8)),
                               ("both", cube, PMLConfig(cells=8))):
        st_r = state_from_numpy(pulse, dev, torch.float32)
        pol_r = zero_polarization(pa, dev) if mats_r is not None else None
        psi_r = init_psi(pa, pml_r, dev) if pml_r is not None else None
        make_chunk_runner(pa, dev, mats_r, "torch" if mats_r is not None else "twopass", pml=pml_r)(
            st_r, xs_a, None, psi_r, pol_r)
        torch.cuda.synchronize()
        energies[key] = float(diagnostics.total_energy(pa, st_r))
    e_d, e_r, e_b = energies["dielectric"], energies["radiation"], energies["both"]
    check(e_d < 0.9 * e0 and e_r < 1e-3 * e0 and e_b < 0.05 * e_d and e_b < 1e-3 * e0 and e_b < 5 * e_r and e_b > 0,
          f"Debye cube ring-down 32^3 x 400 steps (torch, 8-cell CPML): E/E_0 dielectric {e_d / e0!r}, "
          f"radiation {e_r / e0!r}, both {e_b / e0!r}")

    phase_done("6c Debye path")

    # -- 6d. the monitor path at 256^3 (--dft, --probe) ---------------------
    DFT1 = DftConfig((2.45e10,))  # --dft 2.45e10
    DFT2 = DftConfig((2.45e10, 1.5e10))  # two frequencies, as the JAX tests use

    def random_sums(pm: Params, nf: int) -> tuple:
        shape = (nf, 3, pm.maxk, pm.maxj, pm.maxi)
        return tuple(torch.tensor(rng.uniform(-1.0, 1.0, shape), dtype=torch.float32, device=dev) for _ in range(2))

    def compare_k4(pm: Params, nf: int, label: str) -> None:
        """dft_accum against its plain version from random fields and sums."""
        st = state_from_numpy({c: rng.uniform(-1.0, 1.0, pm.padded_shape).astype(np.float32) for c in COMPONENTS},
                              dev, field_dtype(pm))
        d0 = random_sums(pm, nf)
        w = torch.tensor(rng.uniform(-1.0, 1.0, (2, nf)), dtype=torch.float32, device=dev)
        k, q = tuple(t.clone() for t in d0), tuple(t.clone() for t in d0)
        dft_ops.accumulate_e(pm, st, w, k)
        dft_ops.plain_accumulate_e(pm, st, w, q)
        torch.cuda.synchronize()
        d, moved = maxdiff(k, q), float((q[0] - d0[0]).abs().max())
        record_err("dft_accum", d)
        check(d == 0.0 and moved > 0, f"dft_accum == plain, {label} nf={nf}: sums max|diff| = {d!r} (moved {moved!r})")
        del st, d0, k, q

    def compare_sweep_dft(pm: Params, arrays: dict, label: str, mats=None, sar: bool = False,
                          pml: PMLConfig | None = None, nf: int = 1, dc=None) -> None:
        """One sweep with the DFT bands at its variant's plan against
        plain_sweep, from random sums (and psi, P, SAR map): fields, sums,
        map, psi and P."""
        cfg = DFT1 if nf == 1 else DFT2
        debye_m = isinstance(mats, DebyeMaterials)
        dc = dc or (debye_coefs(pm, mats, dev) if debye_m else None)
        coefs = update_coefs(pm, None if debye_m else mats, dev)
        plan = stream_plan.pick_plan(pm, lossy=coefs.lossy, het=coefs.heterogeneous_mu, sar=sar, pml=pml,
                                     ade=debye_m, dft=cfg)
        st, drive, _ = sweep_inputs(pm, arrays, plan.s)
        cp = make_cpml(pm, pml, coefs, dev) if pml is not None else None
        psi = random_psi(pm, pml) if pml is not None else None
        pol = random_pol(pm, dc) if debye_m else None
        acc0 = (torch.tensor(rng.uniform(0.0, 1e-11, (pm.maxk, pm.maxj, pm.maxi)), dtype=torch.float32, device=dev)
                if sar else None)
        d0 = random_sums(pm, nf)
        wts = torch.tensor(rng.uniform(-1.0, 1.0, (plan.s, 2, nf)), dtype=torch.float32, device=dev)

        def outs(nan: bool):
            like = (lambda t: torch.full_like(t, float("nan"))) if nan else torch.empty_like
            return (FieldState(*(like(t) for t in st.tensors())),
                    PsiState(*(like(t) for t in psi.tensors())) if psi is not None else None,
                    PolState(*(like(t) for t in pol.tensors())) if pol is not None else None,
                    acc0.clone() if sar else None, tuple(t.clone() for t in d0))

        ko, po = outs(True), outs(False)
        stream.sweep(pm, st, ko[0], coefs, plan, drive, ko[3], cp, psi, ko[1], dc, pol, ko[2], ko[4], wts)
        stream.plain_sweep(pm, st, coefs, plan.s, drive, po[0], po[3], cp, psi, po[1], dc, pol, po[2], po[4], wts)
        torch.cuda.synchronize()
        d = max(maxdiff(ko[0], po[0]), maxdiff(ko[4], po[4]),
                maxdiff(ko[1], po[1]) if psi is not None else 0.0, maxdiff(ko[2], po[2]) if pol is not None else 0.0,
                absdiff(ko[3], po[3]) if sar else 0.0)
        moved = float((po[4][0] - d0[0]).abs().max())
        record_err(plan.kernel, d)
        if plan.core is not None:  # the CPML sweep's interior launch wrote its window of the same outputs
            record_err(plan.kernel + stream.INTERIOR, d)
        K1, J1, I1 = pm.padded_shape
        if K1 % plan.tk or J1 % plan.tj or I1 % plan.ti:
            ragged.add((plan.kernel, plan.s, pm.padded_shape))
        check(d == 0.0 and moved > 0,
              f"{plan.kernel} == plain_sweep, s={plan.s} tile (k,j,i)=({plan.tk},{plan.tj},{plan.ti}) {plan.blocks} "
              f"blocks, {label} nf={nf}: fields, sums{', map' if sar else ''}{', psi' if psi else ''}"
              f"{', P' if pol else ''} max|diff| = {d!r} (sums moved {moved!r})")

    ragged.clear()
    for dtype in ("float32", "bfloat16"):
        pr_ = Params(length=0.0615, width=0.0505, height=0.0705, spatial_step=0.001, time_step=1e-12,
                     simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype=dtype)
        arrays = {c: rng.uniform(-1.0, 1.0, pr_.padded_shape) for c in COMPONENTS}
        wb_r, fe_r = water_block(pr_), ferrite_slab(pr_, base=water_block(pr_))
        wide_r = water_block(pr_, lo=(0.02,) * 3, hi=(0.98,) * 3)
        dm_r = water_debye_load(pr_, lo=(0.05,) * 3, hi=(0.95,) * 3, sigma_ion25=0.5)
        dc_r = debye_coefs(pr_, dm_r, dev)
        for nf in (1, 2, 3):
            compare_k4(pr_, nf, f"{dtype} random {pr_.padded_shape}")
        for nf in (1, 2):
            lab = f"{dtype} random {pr_.padded_shape}"
            compare_sweep_dft(pr_, arrays, lab, nf=nf)
            compare_sweep_dft(pr_, arrays, lab + " water", wb_r, nf=nf)
            compare_sweep_dft(pr_, arrays, lab + " water + SAR", wb_r, True, nf=nf)
            compare_sweep_dft(pr_, arrays, lab + " water + ferrite", fe_r, nf=nf)
            compare_sweep_dft(pr_, arrays, lab + " water + ferrite + SAR", fe_r, True, nf=nf)
            compare_sweep_dft(pr_, arrays, lab + " CPML", pml=PML_CHECK, nf=nf)
            compare_sweep_dft(pr_, arrays, lab + " water into the CPML slabs", wide_r, pml=PML_CHECK, nf=nf)
            compare_sweep_dft(pr_, arrays, lab + " Debye", dm_r, nf=nf, dc=dc_r)
            compare_sweep_dft(pr_, arrays, lab + " Debye + SAR", dm_r, True, nf=nf, dc=dc_r)
        del arrays, dc_r
        # the 256^3 plans of the monitor path's scenes
        pd = dataclasses.replace(ph, dtype=dtype)
        arrays = {c: rng.uniform(-1.0, 1.0, pd.padded_shape).astype(np.float32) for c in COMPONENTS}
        compare_k4(pd, 1, f"{dtype} random 256^3")
        if dtype not in dc_by_dtype:  # the maps of the Debye scene per dtype, built once (host fp64)
            dc_by_dtype[dtype] = debye_coefs(pd, debye, dev)
        dc_d = dc_by_dtype[dtype]
        compare_sweep_dft(pd, arrays, f"{dtype} heating 256^3", water, True)
        compare_sweep_dft(pd, arrays, f"{dtype} --pml 10 256^3", pml=PML10)
        compare_sweep_dft(pd, arrays, f"{dtype} Debye + SAR 256^3", debye, True, dc=dc_d)
        if dtype == "float32":
            compare_sweep_dft(pd, arrays, f"{dtype} vacuum 256^3")
            compare_sweep_dft(pd, arrays, f"{dtype} Debye 256^3", debye, dc=dc_d)
        del arrays, dc_d
        torch.cuda.empty_cache()
    check(bool(ragged), f"DFT sweep tiles that do not divide the box were checked: {sorted(ragged)}")
    phase_done("6d kernels vs plain")

    # the CLI: heating with --dft (auto: the lossy + SAR sweep with the bands)
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(ph, dtype=dtype)
        check(resolve_backend(pd, "auto", dev, water, True, dft=DFT1) == "stream"
              and resolve_backend(pd, "auto", dev, pml=PML10, dft=DFT1) == "stream"
              and resolve_backend(pd, "twopass", dev, pml=PML10, dft=DFT1) == "twopass"
              and resolve_backend(pd, "auto", dev, debye, True, dft=DFT1) == "stream",
              f"--dft at 256^3 {dtype}: auto resolves to stream for heating, --pml 10 and Debye (twopass when "
              "asked)")
    # its outputs and log stay for the sharded CLI of phase 7b to be held against
    dft_cli = tempfile.mkdtemp()
    with contextlib.nullcontext(os.path.join(dft_cli, "one")) as out:
        t0 = time.perf_counter()
        r = run_cli([heat500, "--water-block", "--sar", "--dft", "2.45e10", "--out", out, "--diag-log",
                     os.path.join(dft_cli, "one.jsonl")])
        cli_s = time.perf_counter() - t0
        lines = r.stdout.strip().splitlines()
        for line in lines[-4:]:
            print(line)
        dft_line = [line for line in lines if line.startswith("DFT phasors at")]
        e_peak = float(dft_line[0].split("(peak |E| ")[1].split(",")[0]) if dft_line else float("nan")
        dft_path, sar_path = os.path.join(out, "dft_00.vtr"), os.path.join(out, "sar.vtr")
        check(r.returncode == 0 and "Simulation complete!" in r.stdout and os.path.exists(dft_path)
              and os.path.exists(sar_path) and e_peak > 0,
              f"CLI heating_256 --water-block --sar --dft 2.45e10 exit {r.returncode} in {cli_s:.1f} s: dft_00.vtr "
              f"{os.path.getsize(dft_path) if os.path.exists(dft_path) else 0} B, e_mag peak {e_peak!r}, sar.vtr "
              f"{os.path.getsize(sar_path) if os.path.exists(sar_path) else 0} B {r.stderr.strip()[-300:]}")

    def monitored_pair(pm: Params, backends: tuple, wants: dict, label: str, exact: bool = True, **kw):
        """1000 steps of ``pm`` with --dft 2.45e10 through two backends:
        launch counts as ``wants``, phasors, fields (SAR map, psi, P) equal
        bit for bit (``exact``; bf16 sweeps round once a sweep, not a step);
        returns the first backend's result (phase 7b holds the sharded runs
        against it)."""
        res_b = {}
        for backend in backends:
            reset_counts()
            res = run_simulation(pm, dev, write_snapshots=False, backend=backend, dft=DFT1, log=lambda m: None, **kw)
            counts = counts_now()
            want = expect(**wants[backend])
            check(counts == want and res.iterations == 1000,
                  f"{label} --dft 2.45e10 {backend} launch counts {counts} == {want}")
            for name in wants[backend]:
                if (name.endswith(("_dft", "_dft_interior")) or name == "dft_accum") and name not in main_counts:
                    main_counts[name] = counts[name]
                    paths[name] = f"{label} --dft 2.45e10 {backend}"
            peak = float(res.dft.magnitude(0).max())
            check(np.isfinite(res.dft.phasors).all() and peak > 0 and res.dft.phasors.shape == (1, 3, pm.maxk, pm.maxj,
                                                                                                  pm.maxi),
                  f"{label} --dft 2.45e10 {backend}: phasors finite, shape {res.dft.phasors.shape}, |E| peak "
                  f"{peak!r} ({res.mcells_per_s:.1f} Mcells/s over {res.iterations} steps)")
            res_b[backend] = res
            main_rates[f"{label} --dft 2.45e10 {backend}"] = res.mcells_per_s
            del res
        a = res_b[backends[0]]
        if not exact:
            return a
        d = max(max(float(np.nan_to_num(np.abs(a.dft.phasors - b.dft.phasors), nan=np.inf).max()),
                    maxdiff(a.state, b.state), maxdiff(a.psi, b.psi) if a.psi is not None else 0.0,
                    maxdiff(a.pol, b.pol) if a.pol is not None else 0.0,
                    absdiff(a.power_j, b.power_j) if a.power_j is not None else 0.0)
                for b in (res_b[x] for x in backends[1:]))
        check(d == 0.0, f"{label} --dft 2.45e10 1000 steps: {' == '.join(backends)}, phasors, fields"
                        f"{', SAR' if a.power_j is not None else ''}{', psi' if a.psi is not None else ''}"
                        f"{', P' if a.pol is not None else ''} max|diff| = {d!r}")
        del res_b
        torch.cuda.empty_cache()
        return a

    sp_h = stream_plan.pick_plan(ph, lossy=True, sar=True, dft=DFT1).s
    heat_dft_ref = monitored_pair(ph, ("stream", "twopass"),
                   {"stream": {"yee_stream_lossy_sar_dft": nh // sp_h},
                    "twopass": {"yee_update_h": nh, "yee_update_e_lossy": nh, "dft_accum": nh}},
                   "heating_256 --water-block --sar", materials=water, accumulate_power=True)
    sp_p = stream_plan.pick_plan(p, pml=PML10, dft=DFT1).s
    for dtype in ("float32", "bfloat16"):
        pd_ = dataclasses.replace(p, dtype=dtype)
        ref = monitored_pair(pd_, ("stream", "twopass") + (("torch",) if dtype == "float32" else ()),
                             {"stream": {"yee_stream_pml_dft": n // sp_p, "yee_stream_pml_dft_interior": n // sp_p},
                              "twopass": {"yee_update_h_pml": n, "yee_update_e_pml": n, "dft_accum": n},
                              "torch": {}},
                             "bench_256 --pml 10" + ("" if dtype == "float32" else " bf16"), dtype == "float32",
                             pml=PML10)
        tag = "" if dtype == "float32" else " bf16"
        # four more 1000-step runs in turns (twopass, stream, stream, twopass): each backend's rate is the median
        # of its three, as one bf16 stream run was seen to fall 22% below its others on an H100 (PERF.md, open
        # questions); the spread of each backend's three is printed beside the verdict
        runs_pd = {b: [main_rates[f"bench_256 --pml 10{tag} --dft 2.45e10 {b}"]] for b in ("stream", "twopass")}
        for backend in ("twopass", "stream", "stream", "twopass"):
            res = run_simulation(pd_, dev, write_snapshots=False, backend=backend, pml=PML10, dft=DFT1,
                                 log=lambda m: None)
            runs_pd[backend].append(res.mcells_per_s)
            del res
        rates_pd = [sorted(runs_pd[b])[1] for b in ("stream", "twopass")]
        spread_pd = {b: (max(r_) - min(r_)) / sorted(r_)[1] for b, r_ in runs_pd.items()}
        for b, r_ in zip(("stream", "twopass"), rates_pd):
            main_rates[f"bench_256 --pml 10{tag} --dft 2.45e10 {b}"] = r_
        routed = resolve_backend(pd_, "auto", dev, pml=PML10, dft=DFT1)
        check(routed == ("stream" if rates_pd[0] > rates_pd[1] else "twopass"),
              f"auto resolves to {routed} for --pml 10 --dft 2.45e10 at 256^3 {dtype}: stream {rates_pd[0]:.1f} against "
              f"twopass + dft_accum {rates_pd[1]:.1f} Mcells/s over 1000 steps, each the median of three runs in turns "
              f"{runs_pd}, spread (max - min) / median {spread_pd}")
        if dtype == "float32":
            pml_dft_ref = ref
        del ref
    sp_d = stream_plan.pick_plan(ph, sar=True, ade=True, dft=DFT1).s
    monitored_pair(ph, ("stream", "twopass"),
                   {"stream": {"yee_stream_ade_sar_dft": nh // sp_d},
                    "twopass": {"yee_update_h": nh, "yee_update_e_ade_sar": nh, "dft_accum": nh}},
                   "heating_256 --water-block --dispersive --sar", materials=debye, accumulate_power=True, dc=dc_debye)
    phase_done("6d 1000-step monitor runs")

    # every DFT variant with nf = 2 and trailing two-pass steps (dft_accum
    # after each): stream == twopass == torch
    for mats_v, sar_v, pml_v, steps_v, label in (
            (water, True, None, N_LOADS, "--water-block --sar "), (None, False, PML10, N_LOADS + 1, "--pml 10 "),
            (debye, True, None, N_LOADS + 1, "--water-block --dispersive --sar "), (None, False, None, N_LOADS, ""),
            (water, False, None, N_LOADS, "--water-block "), (ferrite, False, None, N_LOADS, "--water-block --ferrite-slab "),
            (ferrite, True, None, N_LOADS, "--water-block --ferrite-slab --sar "),
            (water, False, PML10, N_LOADS + 1, "--water-block --pml 10 "),
            (debye, False, None, N_LOADS, "--water-block --dispersive ")):
        debye_v = isinstance(mats_v, DebyeMaterials)
        lossy_v = mats_v is not None and not debye_v
        het_v = lossy_v and mats_v.mu_r is not None
        plan_v = stream_plan.pick_plan(ph, lossy=lossy_v, het=het_v, sar=sar_v, pml=pml_v, ade=debye_v, dft=DFT2)
        steps_v += steps_v % plan_v.s == 0  # an odd count at s = 2
        trail = steps_v % plan_v.s
        check(trail != 0, f"{steps_v} steps leave {trail} trailing two-pass steps at s={plan_v.s} ({plan_v.kernel})")
        counts = equal_runs(ph, steps_v, ("stream", "twopass", "torch"), mats_v, sar_v, f"{label}--dft (nf=2) ", pml_v,
                            DFT2, dc_debye if debye_v else None)
        inner_v = [plan_v.kernel + stream.INTERIOR] if plan_v.core is not None else []
        check(counts["stream"][plan_v.kernel] == steps_v // plan_v.s and counts["stream"]["dft_accum"] == trail
              and all(counts["stream"][x] == steps_v // plan_v.s for x in inner_v)
              and counts["twopass"]["dft_accum"] == steps_v and counts["torch"] == expect(),
              f"{label}--dft (nf=2) launch counts: stream {plan_v.kernel} {counts['stream'][plan_v.kernel]}, "
              f"dft_accum {counts['stream']['dft_accum']}; twopass dft_accum {counts['twopass']['dft_accum']}")
        for name in [plan_v.kernel] + inner_v:
            if name not in main_counts:
                main_counts[name] = counts["stream"][name]
                paths[name] = f"heating_256 {label}--dft 2.45e10,1.5e10 stream ({steps_v} steps)"
        torch.cuda.empty_cache()

    # probes and the H sums (--probe x2 --dft-fields eh): per-step states,
    # so stream runs twopass with a notice; twopass == torch bit for bit.
    # In 66 steps the wave from the k = 0 source reaches neither cell, so a
    # third probe two planes above the source patch shows the series move
    probes2 = ProbeSet(((128, 128, 128), (10, 20, 30), (2, 128, 128)))
    dft_eh = DftConfig((2.45e10,), fields="eh")
    notices = []
    routed = resolve_backend(p, "stream", dev, dft=dft_eh, probes=probes2, log=notices.append)
    check(routed == "twopass" and len(notices) == 1 and "per-step monitors" in notices[0],
          f"--probe --dft-fields eh with --backend stream runs {routed}: {notices}")
    p66 = dataclasses.replace(p, simulation_time=N_LOADS * p.time_step)
    res_m = {}
    for backend in ("twopass", "torch"):
        reset_counts()
        res_m[backend] = run_simulation(p66, dev, write_snapshots=False, backend=backend, dft=dft_eh, probes=probes2,
                                        log=lambda m: None)
        counts = counts_now()
        want = expect(yee_update_h=N_LOADS, yee_update_e=N_LOADS, dft_accum=N_LOADS) if backend == "twopass" else expect()
        check(counts == want, f"--probe x3 --dft-fields eh {backend} launch counts {counts} == {want}")
    a, b = res_m["twopass"], res_m["torch"]
    d = max(float(np.nan_to_num(np.abs(a.dft.phasors - b.dft.phasors), nan=np.inf).max()), float(np.abs(a.probes.values - b.probes.values).max()),
            maxdiff(a.state, b.state))
    h_peak, p_peak = float(np.abs(a.dft.phasors[0, 3:]).max()), float(np.abs(a.probes.values[:, 2]).max())
    check(d == 0.0 and a.probes.values.shape == (N_LOADS, 3, 6) and a.dft.phasors.shape[1] == 6
          and h_peak > 0 and p_peak > 0,
          f"--probe x3 --dft-fields eh {N_LOADS} steps: twopass == torch, phasors (6 components; H peak {h_peak!r}), "
          f"probe rows {a.probes.values.shape} (peak at (2, 128, 128) {p_peak!r}) and fields max|diff| = {d!r}")
    del res_m, a, b
    with tempfile.TemporaryDirectory() as out:
        params66 = os.path.join(out, "bench_256_66.txt")
        with open("configs/bench_256.txt") as f:
            vals = f.read().split()
        vals[5] = repr(N_LOADS * p.time_step)
        with open(params66, "w") as f:
            f.write("\n".join(vals) + "\n")
        r = run_cli([params66, "--probe", "128,128,128", "--probe", "10,20,30", "--dft", "2.45e10", "--dft-fields",
                     "eh", "--out", os.path.join(out, "r")])
        csv_path = os.path.join(out, "r", "probes.csv")
        rows = open(csv_path).read().splitlines() if os.path.exists(csv_path) else []
        cols = {len(row.split(",")) for row in rows[1:]}
        check(r.returncode == 0 and len(rows) == 2 + N_LOADS and cols == {1 + 6 * 2}
              and rows[0].startswith("# probe cells (k,j,i): (128, 128, 128); (10, 20, 30)")
              and os.path.exists(os.path.join(out, "r", "dft_00.vtr")),
              f"CLI --probe x2 --dft 2.45e10 --dft-fields eh ({N_LOADS} steps) exit {r.returncode}: probes.csv "
              f"{len(rows) - 2} rows of {cols} columns, dft_00.vtr written {r.stderr.strip()[-300:]}")
    phase_done("6d trailing steps, probes")

    # -- 6e. the DFT bands' means mode and the fold ------------------------
    means_rows = phase_means(dev, smi, rng, water256=water, parent=parent_pkg)
    phase_done("6e the DFT means mode and the fold")

    # -- 6f. the per-step SAR increment kernel -----------------------------
    sar_rows = phase_sar(dev, smi, water256=water)
    phase_done("6f the SAR increment kernel")

    # the output reductions in k slabs: the allocator's peak over one
    # snapshot (aggregation) plus one log record (energies and radiated
    # power) at 256^3 with slabs forced to 64 planes, against the model
    slab_cells = diagnostics.OUTPUT_SLAB_CELLS
    diagnostics.OUTPUT_SLAB_CELLS = 64 * p.maxj * p.maxi
    s_o = state_from_numpy({c: rng.uniform(-1.0, 1.0, p.padded_shape).astype(np.float32) for c in COMPONENTS},
                           dev, torch.float32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    variables = aggregate_all(p, s_o)
    rec_e = float(diagnostics.e_energy(p, s_o)) + float(diagnostics.h_energy(p, s_o))
    rec_f = float(diagnostics.poynting_flux(p, s_o, margin=11))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    model = stream_plan.output_work_bytes(p)
    whole = 6 * p.maxk * p.maxj * p.maxi * 4
    check(0 < peak <= model and len(variables) == 6 and math.isfinite(rec_e + rec_f),
          f"one snapshot + one log record at 256^3 in {len(diagnostics.output_slabs(p))} slabs: peak "
          f"{peak} B <= model {model} B ({peak / model!r} of it; the six whole-grid cell arrays alone "
          f"were {whole} B)")
    diagnostics.OUTPUT_SLAB_CELLS = slab_cells
    del s_o, variables
    torch.cuda.empty_cache()

    # -- 7. sharding (--shard) ----------------------------------------------
    ms: dict[str, tuple[float, float]] = {}  # each kernel's fp32 ms and its plain version's ms (phases 7, 8)
    ms_bf16: dict[str, float] = {}
    plans: dict[str, stream_plan.StreamPlan] = {}
    from fdtd_tpu_torch.parallel import mesh as shard_mesh
    from fdtd_tpu_torch.parallel import sharded_fast
    from fdtd_tpu_torch.parallel.sharded_step import shard_coefs
    from fdtd_tpu_torch.io.vtr import read_vtr_cell_arrays

    def owned_diff(a, b, box) -> float:
        """Largest |a - b| over the owned cells of two shard states."""
        return max(absdiff(x[box.owned], y[box.owned]) for x, y in zip(a.tensors(), b.tensors()))

    def shard_kernels(pk: Params, arrays: dict, shape: tuple, s: int, label: str, mats=None, sar: bool = False,
                      two_pass: bool = True) -> None:
        """On every shard of a ``shape`` mesh (random fields; the map from
        random sums), K1/K2-shard (``two_pass``) and K3-shard at ``s``
        against their plain versions on the shard's arrays: the owned cells
        bit for bit."""
        mesh_k = shard_mesh.make_mesh(shape, "cuda")
        host = memo_update_coefs(pk, mats, "cpu")
        dt = field_dtype(pk)
        canon = state_from_numpy(arrays, dev, dt)
        acc0 = (torch.tensor(rng.uniform(0.0, 1e-11, (pk.maxk, pk.maxj, pk.maxi)), dtype=torch.float32, device=dev)
                if sar else None)
        shards = shard_mesh.scatter(pk, canon, mesh_k, s + int(sar), acc0)
        src = make_source_plan(pk) if pk.mode == Mode.COMPUTATION else None
        patch = src.patch if src is not None else None
        err: dict[str, float] = {}
        for sh in shards:
            cf = shard_coefs(pk, host, sh.box, dev)
            if two_pass:
                h_name = ("yee_update_h_het" if cf.heterogeneous_mu else "yee_update_h") + "_shard"
                e_name = ("yee_update_e_lossy" if cf.lossy else "yee_update_e") + "_shard"
                a, b = sh.state.clone(), sh.state.clone()
                yee.update_h(pk, a, cf, patch, box=sh.box)
                curl.update_h(pk, b, cf, patch, sh.box)
                torch.cuda.synchronize()
                err[h_name] = max(err.get(h_name, 0.0), owned_diff(a, b, sh.box))
                yee.update_e(pk, a, cf, box=sh.box)
                curl.update_e(pk, b, cf, sh.box)
                torch.cuda.synchronize()
                err[e_name] = max(err.get(e_name, 0.0), owned_diff(a, b, sh.box))
            window = tuple(h - lo for lo, h in zip(sh.box.own_lo, sh.box.own_hi))
            plan = stream_plan.plan_for(pk, s, cf.lossy, cf.heterogeneous_mu, sar, window=window)
            st, drive = sh.state.clone(), None
            if src is not None:
                amps = torch.tensor(rng.uniform(-1.0, 1.0, s), dtype=torch.float64, device=dev)
                prof = profile_tensor(src, dev)
                apply_source(src, st, amps[0], prof, sh.box)
                ez_rows, hx_rows = sweep_drive_rows(src, amps, s, dt, prof)
                drive = stream.SweepDrive(src.patch, ez_rows[0], hx_rows[0])
            acc_k = sh.power.clone() if sar else None
            acc_p = sh.power.clone() if sar else None
            out = FieldState(*(torch.full_like(t, float("nan")) for t in st.tensors()))
            want = FieldState(*(torch.full_like(t, float("nan")) for t in st.tensors()))
            stream.sweep(pk, st, out, cf, plan, drive, acc_k, box=sh.box)
            stream.plain_sweep(pk, st, cf, s, drive, want, acc_p, box=sh.box)
            torch.cuda.synchronize()
            name = plan.kernel + "_shard"
            d = owned_diff(out, want, sh.box)
            d_acc = absdiff(acc_k, acc_p) if sar and acc_k.numel() else 0.0
            err[name] = max(err.get(name, 0.0), d, d_acc)
            if window[0] % plan.tk or window[1] % plan.tj or window[2] % plan.ti:
                ragged.add((name, s, window))
        for name, d in err.items():
            record_err(name, d)
            check(d == 0.0, f"{name} == plain on every shard of a {shape} mesh, s={s}, {label}: max|diff| = {d!r}")

    ragged.clear()
    for dtype in ("float32", "bfloat16"):
        for mode in (Mode.VALIDATION, Mode.COMPUTATION):
            # K, J, I = 70, 50, 61: 71 planes over 4 (18, 18, 18, 17) and 3; j over 3 (17 each)
            pk = Params(length=0.0615, width=0.0505, height=0.0705, spatial_step=0.001, time_step=1e-12,
                        simulation_time=1e-11, sampling_rate=5, mode=mode, dtype=dtype)
            arrays = {c: rng.uniform(-1.0, 1.0, pk.padded_shape) for c in COMPONENTS}
            scenes = [(None, False, "vacuum")]
            if mode == Mode.COMPUTATION:  # materials shard in computation mode only, as they stream
                scenes += [(water_block(pk), False, "water"), (water_block(pk), True, "water + SAR"),
                           (ferrite_slab(pk, base=water_block(pk)), False, "water + ferrite"),
                           (ferrite_slab(pk, base=water_block(pk)), True, "water + ferrite + SAR")]
            # bf16 on the 4-slab and 2 x 3 meshes (the 3-slab mesh's ragged shards in fp32: its depth cut
            # to keep the smoke's time with phase 10)
            for shape in SHARD_MESHES[dtype]:
                for mats_k, sar_k, scene_k in scenes:
                    for s_k in stream_plan.built_depths(mats_k is not None):
                        shard_kernels(pk, arrays, shape, s_k, f"{dtype} {mode.name} {scene_k} {pk.padded_shape}",
                                      mats_k, sar_k, two_pass=s_k == stream_plan.built_depths(mats_k is not None)[0])
    # bf16 shards whose rows are odd-pitched (the boxes above: 62 wide): a
    # 4-slab of 64^3 (ni = 65), water + ferrite + SAR at every built depth
    pk = Params(length=0.064, width=0.064, height=0.064, spatial_step=0.001, time_step=1e-12,
                simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype="bfloat16")
    arrays = {c: rng.uniform(-1.0, 1.0, pk.padded_shape) for c in COMPONENTS}
    for s_k in stream_plan.built_depths(True):
        shard_kernels(pk, arrays, (4, 1, 1), s_k, f"bfloat16 water + ferrite + SAR odd ni {pk.padded_shape}",
                      ferrite_slab(pk, base=water_block(pk)), True, two_pass=False)
    check(bool(ragged), f"shard tiles that do not divide the shard were checked: {sorted(ragged)[:6]} ...")
    # the 256^3 shard plans of the main and heating paths, both dtypes
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(p, dtype=dtype)
        arrays = {c: rng.uniform(-1.0, 1.0, pd.padded_shape).astype(np.float32) for c in COMPONENTS}
        for shape in ((4, 1, 1), (2, 2, 1)):
            mesh_d = shard_mesh.make_mesh(shape, "cuda")
            s_vac = sharded_fast.pick_shard_plan(pd, mesh_d)[0].s
            shard_kernels(pd, arrays, shape, s_vac, f"{dtype} random 256^3, its plan")
            s_heat = sharded_fast.pick_shard_plan(pd, mesh_d, lossy=True, sar=True)[0].s
            shard_kernels(pd, arrays, shape, s_heat, f"{dtype} heating random 256^3, its plan", water, True)
        del arrays
    torch.cuda.empty_cache()
    phase_done("7 shard kernels vs plain")

    # 1000 steps of bench_256 on a 4-slab and a 2x2 mesh: auto, stream and
    # twopass equal the unsharded stream run bit for bit
    shard_rates = {f"{k} (unsharded, phases 5-6)": v for k, v in main_rates.items()}
    for spec, shape in (("4", (4, 1, 1)), ("2x2", (2, 2, 1))):
        mesh_s = shard_mesh.make_mesh(shape, "cuda")
        n_sh = mesh_s.size
        s_sh = sharded_fast.pick_shard_plan(p, mesh_s)[0].s
        for backend in ("auto", "stream", "twopass"):
            notices = []
            reset_counts()
            res = run_simulation(p, dev, write_snapshots=False, backend=backend, shard=spec, log=notices.append)
            counts = counts_now()
            want = (expect(yee_update_h_shard=n_sh * n, yee_update_e_shard=n_sh * n) if backend == "twopass" else
                    expect(yee_stream_shard=n_sh * (n // s_sh), yee_update_h_shard=n_sh * (n % s_sh),
                           yee_update_e_shard=n_sh * (n % s_sh)))
            d = maxdiff(res.state, bench_ref)
            shard_rates[f"bench_256 --shard {spec} {backend}"] = res.mcells_per_s
            check(counts == want and d == 0.0 and n == 1000,
                  f"bench_256 --shard {spec} {backend}: 1000 steps == unsharded stream, max|diff| = {d!r}; launch "
                  f"counts {counts} == {want}; {res.mcells_per_s:.1f} Mcells/s (unsharded stream "
                  f"{main_rates['bench_256 stream']:.1f}) {notices}")
            if spec == "4" and backend != "auto":
                for name in (("yee_update_h_shard", "yee_update_e_shard") if backend == "twopass"
                             else ("yee_stream_shard",)):
                    main_counts[name] = counts[name]
                    paths[name] = f"bench_256 --shard 4 {backend}"
            del res
    del bench_ref
    # the heating scene on 4 slabs: stream and twopass == unsharded, fields and SAR map
    mesh_h = shard_mesh.make_mesh((4, 1, 1), "cuda")
    s_hs = sharded_fast.pick_shard_plan(ph, mesh_h, lossy=True, sar=True)[0].s
    for backend in ("stream", "twopass"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        res = run_simulation(ph, dev, materials=water, accumulate_power=True, write_snapshots=False, backend=backend,
                             shard="4", log=lambda m: None)
        counts = counts_now()
        torch.cuda.synchronize()
        # the allocator's peak over the whole run (shards, second buffers, coefficient parts, the gathered
        # grid and map) against the model that admits or refuses a sharded run
        peak = torch.cuda.max_memory_allocated(dev) - base
        boxes_m = shard_mesh.shard_boxes(ph, mesh_h, s_hs + 1 if backend == "stream" else 1)
        model = max(stream_plan.shard_bytes(ph, [(b.shape, math.prod(b.cell_shape(ph))) for b in boxes_m],
                                            mesh_h.devices, mesh_h.devices[0], backend == "stream", True, False,
                                            True).values())
        check(0 < peak <= model, f"heating_256 --water-block --sar --shard 4 {backend} peak device memory {peak} B "
                                 f"<= model {model} B ({peak / model!r} of it)")
        want = (expect(yee_update_h_shard=4 * nh, yee_update_e_lossy_shard=4 * nh) if backend == "twopass" else
                expect(yee_stream_lossy_sar_shard=4 * (nh // s_hs), yee_update_h_shard=4 * (nh % s_hs),
                       yee_update_e_lossy_shard=4 * (nh % s_hs)))
        d = maxdiff(res.state, heat_ref[0])
        d_acc = absdiff(res.power_j, heat_ref[1])
        shard_rates[f"heating_256 --shard 4 {backend}"] = res.mcells_per_s
        check(counts == want and d == 0.0 and d_acc == 0.0 and float(heat_ref[1].max()) > 0,
              f"heating_256 --water-block --sar --shard 4 {backend}: 1000 steps == unsharded stream, fields "
              f"max|diff| = {d!r}, SAR max|diff| = {d_acc!r}; launch counts {counts} == {want}; "
              f"{res.mcells_per_s:.1f} Mcells/s (unsharded stream {main_rates['heating_256 stream']:.1f})")
        name = "yee_update_e_lossy_shard" if backend == "twopass" else "yee_stream_lossy_sar_shard"
        main_counts[name] = counts[name]
        paths[name] = f"heating_256 --water-block --sar --shard 4 {backend}"
        del res
    del heat_ref
    # the other loads on 4 slabs (66 steps: sweeps and trailing two-pass steps), stream == unsharded stream
    for mats_l, sar_l, scene_l in ((water, False, "--water-block"), (ferrite, False, "--water-block --ferrite-slab"),
                                   (ferrite, True, "--water-block --ferrite-slab --sar")):
        het_l = mats_l.mu_r is not None
        tv = time_values(ph)[:N_LOADS]
        xs_l = scan_inputs(ph, tv)
        init = {c: rng.uniform(-1.0, 1.0, ph.padded_shape).astype(np.float32) for c in COMPONENTS}
        s_ref = state_from_numpy(init, dev, torch.float32)
        pw_ref = zero_power_acc(ph, dev) if sar_l else None
        make_chunk_runner(ph, dev, mats_l, "stream", accumulate_power=sar_l)(
            s_ref, xs_l, pw_ref)
        s_sh_state = state_from_numpy(init, dev, torch.float32)
        pw_sh = zero_power_acc(ph, dev) if sar_l else None
        run_sh = sharded_fast.make_sharded_stream_runner(ph, mesh_h, mats_l, sar_l)
        shards = shard_mesh.scatter(ph, s_sh_state, mesh_h, run_sh.depth, pw_sh)
        reset_counts()
        run_sh(shards, xs_l)
        torch.cuda.synchronize()
        counts = counts_now()
        shard_mesh.gather(ph, shards, s_sh_state, pw_sh)
        kname = run_sh.plans[0].kernel + "_shard"
        s_l = run_sh.plans[0].s
        h_l = "yee_update_h_het_shard" if het_l else "yee_update_h_shard"
        want = expect(**{kname: 4 * (N_LOADS // s_l), h_l: 4 * (N_LOADS % s_l),
                         "yee_update_e_lossy_shard": 4 * (N_LOADS % s_l)})
        d = maxdiff(s_sh_state, s_ref)
        d_acc = absdiff(pw_sh, pw_ref) if sar_l else 0.0
        check(counts == want and d == 0.0 and d_acc == 0.0,
              f"heating_256 {scene_l} --shard 4 stream, {N_LOADS} steps from random fields == unsharded stream: "
              f"max|diff| = {d!r}, SAR {d_acc!r}; launch counts {counts} == {want}")
        main_counts[kname] = counts[kname]
        paths[kname] = f"heating_256 {scene_l} --shard 4 stream ({N_LOADS} steps)"
        if het_l and h_l not in main_counts:
            main_counts[h_l] = counts[h_l]
            paths[h_l] = f"heating_256 {scene_l} --shard 4 stream ({N_LOADS} steps, trailing two-pass steps)"
        del shards, run_sh, s_ref, s_sh_state
    torch.cuda.empty_cache()
    # 512^3 on 4 slabs, 16 steps: the sharded stream == the unsharded stream
    xs512 = scan_inputs(p512, time_values(p512)[:16])
    s_ref = initial_state(p512, dev)
    make_chunk_runner(p512, dev, backend="stream")(s_ref, xs512)
    s512 = initial_state(p512, dev)
    mesh_5 = shard_mesh.make_mesh((4, 1, 1), "cuda")
    run5 = sharded_fast.make_sharded_stream_runner(p512, mesh_5)
    shards = shard_mesh.scatter(p512, s512, mesh_5, run5.depth)
    reset_counts()
    run5(shards, xs512)
    torch.cuda.synchronize()
    counts = counts_now()
    shard_mesh.gather(p512, shards, s512)
    d = maxdiff(s512, s_ref)
    check(d == 0.0 and counts["yee_stream_shard"] == 4 * (16 // run5.plans[0].s),
          f"512^3 --shard 4 stream, 16 steps == unsharded stream: max|diff| = {d!r}; launch counts {counts}")
    del shards, run5, s512, s_ref
    torch.cuda.empty_cache()
    phase_done("7 sharded runs")

    # the CLI: bench_256 (snapshots every 500 steps) and the heating scene with --shard 4 write the unsharded outputs
    def array_diff(x: np.ndarray, y: np.ndarray) -> float:
        """Largest |x - y| in the arrays' own type, a NaN counted as inf (the
        difference of two unequal floats is never 0, so 0 means equal)."""
        diff = np.abs(x - y)
        return math.inf if np.isnan(diff).any() else float(diff.max())

    def same_outputs(a_dir: str, b_dir: str) -> tuple[list, float]:
        names = sorted(os.path.basename(f) for f in glob.glob(os.path.join(a_dir, "*.vtr")))
        d = 0.0
        for nm in names:
            a, b = read_vtr_cell_arrays(os.path.join(a_dir, nm)), read_vtr_cell_arrays(os.path.join(b_dir, nm))
            d = max([d] + [array_diff(a[k], b[k]) for k in a])
        return names, d

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        r4 = run_cli([params500, "--out", os.path.join(out, "z4"), "--diag-log", os.path.join(out, "z4.jsonl"),
                      "--shard", "4"])
        cli_s = time.perf_counter() - t0
        names, d = same_outputs(os.path.join(bench_cli, "one"), os.path.join(out, "z4"))
        logs = [open(path).read() for path in (os.path.join(bench_cli, "one.jsonl"), os.path.join(out, "z4.jsonl"))]
        check(r4.returncode == 0 and names == ["result0001.vtr", "result0500.vtr", "result1000.vtr"]
              and d == 0.0 and logs[0] == logs[1] and len(logs[0].splitlines()) == 3,
              f"CLI bench_256 (rate 500) --shard 4 writes the unsharded snapshots {names} (max|diff| {d!r}) and "
              f"energy log in {cli_s:.1f} s: {r4.stdout.strip().splitlines()[-2:]} {r4.stderr.strip()[-300:]}")
        t0 = time.perf_counter()
        r = run_cli(["configs/heating_256.txt", "--water-block", "--sar", "--shard", "4", "--out",
                     os.path.join(out, "heat")])
        cli_s = time.perf_counter() - t0
        names, d = same_outputs(heat_cli, os.path.join(out, "heat"))
        check(r.returncode == 0 and len(names) == 12 and "sar.vtr" in names and d == 0.0,
              f"CLI heating_256 --water-block --sar --shard 4 in {cli_s:.1f} s writes the unsharded snapshots and "
              f"sar.vtr ({len(names)} files, max|diff| {d!r}): {r.stdout.strip().splitlines()[-3:]} "
              f"{r.stderr.strip()[-300:]}")
    shutil.rmtree(heat_cli, ignore_errors=True)
    shutil.rmtree(bench_cli, ignore_errors=True)

    # the halo copies at 256^3: a sweep's exchange (every field, s planes;
    # s + 1 with SAR) and a two-pass step's (E above, H below; one plane)
    shell_ms: dict[str, float] = {}  # a CPML sweep's shell launch alone, fp32

    def time_interior(name: str, pm: Params, plan, fp32: bool, run, plain_box) -> None:
        """Each launch of CPML sweep ``name`` alone: the interior
        (``plan.core``: ring_kernel on the psi-free window; ``run`` with the
        plan without shell blocks) beside the plain K3 steps on that window
        (``plain_box``, a box of the whole grid's arrays that owns it), and
        the shell (``run`` with the plan without the interior)."""
        if plan.core is None:
            return
        inner = name + stream.INTERIOR
        k_inner = event_ms(lambda: run(dataclasses.replace(plan, pml_blocks=())))
        core = plan.core
        box = Box((0, 0, 0), pm.padded_shape, core.origin, tuple(o + w for o, w in zip(core.origin, core.window)))
        if fp32:
            plans[inner] = plan
            shell_ms[name] = event_ms(lambda: run(dataclasses.replace(plan, core=None)))
            ms[inner] = (k_inner, event_ms(lambda: plain_box(box), reps=3))
        else:
            ms_bf16[inner] = k_inner

    from fdtd_tpu_torch.grid import E_COMPONENTS, H_COMPONENTS
    halo_ms = {}
    for spec, shape in (("4", (4, 1, 1)), ("2x2", (2, 2, 1))):
        mesh_x = shard_mesh.make_mesh(shape, "cuda")
        for label, depth, sar_x in (("stream", None, False), ("stream --sar", None, True), ("twopass", 1, False)):
            if depth is None:
                depth = sharded_fast.pick_shard_plan(p, mesh_x, lossy=sar_x, sar=sar_x)[0].s + int(sar_x)
            shards = shard_mesh.scatter(p, initial_state(p, dev), mesh_x, depth)
            if label.startswith("stream"):
                ms_x = event_ms(lambda: shard_mesh.exchange(mesh_x, shards), queued=False)
            else:
                ms_x = event_ms(lambda: (shard_mesh.exchange(mesh_x, shards, E_COMPONENTS, ("hi",)),
                                         shard_mesh.exchange(mesh_x, shards, H_COMPONENTS, ("lo",))), queued=False)
            halo_ms[(spec, label)] = ms_x
            print(f"halo copies 256^3 --shard {spec} {label} (depth {depth}): {ms_x!r} ms per "
                  f"{'sweep' if label.startswith('stream') else 'step'} ({smi})")
            del shards
    torch.cuda.empty_cache()

    # each shard kernel's time at 256^3 on a middle slab of --shard 4, scattered as its runner scatters it (one
    # halo plane for K1/K2, the sweep's depth for K3), beside its plain version and its bound: (values read,
    # values written over the owned window, operations, SAR cells)
    shard_work: dict[str, tuple[int, int, int, int]] = {}

    def window_plus(box, side: str) -> int:
        """Cells of the owned window and the one plane past it on ``side``
        of each sharded axis: what a two-pass pass reads of the other field."""
        return math.prod(h - lo + (hi > h if side == "hi" else lo > l0)
                         for l0, hi, lo, h in zip(box.lo, box.hi, box.own_lo, box.own_hi))

    patch_t = make_source_plan(p).patch
    mesh_t = shard_mesh.make_mesh((4, 1, 1), "cuda")
    arrays = {c: rng.uniform(-1.0, 1.0, p.padded_shape).astype(np.float32) for c in COMPONENTS}
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(p, dtype=dtype)
        fp32 = dtype == "float32"
        item = 4 if fp32 else 2
        for mats_t, sar_t, names in ((None, False, ("yee_update_h_shard", "yee_update_e_shard", "yee_stream_shard")),
                                     (water, False, (None, "yee_update_e_lossy_shard", "yee_stream_lossy_shard")),
                                     (water, True, (None, None, "yee_stream_lossy_sar_shard")),
                                     (ferrite, False, ("yee_update_h_het_shard", None, "yee_stream_lossy_het_shard")),
                                     (ferrite, True, (None, None, "yee_stream_lossy_het_sar_shard"))):
            plans_t = sharded_fast.pick_shard_plan(pd, mesh_t, lossy=mats_t is not None,
                                                   het=mats_t is not None and mats_t.mu_r is not None, sar=sar_t)
            h_name, e_name, k_name = names
            canon_t = state_from_numpy(arrays, dev, field_dtype(pd))
            if h_name or e_name:  # H: H, hf over the owned window, E one plane past it; E: E, ca/cb, H one below
                s1 = shard_mesh.scatter(pd, canon_t, mesh_t, 1)[1]
                cf1, box1 = shard_coefs(pd, coefs_of(pd, mats_t), s1.box, dev), s1.box
                v_own = math.prod(h - lo for lo, h in zip(box1.own_lo, box1.own_hi))
            if h_name:
                k_ms = event_ms(lambda: yee.update_h(pd, s1.state, cf1, patch_t, box=box1))
                if fp32:
                    ms[h_name] = (k_ms, event_ms(lambda: curl.update_h(pd, s1.state, cf1, patch_t, box1)))
                    shard_work[h_name] = ((3 + (3 if cf1.heterogeneous_mu else 0)) * v_own
                                          + 3 * window_plus(box1, "hi"), 3 * v_own, 15 * v_own, 0)
                else:
                    ms_bf16[h_name] = k_ms
            if e_name:
                k_ms = event_ms(lambda: yee.update_e(pd, s1.state, cf1, box=box1))
                if fp32:
                    ms[e_name] = (k_ms, event_ms(lambda: curl.update_e(pd, s1.state, cf1, box1)))
                    shard_work[e_name] = ((3 + (6 if cf1.lossy else 0)) * v_own + 3 * window_plus(box1, "lo"),
                                          3 * v_own, (18 if cf1.lossy else 15) * v_own, 0)
                else:
                    ms_bf16[e_name] = k_ms
            if h_name or e_name:
                del s1, cf1
            sh = shard_mesh.scatter(pd, canon_t, mesh_t, plans_t[1].s + int(sar_t),
                                    zero_power_acc(pd, dev) if sar_t else None)[1]
            del canon_t
            cf = shard_coefs(pd, coefs_of(pd, mats_t), sh.box, dev)
            box = sh.box
            v_box, v_own = math.prod(box.shape), math.prod(tuple(h - lo for lo, h in zip(box.own_lo, box.own_hi)))
            c_own = math.prod(box.cell_shape(pd))
            lossy_t, het_t = cf.lossy, cf.heterogeneous_mu
            plan_t = plans_t[1]
            src = make_source_plan(pd)
            amps = torch.tensor(rng.uniform(-1.0, 1.0, plan_t.s), dtype=torch.float64, device=dev)
            ez_rows, hx_rows = sweep_drive_rows(src, amps, plan_t.s, field_dtype(pd), profile_tensor(src, dev))
            drive = stream.SweepDrive(src.patch, ez_rows[0], hx_rows[0])
            out_t = FieldState(*(torch.empty_like(t) for t in sh.state.tensors()))
            acc_t = sh.power
            k_ms = event_ms(lambda: stream.sweep(pd, sh.state, out_t, cf, plan_t, drive, acc_t, box=box))
            if fp32:
                plans[k_name] = plan_t
                ms[k_name] = (k_ms, event_ms(lambda: stream.plain_sweep(pd, sh.state, cf, plan_t.s, drive, out_t, acc_t,
                                                                        box=box), reps=3))
                # fields in over the slab and its halos, out over the owned window; coefficients over the slab;
                # sigma and the map (in and out) over the owned cells
                in_vals = (6 + (6 if lossy_t else 0) + (3 if het_t else 0)) * v_box
                ops = plan_t.s * (v_own * (15 + (18 if lossy_t else 15)) + (20 * c_own if sar_t else 0))
                shard_work[k_name] = (in_vals, 6 * v_own, ops, c_own if sar_t else 0)
            else:
                ms_bf16[k_name] = k_ms
            del sh, cf, out_t
    del arrays
    torch.cuda.empty_cache()
    phase_done("7 CLI, halo copies, shard kernel times")

    # -- 7b. CPML, Debye media and the monitors under --shard ---------------
    from fdtd_tpu_torch.ops.cpml import psi_part_shapes

    PML_SHARD = PMLConfig(cells=10)  # on the 35 x 27 x 31 grid its k and j slabs straddle two shards
    shard_sums: dict[str, int] = {}  # the fp32 DFT sums a shard launch reads and writes (bytes), beside shard_work

    def pdiff(a, b) -> float:
        """``maxdiff`` over tensors that may be empty (a shard's psi parts)."""
        ta, tb = (x.tensors() if hasattr(x, "tensors") else tuple(x) for x in (a, b))
        return max([absdiff(x, y) for x, y in zip(ta, tb) if x.numel()] + [0.0])

    def shard_kernels_11b(pk: Params, arrays: dict, shape: tuple, label: str, mats=None, sar: bool = False,
                          pml: PMLConfig | None = None, nf: int = 0, s: int | None = None) -> None:
        """On every shard of a ``shape`` mesh (random fields, psi, sums and
        map): with ``pml`` K10-shard (H and E, the variant of ``mats``), with
        ``nf`` frequencies K4-shard and, in computation mode and nf <= 2,
        K3-shard-DFT at ``s`` (default: its built depth), against their plain versions: owned cells,
        psi parts, sums and map bit for bit."""
        mesh_k = shard_mesh.make_mesh(shape, "cuda")
        s = s or stream_plan.built_depths(mats is not None, dft=True)[0]
        host = memo_update_coefs(pk, mats, "cpu")
        dt = field_dtype(pk)
        canon = state_from_numpy(arrays, dev, dt)
        acc0 = (torch.tensor(rng.uniform(0.0, 1e-11, (pk.maxk, pk.maxj, pk.maxi)), dtype=torch.float32, device=dev)
                if sar else None)
        shards = shard_mesh.scatter(pk, canon, mesh_k, s + 1 if nf else 1, acc0,
                                    random_psi(pk, pml) if pml is not None else None, pml, None,
                                    random_sums(pk, nf) if nf else None)
        src = make_source_plan(pk) if pk.mode == Mode.COMPUTATION else None
        patch = src.patch if src is not None else None
        err: dict[str, float] = {}
        for sh in shards:
            cf = shard_coefs(pk, host, sh.box, dev)
            if pml is not None:
                cp = make_cpml(pk, pml, cf, dev, sh.box)
                h_name = ("yee_update_h_het_pml" if cf.heterogeneous_mu else "yee_update_h_pml") + "_shard"
                e_name = ("yee_update_e_lossy_pml" if cf.lossy else "yee_update_e_pml") + "_shard"
                a, b = sh.state.clone(), sh.state.clone()
                pa, pb = sh.psi.clone(), sh.psi.clone()
                yee.update_h(pk, a, cf, patch, cp, pa, box=sh.box)
                cp.plain_h(pk, b, cf, pb, patch)
                torch.cuda.synchronize()
                err[h_name] = max(err.get(h_name, 0.0), owned_diff(a, b, sh.box), pdiff(pa, pb))
                yee.update_e(pk, a, cf, cp, pa, box=sh.box)
                cp.plain_e(pk, b, cf, pb)
                torch.cuda.synchronize()
                err[e_name] = max(err.get(e_name, 0.0), owned_diff(a, b, sh.box), pdiff(pa, pb))
            if nf:
                w = torch.tensor(rng.uniform(-1.0, 1.0, (2, nf)), dtype=torch.float32, device=dev)
                da, db = tuple(t.clone() for t in sh.dacc), tuple(t.clone() for t in sh.dacc)
                dft_ops.accumulate_e(pk, sh.state, w, da, sh.box)
                dft_ops.plain_accumulate_e(pk, sh.state, w, db, sh.box)
                torch.cuda.synchronize()
                err["dft_accum_shard"] = max(err.get("dft_accum_shard", 0.0), maxdiff(da, db))
            if nf and nf <= 2 and src is not None:
                window = tuple(h - lo for lo, h in zip(sh.box.own_lo, sh.box.own_hi))
                plan = stream_plan.plan_for(pk, s, cf.lossy, cf.heterogeneous_mu, sar, dft=(DFT1 if nf == 1 else DFT2),
                                            window=window)
                st = sh.state.clone()
                amps = torch.tensor(rng.uniform(-1.0, 1.0, s), dtype=torch.float64, device=dev)
                prof = profile_tensor(src, dev)
                apply_source(src, st, amps[0], prof, sh.box)
                ez_rows, hx_rows = sweep_drive_rows(src, amps, s, dt, prof)
                drive = stream.SweepDrive(src.patch, ez_rows[0], hx_rows[0])
                wts = torch.tensor(rng.uniform(-1.0, 1.0, (s, 2, nf)), dtype=torch.float32, device=dev)
                out = FieldState(*(torch.full_like(t, float("nan")) for t in st.tensors()))
                want = FieldState(*(torch.full_like(t, float("nan")) for t in st.tensors()))
                da, db = tuple(t.clone() for t in sh.dacc), tuple(t.clone() for t in sh.dacc)
                aa, ab = (sh.power.clone(), sh.power.clone()) if sar else (None, None)
                stream.sweep(pk, st, out, cf, plan, drive, aa, dacc=da, wts=wts, box=sh.box)
                stream.plain_sweep(pk, st, cf, s, drive, want, ab, dacc=db, wts=wts, box=sh.box)
                torch.cuda.synchronize()
                name = plan.kernel + "_shard"
                d = max(owned_diff(out, want, sh.box), maxdiff(da, db), absdiff(aa, ab) if sar else 0.0)
                err[name] = max(err.get(name, 0.0), d)
                if window[0] % plan.tk or window[1] % plan.tj or window[2] % plan.ti:
                    ragged.add((name, s, window))
        for name, d in err.items():
            record_err(name, d)
            check(d == 0.0, f"{name} == plain on every shard of a {shape} mesh, {label}: max|diff| = {d!r}")

    ragged.clear()
    for dtype in ("float32", "bfloat16"):
        for mode in (Mode.VALIDATION, Mode.COMPUTATION):
            # K, J, I = 34, 26, 30: 35 planes over 4 (9, 9, 9, 8) and 3 (12, 12, 11); j over 3 (9 each)
            pk = Params(length=0.0305, width=0.0265, height=0.0345, spatial_step=0.001, time_step=1e-12,
                        simulation_time=1e-11, sampling_rate=5, mode=mode, dtype=dtype)
            arrays = {c: rng.uniform(-1.0, 1.0, pk.padded_shape) for c in COMPONENTS}
            wb_k = water_block(pk)
            fe_k = ferrite_slab(pk, base=water_block(pk, lo=(0.0, 0.1, 0.1), hi=(0.9, 0.9, 0.9)))
            lab = f"{dtype} {mode.name} {pk.padded_shape}"
            for shape in SHARD_MESHES[dtype]:
                shard_kernels_11b(pk, arrays, shape, lab + " vacuum, 10-cell CPML", pml=PML_SHARD)
                shard_kernels_11b(pk, arrays, shape, lab + " water + ferrite into the 10-cell CPML", fe_k,
                                  pml=PML_SHARD)
                for nf in ((1, 2, 3) if shape == (4, 1, 1) else (1, 2)):
                    shard_kernels_11b(pk, arrays, shape, lab + " vacuum", nf=nf)
                if mode == Mode.COMPUTATION:
                    for mats_k, sar_k, scene_k in ((wb_k, False, "water"), (wb_k, True, "water + SAR"),
                                                   (fe_k, False, "water + ferrite"),
                                                   (fe_k, True, "water + ferrite + SAR")):
                        for nf in (1, 2):
                            shard_kernels_11b(pk, arrays, shape, f"{lab} {scene_k}", mats_k, sar_k, nf=nf)
    check(bool(ragged), f"shard DFT tiles that do not divide the shard were checked: {sorted(ragged)[:4]} ...")
    # the 256^3 shard geometries of the 1000-step runs below, both dtypes
    mesh4 = shard_mesh.make_mesh((4, 1, 1), "cuda")
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(ph, dtype=dtype)
        arrays = {c: rng.uniform(-1.0, 1.0, pd.padded_shape).astype(np.float32) for c in COMPONENTS}
        shard_kernels_11b(pd, arrays, (4, 1, 1), f"{dtype} random 256^3 --pml 10", pml=PML10)
        shard_kernels_11b(pd, arrays, (4, 1, 1), f"{dtype} random 256^3 ferrite + --pml 10",
                          ferrite, pml=PML10)
        for shape in ((4, 1, 1), (2, 2, 1)):
            s_hd = sharded_fast.pick_shard_plan(pd, shard_mesh.make_mesh(shape, "cuda"), lossy=True, sar=True,
                                                dft=DFT1)[0].s
            shard_kernels_11b(pd, arrays, shape, f"{dtype} heating random 256^3, its --dft plan", water, True, nf=1,
                              s=s_hd)
        del arrays
    torch.cuda.empty_cache()
    phase_done("7b shard kernels vs plain")

    # 1000 steps with --shard 4 through run_simulation, each equal to its
    # unsharded run of phases 6b-6d bit for bit, with launch counts, rates
    # and the allocator's peak against stream_plan.shard_bytes
    def shard_model(pm: Params, depth: int, stream_: bool, **flags) -> int:
        boxes_m = shard_mesh.shard_boxes(pm, mesh4, depth)
        pml_m = flags.get("pml")
        psi_m = ([sum(math.prod(x) for x in psi_part_shapes(pm, pml_m, b).values()) for b in boxes_m]
                 if pml_m is not None else None)
        return max(stream_plan.shard_bytes(pm, [(b.shape, math.prod(b.cell_shape(pm))) for b in boxes_m],
                                           mesh4.devices, mesh4.devices[0], stream_, psi_elems=psi_m, **flags).values())

    def sharded_1000(label: str, pm: Params, ref, want: dict, model: int, unsharded: str, backend: str = "auto",
                     **kw) -> None:
        """1000 steps of ``pm`` with --shard 4 on ``backend``: launch counts
        ``want``, the result equal to ``ref`` (an unsharded RunResult or a
        tuple of state, power, psi, pol) and the peak within ``model``."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        notices = []
        reset_counts()
        res = run_simulation(pm, dev, write_snapshots=False, backend=backend, shard="4", log=notices.append, **kw)
        counts = counts_now()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        r_state, r_power, r_psi, r_pol = ((ref.state, ref.power_j, ref.psi, ref.pol) if hasattr(ref, "state")
                                          else ref)
        d = maxdiff(res.state, r_state)
        parts = ["fields"]
        for got_x, want_x, what in ((res.power_j, r_power, "SAR"), (res.psi, r_psi, "psi"), (res.pol, r_pol, "P")):
            if want_x is not None:
                d = max(d, maxdiff(got_x, want_x) if what != "SAR" else absdiff(got_x, want_x))
                parts.append(what)
        for attr, what in (("dft", "phasors"), ("probes", "probe rows")):
            want_m = getattr(ref, attr, None)
            if want_m is not None:
                a_m, b_m = ((getattr(res, attr).phasors, want_m.phasors) if attr == "dft"
                            else (getattr(res, attr).values, want_m.values))
                d = max(d, float(np.nan_to_num(np.abs(a_m - b_m), nan=np.inf).max()))
                parts.append(what)
        shard_rates[f"{label} --shard 4 {backend}"] = res.mcells_per_s
        want_c = expect(**want)
        check(counts == want_c and d == 0.0 and res.iterations == 1000 and 0 < peak <= model,
              f"{label} --shard 4 {backend}: 1000 steps == unsharded ({', '.join(parts)}), max|diff| = {d!r}; launch "
              f"counts {counts} == {want_c}; peak device memory {peak} B <= shard_bytes {model} B "
              f"({peak / model!r} of it); {res.mcells_per_s:.1f} Mcells/s (unsharded {unsharded} "
              f"{main_rates[unsharded]:.1f}) {notices}")
        for name in want:
            if name not in main_counts:
                main_counts[name] = counts[name]
                paths[name] = f"{label} --shard 4 {backend}"
        del res

    sharded_1000("bench_256 --pml 10", p, (pml_ref[0], None, pml_ref[1], None),
                 dict(yee_update_h_pml_shard=4 * n, yee_update_e_pml_shard=4 * n),
                 shard_model(p, 1, False, pml=PML10), "bench_256 --pml 10 twopass", pml=PML10)
    del pml_ref
    s_hd = sharded_fast.pick_shard_plan(ph, mesh4, lossy=True, sar=True, dft=DFT1)[0].s
    for backend in ("auto", "twopass"):
        want = (dict(yee_stream_lossy_sar_dft_shard=4 * (nh // s_hd), yee_update_h_shard=4 * (nh % s_hd),
                     yee_update_e_lossy_shard=4 * (nh % s_hd), dft_accum_shard=4 * (nh % s_hd))
                if backend == "auto" else
                dict(yee_update_h_shard=4 * nh, yee_update_e_lossy_shard=4 * nh, dft_accum_shard=4 * nh))
        sharded_1000("heating_256 --water-block --sar --dft 2.45e10", ph, heat_dft_ref, {k: v for k, v in want.items() if v},
                     shard_model(ph, s_hd + 1 if backend == "auto" else 1, backend == "auto", lossy=True, sar=True,
                                 dft=DFT1),
                     f"heating_256 --water-block --sar --dft 2.45e10 {'stream' if backend == 'auto' else backend}",
                     backend, materials=water, accumulate_power=True, dft=DFT1)
    del heat_dft_ref
    sharded_1000("bench_256 --pml 10 --dft 2.45e10", p, pml_dft_ref,
                 dict(yee_update_h_pml_shard=4 * n, yee_update_e_pml_shard=4 * n, dft_accum_shard=4 * n),
                 shard_model(p, 1, False, pml=PML10, dft=DFT1), "bench_256 --pml 10 --dft 2.45e10 stream", pml=PML10,
                 dft=DFT1)
    del pml_dft_ref
    sharded_1000("heating_256 --water-block --dispersive --sar", ph, debye_ref[:2] + (None, debye_ref[2]), {},
                 shard_model(ph, 1, False, sar=True, ade=True), "heating_256 --water-block --dispersive --sar stream",
                 materials=debye, accumulate_power=True)
    del debye_ref
    # probes and the H sums (--probe x3 --dft-fields eh): twopass unsharded, then on 4 slabs (auto: twopass)
    t0 = time.perf_counter()
    res_m = run_simulation(p, dev, write_snapshots=False, backend="twopass", dft=dft_eh, probes=probes2,
                           log=lambda m: None)
    main_rates["bench_256 --probe x3 --dft 2.45e10 --dft-fields eh twopass"] = res_m.mcells_per_s
    sharded_1000("bench_256 --probe x3 --dft 2.45e10 --dft-fields eh", p, res_m,
                 dict(yee_update_h_shard=4 * n, yee_update_e_shard=4 * n, dft_accum_shard=4 * n),
                 shard_model(p, 1, False, dft=dft_eh), "bench_256 --probe x3 --dft 2.45e10 --dft-fields eh twopass",
                 dft=dft_eh, probes=probes2)
    check(float(np.abs(res_m.probes.values[:, 2]).max()) > 0 and res_m.probes.values.shape == (n, 3, 6),
          f"the probe rows move: {res_m.probes.values.shape}, peak {float(np.abs(res_m.probes.values).max())!r} "
          f"({time.perf_counter() - t0:.1f} s for both runs)")
    del res_m
    torch.cuda.empty_cache()

    # the other variants on 4 slabs, from random fields: CPML with the
    # water + ferrite load and SAR on twopass (66 steps), and the DFT bands
    # of every material variant with nf = 2 on stream (16 sweeps and 2
    # trailing two-pass steps with dft_accum), == their unsharded runs
    def shard_load(pm: Params, mats, sar: bool, backend: str, label: str, pml=None, dft=None,
                   steps: int = N_LOADS) -> dict:
        tv = time_values(pm)[:steps]
        xs_l = scan_inputs(pm, tv) + (dft_weights(dft, tv) if dft is not None else ())
        init = {c: rng.uniform(-1.0, 1.0, pm.padded_shape).astype(np.float32) for c in COMPONENTS}
        outs = []
        for sharded in (False, True):
            s_l = state_from_numpy(init, dev, torch.float32)
            extra = dict(power=zero_power_acc(pm, dev) if sar else None, psi=init_psi(pm, pml, dev) if pml else None,
                         pml=pml, pol=None, dacc=zero_dft_acc(pm, dft, dev) if dft is not None else None)
            if not sharded:
                make_chunk_runner(pm, dev, mats, backend, accumulate_power=sar, pml=pml, dft=dft)(
                    s_l, xs_l, extra["power"], extra["psi"], None, extra["dacc"])
            else:
                run_l = (sharded_fast.make_sharded_stream_runner(pm, mesh4, mats, sar, dft=dft) if backend == "stream"
                         else sharded_step_mod.make_sharded_chunk_runner(pm, mesh4, mats, sar, backend, pml, dft))
                shards = shard_mesh.scatter(pm, s_l, mesh4, run_l.depth, **extra)
                reset_counts()
                run_l(shards, xs_l)
                torch.cuda.synchronize()
                counts = counts_now()
                shard_mesh.gather(pm, shards, s_l, **extra)
                del shards
            outs.append((s_l, extra))
        (a, ea), (b, eb) = outs
        d = maxdiff(a, b)
        for key in ("power", "psi", "dacc"):
            if ea[key] is not None:
                d = max(d, maxdiff(ea[key], eb[key]) if key != "power" else absdiff(ea[key], eb[key]))
        check(d == 0.0, f"heating_256 {label} --shard 4 {backend}, {steps} steps from random fields == unsharded: "
                        f"max|diff| = {d!r}; launch counts {counts}")
        return counts

    counts = shard_load(ph, ferrite, True, "twopass", "--water-block --ferrite-slab --sar --pml 10", pml=PML10)
    want = expect(yee_update_h_het_pml_shard=4 * N_LOADS, yee_update_e_lossy_pml_shard=4 * N_LOADS)
    check(counts == want, f"--water-block --ferrite-slab --sar --pml 10 --shard 4 launch counts {counts} == {want}")
    for name in ("yee_update_h_het_pml_shard", "yee_update_e_lossy_pml_shard"):
        main_counts[name] = counts[name]
        paths[name] = f"heating_256 --water-block --ferrite-slab --sar --pml 10 --shard 4 twopass ({N_LOADS} steps)"
    for mats_l, sar_l, scene_l in ((None, False, ""), (water, False, "--water-block "),
                                   (ferrite, False, "--water-block --ferrite-slab "),
                                   (ferrite, True, "--water-block --ferrite-slab --sar ")):
        lossy_l = mats_l is not None
        plan_l = sharded_fast.pick_shard_plan(ph, mesh4, lossy=lossy_l, het=lossy_l and mats_l.mu_r is not None,
                                              sar=sar_l, dft=DFT2)[0]
        steps_l = N_LOADS + (N_LOADS % plan_l.s == 0)  # an odd count at s = 2
        counts = shard_load(ph, mats_l, sar_l, "stream", f"{scene_l}--dft (nf=2)", dft=DFT2, steps=steps_l)
        kname = plan_l.kernel + "_shard"
        trail = steps_l % plan_l.s
        h_l = "yee_update_h_het_shard" if lossy_l and mats_l.mu_r is not None else "yee_update_h_shard"
        e_l = "yee_update_e_lossy_shard" if lossy_l else "yee_update_e_shard"
        want = expect(**{kname: 4 * (steps_l // plan_l.s), h_l: 4 * trail, e_l: 4 * trail, "dft_accum_shard": 4 * trail})
        check(counts == want and trail, f"{scene_l}--dft (nf=2) --shard 4 stream launch counts {counts} == {want}")
        if kname not in main_counts:
            main_counts[kname] = counts[kname]
            paths[kname] = f"heating_256 {scene_l}--dft 2.45e10,1.5e10 --shard 4 stream ({steps_l} steps)"
    torch.cuda.empty_cache()
    phase_done("7b sharded runs")

    # the CLI with --shard 4 writes the unsharded outputs: --pml 10 (rate 500;
    # snapshots and the radiated_W log) and the heating scene with --dft
    # 2.45e10 (snapshots, sar.vtr, dft_00.vtr, log)
    with tempfile.TemporaryDirectory() as out:
        for label, argv, ref_dir, ref_log, n_files in (
                ("bench_256 (rate 500) --pml 10", [params_pml, "--pml", "10"], os.path.join(pml_cli, "r"),
                 os.path.join(pml_cli, "diag.jsonl"), 3),
                ("heating_256 (rate 500) --water-block --sar --dft 2.45e10",
                 [heat500, "--water-block", "--sar", "--dft", "2.45e10"],
                 os.path.join(dft_cli, "one"), os.path.join(dft_cli, "one.jsonl"), 5)):
            sub = os.path.join(out, str(n_files))
            t0 = time.perf_counter()
            r = run_cli([*argv, "--shard", "4", "--out", sub, "--diag-log", sub + ".jsonl"])
            cli_s = time.perf_counter() - t0
            names, d = same_outputs(ref_dir, sub)
            logs = [open(path).read() if os.path.exists(path) else None for path in (ref_log, sub + ".jsonl")]
            check(r.returncode == 0 and len(names) == n_files and d == 0.0 and logs[0] == logs[1]
                  and logs[0] is not None and len(logs[0].splitlines()) >= 3,
                  f"CLI {label} --shard 4 in {cli_s:.1f} s writes the unsharded {names} (max|diff| {d!r}) and energy "
                  f"log: {r.stdout.strip().splitlines()[-3:]} {r.stderr.strip()[-300:]}")
    for tmp in (pml_cli, dft_cli, os.path.dirname(heat500)):
        shutil.rmtree(tmp, ignore_errors=True)
    for key, val in shard_rates.items():
        print(f"rate 256^3 1000 steps {key}: {val!r} Mcells/s ({smi})")

    # each new shard kernel's time at 256^3 on a middle slab of --shard 4,
    # scattered as its runner scatters it, beside its plain version and its
    # bound (what the launch reads and writes once)
    arrays = {c: rng.uniform(-1.0, 1.0, p.padded_shape).astype(np.float32) for c in COMPONENTS}
    w1 = torch.tensor([[0.5], [0.25]], dtype=torch.float32, device=dev)
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(p, dtype=dtype)
        fp32 = dtype == "float32"
        canon_t = state_from_numpy(arrays, dev, field_dtype(pd))
        # K10-shard: H and E, vacuum and the het-mu H / lossy E variants
        s1 = shard_mesh.scatter(pd, canon_t, mesh_t, 1, psi=init_psi(pd, PML10, dev), pml=PML10,
                                dacc=zero_dft_acc(pd, DFT1, dev))[1]
        box1 = s1.box
        v_own = math.prod(h - lo for lo, h in zip(box1.own_lo, box1.own_hi))
        c_own = math.prod(box1.cell_shape(pd))
        part_n = psi_part_shapes(pd, PML10, box1)
        psi_h1 = sum(math.prod(part_n[t]) for t in cpml.H_TERMS)
        psi_e1 = sum(math.prod(part_n[t]) for t in cpml.E_TERMS)
        for mats_t, h_name, e_name in ((None, "yee_update_h_pml_shard", "yee_update_e_pml_shard"),
                                       (ferrite, "yee_update_h_het_pml_shard", "yee_update_e_lossy_pml_shard")):
            cf1 = shard_coefs(pd, coefs_of(pd, mats_t), box1, dev)
            cp1 = make_cpml(pd, PML10, cf1, dev, box1)
            k_h = event_ms(lambda: yee.update_h(pd, s1.state, cf1, patch_t, cp1, s1.psi, box=box1))
            k_e = event_ms(lambda: yee.update_e(pd, s1.state, cf1, cp1, s1.psi, box=box1))
            if fp32:
                ms[h_name] = (k_h, event_ms(lambda: cp1.plain_h(pd, s1.state, cf1, s1.psi, patch_t), reps=5))
                ms[e_name] = (k_e, event_ms(lambda: cp1.plain_e(pd, s1.state, cf1, s1.psi), reps=5))
                het_t = cf1.heterogeneous_mu
                # H: H (and hf) over the owned window, E one plane past it, the H psi parts in; H and psi out
                shard_work[h_name] = ((3 + (3 if het_t else 0)) * v_own + 3 * window_plus(box1, "hi") + psi_h1,
                                      3 * v_own + psi_h1, 15 * v_own + 5 * psi_h1, 0)
                shard_work[e_name] = ((3 + (6 if cf1.lossy else 0)) * v_own + 3 * window_plus(box1, "lo") + psi_e1,
                                      3 * v_own + psi_e1, (18 if cf1.lossy else 15) * v_own + 5 * psi_e1, 0)
            else:
                ms_bf16[h_name], ms_bf16[e_name] = k_h, k_e
            del cf1, cp1
        # K4-shard: E over the owned window and the plane above it in, the sums in and out
        k_ms = event_ms(lambda: dft_ops.accumulate_e(pd, s1.state, w1, s1.dacc, box1))
        if fp32:
            ms["dft_accum_shard"] = (k_ms, event_ms(lambda: dft_ops.plain_accumulate_e(pd, s1.state, w1, s1.dacc, box1)))
            shard_work["dft_accum_shard"] = (3 * window_plus(box1, "hi"), 0, 24 * c_own, 0)
            shard_sums["dft_accum_shard"] = 48 * c_own
        else:
            ms_bf16["dft_accum_shard"] = k_ms
        del s1
        # K3-shard-DFT: the five variants at their --shard 4 plan with nf = 1
        for mats_t, sar_t in ((None, False), (water, False), (water, True), (ferrite, False), (ferrite, True)):
            lossy_t = mats_t is not None
            het_t = lossy_t and mats_t.mu_r is not None
            plan_t = sharded_fast.pick_shard_plan(pd, mesh_t, lossy=lossy_t, het=het_t, sar=sar_t, dft=DFT1)[1]
            k_name = plan_t.kernel + "_shard"
            sh = shard_mesh.scatter(pd, canon_t, mesh_t, plan_t.s + 1, zero_power_acc(pd, dev) if sar_t else None,
                                    dacc=zero_dft_acc(pd, DFT1, dev))[1]
            cf = shard_coefs(pd, coefs_of(pd, mats_t), sh.box, dev)
            box = sh.box
            v_box, v_own = math.prod(box.shape), math.prod(tuple(h - lo for lo, h in zip(box.own_lo, box.own_hi)))
            c_own = math.prod(box.cell_shape(pd))
            src = make_source_plan(pd)
            amps = torch.tensor(rng.uniform(-1.0, 1.0, plan_t.s), dtype=torch.float64, device=dev)
            ez_rows, hx_rows = sweep_drive_rows(src, amps, plan_t.s, field_dtype(pd), profile_tensor(src, dev))
            drive = stream.SweepDrive(src.patch, ez_rows[0], hx_rows[0])
            out_t = FieldState(*(torch.empty_like(t) for t in sh.state.tensors()))
            wts = w1.reshape(1, 2, 1).expand(plan_t.s, 2, 1).contiguous()
            k_ms = event_ms(lambda: stream.sweep(pd, sh.state, out_t, cf, plan_t, drive, sh.power, dacc=sh.dacc,
                                                 wts=wts, box=box))
            if fp32:
                plans[k_name] = plan_t
                ms[k_name] = (k_ms, event_ms(lambda: stream.plain_sweep(pd, sh.state, cf, plan_t.s, drive, out_t,
                                                                        sh.power, dacc=sh.dacc, wts=wts, box=box),
                                             reps=3))
                in_vals = (6 + (6 if lossy_t else 0) + (3 if het_t else 0)) * v_box
                ops = plan_t.s * (v_own * (15 + (18 if lossy_t else 15)) + (20 * c_own if sar_t else 0) + 24 * c_own)
                shard_work[k_name] = (in_vals, 6 * v_own, ops, c_own if sar_t else 0)
                shard_sums[k_name] = 48 * c_own
            else:
                ms_bf16[k_name] = k_ms
            del sh, cf, out_t
        del canon_t
    del arrays
    torch.cuda.empty_cache()
    phase_done("7b CLI and kernel times")


    # -- 10. the thermal solve, the coupled cook and the sweeps -----------------
    # (ROADMAP items 6 and 10; runs here, before the timing of phase 8)
    import filecmp

    from fdtd_tpu_torch import coupled as coupled_mod
    from fdtd_tpu_torch import profile_chunk, sweep
    from fdtd_tpu_torch import thermal
    from fdtd_tpu_torch.io.vtr import read_vtr_cell_arrays as read_vtr
    from fdtd_tpu_torch.source import apply_source_batch
    from fdtd_tpu_torch.state import block_mask

    # (a) the thermal solve on phase 6's 256^3 heating SAR map, normalized
    # to a 1 kW magnetron, a 2 s cook in fp64 and in fp32
    tm_h = thermal.thermal_from_mask(ph, block_mask(ph))
    q_h = coupled_mod.normalize_power(ph, heat_sar.to(device="cpu", dtype=torch.float64).numpy() / (nh * ph.time_step),
                                      THERMAL_WATTS)
    dt_h = thermal.stable_dt(ph, tm_h)  # host fp64, a second or two at 256^3: once for every solve here
    rises, thermal_s = {}, {}
    for dtype in ("float64", "float32"):
        pd = dataclasses.replace(ph, dtype=dtype)
        t0 = time.perf_counter()
        tr = thermal.run_thermal(pd, tm_h, q_h, THERMAL_COOK_S, dt=dt_h, device=dev)
        torch.cuda.synchronize()
        thermal_s[dtype] = time.perf_counter() - t0
        rises[dtype] = tr.rise
        check(tr.rise.dtype == thermal.thermal_dtype(pd) and bool(torch.isfinite(tr.rise).all())
              and float(tr.rise.max()) > 0,
              f"thermal 256^3 {dtype}: {tr.steps} steps of {tr.dt!r} s over a {THERMAL_COOK_S} s cook in "
              f"{thermal_s[dtype]:.2f} s (host set-up but stable_dt included), peak rise {float(tr.rise.max())!r} K")
    # insulated walls: the heat content is the deposited energy, sum(rho_c * rise) dV = Q t
    dv = ph.spatial_step**3
    heat = float((torch.tensor(tm_h.rho_c, device=dev) * rises["float64"]).sum()) * dv
    want_j = float(q_h.sum()) * dv * THERMAL_COOK_S
    check(abs(heat / want_j - 1.0) < 1e-5,
          f"thermal 256^3 fp64 energy: sum(rho_c rise) dV = {heat!r} J against Q t = {want_j!r} J "
          f"(relative {heat / want_j - 1.0!r}, bar 1e-5)")
    d_th = float((rises["float32"].double() - rises["float64"]).abs().max())
    peak_th = float(rises["float64"].max())
    check(d_th <= THERMAL_FP32_BAR * peak_th,
          f"thermal 256^3 fp32 against fp64: max|diff| {d_th!r} K = {d_th / peak_th!r} of the peak rise "
          f"{peak_th!r} K (bar {THERMAL_FP32_BAR!r}: fp32 rounding over the cook's steps)")
    del rises
    thermal_ms = {}
    for dtype, item in (("float32", 4), ("float64", 8)):
        pd = dataclasses.replace(ph, dtype=dtype)
        step_th = thermal.make_thermal_step(pd, tm_h, q_h, dt_h, dev)
        T_th = torch.zeros((ph.maxk, ph.maxj, ph.maxi), dtype=thermal.thermal_dtype(pd), device=dev)
        thermal_ms[dtype] = event_ms(lambda: step_th(T_th))
        # T, three face conductivities, dt/rho_c and q dt/rho_c read once, T written once
        bound_th = 7 * item * ph.maxk * ph.maxj * ph.maxi / HBM_BYTES_PER_S * 1e3
        print(f"timing 256^3 thermal step {dtype}: {thermal_ms[dtype]!r} ms a step ({1e3 / thermal_ms[dtype]!r} "
              f"steps a second of cook), byte bound {bound_th!r} ms ({bound_th / thermal_ms[dtype]!r} of it); "
              f"the {THERMAL_COOK_S} s cook {thermal_s[dtype]!r} s with its host set-up ({smi})")
        del step_th, T_th
    torch.cuda.empty_cache()

    # (b) the coupled cook through the CLI, on auto (the lossy + SAR sweep)
    # and on twopass: the same bits; each interval's host materials build,
    # update_coefs (host fp64), EM run and thermal solve timed on the host
    # clock; auto checkpoints its intervals, and the checkpoint after
    # interval 2 resumes to the same cook
    split = dict.fromkeys(("materials", "update_coefs", "em", "thermal"), 0.0)
    real = {"materials": coupled_mod.materials_at_temperature, "update_coefs": update_coefs,
            "em": coupled_mod.run_simulation, "thermal": coupled_mod.run_thermal}

    def timed(key):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[key](*a, **k)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            return out
        return call

    save_ckpt = coupled_mod._save_coupled_ckpt
    cook_root = tempfile.mkdtemp()
    resume_dir = os.path.join(cook_root, "resume")

    def save_and_keep(out_dir, R, it_done, summaries):
        save_ckpt(out_dir, R, it_done, summaries)
        if it_done == 2 and out_dir.endswith("auto"):  # the checkpoint after interval 2, kept for the resume
            os.makedirs(resume_dir, exist_ok=True)
            shutil.copy(os.path.join(out_dir, "coupled_ckpt.npz"), resume_dir)

    coupled_mod.materials_at_temperature = timed("materials")
    coupled_mod.run_simulation, coupled_mod.run_thermal = timed("em"), timed("thermal")
    step_mod.update_coefs = timed("update_coefs")  # the runner's fp64 host build, unmemoized: new maps each interval
    coupled_mod._save_coupled_ckpt = save_and_keep
    cook = ["configs/heating_256.txt", "--water-block", "--sar", "--coupled", "3", "--thermal", "10",
            "--thermal-power", "1000"]
    n_cook = 3 * nh
    cook_files = ["coupled.jsonl", "temperature.vtr", "temperature_00.vtr", "temperature_01.vtr",
                  "temperature_02.vtr"]
    try:
        for backend in ("auto", "twopass"):
            for key in split:
                split[key] = 0.0
            out_c = os.path.join(cook_root, backend)
            reset_counts()
            t0 = time.perf_counter()
            r = run_cli(cook + ["--backend", backend, "--out", out_c]
                        + (["--checkpoint-every", "1"] if backend == "auto" else []))
            wall_c = time.perf_counter() - t0
            counts = counts_now()
            want = (expect(yee_stream_lossy_sar=n_cook // heat_plan.s) if backend == "auto" else
                    expect(yee_update_h=n_cook, yee_update_e_lossy=n_cook))
            rows = ([json.loads(line) for line in open(os.path.join(out_c, "coupled.jsonl"))]
                    if r.returncode == 0 else [])
            check(r.returncode == 0 and counts == want and len(rows) == 3
                  and all(os.path.exists(os.path.join(out_c, f)) for f in cook_files)
                  and rows[-1]["peak_t_c"] > rows[0]["peak_t_c"] > 20.0,
                  f"CLI {' '.join(cook[1:])} --backend {backend}: exit {r.returncode} in {wall_c:.1f} s, launch "
                  f"counts {counts} == {want}, peak {[row['peak_t_c'] for row in rows]} C, eps_r "
                  f"{[row['eps_r_range'] for row in rows]} {r.stderr.strip()[-300:]}")
            print(f"coupled interval 256^3 --backend {backend} (3 intervals, {wall_c!r} s of CLI wall): per interval "
                  f"materials {split['materials'] / 3!r} s (water_debye and the maps, host), update_coefs "
                  f"{split['update_coefs'] / 3!r} s (the runner's fp64 host build and copy), EM run "
                  f"{(split['em'] - split['update_coefs']) / 3!r} s (run_simulation less update_coefs), thermal "
                  f"{split['thermal'] / 3!r} s (run_thermal, host set-up included) ({smi})", flush=True)
        same = [f for f in cook_files if filecmp.cmp(os.path.join(cook_root, "auto", f),
                                                     os.path.join(cook_root, "twopass", f), shallow=False)]
        check(same == cook_files, f"coupled cook auto == twopass bit for bit: {same} of {cook_files}")
        reset_counts()
        r = run_cli(cook + ["--checkpoint-every", "1", "--resume", "--out", resume_dir])
        counts = counts_now()
        same = [f for f in ("coupled.jsonl", "temperature.vtr", "temperature_02.vtr")
                if filecmp.cmp(os.path.join(cook_root, "auto", f), os.path.join(resume_dir, f), shallow=False)]
        check(r.returncode == 0 and "Resuming coupled cook after interval 2" in r.stdout and len(same) == 3
              and counts == expect(yee_stream_lossy_sar=nh // heat_plan.s),
              f"coupled cook resumed after interval 2 == the uninterrupted cook bit for bit ({same}); launch counts "
              f"{counts} {r.stderr.strip()[-300:]}")
        # (c) the turntable: an off-center load at 10 rpm, 2 intervals
        out_r = os.path.join(cook_root, "rotate")
        reset_counts()
        r = run_cli(["configs/heating_256.txt", "--water-block", "--sar", "--coupled", "2", "--thermal", "10",
                     "--thermal-power", "1000", "--rotate", "10", "--load-center", "0.35,0.5", "--out", out_r])
        counts = counts_now()
        rows = [json.loads(line) for line in open(os.path.join(out_r, "coupled.jsonl"))] if r.returncode == 0 else []
        maps = read_vtr(os.path.join(out_r, "temperature.vtr")) if r.returncode == 0 else {}
        lab, mat = maps.get("temperature_c_lab"), maps.get("temperature_c_material_frame")
        check(r.returncode == 0 and counts == expect(yee_stream_lossy_sar=2 * nh // heat_plan.s)
              and np.allclose([row["theta_deg"] for row in rows], [150.0, 450.0], rtol=0, atol=1e-9)
              and lab is not None and bool(np.isfinite(lab).all() and np.isfinite(mat).all())
              and float(mat.max()) > 20.0 and not np.array_equal(lab, mat),
              f"CLI --coupled 2 --rotate 10 --load-center 0.35,0.5: exit {r.returncode}, launch counts {counts}, "
              f"angles {[row['theta_deg'] for row in rows]}, peak {[row['peak_t_c'] for row in rows]} C, "
              f"raw absorbed {[row['raw_absorbed_w'] for row in rows]} W {r.stderr.strip()[-300:]}")
    finally:
        coupled_mod.materials_at_temperature = real["materials"]
        coupled_mod.run_simulation, coupled_mod.run_thermal = real["em"], real["thermal"]
        coupled_mod._save_coupled_ckpt = save_ckpt
        step_mod.update_coefs = memo_update_coefs
        shutil.rmtree(cook_root, ignore_errors=True)
    del heat_sar
    torch.cuda.empty_cache()
    phase_done("10 thermal and coupled cooks")

    # (d) the sweep: frequency_sweep(backend="pallas_fused") of 4 members at
    # 256^3 (the batched K1/K2, one launch each a step), equal to four single
    # twopass runs; the batched kernels against their plain versions (each
    # member's curl passes) and the per-member kernels
    freqs = [2.45e10 * (1.0 + 0.05 * b) for b in range(SWEEP_MEMBERS)]
    p_sw = dataclasses.replace(p, simulation_time=199.5 * p.time_step)
    n_sw = len(time_values(p_sw))
    reset_counts()
    res_sw = sweep.frequency_sweep(p, freqs, n_steps=n_sw, backend="pallas_fused", device=dev, log=lambda m: None)
    torch.cuda.synchronize()
    counts = counts_now()
    check(n_sw == 200 and counts == expect(yee_update_h_batch=n_sw, yee_update_e_batch=n_sw),
          f"frequency_sweep 256^3 x{SWEEP_MEMBERS} pallas_fused {n_sw} steps: launch counts {counts}")
    main_counts["yee_update_h_batch"], main_counts["yee_update_e_batch"] = n_sw, n_sw
    for name in ("yee_update_h_batch", "yee_update_e_batch"):
        paths[name] = f"frequency_sweep 256^3 x{SWEEP_MEMBERS} pallas_fused ({n_sw} steps)"
    reset_counts()
    d_sw = 0.0
    for b, f in enumerate(freqs):
        one = run_simulation(dataclasses.replace(p_sw, source=dataclasses.replace(p_sw.source, frequency=f)), dev,
                             backend="twopass", write_snapshots=False, log=lambda m: None)
        d_sw = max(d_sw, maxdiff(sweep.member(res_sw.states, b), one.state))
        del one
    counts = counts_now()
    check(d_sw == 0.0 and counts == expect(yee_update_h=SWEEP_MEMBERS * n_sw, yee_update_e=SWEEP_MEMBERS * n_sw)
          and float(res_sw.e_energy.min()) > 0,
          f"frequency_sweep 256^3 x{SWEEP_MEMBERS} == {SWEEP_MEMBERS} single twopass runs bit for bit: max|diff| "
          f"{d_sw!r}; single-run launch counts {counts}; member E energies {res_sw.e_energy.tolist()}")
    del res_sw
    torch.cuda.empty_cache()
    fields_b = {}  # random fields per size, shared by both dtypes
    for n_b, m_b, dtype in (("ragged", RAGGED_BATCH, "float32"), ("ragged", RAGGED_BATCH, "bfloat16"),
                            (64, 8, "float32"), (64, 8, "bfloat16"), (256, SWEEP_MEMBERS, "float32"),
                            (256, SWEEP_MEMBERS, "bfloat16")):
        # the ragged batch: 35 x 29 x 31 a member (narrow tiles, edge blocks along j in the H pass), an odd
        # member size, so the members' arrays start at every lead of a 16-byte chunk
        pb = (Params(length=0.0305, width=0.0285, height=0.0345, spatial_step=0.001, time_step=1e-12,
                     simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype=dtype)
              if n_b == "ragged" else profile_chunk.scene(n_b, dtype))
        label = "x".join(map(str, pb.padded_shape)) if n_b == "ragged" else f"{n_b}^3"
        if n_b not in fields_b:
            fields_b[n_b] = [torch.rand((m_b,) + pb.padded_shape, generator=torch.Generator(dev).manual_seed(c),
                                        device=dev) * 2.0 - 1.0 for c in range(len(COMPONENTS))]
        init = [t.to(field_dtype(pb)) for t in fields_b[n_b]]
        k_batch, k_each, plain = (FieldState(*(t.clone() for t in init)) for _ in range(3))
        item = init[0].element_size()
        lead0 = k_batch.ex.data_ptr() % 16 // item
        leads = [k_batch.ex[b].data_ptr() % 16 // item for b in range(m_b)]
        want_leads = [stream_plan.member_lead(lead0, stream_plan.member_start(b, pb.padded_shape), item)
                      for b in range(m_b)]
        amps_b = torch.tensor(rng.uniform(-1.0, 1.0, m_b), dtype=torch.float64, device=dev)
        src_b = make_source_plan(pb)
        prof_b, vac_b = profile_tensor(src_b, dev), update_coefs(pb)
        apply_source_batch(src_b, k_batch, amps_b, prof_b)
        yee.update_h_batch(pb, k_batch, vac_b, src_b.patch)
        torch.cuda.synchronize()
        views = [(sweep.member(k_each, b), sweep.member(plain, b)) for b in range(m_b)]
        for b, (ke, pl) in enumerate(views):
            apply_source(src_b, ke, amps_b[b], prof_b)
            yee.update_h(pb, ke, vac_b, src_b.patch)
            apply_source(src_b, pl, amps_b[b], prof_b)
            curl.update_h(pb, pl, vac_b, src_b.patch)
        torch.cuda.synchronize()
        d_h = max(maxdiff(k_batch, plain), maxdiff(k_batch, k_each))
        yee.update_e_batch(pb, k_batch, vac_b)
        for ke, pl in views:
            yee.update_e(pb, ke, vac_b)
            curl.update_e(pb, pl, vac_b)
        torch.cuda.synchronize()
        d_e = max(maxdiff(k_batch, plain), maxdiff(k_batch, k_each))
        record_err("yee_update_h_batch", d_h)
        record_err("yee_update_e_batch", d_e)
        check(d_h == 0.0 and d_e == 0.0 and leads == want_leads
              and (n_b != "ragged" or sorted(set(leads)) == list(range(16 // item))),
              f"batched K1/K2 {label} x{m_b} {dtype} == the plain passes and the per-member kernels, one step from "
              f"random fields: H max|diff| {d_h!r}, E {d_e!r}; the members' leads {leads} (stream_plan.member_lead "
              f"{want_leads})")
        if n_b != "ragged":
            fp32 = dtype == "float32"
            t_h = event_ms(lambda: yee.update_h_batch(pb, k_batch, vac_b, src_b.patch))
            t_e = event_ms(lambda: yee.update_e_batch(pb, k_batch, vac_b))
            each_h = event_ms(lambda: [yee.update_h(pb, ke, vac_b, src_b.patch) for ke, _ in views])
            each_e = event_ms(lambda: [yee.update_e(pb, ke, vac_b) for ke, _ in views])
            # the bound: each member's six fields read once and three written once
            bound_b = m_b * 9 * item * math.prod(pb.padded_shape) / HBM_BYTES_PER_S * 1e3
            plans_b = [stream_plan.march_plan(pb, None, e_pass, members=m_b) for e_pass in (False, True)]
            if n_b == 256 and fp32:
                ms["yee_update_h_batch"] = (t_h, event_ms(lambda: [curl.update_h(pb, pl, vac_b, src_b.patch)
                                                                   for _, pl in views], reps=5))
                ms["yee_update_e_batch"] = (t_e, event_ms(lambda: [curl.update_e(pb, pl, vac_b) for _, pl in views],
                                                          reps=5))
            elif n_b == 256:
                ms_bf16["yee_update_h_batch"], ms_bf16["yee_update_e_batch"] = t_h, t_e
            print(f"timing {label} x{m_b} {dtype}: batched K1 {t_h!r} ms ({bound_b / t_h!r} of its bound "
                  f"{bound_b!r} ms; tk {plans_b[0].tk}, {plans_b[0].blocks} blocks), K2 {t_e!r} ms "
                  f"({bound_b / t_e!r}; tk {plans_b[1].tk}, {plans_b[1].blocks} blocks) a launch; the {m_b} "
                  f"per-member launches {each_h!r} and {each_e!r} ms (queued behind a spin kernel: device time "
                  f"only) ({smi})", flush=True)
        del init, k_batch, k_each, plain, views
    del fields_b
    torch.cuda.empty_cache()
    # the device's idle share over a chunk of the sweep, the batched
    # launches against the per-member ones (the launch-shape decision)
    for n_b, m_b in ((64, 8), (256, SWEEP_MEMBERS)):
        for batched in (True, False):
            rec = profile_chunk.profile_sweep(profile_chunk.scene(n_b, "float32"), m_b, "twopass", N_TIMED, N_WARM,
                                              dev, batched)
            print(f"sweep idle {n_b}^3 x{m_b} twopass {'batched' if batched else 'per member'}: wall "
                  f"{rec['wall_ms_per_step']!r} ms a step, device {rec['device_ms_per_step']!r} ms, idle share "
                  f"{rec['idle_share_profiled']!r} (profiled); launches a step {rec['launches_per_step']} ({smi})",
                  flush=True)
    phase_done("10 sweeps")

    # -- 8. timing ---------------------------------------------------------
    rates: dict[str, list[float]] = {}
    dcs = dc_by_dtype  # the Debye maps per dtype (p and ph share the grid and the step)
    for dft_t in (None, DFT1):
        for scene_t, mats_t, pml_t in (("vacuum", None, None), ("heating", water, None), ("pml", None, PML10),
                                       ("dispersive", debye, None)):
            for dtype in ("float32", "bfloat16"):
                pd = dataclasses.replace(p, dtype=dtype)
                tv = time_values(pd)[: N_WARM + N_TIMED]
                ts, amps = scan_inputs(pd, tv)
                cw, sw = dft_weights(dft_t, tv) if dft_t is not None else (None, None)
                sar = mats_t is not None
                debye_t = isinstance(mats_t, DebyeMaterials)
                if debye_t and dtype not in dcs:
                    dcs[dtype] = debye_coefs(pd, debye, dev)
                runners = {}  # one runner a backend: its coefficients are built once
                for backend in ("stream", "twopass", "torch", "torch", "twopass", "stream"):
                    s = initial_state(pd, dev)
                    power = zero_power_acc(pd, dev) if sar else None
                    psi_t = init_psi(pd, pml_t, dev) if pml_t is not None else None
                    pol_t = zero_polarization(pd, dev) if debye_t else None
                    dacc_t = zero_dft_acc(pd, dft_t, dev) if dft_t is not None else None
                    if backend not in runners:
                        runners[backend] = make_chunk_runner(pd, dev, mats_t, backend, accumulate_power=sar, pml=pml_t,
                                                             dft=dft_t, dc=dcs.get(dtype) if debye_t else None)
                    run = runners[backend]
                    extra = (lambda a, b: (cw[a:b], sw[a:b])) if dft_t is not None else (lambda a, b: ())
                    run(s, (ts[:N_WARM], amps[:N_WARM]) + extra(0, N_WARM), power, psi_t, pol_t, dacc_t)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run(s, (ts[N_WARM:], amps[N_WARM:]) + extra(N_WARM, N_WARM + N_TIMED), power, psi_t, pol_t, dacc_t)
                    torch.cuda.synchronize()
                    dt_s = time.perf_counter() - t0
                    key = f"{scene_t}{' --dft 2.45e10' if dft_t is not None else ''} {backend} {dtype}"
                    rates.setdefault(key, []).append(pd.cell_count * N_TIMED / dt_s / 1e6)
                    del s, power, run, psi_t, pol_t, dacc_t
                del runners
    for key, vals in rates.items():
        print(f"timing 256^3 {key}: Mcells/s {vals} (2 runs of {N_TIMED} steps, {smi})")
    phase_done("8 rates")

    patch = make_source_plan(p).patch
    arrays = {c: rng.uniform(-1.0, 1.0, p.padded_shape).astype(np.float32) for c in COMPONENTS}
    ade_extra: dict[str, float] = {}
    variants = (("", None, False), ("_lossy", water, False), ("_lossy_sar", water, True),
                ("_lossy_het", ferrite, False), ("_lossy_het_sar", ferrite, True))
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(p, dtype=dtype)
        fp32 = dtype == "float32"
        s_d = initial_state(dataclasses.replace(pd, mode=Mode.VALIDATION), dev)
        for mats_t, names in ((None, ("yee_update_h", "yee_update_e")),
                              (ferrite, ("yee_update_h_het", "yee_update_e_lossy"))):
            coefs_t = coefs_of(pd, mats_t)
            k_h = event_ms(lambda: yee.update_h(pd, s_d, coefs_t, patch))
            k_e = event_ms(lambda: yee.update_e(pd, s_d, coefs_t))
            if fp32:
                ms[names[0]] = (k_h, event_ms(lambda: curl.update_h(pd, s_d, coefs_t, patch)))
                ms[names[1]] = (k_e, event_ms(lambda: curl.update_e(pd, s_d, coefs_t)))
            else:
                ms_bf16[names[0]], ms_bf16[names[1]] = k_h, k_e
            del coefs_t
        del s_d
        for suffix, mats_t, sar in variants:
            name = "yee_stream" + suffix
            coefs_t = coefs_of(pd, mats_t)
            plan_t = stream_plan.pick_plan(pd, lossy=coefs_t.lossy, het=coefs_t.heterogeneous_mu, sar=sar)
            st, drive, _ = sweep_inputs(pd, arrays, plan_t.s)
            out = FieldState(*(torch.empty_like(t) for t in st.tensors()))
            acc = zero_power_acc(pd, dev) if sar else None
            k_ms = event_ms(lambda: stream.sweep(pd, st, out, coefs_t, plan_t, drive, acc))
            if fp32:
                plans[name] = plan_t
                ms[name] = (k_ms, event_ms(lambda: stream.plain_sweep(pd, st, coefs_t, plan_t.s, drive, out, acc),
                                           reps=5))
            else:
                ms_bf16[name] = k_ms
            del coefs_t, st, out, acc
        # CPML: the two-pass variants (vacuum; het-mu H + lossy E) and the
        # sweeps (vacuum, lossy) at the --pml 10 path's shapes
        s_d = initial_state(dataclasses.replace(pd, mode=Mode.VALIDATION), dev)
        psi_d = init_psi(pd, PML10, dev)
        for mats_t, names in ((None, ("yee_update_h_pml", "yee_update_e_pml")),
                              (ferrite, ("yee_update_h_het_pml", "yee_update_e_lossy_pml"))):
            coefs_t = coefs_of(pd, mats_t)
            cp_t = make_cpml(pd, PML10, coefs_t, dev)
            k_h = event_ms(lambda: yee.update_h(pd, s_d, coefs_t, patch, cp_t, psi_d))
            k_e = event_ms(lambda: yee.update_e(pd, s_d, coefs_t, cp_t, psi_d))
            if fp32:
                ms[names[0]] = (k_h, event_ms(lambda: cp_t.plain_h(pd, s_d, coefs_t, psi_d, patch), reps=5))
                ms[names[1]] = (k_e, event_ms(lambda: cp_t.plain_e(pd, s_d, coefs_t, psi_d), reps=5))
            else:
                ms_bf16[names[0]], ms_bf16[names[1]] = k_h, k_e
            del coefs_t, cp_t
        del s_d
        for name, mats_t in (("yee_stream_pml", None), ("yee_stream_lossy_pml", water)):
            coefs_t = coefs_of(pd, mats_t)
            cp_t = make_cpml(pd, PML10, coefs_t, dev)
            plan_t = stream_plan.pick_plan(pd, lossy=coefs_t.lossy, pml=PML10)
            st, drive, _ = sweep_inputs(pd, arrays, plan_t.s)
            out = FieldState(*(torch.empty_like(t) for t in st.tensors()))
            psi_o = PsiState(*(torch.empty_like(t) for t in psi_d.tensors()))
            k_ms = event_ms(lambda: stream.sweep(pd, st, out, coefs_t, plan_t, drive, None, cp_t, psi_d, psi_o))
            time_interior(name, pd, plan_t, fp32, lambda pl: stream.sweep(pd, st, out, coefs_t, pl, drive, None,
                                                                              cp_t, psi_d, psi_o),
                          lambda box: stream.plain_sweep(pd, st, coefs_t, plan_t.s, drive, out, box=box))
            if fp32:
                plans[name] = plan_t
                ms[name] = (k_ms, event_ms(lambda: stream.plain_sweep(pd, st, coefs_t, plan_t.s, drive, out, None,
                                                                      cp_t, psi_d, psi_o), reps=5))
            else:
                ms_bf16[name] = k_ms
            del coefs_t, cp_t, st, out, psi_o
        del psi_d
        # Debye: the ADE E pass (with and without the SAR work) and the ADE
        # sweeps at the dispersive path's shapes
        dc_t, vac = dcs[dtype], update_coefs(pd)
        # the DFT variants (nf = 1) at the monitor path's plans, and dft_accum
        d1 = zero_dft_acc(pd, DFT1, dev)
        s_d = state_from_numpy(arrays, dev, field_dtype(pd))
        w1 = torch.tensor([[0.5], [0.25]], dtype=torch.float32, device=dev)
        k_ms = event_ms(lambda: dft_ops.accumulate_e(pd, s_d, w1, d1))
        if fp32:
            ms["dft_accum"] = (k_ms, event_ms(lambda: dft_ops.plain_accumulate_e(pd, s_d, w1, d1)))
        else:
            ms_bf16["dft_accum"] = k_ms
        del s_d
        for mats_t, sar, pml_t in ((None, False, None), (water, False, None), (water, True, None),
                                   (ferrite, False, None), (ferrite, True, None), (None, False, PML10),
                                   (water, False, PML10), (debye, False, None), (debye, True, None)):
            debye_t = mats_t is debye
            coefs_t = vac if debye_t else coefs_of(pd, mats_t)
            plan_t = stream_plan.pick_plan(pd, lossy=coefs_t.lossy, het=coefs_t.heterogeneous_mu, sar=sar, pml=pml_t,
                                           ade=debye_t, dft=DFT1)
            st, drive, _ = sweep_inputs(pd, arrays, plan_t.s)
            out = FieldState(*(torch.empty_like(t) for t in st.tensors()))
            cp_t = make_cpml(pd, pml_t, coefs_t, dev) if pml_t is not None else None
            psi_i = init_psi(pd, pml_t, dev) if pml_t is not None else None
            psi_o = init_psi(pd, pml_t, dev) if pml_t is not None else None
            pol_i = zero_polarization(pd, dev) if debye_t else None
            pol_o = zero_polarization(pd, dev) if debye_t else None
            acc = zero_power_acc(pd, dev) if sar else None
            wts = w1.reshape(1, 2, 1).expand(plan_t.s, 2, 1).contiguous()
            dc_x = dc_t if debye_t else None
            k_ms = event_ms(lambda: stream.sweep(pd, st, out, coefs_t, plan_t, drive, acc, cp_t, psi_i, psi_o, dc_x,
                                                 pol_i, pol_o, d1, wts))
            if pml_t is not None:
                time_interior(plan_t.kernel, pd, plan_t, fp32,
                              lambda pl: stream.sweep(pd, st, out, coefs_t, pl, drive, acc, cp_t, psi_i, psi_o, dacc=d1,
                                                      wts=wts),
                              lambda box: stream.plain_sweep(pd, st, coefs_t, plan_t.s, drive, out, wts=wts, box=box,
                                                             dacc=tuple(torch.zeros((1, 3) + box.cell_shape(pd),
                                                                                    device=dev) for _ in range(2))))
            if fp32:
                plans[plan_t.kernel] = plan_t
                ms[plan_t.kernel] = (k_ms, event_ms(lambda: stream.plain_sweep(
                    pd, st, coefs_t, plan_t.s, drive, out, acc, cp_t, psi_i, psi_o, dc_x, pol_i, pol_o, d1, wts), reps=3))
            else:
                ms_bf16[plan_t.kernel] = k_ms
            del st, out, cp_t, psi_i, psi_o, pol_i, pol_o, acc
        del d1
        s_d = state_from_numpy(arrays, dev, field_dtype(pd))
        pol_d, w_d = zero_polarization(pd, dev), zero_work(pd, dev)
        for name, w_t in (("yee_update_e_ade", None), ("yee_update_e_ade_sar", w_d)):
            k_ms = event_ms(lambda: yee.update_e_ade(pd, s_d, pol_d, dc_t, w_t))
            if fp32:
                ms[name] = (k_ms, event_ms(lambda: update_e_ade(pd, s_d, pol_d, dc_t, w_t)))
            else:
                ms_bf16[name] = k_ms
        if fp32:
            ade_extra["sar_increment"] = event_ms(lambda: diagnostics.accumulate_work(pd, w_d, zero_power_acc(pd, dev)))
        del s_d, w_d
        for name, sar in (("yee_stream_ade", False), ("yee_stream_ade_sar", True)):
            plan_t = stream_plan.pick_plan(pd, sar=sar, ade=True)
            st, drive, _ = sweep_inputs(pd, arrays, plan_t.s)
            out = FieldState(*(torch.empty_like(t) for t in st.tensors()))
            pol_o = PolState(*(torch.empty_like(t) for t in pol_d.tensors()))
            acc = zero_power_acc(pd, dev) if sar else None
            k_ms = event_ms(lambda: stream.sweep(pd, st, out, vac, plan_t, drive, acc, dc=dc_t, pol=pol_d,
                                                 pol_out=pol_o))
            if fp32:
                plans[name] = plan_t
                ms[name] = (k_ms, event_ms(lambda: stream.plain_sweep(pd, st, vac, plan_t.s, drive, out, acc, dc=dc_t,
                                                                      pol=pol_d, pol_out=pol_o), reps=5))
            else:
                ms_bf16[name] = k_ms
            del st, out, pol_o, acc
        del dc_t, pol_d
    del arrays
    print(f"timing 256^3 the Debye SAR increment (torch ops after each twopass step): "
          f"{ade_extra['sar_increment']!r} ms fp32; the Debye maps' set-up (debye_coefs, host fp64): "
          f"{debye_build_s!r} s (phase 3) ({smi})")
    for name, (k_ms, p_ms) in ms.items():
        per = f" per sweep of {plans[name].s} steps" if name in plans else " per pass"
        print(f"timing 256^3 {name}: kernel fp32 {k_ms!r} ms, bf16 {ms_bf16[name]!r} ms, "
              f"plain fp32 {p_ms!r} ms{per} ({smi})")
    # every plan the picker ranks, in both dtypes (the picker's choice above)
    st, drive, plan = sweep_inputs(p, {c: rng.uniform(-1.0, 1.0, p.padded_shape).astype(np.float32)
                                       for c in COMPONENTS}, main_plan.s)
    coefs = update_coefs(p)
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
    del st

    # least time for the same work: each input read once, each output
    # written once (bytes), or the flops at the fp32 peak, whichever is larger
    cells = math.prod(p.padded_shape)
    cells_k = p.maxk * p.maxj * p.maxi

    # psi cells of the H and E terms at --pml 10 (each read once and written
    # once per pass or sweep; 5 operations each: the recursion and the add)
    shapes10 = psi_shapes(p, PML10)
    psi_h = sum(math.prod(shapes10[t]) for t in cpml.H_TERMS)
    psi_e = sum(math.prod(shapes10[t]) for t in cpml.E_TERMS)

    def work(name: str, item: int) -> tuple[float, float]:
        """(bytes, flops) of one pass or sweep of kernel ``name`` with
        ``item``-byte fields and coefficients (the SAR map is fp32), with
        CPML the psi of its terms read and written once; the DFT variants
        (nf = 1) add the six fp32 sums of a cell read and written once and,
        each step, the three 4-edge means and the four operations a
        component (24 a cell)."""
        if name.endswith("_batch"):  # the sweep's members, each a whole-grid pass
            b, f = work(name.removesuffix("_batch"), item)
            return SWEEP_MEMBERS * b, SWEEP_MEMBERS * f
        if name in shard_work:  # a middle slab of --shard 4: what it reads, the owned window out; sigma, the map
            vals_in, vals_out, ops_n, sar_cells = shard_work[name]
            return (vals_in + vals_out) * item + sar_cells * (item + 8) + shard_sums.get(name, 0), ops_n
        if name == "dft_accum":  # three E in, the six sums in and out
            return 3 * item * cells + 48 * cells_k, 24 * cells_k
        if name.endswith(stream.INTERIOR):  # the K3 sweep of a CPML sweep's interior window
            core = plans[name].core
            v = math.prod(core.window)
            c_in = math.prod(min(o + w, t) - o for o, w, t in zip(core.origin, core.window, (p.maxk, p.maxj, p.maxi)))
            lossy_i, dft_i = "lossy" in name, "_dft" in name
            return ((12 + (6 if lossy_i else 0)) * item * v + (48 * c_in if dft_i else 0),
                    core.s * (v * (15 + (18 if lossy_i else 15)) + (24 * c_in if dft_i else 0)))
        if name.endswith("_dft"):
            b, f = work(name[:-4], item)
            return b + 48 * cells_k, f + plans[name].s * 24 * cells_k
        lossy, het, sar, pml = "lossy" in name, "het" in name, name.endswith("sar"), name.endswith("pml")
        if name.startswith("yee_update_e_ade"):  # H, E, P and 15 maps in, E and P out; SAR: 3 sigma in, 3 fp32 w out
            return ((30 + (3 if sar else 0)) * item * cells + (12 * cells if sar else 0),
                    (36 + (21 if sar else 0)) * cells)
        if name.startswith("yee_stream_ade"):  # fields and P in and out, 15 maps; SAR: 3 sigma, the map in and out
            s_n = plans.get(name, plans.get(name + "_dft")).s
            return ((33 + (3 if sar else 0)) * item * cells + (8 * cells_k if sar else 0),
                    s_n * (51 * cells + (21 * cells + 19 * cells_k if sar else 0)))
        if name.startswith("yee_update_h"):  # six fields and hf in, three H out
            return ((9 + (3 if het else 0)) * item * cells + (2 * item * psi_h if pml else 0),
                    15 * cells + (5 * psi_h if pml else 0))
        if name.startswith("yee_update_e"):  # six fields and ca/cb in, three E out
            return ((9 + (6 if lossy else 0)) * item * cells + (2 * item * psi_e if pml else 0),
                    (18 if lossy else 15) * cells + (5 * psi_e if pml else 0))
        s_n = plans.get(name, plans.get(name + "_dft")).s  # fields in and out, coefficients, sigma, the map in and out
        b = (12 + (6 if lossy else 0) + (3 if het else 0)) * item * cells + ((item + 8) * cells_k if sar else 0)
        b += 2 * item * (psi_h + psi_e) if pml else 0
        return b, s_n * (cells * (15 + (18 if lossy else 15)) + (20 * cells_k if sar else 0)
                         + (5 * (psi_h + psi_e) if pml else 0))

    kernels = []
    bound16: dict[str, float] = {}  # each kernel's bf16 bound
    for name in ("yee_update_h", "yee_update_e", "yee_stream", "yee_update_h_het", "yee_update_e_lossy",
                 "yee_stream_lossy", "yee_stream_lossy_sar", "yee_stream_lossy_het", "yee_stream_lossy_het_sar",
                 "yee_update_h_pml", "yee_update_e_pml", "yee_update_h_het_pml", "yee_update_e_lossy_pml",
                 "yee_stream_pml", "yee_stream_pml_interior", "yee_stream_lossy_pml", "yee_stream_lossy_pml_interior",
                 "yee_update_e_ade", "yee_update_e_ade_sar",
                 "yee_stream_ade", "yee_stream_ade_sar", "dft_accum", "yee_stream_dft", "yee_stream_lossy_dft",
                 "yee_stream_lossy_sar_dft", "yee_stream_lossy_het_dft", "yee_stream_lossy_het_sar_dft",
                 "yee_stream_pml_dft", "yee_stream_pml_dft_interior", "yee_stream_lossy_pml_dft",
                 "yee_stream_lossy_pml_dft_interior", "yee_stream_ade_dft", "yee_stream_ade_sar_dft",
                 "yee_update_h_shard", "yee_update_e_shard", "yee_stream_shard", "yee_update_h_het_shard",
                 "yee_update_e_lossy_shard", "yee_stream_lossy_shard", "yee_stream_lossy_sar_shard",
                 "yee_stream_lossy_het_shard", "yee_stream_lossy_het_sar_shard", "yee_update_h_pml_shard",
                 "yee_update_e_pml_shard", "yee_update_h_het_pml_shard", "yee_update_e_lossy_pml_shard",
                 "dft_accum_shard", "yee_stream_dft_shard", "yee_stream_lossy_dft_shard",
                 "yee_stream_lossy_sar_dft_shard", "yee_stream_lossy_het_dft_shard",
                 "yee_stream_lossy_het_sar_dft_shard", "yee_update_h_batch", "yee_update_e_batch"):
        bound = {}
        for dtype, item in (("fp32", 4), ("bf16", 2)):
            bytes_n, flops_n = work(name, item)
            t_bytes, t_ops = bytes_n / HBM_BYTES_PER_S * 1e3, flops_n / FP32_FLOPS * 1e3
            bound[dtype] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", bytes_n / cells)
        print(f"bound 256^3 {name}: fp32 {bound['fp32'][0]!r} ms ({bound['fp32'][2]!r} B per padded cell, "
              f"{bound['fp32'][1]}), bf16 {bound['bf16'][0]!r} ms ({bound['bf16'][2]!r} B, {bound['bf16'][1]}); "
              f"launches {main_counts[name]} on {paths[name]}")
        bound16[name] = bound["bf16"][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fdtd_tpu_torch/csrc/" + ("dft_accum.cu" if name.startswith("dft_accum") else
                                                "yee_stream.cu" if "stream" in name else "yee_twopass.cu"),
            "replaces": ("fdtd_tpu/ops/pallas_stream.py:1538" if name.startswith("yee_stream") and
                         name.endswith("_shard") else
                         "fdtd_tpu/parallel/sharded_pml_fast.py:341" if name.endswith("_pml_shard") else
                         "fdtd_tpu/ops/pallas_stream.py:1225" if name.startswith("dft_accum") else
                         "fdtd_tpu/ops/pallas_dispersive.py:182" if name.startswith("yee_update_e_ade") else
                         "fdtd_tpu/ops/pallas_dispersive.py:464" if name.startswith("yee_stream_ade") else
                         "fdtd_tpu/ops/pallas_stream_pml.py:329" if name.startswith("yee_stream") and
                         name.removesuffix(stream.INTERIOR).removesuffix("_dft").endswith("pml") else
                         "fdtd_tpu/ops/cpml_kernel.py:229" if name.startswith("yee_update_h") and
                         name.endswith("pml") else
                         "fdtd_tpu/ops/cpml_kernel.py:417" if name.endswith("pml") else
                         "fdtd_tpu/ops/pallas_stream.py:207" if "stream" in name else
                         "fdtd_tpu/ops/pallas_fused.py:332" if "_h" in name else
                         "fdtd_tpu/ops/pallas_fused.py:412"),
            "launches": main_counts[name], "max_abs_err": max_err[name],
            "ms": ms[name][0], "plain_ms": ms[name][1],
            "bound_ms": bound["fp32"][0], "bound_by": bound["fp32"][1],
            "library_ms": None, "path": paths[name],
        })
    # the redesigned sweeps (ring_kernel): each beside its first design's
    # time a step, with registers and spills from the build's ptxas report
    from fdtd_tpu_torch import tune_stream
    regs = tune_stream.ptxas_report(lib_paths[1].with_suffix(".log").read_text())
    for entry in kernels:
        name = entry["name"]
        if name not in FIRST_SWEEPS:
            continue
        box = name.endswith("_shard")
        pl = plans[name.removesuffix("_shard")]
        flags = (pl.s, pl.bj, pl.cr, pl.lossy, pl.het, pl.sar, pl.ade, pl.dft, box)
        r32, r16 = regs.get(("float32",) + flags, (None, None)), regs.get(("bfloat16",) + flags, (None, None))
        s8, ms8 = FIRST_SWEEPS[name]
        grid = "a middle slab" if box else f"{pl.blocks} blocks ({pl.blocks / stream_plan.SM_COUNT!r} waves)"
        print(f"redesign 256^3 {name}: ring_kernel s={pl.s} bj={pl.bj} coefficient ring {int(pl.cr)}, {grid}: fp32 "
              f"{entry['ms']!r} ms a sweep, {entry['ms'] / pl.s!r} a step (first design {ms8 / s8!r} a step at s={s8}: "
              f"x{(ms8 / s8) / (entry['ms'] / pl.s)!r}), bf16 {ms_bf16[name]!r} ms a sweep; bound share "
              f"{entry['bound_ms'] / entry['ms']!r}; registers {r32[0]} / {r16[0]}, spill stores {r32[1]} / {r16[1]} B "
              f"(fp32 / bf16) ({smi})")
    for key, first in FIRST_RATES.items():
        print(f"rate 1000 steps {key}: {main_rates[key]!r} Mcells/s (first design {first!r}: "
              f"x{main_rates[key] / first!r}) ({smi})")
    for tag in ("", " bf16"):
        for dft_tag in ("", " --dft 2.45e10"):
            st_r, tp_r = (main_rates[f"bench_256 --pml 10{tag}{dft_tag} {b}"] for b in ("stream", "twopass"))
            print(f"rate 1000 steps bench_256 --pml 10{tag}{dft_tag}: stream {st_r!r}, twopass {tp_r!r} Mcells/s "
                  f"(x{st_r / tp_r!r}) ({smi})")

    if sass_proc is not None:
        out_s, _ = sass_proc.communicate()
        verdict_path = os.path.join(sass_dir.name, "sass.json")
        verdicts = json.loads(open(verdict_path).read()) if os.path.exists(verdict_path) else {}
        # the parent's fold (dft_fold_kernel) is redesigned: a template of its shape here
        replaced = {k for k in verdicts if k.startswith("dft_accum: ") and "dft_fold_kernel" in k}
        kept = {k: v for k, v in verdicts.items() if k not in replaced}
        changed = sorted(k for k, v in kept.items() if v != "same")
        for line in out_s.strip().splitlines():
            if line.startswith("{"):
                print(f"sass_compare vs {PARENT}: {line}")
        for k in sorted(kept):
            print(f"sass_compare vs {PARENT}: kept its machine code: {k}" if kept[k] == "same" else
                  f"sass_compare vs {PARENT}: {kept[k]}: {k}")
        check(bool(kept) and not changed and len(replaced) == 1,
              f"sass_compare vs {PARENT}: {len(kept)} kernels keep their machine code (changed: {changed}); "
              f"the fold redesigned: {sorted(replaced)}")
    else:
        print(f"sass_compare vs {PARENT}: not run (no git history and no scratch_chip/parent checkout)")
    sass_dir.cleanup()

    print(json.dumps({"kernels": kernels + means_rows + sar_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
