"""Time the ADE sweep (K12, Debye media) at candidate block shapes on the
card, beside ptxas's registers and spills: the measurement behind the one
shape each ADE variant is built at (``ops/stream_plan.py::BLOCK_J_ADE``,
``BLOCK_J_ADE_SAR``); with ``--dft``, the same for the sweeps' DFT bands.

    python -m fdtd_tpu_torch.tune_ade [--n 256] [--reps 20] [--dtypes float32 bfloat16] [--dft]

It builds ``csrc/yee_stream.cu`` a second time with
``YEE_STREAM_ADE_CANDIDATES`` defined (the ADE variants at every shape of
:data:`CANDIDATES`), checks each shape against ``stream.plain_sweep`` once
on a small ragged box (fields, P and the SAR map, bit for bit), and times
one sweep of the dispersive scene (``profile_chunk.scene``: the heating
box rescaled to n, its default water block as a Debye medium) with CUDA
events, the mean of ``--reps`` launches after one.  One JSON line per
dtype, SAR and shape: ms per sweep and per step, the plan's modelled bytes
per cell and step, registers and spill-store bytes, the check's max
|diff|, and the card's name and power limit.  Exits 1 when a check fails
or no CUDA device is available.

With ``--dft`` it times the DFT variants instead (nf = 1 at 2.45e10 Hz,
from random starting sums): the vacuum and heating (water block + SAR)
sweeps at the shapes of :data:`DFT_CANDIDATES` (a build with
``YEE_STREAM_DFT_CANDIDATES``), and every scene's DFT variant at its built
shape, also without the bands, for the bands' cost.  Every timed variant is
checked against ``plain_sweep`` on the small box first.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import numpy as np
import torch

from .convert import state_from_numpy
from .grid import COMPONENTS
from .dft import DftConfig
from .ops import build, stream, stream_plan
from .ops.cpml import PMLConfig, PsiState, make_cpml, psi_shapes
from .ops.dispersive import PolState, debye_coefs, water_debye_load
from .params import Mode, Params
from .profile_chunk import scene
from .source import apply_source, make_source_plan, profile_tensor, sweep_drive_rows
from .state import FieldState, field_dtype, update_coefs, water_block

DEFINE = "YEE_STREAM_ADE_CANDIDATES"
DFT_DEFINE = "YEE_STREAM_DFT_CANDIDATES"
# (steps per sweep, threads along j); the candidate cases of csrc/yee_stream.cu
CANDIDATES = ((8, 24), (4, 16), (4, 24), (4, 32), (2, 24), (2, 32))
DFT_CANDIDATES = ((8, 24), (4, 16), (4, 24), (4, 32), (2, 32))
# the DFT scenes: (lossy, sar, pml, ade)
DFT_SCENES = {"vacuum": (False, False, False, False), "heating": (True, True, False, False),
              "pml": (False, False, True, False), "dispersive": (False, False, False, True),
              "dispersive_sar": (False, True, False, True)}
DFT_FREQUENCY = 2.45e10
# a mangled stream_kernel<T, S, BJ, LOSSY, HET, SAR, PML, ADE[, DFT]> entry
_ENTRY = re.compile(r"stream_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])ELb([01])ELb([01])ELb([01])ELb([01])E"
                    r"(?:Lb([01])E)?")


def ptxas_report(log: str, dft: bool = False) -> dict[tuple, tuple[int, int]]:
    """(dtype, sar, s, bj) -> (registers, spill-store bytes) of the ADE
    sweep instantiations in an ``nvcc -Xptxas -v`` log; with ``dft``,
    (dtype, lossy, het, sar, pml, ade, s, bj) -> the same for the DFT
    variants."""
    out: dict[tuple, tuple[int, int]] = {}
    key, spill = None, 0
    for line in log.splitlines():
        m = _ENTRY.search(line) if "Compiling entry function" in line else None
        if m is not None:
            ade, has_dft = m.group(8) == "1", m.group(9) == "1"
            dtype = "float32" if m.group(1) == "f" else "bfloat16"
            if dft:
                key = ((dtype, *(g == "1" for g in m.group(4, 5, 6, 7, 8)), int(m.group(2)), int(m.group(3)))
                       if has_dft else None)
            else:
                key = (dtype, m.group(6) == "1", int(m.group(2)), int(m.group(3))) if ade and not has_dft else None
            spill = 0
        elif key is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif key is not None and "registers" in line:
            out[key] = (int(re.search(r"Used (\d+) registers", line).group(1)), spill)
            key = None
    return out


def _setup(p: Params, dm, s: int, bj: int, sar: bool, dev: torch.device, rng: np.random.Generator):
    """The plan, maps and inputs of one ADE sweep: random fields with step 1
    hard-set by the source, random P where the load relaxes (k2 > 0), the
    drive of steps 2..s and, with SAR, a random map."""
    dt = field_dtype(p)
    dc = debye_coefs(p, dm, dev)
    plan = stream_plan.plan_for(p, s, sar=sar, ade=True, bj=bj)
    st = state_from_numpy({c: rng.uniform(-1.0, 1.0, p.padded_shape) for c in COMPONENTS}, dev, dt)
    src = make_source_plan(p)
    amps = torch.tensor(rng.uniform(-1.0, 1.0, s), dtype=torch.float64, device=dev)
    prof = profile_tensor(src, dev)
    apply_source(src, st, amps[0], prof)
    ez_rows, hx_rows = sweep_drive_rows(src, amps, s, dt, prof)
    drive = stream.SweepDrive(src.patch, ez_rows[0], hx_rows[0])
    pol = PolState(*(torch.where(dc.k2[c] > 0, torch.tensor(rng.uniform(-1e-9, 1e-9, p.padded_shape), dtype=dt,
                                                            device=dev), 0.0) for c in "xyz"))
    acc = (torch.tensor(rng.uniform(0.0, 1e-11, (p.maxk, p.maxj, p.maxi)), dtype=torch.float32, device=dev)
           if sar else None)
    return plan, dc, st, drive, pol, acc


def check(p: Params, dm, s: int, bj: int, sar: bool, dev: torch.device, rng: np.random.Generator) -> float:
    """max |kernel - plain_sweep| over the fields, P and the SAR map."""
    plan, dc, st, drive, pol, acc = _setup(p, dm, s, bj, sar, dev, rng)
    vac = update_coefs(p)
    out = FieldState(*(torch.full_like(t, float("nan")) for t in st.tensors()))
    pol_out = PolState(*(torch.full_like(t, float("nan")) for t in pol.tensors()))
    acc_p = acc.clone() if sar else None
    stream.sweep(p, st, out, vac, plan, drive, acc, dc=dc, pol=pol, pol_out=pol_out)
    want_pol = PolState(*(torch.empty_like(t) for t in pol.tensors()))
    want = stream.plain_sweep(p, st, vac, s, drive, None, acc_p, dc=dc, pol=pol, pol_out=want_pol)
    torch.cuda.synchronize(dev)
    got = out.tensors() + pol_out.tensors() + ((acc,) if sar else ())
    ref = want.tensors() + want_pol.tensors() + ((acc_p,) if sar else ())
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))


def time_sweep(p: Params, dm, s: int, bj: int, sar: bool, dev: torch.device, rng: np.random.Generator,
               reps: int) -> tuple[float, stream_plan.StreamPlan]:
    """ms per sweep (CUDA events, mean of ``reps`` after one) and the plan."""
    plan, dc, st, drive, pol, acc = _setup(p, dm, s, bj, sar, dev, rng)
    vac = update_coefs(p)
    out = FieldState(*(torch.empty_like(t) for t in st.tensors()))
    pol_out = PolState(*(torch.empty_like(t) for t in pol.tensors()))

    def run() -> None:
        stream.sweep(p, st, out, vac, plan, drive, acc, dc=dc, pol=pol, pol_out=pol_out)

    run()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, plan


def dft_sweep(p: Params, scene_name: str, s: int | None, bj: int | None, dev: torch.device,
              rng: np.random.Generator, dft: bool = True):
    """``(plan, run_kernel, run_plain)`` of one sweep of a DFT scene
    (:data:`DFT_SCENES`) on the grid of ``p`` from random fields, psi, P,
    SAR map and sums (``dft=False``: the same variant without the bands).
    ``run_kernel()`` and ``run_plain()`` return the arrays they wrote."""
    lossy, sar, pml_on, ade = DFT_SCENES[scene_name]
    dt = field_dtype(p)
    cfg = DftConfig((DFT_FREQUENCY,))
    pml = PMLConfig(cells=10 if min(p.maxk, p.maxj, p.maxi) > 40 else 6) if pml_on else None
    dm = (water_debye_load(p, lo=(0.05,) * 3, hi=(0.95,) * 3, sigma_ion25=0.5) if min(p.maxk, p.maxj, p.maxi) < 100
          else water_debye_load(p)) if ade else None
    dc = debye_coefs(p, dm, dev) if ade else None
    coefs = update_coefs(p, water_block(p) if lossy else None, dev)
    s = s or stream_plan.pick_plan(p, lossy=lossy, sar=sar, pml=pml, ade=ade, dft=cfg if dft else None).s
    plan = stream_plan.plan_for(p, s, lossy, sar=sar, pml=pml, ade=ade, bj=bj, dft=cfg if dft else None)
    st = state_from_numpy({c: rng.uniform(-1.0, 1.0, p.padded_shape).astype(np.float32) for c in COMPONENTS}, dev, dt)
    src = make_source_plan(p)
    amps = torch.tensor(rng.uniform(-1.0, 1.0, s), dtype=torch.float64, device=dev)
    prof = profile_tensor(src, dev)
    apply_source(src, st, amps[0], prof)
    ez_rows, hx_rows = sweep_drive_rows(src, amps, s, dt, prof)
    drive = stream.SweepDrive(src.patch, ez_rows[0], hx_rows[0])
    cp = make_cpml(p, pml, coefs, dev) if pml else None
    psi = (PsiState(**{n: torch.tensor(rng.uniform(-1e-2, 1e-2, sh), dtype=dt, device=dev)
                       for n, sh in psi_shapes(p, pml).items()}) if pml else None)
    pol = (PolState(*(torch.where(dc.k2[c] > 0, torch.tensor(rng.uniform(-1e-9, 1e-9, p.padded_shape), dtype=dt,
                                                             device=dev), 0.0) for c in "xyz")) if ade else None)
    acc0 = (torch.tensor(rng.uniform(0.0, 1e-11, (p.maxk, p.maxj, p.maxi)), dtype=torch.float32, device=dev)
            if sar else None)
    shape = (1, 3, p.maxk, p.maxj, p.maxi)
    d0 = tuple(torch.tensor(rng.uniform(-1.0, 1.0, shape), dtype=torch.float32, device=dev) for _ in range(2))
    wts = torch.tensor(rng.uniform(-1.0, 1.0, (s, 2, 1)), dtype=torch.float32, device=dev) if dft else None

    def fresh():
        return (FieldState(*(torch.empty_like(t) for t in st.tensors())),
                PsiState(*(torch.empty_like(t) for t in psi.tensors())) if pml else None,
                PolState(*(torch.empty_like(t) for t in pol.tensors())) if ade else None,
                acc0.clone() if sar else None, tuple(t.clone() for t in d0) if dft else None)

    k_out = fresh()
    p_out = fresh()

    def run_kernel():
        out, psi_o, pol_o, acc, dacc = k_out
        stream.sweep(p, st, out, coefs, plan, drive, acc, cp, psi, psi_o, dc, pol, pol_o, dacc, wts)
        return _arrays(k_out)

    def run_plain():
        out, psi_o, pol_o, acc, dacc = p_out
        stream.plain_sweep(p, st, coefs, s, drive, out, acc, cp, psi, psi_o, dc, pol, pol_o, dacc, wts)
        return _arrays(p_out)

    return plan, run_kernel, run_plain


def _arrays(outs) -> list[torch.Tensor]:
    out, psi_o, pol_o, acc, dacc = outs
    return (list(out.tensors()) + (list(psi_o.tensors()) if psi_o else []) + (list(pol_o.tensors()) if pol_o else [])
            + ([acc] if acc is not None else []) + (list(dacc) if dacc else []))


def _event_ms(fn, reps: int) -> float:
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main_dft(args, dev: torch.device, card: str) -> int:
    """The ``--dft`` measurements (see the module docstring)."""
    path = build.build(stream.KERNEL_SOURCE, defines=(DFT_DEFINE,))
    regs = ptxas_report(path.with_suffix(".log").read_text(), dft=True)
    stream.use_library(path)
    rng = np.random.default_rng(0)
    ok = True
    runs = [(sc, s, bj) for sc in ("vacuum", "heating") for s, bj in DFT_CANDIDATES]
    runs += [(sc, None, None) for sc in DFT_SCENES]
    for dtype in args.dtypes:
        small = Params(length=0.0615, width=0.0505, height=0.0705, spatial_step=0.001, time_step=1e-12,
                       simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype=dtype)
        big = scene(args.n, dtype)
        for sc, s, bj in runs:
            plan, k, pl = dft_sweep(small, sc, s, bj, dev, rng)
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(k(), pl()))
            ok = ok and err == 0.0
            plan, k, _ = dft_sweep(big, sc, plan.s, plan.bj, dev, rng)
            ms = _event_ms(k, args.reps)
            base_plan, base_k, _ = dft_sweep(big, sc, None, None, dev, rng, dft=False)
            base_ms = _event_ms(base_k, args.reps) if s is None else None
            key = (dtype, plan.lossy, plan.het, plan.sar, plan.pml, plan.ade, plan.s, plan.bj)
            reg, spill = regs.get(key, (None, None))
            print(json.dumps({
                "kernel": plan.kernel, "dtype": dtype, "n": args.n, "s": plan.s, "bj": plan.bj,
                "threads": plan.threads, "tile": [plan.tk, plan.tj, plan.ti], "blocks": plan.blocks,
                "ms_per_sweep": ms, "ms_per_step": ms / plan.s, "without_bands": None if base_ms is None else {
                    "kernel": base_plan.kernel, "s": base_plan.s, "ms_per_step": base_ms / base_plan.s},
                "modelled_bytes_per_cell_step": plan.bytes_per_cell_step, "registers": reg,
                "spill_store_bytes": spill, "max_abs_err": err, "card": card,
            }), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fdtd_tpu_torch.tune_ade", description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256, help="cells per side of the timed scene (default 256)")
    ap.add_argument("--reps", type=int, default=20, help="timed sweeps per shape (default 20)")
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--dft", action="store_true", help="time the sweeps' DFT bands instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: tune_ade measures a CUDA device and none is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    if args.dft:
        return main_dft(args, dev, card)
    path = build.build(stream.KERNEL_SOURCE, defines=(DEFINE,))
    regs = ptxas_report(path.with_suffix(".log").read_text())
    stream.use_library(path)
    rng = np.random.default_rng(0)
    ok = True
    for dtype in args.dtypes:
        small = Params(length=0.0615, width=0.0505, height=0.0705, spatial_step=0.001, time_step=1e-12,
                       simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype=dtype)
        dm_small = water_debye_load(small, lo=(0.05,) * 3, hi=(0.95,) * 3, sigma_ion25=0.5)
        big = scene(args.n, dtype)
        dm_big = water_debye_load(big)
        for sar in (False, True):
            for s, bj in CANDIDATES:
                err = check(small, dm_small, s, bj, sar, dev, rng)
                ms, plan = time_sweep(big, dm_big, s, bj, sar, dev, rng, args.reps)
                ok = ok and err == 0.0
                reg, spill = regs.get((dtype, sar, s, bj), (None, None))
                print(json.dumps({
                    "kernel": plan.kernel, "dtype": dtype, "n": args.n, "s": s, "bj": bj, "threads": plan.threads,
                    "tile": [plan.tk, plan.tj, plan.ti], "blocks": plan.blocks, "ms_per_sweep": ms,
                    "ms_per_step": ms / s, "modelled_bytes_per_cell_step": plan.bytes_per_cell_step,
                    "registers": reg, "spill_store_bytes": spill, "max_abs_err": err, "card": card,
                }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
