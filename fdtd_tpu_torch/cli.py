"""Command-line entry point: ``python -m fdtd_tpu_torch params.txt``.

Mirrors ``python -m fdtd_tpu params.txt`` (and the reference's
``./microwave params.txt``, main.c:807-853): the same banner lines, the same
single positional argument, the same exit codes on a missing or bad
parameters file, and the JAX CLI's load flags (``--water-block``,
``--ferrite-slab``, ``--load-shape``, ``--load-center``), ``--sar``,
which writes ``sar.vtr``, ``--pml N``, the CPML open boundary, and
``--dispersive`` (with ``--salt-sigma`` and ``--thermal-ambient``), which
makes the water load a Debye medium.  ``--device`` chooses where the fields live
(default ``cuda``); without CUDA the run stops with a message that names
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

from . import grid
from .io.vtr import write_vtr
from .ops.cpml import PMLConfig
from .ops.dispersive import water_debye_load
from .params import Mode, load_parameters
from .runner import BACKEND_CHOICES, run_simulation
from .state import block_mask, cylinder_mask, ferrite_slab, sphere_mask, water_from_mask


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fdtd_tpu_torch",
        description="FDTD microwave-oven simulator on PyTorch/CUDA (params.txt compatible)",
    )
    ap.add_argument("params", help="parameters file (.txt), 8 ordered scalars")
    ap.add_argument("--out", default="r", help="output directory (default: r, like the reference)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64", "bfloat16"])
    ap.add_argument("--backend", default="auto", choices=list(BACKEND_CHOICES),
                    help="update path: stream (Hopper streaming kernel, s steps a launch), "
                         "twopass (Hopper two-pass kernels), torch (plain ops), or auto "
                         "(stream on CUDA in float32/bfloat16 when a sweep plan fits and "
                         "there is no --pml, else twopass; torch on the CPU, in float64, and for "
                         "--dispersive with --pml or in validation mode)")
    ap.add_argument("--device", default="cuda", help="torch device of the fields (default: cuda)")
    ap.add_argument("--no-output", action="store_true", help="skip snapshots (benchmark mode)")
    ap.add_argument("--water-block", action="store_true", help="place a water load in the cavity")
    ap.add_argument("--ferrite-slab", action="store_true",
                    help="add a mu_r=4 ferrite shelf (heterogeneous mu; composes with --water-block)")
    ap.add_argument("--sar", action="store_true",
                    help="accumulate power deposition (J/m^3) and write sar.vtr")
    ap.add_argument("--load-shape", default="box", choices=["box", "sphere", "cylinder"],
                    help="geometry of the --water-block load: the default 0.3-0.7 box, a "
                         "centered sphere, or a z-axis cylinder (the mug)")
    ap.add_argument("--load-center", default=None, metavar="X,Y",
                    help="(x, y) center of the load as box fractions (default 0.5,0.5)")
    ap.add_argument("--dispersive", action="store_true",
                    help="make the --water-block load a true single-pole Debye medium solved by the ADE "
                         "method (frequency-dependent eps(w) in the time domain); --sar then maps its "
                         "dielectric and ionic work")
    ap.add_argument("--salt-sigma", type=float, default=0.0, metavar="S_M",
                    help="ionic conductivity of the --dispersive load at 25 C in S/m (default 0 = pure water)")
    ap.add_argument("--thermal-ambient", type=float, default=20.0, metavar="C",
                    help="temperature of the --dispersive load (default 20 C); the thermal solve that "
                         "also reads it is not ported")
    ap.add_argument("--pml", type=int, default=0, metavar="N",
                    help="CPML absorbing boundaries, N cells per face (0 = closed PEC cavity "
                         "like the reference); the energy log adds radiated_W")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N", help="checkpoint every N steps")
    ap.add_argument("--resume", action="store_true", help="resume from latest checkpoint in --out")
    ap.add_argument("--diag-log", default=None, help="JSONL per-sample energy log path")
    ap.add_argument("--physics-correct", action="store_true",
                    help="disable reference-quirk compatibility in exported validation vars")
    ap.add_argument("--source-frequency", type=float, default=None, metavar="HZ",
                    help="magnetron drive frequency (reference hardcodes 2.45e10, main.c:735)")
    ap.add_argument("--source-aprime", type=float, default=None, metavar="M",
                    help="source patch width a' (reference hardcodes 0.005, main.c:720)")
    ap.add_argument("--source-bprime", type=float, default=None, metavar="M",
                    help="source patch depth b' (reference hardcodes 0.005, main.c:721)")
    ap.add_argument("--source-envelope", default=None, choices=["cw", "gaussian"],
                    help="drive envelope: cw (reference behavior) or a gaussian-modulated burst")
    ap.add_argument("--source-pulse-width", type=float, default=None, metavar="S",
                    help="gaussian envelope sigma in seconds (default: 2 carrier periods)")
    ap.add_argument("--source-pulse-delay", type=float, default=None, metavar="S",
                    help="gaussian envelope center in seconds (default: 3 widths)")
    return ap


def _parse_load_center(spec: str | None) -> tuple[float, float]:
    """(x, y) load center as box fractions from --load-center (default
    centered); raises ValueError on a malformed spec."""
    if not spec:
        return (0.5, 0.5)
    parts = spec.split(",")
    if len(parts) != 2:
        raise ValueError(f"--load-center wants X,Y fractions, got {spec!r}")
    cx, cy = (float(v) for v in parts)
    if not (0.0 < cx < 1.0 and 0.0 < cy < 1.0):
        raise ValueError("--load-center fractions must be in (0, 1)")
    return (cx, cy)


def _materials(args, p):
    """The scene's materials from the load flags (None for vacuum; a Debye
    medium with ``--dispersive``); raises ValueError on flags that do not
    compose."""
    materials = mask = None
    if args.dispersive and (not args.water_block or args.ferrite_slab):
        raise ValueError("--dispersive needs --water-block (and no --ferrite-slab): it is the Debye "
                         "description of the water load")
    if args.water_block:
        cx, cy = _parse_load_center(args.load_center)
        ox, oy = cx - 0.5, cy - 0.5  # offset from the centered defaults
        if args.load_shape == "sphere":
            mask = sphere_mask(p, center=(cx, cy, 0.5))
        elif args.load_shape == "cylinder":
            mask = cylinder_mask(p, center=(cx, cy))
        else:
            mask = block_mask(p, lo=(0.3 + ox, 0.3 + oy, 0.3), hi=(0.7 + ox, 0.7 + oy, 0.7))
        materials = water_from_mask(p, mask)
    elif args.load_shape != "box" or args.load_center:
        raise ValueError("--load-shape/--load-center need --water-block (they place the water load)")
    if args.dispersive:
        return water_debye_load(p, temperature=args.thermal_ambient, sigma_ion25=args.salt_sigma, mask=mask)
    if args.ferrite_slab:
        materials = ferrite_slab(p, base=materials)
    return materials


def main(argv=None) -> int:
    print("Welcome into our microwave oven eletrico-magnetic field simulator! \n", end="")
    args = build_arg_parser().parse_args(argv)
    print("Loading the parameters...")
    src_kw = {
        name: getattr(args, f"source_{name}")
        for name in ("frequency", "aprime", "bprime", "envelope", "pulse_width", "pulse_delay")
        if getattr(args, f"source_{name}") is not None
    }
    try:
        p = load_parameters(args.params, dtype=args.dtype)
        if src_kw:
            p = dataclasses.replace(p, source=dataclasses.replace(p.source, **src_kw))
        p.validate()
    except FileNotFoundError:
        # same UX as the reference's fail() (main.c:221-223)
        print("Unable to open parameters file!", file=sys.stderr)
        return 1
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if not p.is_cfl_stable():
        print(
            f"WARNING: time_step {p.time_step:g} exceeds the CFL bound "
            f"{p.cfl_limit():g}; the run will be unstable",
            file=sys.stderr,
        )

    try:
        materials = _materials(args, p)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    print("Initializing fields")
    if p.mode == Mode.VALIDATION:
        print("Validation mode activated. ")
    print("Creating mesh")
    print("Setting initial conditions")
    print("Launching simulation")
    try:
        result = run_simulation(
            p,
            args.device,
            out_dir=args.out,
            materials=materials,
            backend=args.backend,
            write_snapshots=not args.no_output,
            accumulate_power=args.sar,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            quirk_compat=not args.physics_correct,
            diagnostics_log=args.diag_log,
            pml=PMLConfig(cells=args.pml) if args.pml else None,
        )
    except (RuntimeError, ValueError) as e:
        # no CUDA for --device cuda, twopass/stream on the CPU or in float64, a bad
        # device string, a diverged run
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(
        f"{result.iterations} iterations in {result.wall_seconds:.3f}s "
        f"({result.mcells_per_s:.1f} Mcells/s)"
    )
    if args.sar and not args.no_output:
        acc = result.power_j.to(device="cpu", dtype=torch.float64).numpy()
        t_em = result.iterations * p.time_step
        sar_path = os.path.join(args.out, "sar.vtr")  # the snapshot writer made the directory
        write_vtr(sar_path, grid.node_coords(p), {"power_j_m3": acc, "avg_power_w_m3": acc / t_em})
        print(f"SAR map written to {sar_path} (peak {acc.max():.3e} J/m^3 over {t_em:.3e} s)")
    print("Simulation complete!")
    return 0

