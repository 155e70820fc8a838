"""Command-line entry point: ``python -m fdtd_tpu_torch params.txt``.

Mirrors ``python -m fdtd_tpu params.txt`` (and the reference's
``./microwave params.txt``, main.c:807-853) on the vacuum main path: the
same banner lines, the same single positional argument, the same exit codes
on a missing or bad parameters file.  ``--device`` chooses where the fields
live (default ``cuda``); without CUDA the run stops with a message that
names ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from .params import Mode, load_parameters
from .runner import BACKEND_CHOICES, run_simulation


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
                         "(stream on CUDA in float32/bfloat16 when a sweep plan fits, "
                         "else twopass; torch on the CPU or in float64)")
    ap.add_argument("--device", default="cuda", help="torch device of the fields (default: cuda)")
    ap.add_argument("--no-output", action="store_true", help="skip snapshots (benchmark mode)")
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
            backend=args.backend,
            write_snapshots=not args.no_output,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            quirk_compat=not args.physics_correct,
            diagnostics_log=args.diag_log,
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
    print("Simulation complete!")
    return 0

