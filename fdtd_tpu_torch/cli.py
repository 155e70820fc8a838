"""Command-line entry point: ``python -m fdtd_tpu_torch params.txt``.

Mirrors ``python -m fdtd_tpu params.txt`` (and the reference's
``./microwave params.txt``, main.c:807-853): the same banner lines, the same
single positional argument, the same exit codes on a missing or bad
parameters file, and the JAX CLI's load flags (``--water-block``,
``--ferrite-slab``, ``--load-shape``, ``--load-center``), ``--sar``,
which writes ``sar.vtr``, ``--pml N``, the CPML open boundary, and
``--dispersive`` (with ``--salt-sigma`` and ``--thermal-ambient``), which
makes the water load a Debye medium, and the frequency-domain monitors:
``--dft HZ[,HZ...]`` (with ``--dft-fields e|eh``), which writes
``dft_NN.vtr``, and ``--probe K,J,I`` (repeatable), which writes
``probes.csv``, in the JAX CLI's formats.  ``--device`` chooses where the
fields live (default ``cuda``); without CUDA the run stops with a message
that names ``--device cpu``.  ``--shard Z`` or ``ZxY`` runs the scene on a
mesh of shards (the counterpart of the reference's ``mpirun -np N``; with
fewer CUDA devices than shards they share the devices round-robin, and
``--device cpu`` puts them on the host), with every flag above but
``--dispersive`` together with ``--pml``, which stops with exit code 1 and
the JAX CLI's message.

It takes every flag of the JAX CLI: ``--backend`` also takes the JAX
backend names (mapped with a notice: ``xla`` -> ``torch``, ``pallas`` and
``pallas_fused`` -> ``twopass``, ``pallas_stream`` and
``pallas_temporal`` -> ``stream``), ``--temporal-steps S`` forces the
stream sweep's depth (8, 4 or 2 here), ``--profile DIR`` writes a
``torch.profiler`` trace, and the flags of features not ported yet
(``--thermal``, ``--thermal-power``, ``--coupled``, ``--rotate``) stop the
run with exit code 1 and the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from . import grid
from .dft import DftConfig
from .io.vtr import write_vtr
from .monitors import COMPONENTS, ProbeSet
from .ops.cpml import PMLConfig
from .ops.dispersive import DebyeMaterials, effective_sigma, water_debye_load
from .params import Mode, load_parameters
from .runner import BACKEND_CHOICES, JAX_BACKENDS, run_simulation
from .state import block_mask, cylinder_mask, ferrite_slab, sphere_mask, water_from_mask


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fdtd_tpu_torch",
        description="FDTD microwave-oven simulator on PyTorch/CUDA (params.txt compatible)",
    )
    ap.add_argument("params", help="parameters file (.txt), 8 ordered scalars")
    ap.add_argument("--out", default="r", help="output directory (default: r, like the reference)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64", "bfloat16"])
    ap.add_argument("--backend", default="auto", choices=list(BACKEND_CHOICES) + list(JAX_BACKENDS),
                    help="update path: stream (Hopper streaming kernel, s steps a launch), "
                         "twopass (Hopper two-pass kernels), torch (plain ops), or auto "
                         "(stream on CUDA in float32/bfloat16 when a sweep plan fits and "
                         "there is no --pml, else twopass; torch on the CPU, in float64, and for "
                         "--dispersive with --pml or in validation mode); the JAX names "
                         "xla, pallas, pallas_fused, pallas_stream and pallas_temporal map to "
                         "torch, twopass, twopass, stream and stream")
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
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run to DIR (trace.json)")
    ap.add_argument("--temporal-steps", type=int, default=None, metavar="S", choices=range(2, 9),
                    help="steps per sweep of the stream backend (built at 8, 4 and 2; default: the "
                         "plan with the fewest modelled bytes)")
    ap.add_argument("--dft", default=None, metavar="HZ[,HZ...]",
                    help="accumulate on-the-fly DFT phasors of the E field at these frequencies "
                         "(comma-separated Hz); writes per-frequency dft_NN.vtr complex field maps, |E|, "
                         "and the CW power deposition for lossy loads")
    ap.add_argument("--dft-fields", default="e", choices=["e", "eh"],
                    help="DFT components: 'e' (default) or 'eh' (all six, enabling the cycle-averaged "
                         "Poynting map)")
    ap.add_argument("--probe", action="append", default=None, metavar="K,J,I",
                    help="record a per-step time series of the six cell-centered field components at "
                         "cell (k,j,i); repeatable; writes probes.csv")
    ap.add_argument("--shard", default=None, metavar="ZxY",
                    help="spatial decomposition over devices: Z z-slabs (e.g. 4) or a Z x Y mesh (e.g. 4x2); "
                         "more shards than CUDA devices share them round-robin (not --dispersive with --pml)")
    # the JAX CLI's flags of features not ported yet: accepted, and refused
    # with the ROADMAP item that ports them
    ap.add_argument("--thermal", type=float, default=None, metavar="SECONDS",
                    help="heat-equation solve after the EM run (not ported: ROADMAP queue 1 item 6)")
    ap.add_argument("--thermal-power", type=float, default=None, metavar="WATTS",
                    help="rescale the SAR map to WATTS before the thermal solve (not ported: ROADMAP "
                         "queue 1 item 6)")
    ap.add_argument("--coupled", type=int, default=0, metavar="N",
                    help="two-way EM<->thermal coupling in N intervals (not ported: ROADMAP queue 1 item 6)")
    ap.add_argument("--rotate", type=float, default=0.0, metavar="RPM",
                    help="turntable rotation during a --coupled cook (not ported: ROADMAP queue 1 item 6)")
    return ap


# flags of features not ported yet -> the ROADMAP item that ports them
_UNPORTED_FLAGS = (
    ("thermal", "--thermal", "ROADMAP queue 1 item 6 (thermal and coupling)"),
    ("thermal_power", "--thermal-power", "ROADMAP queue 1 item 6 (thermal and coupling)"),
    ("coupled", "--coupled", "ROADMAP queue 1 item 6 (thermal and coupling)"),
    ("rotate", "--rotate", "ROADMAP queue 1 item 6 (thermal and coupling)"),
)


def _unported_flag(args) -> str | None:
    """The refusal of the first flag of a feature not ported yet, or None."""
    for attr, flag, item in _UNPORTED_FLAGS:
        value = getattr(args, attr)
        if value is not None and value != 0:
            return f"{flag} is not ported yet: {item}"
    return None


def _monitors(args, p):
    """(DftConfig or None, ProbeSet or None) from --dft/--dft-fields and
    --probe; raises ValueError naming the bad flag."""
    probes = dft = None
    if args.probe:
        try:
            probes = ProbeSet(tuple(tuple(int(x) for x in spec.split(",")) for spec in args.probe))
            probes.validate(p)
        except ValueError as e:
            raise ValueError(f"bad --probe spec: {e}") from None
    if args.dft:
        try:
            dft = DftConfig(tuple(float(x) for x in args.dft.split(",")), fields=args.dft_fields)
        except ValueError as e:
            raise ValueError(f"bad --dft spec: {e}") from None
    return dft, probes


def write_probes_csv(path: str, probes) -> None:
    """probes.csv in the JAX CLI's layout: a comment line with the cells, a
    header ``t,p0_ex,...`` and one row per step (``%.9e`` time, ``%.6e``
    values)."""
    header = ["t"] + [f"p{pi}_{c}" for pi in range(len(probes.cells)) for c in COMPONENTS]
    with open(path, "w") as f:
        f.write("# probe cells (k,j,i): " + "; ".join(str(c) for c in probes.cells) + "\n")
        f.write(",".join(header) + "\n")
        flat = probes.values.reshape(probes.values.shape[0], -1)
        for ti in range(flat.shape[0]):
            f.write(f"{probes.times[ti]:.9e}," + ",".join(f"{v:.6e}" for v in flat[ti]) + "\n")


def dft_variables(res, fi: int, frequency: float, materials) -> dict:
    """The arrays of ``dft_NN.vtr`` as the JAX CLI writes them: ``<c>_re`` /
    ``<c>_im`` per component, ``e_mag``, with fields "eh" ``s_x/s_y/s_z``
    and ``s_mag``, and ``cw_power_w_m3`` where the load is lossy (a Debye
    load's effective sigma at this frequency)."""
    comps = COMPONENTS if res.fields == "eh" else COMPONENTS[:3]
    ph = res.phasors[fi]
    variables = {}
    for ci, name in enumerate(comps):
        variables[f"{name}_re"] = np.ascontiguousarray(ph[ci].real)
        variables[f"{name}_im"] = np.ascontiguousarray(ph[ci].imag)
    variables["e_mag"] = res.magnitude(fi)
    if res.fields == "eh":
        S = res.poynting(fi)
        for ci, name in enumerate(("s_x", "s_y", "s_z")):
            variables[name] = np.ascontiguousarray(S[ci])
        variables["s_mag"] = np.sqrt((S**2).sum(axis=0))
    sig_map = None
    if isinstance(materials, DebyeMaterials):  # sigma_eff at this frequency
        sig_map = effective_sigma(materials, frequency)
    elif materials is not None and materials.sigma is not None:
        sig_map = materials.sigma
    if sig_map is not None:
        variables["cw_power_w_m3"] = res.cw_power(sig_map, fi)
    return variables


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

    refusal = _unported_flag(args)
    if refusal:
        print(f"error: {refusal}", file=sys.stderr)
        return 1
    try:
        materials = _materials(args, p)
        dft, probes = _monitors(args, p)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    print("Initializing fields")
    if p.mode == Mode.VALIDATION:
        print("Validation mode activated. ")
    print("Creating mesh")
    print("Setting initial conditions")
    print("Launching simulation")
    prof = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
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
            dft=dft,
            probes=probes,
            stream_s=args.temporal_steps,
            shard=args.shard,
        )
    except (RuntimeError, ValueError) as e:
        # no CUDA for --device cuda, twopass/stream on the CPU or in float64, a bad
        # device string, an unbuilt --temporal-steps, a diverged run, a bad --shard
        # spec or --dispersive with --pml under --shard
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if prof is not None:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(f"profiler trace written to {args.profile}")
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
    if result.probes is not None and not args.no_output:
        pr = result.probes
        path = os.path.join(args.out, "probes.csv")
        os.makedirs(args.out, exist_ok=True)
        write_probes_csv(path, pr)
        print(f"Probe time series ({len(pr.cells)} cell(s), {pr.values.shape[0]} steps) written to {path}")
    if result.dft is not None and not args.no_output:
        coords = grid.node_coords(p)
        os.makedirs(args.out, exist_ok=True)
        for fi, f in enumerate(result.dft.frequencies):
            variables = dft_variables(result.dft, fi, f, materials)
            path = os.path.join(args.out, f"dft_{fi:02d}.vtr")
            write_vtr(path, coords, variables)
            print(f"DFT phasors at {f:.6g} Hz written to {path} "
                  f"(peak |E| {variables['e_mag'].max():.3e}, {result.dft.steps} steps)")
    print("Simulation complete!")
    return 0

