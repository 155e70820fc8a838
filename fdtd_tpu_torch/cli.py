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
``probes.csv``, in the JAX CLI's formats.  The heating chain: ``--thermal
SECONDS`` after a ``--sar`` run integrates the heat equation driven by the
SAR map (``--thermal-power WATTS`` rescales it, ``--thermal-ambient`` the
start) and writes ``temperature.vtr``; ``--coupled N`` splits the
``--thermal`` cook into N intervals whose EM runs see the load's
temperature-dependent dielectrics (``temperature.vtr``,
``temperature_NN.vtr``, ``coupled.jsonl``, with ``--dft``
``dft_iNN_MM.vtr``; ``--checkpoint-every`` then checkpoints intervals),
and ``--rotate RPM`` turns the load on the turntable during the cook.
``--device`` chooses where the fields live (default ``cuda``); without
CUDA the run stops with a message that names ``--device cpu``.  ``--shard
Z`` or ``ZxY`` runs the scene on a mesh of shards (the counterpart of the
reference's ``mpirun -np N``; with fewer CUDA devices than shards they
share the devices round-robin, and ``--device cpu`` puts them on the
host), with every flag above but ``--dispersive`` together with ``--pml``,
which stops with exit code 1 and the JAX CLI's message.

It takes every flag of the JAX CLI: ``--backend`` also takes the JAX
backend names (mapped with a notice: ``xla`` -> ``torch``, ``pallas`` and
``pallas_fused`` -> ``twopass``, ``pallas_stream`` and
``pallas_temporal`` -> ``stream``), ``--temporal-steps S`` forces the
stream sweep's depth (8, 4 or 2 here), and ``--profile DIR`` writes a
``torch.profiler`` trace.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from . import grid
from .coupled import normalize_power, run_coupled
from .dft import DftConfig
from .io.vtr import write_vtr
from .monitors import COMPONENTS, ProbeSet
from .ops.cpml import PMLConfig
from .ops.dispersive import DebyeMaterials, effective_sigma, water_debye_load
from .params import Mode, load_parameters
from .runner import BACKEND_CHOICES, JAX_BACKENDS, run_simulation
from .state import block_mask, cylinder_mask, ferrite_slab, sphere_mask, water_from_mask
from .thermal import air_thermal, run_thermal, thermal_from_mask
from .turntable import LoadGeometry, rotate_field


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
                         "centered sphere, or a z-axis cylinder (the mug); applies to EM, thermal, "
                         "coupled, and dispersive paths alike")
    ap.add_argument("--load-center", default=None, metavar="X,Y",
                    help="(x, y) center of the load as box fractions (default 0.5,0.5); off-center "
                         "loads are what make --rotate matter")
    ap.add_argument("--dispersive", action="store_true",
                    help="make the --water-block load a true single-pole Debye medium solved by the ADE "
                         "method (frequency-dependent eps(w) in the time domain); --sar then maps its "
                         "dielectric and ionic work")
    ap.add_argument("--salt-sigma", type=float, default=0.0, metavar="S_M",
                    help="ionic conductivity of the load at 25 C in S/m for the coupled and --dispersive "
                         "Debye models (salty food heats harder when hot; default 0 = pure water)")
    ap.add_argument("--thermal-ambient", type=float, default=20.0, metavar="C",
                    help="initial/ambient temperature (default 20 C), and the temperature of the "
                         "--dispersive load")
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
    ap.add_argument("--thermal", type=float, default=None, metavar="SECONDS",
                    help="after the EM run, integrate the heat equation for SECONDS of cook time driven by "
                         "the SAR map (needs --sar and a lossy load, e.g. --water-block); writes temperature.vtr")
    ap.add_argument("--thermal-power", type=float, default=None, metavar="WATTS",
                    help="rescale the deposited-power map so total absorbed power equals WATTS (e.g. the "
                         "magnetron rating) before the thermal solve")
    ap.add_argument("--coupled", type=int, default=0, metavar="N",
                    help="two-way EM<->thermal coupling: split the --thermal cook time into N quasi-static "
                         "intervals, re-deriving the load's eps_r/sigma from its temperature (Debye water "
                         "model) before each interval's EM solve")
    ap.add_argument("--rotate", type=float, default=0.0, metavar="RPM",
                    help="turntable rotation: spin the --water-block load at RPM about the vertical cavity "
                         "axis during a --coupled cook (each interval re-rasterizes the load at its "
                         "mid-interval angle; heat integrates in the load's co-rotating frame)")
    return ap


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
    """(materials, load mask) from the load flags (None for vacuum; a Debye
    medium with ``--dispersive``; the mask of ``--water-block``, else None),
    with the JAX CLI's checks in its order; raises ValueError on flags that
    do not compose."""
    materials = mask = None
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
    if args.rotate and not args.coupled:
        raise ValueError("--rotate needs --coupled N (the turntable is sampled at N angles over the --thermal "
                         "cook)")
    if args.ferrite_slab:
        materials = ferrite_slab(p, base=materials)
    if args.dispersive:
        if not args.water_block or args.ferrite_slab:
            raise ValueError("--dispersive needs --water-block (and no --ferrite-slab): it is the Debye "
                             "description of the water load")
        if args.coupled:
            raise ValueError("--dispersive does not compose with --coupled (the ADE already carries the "
                             "frequency dependence)")
        materials = water_debye_load(p, temperature=args.thermal_ambient, sigma_ion25=args.salt_sigma, mask=mask)
    if args.thermal is not None:
        if not args.sar and not args.coupled:
            raise ValueError("--thermal needs --sar (the SAR map is the heat source)")
        if args.thermal <= 0:
            raise ValueError("--thermal duration must be positive seconds")
    if args.thermal_power is not None and args.thermal_power <= 0:
        raise ValueError("--thermal-power must be positive watts")
    return materials, mask


def _run_coupled_cli(args, p, load_mask=None, dft_cfg=None) -> int:
    """--coupled N: the two-way EM <-> thermal cook
    (:func:`fdtd_tpu_torch.coupled.run_coupled`), with the JAX CLI's
    checks, lines and files."""
    if args.thermal is None:
        print("error: --coupled needs --thermal SECONDS (the cook time)", file=sys.stderr)
        return 1
    if p.mode != Mode.COMPUTATION:
        print("error: --coupled needs computation mode (a driven source heats the load; set the params-file "
              "mode to 1)", file=sys.stderr)
        return 1
    if not args.water_block:
        print("error: --coupled needs --water-block (the heated load whose dielectrics track temperature)",
              file=sys.stderr)
        return 1
    if args.ferrite_slab:
        print("error: --coupled models the water load only (no --ferrite-slab)", file=sys.stderr)
        return 1
    geometry = None
    if args.rotate:
        geometry = LoadGeometry(shape=args.load_shape, center=_parse_load_center(args.load_center))
        load_mask = None  # run_coupled rasterizes the geometry itself
        print(f"Turntable: {args.rotate:g} rpm about the cavity axis ({args.coupled} angle samples over the cook)")
    print(f"Coupled EM<->thermal cook: {args.thermal:g} s over {args.coupled} interval(s); Debye dielectrics at "
          f"{p.source.frequency:.3g} Hz (note the reference drives at 2.45e10, not 2.45e9 — override with "
          "--source-frequency)")
    on_interval = on_interval_dft = None
    if not args.no_output:
        os.makedirs(args.out, exist_ok=True)
        coords = grid.node_coords(p)

        def on_interval(it, T, theta):
            # per-interval maps, an animation of the cook; under --rotate
            # the material-frame map and the lab-frame one at this angle
            if theta:
                variables = {"temperature_c_material_frame": T,
                             "temperature_c_lab": rotate_field(p, T, theta, fill=args.thermal_ambient)}
            else:
                variables = {"temperature_c": T}
            write_vtr(os.path.join(args.out, f"temperature_{it:02d}.vtr"), coords, variables)

        if dft_cfg is not None:
            def on_interval_dft(it, dres, sigma_cells, theta):
                # per-interval phasor maps: how the pattern shifts as the load heats
                for fi in range(len(dft_cfg.frequencies)):
                    variables = {"e_mag": dres.magnitude(fi), "cw_power_w_m3": dres.cw_power(sigma_cells, fi)}
                    for ci in range(dres.phasors.shape[1]):
                        ph = dres.phasors[fi, ci]
                        variables[f"{COMPONENTS[ci]}_re"] = np.real(ph)
                        variables[f"{COMPONENTS[ci]}_im"] = np.imag(ph)
                    write_vtr(os.path.join(args.out, f"dft_i{it:02d}_{fi:02d}.vtr"), coords, variables)

    try:
        res = run_coupled(
            p, cook_time=args.thermal, intervals=args.coupled, mask=load_mask, geometry=geometry, rpm=args.rotate,
            frequency=p.source.frequency, sigma_ion25=args.salt_sigma, power_watts=args.thermal_power,
            ambient=args.thermal_ambient, backend=args.backend, shard=args.shard,
            pml=PMLConfig(cells=args.pml) if args.pml else None, out_dir=args.out, on_interval=on_interval,
            dft=dft_cfg, on_interval_dft=on_interval_dft,
            # under --coupled, --checkpoint-every N (any N > 0) checkpoints
            # intervals: each EM interval restarts from a zero field
            checkpoint=bool(args.checkpoint_every), resume=args.resume, device=args.device,
        )
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    T = res.temperature
    if not args.no_output:
        t_path = os.path.join(args.out, "temperature.vtr")
        if res.final_theta:
            write_vtr(t_path, grid.node_coords(p), {
                "temperature_c_material_frame": T,
                "temperature_c_lab": rotate_field(p, T, res.final_theta, fill=args.thermal_ambient),
            })
            print(f"Turntable end-of-cook angle {np.degrees(res.final_theta):.1f} deg; temperature.vtr carries "
                  "both the material-frame and lab-frame maps")
        else:
            write_vtr(t_path, grid.node_coords(p), {"temperature_c": T})
        log_path = os.path.join(args.out, "coupled.jsonl")
        with open(log_path, "w") as f:
            for rec in res.intervals:
                f.write(json.dumps(rec) + "\n")
        print(f"Temperature map written to {t_path}; interval log to {log_path}")
    hot = tuple(int(c) for c in np.unravel_index(int(res.rise.argmax()), res.rise.shape))
    first, last = res.intervals[0], res.intervals[-1]
    print(f"Peak temperature {T.max():.2f} C (rise {res.rise.max():.3e} K) at cell (k,j,i)={hot}")
    print(f"Load eps_r drifted {first['eps_r_range'][1]:.1f} -> {last['eps_r_range'][1]:.1f}, sigma "
          f"{first['sigma_range'][1]:.3f} -> {last['sigma_range'][1]:.3f} S/m over the cook")
    print("Simulation complete!")
    return 0


def _thermal_after_run(args, p, result, load_mask) -> None:
    """--thermal after an EM run: the SAR map as the heat source (the JAX
    CLI's solve and lines); writes temperature.vtr."""
    acc = result.power_j.to(device="cpu", dtype=torch.float64).numpy()
    q = acc / (result.iterations * p.time_step)
    tm = thermal_from_mask(p, load_mask) if load_mask is not None else air_thermal(p)
    if args.thermal_power is not None:
        q = normalize_power(p, q, args.thermal_power)
        print(f"Deposited power normalized to {args.thermal_power:g} W total")
    print(f"Integrating the heat equation for {args.thermal:g} s of cook time")
    tr = run_thermal(p, tm, q, args.thermal, ambient=args.thermal_ambient, device=args.device)
    T = tr.temperature
    rise = tr.rise.to(device="cpu", dtype=torch.float64).numpy()
    if not args.no_output:
        t_path = os.path.join(args.out, "temperature.vtr")
        os.makedirs(args.out, exist_ok=True)
        write_vtr(t_path, grid.node_coords(p), {"temperature_c": T})
        print(f"Temperature map written to {t_path}")
    hot = tuple(int(c) for c in np.unravel_index(int(rise.argmax()), rise.shape))
    print(f"Peak temperature {T.max():.2f} C (rise {rise.max():.3e} K) at cell (k,j,i)={hot} (ambient "
          f"{args.thermal_ambient:g} C, {tr.steps} thermal steps of {tr.dt:.3e} s)")
    qh = tuple(int(c) for c in np.unravel_index(int(q.argmax()), q.shape))
    print(f"Peak deposited power {q.max():.3e} W/m^3 at {qh}")


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
        materials, load_mask = _materials(args, p)
        dft, probes = _monitors(args, p)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.coupled:
        if probes is not None:
            print("error: --probe does not compose with --coupled (per-step probe series mix the intervals' "
                  "different dielectric problems; run probes on a fixed-material run)", file=sys.stderr)
            return 1
        return _run_coupled_cli(args, p, load_mask, dft)

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
    if args.thermal is not None:
        _thermal_after_run(args, p, result, load_mask)
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

