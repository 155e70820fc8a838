"""Simulation orchestration: backend choice, snapshot cadence, diagnostics,
checkpoints.

Replicates the reference program's observable behaviour (reference:
propagate_fields, main.c:755-799): a snapshot at iteration 1 before the
loop, then one after every step whose 1-based index is a multiple of
``sampling_rate`` (rate 2 gives files 0001, 0002, 0004, ...).  The steps
between two boundaries run as one chunk that only enqueues device work; the
host waits on the device only at snapshot, log and checkpoint boundaries.

Materials (lossy and heterogeneous-mu_r media), the SAR accumulation and
the CPML open boundary (``pml``) run on every backend; with CPML the psi
state rides beside the fields, goes into checkpoints as ``aux_psi_<term>``
(the JAX package's keys and shapes) and comes back on resume, and the
energy log adds the radiated power ``radiated_W``.  Debye media (a
``DebyeMaterials`` as ``materials``) carry their polarization the same way:
``aux_pol_x/y/z`` in checkpoints (the JAX package's keys), restored on
resume, and ``RunResult.pol``; with ``accumulate_power`` the SAR map is
their true dielectric and ionic work.  The frequency-domain monitors
(``dft``, a ``DftConfig``, and ``probes``, a ``ProbeSet``) run on every
scene: their (re, im) sums and probe rows go into checkpoints as
``aux_dft_re``/``aux_dft_im``/``aux_probe_rows`` (the JAX package's keys)
and come back on resume, and the result carries ``RunResult.dft`` (a
``DftResult``) and ``RunResult.probes`` (a ``ProbeResult``).

``shard`` ("Z" or "ZxY", :func:`parse_shard_spec`) runs the scene on a
(Z, Y, 1) mesh of shards (:mod:`fdtd_tpu_torch.parallel`): vacuum, lossy
and heterogeneous-mu_r materials with SAR, CPML, Debye media and the
monitors, every composition the JAX package's sharded runner takes
(:func:`sharded_runner`).  The chunks between boundaries stay sharded; the
shards are gathered into the canonical state (and SAR map, psi, P and DFT
sums) only where a snapshot, a log record or a checkpoint is due, and at
the end, so checkpoints keep the canonical schema and resume with or
without sharding, in either package.  Debye media with CPML under
``shard`` raise the JAX package's ``ValueError``.

``backend`` also takes the JAX package's names, mapped with a notice:
``xla`` -> ``torch``, ``pallas``/``pallas_fused`` -> ``twopass``,
``pallas_stream``/``pallas_temporal`` -> ``stream``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Callable

import torch

import numpy as np

from . import diagnostics, spans
from .dft import DftConfig, DftResult, acc_bytes, dft_weights, finalize, zero_dft_acc
from .io.checkpoint import CheckpointWriter, from_host, latest_checkpoint, load_aux, load_checkpoint
from .io.snapshots import SnapshotWriter, aggregate_all, validation_extras
from .ops import stream_plan
from .parallel import mesh as shard_mesh
from .parallel.sharded_fast import free_bytes, make_sharded_stream_runner, pick_shard_plan
from .parallel.sharded_step import make_sharded_chunk_runner
from .ops.cpml import PMLConfig, PsiState, init_psi, psi_part_shapes, psi_shapes
from .monitors import ProbeResult, ProbeSet
from .ops.dispersive import DebyeCoefs, DebyeMaterials, PolState, zero_polarization
from .params import Mode, Params, time_values
from .state import FieldState, Materials, init_validation, zeros
from .step import make_chunk_runner, scan_inputs, zero_power_acc

BACKEND_CHOICES = ("auto", "torch", "twopass", "stream")
# the JAX package's backend names -> the port's backend that takes their place
JAX_BACKENDS = {"xla": "torch", "pallas": "twopass", "pallas_fused": "twopass",
                "pallas_stream": "stream", "pallas_temporal": "stream"}


@dataclasses.dataclass
class RunResult:
    state: FieldState
    iterations: int
    wall_seconds: float
    mcells_per_s: float
    power_j: torch.Tensor | None = None
    warnings: list[str] = dataclasses.field(default_factory=list)
    psi: PsiState | None = None
    pol: PolState | None = None
    dft: DftResult | None = None
    probes: ProbeResult | None = None


def map_backend(backend: str, log: Callable[[str], None] | None = None) -> str:
    """A JAX package backend name as the port's backend (with a notice);
    the port's own names unchanged."""
    if backend in JAX_BACKENDS:
        mapped = JAX_BACKENDS[backend]
        if log is not None:
            log(f"notice: backend {backend!r} is the JAX package's; running the port's {mapped!r} backend")
        return mapped
    return backend


def per_step_monitors(p: Params, dft: DftConfig | None, probes: ProbeSet | None) -> bool:
    """Monitors that need a state after every step: probes, the H sums of
    fields "eh" and the DFT in validation mode (the JAX package's
    ``dft.supported_backend`` gate)."""
    return probes is not None or (dft is not None and not stream_plan.dft_gates(p, dft))


def _monitor_notice(p: Params, dft, probes, log) -> None:
    if log is None:
        return
    if per_step_monitors(p, dft, probes):
        log("notice: per-step monitors (--probe/--dft eh/validation) run the twopass kernels "
            "(backend 'stream' ignored)")
    else:
        log("notice: the DFT bands of the stream sweep do not fit this scene; running the twopass kernels "
            "with the dft_accum kernel (backend 'stream' ignored)")


def _dft_memory_note(p: Params, dft: DftConfig) -> str | None:
    """Warning text when the DFT sums (re + im fp32 pairs) cross 2 GB of
    device memory, surfaced up front instead of as a mid-run failure."""
    acc_gb = acc_bytes(p, dft) / 2**30
    if acc_gb <= 2.0:
        return None
    return (f"DFT accumulators need {acc_gb:.1f} GB HBM ({dft.nf} frequencies x {dft.nc} components at "
            f"{p.maxk}x{p.maxj}x{p.maxi}); consider fewer frequencies or fields='e'")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA is an
    error that points at ``--device cpu`` (never a silent move to the host)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass --device cpu "
            "(device='cpu') to run the plain torch path on the host"
        )
    return dev


def resolve_backend(p: Params, backend: str, device, materials: Materials | DebyeMaterials | None = None,
                    accumulate_power: bool = False, pml: PMLConfig | None = None,
                    log: Callable[[str], None] | None = None, dft: DftConfig | None = None,
                    probes: ProbeSet | None = None) -> str:
    """Resolve ``auto`` and refuse combinations the kernels do not run.

    ``auto`` runs ``stream`` (the streaming sweep kernel) on a CUDA device
    in float32 or bfloat16 when a sweep plan fits the scene, else
    ``twopass`` (the two-pass kernels), and ``torch`` for float64 or on
    the CPU, as the JAX package's ``auto`` picks ``pallas_stream`` before
    the two-pass tiers.  A plan fits when the two states and the material
    arrays (and two psi sets with CPML) fit in device memory; materials
    stream in computation mode only, SAR needs materials, and the CPML
    sweep takes the gates of ``stream_plan.pml_gates`` (computation mode,
    uniform mu_r, no SAR, the source patch clear of the j and i slabs), as
    the JAX package's streaming-PML tier does, and ``auto`` picks it as
    the JAX package's ``auto`` picks that tier: on an H100, 1000 steps at
    256^3 with 10-cell walls ran 1.59-1.61x faster in fp32 on the CPML sweep
    (the psi-free interior on the K3 sweep, the shell on the CPML kernel)
    than on ``twopass`` with its passes on the march core, and 1.004-1.009x
    in bf16 (a tie within a run's spread, where ``auto`` keeps the sweep),
    and 1.41x and 1.10-1.13x with the DFT bands against ``twopass`` +
    ``dft_accum`` (PERF.md, ``chip_smoke.py``).  An explicit ``twopass`` or
    ``stream`` on the CPU or in float64 raises ``ValueError``, and so does
    ``stream`` when no plan fits, and ``twopass`` (picked or asked for)
    when its state, material arrays, psi and temporaries do not fit either
    (``stream_plan.twopass_fits``).

    The monitors follow the JAX runner's gates: the DFT of fields "e" in
    computation mode rides the stream sweep's DFT bands when a plan with
    them fits (``auto`` picks it): in shared memory up to the
    frequencies a block holds (``StreamPlan.dft_max_nf``), past them in the
    bands' means mode (each step's cell means buffered in device memory and
    folded into the sums, ``StreamPlan.fold``), so that only memory refuses
    a frequency count; else ``twopass`` with the ``dft_accum`` kernel after each
    step; probes, fields "eh" and validation mode need per-step states and
    run on ``twopass`` (``torch`` off the card).  An explicit ``stream``
    that the monitors cannot take runs ``twopass`` with a notice.  The
    JAX package's backend names are mapped first (:func:`map_backend`).

    Debye media (:func:`_resolve_debye`) have gates of their own.
    """
    dev = torch.device(device)
    backend = map_backend(backend, log)
    if backend not in BACKEND_CHOICES:
        raise ValueError(f"unknown backend {backend!r}: use one of {BACKEND_CHOICES}")
    if isinstance(materials, DebyeMaterials):
        return _resolve_debye(p, backend, dev, accumulate_power, pml, log, dft, probes)
    kernels_ok = dev.type == "cuda" and p.dtype in ("float32", "bfloat16")
    lossy = materials is not None and not materials.is_vacuum
    het = lossy and materials.mu_r is not None
    free = _free_memory(dev)
    monitors = dft is not None or probes is not None
    fits = (kernels_ok and not per_step_monitors(p, dft, probes)
            and stream_plan.supported(p, free, lossy, het, accumulate_power, pml, dft=dft))
    if backend == "auto":
        if not kernels_ok:
            return "torch"
        backend = "stream" if fits else "twopass"
    elif backend == "stream" and monitors and kernels_ok and not fits:
        _monitor_notice(p, dft, probes, log)
        backend = "twopass"
    if backend in ("twopass", "stream") and not kernels_ok:
        raise ValueError(
            f"the {backend} kernels run on a CUDA device in float32 or bfloat16 "
            f"(got device {dev}, dtype {p.dtype}); use --backend torch"
        )
    if backend == "twopass" and not stream_plan.twopass_fits(p, free, lossy, het, accumulate_power, pml, dft=dft):
        need = stream_plan.twopass_bytes(p, lossy, het, accumulate_power, pml, dft=dft)
        mem = stream_plan.DEVICE_BYTES if free is None else free
        raise ValueError(
            f"{p.maxk}x{p.maxj}x{p.maxi} {p.dtype} does not fit in device memory: the twopass "
            f"kernels need {need / 1e9:.1f} GB (the state, the material arrays, the CPML psi, the DFT "
            f"sums and the temporaries) and {stream_plan.MEMORY_MARGIN:.0%} of {mem / 1e9:.1f} GB free is "
            f"{stream_plan.MEMORY_MARGIN * mem / 1e9:.1f} GB; use a coarser grid or bfloat16"
        )
    if backend == "stream" and not fits:
        raise ValueError(
            f"no stream plan fits {p.maxk}x{p.maxj}x{p.maxi} {p.dtype}: the sweep needs "
            "a second copy of the state (and the material arrays) in device memory, "
            "materials stream in computation mode only, SAR needs materials, and the CPML "
            "sweep takes computation mode, uniform mu_r, no SAR and a source patch clear of "
            "the j and i slabs; use --backend twopass"
        )
    return backend


def _resolve_debye(p: Params, backend: str, dev: torch.device, sar: bool, pml: PMLConfig | None,
                   log: Callable[[str], None] | None, dft: DftConfig | None = None,
                   probes: ProbeSet | None = None) -> str:
    """The backend of a Debye scene.  The ADE kernels take what the JAX
    package's dispersive Pallas tier takes (``dispersive_fused_supported``:
    computation mode, float32 or bfloat16) and no CPML: Debye x CPML has no
    kernel in either package, so ``auto`` runs it on ``torch`` with a
    notice (the JAX package runs its xla scan there), and an explicit
    ``twopass`` or ``stream`` raises ``ValueError``, as it does in
    validation mode, in float64, on the CPU and where the arrays do not
    fit.  Otherwise ``auto`` picks ``stream`` when its plan fits, else
    ``twopass``; the monitors as in :func:`resolve_backend` (the DFT bands
    of the ADE sweep or their means mode, else ``twopass`` with the
    ``dft_accum`` kernel)."""
    on_card = dev.type == "cuda" and p.dtype in ("float32", "bfloat16")
    gates = on_card and stream_plan.ade_gates(p, pml=pml)
    free = _free_memory(dev)
    monitors = dft is not None or probes is not None
    stream_ok = (not per_step_monitors(p, dft, probes)
                 and stream_plan.supported(p, free, sar=sar, ade=True, dft=dft))
    if backend == "auto":
        if not on_card:
            return "torch"
        if pml is not None:
            if log is not None:
                log("notice: dispersive media under --pml run the torch ADE+CPML ops (no kernel composes "
                    "them; the JAX package runs its xla scan there)")
            return "torch"
        if not gates:
            if log is not None:
                log("notice: the dispersive kernels need computation mode and float32/bfloat16; "
                    "running the torch ADE ops")
            return "torch"
        backend = "stream" if stream_ok else "twopass"
    elif backend == "stream" and monitors and gates and not stream_ok:
        _monitor_notice(p, dft, probes, log)
        backend = "twopass"
    if backend in ("twopass", "stream") and not gates:
        why = ("Debye media with CPML run the torch ADE+CPML ops (no kernel composes them)"
               if pml is not None and on_card else
               f"the dispersive kernels run on a CUDA device in computation mode and float32 or bfloat16 "
               f"(got device {dev}, {p.mode.name.lower()} mode, dtype {p.dtype})")
        raise ValueError(f"{why}; use --backend torch")
    if backend == "twopass" and not stream_plan.twopass_fits(p, free, sar=sar, ade=True, dft=dft):
        need = stream_plan.twopass_bytes(p, sar=sar, ade=True, dft=dft)
        mem = stream_plan.DEVICE_BYTES if free is None else free
        raise ValueError(
            f"{p.maxk}x{p.maxj}x{p.maxi} {p.dtype} Debye does not fit in device memory: the twopass "
            f"kernels need {need / 1e9:.1f} GB (the state, P, the 15 ADE maps, sigma, the work arrays "
            f"and the temporaries) and {stream_plan.MEMORY_MARGIN:.0%} of {mem / 1e9:.1f} GB free is "
            f"{stream_plan.MEMORY_MARGIN * mem / 1e9:.1f} GB; use a coarser grid or bfloat16"
        )
    if backend == "stream" and not stream_plan.supported(p, free, sar=sar, ade=True, dft=dft):
        raise ValueError(
            f"no stream plan fits {p.maxk}x{p.maxj}x{p.maxi} {p.dtype} Debye: the sweep needs a second "
            "copy of the state and of P beside the 15 ADE maps in device memory; use --backend twopass"
        )
    return backend


def _free_memory(dev: torch.device) -> int | None:
    """Free bytes on a CUDA device, or None (the plan's H100 default)
    where CUDA is not available."""
    if dev.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.mem_get_info(dev)[0]
    return None


def parse_shard_spec(spec: str) -> tuple[int, int]:
    """'4' -> (4, 1) z-slabs; '4x2' -> (4, 2) z*y decomposition.

    The CLI analogue of the reference's ``mpirun -np N ./microwave``
    (description.pdf section 2.2): the grid shards over devices instead of
    ranks (the JAX package's ``parse_shard_spec``, its errors word for
    word).  i-axis (third factor) sharding is API-only
    (``parallel.sharded_step``).
    """
    parts = str(spec).lower().split("x")
    try:
        dims_ = [int(x) for x in parts]
    except ValueError:
        raise ValueError(f"bad --shard spec {spec!r}: use e.g. 4 or 4x2")
    if not 1 <= len(dims_) <= 2 or any(d < 1 for d in dims_):
        raise ValueError(f"bad --shard spec {spec!r}: use e.g. 4 or 4x2")
    nz = dims_[0]
    ny = dims_[1] if len(dims_) > 1 else 1
    return nz, ny


def check_shard_scene(materials, pml: PMLConfig | None) -> None:
    """Refuse what the JAX package's ``--shard`` refuses: Debye x CPML x
    shard, with its ``ValueError`` (its words)."""
    if isinstance(materials, DebyeMaterials) and pml is not None:
        raise ValueError("dispersive media with --pml run single-chip for now (no --shard)")


def sharded_runner(p: Params, shard: str, device, materials: Materials | DebyeMaterials | None = None,
                   accumulate_power: bool = False, backend: str = "auto",
                   log: Callable[[str], None] = print, stream_s: int | None = None, pml: PMLConfig | None = None,
                   dft: DftConfig | None = None, probes: ProbeSet | None = None):
    """(mesh, run) of a sharded run, the counterpart of the JAX package's
    ``_sharded_chunk_runner`` (``fdtd_tpu/runner.py:166``) and its Debye
    routing (:748-786): ``run(shards, xs)`` advances the shards of
    :func:`~fdtd_tpu_torch.parallel.mesh.scatter` (``run.depth`` halo
    planes, with the parts of psi, P and the DFT sums the scene carries) in
    place, and returns the chunk's probe rows with ``probes``.

    ``auto`` takes the sharded ``stream`` where a shard plan fits
    (:func:`~fdtd_tpu_torch.parallel.sharded_fast.pick_shard_plan`; with the
    DFT of fields "e" in computation mode, the plan with the bands or their
    means mode), else
    ``twopass``, and ``torch`` for float64 or on the CPU.  CPML runs
    ``twopass`` (K10-shard: the JAX package has no sharded CPML sweep
    either) and the per-step monitors (probes, fields "eh", the DFT in
    validation mode) ``twopass`` with K4-shard; an explicit ``stream`` that
    the scene cannot take runs ``twopass`` with a notice, and
    ``twopass``/``stream`` off the card or in float64 raise as they do
    unsharded.  Debye media run the torch ADE ops per shard whatever the
    backend (with the JAX package's notice), as its xla shard_map scan
    does."""
    nz, ny = parse_shard_spec(shard)
    dev = torch.device(device)
    mesh = shard_mesh.make_mesh((nz, ny, 1), dev, log)
    backend = map_backend(backend, log)
    if backend not in BACKEND_CHOICES:
        raise ValueError(f"unknown backend {backend!r}: use one of {BACKEND_CHOICES}")
    debye = isinstance(materials, DebyeMaterials)
    lossy = not debye and materials is not None and not materials.is_vacuum
    het = lossy and materials.mu_r is not None
    kernels_ok = dev.type == "cuda" and p.dtype in ("float32", "bfloat16")
    free = free_bytes(mesh)
    per_step = per_step_monitors(p, dft, probes)
    plans = None
    if debye:
        if backend not in ("auto", "torch"):
            log(f"notice: dispersive media under --shard run the torch ADE ops per shard (backend {backend!r} "
                "ignored; the JAX package runs its xla shard_map ADE scan)")
        backend = "torch"
    else:
        if kernels_ok and pml is None and not per_step:
            with spans.span(spans.PLAN):
                plans = pick_shard_plan(p, mesh, stream_s, lossy, het, accumulate_power, free, dft)
        if backend == "auto":
            backend = "torch" if not kernels_ok else "stream" if plans is not None else "twopass"
        elif backend == "stream" and kernels_ok and plans is None:
            why = ("CPML under --shard runs the CPML two-pass kernels per shard (no sharded CPML sweep)"
                   if pml is not None else
                   "per-step monitors (--probe/--dft eh/validation) under --shard run the twopass kernels per shard"
                   if per_step else
                   f"no sharded stream plan fits a {nz}x{ny} mesh of this scene (each shard owns at least s planes, "
                   "s + 1 with --sar or --dft, and two states of every shard, with the DFT sums and buffer, fit its "
                   "device); running the twopass kernels per shard")
            log(f"notice: {why} (backend 'stream' ignored)")
            backend = "twopass"
        if backend in ("twopass", "stream") and not kernels_ok:
            raise ValueError(
                f"the {backend} kernels run on a CUDA device in float32 or bfloat16 "
                f"(got device {dev}, dtype {p.dtype}); use --backend torch"
            )
    if backend != "stream" and dev.type == "cuda":
        boxes = shard_mesh.shard_boxes(p, mesh, 1)
        psi = [sum(map(math.prod, psi_part_shapes(p, pml, b).values())) for b in boxes] if pml is not None else None
        need = stream_plan.shard_bytes(p, [(b.shape, math.prod(b.cell_shape(p))) for b in boxes], mesh.devices,
                                       mesh.devices[0], False, lossy, het, accumulate_power, pml, debye, dft, psi)
        if not stream_plan.shard_fits(need, free):
            raise ValueError(f"{p.maxk}x{p.maxj}x{p.maxi} {p.dtype} on a {nz}x{ny} mesh does not fit in device "
                             f"memory: the shards and the gathered grid need {max(need.values()) / 1e9:.1f} GB on a "
                             "device; use a coarser grid or bfloat16")
    with spans.span(spans.RUNNER_BUILD):
        if backend == "stream":
            return mesh, make_sharded_stream_runner(p, mesh, materials, accumulate_power, plans[0].s, free, dft)
        return mesh, make_sharded_chunk_runner(p, mesh, materials, accumulate_power, backend, pml, dft, probes)


def initial_state(p: Params, device) -> FieldState:
    return init_validation(p, device) if p.mode == Mode.VALIDATION else zeros(p, device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@spans.spanned(spans.RUN)
def run_simulation(
    p: Params,
    device,
    out_dir: str = "r",
    materials: Materials | None = None,
    backend: str = "auto",
    write_snapshots: bool = True,
    accumulate_power: bool = False,
    checkpoint_every: int = 0,
    resume: bool = False,
    quirk_compat: bool = True,
    log: Callable[[str], None] = print,
    diagnostics_log: str | None = None,
    shard: str | None = None,
    pml: PMLConfig | None = None,
    dft: DftConfig | None = None,
    probes: ProbeSet | None = None,
    stream_s: int | None = None,
    dc: DebyeCoefs | None = None,
) -> RunResult:
    """Run the scene ``p`` (with ``materials``, vacuum when None) on
    ``device`` and write its outputs to ``out_dir``.  With
    ``accumulate_power`` the result's ``power_j`` is the deposited energy
    density (J/m^3) per cell, fp32 (all zero in vacuum).  With ``pml`` the
    six walls absorb (CPML); the result's ``psi`` is the final psi state.
    With ``dft`` the result's ``dft`` holds the phasors, with ``probes``
    its ``probes`` the per-step series.  ``stream_s`` forces the steps per
    sweep of the ``stream`` backend (one of ``stream_plan.STEPS``; the
    CLI's ``--temporal-steps``); ``dc`` passes the Debye maps of
    ``materials`` on the device when already built.  ``shard`` ("Z" or
    "ZxY"): run on a mesh of shards (the module docstring)."""
    if shard is not None:
        check_shard_scene(materials, pml)
    if stream_s is not None and stream_s not in stream_plan.STEPS:
        built = "{" + ", ".join(map(str, stream_plan.STEPS)) + "}"
        raise ValueError(f"the stream sweep is built at {built} steps per sweep, not {stream_s} (--temporal-steps)")
    p.validate()
    debye = isinstance(materials, DebyeMaterials)
    if pml is not None and accumulate_power and not debye and (materials is None or materials.is_vacuum):
        raise ValueError("--sar needs lossy materials (e.g. --water-block)")
    if probes is not None:
        probes.validate(p)
    dev = resolve_device(device)
    with spans.span(spans.RESOLVE):  # under --shard the runner's build too
        if shard is not None:
            mesh, run_shards = sharded_runner(p, shard, dev, materials, accumulate_power, backend, log, stream_s,
                                              pml, dft, probes)
        else:
            backend = resolve_backend(p, backend, dev, materials, accumulate_power, pml, log, dft, probes)
    ts = time_values(p)
    xs_t, xs_a = scan_inputs(p, ts)
    dft_cw, dft_sw = dft_weights(dft, ts) if dft is not None else (None, None)
    warnings: list[str] = []

    def warn(msg: str) -> None:
        warnings.append(msg)
        log(f"WARNING: {msg}")

    if dft is not None and (note := _dft_memory_note(p, dft)):
        warn(note)

    if p.dtype == "bfloat16" and (p.mode == Mode.VALIDATION or len(ts) > 2000):
        warn(
            "bfloat16 field storage accumulates leapfrog round-off over long "
            "runs; use float32 for validation/accuracy runs"
        )

    if shard is None:
        with spans.span(spans.RUNNER_BUILD):
            run_chunk = make_chunk_runner(p, dev, materials, backend,
                                          stream_s=stream_s if backend == "stream" else None,
                                          accumulate_power=accumulate_power, pml=pml, dft=dft, probes=probes, dc=dc,
                                          memory_bytes=_free_memory(dev))
    with spans.span(spans.STATE_ALLOC):
        state = initial_state(p, dev)
        power = zero_power_acc(p, dev) if accumulate_power else None
        psi = init_psi(p, pml, dev) if pml is not None else None
        pol = zero_polarization(p, dev) if debye else None
        dacc = zero_dft_acc(p, dft, dev) if dft is not None else None
    probe_rows: list[np.ndarray] = []  # host copies, one a chunk
    resumed_dft = False
    start_step = 0
    if resume:
        with spans.span(spans.RESUME):
            ck = latest_checkpoint(out_dir)
            if ck:
                state, start_step, _t, ck_power = load_checkpoint(ck, p, dev)
                if accumulate_power:
                    if ck_power is not None:
                        power.copy_(torch.as_tensor(ck_power))
                    else:
                        warn("checkpoint has no power accumulator; --sar totals restart from zero "
                             "at this point")
                if pml is not None:
                    _resume_psi(ck, p, pml, psi, warn)
                if debye:
                    _resume_pol(ck, p, pol, warn)
                if dft is not None or probes is not None:
                    resumed_dft = _resume_monitors(ck, dacc, probe_rows if probes is not None else None, warn)

    ckpt_writer = CheckpointWriter(out_dir) if checkpoint_every else None
    writer = SnapshotWriter(p, out_dir) if write_snapshots else None
    diag_f = open(diagnostics_log, "a") if diagnostics_log else None
    # open-boundary runs also log the radiated power through the box one
    # cell inside the absorber, clamped to the largest box the grid admits
    flux_margin = min(pml.cells + 1, min(p.maxk, p.maxj, p.maxi) // 2 - 1) if pml is not None else -1

    def snapshot(s: FieldState, iteration: int, t: float) -> None:
        if writer is None:
            return
        with spans.span(spans.SNAPSHOT):
            variables = aggregate_all(p, s)
            if p.mode == Mode.VALIDATION:
                variables.update(validation_extras(p, s, t, quirk_compat=quirk_compat))
            writer.submit(variables, iteration, t)

    def log_diag(s: FieldState, iteration: int, t: float) -> None:
        if diag_f is None:
            return
        with spans.span(spans.ENERGY_LOG):
            e, h = float(diagnostics.e_energy(p, s)), float(diagnostics.h_energy(p, s))
            rec = {"iteration": iteration, "t": t, "E_energy": e, "H_energy": h, "total": e + h}
            if flux_margin >= 0:
                rec["radiated_W"] = float(diagnostics.poynting_flux(p, s, margin=flux_margin))
            diag_f.write(json.dumps(rec) + "\n")
        # a CFL-unstable or NaN run stops at the next sample instead of
        # burning the rest of the schedule
        if not math.isfinite(e + h):
            diag_f.flush()
            raise RuntimeError(
                f"simulation diverged (non-finite energy) at iteration {iteration}; "
                f"snapshots written so far are in {out_dir!r}"
            )

    n = len(ts)
    rate = max(1, p.sampling_rate)
    try:
        if start_step == 0:
            # initial snapshot at iteration 1 (reference: main.c:758-764)
            snapshot(state, 1, 0.0)
            log_diag(state, 0, 0.0)
        # a sharded run keeps its chunks sharded: the shards are gathered
        # into ``state`` (and ``power``) only where an output is due
        extras = dict(power=power, psi=psi, pml=pml, pol=pol, dacc=dacc)  # the state beside the fields
        shards = shard_mesh.scatter(p, state, mesh, run_shards.depth, **extras) if shard is not None else None

        devices = set(mesh.devices) | {dev} if shard is not None else {dev}
        with spans.span(spans.LOOP):
            for d in devices:
                _sync(d)
            t0 = time.perf_counter()
            pos = start_step

            def next_mult(x, m):
                return ((x // m) + 1) * m

            while pos < n:
                # next boundary: the smallest multiple of the sampling rate (or
                # of the checkpoint interval) past pos, in 1-based steps
                boundary = next_mult(pos, rate)
                if checkpoint_every:
                    boundary = min(boundary, next_mult(pos, checkpoint_every))
                end = min(boundary, n)
                xs = (xs_t[pos:end], xs_a[pos:end])
                if dft is not None:
                    xs += (dft_cw[pos:end], dft_sw[pos:end])
                with spans.span(spans.CHUNK):
                    if shards is not None:
                        rows = run_shards(shards, xs)
                    else:
                        rows = run_chunk(state, xs, power, psi, pol, dacc)  # the state advances in place
                if probes is not None:
                    with spans.span(spans.PROBE_ROWS):
                        probe_rows.append(rows.cpu().numpy())
                pos = end
                t_now = float(ts[pos - 1])
                output = pos % rate == 0 and (writer is not None or diag_f is not None)
                if shards is not None and (output or (checkpoint_every and pos % checkpoint_every == 0) or pos == n):
                    with spans.span(spans.GATHER):
                        shard_mesh.gather(p, shards, state, **extras)
                if pos % rate == 0:
                    snapshot(state, pos, t_now)
                    log_diag(state, pos, t_now)
                if checkpoint_every and pos % checkpoint_every == 0:
                    with spans.span(spans.CHECKPOINT):
                        aux = {f"psi_{n}": getattr(psi, n) for n in PsiState.names()} if psi is not None else {}
                        if pol is not None:
                            aux.update(zip(("pol_x", "pol_y", "pol_z"), pol.tensors()))
                        if dacc is not None:
                            aux.update(dft_re=dacc[0], dft_im=dacc[1])
                        if probes is not None:
                            aux["probe_rows"] = _probe_values(probe_rows, probes)
                        ckpt_writer.submit(state, pos, t_now, power, aux or None)
            for d in devices:
                _sync(d)
            wall = time.perf_counter() - t0
    finally:
        if ckpt_writer is not None:
            ckpt_writer.close()
        if writer is not None:
            writer.close()
        if diag_f is not None:
            diag_f.close()

    steps_done = n - start_step
    mcells = p.cell_count * steps_done / wall / 1e6 if wall > 0 else float("inf")
    with spans.span(spans.FINALIZE):
        # resumed sums cover the whole schedule (they rode the checkpoint)
        dft_result = (finalize(dft, dacc, n if resumed_dft else steps_done, time_step=p.time_step)
                      if dft is not None else None)
        probe_result = None
        if probes is not None:
            values = _probe_values(probe_rows, probes)
            # a resume without stored rows covers only the resumed tail
            probe_result = ProbeResult(cells=probes.cells, times=np.asarray(ts, np.float64)[n - values.shape[0]:],
                                       values=values)
    return RunResult(state, n, wall, mcells, power, warnings, psi, pol, dft_result, probe_result)


def _probe_values(chunks: list[np.ndarray], probes: ProbeSet) -> np.ndarray:
    """The (n, n_probes, 6) fp32 rows recorded so far."""
    if not chunks:
        return np.zeros((0, len(probes.cells), 6), np.float32)
    return np.concatenate(chunks, axis=0)


def _resume_monitors(ck: str, dacc, probe_rows: list, warn: Callable[[str], None]) -> bool:
    """Load the DFT sums (``aux_dft_re``/``aux_dft_im``) into ``dacc`` and
    the stored probe rows (``aux_probe_rows``) into ``probe_rows``, with
    the JAX package's warnings where they are missing; True when the sums
    were resumed."""
    aux = load_aux(ck)
    resumed = False
    if dacc is not None:
        if "dft_re" in aux and "dft_im" in aux and aux["dft_re"].shape == tuple(dacc[0].shape):
            for t, name in zip(dacc, ("dft_re", "dft_im")):
                t.copy_(from_host(aux[name], torch.float32, t.device))
            resumed = True
        else:
            warn("checkpoint has no DFT accumulators; the phasor sums restart from zero (spectra cover only the "
                 "resumed steps)")
    if probe_rows is not None:
        if "probe_rows" in aux:
            rows = np.asarray(aux["probe_rows"], np.float32)
            if rows.shape[0]:
                probe_rows.append(rows)
        else:
            warn("checkpoint has no probe rows; the series covers only the resumed steps")
    return resumed


def _resume_psi(ck: str, p: Params, pml: PMLConfig, psi: PsiState, warn: Callable[[str], None]) -> None:
    """Load the ``aux_psi_<term>`` arrays of checkpoint ``ck`` into ``psi``;
    where one is missing or has another shape, psi restarts from zero with
    the JAX package's warning."""
    aux = load_aux(ck)
    shapes = psi_shapes(p, pml)
    names = PsiState.names()
    if all(f"psi_{n}" in aux and aux[f"psi_{n}"].shape == shapes[n] for n in names):
        for n in names:
            t = getattr(psi, n)
            t.copy_(from_host(aux[f"psi_{n}"], t.dtype, t.device))
    else:
        warn("checkpoint has no (or differently-shaped) CPML psi state; the absorber memory "
             "restarts from zero (fields in the slabs will see a transient)")


def _resume_pol(ck: str, p: Params, pol: PolState, warn: Callable[[str], None]) -> None:
    """Load the ``aux_pol_x/y/z`` arrays of checkpoint ``ck`` into ``pol``;
    where they are missing (or have another shape) P restarts from zero
    with the JAX package's warning."""
    aux = load_aux(ck)
    names = ("pol_x", "pol_y", "pol_z")
    if all(n in aux and aux[n].shape == p.padded_shape for n in names):
        for n, t in zip(names, pol.tensors()):
            t.copy_(from_host(aux[n], t.dtype, t.device))
    else:
        warn("checkpoint has no polarization state; the Debye memory restarts from zero (the medium "
             "will see a transient)")
