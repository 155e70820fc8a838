"""Batched design sweeps (BASELINE config #5).

Counterpart of ``fdtd_tpu/sweep.py``.  A batch of simulations, a scan over
source frequency (:func:`frequency_sweep`) or over material
configurations (:func:`material_sweep`), runs as one program whose states
carry a leading batch axis: each of the six fields is one contiguous
(N, K+1, J+1, I+1) tensor, and member b's state is the contiguous view
``[b]`` of each, updated in place.  The steps run in the JAX package's
scan-of-vmap order: every step advances every member before the next
step starts.

- ``frequency_sweep``: the per-step drive amplitudes of each frequency are
  host-precomputed in fp64 through ``source.drive_values`` (so a gaussian
  envelope applies to members as to single runs) and the same step runs
  for every member.  ``backend`` takes the JAX package's names, mapped as
  ``run_simulation`` maps them (``xla`` -> ``torch``, ``pallas`` and
  ``pallas_fused`` -> ``twopass``, with a notice): on ``twopass`` a step
  of a device's members is one launch each of the batched two-pass Hopper
  kernels (``csrc/yee_twopass.cu``'s k-marching core ``march_kernel`` with
  ``BATCH``, the port's K1/K2 over the batch, each member on the
  operations of its own whole-grid pass: they take the place of the JAX
  package's vmapped ``_h_kernel2``/``_e_kernel2`` and of K7), after the
  source of every member at once (:func:`batch_step`); their plain
  versions on CPU tensors.  On an NVIDIA H100 80GB HBM3 at 700 W one
  launch a member left a 64^3 x 8 sweep's card idle 87-94% of the time
  (PERF.md).
- ``material_sweep``: one coefficient set a member, stacked along a new
  batch axis (each member's coefficients are views of the stack), on the
  torch ops (the JAX package runs its xla path; no ``backend`` argument).

``mesh=``: :func:`batch_mesh` spreads the members over the port's devices
in contiguous blocks, as the JAX package's ``P("b")`` sharding splits the
batch axis (on one card the members share it); a batch that does not
divide over the mesh is refused with the JAX package's message.
:func:`spatial_batch_mesh` also splits each member's grid over z through
the port's sharded step (:mod:`fdtd_tpu_torch.parallel.sharded_step`,
one-plane halos), which takes the place of the JAX package's
GSPMD-partitioned scan; its where-masked source step
(``fdtd_tpu/sweep.py:88``) has no counterpart here, since the sharded step
sets the source at global indices already.  ``pml=``: open-boundary
members (each carries its own psi) on the torch path; not with a spatial
mesh and not on the kernels, the JAX package's refusals.  The result's
states and energies lie on the mesh's first device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from . import diagnostics
from .ops import cpml, yee
from .ops.cpml import PMLConfig, PsiState
from .params import Mode, Params, time_values
from .parallel import mesh as shard_mesh
from .parallel.sharded_step import make_sharded_chunk_runner
from .runner import map_backend, resolve_device
from .source import apply_source_batch, drive_values, make_source_plan, profile_tensor
from .state import FieldState, Materials, UpdateCoefs, field_dtype, te101_initial_ey, update_coefs
from .step import make_step, scan_inputs

SWEEP_BACKENDS = ("torch", "twopass")


@dataclasses.dataclass
class SweepResult:
    states: FieldState  # a leading batch axis on every component: (N, K+1, J+1, I+1)
    e_energy: torch.Tensor  # (N,)
    h_energy: torch.Tensor  # (N,)


@dataclasses.dataclass(frozen=True)
class SweepMesh:
    """An (nb, nz) grid of devices with axes ("b", "z"): members in
    contiguous blocks over "b", each member's grid in z slabs over "z"
    (``devices`` in C order of (b, z))."""

    shape: tuple[int, int]
    devices: tuple[torch.device, ...]

    @property
    def nb(self) -> int:
        return self.shape[0]

    @property
    def nz(self) -> int:
        return self.shape[1]


def batch_mesh(n_devices: int | None = None, devices=None, device="cuda",
               log: Callable[[str], None] | None = None) -> SweepMesh:
    """1-D mesh with axis ``"b"`` for spreading a sweep's members: the
    given ``devices`` (the first ``n_devices``), else ``n_devices`` of
    ``device``'s type (every visible CUDA device when None; fewer devices
    than asked are shared round-robin, with a notice through ``log``)."""
    if devices is None:
        if n_devices is None:
            n_devices = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
        devices = shard_mesh.make_mesh((n_devices, 1, 1), device, log).devices
    elif n_devices is not None:
        devices = devices[:n_devices]
    return SweepMesh((len(devices), 1), tuple(torch.device(d) for d in devices))


def spatial_batch_mesh(nb: int, nz: int, devices=None, device="cuda",
                       log: Callable[[str], None] | None = None) -> SweepMesh:
    """(nb, nz) mesh with axes ("b", "z"): members over "b" and each
    member's grid in ``nz`` z slabs over "z", for members too large for one
    device.  ``devices``: at least nb * nz, else ``nb * nz`` of
    ``device``'s type (shared round-robin where there are fewer)."""
    if devices is None:
        devices = shard_mesh.make_mesh((nb * nz, 1, 1), device, log).devices
    if len(devices) < nb * nz:
        raise ValueError(f"spatial_batch_mesh({nb}, {nz}) needs {nb * nz} devices")
    return SweepMesh((nb, nz), tuple(torch.device(d) for d in devices[: nb * nz]))


def _is_spatial(mesh: SweepMesh | None) -> bool:
    return mesh is not None and mesh.nz > 1


def _member_devices(mesh: SweepMesh | None, n: int, device) -> list[torch.device]:
    """Member b's device on a batch mesh: the device of its block of the
    "b" axis (contiguous blocks, as ``P("b")`` splits the batch), which
    must divide the members evenly; with no mesh, ``device``."""
    if mesh is None:
        return [resolve_device(device)] * n
    if n % mesh.nb:
        raise ValueError(f"sweep size {n} must divide over {mesh.nb} mesh devices")
    for d in mesh.devices:
        resolve_device(d)
    return [mesh.devices[b // (n // mesh.nb)] for b in range(n)]


def member(states: FieldState, b: int) -> FieldState:
    """Member ``b``'s state: the contiguous views ``[b]`` of the batch."""
    return FieldState(*(t[b] for t in states.tensors()))


def initial_batch(p: Params, n: int, device) -> FieldState:
    """The (n, K+1, J+1, I+1) batch of the mode's initial state."""
    states = FieldState(*(torch.zeros((n,) + p.padded_shape, dtype=field_dtype(p), device=device)
                          for _ in range(6)))
    if p.mode == Mode.VALIDATION:
        states.ey.copy_(torch.from_numpy(te101_initial_ey(p)).to(states.ey.dtype))
    return states


class _Batch:
    """The members' states: one (N, K+1, J+1, I+1) batch on the first
    member's device, and for each device a block of the members it runs in
    contiguous order (a slice of the batch on that device, a batch of its
    own on another, copied back at the end)."""

    def __init__(self, p: Params, devices: list[torch.device]):
        self.p, self.home = p, devices[0]
        self.states = initial_batch(p, len(devices), self.home)
        self.blocks: list[tuple[torch.device, int, FieldState]] = []  # (device, first member, block)
        for d in dict.fromkeys(devices):
            first, count = devices.index(d), devices.count(d)
            blk = (FieldState(*(t[first:first + count] for t in self.states.tensors())) if d == self.home
                   else initial_batch(p, count, d))
            self.blocks.append((d, first, blk))
        self.views = [member(blk, b) for _, _, blk in self.blocks for b in range(blk.ex.shape[0])]

    def result(self) -> SweepResult:
        for d, first, blk in self.blocks:
            if d != self.home:
                for dst, src in zip(self.states.tensors(), blk.tensors()):
                    dst[first:first + src.shape[0]].copy_(src)
        return _energies(self.p, self.states)


def batch_step(p: Params, device) -> Callable:
    """``step(states, amps)``: one ``twopass`` step of every member of a
    batch on ``device`` (``amps``: the members' (N,) fp64 amplitudes): the
    source of every member at once, then one launch each of the batched
    K1 and K2 (their plain versions on CPU tensors), the values of the
    members' own ``twopass`` steps."""
    if p.dtype == "float64":
        raise ValueError("the twopass kernels store float32 or bfloat16; float64 runs on the torch backend")
    plan = make_source_plan(p)
    profile = profile_tensor(plan, device)
    coefs = update_coefs(p)

    def step(states: FieldState, amps: torch.Tensor) -> None:
        apply_source_batch(plan, states, amps, profile)
        yee.update_h_batch(p, states, coefs, plan.patch)
        yee.update_e_batch(p, states, coefs)

    return step


def _energies(p: Params, states: FieldState) -> SweepResult:
    n = states.ex.shape[0]
    e = torch.stack([diagnostics.e_energy(p, member(states, b)) for b in range(n)])
    h = torch.stack([diagnostics.h_energy(p, member(states, b)) for b in range(n)])
    return SweepResult(states, e, h)


def run_steps(steps: list[Callable], views: list[FieldState], ts: np.ndarray, amps: list[torch.Tensor],
               psis: list[PsiState] | None = None) -> None:
    """Scan of the batch member by member: every member's step at each
    time before the next (``amps[b]``: member b's fp64 drive row on its
    device), for the steps that take one state."""
    for n in range(len(ts)):
        for b, (step, s) in enumerate(zip(steps, views)):
            if psis is not None:
                step(s, (ts[n], amps[b][n]), psis[b])
            else:
                step(s, (ts[n], amps[b][n]))


def _run_spatial(p: Params, mesh: SweepMesh, n: int, xs_of: Callable, materials_of: Callable,
                 backend: str) -> SweepResult:
    """Members over the mesh's "b" axis, each member's grid in z slabs over
    its "z" devices (the port's sharded step; ``xs_of(b)`` the member's
    chunk inputs, ``materials_of(b)`` its materials)."""
    home = resolve_device(mesh.devices[0])
    states = initial_batch(p, n, home)
    per = -(-n // mesh.nb)
    for b in range(n):
        g = b // per
        zmesh = shard_mesh.Mesh((mesh.nz, 1, 1), mesh.devices[g * mesh.nz:(g + 1) * mesh.nz])
        run = make_sharded_chunk_runner(p, zmesh, materials_of(b), backend=backend)
        s = member(states, b)
        shards = shard_mesh.scatter(p, s, zmesh, run.depth)
        run(shards, xs_of(b))
        shard_mesh.gather(p, shards, s)
    return _energies(p, states)


def frequency_sweep(p: Params, frequencies: Sequence[float], n_steps: int | None = None, backend: str = "xla",
                    mesh: SweepMesh | None = None, pml: PMLConfig | None = None, device="cuda",
                    log: Callable[[str], None] | None = None) -> SweepResult:
    """One simulation per source frequency, batched.

    ``backend``: ``xla``/``torch`` (torch ops) or ``pallas``/
    ``pallas_fused``/``twopass`` (the batched two-pass kernels, one launch
    a pass for every member of a device); the JAX names are mapped with a
    notice through ``log``.  ``pml``: open-boundary members, each with its own psi, on the
    torch path; spatial ("b", "z") meshes do not compose with it.
    ``device``: where the members run without a mesh.
    """
    if p.mode != Mode.COMPUTATION:
        raise ValueError("frequency sweeps require computation mode (a source)")
    if pml is not None and _is_spatial(mesh):
        raise ValueError("PML sweeps do not compose with spatial ('b','z') meshes yet")
    mapped = map_backend(backend, log)
    if mapped not in SWEEP_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if pml is not None and mapped != "torch":
        raise ValueError(f"PML sweeps run the xla path (got backend={backend!r})")
    freqs = np.asarray(frequencies, dtype=np.float64)
    ts = time_values(p)
    if n_steps is not None:
        ts = ts[:n_steps]
    # per-frequency drive amplitudes, host fp64, through drive_values (the
    # envelope applies to members as to single runs)
    amps = np.stack([
        drive_values(make_source_plan(dataclasses.replace(p, source=dataclasses.replace(p.source, frequency=float(f)))),
                     ts)
        for f in freqs
    ])  # (N, steps)
    if _is_spatial(mesh):
        return _run_spatial(p, mesh, len(freqs), lambda b: (ts, amps[b]), lambda b: None, mapped)
    devices = _member_devices(mesh, len(freqs), device)
    batch = _Batch(p, devices)
    if mapped == "twopass":
        # each device's block in one launch of each pass a step
        steps = [(batch_step(p, d), blk, torch.as_tensor(np.ascontiguousarray(amps[first:first + blk.ex.shape[0]].T),
                                                          device=d))
                 for d, first, blk in batch.blocks]
        for n in range(len(ts)):
            for step, blk, rows in steps:
                step(blk, rows[n])
        return batch.result()
    vac = update_coefs(p)
    by_device = {d: cpml.make_pml_step(p, pml, vac, d) if pml is not None else make_step(p, d, coefs=vac)
                 for d in dict.fromkeys(devices)}
    psis = [cpml.init_psi(p, pml, d) for d in devices] if pml is not None else None
    rows = [torch.as_tensor(amps[b], device=d) for b, d in enumerate(devices)]
    run_steps([by_device[d] for d in devices], batch.views, ts, rows, psis)
    return batch.result()


def _stack_coefs(coefs_list: list[UpdateCoefs]) -> UpdateCoefs:
    """The members' coefficient sets stacked along a new batch axis (the
    Python-float factors are the members' common scalars)."""
    het = {c.heterogeneous_mu for c in coefs_list}
    if len(het) != 1:
        raise ValueError("material_sweep members must all carry mu_r, or none")
    fields = {}
    for f in dataclasses.fields(UpdateCoefs):
        vals = [getattr(c, f.name) for c in coefs_list]
        fields[f.name] = torch.stack(vals) if isinstance(vals[0], torch.Tensor) else vals[0]
    return UpdateCoefs(**fields)


def _member_coefs(stacked: UpdateCoefs, b: int) -> UpdateCoefs:
    return UpdateCoefs(**{f.name: (v[b] if isinstance(v := getattr(stacked, f.name), torch.Tensor) else v)
                          for f in dataclasses.fields(UpdateCoefs)})


def material_sweep(p: Params, materials_list: Sequence[Materials], n_steps: int | None = None,
                   mesh: SweepMesh | None = None, pml: PMLConfig | None = None, device="cuda") -> SweepResult:
    """One simulation per material configuration, batched, on the torch
    ops (the members' coefficients stacked along a batch axis).  ``pml``:
    open-boundary members (see :func:`frequency_sweep`)."""
    if any(m is None or m.is_vacuum for m in materials_list):
        raise ValueError("material_sweep requires non-vacuum Materials for every member")
    if pml is not None and _is_spatial(mesh):
        raise ValueError("PML sweeps do not compose with spatial ('b','z') meshes yet")
    ts = time_values(p)
    if n_steps is not None:
        ts = ts[:n_steps]
    xs = scan_inputs(p, ts)
    n = len(materials_list)
    if _is_spatial(mesh):
        return _run_spatial(p, mesh, n, lambda b: xs, lambda b: materials_list[b], "torch")
    devices = _member_devices(mesh, n, device)
    batch = _Batch(p, devices)
    steps, psis, stacks = [], [] if pml is not None else None, {}
    for d in sorted(set(devices), key=devices.index):
        idx = [b for b in range(n) if devices[b] == d]
        stacks[d] = (idx, _stack_coefs([update_coefs(p, materials_list[b], d) for b in idx]))
    for b, d in enumerate(devices):
        idx, stacked = stacks[d]
        coefs = _member_coefs(stacked, idx.index(b))
        if pml is not None:
            steps.append(cpml.make_pml_step(p, pml, coefs, d))
            psis.append(cpml.init_psi(p, pml, d))
        else:
            steps.append(make_step(p, d, coefs=coefs))
    rows = [torch.as_tensor(xs[1], device=d) for d in devices]
    run_steps(steps, batch.views, xs[0], rows, psis)
    return batch.result()
