"""The sharded leapfrog step: the torch ground truth of a sharded run.

The counterpart of ``fdtd_tpu/parallel/sharded_step.py::make_sharded_step``
(:90) and ``make_sharded_chunk_runner`` (:400): one step per shard in torch
ops, the reference order (source, H, source, E), with the halo exchange of
the JAX package's ``shift_up``/``shift_down``: E halos travel toward -axis
before the H pass (H reads E at +1), H halos toward +axis before the E
pass.  The PEC walls and staggered extents are global-index bounds of the
plain updates (:mod:`fdtd_tpu_torch.ops.curl` with a shard's box) and the
source patch is set at its global cells; lossy and heterogeneous-mu_r
coefficients are each shard's parts of the global arrays, and the SAR
increment adds to each shard's owned cells (after one more E exchange:
the cell means read E at +1; on ``twopass`` the ``sar_accum`` kernel,
``sar_accum_shard``).  It shards all three mesh axes, and it is the
float64 path of a sharded run.  The same scaffolding runs the per-shard
two-pass kernels (:func:`make_sharded_chunk_runner` with ``twopass``) and
the trailing steps of the per-shard sweep.

The rest of the JAX package's sharded compositions run here too:

- CPML (``pml``; ``make_sharded_step(pml=)``): each shard advances its psi
  parts (:func:`~fdtd_tpu_torch.ops.cpml.psi_part_slices`) with the
  corrections over its box after each pass (``torch``, the JAX package's
  xla order), or inside the CPML two-pass kernels on the shard (K10-shard
  on ``twopass``, their plain versions on CPU shards); the differences
  read the planes the curls read, so no exchange is added.
- Debye media (``make_sharded_dispersive_step`` :463,
  ``make_sharded_dispersive_chunk_runner`` :627): the vacuum H pass and the
  ADE E update on each shard's parts of the Debye maps, P over the shard's
  box; with SAR the E pass writes each shard's edge work, whose halo plane
  above is exchanged before the work's cell means.  Torch ops only, as the
  JAX package runs its xla scan whatever the backend.
- The monitors (the monitored shard_map scan, ``fdtd_tpu/runner.py:
  499-581``): after each step, E (and with probes or fields "eh", H) one
  plane above each shard's owned window is exchanged, each shard adds its
  owned cells to its part of the DFT sums (the ``dft_accum`` kernel on the
  card, K4-shard, its plain version on ``torch``; the H sums as torch
  ops), and each probe row is read from the shard that owns its cell, in
  the probes' order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import diagnostics
from ..dft import DftConfig
from ..grid import E_COMPONENTS, H_COMPONENTS, Box
from ..monitors import ProbeSet, apply_monitors, probe_row, weight_rows
from ..ops import cpml, curl, dispersive, sar, yee
from ..ops.cpml import PMLConfig
from ..ops.dispersive import DebyeMaterials
from ..params import Mode, Params
from ..source import apply_source, make_source_plan, profile_tensor
from ..spans import COEFS, PROBE_GATHER, span
from ..state import Materials, UpdateCoefs, update_coefs
from .mesh import Mesh, Shard, exchange, part, shard_boxes

_COEF_ARRAYS = ("ca_x", "ca_y", "ca_z", "cb_x", "cb_y", "cb_z")
_HF_ARRAYS = ("hf_x", "hf_y", "hf_z")


def shard_coefs(p: Params, coefs: UpdateCoefs, box: Box, device) -> UpdateCoefs:
    """A shard's part of the update coefficients: the ca/cb (and hf) arrays
    over its box, sigma over its owned cells; vacuum scalars as they are."""
    if not coefs.lossy:
        return coefs
    parts = {n: part(getattr(coefs, n), box.lo, box.hi, device) for n in _COEF_ARRAYS}
    if coefs.heterogeneous_mu:
        parts.update({n: part(getattr(coefs, n), box.lo, box.hi, device) for n in _HF_ARRAYS})
    return dataclasses.replace(coefs, sigma_cells=part(coefs.sigma_cells, *box.cells(p), device), **parts)


def probe_owners(p: Params, boxes: list[Box], probes: ProbeSet) -> list[tuple[int, tuple[int, int, int]]]:
    """For each probe, in order: the shard that owns its cell and the cell
    in that shard's arrays."""
    out = []
    for cell in probes.cells:
        for q, box in enumerate(boxes):
            lo, hi = box.cells(p)
            if all(a <= c < b for a, c, b in zip(lo, cell, hi)):
                out.append((q, tuple(c - o for c, o in zip(cell, box.lo))))
                break
    return out


class ShardContext:
    """What a sharded runner keeps per shard, built once: the coefficient
    parts (built on the host from ``materials``, rounded once to the field
    dtype as on one device), per device the source profile, and as the
    scene asks: each shard's :class:`~fdtd_tpu_torch.ops.cpml.Cpml` of its
    box (``pml``), its part of the Debye maps, the DFT config and the
    probes' owners."""

    def __init__(self, p: Params, mesh: Mesh, boxes: list[Box], materials: Materials | DebyeMaterials | None,
                 pml: PMLConfig | None = None, dft: DftConfig | None = None, probes: ProbeSet | None = None):
        self.p, self.mesh = p, mesh
        debye = isinstance(materials, DebyeMaterials)
        with span(COEFS):
            host = update_coefs(p, None if debye else materials, "cpu")
            self.coefs = [shard_coefs(p, host, box, dev) for box, dev in zip(boxes, mesh.devices)]
            self.dc = None
            if debye:
                dc = dispersive.debye_coefs(p, materials, "cpu")
                self.dc = [dispersive.shard_debye_coefs(dc, box, dev) for box, dev in zip(boxes, mesh.devices)]
        self.cpml = ([cpml.make_cpml(p, pml, cf, dev, box) for cf, box, dev in zip(self.coefs, boxes, mesh.devices)]
                     if pml is not None else None)
        self.dft, self.probes = dft, probes
        self.owners = probe_owners(p, boxes, probes) if probes is not None else None
        self.src = make_source_plan(p) if p.mode == Mode.COMPUTATION else None
        self.profile = ({d: profile_tensor(self.src, d) for d in set(mesh.devices)}
                        if self.src is not None else {})
        self.work: list | None = None  # the Debye SAR's edge work arrays per shard, at first use

    def amps(self, amps) -> dict:
        """The chunk's drive amplitudes as an fp64 tensor on each device."""
        a = np.asarray(amps, dtype=np.float64)
        return {d: torch.as_tensor(a, device=d) for d in set(self.mesh.devices)}

    def weights(self, xs) -> dict | None:
        """The chunk's (n, 2, nf) DFT weight rows on each device (``xs =
        (times, amps, cw, sw)``), or None without the DFT."""
        if self.dft is None:
            return None
        if len(xs) != 4:
            raise ValueError("a DFT chunk takes xs = (times, amps, cw, sw) (dft.dft_weights sliced to the chunk)")
        return {d: weight_rows(xs[2], xs[3], d) for d in set(self.mesh.devices)}

    def source(self, shards: list[Shard], amps: dict, n: int) -> None:
        """Hard-set step ``n``'s source on every shard's arrays, halos
        included."""
        if self.src is None:
            return
        for sh in shards:
            apply_source(self.src, sh.state, amps[sh.device][n], self.profile[sh.device], sh.box)

    def sar(self, shards: list[Shard], kernel: bool) -> None:
        """Each shard's deposition of this step on its owned cells;
        ``kernel``: through the ``sar_accum`` wrapper (else its plain
        version)."""
        exchange(self.mesh, shards, E_COMPONENTS, ("hi",), planes=1)
        deposit = sar.accumulate_power if kernel else diagnostics.accumulate_power
        for sh, cf in zip(shards, self.coefs):
            deposit(self.p, sh.state, cf.sigma_cells, sh.power, sh.box)

    def work_arrays(self, shards: list[Shard]) -> list:
        if self.work is None:
            self.work = [dispersive.zero_work(self.p, sh.device, sh.box.shape) for sh in shards]
        return self.work

    def sar_debye(self, shards: list[Shard]) -> None:
        """Each shard's Debye work of this step on its owned cells (its edge
        work's halo plane above exchanged first)."""
        work = {id(sh): w for sh, w in zip(shards, self.work_arrays(shards))}
        exchange(self.mesh, shards, (0, 1, 2), ("hi",), planes=1, arrays=lambda sh, q: work[id(sh)][q])
        for sh in shards:
            diagnostics.accumulate_work(self.p, work[id(sh)], sh.power, sh.box)

    def monitors(self, shards: list[Shard], w: dict | None, kernel: bool, e_fresh: bool) -> torch.Tensor | None:
        """One step of the monitors on every shard (the module docstring);
        ``w``: the step's (2, nf) weight row on each device; ``kernel``:
        the E sums through the ``dft_accum`` wrapper (else its plain
        version); ``e_fresh``: E's halo plane above is already exchanged.
        Returns the step's (n_probes, 6) probe rows on the first shard's
        device, or None without probes."""
        if self.dft is None and self.probes is None:
            return None
        if not e_fresh:
            exchange(self.mesh, shards, E_COMPONENTS, ("hi",), planes=1)
        if self.probes is not None or self.dft.fields == "eh":
            exchange(self.mesh, shards, H_COMPONENTS, ("hi",), planes=1)
        if self.dft is not None:
            for sh in shards:
                apply_monitors(self.p, sh.state, w[sh.device], self.dft, None, sh.dacc, kernel, sh.box)
        if self.probes is None:
            return None
        main = shards[0].device
        with span(PROBE_GATHER):
            return torch.cat([probe_row(self.p, shards[q].state, (cell,)).to(main) for q, cell in self.owners])


def make_step(ctx: ShardContext, backend: str, accumulate_power: bool):
    """``step(shards, amps, n, w=None)``: step ``n`` of the chunk on every
    shard in place, then the monitors (``w``: the step's DFT weight row on
    each device); returns the step's probe rows or None.  ``torch``: the
    plain updates in the reference order (the source set before each pass;
    with CPML the corrections after each pass; in a Debye medium the ADE E
    update); ``twopass``: the per-shard two-pass kernels (the source once,
    the H kernel keeping the patch; with CPML their CPML variants).  Each
    pass reads one plane past the owned window, so each exchange copies
    that plane only, whatever the shards' halo depth."""
    p = ctx.p
    patch = ctx.src.patch if ctx.src is not None else None
    kernels = backend == "twopass"
    if ctx.dc is not None and kernels:
        raise ValueError("Debye media under --shard run the torch ADE ops (no per-shard ADE kernel)")
    hcoefs = update_coefs(p)  # the vacuum H factor of a Debye medium
    cps = ctx.cpml or [None] * len(ctx.coefs)

    def step(shards: list[Shard], amps: dict, n: int, w: dict | None = None) -> torch.Tensor | None:
        ctx.source(shards, amps, n)
        exchange(ctx.mesh, shards, E_COMPONENTS, ("hi",), planes=1)
        for sh, cf, cp in zip(shards, ctx.coefs, cps):
            if kernels:
                yee.update_h(p, sh.state, cf, patch, cp, sh.psi, box=sh.box)
            else:
                curl.update_h(p, sh.state, hcoefs if ctx.dc is not None else cf, None, sh.box)
                if cp is not None:
                    cp.h_correct(sh.state, sh.psi)
        if not kernels:
            ctx.source(shards, amps, n)
        exchange(ctx.mesh, shards, H_COMPONENTS, ("lo",), planes=1)
        work = ctx.work_arrays(shards) if ctx.dc is not None and accumulate_power else None
        for q, (sh, cf, cp) in enumerate(zip(shards, ctx.coefs, cps)):
            if ctx.dc is not None:
                dispersive.update_e_ade(p, sh.state, sh.pol, ctx.dc[q], work[q] if work else None, sh.box)
            elif kernels:
                yee.update_e(p, sh.state, cf, cp, sh.psi, box=sh.box)
            else:
                curl.update_e(p, sh.state, cf, sh.box)
                if cp is not None:
                    cp.e_correct(sh.state, sh.psi)
        if accumulate_power and ctx.dc is not None:
            ctx.sar_debye(shards)
        elif accumulate_power:
            ctx.sar(shards, kernels)
        return ctx.monitors(shards, w, kernels, e_fresh=accumulate_power and ctx.dc is None)

    return step


def check_scene(materials: Materials | DebyeMaterials | None, accumulate_power: bool) -> None:
    debye = isinstance(materials, DebyeMaterials)
    if accumulate_power and not debye and (materials is None or materials.is_vacuum):
        raise ValueError("--sar needs lossy materials (e.g. --water-block)")


def run_chunk(ctx: ShardContext, step, shards: list[Shard], xs, first: int = 0, amps: dict | None = None,
              w: dict | None = None):
    """Steps ``first``.. of the chunk ``xs`` through ``step`` (``amps``, ``w``:
    the chunk's :meth:`ShardContext.amps` and :meth:`~ShardContext.weights`
    when the caller has them); returns the chunk's probe rows (a (n,
    n_probes, 6) tensor) with probes, else the shards."""
    amps = amps if amps is not None else ctx.amps(xs[1])
    w = w if w is not None else ctx.weights(xs)
    rows = []
    for n in range(first, len(xs[0])):
        row = step(shards, amps, n, {d: t[n] for d, t in w.items()} if w is not None else None)
        if row is not None:
            rows.append(row)
    if ctx.probes is not None:
        return (torch.stack(rows) if rows else
                torch.zeros((0, len(ctx.probes.cells), 6), dtype=torch.float32, device=shards[0].device))
    return shards


def make_sharded_chunk_runner(p: Params, mesh: Mesh, materials: Materials | DebyeMaterials | None = None,
                              accumulate_power: bool = False, backend: str = "torch", pml: PMLConfig | None = None,
                              dft: DftConfig | None = None, probes: ProbeSet | None = None):
    """``run(shards, xs)``: advance the shards (:func:`~fdtd_tpu_torch.
    parallel.mesh.scatter` with ``run.depth`` = 1 halo plane and the parts
    the scene needs) in place over the chunk ``xs = (times, amps)`` of
    :func:`fdtd_tpu_torch.step.scan_inputs` (with ``dft``: ``(times, amps,
    cw, sw)``); with ``accumulate_power`` each shard's ``power`` (its part
    of the fp32 SAR map) takes every step's deposition.  Returns the
    shards, or with ``probes`` the chunk's probe rows.  ``backend``
    ``torch`` (any dtype and device) or ``twopass`` (the kernels; their
    plain versions on CPU shards; K1/K2-shard, with CPML K10-shard and with
    the DFT K4-shard on the card).  ``pml``: CPML (shards with psi parts);
    a ``DebyeMaterials``: Debye media (shards with P; ``torch`` only);
    ``dft``/``probes``: the monitors (shards with their parts of the
    sums)."""
    check_scene(materials, accumulate_power)
    if probes is not None:
        probes.validate(p)
    ctx = ShardContext(p, mesh, shard_boxes(p, mesh, 1), materials, pml, dft, probes)
    step = make_step(ctx, backend, accumulate_power)

    def run(shards: list[Shard], xs):
        return run_chunk(ctx, step, shards, xs)

    run.depth = 1
    run.backend = backend
    return run
