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
the cell means read E at +1).  It shards all three mesh axes, and it is the
float64 path of a sharded run.  The same scaffolding runs the per-shard
two-pass kernels (:func:`make_sharded_chunk_runner` with ``twopass``) and
the trailing steps of the per-shard sweep.

CPML, Debye media and the monitors do not shard yet (ROADMAP queue 1 item
11b).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import diagnostics
from ..grid import E_COMPONENTS, H_COMPONENTS, Box
from ..ops import curl, yee
from ..params import Mode, Params
from ..source import apply_source, make_source_plan, profile_tensor
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


class ShardContext:
    """What a sharded runner keeps per shard, built once: the coefficient
    parts (built on the host from ``materials``, rounded once to the field
    dtype as on one device) and, per device, the source profile."""

    def __init__(self, p: Params, mesh: Mesh, boxes: list[Box], materials: Materials | None):
        self.p, self.mesh = p, mesh
        host = update_coefs(p, materials, "cpu")
        self.coefs = [shard_coefs(p, host, box, dev) for box, dev in zip(boxes, mesh.devices)]
        self.src = make_source_plan(p) if p.mode == Mode.COMPUTATION else None
        self.profile = ({d: profile_tensor(self.src, d) for d in set(mesh.devices)}
                        if self.src is not None else {})

    def amps(self, amps) -> dict:
        """The chunk's drive amplitudes as an fp64 tensor on each device."""
        a = np.asarray(amps, dtype=np.float64)
        return {d: torch.as_tensor(a, device=d) for d in set(self.mesh.devices)}

    def source(self, shards: list[Shard], amps: dict, n: int) -> None:
        """Hard-set step ``n``'s source on every shard's arrays, halos
        included."""
        if self.src is None:
            return
        for sh in shards:
            apply_source(self.src, sh.state, amps[sh.device][n], self.profile[sh.device], sh.box)

    def sar(self, shards: list[Shard]) -> None:
        """Each shard's deposition of this step on its owned cells."""
        exchange(self.mesh, shards, E_COMPONENTS, ("hi",), planes=1)
        for sh, cf in zip(shards, self.coefs):
            diagnostics.accumulate_power(self.p, sh.state, cf.sigma_cells, sh.power, sh.box)


def make_step(ctx: ShardContext, backend: str, accumulate_power: bool):
    """``step(shards, amps, n)``: step ``n`` of the chunk on every shard in
    place.  ``torch``: the plain updates in the reference order (the source
    set before each pass); ``twopass``: the per-shard two-pass kernels (the
    source once, the H kernel keeping the patch).  Each pass reads one
    plane past the owned window, so each exchange copies that plane only,
    whatever the shards' halo depth."""
    p = ctx.p
    patch = ctx.src.patch if ctx.src is not None else None
    kernels = backend == "twopass"

    def step(shards: list[Shard], amps: dict, n: int) -> None:
        ctx.source(shards, amps, n)
        exchange(ctx.mesh, shards, E_COMPONENTS, ("hi",), planes=1)
        for sh, cf in zip(shards, ctx.coefs):
            if kernels:
                yee.update_h(p, sh.state, cf, patch, box=sh.box)
            else:
                curl.update_h(p, sh.state, cf, None, sh.box)
        if not kernels:
            ctx.source(shards, amps, n)
        exchange(ctx.mesh, shards, H_COMPONENTS, ("lo",), planes=1)
        for sh, cf in zip(shards, ctx.coefs):
            if kernels:
                yee.update_e(p, sh.state, cf, box=sh.box)
            else:
                curl.update_e(p, sh.state, cf, sh.box)
        if accumulate_power:
            ctx.sar(shards)

    return step


def check_scene(materials: Materials | None, accumulate_power: bool) -> None:
    if accumulate_power and (materials is None or materials.is_vacuum):
        raise ValueError("--sar needs lossy materials (e.g. --water-block)")


def make_sharded_chunk_runner(p: Params, mesh: Mesh, materials: Materials | None = None,
                              accumulate_power: bool = False, backend: str = "torch"):
    """``run(shards, xs)``: advance the shards (:func:`~fdtd_tpu_torch.
    parallel.mesh.scatter` with ``run.depth`` = 1 halo plane) in place over
    the chunk ``xs = (times, amps)`` of :func:`fdtd_tpu_torch.step.
    scan_inputs`; with ``accumulate_power`` each shard's ``power`` (its
    part of the fp32 SAR map) takes every step's deposition.  ``backend``
    ``torch`` (any dtype and device) or ``twopass`` (the kernels; their
    plain versions on CPU shards; K1-shard and K2-shard on the card)."""
    check_scene(materials, accumulate_power)
    ctx = ShardContext(p, mesh, shard_boxes(p, mesh, 1), materials)
    step = make_step(ctx, backend, accumulate_power)

    def run(shards: list[Shard], xs) -> list[Shard]:
        amps = ctx.amps(xs[1])
        for n in range(len(xs[0])):
            step(shards, amps, n)
        return shards

    run.depth = 1
    run.backend = backend
    return run
