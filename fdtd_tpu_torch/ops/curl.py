"""Yee leapfrog curl updates as plain torch slice arithmetic.

These are the plain versions of the two Hopper kernels in
:mod:`fdtd_tpu_torch.ops.yee` (H pass and E pass), and the update of the
``torch`` backend on any device.  They follow the slices and the operation
order of :mod:`fdtd_tpu.ops.curl` (reference: main.c:431-462 update_H,
main.c:469-500 update_E): the E bounds start at 1 and stop before max, which
leaves tangential E on all six walls untouched, the implicit PEC boundary.

A shard of a spatially sharded run (:mod:`fdtd_tpu_torch.parallel`) holds a
:class:`~fdtd_tpu_torch.grid.Box` of the grid in arrays of its own: with
``box`` the updates work on those arrays, with every bound and the source
patch at global indices, over the cells of ``region`` (global (lo, hi),
default the box's owned planes) whose neighbours the arrays hold.  A cell
gets the same operations on the same values as in the whole grid, so the
owned cells of a shard whose halos hold its neighbours' values are bit for
bit those of the unsharded update.

Arithmetic type: fp64 fields compute in fp64 and fp32 in fp32; bf16 fields
are read as fp32, computed in fp32 and rounded back to bf16 once per update,
as the TPU kernels do.  Both functions update the state in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import Box, full_box
from ..params import Params
from ..state import FieldState, UpdateCoefs

Region = tuple[tuple[int, int, int], tuple[int, int, int]]


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to the compute type of ``dtype``, as a Python float
    (an fp32 coefficient must be the same fp32 number on every path)."""
    return float(np.float32(value)) if compute_dtype(dtype) == torch.float32 else float(value)


def _target(box: Box, region: Region, bounds, reads: tuple[int, ...], ahead: bool):
    """The local slices of a component's update: its global ``bounds`` per
    axis within ``region``, less the cells whose neighbour along a ``reads``
    axis (+1 when ``ahead``, else -1) lies outside the arrays; None when
    empty."""
    out = []
    for a, (g0, g1) in enumerate(bounds):
        lo = max(g0, region[0][a], box.lo[a] + (1 if a in reads and not ahead else 0))
        hi = min(g1, region[1][a], box.hi[a] - (1 if a in reads and ahead else 0))
        if hi <= lo:
            return None
        out.append(slice(lo - box.lo[a], hi - box.lo[a]))
    return tuple(out)


def _shift(t: tuple[slice, ...], axis: int, d: int) -> tuple[slice, ...]:
    return tuple(slice(s.start + d, s.stop + d) if a == axis else s for a, s in enumerate(t))


def update_h(p: Params, s: FieldState, coefs: UpdateCoefs,
             patch: tuple[int, int, int, int] | None = None,
             box: Box | None = None, region: Region | None = None) -> None:
    """Half-step H <- H + dt/(mu*dx) * curl E, in place (main.c:431-462);
    with a ``mu_r`` map the factor is ``coefs.hf_x/y/z`` per component.

    Bounds per component (k, j, i):
      Hx: k<K, j<J, i<I+1     Hy: k<K, j<J+1, i<I     Hz: k<K+1, j<J, i<I

    ``patch`` = (j0, j1, i0, i1) leaves Hx and Hz at k=0 inside the source
    rectangle as they were: the reference's second source hard-set
    (main.c:770-778) overwrites whatever update_H put there, so a step that
    sets the source once and skips those cells gives the same fields.
    ``box`` and ``region``: a shard's arrays and the cells to update (see
    the module docstring).
    """
    K, J, I = p.maxk, p.maxj, p.maxi
    box = box or full_box(p)
    region = region or (box.own_lo, box.own_hi)
    cd = compute_dtype(s.hx.dtype)
    f = scalar(coefs.h_factor, s.hx.dtype)
    ex, ey, ez = s.ex.to(cd), s.ey.to(cd), s.ez.to(cd)

    keep = None
    local_patch = box.patch(patch) if patch is not None else None
    if local_patch is not None:
        psl = (0,) + local_patch[0]
        keep = (s.hx[psl].clone(), s.hz[psl].clone())

    het = coefs.heterogeneous_mu
    # H reads E at +1 along two axes: Hx along k and j, Hy along i and k, Hz along j and i
    tx = _target(box, region, ((0, K), (0, J), (0, I + 1)), (0, 1), True)
    if tx is not None:
        fx = coefs.hf_x[tx].to(cd) if het else f
        s.hx[tx] = s.hx[tx].to(cd) + fx * ((ey[_shift(tx, 0, 1)] - ey[tx]) - (ez[_shift(tx, 1, 1)] - ez[tx]))
    ty = _target(box, region, ((0, K), (0, J + 1), (0, I)), (2, 0), True)
    if ty is not None:
        fy = coefs.hf_y[ty].to(cd) if het else f
        s.hy[ty] = s.hy[ty].to(cd) + fy * ((ez[_shift(ty, 2, 1)] - ez[ty]) - (ex[_shift(ty, 0, 1)] - ex[ty]))
    tz = _target(box, region, ((0, K + 1), (0, J), (0, I)), (1, 2), True)
    if tz is not None:
        fz = coefs.hf_z[tz].to(cd) if het else f
        s.hz[tz] = s.hz[tz].to(cd) + fz * ((ex[_shift(tz, 1, 1)] - ex[tz]) - (ey[_shift(tz, 2, 1)] - ey[tz]))
    if keep is not None:
        s.hx[psl] = keep[0]
        s.hz[psl] = keep[1]


def update_e(p: Params, s: FieldState, coefs: UpdateCoefs,
             box: Box | None = None, region: Region | None = None) -> None:
    """Half-step E <- ca*E + cb*curl H, in place (main.c:469-500).

    Interior-only bounds (the PEC boundary):
      Ex: k 1..K-1, j 1..J-1, i 0..I-1
      Ey: k 1..K-1, j 0..J-1, i 1..I-1
      Ez: k 0..K-1, j 1..J-1, i 1..I-1
    Vacuum (scalar coefficients, ca == 1) computes E + cb*curl, which
    equals the reference's ca*E + cb*curl; with materials, ca and cb are
    tensors sliced over the same region, ``ca*E + cb*curl`` in that order.
    ``box`` and ``region`` as in :func:`update_h`.
    """
    K, J, I = p.maxk, p.maxj, p.maxi
    box = box or full_box(p)
    region = region or (box.own_lo, box.own_hi)
    cd = compute_dtype(s.ex.dtype)
    hx, hy, hz = s.hx.to(cd), s.hy.to(cd), s.hz.to(cd)

    def new_e(e: torch.Tensor, sl: tuple, ca, cb, curl: torch.Tensor) -> torch.Tensor:
        if coefs.lossy:
            return ca[sl].to(cd) * e[sl].to(cd) + cb[sl].to(cd) * curl
        return e[sl].to(cd) + scalar(cb, s.ex.dtype) * curl

    # E reads H at -1 along two axes: Ex along j and k, Ey along k and i, Ez along i and j
    sx = _target(box, region, ((1, K), (1, J), (0, I)), (1, 0), False)
    if sx is not None:
        curl_x = (hz[sx] - hz[_shift(sx, 1, -1)]) - (hy[sx] - hy[_shift(sx, 0, -1)])
        s.ex[sx] = new_e(s.ex, sx, coefs.ca_x, coefs.cb_x, curl_x)
    sy = _target(box, region, ((1, K), (0, J), (1, I)), (0, 2), False)
    if sy is not None:
        curl_y = (hx[sy] - hx[_shift(sy, 0, -1)]) - (hz[sy] - hz[_shift(sy, 2, -1)])
        s.ey[sy] = new_e(s.ey, sy, coefs.ca_y, coefs.cb_y, curl_y)
    sz = _target(box, region, ((0, K), (1, J), (1, I)), (2, 1), False)
    if sz is not None:
        curl_z = (hy[sz] - hy[_shift(sz, 2, -1)]) - (hx[sz] - hx[_shift(sz, 1, -1)])
        s.ez[sz] = new_e(s.ez, sz, coefs.ca_z, coefs.cb_z, curl_z)
