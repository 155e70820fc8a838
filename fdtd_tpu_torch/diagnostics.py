"""Cavity energies (reference: main.c:602-668) and power deposition (SAR),
on the device.

The reference reads Ez through the Hz index map in the electric energy
(main.c:627); the default here is the physics-correct form, and
``quirk_compat=True`` replicates the reference's gather.  Reductions
accumulate in fp64 for fp64 fields and in fp32 otherwise.

The power deposition sigma*|E|^2 at cell centers is the JAX package's
capability beyond the vacuum-only reference (BASELINE config #3); its
accumulator is fp32 whatever the field dtype.  A Debye load deposits the
work of its ADE update instead (:func:`accumulate_work`).
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import EPSILON, MU
from .grid import Box, full_box
from .ops.dispersive import work_cell_means
from .params import Params
from .spans import SAR_INCREMENT, span
from .state import FieldState


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _cell_block(p: Params, kk: slice | None = None, jj: slice | None = None,
                ii: slice | None = None) -> tuple[slice, slice, slice]:
    """Cell-index slices for the mean helpers (default: all cells)."""
    return (kk or slice(0, p.maxk), jj or slice(0, p.maxj), ii or slice(0, p.maxi))


def _e_cell_means(p: Params, s: FieldState, kk: slice | None = None, jj: slice | None = None,
                  ii: slice | None = None):
    """Cell-centered means of the 4 edges bordering each cell (main.c:602-634),
    over the cell block ``kk`` x ``jj`` x ``ii`` (default: all cells).
    Only the E box the block reads is widened; a block's means are the same
    rows of the whole grid's, bit for bit."""
    kk, jj, ii = _cell_block(p, kk, jj, ii)
    K, J, I = kk.stop - kk.start, jj.stop - jj.start, ii.stop - ii.start
    at = _acc_dtype(s.ex)
    box = (slice(kk.start, kk.stop + 1), slice(jj.start, jj.stop + 1), slice(ii.start, ii.stop + 1))
    ex, ey, ez = (t[box].to(at) for t in (s.ex, s.ey, s.ez))
    k0, k1 = slice(0, K), slice(1, K + 1)
    j0, j1 = slice(0, J), slice(1, J + 1)
    i0, i1 = slice(0, I), slice(1, I + 1)
    mean_ex = 0.25 * (ex[k0, j0, i0] + ex[k1, j0, i0] + ex[k0, j1, i0] + ex[k1, j1, i0])
    mean_ey = 0.25 * (ey[k0, j0, i0] + ey[k0, j0, i1] + ey[k1, j0, i0] + ey[k1, j0, i1])
    mean_ez = 0.25 * (ez[k0, j0, i0] + ez[k0, j1, i0] + ez[k0, j0, i1] + ez[k0, j1, i1])
    return mean_ex, mean_ey, mean_ez


def _h_cell_means(p: Params, s: FieldState, kk: slice | None = None, jj: slice | None = None,
                  ii: slice | None = None):
    """Cell-centered means of the 2 faces bordering each cell
    (main.c:636-668), over a cell block (default: all cells)."""
    kk, jj, ii = _cell_block(p, kk, jj, ii)
    K, J, I = kk.stop - kk.start, jj.stop - jj.start, ii.stop - ii.start
    at = _acc_dtype(s.hx)
    box = (slice(kk.start, kk.stop + 1), slice(jj.start, jj.stop + 1), slice(ii.start, ii.stop + 1))
    hx, hy, hz = (t[box].to(at) for t in (s.hx, s.hy, s.hz))
    mean_hx = 0.5 * (hx[:K, :J, :I] + hx[:K, :J, 1 : I + 1])
    mean_hy = 0.5 * (hy[:K, :J, :I] + hy[:K, 1 : J + 1, :I])
    mean_hz = 0.5 * (hz[:K, :J, :I] + hz[1 : K + 1, :J, :I])
    return mean_hx, mean_hy, mean_hz


def _quirk_mean_ez(p: Params, ez: torch.Tensor) -> torch.Tensor:
    """Replicate main.c:627: Ez gathered through the kHz index map
    kHz(i,j,k) = i + j*maxi + k*maxi*maxj, applied to Ez's physical region
    flattened in C order (the reference buffer's layout)."""
    K, J, I = p.maxk, p.maxj, p.maxi
    flat = ez[:K, : J + 1, : I + 1].reshape(-1)
    dev = ez.device
    i = torch.arange(I, device=dev)[None, None, :]
    j = torch.arange(J, device=dev)[None, :, None]
    k = torch.arange(K, device=dev)[:, None, None]

    def g(ii, jj):
        return flat[ii + jj * I + k * I * J]

    return 0.25 * (g(i, j) + g(i, j + 1) + g(i + 1, j) + g(i + 1, j + 1))


# k slabs of the output reductions (energies, snapshot aggregation): each
# works on at most OUTPUT_SLAB_CELLS cells at a time, so its temporaries
# (at most about 8 fp32 values a slab cell, the widened E or H box of bf16
# fields included) stay small beside the resident arrays
OUTPUT_SLAB_CELLS = 1 << 25


def output_slab_planes(p: Params) -> int:
    """Cell planes per slab of the energies and the snapshot aggregation."""
    return max(1, min(p.maxk, OUTPUT_SLAB_CELLS // (p.maxj * p.maxi)))


def output_slabs(p: Params):
    """The (k_lo, k_hi) cell-plane ranges of the output reductions."""
    kb = output_slab_planes(p)
    return [(k, min(p.maxk, k + kb)) for k in range(0, p.maxk, kb)]


def e_energy(p: Params, s: FieldState, quirk_compat: bool = False) -> torch.Tensor:
    """Total electric energy (reference: main.c:602-634), a 0-d tensor,
    summed a k slab at a time (``quirk_compat`` gathers Ez over the whole
    grid: a diagnostic of the reference's indexing, not the run's log)."""
    dv = p.spatial_step**3
    quirk = _quirk_mean_ez(p, s.ez.to(_acc_dtype(s.ex))) if quirk_compat else None
    total = None
    for k_lo, k_hi in output_slabs(p):
        mean_ex, mean_ey, mean_ez = _e_cell_means(p, s, slice(k_lo, k_hi))
        if quirk is not None:
            mean_ez = quirk[k_lo:k_hi]
        part = (mean_ex**2).sum() + (mean_ey**2).sum() + (mean_ez**2).sum()
        total = part if total is None else total + part
    return total * dv * (EPSILON / 2.0)


def h_energy(p: Params, s: FieldState) -> torch.Tensor:
    """Total magnetic energy (reference: main.c:636-668), a 0-d tensor,
    summed a k slab at a time."""
    dv = p.spatial_step**3
    total = None
    for k_lo, k_hi in output_slabs(p):
        mean_hx, mean_hy, mean_hz = _h_cell_means(p, s, slice(k_lo, k_hi))
        part = (mean_hx**2).sum() + (mean_hy**2).sum() + (mean_hz**2).sum()
        total = part if total is None else total + part
    return total * dv * (MU / 2.0)


def total_energy(p: Params, s: FieldState, quirk_compat: bool = False) -> torch.Tensor:
    return e_energy(p, s, quirk_compat) + h_energy(p, s)


def poynting_flux(p: Params, s: FieldState, margin: int = 0) -> torch.Tensor:
    """Net outward Poynting flux (W) through the box whose faces lie
    ``margin`` cells inside the grid on every side (``--pml`` runs log it
    as ``radiated_W``), as ``fdtd_tpu.diagnostics.poynting_flux``: S = E x
    H from the cell-centered means, summed over the box's outermost cell
    layer with outward normals; only the six face layers are computed."""
    K, J, I = p.maxk, p.maxj, p.maxi
    m = int(margin)
    if not 0 <= m < min(K, J, I) // 2:
        raise ValueError(f"margin {margin} leaves no box in a ({K},{J},{I}) grid")
    kk, jj, ii = slice(m, K - m), slice(m, J - m), slice(m, I - m)

    def s_face(comp, kf, jf, if_):
        mex, mey, mez = _e_cell_means(p, s, kf, jf, if_)
        mhx, mhy, mhz = _h_cell_means(p, s, kf, jf, if_)
        if comp == 0:
            return (mey * mhz - mez * mhy).sum()
        if comp == 1:
            return (mez * mhx - mex * mhz).sum()
        return (mex * mhy - mey * mhx).sum()

    def one(c):
        return slice(c, c + 1)

    da = p.spatial_step**2
    flux = (
        s_face(2, one(K - 1 - m), jj, ii) - s_face(2, one(m), jj, ii)
        + s_face(1, kk, one(J - 1 - m), ii) - s_face(1, kk, one(m), ii)
        + s_face(0, kk, jj, one(I - 1 - m)) - s_face(0, kk, jj, one(m))
    )
    return flux * da


def theoretical_te101_energy(p: Params) -> float:
    """W = eps0 * a*b*d / 8 (description.pdf section 3 Eq. 4)."""
    return EPSILON * p.length * p.width * p.height / 8.0


def e_center_sq(p: Params, s: FieldState, k_range: tuple[int, int] | None = None) -> torch.Tensor:
    """|E|^2 at cell centers: the sum of the squared 4-edge means (over the
    cell planes ``k_range``, default all)."""
    kk = slice(*k_range) if k_range is not None else None
    mean_ex, mean_ey, mean_ez = _e_cell_means(p, s, kk)
    return mean_ex * mean_ex + mean_ey * mean_ey + mean_ez * mean_ez


def power_deposition(p: Params, s: FieldState, sigma_cells: torch.Tensor,
                     k_range: tuple[int, int] | None = None, box: Box | None = None) -> torch.Tensor:
    """Instantaneous dissipated power density sigma*|E|^2 (W/m^3) per cell,
    (maxk, maxj, maxi) (or the planes ``k_range``), in the reduction type
    of the fields.  With ``box`` (a shard's arrays, :class:`~fdtd_tpu_torch.
    grid.Box`) the cells it owns, ``sigma_cells`` its part of the map and
    ``k_range`` planes of that part; E's +1 neighbours come from its
    halos."""
    box = box or full_box(p)
    ck, cj, ci = box.local(*box.cells(p))
    k_lo, k_hi = k_range or (0, ck.stop - ck.start)
    mean_ex, mean_ey, mean_ez = _e_cell_means(p, s, slice(ck.start + k_lo, ck.start + k_hi), cj, ci)
    esq = mean_ex * mean_ex + mean_ey * mean_ey + mean_ez * mean_ez
    return sigma_cells[k_lo:k_hi].to(esq.dtype) * esq


SAR_LABEL = SAR_INCREMENT  # the profiler span of the per-step increment
# cells per slab of the per-step increment: its temporaries (the widened E
# planes of bf16 fields, the three cell means, the products and sums) hold
# at most about 7 fp32 values a cell of one slab, not of the whole grid;
# the memory model counts SAR_SLAB_TEMPS
SAR_SLAB_CELLS = 1 << 25
SAR_SLAB_TEMPS = 8


def sar_slab_planes(p: Params) -> int:
    """Cell planes per slab of :func:`accumulate_power`."""
    return max(1, min(p.maxk, SAR_SLAB_CELLS // (p.maxj * p.maxi)))


def accumulate_power(p: Params, s: FieldState, sigma_cells: torch.Tensor | None,
                     acc: torch.Tensor, box: Box | None = None) -> None:
    """One step's deposition, ``acc += (sigma*|E|^2 * dt)`` rounded to fp32,
    in place (the per-step increment of ``fdtd_tpu/step.py``), a slab of k
    planes at a time (every cell's value is the same; the slabs bound the
    device memory of the temporaries).  Vacuum (``sigma_cells`` None)
    deposits nothing.  With ``box``, a shard's cells (``sigma_cells`` and
    ``acc`` its parts of the maps; :func:`power_deposition`)."""
    if sigma_cells is None:
        return
    dt = float(np.float32(p.time_step)) if _acc_dtype(s.ex) == torch.float32 else p.time_step
    kb = sar_slab_planes(p)
    nk = sigma_cells.shape[0]
    with span(SAR_LABEL):
        for k_lo in range(0, nk, kb):
            k_hi = min(nk, k_lo + kb)
            inc = power_deposition(p, s, sigma_cells, (k_lo, k_hi), box)
            acc[k_lo:k_hi].add_((inc * dt).to(torch.float32))


def accumulate_work(p: Params, work: tuple[torch.Tensor, ...], acc: torch.Tensor, box: Box | None = None) -> None:
    """One step's deposition in a Debye load, ``acc += work_cell_means(w)
    * dt`` rounded to fp32, in place: the true dielectric and ionic work
    of the ADE update (``ops.dispersive.update_e_ade`` with ``work``), the
    per-step increment of ``fdtd_tpu.ops.dispersive``'s chunk runners.  A
    slab of k planes at a time, under the profiler span of
    :func:`accumulate_power`.  With ``box``, a shard's cells (``work`` its
    arrays with the halo plane above filled, ``acc`` its part of the map)."""
    dt = float(np.float32(p.time_step)) if work[0].dtype == torch.float32 else p.time_step
    kb = sar_slab_planes(p)
    nk = acc.shape[0]
    with span(SAR_LABEL):
        for k_lo in range(0, nk, kb):
            k_hi = min(nk, k_lo + kb)
            inc = work_cell_means(p, *work, (k_lo, k_hi), box)
            acc[k_lo:k_hi].add_((inc * dt).to(torch.float32))
