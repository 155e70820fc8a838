"""Cavity energies (reference: main.c:602-668) and power deposition (SAR),
on the device.

The reference reads Ez through the Hz index map in the electric energy
(main.c:627); the default here is the physics-correct form, and
``quirk_compat=True`` replicates the reference's gather.  Reductions
accumulate in fp64 for fp64 fields and in fp32 otherwise.

The power deposition sigma*|E|^2 at cell centers is the JAX package's
capability beyond the vacuum-only reference (BASELINE config #3); its
accumulator is fp32 whatever the field dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import EPSILON, MU
from .params import Params
from .state import FieldState


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _e_cell_means(p: Params, s: FieldState, k_range: tuple[int, int] | None = None):
    """Cell-centered means of the 4 edges bordering each cell (main.c:602-634),
    over the cell planes ``k_range`` = (k_lo, k_hi) (default: all)."""
    k_lo, k_hi = k_range or (0, p.maxk)
    K, J, I = k_hi - k_lo, p.maxj, p.maxi
    at = _acc_dtype(s.ex)
    # the E planes these cells read, widened once
    ex, ey, ez = (t[k_lo : k_hi + 1].to(at) for t in (s.ex, s.ey, s.ez))
    k0, k1 = slice(0, K), slice(1, K + 1)
    j0, j1 = slice(0, J), slice(1, J + 1)
    i0, i1 = slice(0, I), slice(1, I + 1)
    mean_ex = 0.25 * (ex[k0, j0, i0] + ex[k1, j0, i0] + ex[k0, j1, i0] + ex[k1, j1, i0])
    mean_ey = 0.25 * (ey[k0, j0, i0] + ey[k0, j0, i1] + ey[k1, j0, i0] + ey[k1, j0, i1])
    mean_ez = 0.25 * (ez[k0, j0, i0] + ez[k0, j1, i0] + ez[k0, j0, i1] + ez[k0, j1, i1])
    return mean_ex, mean_ey, mean_ez


def _h_cell_means(p: Params, s: FieldState):
    """Cell-centered means of the 2 faces bordering each cell (main.c:636-668)."""
    K, J, I = p.maxk, p.maxj, p.maxi
    at = _acc_dtype(s.hx)
    hx, hy, hz = s.hx.to(at), s.hy.to(at), s.hz.to(at)
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


def e_energy(p: Params, s: FieldState, quirk_compat: bool = False) -> torch.Tensor:
    """Total electric energy (reference: main.c:602-634), a 0-d tensor."""
    dv = p.spatial_step**3
    mean_ex, mean_ey, mean_ez = _e_cell_means(p, s)
    if quirk_compat:
        mean_ez = _quirk_mean_ez(p, s.ez.to(_acc_dtype(s.ex)))
    total = (mean_ex**2).sum() + (mean_ey**2).sum() + (mean_ez**2).sum()
    return total * dv * (EPSILON / 2.0)


def h_energy(p: Params, s: FieldState) -> torch.Tensor:
    """Total magnetic energy (reference: main.c:636-668), a 0-d tensor."""
    dv = p.spatial_step**3
    mean_hx, mean_hy, mean_hz = _h_cell_means(p, s)
    total = (mean_hx**2).sum() + (mean_hy**2).sum() + (mean_hz**2).sum()
    return total * dv * (MU / 2.0)


def total_energy(p: Params, s: FieldState, quirk_compat: bool = False) -> torch.Tensor:
    return e_energy(p, s, quirk_compat) + h_energy(p, s)


def theoretical_te101_energy(p: Params) -> float:
    """W = eps0 * a*b*d / 8 (description.pdf section 3 Eq. 4)."""
    return EPSILON * p.length * p.width * p.height / 8.0


def e_center_sq(p: Params, s: FieldState, k_range: tuple[int, int] | None = None) -> torch.Tensor:
    """|E|^2 at cell centers: the sum of the squared 4-edge means (over the
    cell planes ``k_range``, default all)."""
    mean_ex, mean_ey, mean_ez = _e_cell_means(p, s, k_range)
    return mean_ex * mean_ex + mean_ey * mean_ey + mean_ez * mean_ez


def power_deposition(p: Params, s: FieldState, sigma_cells: torch.Tensor,
                     k_range: tuple[int, int] | None = None) -> torch.Tensor:
    """Instantaneous dissipated power density sigma*|E|^2 (W/m^3) per cell,
    (maxk, maxj, maxi) (or the planes ``k_range``), in the reduction type
    of the fields."""
    k_lo, k_hi = k_range or (0, p.maxk)
    esq = e_center_sq(p, s, k_range)
    return sigma_cells[k_lo:k_hi].to(esq.dtype) * esq


SAR_LABEL = "sar_increment"  # the profiler range of the per-step increment
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
                     acc: torch.Tensor) -> None:
    """One step's deposition, ``acc += (sigma*|E|^2 * dt)`` rounded to fp32,
    in place (the per-step increment of ``fdtd_tpu/step.py``), a slab of k
    planes at a time (every cell's value is the same; the slabs bound the
    device memory of the temporaries).  Vacuum (``sigma_cells`` None)
    deposits nothing."""
    if sigma_cells is None:
        return
    dt = float(np.float32(p.time_step)) if _acc_dtype(s.ex) == torch.float32 else p.time_step
    kb = sar_slab_planes(p)
    with torch.profiler.record_function(SAR_LABEL):
        for k_lo in range(0, p.maxk, kb):
            k_hi = min(p.maxk, k_lo + kb)
            inc = power_deposition(p, s, sigma_cells, (k_lo, k_hi))
            acc[k_lo:k_hi].add_((inc * dt).to(torch.float32))
