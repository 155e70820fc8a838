"""Cavity energies (reference: main.c:602-668), reduced on the device.

The reference reads Ez through the Hz index map in the electric energy
(main.c:627); the default here is the physics-correct form, and
``quirk_compat=True`` replicates the reference's gather.  Reductions
accumulate in fp64 for fp64 fields and in fp32 otherwise.
"""

from __future__ import annotations

import torch

from .constants import EPSILON, MU
from .params import Params
from .state import FieldState


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _e_cell_means(p: Params, s: FieldState):
    """Cell-centered means of the 4 edges bordering each cell (main.c:602-634)."""
    K, J, I = p.maxk, p.maxj, p.maxi
    at = _acc_dtype(s.ex)
    ex, ey, ez = s.ex.to(at), s.ey.to(at), s.ez.to(at)
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
