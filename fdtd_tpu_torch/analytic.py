"""TE101 closed-form solution, the built-in correctness oracle.

Replicates the reference's validation evaluator (reference: main.c:670-710):
resonant frequency and wave impedance from height/length (main.c:672-675),
and the three nonzero components of the TE101 mode.  The acceptance metric is
the grid-relative L2 error e_r = sqrt(sum (F_c - F_a)^2 / sum F_a^2).

The closed forms are fp64 numpy; only :func:`error_fields` touches tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import CELERITY, EPSILON, MU, PI
from .params import Params
from .state import FieldState


def mode_constants(p: Params) -> tuple[float, float]:
    """(f_101, Z_te) from height/length (reference: main.c:672-675)."""
    f_mnl = 0.5 * CELERITY * math.sqrt((PI / p.height) ** 2 + (PI / p.length) ** 2) / PI
    omega = 2.0 * PI * f_mnl
    z_te = (omega * MU) / math.sqrt(omega**2 * MU * EPSILON - (PI / p.length) ** 2)
    return f_mnl, z_te


def _spatial_profiles(p: Params):
    K1, J1, I1 = p.padded_shape
    dx = p.spatial_step
    kz = PI * np.arange(K1, dtype=np.float64) * dx / p.height
    kx = PI * np.arange(I1, dtype=np.float64) * dx / p.length
    return np.sin(kz), np.cos(kz), np.sin(kx), np.cos(kx)


def analytic_fields(p: Params, t: float, ccompat: bool = False,
                    k_range: tuple[int, int] | None = None) -> dict[str, np.ndarray]:
    """Closed-form Ey/Hx/Hz on their staggered grids at time ``t`` (fp64),
    on the array planes ``k_range`` = (k_lo, k_hi) (default: all K+1; a
    range gives the same rows of the whole arrays, bit for bit).

    Physics (default), from Maxwell with Ey = cos(wt) sin(pi z/h) sin(pi x/l):

        Hx =  (1/Z_te)      sin(wt) cos(pi z/h) sin(pi x/l)
        Hz = -(pi/(w mu l)) sin(wt) sin(pi z/h) cos(pi x/l)

    ``ccompat=True`` replicates the reference formulas verbatim
    (main.c:693-709), whose Hx/Hz spatial factors are swapped; use it only
    for parity with the reference's aHx/aHz exports.
    """
    f_mnl, z_te = mode_constants(p)
    omega = 2.0 * PI * f_mnl
    sin_kz, cos_kz, sin_kx, cos_kx = _spatial_profiles(p)
    K1, J1, I1 = p.padded_shape
    K, J, I = p.maxk, p.maxj, p.maxi
    k_lo, k_hi = k_range or (0, K1)
    rows = slice(k_lo, k_hi)
    nk = k_hi - k_lo
    nh = max(0, min(k_hi, K) - k_lo)  # Hx's rows below K
    ct = math.cos(2.0 * PI * f_mnl * t)
    st = math.sin(2.0 * PI * f_mnl * t)

    ey = np.zeros((nk, J1, I1))
    ey[:, :J, :] = ct * sin_kz[rows, None, None] * sin_kx[None, None, :]

    hx = np.zeros((nk, J1, I1))
    hz = np.zeros((nk, J1, I1))
    hrows = slice(k_lo, k_lo + nh)
    if ccompat:
        hx[:nh, :J, :] = (1.0 / z_te) * st * sin_kz[hrows, None, None] * cos_kx[None, None, :]
        hz[:, :J, :I] = (-PI / (omega * MU * p.length)) * st * cos_kz[rows, None, None] * sin_kx[None, None, :I]
    else:
        # Hx lives at (i, j+1/2, k+1/2): cos along z evaluated mid-cell.
        dz = PI * p.spatial_step / p.height
        dxs = PI * p.spatial_step / p.length
        cos_kz_half = np.cos(dz * (np.arange(K1) + 0.5))
        cos_kx_half = np.cos(dxs * (np.arange(I1) + 0.5))
        hx[:nh, :J, :] = (1.0 / z_te) * st * cos_kz_half[hrows, None, None] * sin_kx[None, None, :]
        hz[:, :J, :I] = (-PI / (omega * MU * p.length)) * st * sin_kz[rows, None, None] * cos_kx_half[None, None, :I]

    return {"ey": ey, "hx": hx, "hz": hz}


def error_fields(p: Params, s: FieldState, t: float, ccompat: bool = True,
                 k_range: tuple[int, int] | None = None) -> dict[str, torch.Tensor]:
    """(analytical - computed) for Ey/Hx/Hz in the field dtype, on the
    state's device (reference: main.c:685-709), over the array planes
    ``k_range`` (default: all)."""
    ana = analytic_fields(p, t, ccompat=ccompat, k_range=k_range)
    k_lo, k_hi = k_range or (0, p.padded_shape[0])

    def diff(name, comp):
        comp = comp[k_lo:k_hi]
        return torch.as_tensor(ana[name], dtype=comp.dtype, device=comp.device) - comp

    return {"aEy": diff("ey", s.ey), "aHx": diff("hx", s.hx), "aHz": diff("hz", s.hz)}


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float64).numpy()


def peak_normalized_error(p: Params, s: FieldState, t: float) -> dict[str, float]:
    """L2 error against the analytic field at each component's discrete
    time (E at t + dt/2, H at t + dt), normalized by the mode's peak norm."""
    dt_ = p.time_step
    out = {}
    for name, comp, t_off in (("ey", s.ey, 0.5 * dt_), ("hx", s.hx, dt_), ("hz", s.hz, dt_)):
        ana = analytic_fields(p, t + t_off)[name]
        peak = analytic_fields(p, _peak_time(p, name))[name]
        c = _host64(comp)
        out[name] = math.sqrt(float(((c - ana) ** 2).sum()) / float((peak * peak).sum()))
    return out


def _peak_time(p: Params, name: str) -> float:
    f_mnl, _ = mode_constants(p)
    # ey peaks at t=0 (cos); hx/hz at a quarter period (sin)
    return 0.0 if name == "ey" else 0.25 / f_mnl


def relative_l2_error(p: Params, s: FieldState, t: float) -> dict[str, float]:
    """e_r per component (description.pdf section 3 Eq. 2), fp64 on the host."""
    ana = analytic_fields(p, t)
    out = {}
    for name, comp in (("ey", s.ey), ("hx", s.hx), ("hz", s.hz)):
        a = ana[name]
        c = _host64(comp)
        denom = float((a * a).sum())
        num = float(((c - a) ** 2).sum())
        out[name] = math.sqrt(num / denom) if denom > 0 else math.sqrt(num)
    return out
