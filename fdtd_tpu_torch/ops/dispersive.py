"""ADE single-pole Debye dispersion: the torch ground truth and the plain
version of the ADE E kernel.

Counterpart of ``fdtd_tpu/ops/dispersive.py``.  Water's permittivity is a
relaxation, eps(w) = eps_inf + d_eps / (1 + i w tau) (+ sigma_dc/(i w
eps0)); the auxiliary-differential-equation (ADE) method solves it in the
time domain.  Per E component, on its Yee edge:

    D = eps0 eps_inf E + P,      tau dP/dt + P = eps0 d_eps E
    curl H = eps0 eps_inf dE/dt + dP/dt + sigma E

The trapezoidal discretisation of the P ODE,

    P' = k1 P + k2 (E' + E),   k1 = (2 tau - dt)/(2 tau + dt),
                               k2 = eps0 d_eps dt / (2 tau + dt),

in Ampere's law gives the explicit E update

    E' = ca E + cb curl H + cp P
    ca = (eps - k2 - sigma dt/2) / D,   cb = (dt/dx) / D,
    cp = (1 - k1) / D,                  D = eps + k2 + sigma dt/2,

with eps = eps0 eps_inf edge-averaged.  At d_eps = 0 it is the lossy
update of :func:`fdtd_tpu_torch.state.update_coefs`.  The coefficient maps
are edge-averaged from cell maps with the 4-cell stencil of eps/sigma, in
fp64 on the host, and rounded once to the field dtype on the run's device;
outside each component's physical extent (ca, cb, cp, k1, k2) = (1, 0, 0,
1, 0).  The three polarization arrays P live on the padded E grids.

Dielectric loss is E.dP/dt work, not sigma|E|^2, so the SAR of a Debye
load accumulates the trapezoidal work densities of the update itself
(:func:`update_e_ade` with ``work``, :func:`work_cell_means`).

:func:`update_e_ade` is also the plain version of the ADE E kernel
(``csrc/yee_twopass.cu::ade_e_kernel``, replacing
``fdtd_tpu/ops/pallas_dispersive.py::_e_kernel_ade``): bf16 storage is
read as fp32, computed in fp32 and rounded once at the store, and the work
comes from the fp32 values, as the TPU kernel does.  Debye x CPML has no
TPU kernel (the JAX package runs it as its xla scan): here it is torch
ops, :func:`make_dispersive_pml_step`.  A shard of a sharded run takes its
part of the maps (:func:`shard_debye_coefs`) and runs :func:`update_e_ade`
and :func:`work_cell_means` with its box (``parallel.sharded_step``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import EPSILON, MU
from ..grid import Box, full_box
from ..params import Mode, Params
from ..source import apply_source, make_source_plan, profile_tensor
from ..state import FieldState, Materials, UpdateCoefs, _edge_average, block_mask, field_dtype
from . import cpml, curl

# E component -> the two cell axes its edge is averaged over
COMP_AXES = {"x": (0, 1), "y": (0, 2), "z": (1, 2)}

# Water's relaxation (the port's one copy of fdtd_tpu/coupled.py's fits,
# which fdtd_tpu_torch/coupled.py's water_debye reads too): tau(T) in ps
# from Kaatze (1989), interpolated linearly, endpoints clamp; the
# high-frequency permittivity; the Malmberg-Maryott static permittivity.
_TAU_T_C = np.array([0.0, 10.0, 20.0, 25.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0, 90.0, 100.0])
_TAU_PS = np.array([17.67, 12.68, 9.36, 8.27, 7.28, 5.82, 4.75, 3.95, 3.35, 2.88, 2.50, 2.21])
EPS_INF = 5.2


def water_eps_static(T):
    """Static permittivity of water: Malmberg-Maryott (1956) fit, T in C."""
    T = np.asarray(T, np.float64)
    return 87.74 - 0.40008 * T + 9.398e-4 * T**2 - 1.410e-6 * T**3


@dataclasses.dataclass(frozen=True)
class DebyeMaterials:
    """Cell-centered Debye medium maps of shape (maxk, maxj, maxi).

    ``base``: the instantaneous response (``eps_r`` is eps_inf, ``sigma``
    the DC ionic conductivity).  ``d_eps``: relaxation strength eps_s -
    eps_inf (0 = no dispersion).  ``tau``: relaxation time in seconds (> 0
    wherever d_eps > 0).
    """

    base: Materials
    d_eps: np.ndarray
    tau: np.ndarray

    def __post_init__(self):
        d = np.asarray(self.d_eps)
        t = np.asarray(self.tau)
        if np.any(d < 0):
            raise ValueError("Debye d_eps must be >= 0")
        if np.any((d > 0) & (t <= 0)):
            raise ValueError("Debye tau must be > 0 wherever d_eps > 0")


def water_debye_load(p: Params, lo=(0.3, 0.3, 0.3), hi=(0.7, 0.7, 0.7), temperature: float = 20.0,
                     sigma_ion25: float = 0.0, mask: np.ndarray | None = None) -> DebyeMaterials:
    """A water load as a Debye medium at ``temperature`` (C): eps_inf and
    the relaxation of the fits above, and the ionic conductivity
    ``sigma_ion25`` (S/m at 25 C, +2 %/K).  ``mask`` overrides the default
    [lo, hi) box with any cell geometry."""
    if mask is None:
        mask = block_mask(p, lo, hi)
    T = float(np.clip(temperature, 0.0, 100.0))
    eps_s = float(water_eps_static(T))
    tau = float(np.interp(T, _TAU_T_C, _TAU_PS)) * 1e-12
    sigma_ion = sigma_ion25 * (1.0 + 0.02 * (T - 25.0))
    base = Materials(eps_r=np.where(mask, EPS_INF, 1.0), sigma=np.where(mask, sigma_ion, 0.0))
    return DebyeMaterials(base=base, d_eps=np.where(mask, eps_s - EPS_INF, 0.0), tau=np.where(mask, tau, 0.0))


def effective_sigma(dm: DebyeMaterials, frequency: float) -> np.ndarray:
    """Cell-centered effective conductivity at ``frequency``: w eps0
    eps''(w) + sigma_dc, the map that makes the CW power density 1/2
    sigma_eff |E|^2 right for a Debye medium."""
    w = 2.0 * np.pi * float(frequency)
    wt = w * np.asarray(dm.tau, np.float64)
    eps_pp = np.asarray(dm.d_eps, np.float64) * wt / (1.0 + wt * wt)
    sigma_dc = np.asarray(dm.base.sigma, np.float64) if dm.base.sigma is not None else 0.0
    return w * EPSILON * eps_pp + sigma_dc


COMPS = ("x", "y", "z")
COEF_NAMES = ("ca", "cb", "cp", "k1", "k2")


@dataclasses.dataclass(frozen=True)
class DebyeCoefs:
    """Per-E-component padded coefficient maps (comp -> tensor of the
    padded shape in the field dtype, on the run's device): the five ADE
    maps and ``sig``, the edge-averaged DC sigma of the work densities;
    ``h_factor`` is the vacuum dt/(MU dx) of the H pass, and ``dt`` the
    time step as a 0-d tensor in the compute type on the device (the
    divisor of the work densities)."""

    ca: dict
    cb: dict
    cp: dict
    k1: dict
    k2: dict
    sig: dict
    h_factor: float
    dt: torch.Tensor

    def arrays(self, sar: bool = False) -> tuple[torch.Tensor, ...]:
        """The kernels' order: ca_x, ca_y, ca_z, cb_x, ..., k2_z (15), then
        sig_x, sig_y, sig_z with ``sar``."""
        out = [getattr(self, n)[c] for n in COEF_NAMES for c in COMPS]
        if sar:
            out += [self.sig[c] for c in COMPS]
        return tuple(out)


def debye_coefs(p: Params, dm: DebyeMaterials, device) -> DebyeCoefs:
    """Edge-average the cell maps and form the ADE coefficients, in fp64
    on the host, as ``fdtd_tpu.ops.dispersive.debye_coefs`` does; each map
    is rounded once to the field dtype on ``device``."""
    dt_, dx = p.time_step, p.spatial_step
    dty = field_dtype(p)
    K, J, I = p.maxk, p.maxj, p.maxi
    er = dm.base.eps_r if dm.base.eps_r is not None else np.ones((K, J, I))
    sg = dm.base.sigma if dm.base.sigma is not None else np.zeros((K, J, I))
    if dm.base.mu_r is not None:
        raise NotImplementedError("dispersive media with heterogeneous mu_r is not supported")

    def embed(arr: np.ndarray, fill: float) -> torch.Tensor:
        out = np.full(p.padded_shape, fill, np.float64)
        ek, ej, ei = arr.shape
        out[:ek, :ej, :ei] = arr
        return torch.tensor(out, dtype=dty, device=device)

    maps = {n: {} for n in COEF_NAMES + ("sig",)}
    for comp, axes in COMP_AXES.items():
        eps_e = _edge_average(np.asarray(er, np.float64), axes) * EPSILON
        sig_e = _edge_average(np.asarray(sg, np.float64), axes)
        de_e = _edge_average(np.asarray(dm.d_eps, np.float64), axes)
        tau_e = _edge_average(np.asarray(dm.tau, np.float64), axes)
        two_tau = 2.0 * tau_e + dt_
        k1 = (2.0 * tau_e - dt_) / two_tau
        k2 = EPSILON * de_e * dt_ / two_tau
        D = eps_e + k2 + 0.5 * sig_e * dt_
        maps["ca"][comp] = embed((eps_e - k2 - 0.5 * sig_e * dt_) / D, 1.0)
        maps["cb"][comp] = embed((dt_ / dx) / D, 0.0)
        maps["cp"][comp] = embed((1.0 - k1) / D, 0.0)
        maps["k1"][comp] = embed(k1, 1.0)
        maps["k2"][comp] = embed(k2, 0.0)
        maps["sig"][comp] = embed(sig_e, 0.0)
    dt_c = torch.tensor(curl.scalar(dt_, dty), dtype=curl.compute_dtype(dty), device=device)
    return DebyeCoefs(**maps, h_factor=dt_ / (MU * dx), dt=dt_c)


@dataclasses.dataclass
class PolState:
    """The polarization (px, py, pz), each of the padded shape in the field
    dtype; updated in place like the fields."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.px, self.py, self.pz)

    def clone(self) -> "PolState":
        return PolState(*(t.clone() for t in self.tensors()))

    def swap(self, other: "PolState") -> None:
        """Exchange the tensors of ``self`` and ``other`` (no copy)."""
        self.px, other.px = other.px, self.px
        self.py, other.py = other.py, self.py
        self.pz, other.pz = other.pz, self.pz


def zero_polarization(p: Params, device) -> PolState:
    """Zero P on the padded E grids in the field dtype of ``p``."""
    return PolState(*(torch.zeros(p.padded_shape, dtype=field_dtype(p), device=device) for _ in COMPS))


def work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the edge work arrays of fields in ``dtype``: fp64 for
    fp64, else fp32 (the TPU kernel's fp32 work outputs)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def zero_work(p: Params, device, shape: tuple[int, int, int] | None = None) -> tuple[torch.Tensor, ...]:
    """Three edge work arrays (wx, wy, wz) of the padded shape (or of a
    shard's arrays, ``shape``)."""
    dt = work_dtype(field_dtype(p))
    return tuple(torch.zeros(shape or p.padded_shape, dtype=dt, device=device) for _ in COMPS)


def shard_debye_coefs(dc: DebyeCoefs, box: Box, device) -> DebyeCoefs:
    """A shard's part of the Debye maps: the 15 ADE maps and the edge sigma
    over its box (the counterpart of ``fdtd_tpu/parallel/sharded_step.py::
    shard_coefs`` for a Debye medium), copies on ``device``."""
    sl = tuple(slice(a, b) for a, b in zip(box.lo, box.hi))

    def cut(maps: dict) -> dict:
        return {c: torch.empty(t[sl].shape, dtype=t.dtype, device=device).copy_(t[sl]) for c, t in maps.items()}

    return DebyeCoefs(**{n: cut(getattr(dc, n)) for n in COEF_NAMES + ("sig",)}, h_factor=dc.h_factor,
                      dt=dc.dt.to(device))


def update_e_ade(p: Params, s: FieldState, P: PolState, dc: DebyeCoefs,
                 work: tuple[torch.Tensor, ...] | None = None, box: Box | None = None) -> None:
    """The dispersive E half-step in place: E' = ca E + cb curl H + cp P,
    then P' = k1 P + k2 (E' + E), over the interior-only bounds of
    :func:`curl.update_e` (reference main.c:469-500).

    With ``work`` (three tensors of the padded shape, :func:`zero_work`),
    also writes the edge dissipation rates (W/m^3)

        w = E_mid ((P' - P)/dt + sigma E_mid),     E_mid = (E' + E)/2,

    the trapezoidal work of the update's own discretisation, zero outside
    each component's update region (``fdtd_tpu`` ``update_e_ade`` with
    ``with_work``).  Arithmetic in the compute type (fp32 for bf16
    storage); E' and P' round once at the store, the work uses their
    unrounded values, and the division by dt (rounded to the compute type)
    is a true division.  With ``box`` (a shard, its arrays, ``dc`` its
    parts: :func:`shard_debye_coefs`) the shard's owned edges, at global
    bounds, reading H at -1 from its halos; the work arrays are the box's
    shape."""
    K, J, I = p.maxk, p.maxj, p.maxi
    box = box or full_box(p)
    region = (box.own_lo, box.own_hi)
    cd = curl.compute_dtype(s.ex.dtype)
    hx, hy, hz = s.hx.to(cd), s.hy.to(cd), s.hz.to(cd)
    dt = dc.dt

    def advance(comp: str, e: torch.Tensor, pol: torch.Tensor, sl: tuple, c: torch.Tensor, w) -> None:
        e_old, p_old = e[sl].to(cd), pol[sl].to(cd)
        en = dc.ca[comp][sl].to(cd) * e_old + dc.cb[comp][sl].to(cd) * c + dc.cp[comp][sl].to(cd) * p_old
        pn = dc.k1[comp][sl].to(cd) * p_old + dc.k2[comp][sl].to(cd) * (en + e_old)
        if w is not None:
            e_mid = 0.5 * (en + e_old)
            w[sl] = e_mid * ((pn - p_old) / dt + dc.sig[comp][sl].to(cd) * e_mid)
        e[sl] = en
        pol[sl] = pn

    def sh(t: tuple, axis: int) -> tuple:
        return curl._shift(t, axis, -1)

    for w in work or ():
        w.zero_()
    wx, wy, wz = work if work is not None else (None, None, None)
    # E reads H at -1 along two axes: Ex along j and k, Ey along k and i, Ez along i and j
    sx = curl._target(box, region, ((1, K), (1, J), (0, I)), (1, 0), False)
    if sx is not None:
        advance("x", s.ex, P.px, sx, (hz[sx] - hz[sh(sx, 1)]) - (hy[sx] - hy[sh(sx, 0)]), wx)
    sy = curl._target(box, region, ((1, K), (0, J), (1, I)), (0, 2), False)
    if sy is not None:
        advance("y", s.ey, P.py, sy, (hx[sy] - hx[sh(sy, 0)]) - (hz[sy] - hz[sh(sy, 2)]), wy)
    sz = curl._target(box, region, ((0, K), (1, J), (1, I)), (2, 1), False)
    if sz is not None:
        advance("z", s.ez, P.pz, sz, (hy[sz] - hy[sh(sz, 2)]) - (hx[sz] - hx[sh(sz, 1)]), wz)


def work_cell_means(p: Params, wx: torch.Tensor, wy: torch.Tensor, wz: torch.Tensor,
                    k_range: tuple[int, int] | None = None, box: Box | None = None) -> torch.Tensor:
    """Cell-centered total dissipation rate from the three edge work
    arrays, over the cell planes ``k_range`` (default all): per component
    0.25 * (((a + b) + c) + d) of its four edges, then mx + my + mz, the
    association of ``fdtd_tpu.ops.dispersive.work_cell_means``.  With
    ``box`` (a shard's work arrays) the cells it owns, ``k_range`` planes of
    them; the +1 neighbours come from its halos."""
    box = box or full_box(p)
    ck, cj, ci = box.local(*box.cells(p))
    k_lo, k_hi = k_range or (0, ck.stop - ck.start)
    kk, k1s = slice(ck.start + k_lo, ck.start + k_hi), slice(ck.start + k_lo + 1, ck.start + k_hi + 1)
    jj, ii = cj, ci
    j1s, i1s = slice(cj.start + 1, cj.stop + 1), slice(ci.start + 1, ci.stop + 1)
    mx = 0.25 * (wx[kk, jj, ii] + wx[k1s, jj, ii] + wx[kk, j1s, ii] + wx[k1s, j1s, ii])
    my = 0.25 * (wy[kk, jj, ii] + wy[kk, jj, i1s] + wy[k1s, jj, ii] + wy[k1s, jj, i1s])
    mz = 0.25 * (wz[kk, jj, ii] + wz[kk, j1s, ii] + wz[kk, jj, i1s] + wz[kk, j1s, i1s])
    return mx + my + mz


def make_dispersive_pml_step(p: Params, dc: DebyeCoefs, cfg: cpml.PMLConfig, device):
    """One ADE leapfrog step with CPML walls, in the JAX package's xla
    order (``fdtd_tpu.ops.dispersive.make_dispersive_pml_step``):
    ``step(s, (t, amp), P, psi, work=None)`` advances the fields, P and
    psi in place ([source] -> H -> H corrections -> [source] -> ADE E ->
    E corrections -> P += k2 (E_corrected - E)).

    CPML with kappa = 1 adds psi to the curl, and the ADE E update is
    linear in the curl with coefficient cb, so the E corrections use the
    ADE cb maps as their factors, and P' = k1 P + k2 (E' + E) gains
    k2 times E's correction.  With ``work`` the work densities come from
    the E' before the corrections, as in the JAX package (exact where the
    load keeps clear of the absorber)."""
    corr = UpdateCoefs(dc.ca["x"], dc.ca["y"], dc.ca["z"], dc.cb["x"], dc.cb["y"], dc.cb["z"], dc.h_factor)
    h_correct, e_correct = cpml.make_cpml_corrections(p, cfg, corr, device)
    hcoefs = UpdateCoefs(1.0, 1.0, 1.0, 0.0, 0.0, 0.0, dc.h_factor)
    plan = make_source_plan(p) if p.mode == Mode.COMPUTATION else None
    profile = profile_tensor(plan, device) if plan is not None else None

    def step(s: FieldState, x, P: PolState, psi: cpml.PsiState, work=None) -> None:
        if plan is not None:
            apply_source(plan, s, x[1], profile)
        curl.update_h(p, s, hcoefs)
        h_correct(s, psi)
        if plan is not None:
            apply_source(plan, s, x[1], profile)
        update_e_ade(p, s, P, dc, work)
        pre = (s.ex.clone(), s.ey.clone(), s.ez.clone())
        e_correct(s, psi)
        cd = curl.compute_dtype(s.ex.dtype)
        for pc, comp, e_pre in zip(P.tensors(), COMPS, pre):
            e_now = getattr(s, "e" + comp)
            pc.copy_(pc.to(cd) + dc.k2[comp].to(cd) * (e_now.to(cd) - e_pre.to(cd)))

    return step
