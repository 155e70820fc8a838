"""Thermal solve driven by the SAR map: the multi-rate EM -> heat coupling.

Counterpart of ``fdtd_tpu/thermal.py``.  The EM run's time-averaged
dissipated power density

    Q = power_acc / t_em      (W/m^3, power_acc in J/m^3 over t_em)

is taken constant over the thermal timescale (the CW steady-state
assumption) and drives explicit FTCS on the cell-centered (maxk, maxj,
maxi) grid of the SAR map,

    rho_c dT/dt = div(k grad T) + Q,

in flux form with harmonic-mean face conductivities and insulated
(zero-flux) walls.  The property maps, the face conductivities, dt/rho_c
and q*dt/rho_c are formed in fp64 on the host, as the JAX package forms
them, and cast once to the solve's dtype on the device.

The step is the JAX package's XLA glue (no TPU kernel belongs here) as
torch ops on the device, in its order of operations: per axis ``div +
pad(flux_out) - pad(flux_in)``, then ``T + inv_rc * (div / dx^2) +
q_term``.  It runs in place on preallocated buffers (the divergence and
one flux buffer) with slice-wise adds instead of padded copies: at 256^3
each array is 67 MB in fp32 and a cook runs thousands of steps.  The
state is the rise above ambient (:func:`run_thermal`), so small rises keep
their full fp32 resolution instead of being rounded against ~300 K.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params import Params

# volumetric heat capacity rho*c_p (J/m^3/K) and conductivity k (W/m/K)
AIR_RHO_C = 1.2 * 1005.0
AIR_K = 0.026
WATER_RHO_C = 1000.0 * 4186.0
WATER_K = 0.6


@dataclasses.dataclass(frozen=True)
class ThermalMaterials:
    """Cell-centered thermal property maps of shape (maxk, maxj, maxi).

    ``rho_c``: volumetric heat capacity rho*c_p (J/m^3/K); ``k``:
    thermal conductivity (W/m/K).
    """

    rho_c: np.ndarray
    k: np.ndarray


def air_thermal(p: Params) -> ThermalMaterials:
    shape = (p.maxk, p.maxj, p.maxi)
    return ThermalMaterials(rho_c=np.full(shape, AIR_RHO_C), k=np.full(shape, AIR_K))


def thermal_from_mask(p: Params, mask, rho_c: float = WATER_RHO_C, k: float = WATER_K,
                      base: ThermalMaterials | None = None) -> ThermalMaterials:
    """Water/food thermal properties over a boolean cell mask (air
    elsewhere): the maps of the coupled cook and the CLI's load shapes."""
    tm = base if base is not None else air_thermal(p)
    return ThermalMaterials(rho_c=np.where(mask, rho_c, tm.rho_c), k=np.where(mask, k, tm.k))


def water_thermal(p: Params, lo=(0.3, 0.3, 0.3), hi=(0.7, 0.7, 0.7), base: ThermalMaterials | None = None,
                  rho_c: float = WATER_RHO_C, k: float = WATER_K) -> ThermalMaterials:
    """Water/food thermal properties over fractional box coords [lo, hi),
    the geometry of :func:`fdtd_tpu_torch.state.water_block`."""
    tm = base if base is not None else air_thermal(p)
    K, J, I = p.maxk, p.maxj, p.maxi
    k0, j0, i0 = int(lo[2] * K), int(lo[1] * J), int(lo[0] * I)
    k1, j1, i1 = int(hi[2] * K), int(hi[1] * J), int(hi[0] * I)
    rc = tm.rho_c.copy()
    kk = tm.k.copy()
    rc[k0:k1, j0:j1, i0:i1] = rho_c
    kk[k0:k1, j0:j1, i0:i1] = k
    return ThermalMaterials(rho_c=rc, k=kk)


def _face_k(k: np.ndarray, axis: int) -> np.ndarray:
    """Harmonic-mean conductivity on interior faces along ``axis``."""
    n = k.shape[axis]
    lo = k[(slice(None),) * axis + (slice(0, n - 1),)]
    hi = k[(slice(None),) * axis + (slice(1, n),)]
    s = lo + hi
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(s > 0, 2.0 * lo * hi / np.where(s > 0, s, 1.0), 0.0)


def stable_dt(p: Params, tm: ThermalMaterials, safety: float = 0.9) -> float:
    """Largest stable FTCS step: per-cell bound over the face sums."""
    dx2 = p.spatial_step**2
    ksum = np.zeros_like(tm.k)
    faces = np.empty_like(ksum)
    for axis in range(3):
        kf = _face_k(tm.k, axis)
        n = kf.shape[axis] + 1
        # the faces of cell c: (c-1, c), then (c, c+1) added (0 at the walls)
        faces[(slice(None),) * axis + (0,)] = 0.0
        faces[(slice(None),) * axis + (slice(1, n),)] = kf
        faces[(slice(None),) * axis + (slice(0, n - 1),)] += kf
        ksum += faces
    # positivity-preserving (all update weights >= 0): dt <= rho_c dx^2
    # / sum_faces k_face, the classical dx^2/(6 alpha) for uniform k
    bound = tm.rho_c * dx2 / np.maximum(ksum, 1e-300)
    return float(safety * bound.min())


def thermal_dtype(p: Params) -> torch.dtype:
    """fp64 when the scene's field dtype is float64, else fp32."""
    return torch.float64 if p.dtype == "float64" else torch.float32


class _Operator:
    """The dt-independent part of the FTCS step on a device: the face
    conductivities, the source map and the work buffers (the divergence and
    one flux buffer), built once and shared by the steps of every dt
    (:meth:`step`)."""

    def __init__(self, p: Params, tm: ThermalMaterials, q, device):
        self.dtype = thermal_dtype(p)
        self.shape = (p.maxk, p.maxj, p.maxi)
        self.div = torch.empty(self.shape, dtype=self.dtype, device=device)
        self.device = self.div.device  # "cuda" made concrete, as a state's device reads
        self.rho_c = np.asarray(tm.rho_c, np.float64)
        self.q = np.asarray(q, np.float64)
        self.kfs = [self._on_device(_face_k(np.asarray(tm.k, np.float64), axis)) for axis in range(3)]
        # a 0-d tensor on the device: a true division on every device (a CPU
        # scalar divisor becomes a multiply by its reciprocal on CUDA)
        self.dx2 = torch.tensor(p.spatial_step**2, dtype=self.dtype, device=self.device)
        self.flux_buf = torch.empty(self.shape, dtype=self.dtype, device=self.device).view(-1)

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        """An fp64 host array cast once to the solve's dtype on the device."""
        return torch.tensor(a, dtype=self.dtype, device=self.device)

    def step(self, dt: float):
        """``step(T)``: one FTCS step of ``dt`` seconds, ``T`` in place;
        dt/rho_c and q*dt/rho_c formed in fp64 on the host and cast once."""
        inv_rc = self._on_device(dt / self.rho_c)
        q_term = self._on_device(self.q * (dt / self.rho_c))
        shape, div, kfs = self.shape, self.div, self.kfs

        def step(T: torch.Tensor) -> None:
            if T.dtype != self.dtype or tuple(T.shape) != shape or T.device != self.device or not T.is_contiguous():
                raise ValueError(f"the thermal state must be a contiguous {self.dtype} tensor of shape {shape} on "
                                 f"{self.device}; got {T.dtype} {tuple(T.shape)} on {T.device}")
            div.zero_()
            for axis, kf in enumerate(kfs):
                n = shape[axis]
                flux = self.flux_buf[: kf.numel()].view(kf.shape)
                torch.sub(T.narrow(axis, 1, n - 1), T.narrow(axis, 0, n - 1), out=flux)
                flux.mul_(kf)  # k * dT across each interior face
                # div at cell c = flux(c, c+1) - flux(c-1, c): the add of the
                # face above first, then the subtraction of the face below, as
                # (div + pad_out) - pad_in; the walls carry no flux
                div.narrow(axis, 0, n - 1).add_(flux)
                div.narrow(axis, 1, n - 1).sub_(flux)
            div.div_(self.dx2).mul_(inv_rc)
            T.add_(div).add_(q_term)

        return step


def make_thermal_step(p: Params, tm: ThermalMaterials, q, dt: float, device="cuda"):
    """``step(T)``: one FTCS step of ``T`` in place (insulated walls), on
    ``device``.

    ``q``: (maxk, maxj, maxi) volumetric power density (W/m^3), e.g.
    ``power_acc / t_em`` from an EM ``--sar`` run.  ``T`` is a contiguous
    tensor of :func:`thermal_dtype` on ``device``.  The update is linear
    in ``T`` and a uniform constant carries no flux, so stepping a rise
    above any uniform ambient is stepping the temperature.
    """
    return _Operator(p, tm, q, device).step(dt)


@dataclasses.dataclass
class ThermalResult:
    rise: torch.Tensor  # (maxk, maxj, maxi) rise above ambient, degrees K, on the solve's device
    ambient: float
    dt: float
    steps: int

    @property
    def temperature(self) -> np.ndarray:
        """Absolute temperature (degrees C), reconstructed in fp64 on the
        host from the rise (small rises keep their full resolution)."""
        return self.rise.detach().to(device="cpu", dtype=torch.float64).numpy() + self.ambient


def run_thermal(p: Params, tm: ThermalMaterials, q, duration: float, ambient: float = 20.0,
                dt: float | None = None, t0=None, device="cuda") -> ThermalResult:
    """Integrate the heat equation for ``duration`` seconds on ``device``.

    ``q``: volumetric power density (W/m^3); ``t0``: initial temperature
    field (defaults to uniform ``ambient``).  ``n_full`` steps of ``dt``
    (:func:`stable_dt` when None), then one shortened step that lands
    exactly on ``duration``.  The state is the rise ``T - ambient``, in
    fp64 when ``p.dtype`` is float64, else fp32.
    """
    if duration <= 0:
        raise ValueError("thermal duration must be positive")
    dev = torch.device(device)
    dt_s = stable_dt(p, tm) if dt is None else float(dt)
    n_full = int(duration / dt_s)
    rem = duration - n_full * dt_s
    dtype = thermal_dtype(p)
    shape = (p.maxk, p.maxj, p.maxi)
    if t0 is None:
        D = torch.zeros(shape, dtype=dtype, device=dev)
    else:
        D = torch.tensor(np.asarray(t0, np.float64) - ambient, dtype=dtype, device=dev)
    op = _Operator(p, tm, q, dev)  # q*(dt/rho_c) forms in fp64 on the host
    if n_full:
        step = op.step(dt_s)
        for _ in range(n_full):
            step(D)
    do_rem = rem > 1e-12 * duration
    if do_rem:
        op.step(rem)(D)
    return ThermalResult(rise=D, ambient=ambient, dt=dt_s, steps=n_full + do_rem)
