"""On-the-fly DFT of the fields: steady-state phasors without storage.

The port of ``fdtd_tpu/dft.py``: the running sums

    E_hat(f) = (2/N) * sum_n E(t_n) * exp(-i 2 pi f t_n)

per cell, accumulated during the time loop, give the complex steady-state
field pattern at each frequency, its magnitude map and the cycle-averaged
CW power deposition 1/2 sigma |E_hat|^2.

The quadrature weights cos/sin(2 pi f t_n) are computed on the host in
fp64 and stored in fp32 (:func:`dft_weights`); the (re, im) sums are fp32
tensors of shape (nf, nc, maxk, maxj, maxi) on the run's device
(:func:`zero_dft_acc`), whatever the field dtype.  One step adds
``re + cw*E`` and ``im - sw*E`` for the cell-centered means of the final
state of that step (:func:`accumulate`), each product and sum rounded on
its own in fp32.  The E sums of a per-step backend come from the
``dft_accum`` kernel (:mod:`fdtd_tpu_torch.ops.dft`), of the ``stream``
backend from the DFT bands of the sweep; the H sums of ``fields="eh"`` are
torch ops (:mod:`fdtd_tpu_torch.monitors`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params import Params

# the backends with per-step states (the JAX package's xla, pallas and
# pallas_fused)
PER_STEP_BACKENDS = ("torch", "twopass")


@dataclasses.dataclass(frozen=True)
class DftConfig:
    """Frequencies (Hz) to accumulate; phasors at cell centers.

    ``fields``: "e" (Ex, Ey, Ez, the default) or "eh" (all six components,
    for the cycle-averaged Poynting vector S = 1/2 Re(E x H*))."""

    frequencies: tuple
    fields: str = "e"

    def __post_init__(self):
        fs = tuple(float(f) for f in self.frequencies)
        if not fs:
            raise ValueError("DFT needs at least one frequency")
        if any(f <= 0 for f in fs):
            raise ValueError("DFT frequencies must be positive Hz")
        object.__setattr__(self, "frequencies", fs)
        if self.fields not in ("e", "eh"):
            raise ValueError("DFT fields must be 'e' or 'eh'")

    @property
    def nf(self) -> int:
        return len(self.frequencies)

    @property
    def nc(self) -> int:
        return 6 if self.fields == "eh" else 3


def dft_weights(dft: DftConfig, times) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) weight arrays of shape (n_steps, nf): fp64 phase on the
    host, fp32 storage."""
    t = np.asarray(times, np.float64)[:, None]
    f = np.asarray(dft.frequencies, np.float64)[None, :]
    ph = 2.0 * np.pi * f * t
    return np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)


def acc_shape(p: Params, dft: DftConfig) -> tuple[int, int, int, int, int]:
    return (dft.nf, dft.nc, p.maxk, p.maxj, p.maxi)


def acc_bytes(p: Params, dft: DftConfig) -> int:
    """Device bytes of the (re, im) fp32 sums."""
    return 8 * dft.nf * dft.nc * p.maxk * p.maxj * p.maxi


def zero_dft_acc(p: Params, dft: DftConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(re, im) sums, each (nf, nc, maxk, maxj, maxi) fp32 on ``device``,
    zero; component order (Ex, Ey, Ez[, Hx, Hy, Hz]) at cell centers."""
    shape = acc_shape(p, dft)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def accumulate(cells, cw: torch.Tensor, sw: torch.Tensor, acc, c0: int = 0) -> None:
    """One step of the running sums in place, for the components ``c0``,
    ``c0 + 1``, ... of ``acc``: ``re += cw*F`` and ``im -= sw*F`` (so
    re + i*im = sum F exp(-i w t)), the association of
    ``fdtd_tpu.dft.accumulate``.  ``cells``: cell-mean arrays (cast to
    fp32); ``cw``/``sw``: the (nf,) fp32 weights of the step, on the sums'
    device."""
    re, im = acc
    F = torch.stack([c.to(torch.float32) for c in cells])[None]  # (1, n, K, J, I)
    sl = slice(c0, c0 + F.shape[1])
    re[:, sl] += cw[:, None, None, None, None] * F
    im[:, sl] -= sw[:, None, None, None, None] * F


@dataclasses.dataclass
class DftResult:
    frequencies: tuple
    # complex phasors (nf, nc, maxk, maxj, maxi), (2/N)-normalized so a
    # steady A*cos(2 pi f t + phi) component reads |.| = A; components 3:6
    # (fields="eh") carry the leapfrog half-step correction (finalize)
    phasors: np.ndarray
    steps: int
    fields: str = "e"

    def magnitude(self, fi: int = 0) -> np.ndarray:
        """|E| magnitude map (sqrt of the sum over E components) at
        frequency index ``fi``."""
        ph = self.phasors[fi, :3]
        return np.sqrt((np.abs(ph) ** 2).sum(axis=0))

    def cw_power(self, sigma_cells, fi: int = 0) -> np.ndarray:
        """Cycle-averaged CW power deposition 1/2 sigma |E_hat|^2 (W/m^3)
        at frequency index ``fi``."""
        ph = self.phasors[fi, :3]
        return 0.5 * np.asarray(sigma_cells) * (np.abs(ph) ** 2).sum(axis=0)

    def poynting(self, fi: int = 0) -> np.ndarray:
        """Cycle-averaged Poynting vector S = 1/2 Re(E x H*) (W/m^2), shape
        (3, maxk, maxj, maxi); needs fields="eh"."""
        if self.fields != "eh":
            raise ValueError("Poynting needs DftConfig(fields='eh')")
        E = self.phasors[fi, :3]
        H = np.conj(self.phasors[fi, 3:])
        return 0.5 * np.real(np.cross(E, H, axis=0))


def finalize(dft: DftConfig, acc, steps: int, time_step: float | None = None) -> DftResult:
    """The 2/N normalization; with fields="eh" the H phasors get the
    leapfrog half-step correction exp(+i w dt/2) (the post-step H samples
    live at t_n - dt/2).  ``acc``: the (re, im) sums as tensors or arrays."""
    re, im = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in acc)
    scale = 2.0 / max(steps, 1)
    phasors = (np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)) * scale
    if dft.fields == "eh":
        if time_step is None:
            raise ValueError("fields='eh' finalize needs time_step")
        w = 2.0 * np.pi * np.asarray(dft.frequencies)
        corr = np.exp(0.5j * w * time_step)[:, None, None, None, None]
        phasors[:, 3:] = phasors[:, 3:] * corr
    return DftResult(frequencies=dft.frequencies, phasors=phasors, steps=steps, fields=dft.fields)


def supported_backend(backend: str) -> bool:
    """Per-step states (the H sums of "eh", probes, validation mode) exist
    on the per-step backends only."""
    return backend in PER_STEP_BACKENDS
