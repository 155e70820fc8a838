"""TE10 waveguide-port source injection (reference: main.c:712-753).

Computation mode hard-sets, on an a'xb' patch centered in the z=0 wall:

    Ez = sin(2*pi*f*t) * sin(pi * shift_i*dx / a')
    Hx = -(1/Z_te) * sin(2*pi*f*t) * sin(pi * shift_i*dx / a')
    Ex = Hz = 0

The patch bounds replicate the reference, including the +-1 index slop:
min_j = (int)(min_y/dx) - 1, max_j = (int)(max_y/dx) + 1 (main.c:729-733).
Z_te is derived from width/length (main.c:737-739).

The drive amplitude of each step is computed on the host in fp64
(:func:`drive_values`); :func:`apply_source` multiplies it by the profile in
fp64 on the device and rounds once to the field dtype, as the JAX package
does, so the injected values are bit-identical.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .constants import CELERITY, EPSILON, MU, PI
from .grid import Box
from .params import Params
from .state import FieldState


@dataclasses.dataclass(frozen=True)
class SourcePlan:
    """Static patch geometry and drive constants."""

    i0: int
    i1: int
    j0: int
    j1: int
    frequency: float
    inv_z_te: float
    profile: tuple[float, ...]  # sin(pi * shift_i * dx / a') per i in [i0, i1)
    envelope: str = "cw"
    pulse_width: float = 0.0  # gaussian sigma (s)
    pulse_delay: float = 0.0  # gaussian center (s)

    @property
    def patch(self) -> tuple[int, int, int, int]:
        """(j0, j1, i0, i1): the k=0 rectangle the source hard-sets."""
        return (self.j0, self.j1, self.i0, self.i1)


def make_source_plan(p: Params) -> SourcePlan:
    cfg = p.source
    aprime, bprime = cfg.aprime, cfg.bprime
    dx = p.spatial_step

    min_y = p.width / 2.0 - aprime / 2.0
    max_y = min_y + aprime
    min_x = p.length / 2.0 - bprime / 2.0
    max_x = min_x + bprime

    j0 = int(min_y / dx) - 1
    j1 = int(max_y / dx) + 1
    i0 = int(min_x / dx) - 1
    i1 = int(max_x / dx) + 1
    if i0 < 0 or j0 < 0 or i1 > p.maxi or j1 > p.maxj:
        raise ValueError(
            f"source patch [{i0}:{i1})x[{j0}:{j1}) exceeds the grid "
            f"({p.maxi}x{p.maxj}); the reference would index out of bounds here"
        )

    f_mnl = 0.5 * CELERITY * math.sqrt((PI / p.width) ** 2 + (PI / p.length) ** 2) / PI
    omega = 2.0 * PI * f_mnl
    z_te = (omega * MU) / math.sqrt(omega**2 * MU * EPSILON - (PI / p.width) ** 2)

    profile = tuple(math.sin(PI * (shift_i * dx) / aprime) for shift_i in range(i1 - i0))
    env = cfg.envelope
    if env not in ("cw", "gaussian"):
        raise ValueError(f"unknown source envelope {env!r}: use cw or gaussian")
    width = delay = 0.0
    if env == "gaussian":
        width = cfg.pulse_width if cfg.pulse_width is not None else 2.0 / cfg.frequency
        if width <= 0:
            raise ValueError("source pulse width must be positive")
        delay = cfg.pulse_delay if cfg.pulse_delay is not None else 3.0 * width
    elif cfg.pulse_width is not None or cfg.pulse_delay is not None:
        raise ValueError(
            "source pulse width/delay need envelope='gaussian' (--source-envelope gaussian)"
        )
    return SourcePlan(i0, i1, j0, j1, cfg.frequency, 1.0 / z_te, profile,
                      envelope=env, pulse_width=width, pulse_delay=delay)


def drive_values(plan: SourcePlan, times) -> np.ndarray:
    """Per-step drive amplitudes sin(2*pi*f*t) in host fp64 (main.c:748),
    times the gaussian envelope when one is configured."""
    t = np.asarray(times, dtype=np.float64)
    amp = np.sin((2.0 * PI * plan.frequency) * t)
    if plan.envelope == "gaussian":
        amp = amp * np.exp(-((t - plan.pulse_delay) ** 2) / (2.0 * plan.pulse_width**2))
    return amp


def profile_tensor(plan: SourcePlan, device) -> torch.Tensor:
    """The patch profile as an fp64 tensor on ``device``."""
    return torch.tensor(plan.profile, dtype=torch.float64, device=device)


def apply_source(plan: SourcePlan, s: FieldState, amp, profile: torch.Tensor, box: Box | None = None) -> None:
    """Hard-set the source patch in place.

    ``amp`` is sin(2*pi*f*t) as a Python float or a 0-d fp64 tensor on the
    state's device; ``profile`` is :func:`profile_tensor`.  The row is
    formed in fp64 and rounded once to the field dtype.  With ``box`` (a
    shard's arrays) the part of the patch those arrays hold, halos
    included.
    """
    sl = (0, slice(plan.j0, plan.j1), slice(plan.i0, plan.i1))
    if box is not None:
        local = box.patch(plan.patch)
        if local is None:
            return
        sl, profile = (0,) + local[0], profile[local[1]]
    row = amp * profile  # (ni,), value depends on i only (main.c:748)
    s.ez[sl].copy_(row.expand(s.ez[sl].shape))
    s.ex[sl].zero_()
    s.hz[sl].zero_()
    s.hx[sl].copy_((-plan.inv_z_te * row).expand(s.hx[sl].shape))


def apply_source_batch(plan: SourcePlan, states: FieldState, amps: torch.Tensor, profile: torch.Tensor) -> None:
    """:func:`apply_source` on every member of a batch (six (N, K+1, J+1,
    I+1) tensors) at once: ``amps`` the members' (N,) fp64 amplitudes on
    the device.  Each member's row is formed in fp64 and rounded once, the
    values :func:`apply_source` sets member by member."""
    sl = (slice(None), 0, slice(plan.j0, plan.j1), slice(plan.i0, plan.i1))
    row = amps[:, None] * profile  # (N, ni)
    shape = states.ez[sl].shape
    states.ez[sl].copy_(row[:, None, :].expand(shape))
    states.ex[sl].zero_()
    states.hz[sl].zero_()
    states.hx[sl].copy_((-plan.inv_z_te * row)[:, None, :].expand(shape))


def sweep_drive_rows(plan: SourcePlan, amps: torch.Tensor, s: int, dtype: torch.dtype,
                     profile: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The hard-set rows of steps 2..s of every s-step sweep of a chunk.

    ``amps`` holds the chunk's drive amplitudes (fp64, on the device);
    the chunk's ``len(amps) // s`` sweeps each take the amplitudes of
    their steps 2..s.  Returns ``(ez_rows, hx_rows)``, each of shape
    (sweeps, s - 1, i1 - i0) in ``dtype``: the Ez and Hx values of
    :func:`apply_source`, formed in fp64 and rounded once, so a sweep
    injects the same bits as s single steps.  (Step 1 of a sweep is
    :func:`apply_source` on the state itself.)
    """
    n = amps.shape[0] // s
    a = amps[: n * s].reshape(n, s)[:, 1:, None]
    row = a * profile
    return row.to(dtype), (-plan.inv_z_te * row).to(dtype)
