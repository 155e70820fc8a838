"""CFL stability mapping: the reference's empirical sweep as one function.

Counterpart of ``fdtd_tpu/utils/stability.py``.  The reference validated
the Yee/Taflove stability bound by launching runs at (ds, dt) points and
killing the ones whose energy diverged (description.pdf section 3.1, Fig.
7); here each dt gets a short probe run from the TE101 seed on the torch
ops, classified by its total-energy growth against the analytic bound.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import diagnostics
from ..params import Params
from ..state import init_validation
from ..step import make_chunk_runner, scan_inputs


@dataclasses.dataclass
class StabilityPoint:
    time_step: float
    cfl_ratio: float  # c*dt*sqrt(3)/dx (1.0 = bound)
    stable_predicted: bool
    stable_observed: bool
    energy_growth: float  # E_end / E_0


def stability_map(p: Params, time_steps, n_steps: int = 60, growth_bar: float = 10.0,
                  device="cuda") -> list[StabilityPoint]:
    """Probe each dt for ``n_steps`` on ``device`` and classify by
    total-energy growth."""
    out = []
    for dt_ in time_steps:
        pp = dataclasses.replace(p, time_step=float(dt_), simulation_time=float(dt_) * n_steps * 2)
        run = make_chunk_runner(pp, device)
        s = init_validation(pp, device)
        e0 = float(diagnostics.total_energy(pp, s))
        ts = np.arange(n_steps, dtype=np.float64) * pp.time_step
        run(s, scan_inputs(pp, ts))
        e1 = float(diagnostics.total_energy(pp, s))
        growth = e1 / e0 if e0 > 0 else float("inf")
        out.append(
            StabilityPoint(
                time_step=float(dt_),
                cfl_ratio=float(dt_) / pp.cfl_limit(),
                stable_predicted=pp.is_cfl_stable(),
                stable_observed=bool(np.isfinite(growth) and growth < growth_bar),
                energy_growth=growth,
            )
        )
    return out
