"""Simulation parameters and the params.txt-compatible parser.

The reference reads 8 whitespace-separated scalars in a fixed order
(reference: main.c:216-242): length, width, height, spatial_step, time_step,
simulation_time, sampling_rate, mode.  C parses the three box dimensions and
the simulation time with ``%f`` (single precision) and the two steps with
``%lf`` (double), and the mode with ``%x`` (hex).  Grid sizes are then
``maxi = (size_t)(length / spatial_step)`` with the float32 value promoted
to double (reference: main.c:237-239).  These semantics are observable (grid
size, step count and source phase depend on them), so they are reproduced
exactly, as in :mod:`fdtd_tpu.params`.

Pure Python and numpy: nothing here touches a device.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Sequence

import numpy as np

from .constants import CELERITY


class Mode(enum.IntEnum):
    """Run mode (reference: main.c:37-41)."""

    VALIDATION = 0
    COMPUTATION = 1


@dataclasses.dataclass(frozen=True)
class SourceConfig:
    """TE10 waveguide-port source on the z=0 wall.

    Defaults replicate the constants hardcoded in the reference
    (reference: main.c:720-739): a 5 mm x 5 mm patch centered in the z=0
    plane, driven at ``frequency`` (the code uses 2.45e10).  ``envelope``
    "gaussian" modulates the carrier by exp(-(t - delay)^2 / (2 width^2));
    ``pulse_width`` defaults to 2 carrier periods and ``pulse_delay`` to
    3 widths.
    """

    frequency: float = 2.45e10
    aprime: float = 0.005
    bprime: float = 0.005
    envelope: str = "cw"
    pulse_width: float | None = None
    pulse_delay: float | None = None


@dataclasses.dataclass(frozen=True)
class Params:
    """Scene configuration (reference: main.c:57-71).

    ``length``/``width``/``height``/``simulation_time`` carry float32-rounded
    values (C stores them in ``float``).  ``spatial_step``/``time_step`` are
    double.  ``dtype`` names the field storage type: float32, float64 or
    bfloat16.
    """

    length: float
    width: float
    height: float
    spatial_step: float
    time_step: float
    simulation_time: float
    sampling_rate: int
    mode: Mode
    dtype: str = "float32"
    source: SourceConfig = dataclasses.field(default_factory=SourceConfig)

    # Derived grid sizes (reference: main.c:237-239).
    @property
    def maxi(self) -> int:
        return int(self.length / self.spatial_step)

    @property
    def maxj(self) -> int:
        return int(self.width / self.spatial_step)

    @property
    def maxk(self) -> int:
        return int(self.height / self.spatial_step)

    @property
    def padded_shape(self) -> tuple[int, int, int]:
        """Uniform (k, j, i) shape that holds every staggered component.

        All six Yee components live in arrays of this one shape, i fastest;
        each component's physical region is a sub-box of it (see
        :mod:`fdtd_tpu_torch.grid`).
        """
        return (self.maxk + 1, self.maxj + 1, self.maxi + 1)

    @property
    def cell_count(self) -> int:
        return self.maxi * self.maxj * self.maxk

    def cfl_limit(self) -> float:
        """Taflove CFL bound on dt for a uniform cubic grid:
        c*dt <= (1/dx^2 + 1/dy^2 + 1/dz^2)^(-1/2)."""
        d = self.spatial_step
        return d / (CELERITY * math.sqrt(3.0))

    def is_cfl_stable(self) -> bool:
        return self.time_step <= self.cfl_limit()

    def validate(self) -> None:
        if self.time_step <= 0:
            # The reference hangs forever on dt <= 0 (main.c:765).
            raise ValueError("The time step must be positive!")
        if self.time_step > self.simulation_time:
            # Same sanity check as reference main.c:818-821.
            raise ValueError("The time step must be lower than the simulation time!")
        if min(self.maxi, self.maxj, self.maxk) < 2:
            raise ValueError("Grid too small: need at least 2 cells per axis")


def _c_float(tok: str) -> float:
    """Parse like C ``%f`` into float, then promote (round through float32)."""
    return float(np.float32(tok))


def parse_params_text(text: str, **overrides) -> Params:
    """Parse the 8 ordered scalars of a params.txt (reference: main.c:226-233)."""
    toks: Sequence[str] = text.split()
    if len(toks) < 8:
        raise ValueError(f"params.txt needs 8 values, got {len(toks)}")
    return Params(
        length=_c_float(toks[0]),
        width=_c_float(toks[1]),
        height=_c_float(toks[2]),
        spatial_step=float(toks[3]),
        time_step=float(toks[4]),
        simulation_time=_c_float(toks[5]),
        sampling_rate=int(toks[6]),
        mode=Mode(int(toks[7], 16)),  # %x quirk: mode parsed as hex (main.c:233)
        **overrides,
    )


def load_parameters(path: str, **overrides) -> Params:
    with open(path) as f:
        return parse_params_text(f.read(), **overrides)


def time_values(p: Params) -> np.ndarray:
    """Exact sequence of time_counter values of the reference loop.

    The C main loop accumulates ``time_counter += time_step`` in double and runs
    while ``time_counter <= simulation_time`` (reference: main.c:765).
    Python floats are C doubles, so this loop reproduces the iteration count
    and the per-step source phases bit-exactly.
    """
    ts = []
    t = 0.0
    limit = p.simulation_time
    while t <= limit:
        ts.append(t)
        t += p.time_step
    return np.asarray(ts, dtype=np.float64)


def num_steps(p: Params) -> int:
    return len(time_values(p))
