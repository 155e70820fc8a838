"""Point probes and the per-step monitor sampling.

The port of ``fdtd_tpu/monitors.py``.  Probes record per-step time series
of the six cell-centered field components at chosen cells (a probe row is
6 floats, so a series costs nothing beside the update), for resonance and
spectrum analysis (:mod:`fdtd_tpu_torch.utils.spectrum`).

:func:`apply_monitors` is the single definition of the monitor sampling:
every per-step chunk runner (``step.make_chunk_runner`` on ``torch`` and
``twopass``, with materials, CPML or a Debye medium, and the trailing
two-pass steps of ``stream``) calls it on the final state of each step.
It adds the step to the DFT sums (the E sums through the ``dft_accum``
kernel of :mod:`fdtd_tpu_torch.ops.dft`, its plain version on the
``torch`` backend, the H sums of ``fields="eh"`` as torch ops) and
returns the step's probe row, a (n_probes, 6) fp32 tensor on the device
(rows stay there until the chunk ends).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import diagnostics
from .dft import DftConfig, accumulate
from .grid import Box
from .ops import dft as dft_ops
from .params import Params
from .spans import PROBE_GATHER, span
from .state import FieldState

COMPONENTS = ("ex", "ey", "ez", "hx", "hy", "hz")


@dataclasses.dataclass(frozen=True)
class ProbeSet:
    """Cell-centered probe locations as (k, j, i) cell indices."""

    cells: tuple

    def __post_init__(self):
        cells = tuple(tuple(int(c) for c in cell) for cell in self.cells)
        if not cells:
            raise ValueError("ProbeSet needs at least one cell")
        if any(len(c) != 3 for c in cells):
            raise ValueError("probe cells are (k, j, i) index triples")
        object.__setattr__(self, "cells", cells)

    def validate(self, p: Params) -> None:
        for k, j, i in self.cells:
            if not (0 <= k < p.maxk and 0 <= j < p.maxj and 0 <= i < p.maxi):
                raise ValueError(
                    f"probe cell (k={k}, j={j}, i={i}) is outside the "
                    f"{p.maxk}x{p.maxj}x{p.maxi} cell grid"
                )


@dataclasses.dataclass
class ProbeResult:
    cells: tuple  # ((k, j, i), ...)
    times: np.ndarray  # (n,) fp64 step times
    values: np.ndarray  # (n, n_probes, 6) fp32, component order COMPONENTS

    def series(self, probe: int, component: str) -> np.ndarray:
        """One probe's time series for a named component."""
        return self.values[:, probe, COMPONENTS.index(component)]


def probe_row(p: Params, s: FieldState, cells) -> torch.Tensor:
    """(n_probes, 6) fp32 cell-centered field values of one step."""
    rows = []
    for k, j, i in cells:
        kk, jj, ii = slice(k, k + 1), slice(j, j + 1), slice(i, i + 1)
        es = diagnostics._e_cell_means(p, s, kk, jj, ii)
        hs = diagnostics._h_cell_means(p, s, kk, jj, ii)
        rows.append(torch.stack([m[0, 0, 0].to(torch.float32) for m in (*es, *hs)]))
    return torch.stack(rows)


def apply_monitors(p: Params, s: FieldState, weights: torch.Tensor | None, dft: DftConfig | None,
                   cells, dacc, kernel: bool = True, box: Box | None = None) -> torch.Tensor | None:
    """One step of every enabled monitor on the final state ``s`` of the
    step: the DFT sums ``dacc`` in place (``weights``: the step's (2, nf)
    fp32 (cos, sin) row on the device; the E sums through the kernel's
    wrapper, or with ``kernel=False``, as the ``torch`` backend runs them,
    its plain version) and the probe row of ``cells`` (returned; None
    without probes).  With ``box`` (a shard's arrays, their +1 neighbour
    planes filled) the sums are the shard's part over its owned cells and
    ``cells`` are cells of its arrays."""
    if dft is not None:
        (dft_ops.accumulate_e if kernel else dft_ops.plain_accumulate_e)(p, s, weights, dacc, box)
        if dft.fields == "eh":
            owned = box.local(*box.cells(p)) if box is not None else ()
            accumulate(diagnostics._h_cell_means(p, s, *owned), weights[0], weights[1], dacc, c0=3)
    if cells is None:
        return None
    with span(PROBE_GATHER):
        return probe_row(p, s, cells)


def weight_rows(cw: np.ndarray, sw: np.ndarray, device) -> torch.Tensor:
    """The (n, 2, nf) fp32 (cos, sin) rows of a chunk on ``device``: one
    copy per chunk, sliced per step or per sweep."""
    return torch.as_tensor(np.stack([np.asarray(cw, np.float32), np.asarray(sw, np.float32)], axis=1),
                           device=device)
