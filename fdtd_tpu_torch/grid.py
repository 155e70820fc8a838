"""Yee-grid stagger specification.

Every component lives in one uniform (maxk+1, maxj+1, maxi+1) tensor, axis
order (k, j, i) with i fastest, and the stagger is each component's physical
extent inside that box.  Entries outside the physical extent are padding:
zero, and never read or written by the update rules.

Physical extents (reference allocation sizes, main.c:299-355), in (k, j, i):

    Ex: (K+1, J+1, I  )      Hx: (K,   J,   I+1)
    Ey: (K+1, J,   I+1)      Hy: (K,   J+1, I  )
    Ez: (K,   J+1, I+1)      Hz: (K+1, J,   I  )

with I=maxi, J=maxj, K=maxk.  This is also the port's hot layout: the
kernels update these tensors in place, so no conversion stands between the
step loop and snapshots or checkpoints.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params import Params

E_COMPONENTS = ("ex", "ey", "ez")
H_COMPONENTS = ("hx", "hy", "hz")
COMPONENTS = E_COMPONENTS + H_COMPONENTS


@dataclasses.dataclass(frozen=True)
class Extents:
    """Per-component physical (k, j, i) extents inside the padded box."""

    ex: tuple[int, int, int]
    ey: tuple[int, int, int]
    ez: tuple[int, int, int]
    hx: tuple[int, int, int]
    hy: tuple[int, int, int]
    hz: tuple[int, int, int]


def extents(p: Params) -> Extents:
    I, J, K = p.maxi, p.maxj, p.maxk
    return Extents(
        ex=(K + 1, J + 1, I),
        ey=(K + 1, J, I + 1),
        ez=(K, J + 1, I + 1),
        hx=(K, J, I + 1),
        hy=(K, J + 1, I),
        hz=(K + 1, J, I),
    )


# Export/aggregation offsets, (ofi, ofj, ofk) per component
# (reference: main.c:563-579).
E_AGG_OFFSETS = {"ex": (0, 1, 1), "ey": (1, 0, 1), "ez": (1, 1, 0)}
H_AGG_OFFSETS = {"hx": (1, 0, 0), "hy": (0, 1, 0), "hz": (0, 0, 1)}


def aggregate_e(p: Params, f: torch.Tensor, name: str,
                k_range: tuple[int, int] | None = None) -> torch.Tensor:
    """Cell-center aggregation of an E component (reference: main.c:511-521),
    over the cell planes ``k_range`` = (k_lo, k_hi) of ``f`` (default: all;
    a slab's cells are the same rows of the whole grid's, bit for bit).

    Replicates the reference's 4-term average including its quirk: the term
    list is F[i,j,k], F[i+oi,j+oj,k+ok], F[i,j+oj,k+ok], F[i+oi,j,k+ok], so
    for Ex (oi=0) two terms coincide and the result is
    .25*(F + 2*F[j+1,k+1] + F[k+1]) rather than a 4-corner mean.
    """
    oi, oj, ok = E_AGG_OFFSETS[name]
    J, I = p.maxj, p.maxi
    k_lo, k_hi = k_range or (0, p.maxk)

    def sl(di, dj, dk):
        return f[k_lo + dk : k_hi + dk, dj : dj + J, di : di + I]

    return 0.25 * (sl(0, 0, 0) + sl(oi, oj, ok) + sl(0, oj, ok) + sl(oi, 0, ok))


def aggregate_h(p: Params, f: torch.Tensor, name: str,
                k_range: tuple[int, int] | None = None) -> torch.Tensor:
    """Cell-center aggregation of an H component (reference: main.c:532-540),
    over the cell planes ``k_range`` (default: all)."""
    oi, oj, ok = H_AGG_OFFSETS[name]
    J, I = p.maxj, p.maxi
    k_lo, k_hi = k_range or (0, p.maxk)

    def sl(di, dj, dk):
        return f[k_lo + dk : k_hi + dk, dj : dj + J, di : di + I]

    return 0.5 * (sl(0, 0, 0) + sl(oi, oj, ok))


def node_coords(p: Params):
    """Rectilinear node coordinates i*dx (reference: main.c:250-288)."""
    dx = p.spatial_step
    x = np.arange(p.maxi + 1, dtype=np.float64) * dx
    y = np.arange(p.maxj + 1, dtype=np.float64) * dx
    z = np.arange(p.maxk + 1, dtype=np.float64) * dx
    return x, y, z
