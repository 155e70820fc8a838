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


@dataclasses.dataclass(frozen=True)
class Box:
    """A part of the padded (K+1, J+1, I+1) grid held in arrays of its own
    (a shard of :mod:`fdtd_tpu_torch.parallel`): the arrays hold the global
    (k, j, i) planes ``lo`` (inclusive) to ``hi`` (exclusive) per axis, of
    which the part owns (updates and emits) ``own_lo`` to ``own_hi``; the
    rest are halo planes, copies of a neighbour's.  The whole grid is
    :func:`full_box`: one part that owns everything."""

    lo: tuple[int, int, int]
    hi: tuple[int, int, int]
    own_lo: tuple[int, int, int]
    own_hi: tuple[int, int, int]

    @property
    def shape(self) -> tuple[int, int, int]:
        """The local arrays' extents."""
        return tuple(h - lo for lo, h in zip(self.lo, self.hi))

    def local(self, lo: tuple[int, ...], hi: tuple[int, ...]) -> tuple[slice, slice, slice]:
        """The local slices of the global range [lo, hi) (per axis)."""
        return tuple(slice(a - o, b - o) for a, b, o in zip(lo, hi, self.lo))

    @property
    def owned(self) -> tuple[slice, slice, slice]:
        """The local slices of the owned planes."""
        return self.local(self.own_lo, self.own_hi)

    def cells(self, p: Params) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
        """The global (lo, hi) of the cells this part owns (the cells of its
        owned planes below (maxk, maxj, maxi)): its part of the SAR map."""
        top = (p.maxk, p.maxj, p.maxi)
        return self.own_lo, tuple(min(h, t) for h, t in zip(self.own_hi, top))

    def cell_shape(self, p: Params) -> tuple[int, int, int]:
        lo, hi = self.cells(p)
        return tuple(b - a for a, b in zip(lo, hi))

    def patch(self, patch: tuple[int, int, int, int]) -> tuple[tuple[slice, slice], slice] | None:
        """The source patch (j0, j1, i0, i1) of the k=0 plane within the
        local arrays: ((j slice, i slice), the i range of the patch's own
        row as a slice of it), or None where the arrays miss it."""
        j0, j1, i0, i1 = patch
        ja, jb = max(j0, self.lo[1]), min(j1, self.hi[1])
        ia, ib = max(i0, self.lo[2]), min(i1, self.hi[2])
        if self.lo[0] > 0 or ja >= jb or ia >= ib:
            return None
        return ((slice(ja - self.lo[1], jb - self.lo[1]), slice(ia - self.lo[2], ib - self.lo[2])),
                slice(ia - i0, ib - i0))

    def is_full(self, p: Params) -> bool:
        return self == full_box(p)


def full_box(p: Params) -> Box:
    """The whole padded grid as one part."""
    hi = p.padded_shape
    return Box((0, 0, 0), hi, (0, 0, 0), hi)


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
