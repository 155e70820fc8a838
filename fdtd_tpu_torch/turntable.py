"""Turntable rotation: the load moves through the standing-wave pattern.

Counterpart of ``fdtd_tpu/turntable.py``, numpy on the host, the same
values bit for bit.

The one mechanical feature that defines a domestic microwave oven —
the reference (vacuum cavity, main.c:441,479) never models a load at
all, and a static load in a closed cavity heats wherever the mode
antinodes happen to intersect it.  Real ovens rotate the food through
the fixed interference pattern so the time-averaged deposition becomes
azimuthally smeared; simulating that is the difference between "the
field pattern" and "will the mug boil evenly".

Multi-rate treatment, same operator splitting as the EM<->thermal
coupling (``coupled.run_coupled``): the turntable period (~6 s/rev) is
glacial on the EM timescale (ns) and slow even on the thermal one, so
each quasi-static interval freezes the load at its mid-interval angle,
runs the EM solve there, and integrates heat in the load's co-rotating
material frame:

- the load GEOMETRY is rasterized fresh at each angle
  (:func:`geometry_mask` — the staircase mask of the rotated shape,
  not a resampled mask image, so the load never erodes over turns);
- the TEMPERATURE field lives in the material frame (attached to the
  food, where heat diffusion physically happens) and is rotated into
  the lab frame only to evaluate the temperature-dependent dielectrics;
- the deposited POWER map is computed in the lab frame and rotated
  back into the material frame (bilinear resample, integral-preserving
  rescale) before the thermal advance.

Rotating Q (a smooth source term) instead of T avoids compounding
resample diffusion into the temperature state over many intervals.

Angles are mid-interval (theta_i = omega * (i + 1/2) * t_int), so the
rpm -> 0 limit reduces continuously to the static coupled run.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .params import Params


@dataclasses.dataclass(frozen=True)
class LoadGeometry:
    """A parametric load shape that can be rasterized at any turntable
    angle.  All lengths are fractions of the oven box (the convention of
    ``state.block_mask``/``sphere_mask``/``cylinder_mask``); the shape
    is tested against CELL CENTERS on every axis (staircase FDTD
    rasterization), which for boxes can differ by one edge layer from
    ``block_mask``'s index-truncation slicing — the geometry path is
    self-consistent across angles, which is what rotation needs.

    ``center``: the load's own (x, y) center.  ``z_lo``/``z_hi``: the
    vertical extent (box, cylinder); ``z_center`` the sphere's vertical
    center.  ``half_x``/``half_y``: box half-extents as x/y fractions.
    ``radius``: sphere/cylinder radius as a fraction of the shortest
    relevant side (matching the ``state`` mask helpers)."""

    shape: str = "box"  # box | sphere | cylinder
    center: tuple[float, float] = (0.5, 0.5)
    radius: float = 0.2
    half_x: float = 0.2
    half_y: float = 0.2
    z_lo: float = 0.3
    z_hi: float = 0.7
    z_center: float = 0.5

    def __post_init__(self):
        if self.shape not in ("box", "sphere", "cylinder"):
            raise ValueError(f"unknown load shape {self.shape!r}")


def geometry_mask(
    p: Params,
    geom: LoadGeometry,
    theta: float = 0.0,
    axis_center: tuple[float, float] = (0.5, 0.5),
) -> np.ndarray:
    """Boolean cell mask of ``geom`` rotated by ``theta`` radians
    (counterclockwise in the (x, y) floor plane, viewed from above)
    about the vertical turntable axis at ``axis_center`` (x, y
    fractions).

    Rasterizes the ROTATED SHAPE analytically — each cell center is
    inverse-rotated into the load's own frame and tested there — so a
    full revolution returns exactly the theta=0 mask and the staircase
    volume stays constant to within one boundary-cell layer at every
    angle.
    """
    K, J, I = p.maxk, p.maxj, p.maxi
    x = (np.arange(I) + 0.5) / I * p.length
    y = (np.arange(J) + 0.5) / J * p.width
    z = (np.arange(K) + 0.5) / K * p.height
    ax = axis_center[0] * p.length
    ay = axis_center[1] * p.width
    c, s = math.cos(theta), math.sin(theta)
    X = x[None, :] - ax  # (1, I)
    Y = y[:, None] - ay  # (J, 1)
    # inverse rotation R(-theta): lab point -> load-frame point
    xr = ax + c * X + s * Y  # (J, I)
    yr = ay - s * X + c * Y
    cx = geom.center[0] * p.length
    cy = geom.center[1] * p.width
    if geom.shape == "box":
        hx = geom.half_x * p.length
        hy = geom.half_y * p.width
        disk = (np.abs(xr - cx) <= hx) & (np.abs(yr - cy) <= hy)
        kz = (z >= geom.z_lo * p.height) & (z < geom.z_hi * p.height)
        return disk[None, :, :] & kz[:, None, None]
    if geom.shape == "cylinder":
        r = geom.radius * min(p.length, p.width)
        disk = (xr - cx) ** 2 + (yr - cy) ** 2 <= r * r
        kz = (z >= geom.z_lo * p.height) & (z < geom.z_hi * p.height)
        return disk[None, :, :] & kz[:, None, None]
    # sphere
    r = geom.radius * min(p.length, p.width, p.height)
    dz = z - geom.z_center * p.height
    d2 = (xr - cx) ** 2 + (yr - cy) ** 2
    return d2[None, :, :] + (dz * dz)[:, None, None] <= r * r


def rotate_field(
    p: Params,
    arr: np.ndarray,
    theta: float,
    axis_center: tuple[float, float] = (0.5, 0.5),
    fill: float = 0.0,
) -> np.ndarray:
    """Rotate a cell-centered (maxk, maxj, maxi) scalar field by
    ``theta`` radians about the vertical turntable axis — bilinear
    resampling in the (x, y) plane, every k slice at once.

    The value at each output cell center is sampled at its
    inverse-rotated source point; samples falling outside the grid get
    ``fill`` (ambient temperature for T, 0 for power maps).  theta=0 is
    an exact identity; rotations that map cell centers onto cell
    centers (e.g. 90-degree multiples about the center of a square
    floor plan) are exact permutations.
    """
    arr = np.asarray(arr, np.float64)
    K, J, I = arr.shape
    if theta == 0.0:
        return arr.copy()
    x = (np.arange(I) + 0.5) / I * p.length
    y = (np.arange(J) + 0.5) / J * p.width
    ax = axis_center[0] * p.length
    ay = axis_center[1] * p.width
    c, s = math.cos(theta), math.sin(theta)
    X = x[None, :] - ax
    Y = y[:, None] - ay
    xs = ax + c * X + s * Y  # (J, I) source points, physical
    ys = ay - s * X + c * Y
    # index conversion uses the SAME pitch (length/I, width/J) as the
    # coordinate arrays above and geometry_mask: params derives
    # maxi = int(length/spatial_step) from a float32-parsed length, so
    # length is generally NOT maxi*spatial_step (e.g. float32(0.06) gives
    # maxi=59) — dividing by spatial_step here would carry a systematic
    # radial scale error that breaks the exact 90-degree permutation
    si = xs / (p.length / I) - 0.5  # fractional source indices
    sj = ys / (p.width / J) - 0.5
    # a source point within half a cell outside the boundary still has
    # meaningful clamped-edge interpolation; beyond that it is `fill`
    valid = (si >= -0.5) & (si <= I - 0.5) & (sj >= -0.5) & (sj <= J - 0.5)
    i0 = np.floor(si).astype(np.int64)
    j0 = np.floor(sj).astype(np.int64)
    wi = si - i0
    wj = sj - j0
    i0c = np.clip(i0, 0, I - 1)
    i1c = np.clip(i0 + 1, 0, I - 1)
    j0c = np.clip(j0, 0, J - 1)
    j1c = np.clip(j0 + 1, 0, J - 1)
    out = (
        (1.0 - wj) * (1.0 - wi) * arr[:, j0c, i0c]
        + (1.0 - wj) * wi * arr[:, j0c, i1c]
        + wj * (1.0 - wi) * arr[:, j1c, i0c]
        + wj * wi * arr[:, j1c, i1c]
    )
    return np.where(valid[None, :, :], out, float(fill))
