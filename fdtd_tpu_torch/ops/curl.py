"""Yee leapfrog curl updates as plain torch slice arithmetic.

These are the plain versions of the two Hopper kernels in
:mod:`fdtd_tpu_torch.ops.yee` (H pass and E pass), and the update of the
``torch`` backend on any device.  They follow the slices and the operation
order of :mod:`fdtd_tpu.ops.curl` (reference: main.c:431-462 update_H,
main.c:469-500 update_E): the E bounds start at 1 and stop before max, which
leaves tangential E on all six walls untouched, the implicit PEC boundary.

Arithmetic type: fp64 fields compute in fp64 and fp32 in fp32; bf16 fields
are read as fp32, computed in fp32 and rounded back to bf16 once per update,
as the TPU kernels do.  Both functions update the state in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import Params
from ..state import FieldState, UpdateCoefs


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


def scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to the compute type of ``dtype``, as a Python float
    (an fp32 coefficient must be the same fp32 number on every path)."""
    return float(np.float32(value)) if compute_dtype(dtype) == torch.float32 else float(value)


def update_h(p: Params, s: FieldState, coefs: UpdateCoefs,
             patch: tuple[int, int, int, int] | None = None) -> None:
    """Half-step H <- H + dt/(mu*dx) * curl E, in place (main.c:431-462);
    with a ``mu_r`` map the factor is ``coefs.hf_x/y/z`` per component.

    Bounds per component (k, j, i):
      Hx: k<K, j<J, i<I+1     Hy: k<K, j<J+1, i<I     Hz: k<K+1, j<J, i<I

    ``patch`` = (j0, j1, i0, i1) leaves Hx and Hz at k=0 inside the source
    rectangle as they were: the reference's second source hard-set
    (main.c:770-778) overwrites whatever update_H put there, so a step that
    sets the source once and skips those cells gives the same fields.
    """
    K, J, I = p.maxk, p.maxj, p.maxi
    cd = compute_dtype(s.hx.dtype)
    f = scalar(coefs.h_factor, s.hx.dtype)
    ex, ey, ez = s.ex.to(cd), s.ey.to(cd), s.ez.to(cd)

    keep = None
    if patch is not None:
        j0, j1, i0, i1 = patch
        psl = (0, slice(j0, j1), slice(i0, i1))
        keep = (s.hx[psl].clone(), s.hz[psl].clone())

    shx = (slice(0, K), slice(0, J), slice(0, I + 1))
    shy = (slice(0, K), slice(0, J + 1), slice(0, I))
    shz = (slice(0, K + 1), slice(0, J), slice(0, I))
    # heterogeneous mu_r: per-component face factors; the scalar otherwise
    fx, fy, fz = ((coefs.hf_x[shx].to(cd), coefs.hf_y[shy].to(cd), coefs.hf_z[shz].to(cd))
                  if coefs.heterogeneous_mu else (f, f, f))
    s.hx[shx] = s.hx[shx].to(cd) + fx * (
        (ey[1 : K + 1, :J, : I + 1] - ey[:K, :J, : I + 1])
        - (ez[:K, 1 : J + 1, : I + 1] - ez[:K, :J, : I + 1])
    )
    s.hy[shy] = s.hy[shy].to(cd) + fy * (
        (ez[:K, : J + 1, 1 : I + 1] - ez[:K, : J + 1, :I])
        - (ex[1 : K + 1, : J + 1, :I] - ex[:K, : J + 1, :I])
    )
    s.hz[shz] = s.hz[shz].to(cd) + fz * (
        (ex[: K + 1, 1 : J + 1, :I] - ex[: K + 1, :J, :I])
        - (ey[: K + 1, :J, 1 : I + 1] - ey[: K + 1, :J, :I])
    )
    if keep is not None:
        s.hx[psl] = keep[0]
        s.hz[psl] = keep[1]


def update_e(p: Params, s: FieldState, coefs: UpdateCoefs) -> None:
    """Half-step E <- ca*E + cb*curl H, in place (main.c:469-500).

    Interior-only bounds (the PEC boundary):
      Ex: k 1..K-1, j 1..J-1, i 0..I-1
      Ey: k 1..K-1, j 0..J-1, i 1..I-1
      Ez: k 0..K-1, j 1..J-1, i 1..I-1
    Vacuum (scalar coefficients, ca == 1) computes E + cb*curl, which
    equals the reference's ca*E + cb*curl; with materials, ca and cb are
    tensors sliced over the same region, ``ca*E + cb*curl`` in that order.
    """
    K, J, I = p.maxk, p.maxj, p.maxi
    cd = compute_dtype(s.ex.dtype)
    hx, hy, hz = s.hx.to(cd), s.hy.to(cd), s.hz.to(cd)

    def new_e(e: torch.Tensor, sl: tuple, ca, cb, curl: torch.Tensor) -> torch.Tensor:
        if coefs.lossy:
            return ca[sl].to(cd) * e[sl].to(cd) + cb[sl].to(cd) * curl
        return e[sl].to(cd) + scalar(cb, s.ex.dtype) * curl

    sx = (slice(1, K), slice(1, J), slice(0, I))
    curl_x = (hz[1:K, 1:J, :I] - hz[1:K, 0 : J - 1, :I]) - (hy[1:K, 1:J, :I] - hy[0 : K - 1, 1:J, :I])
    s.ex[sx] = new_e(s.ex, sx, coefs.ca_x, coefs.cb_x, curl_x)

    sy = (slice(1, K), slice(0, J), slice(1, I))
    curl_y = (hx[1:K, :J, 1:I] - hx[0 : K - 1, :J, 1:I]) - (hz[1:K, :J, 1:I] - hz[1:K, :J, 0 : I - 1])
    s.ey[sy] = new_e(s.ey, sy, coefs.ca_y, coefs.cb_y, curl_y)

    sz = (slice(0, K), slice(1, J), slice(1, I))
    curl_z = (hy[:K, 1:J, 1:I] - hy[:K, 1:J, 0 : I - 1]) - (hx[:K, 1:J, 1:I] - hx[:K, 0 : J - 1, 1:I])
    s.ez[sz] = new_e(s.ez, sz, coefs.ca_z, coefs.cb_z, curl_z)
