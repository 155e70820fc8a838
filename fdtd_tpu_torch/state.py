"""Field state, initial conditions and the vacuum update coefficients.

The six Yee components are six tensors of one uniform padded shape (see
:mod:`fdtd_tpu_torch.grid`) on one device.  The step functions update them
**in place**: this is the port's counterpart of the JAX package's donation
contract, and it keeps device memory at one copy of the state.  A caller
that needs the state as it was keeps a ``clone()``.

Only the vacuum cavity is ported so far; heterogeneous materials are
ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constants import EPSILON, MU, PI
from .grid import COMPONENTS
from .params import Params

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def field_dtype(p: Params) -> torch.dtype:
    try:
        return _DTYPES[p.dtype]
    except KeyError:
        raise ValueError(f"unsupported field dtype {p.dtype!r}: use one of {sorted(_DTYPES)}") from None


@dataclasses.dataclass
class FieldState:
    """The six Yee components, each of shape ``params.padded_shape``."""

    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    hx: torch.Tensor
    hy: torch.Tensor
    hz: torch.Tensor

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, c) for c in COMPONENTS)

    def to(self, device=None, dtype=None) -> "FieldState":
        """A converted copy (or ``self``'s tensors where nothing changes)."""
        return FieldState(*(t.to(device=device, dtype=dtype) for t in self.tensors()))

    def clone(self) -> "FieldState":
        return FieldState(*(t.clone() for t in self.tensors()))

    def swap(self, other: "FieldState") -> None:
        """Exchange the tensors of ``self`` and ``other`` (no copy): a
        kernel that writes its result into a second state hands it back
        to the caller's object this way."""
        for c in COMPONENTS:
            a, b = getattr(self, c), getattr(other, c)
            setattr(self, c, b)
            setattr(other, c, a)


def zeros(p: Params, device, dtype: torch.dtype | None = None) -> FieldState:
    """Zero-initialized fields (reference: main.c:294-364)."""
    dt = dtype or field_dtype(p)
    return FieldState(*(torch.zeros(p.padded_shape, dtype=dt, device=device) for _ in COMPONENTS))


def te101_initial_ey(p: Params) -> np.ndarray:
    """TE101 initial condition on Ey (reference: main.c:416-424).

    Ey[k,j,i] = sin(pi*k*dx/height) * sin(pi*i*dx/length) over Ey's physical
    region (k 0..K, j 0..J-1, i 0..I), in fp64; the caller casts.
    """
    K1, J1, I1 = p.padded_shape
    dx = p.spatial_step
    k = np.arange(K1, dtype=np.float64) * dx
    i = np.arange(I1, dtype=np.float64) * dx
    prof = np.sin(PI * k / p.height)[:, None, None] * np.sin(PI * i / p.length)[None, None, :]
    ey = np.broadcast_to(prof, (K1, J1, I1)).copy()
    ey[:, p.maxj :, :] = 0.0  # padding: Ey's physical j-extent is maxj
    return ey


def init_validation(p: Params, device, dtype: torch.dtype | None = None) -> FieldState:
    """Zero fields with the TE101 Ey seed (validation mode, main.c:843-844)."""
    st = zeros(p, device, dtype)
    st.ey.copy_(torch.from_numpy(te101_initial_ey(p)))
    return st


@dataclasses.dataclass(frozen=True)
class Materials:
    """Cell-centered material maps of shape (maxk, maxj, maxi); ``None``
    means vacuum.  Only the vacuum cavity runs in the port so far."""

    eps_r: np.ndarray | None = None
    sigma: np.ndarray | None = None
    mu_r: np.ndarray | None = None

    @property
    def is_vacuum(self) -> bool:
        return self.eps_r is None and self.sigma is None and self.mu_r is None


@dataclasses.dataclass(frozen=True)
class UpdateCoefs:
    """E-update coefficients E <- ca*E + cb*curl H, and the H factor.

    In vacuum ca == 1 and cb == dt/(EPSILON*dx), the reference's ``factor``
    (main.c:479); ``h_factor`` is dt/(MU*dx) (main.c:441).  All are Python
    floats (fp64).
    """

    ca_x: float
    ca_y: float
    ca_z: float
    cb_x: float
    cb_y: float
    cb_z: float
    h_factor: float


def update_coefs(p: Params, materials: Materials | None = None) -> UpdateCoefs:
    if materials is not None and not materials.is_vacuum:
        raise NotImplementedError(
            "lossy and heterogeneous-mu materials are not ported yet "
            "(ROADMAP queue 1 item 5, materials and heating)"
        )
    cb = p.time_step / (EPSILON * p.spatial_step)  # reference main.c:479
    hf = p.time_step / (MU * p.spatial_step)  # reference main.c:441
    return UpdateCoefs(1.0, 1.0, 1.0, cb, cb, cb, hf)
