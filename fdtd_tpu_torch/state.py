"""Field state, initial conditions, materials and the update coefficients.

The six Yee components are six tensors of one uniform padded shape (see
:mod:`fdtd_tpu_torch.grid`) on one device.  The step functions update them
**in place**: this is the port's counterpart of the JAX package's donation
contract, and it keeps device memory at one copy of the state.  A caller
that needs the state as it was keeps a ``clone()``.

Materials (the JAX package's capability beyond the vacuum-only reference):
per-cell relative permittivity, conductivity and permeability, the load
masks that place them, and the update coefficients built from them.  The
coefficient arrays are computed in fp64 on the host, exactly as
``fdtd_tpu/state.py`` computes them, and rounded once to the field dtype
on the run's device.
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
    """Cell-centered material maps of shape (maxk, maxj, maxi).

    ``eps_r``: relative permittivity, ``sigma``: conductivity (S/m),
    ``mu_r``: relative permeability.  ``None`` means vacuum (the scalar
    path: no coefficient arrays, the vacuum kernels).
    """

    eps_r: np.ndarray | None = None
    sigma: np.ndarray | None = None
    mu_r: np.ndarray | None = None

    @property
    def is_vacuum(self) -> bool:
        return self.eps_r is None and self.sigma is None and self.mu_r is None


def _box_bounds(p: Params, lo, hi) -> tuple[slice, slice, slice]:
    """(k, j, i) cell slices of the fractional box [lo, hi) ((x, y, z))."""
    K, J, I = p.maxk, p.maxj, p.maxi
    return (slice(int(lo[2] * K), int(hi[2] * K)), slice(int(lo[1] * J), int(hi[1] * J)),
            slice(int(lo[0] * I), int(hi[0] * I)))


def block_mask(p: Params, lo=(0.3, 0.3, 0.3), hi=(0.7, 0.7, 0.7)) -> np.ndarray:
    """Boolean cell mask of the fractional box [lo, hi) ((x, y, z) fractions)."""
    mask = np.zeros((p.maxk, p.maxj, p.maxi), dtype=bool)
    mask[_box_bounds(p, lo, hi)] = True
    return mask


def sphere_mask(p: Params, center=(0.5, 0.5, 0.5), radius=0.2) -> np.ndarray:
    """Boolean cell mask of a sphere: ``center`` in (x, y, z) box fractions,
    ``radius`` a fraction of the box's shortest side; a cell is in when its
    center is (the staircase approximation)."""
    K, J, I = p.maxk, p.maxj, p.maxi
    kc = (np.arange(K) + 0.5) / K
    jc = (np.arange(J) + 0.5) / J
    ic = (np.arange(I) + 0.5) / I
    dims = np.array([p.length, p.width, p.height])
    r_phys = float(radius) * dims.min()
    dz = (kc - center[2])[:, None, None] * p.height
    dy = (jc - center[1])[None, :, None] * p.width
    dx = (ic - center[0])[None, None, :] * p.length
    return dx * dx + dy * dy + dz * dz <= r_phys * r_phys


def cylinder_mask(p: Params, center=(0.5, 0.5), radius=0.2, lo=0.3, hi=0.7) -> np.ndarray:
    """Boolean cell mask of a z-axis cylinder (the mug of water): ``center``
    in (x, y) fractions, ``radius`` a fraction of the smaller transverse
    side, height over the z fractions [lo, hi)."""
    K, J, I = p.maxk, p.maxj, p.maxi
    jc = (np.arange(J) + 0.5) / J
    ic = (np.arange(I) + 0.5) / I
    r_phys = float(radius) * min(p.length, p.width)
    dy = (jc - center[1])[None, :, None] * p.width
    dx = (ic - center[0])[None, None, :] * p.length
    disk = dx * dx + dy * dy <= r_phys * r_phys
    kz = np.zeros((K, 1, 1), bool)
    kz[int(lo * K):int(hi * K)] = True
    return np.broadcast_to(disk & kz, (K, J, I)).copy()


def water_from_mask(p: Params, mask: np.ndarray, eps_r=78.0, sigma=1.7) -> Materials:
    """Water/food material maps over a boolean cell mask."""
    return Materials(eps_r=np.where(mask, float(eps_r), 1.0), sigma=np.where(mask, float(sigma), 0.0))


def water_block(p: Params, lo=(0.3, 0.3, 0.3), hi=(0.7, 0.7, 0.7), eps_r=78.0, sigma=1.7) -> Materials:
    """A water/food block over the fractional box [lo, hi) (BASELINE config #2)."""
    return water_from_mask(p, block_mask(p, lo, hi), eps_r, sigma)


def ferrite_slab(p: Params, base: Materials | None = None, lo=(0.0, 0.0, 0.5),
                 hi=(1.0, 0.5, 1.0), mu_r=4.0) -> Materials:
    """A heterogeneous-``mu_r`` slab over the fractional box [lo, hi),
    optionally layered on an existing scene (``base``)."""
    mu = np.ones((p.maxk, p.maxj, p.maxi))
    mu[_box_bounds(p, lo, hi)] = mu_r
    if base is None:
        return Materials(mu_r=mu)
    return dataclasses.replace(base, mu_r=mu)


@dataclasses.dataclass(frozen=True)
class UpdateCoefs:
    """E-update coefficients E <- ca*E + cb*curl H, and the H factor(s).

    Lossy form: ca = (1 - s) / (1 + s), cb = dt / (eps*dx) / (1 + s) with
    s = sigma*dt / (2*eps), per E component at its edge.  In vacuum ca == 1
    and cb == dt/(EPSILON*dx), the reference's ``factor`` (main.c:479), and
    all seven are Python floats (fp64), so the vacuum kernels run
    unchanged.  With materials, ``ca_*``/``cb_*`` are tensors of the padded
    shape in the field dtype (ca 1 and cb 0 outside each component's
    physical extent), and ``sigma_cells`` is the (maxk, maxj, maxi)
    conductivity for the power deposition.

    ``h_factor`` is the scalar dt/(MU*dx) (main.c:441).  With a ``mu_r``
    map, ``hf_x/y/z`` are padded tensors dt/(MU*mu_face*dx), mu averaged
    over the two cells sharing each H component's face (the scalar factor
    outside the physical extent); None for uniform permeability.
    """

    ca_x: float | torch.Tensor
    ca_y: float | torch.Tensor
    ca_z: float | torch.Tensor
    cb_x: float | torch.Tensor
    cb_y: float | torch.Tensor
    cb_z: float | torch.Tensor
    h_factor: float
    sigma_cells: torch.Tensor | None = None
    hf_x: torch.Tensor | None = None
    hf_y: torch.Tensor | None = None
    hf_z: torch.Tensor | None = None

    @property
    def lossy(self) -> bool:
        """Per-cell ca/cb tensors (any non-vacuum scene)."""
        return isinstance(self.ca_x, torch.Tensor)

    @property
    def heterogeneous_mu(self) -> bool:
        return self.hf_x is not None


def _edge_average(cells: np.ndarray, axis_pair: tuple[int, int]) -> np.ndarray:
    """Cell-centered values averaged onto E-edge locations: an edge along
    one axis is shared by the 4 cells adjacent in the other two; the
    boundary replicates the edge cell.  The output is one longer along
    both axes of ``axis_pair``."""
    pads = [(0, 0)] * 3
    for ax in axis_pair:
        pads[ax] = (1, 1)
    out = np.pad(cells, pads, mode="edge")
    for ax in axis_pair:
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[ax] = slice(0, -1)
        sl1[ax] = slice(1, None)
        out = 0.5 * (out[tuple(sl0)] + out[tuple(sl1)])
    return out


def update_coefs(p: Params, materials: Materials | None = None, device=None) -> UpdateCoefs:
    """The update coefficients of ``materials`` (vacuum when None), as
    ``fdtd_tpu.state.update_coefs`` computes them: fp64 on the host, then
    tensors on ``device`` rounded once to the field dtype of ``p``.
    Vacuum coefficients are Python floats and need no device; materials
    need the run's device."""
    dt_, dx = p.time_step, p.spatial_step
    cb0 = dt_ / (EPSILON * dx)  # reference main.c:479
    hf = dt_ / (MU * dx)  # reference main.c:441
    if materials is None or materials.is_vacuum:
        return UpdateCoefs(1.0, 1.0, 1.0, cb0, cb0, cb0, hf)
    if device is None:
        raise ValueError("update_coefs with materials needs the device to build the coefficient tensors on")

    dty = field_dtype(p)
    K, J, I = p.maxk, p.maxj, p.maxi
    shape = p.padded_shape
    er = materials.eps_r if materials.eps_r is not None else np.ones((K, J, I))
    sg = materials.sigma if materials.sigma is not None else np.zeros((K, J, I))

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dty, device=device)

    def coefs_for(axis_pair):
        eps_e = _edge_average(er, axis_pair) * EPSILON
        sig_e = _edge_average(sg, axis_pair)
        s = sig_e * dt_ / (2.0 * eps_e)
        ca_p, cb_p = np.ones(shape), np.zeros(shape)
        ek, ej, ei = eps_e.shape
        ca_p[:ek, :ej, :ei] = (1.0 - s) / (1.0 + s)
        cb_p[:ek, :ej, :ei] = (dt_ / (eps_e * dx)) / (1.0 + s)
        return on_device(ca_p), on_device(cb_p)

    # Ex edges run along i: averaged over (k, j) = axes (0, 1); and so on
    ca_x, cb_x = coefs_for((0, 1))
    ca_y, cb_y = coefs_for((0, 2))
    ca_z, cb_z = coefs_for((1, 2))

    hfs = (None, None, None)
    if materials.mu_r is not None:
        mu = np.asarray(materials.mu_r, dtype=np.float64)

        def hf_for(axis):
            # Hx sits on x-normal faces: mu averaged over the two cells
            # adjacent along i; Hy along j, Hz along k
            pads = [(0, 0)] * 3
            pads[axis] = (1, 1)
            padded = np.pad(mu, pads, mode="edge")
            sl0 = [slice(None)] * 3
            sl1 = [slice(None)] * 3
            sl0[axis] = slice(0, -1)
            sl1[axis] = slice(1, None)
            mu_face = 0.5 * (padded[tuple(sl0)] + padded[tuple(sl1)])
            out = np.full(shape, hf)
            fk, fj, fi = mu_face.shape
            out[:fk, :fj, :fi] = dt_ / (MU * mu_face * dx)
            return on_device(out)

        hfs = (hf_for(2), hf_for(1), hf_for(0))
    return UpdateCoefs(ca_x, ca_y, ca_z, cb_x, cb_y, cb_z, hf, on_device(sg), *hfs)
