"""Carry scenes and states across from the JAX package.

The port cannot import :mod:`fdtd_tpu` (it imports JAX), so the exchange
format is plain data: a state is a dict of six numpy arrays in the canonical
padded (k, j, i) layout, keyed ``ex ey ez hx hy hz`` (what
``{c: np.asarray(getattr(s, c)) for c in COMPONENTS}`` gives for a JAX
``FieldState``), and a scene is read from the fields of any object shaped
like the JAX ``Params``.  Material maps (the system's "weights": both
packages build their coefficients from them) are read from any object with
``eps_r``/``sigma``/``mu_r`` attributes, such as a JAX ``Materials``.  The
CPML memory state crosses as a dict of twelve numpy arrays keyed by term
name in the slab-restricted layout both packages keep (what
``{n: np.asarray(getattr(psi, n)) for n in names}`` gives for a JAX
``PsiState``).  A Debye medium is read from any object with ``base`` (the
material maps), ``d_eps`` and ``tau``, such as a JAX ``DebyeMaterials``,
and its polarization crosses as the three arrays (px, py, pz) of the
padded E grids (the JAX package's tuple, and its checkpoints'
``aux_pol_x/y/z``).  The DFT sums cross as the (re, im) pair of fp32
(nf, nc, maxk, maxj, maxi) arrays (the JAX package's canonical pair, and
its checkpoints' ``aux_dft_re``/``aux_dft_im``); probe rows are one
(n, n_probes, 6) fp32 numpy array in both packages (``aux_probe_rows``).
The tests use this to feed both packages the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import COMPONENTS
from .io.checkpoint import from_host, to_host
from .ops.cpml import PsiState
from .ops.dispersive import DebyeMaterials, PolState
from .params import Mode, Params, SourceConfig
from .state import FieldState, Materials

_PARAM_FIELDS = ("length", "width", "height", "spatial_step", "time_step",
                 "simulation_time", "sampling_rate")
_SOURCE_FIELDS = ("frequency", "aprime", "bprime", "envelope", "pulse_width", "pulse_delay")


def params_from(other) -> Params:
    """The port's ``Params`` with the field values of ``other`` (a JAX
    ``fdtd_tpu.params.Params`` or anything with the same attributes)."""
    src = other.source
    return Params(
        **{name: getattr(other, name) for name in _PARAM_FIELDS},
        mode=Mode(int(other.mode)),
        dtype=str(other.dtype),
        source=SourceConfig(**{name: getattr(src, name) for name in _SOURCE_FIELDS}),
    )


def state_from_numpy(arrays: dict[str, np.ndarray], device, dtype: torch.dtype) -> FieldState:
    """A ``FieldState`` on ``device`` in ``dtype`` from six numpy arrays.

    The tensors are copies: the port updates them in place, and a view would
    write through to the caller's arrays (and to any JAX array sharing
    their memory)."""
    return FieldState(*(from_host(arrays[c], dtype, device) for c in COMPONENTS))


def state_to_numpy(s: FieldState) -> dict[str, np.ndarray]:
    """The six fields as host numpy arrays (bfloat16 widened to float32)."""
    return {c: to_host(getattr(s, c)) for c in COMPONENTS}


def materials_from(other) -> Materials:
    """The port's ``Materials`` with copies of the ``eps_r``/``sigma``/``mu_r``
    maps of ``other`` (None stays None)."""
    def copy(a):
        return None if a is None else np.array(a, dtype=np.float64)

    return Materials(eps_r=copy(other.eps_r), sigma=copy(other.sigma), mu_r=copy(other.mu_r))


def power_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """An fp32 SAR accumulator tensor on ``device`` from a host array (a copy)."""
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def psi_from_numpy(arrays: dict[str, np.ndarray], device, dtype: torch.dtype) -> PsiState:
    """A :class:`PsiState` on ``device`` in ``dtype`` (copies) from the
    twelve arrays of a JAX ``PsiState`` (or of a checkpoint's
    ``aux_psi_<term>``), keyed by term name."""
    return PsiState(**{n: from_host(arrays[n], dtype, device) for n in PsiState.names()})


def psi_to_numpy(psi: PsiState) -> dict[str, np.ndarray]:
    """The twelve psi tensors as host numpy arrays keyed by term name
    (bfloat16 widened to float32)."""
    return {n: to_host(getattr(psi, n)) for n in PsiState.names()}


def debye_from(other) -> DebyeMaterials:
    """The port's ``DebyeMaterials`` with copies of the maps of ``other``
    (a JAX ``DebyeMaterials``: ``base``, ``d_eps``, ``tau``)."""
    return DebyeMaterials(base=materials_from(other.base), d_eps=np.array(other.d_eps, dtype=np.float64),
                          tau=np.array(other.tau, dtype=np.float64))


def pol_from_numpy(arrays, device, dtype: torch.dtype) -> PolState:
    """A :class:`PolState` on ``device`` in ``dtype`` (copies) from the
    three arrays (px, py, pz) of a JAX polarization tuple."""
    return PolState(*(from_host(a, dtype, device) for a in arrays))


def pol_to_numpy(pol: PolState) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(px, py, pz) as host numpy arrays (bfloat16 widened to float32)."""
    return tuple(to_host(t) for t in pol.tensors())


def dft_from_numpy(acc, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (re, im) DFT sums on ``device`` (fp32 copies) from a JAX pair."""
    return tuple(from_host(np.asarray(a, np.float32), torch.float32, device) for a in acc)


def dft_to_numpy(acc) -> tuple[np.ndarray, np.ndarray]:
    """The (re, im) DFT sums as host fp32 arrays."""
    return tuple(to_host(t) for t in acc)
