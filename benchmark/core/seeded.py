"""The seeded initial state of a run, and its checkpoint.

Every cell starts from random fields over the whole grid, drawn on the
device from ``--seed`` in one call, so every cell of the grid does real
work from the first step (a zero start would excite only the region
around the 5 mm source patch).  Tangential E and normal H on the six PEC
walls are zero, and so is the padding outside each component's extent.
The values are rounded to bfloat16, so that the checkpoint can store
them in two bytes a value (``V2`` records, which the checkpoint schema
widens to fp32 exactly): a run writes half the bytes.

The checkpoint is written by this file's own code in the schema of
``fdtd_tpu_torch/io/checkpoint.py``: ``ex ey ez hx hy hz`` in the padded
(maxk+1, maxj+1, maxi+1) layout, ``iteration`` 0, ``t`` 0 and, where the
traffic deposits SAR, a zero ``power_acc``; in a Debye load also the
polarization ``aux_pol_x/y/z`` (the program's resume keys), drawn from the
seed like the fields (:func:`seeded_polarization`).  No DFT sums and no
probe rows: the run's sums start from zero.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from reference.plain import COMP_AXES, COMPONENTS, EPSILON, edge_mean

CHECKPOINT = "ckpt000000.npz"
POL_KEYS = ("aux_pol_x", "aux_pol_y", "aux_pol_z")
# added to the seed for the polarization's generator, a stream apart from the fields'
POL_STREAM = 0x9E3779B97F4A7C15


def _zero_outside(name: str, t: torch.Tensor, K: int, J: int, I: int) -> None:
    """Zero the padding of component ``name`` and its wall values: E
    tangential to a wall, H normal to it."""
    if name == "ex":  # (K+1, J+1, I); tangential to the k and j walls
        t[:, :, I:] = 0
        t[0], t[K], t[:, 0], t[:, J] = 0, 0, 0, 0
    elif name == "ey":  # (K+1, J, I+1); k and i walls
        t[:, J:, :] = 0
        t[0], t[K], t[:, :, 0], t[:, :, I] = 0, 0, 0, 0
    elif name == "ez":  # (K, J+1, I+1); j and i walls
        t[K:] = 0
        t[:, 0], t[:, J], t[:, :, 0], t[:, :, I] = 0, 0, 0, 0
    elif name == "hx":  # (K, J, I+1); normal to the i walls
        t[K:], t[:, J:] = 0, 0
        t[:, :, 0], t[:, :, I] = 0, 0
    elif name == "hy":  # (K, J+1, I); normal to the j walls
        t[K:], t[:, :, I:] = 0, 0
        t[:, 0], t[:, J] = 0, 0
    else:  # hz: (K+1, J, I); normal to the k walls
        t[:, J:], t[:, :, I:] = 0, 0
        t[0], t[K] = 0, 0


def seeded_fields(grid: tuple[int, int, int], seed: int, e_amp: float, h_amp: float,
                  device) -> torch.Tensor:
    """The six components as one (6, K+1, J+1, I+1) bfloat16 tensor on
    ``device``: uniform in [-e_amp, e_amp] for E and [-h_amp, h_amp] for
    H, from a generator seeded with ``seed``, walls and padding zero."""
    K, J, I = grid
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    f = torch.rand((6, K + 1, J + 1, I + 1), generator=g, device=device, dtype=torch.float32)
    f.mul_(2.0).sub_(1.0)
    f[:3].mul_(float(e_amp))
    f[3:].mul_(float(h_amp))
    for n, name in enumerate(COMPONENTS):
        _zero_outside(name, f[n], K, J, I)
    return f.to(torch.bfloat16)


def polarization_amplitude(d_eps: float, e_amp: float) -> float:
    """The seeded P's amplitude: eps0 d_eps times the seeded E's, the
    order of the equilibrium polarization of such a field."""
    return EPSILON * float(d_eps) * float(e_amp)


def seeded_polarization(grid: tuple[int, int, int], seed: int, amp: float, d_eps: np.ndarray,
                        device) -> torch.Tensor:
    """P on the three padded E grids as one (3, K+1, J+1, I+1) bfloat16
    tensor on ``device``: uniform in [-amp, amp] from a generator seeded
    with ``seed`` (apart from the fields' stream), and exactly zero on
    every edge whose edge-averaged ``d_eps`` (the (K, J, I) cell map) is 0
    and in the padding.  Off the load the program's k1 is -1 and its cp
    2/D, so a P there would flip sign each step and drive E."""
    K, J, I = grid
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) + POL_STREAM) % (1 << 64))
    pol = torch.rand((3, K + 1, J + 1, I + 1), generator=g, device=device, dtype=torch.float32)
    pol.mul_(2.0).sub_(1.0).mul_(float(amp))
    cells = torch.as_tensor(np.asarray(d_eps) > 0, device=device).to(torch.float32)
    for n, axes in enumerate(COMP_AXES.values()):
        on = edge_mean(cells, axes) > 0
        keep = torch.zeros((K + 1, J + 1, I + 1), dtype=torch.bool, device=device)
        keep[:on.shape[0], :on.shape[1], :on.shape[2]] = on
        pol[n].masked_fill_(~keep, 0.0)
    return pol.to(torch.bfloat16)


def widen(raw: np.ndarray) -> np.ndarray:
    """bfloat16 bits (``V2`` records or uint16) as fp32, exactly."""
    return (np.ascontiguousarray(raw).view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _bf16_records(t: torch.Tensor) -> np.ndarray:
    """A bfloat16 tensor as a host array of ``V2`` records (its bits)."""
    return t.view(torch.int16).cpu().numpy().view(np.dtype("V2"))


def write_checkpoint(run_dir: str, fields: torch.Tensor, power_shape: tuple[int, int, int] | None,
                     pol: torch.Tensor | None = None) -> str:
    """Write ``fields`` (the bfloat16 tensor of :func:`seeded_fields`) as
    ``run_dir/ckpt000000.npz``; with ``power_shape`` a zero fp32
    ``power_acc`` too, with ``pol`` (:func:`seeded_polarization`) the
    three ``aux_pol_*`` arrays.  Returns the path."""
    host = _bf16_records(fields)
    arrays = {name: host[n] for n, name in enumerate(COMPONENTS)}
    if pol is not None:
        host_pol = _bf16_records(pol)
        arrays.update({key: host_pol[n] for n, key in enumerate(POL_KEYS)})
    if power_shape is not None:
        arrays["power_acc"] = np.zeros(power_shape, np.float32)
    path = os.path.join(run_dir, CHECKPOINT)
    tmp = path + ".tmp.npz"
    np.savez(tmp, iteration=np.int64(0), t=np.float64(0.0), **arrays)
    os.replace(tmp, path)
    return path


def read_checkpoint_fields(path: str) -> dict[str, np.ndarray]:
    """The six components of a checkpoint as fp32 host arrays."""
    with np.load(path) as z:
        return {name: widen(z[name]) if z[name].dtype == np.dtype("V2") else np.asarray(z[name], np.float32)
                for name in COMPONENTS}
