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
traffic deposits SAR, a zero ``power_acc``.  No DFT sums and no probe
rows: the run's sums start from zero.
"""

from __future__ import annotations

import os

import numpy as np
import torch

COMPONENTS = ("ex", "ey", "ez", "hx", "hy", "hz")
CHECKPOINT = "ckpt000000.npz"


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


def widen(raw: np.ndarray) -> np.ndarray:
    """bfloat16 bits (``V2`` records or uint16) as fp32, exactly."""
    return (np.ascontiguousarray(raw).view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def write_checkpoint(run_dir: str, fields: torch.Tensor, power_shape: tuple[int, int, int] | None) -> str:
    """Write ``fields`` (the bfloat16 tensor of :func:`seeded_fields`) as
    ``run_dir/ckpt000000.npz``; with ``power_shape`` a zero fp32
    ``power_acc`` too.  Returns the path."""
    host = fields.view(torch.int16).cpu().numpy().view(np.dtype("V2"))
    arrays = {name: host[n] for n, name in enumerate(COMPONENTS)}
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
