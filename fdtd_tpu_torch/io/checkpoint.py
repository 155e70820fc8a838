"""Checkpoint / resume, in the JAX package's npz schema.

A checkpoint holds the six staggered fields in the canonical padded layout
under the keys ``ex ey ez hx hy hz``, plus ``iteration`` (int64), ``t``
(float64), an optional ``power_acc`` and ``aux_<name>`` arrays, exactly as
:mod:`fdtd_tpu.io.checkpoint` writes them, so a checkpoint written by either
package resumes in the other.  bfloat16 fields are stored as float32 (an
exact widening); loading casts to the run's dtype.
"""

from __future__ import annotations

import glob
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from ..grid import COMPONENTS
from ..params import Params
from ..state import FieldState, field_dtype


def to_host(t: torch.Tensor | np.ndarray) -> np.ndarray:
    """A host numpy copy of a tensor or array (never a view: the fields are
    updated in place while a worker thread writes the copy); bfloat16
    widens to float32."""
    if isinstance(t, np.ndarray):
        return t.copy()
    dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to(device="cpu", dtype=dt, copy=True).numpy()


def from_host(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor copy of a host array.  bfloat16 bits, as numpy's bfloat16
    extension type or as the raw 2-byte records ``np.savez`` stores for it
    (JAX bf16 checkpoints), widen to float32 first, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        a = (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return torch.tensor(a, dtype=dtype, device=device)


def save_checkpoint(path: str, state: dict[str, np.ndarray], iteration: int, t: float,
                    power: np.ndarray | None = None, aux: dict | None = None) -> None:
    """Write host arrays (``state``: component name -> ndarray) to ``path``
    through a temporary file, so a crash never leaves a partial checkpoint
    under the final name."""
    arrays = {name: np.asarray(state[name]) for name in COMPONENTS}
    if power is not None:
        arrays["power_acc"] = np.asarray(power)
    for name, a in (aux or {}).items():
        arrays[f"aux_{name}"] = np.asarray(a)
    tmp = path + ".tmp.npz"
    np.savez(tmp, iteration=np.int64(iteration), t=np.float64(t), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, p: Params, device) -> tuple[FieldState, int, float, np.ndarray | None]:
    """(state on ``device`` in the run's dtype, iteration, t, power_acc)."""
    dt = field_dtype(p)
    with np.load(path) as z:
        fields = []
        for name in COMPONENTS:
            a = z[name]
            if a.shape != p.padded_shape:
                raise ValueError(f"checkpoint {name} shape {a.shape} != params shape {p.padded_shape}")
            fields.append(from_host(a, dt, device))
        power = np.asarray(z["power_acc"]) if "power_acc" in z else None
        return FieldState(*fields), int(z["iteration"]), float(z["t"]), power


def load_aux(path: str) -> dict[str, np.ndarray]:
    """The ``aux_<name>`` arrays of a checkpoint as ``{name: ndarray}``
    (empty for checkpoints written without aux state), as
    ``fdtd_tpu.io.checkpoint.load_aux`` reads them."""
    with np.load(path) as z:
        return {k[4:]: z[k] for k in z.files if k.startswith("aux_")}


class CheckpointWriter:
    """Asynchronous checkpoint writer.

    ``submit`` copies the state to the host on the calling thread (the copy
    waits for the device) and hands the npz encode and the disk write to one
    background worker, so the step loop continues while the file is written.
    At most one checkpoint is in flight: a second ``submit`` first drains the
    previous one, which bounds host memory at one extra copy of the state.
    """

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._inflight: Future | None = None

    def submit(self, state: FieldState, iteration: int, t: float,
               power: torch.Tensor | None = None,
               aux: dict[str, torch.Tensor | np.ndarray] | None = None) -> None:
        """Checkpoint ``state``, the fp32 SAR accumulator ``power`` and the
        ``aux`` tensors or host arrays (stored as ``aux_<name>``, e.g. the
        CPML psi as ``aux_psi_<term>``, the DFT sums as ``aux_dft_re`` /
        ``aux_dft_im``, the probe rows as ``aux_probe_rows``)."""
        self.drain()
        path = os.path.join(self.out_dir, f"ckpt{iteration:06d}.npz")
        host = {name: to_host(getattr(state, name)) for name in COMPONENTS}
        host_power = to_host(power) if power is not None else None
        host_aux = {k: to_host(v) for k, v in aux.items()} if aux else None
        self._inflight = self._pool.submit(save_checkpoint, path, host, iteration, t, host_power, host_aux)

    def drain(self) -> None:
        """Wait for (and surface errors from) the in-flight write, if any."""
        if self._inflight is not None:
            self._inflight.result()
            self._inflight = None

    def close(self) -> None:
        try:
            self.drain()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def latest_checkpoint(out_dir: str) -> str | None:
    # strict ckpt(\d+).npz$ match: excludes partial "*.tmp.npz" files
    pat = re.compile(r"ckpt(\d+)\.npz$")
    cands = [
        (int(m.group(1)), f)
        for f in glob.glob(os.path.join(out_dir, "ckpt[0-9]*.npz"))
        if (m := pat.search(os.path.basename(f)))
    ]
    return max(cands)[1] if cands else None
