"""Wrapper of the per-step SAR increment kernel (``csrc/dft_accum.cu``,
``sar_accum_kernel``).

:func:`accumulate_power` adds one step's deposition ``sigma*|E|^2*dt`` to
the fp32 SAR map in place, as :func:`fdtd_tpu_torch.diagnostics.
accumulate_power` does, in one launch: the E cell means, |E|^2, the sigma
and dt products and the add, each rounded on its own, so the map equals
the torch ops' bits.  It replaces no TPU kernel: the JAX package's step
leaves the increment to XLA, which fuses it into one loop
(``fdtd_tpu/step.py:384-397``).  On CUDA tensors it launches the kernel on
the current stream of their device and allocates nothing; it raises on
anything the kernel does not take (fp64 fields, sigma in another dtype
than the fields, tensors that are not contiguous).  On CPU tensors, and
only there, it runs :func:`diagnostics.accumulate_power`, the plain
version.  With ``box`` (a shard of a sharded run,
:class:`~fdtd_tpu_torch.grid.Box`) it adds a shard's owned cells, read
from the shard's arrays (E's halo plane above filled), to the shard's
part of the map; ``sigma_cells`` is then the shard's part of sigma.

The launch is a torch operator of its own (``<package>::sar_accum``,
registered at the first launch), inside the profiler span of the plain
version (``diagnostics.SAR_LABEL``): a trace links a kernel to the host
op that launched it, and a launch through ctypes alone lies in no op.
``launches`` counts kernel launches; plain-version calls do not count.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import diagnostics
from ..grid import Box
from ..params import Params
from ..spans import span
from ..state import FieldState
from . import build, dft, yee

launches = {"sar_accum": 0, "sar_accum_shard": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ops: list = []  # the operator's library (kept alive) and the operator, at the first launch


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _launch(ex, ey, ez, sigma, acc, dims, geom, dt) -> None:
    """The operator's CUDA kernel: one ``sar_accum`` launch (``dims`` the
    grid's (K, J, I), ``geom`` a shard's 12 ints or empty)."""
    lib = dft._lib()
    e_ptr = (ctypes.c_void_p * 3)(ex.data_ptr(), ey.data_ptr(), ez.data_ptr())
    g = (ctypes.c_int * 12)(*geom) if geom else None
    rc = lib.sar_accum(e_ptr, *dims, g, sigma.data_ptr(), dt, acc.data_ptr(), _DTYPE_CODES[ex.dtype],
                       build.launch_stream(ex.device))
    if rc != 0:
        raise RuntimeError(f"sar_accum launch failed: CUDA error {rc} ({lib.dft_error_string(rc).decode()})")


def _op():
    """The ``sar_accum`` operator, registered under the package's name at
    its first use."""
    if not _ops:
        ns = __name__.split(".")[0]
        lib = torch.library.Library(ns, "DEF")
        lib.define("sar_accum(Tensor ex, Tensor ey, Tensor ez, Tensor sigma, Tensor(a!) acc, int[] dims, int[] geom, "
                   "float dt) -> ()")
        lib.impl("sar_accum", _launch, "CUDA")
        _ops[:] = [lib, getattr(torch.ops, ns).sar_accum]
    return _ops[1]


def accumulate_power(p: Params, s: FieldState, sigma_cells: torch.Tensor | None, acc: torch.Tensor,
                     box: Box | None = None) -> None:
    """``acc += sigma*|E|^2*dt`` over the cells (a shard's owned cells with
    ``box``), in place; vacuum (``sigma_cells`` None) deposits nothing."""
    if sigma_cells is None:
        return
    if box is not None and box.is_full(p):
        box = None
    cells = box.cell_shape(p) if box is not None else (p.maxk, p.maxj, p.maxi)
    dev = s.ex.device
    if any(t.device != dev for t in (s.ex, s.ey, s.ez, sigma_cells, acc)):
        raise ValueError("the E tensors, sigma and the SAR map must all be on one device")
    for name, a in (("sigma", sigma_cells), ("the SAR map", acc)):
        if tuple(a.shape) != cells:
            raise ValueError(f"{name} must be a {cells} tensor; got {tuple(a.shape)}")
    if acc.dtype != torch.float32:
        raise ValueError(f"the SAR map must be float32; got {acc.dtype}")
    if dev.type == "cpu":
        diagnostics.accumulate_power(p, s, sigma_cells, acc, box)
        return
    if dev.type != "cuda":
        raise ValueError(f"the SAR kernel runs on CUDA tensors; got device {dev}")
    dt = s.ex.dtype
    if dt not in _DTYPE_CODES:
        raise ValueError(f"the SAR kernel takes float32 or bfloat16 fields; got {dt}")
    shape = box.shape if box is not None else p.padded_shape
    for t in (s.ex, s.ey, s.ez):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"each E field must be a contiguous {dt} tensor of shape {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if sigma_cells.dtype != dt or not sigma_cells.is_contiguous() or not acc.is_contiguous():
        raise ValueError(f"sigma must be a contiguous {dt} tensor and the SAR map contiguous; got sigma "
                         f"{sigma_cells.dtype}")
    geom = list(yee.geometry(p, box)) if box is not None else []
    with span(diagnostics.SAR_LABEL), torch.cuda.device(dev):
        _op()(s.ex, s.ey, s.ez, sigma_cells, acc, [p.maxk, p.maxj, p.maxi], geom, float(np.float32(p.time_step)))
    launches["sar_accum_shard" if box is not None else "sar_accum"] += 1
