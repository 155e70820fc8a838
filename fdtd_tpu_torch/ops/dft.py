"""Wrapper of the per-step DFT accumulation kernel (``csrc/dft_accum.cu``).

:func:`accumulate_e` replaces the TPU kernel
``fdtd_tpu/ops/pallas_stream.py::build_dft_accum_call.kernel``: after a
step of a per-step backend it adds the 4-edge cell means of the final E,
times the step's (cos, -sin) weights, to the E components of the
canonical (nf, nc, maxk, maxj, maxi) fp32 (re, im) sums, in place.  The
TPU's stacked and stripped layouts (``embed_dft_acc``/``crop_dft_acc``)
have no counterpart: the sums stay canonical throughout.  On CUDA tensors
it launches the kernel on the current stream of their device and allocates nothing; it
raises on anything the kernel does not take.  On CPU tensors, and only
there, it runs :func:`plain_accumulate_e`.  With ``box`` (a shard of a
sharded run, :class:`~fdtd_tpu_torch.grid.Box`) it adds a shard's owned
cells, read from the shard's arrays (the halo plane above filled), to the
shard's (nf, nc, cnk, cnj, cni) part of the sums (K4-shard).

:func:`fold` adds the levels a means-mode sweep buffered (the E cell
means of each step, (depth, 3, cells) fp32, :mod:`.stream`) to the E
components of the sums, in step order, as ``depth`` calls of
:func:`fdtd_tpu_torch.dft.accumulate` would: the sums are read and written
once a fold instead of once a step.  It replaces no TPU kernel: the TPU
kernels keep the sums of the cells in flight in VMEM, which a block's
shared memory cannot hold past a few frequencies.  On CUDA tensors it
launches the fold kernel of ``csrc/dft_accum.cu``, on CPU tensors, and only
there, :func:`plain_fold`.  A shard folds its own buffer into its part of
the sums: the kernel sees cells only, not their geometry.

``launches`` counts kernel launches; plain-version calls do not count.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import diagnostics
from ..dft import accumulate
from ..grid import Box
from ..params import Params
from ..state import FieldState
from . import build, yee

KERNEL_SOURCE = "dft_accum"
launches = {"dft_accum": 0, "dft_accum_shard": 0, "dft_fold": 0}
FOLD_MAX = 32  # the levels a fold takes at most (csrc/dft_accum.cu::FOLD_MAX; stream_plan.FOLD_DEPTH)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_bound: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = build.load(KERNEL_SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.dft_accum.argtypes = [ptr] + [i32] * 3 + [ptr, ptr, i32, i32, ptr, ptr, i32, ptr]
        lib.dft_accum.restype = i32
        lib.dft_fold.argtypes = [ptr, i32, ctypes.c_int64, ptr, i32, i32, ptr, ptr, ptr]
        lib.dft_fold.restype = i32
        lib.sar_accum.argtypes = [ptr] + [i32] * 3 + [ptr, ptr, ctypes.c_float, ptr, i32, ptr]  # ops/sar.py
        lib.sar_accum.restype = i32
        lib.dft_error_string.argtypes = [i32]
        lib.dft_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def plain_accumulate_e(p: Params, s: FieldState, weights: torch.Tensor, dacc, box: Box | None = None) -> None:
    """The plain version of the kernel: :func:`fdtd_tpu_torch.dft.
    accumulate` on the cell means of :func:`diagnostics._e_cell_means`
    (with ``box``, of a shard's owned cells)."""
    cells = box.local(*box.cells(p)) if box is not None else ()
    accumulate(diagnostics._e_cell_means(p, s, *cells), weights[0], weights[1], dacc)


def check_sums(p: Params, like: torch.Tensor, dacc, box: Box | None = None) -> tuple[int, int]:
    """(nf, nc) of the (re, im) sums, which must be contiguous fp32
    (nf, nc, maxk, maxj, maxi) tensors on the fields' device, nc 3 or 6
    (a shard's: its cell box, ``box``)."""
    re, im = dacc
    cells = box.cell_shape(p) if box is not None else (p.maxk, p.maxj, p.maxi)
    for a in (re, im):
        if (a.device != like.device or a.dtype != torch.float32 or a.dim() != 5 or tuple(a.shape[2:]) != cells
                or a.shape[1] not in (3, 6) or a.shape != re.shape or not a.is_contiguous()):
            raise ValueError(
                f"the DFT sums must be contiguous float32 (nf, 3 or 6, *{cells}) tensors on "
                f"{like.device}; got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    return re.shape[0], re.shape[1]


def check_weights(w: torch.Tensor, like: torch.Tensor, shape: tuple[int, ...]) -> None:
    if w.device != like.device or w.dtype != torch.float32 or tuple(w.shape) != shape or not w.is_contiguous():
        raise ValueError(f"the DFT weights must be a contiguous float32 {shape} tensor on {like.device}; got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")


def accumulate_e(p: Params, s: FieldState, weights: torch.Tensor, dacc, box: Box | None = None) -> None:
    """Add the step of the final state ``s`` to the E components of the
    (re, im) sums ``dacc`` in place; ``weights``: the step's (2, nf) fp32
    (cos, sin) row on the fields' device; ``box``: a shard's arrays and
    its part of the sums."""
    if box is not None and box.is_full(p):
        box = None
    dev = s.ex.device
    if any(t.device != dev for t in (s.ex, s.ey, s.ez)):
        raise ValueError("the E tensors must all be on one device")
    nf, nc = check_sums(p, s.ex, dacc, box)
    check_weights(weights, s.ex, (2, nf))
    if dev.type == "cpu":
        plain_accumulate_e(p, s, weights, dacc, box)
        return
    if dev.type != "cuda":
        raise ValueError(f"the DFT kernel runs on CUDA tensors; got device {dev}")
    dt = s.ex.dtype
    if dt not in _DTYPE_CODES:
        raise ValueError(f"the DFT kernel takes float32 or bfloat16 fields; got {dt}")
    shape = box.shape if box is not None else p.padded_shape
    for t in (s.ex, s.ey, s.ez):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"each E field must be a contiguous {dt} tensor of shape {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    lib = _lib()
    e_ptr = (ctypes.c_void_p * 3)(s.ex.data_ptr(), s.ey.data_ptr(), s.ez.data_ptr())
    with torch.cuda.device(dev):
        rc = lib.dft_accum(e_ptr, p.maxk, p.maxj, p.maxi, yee.geometry(p, box), weights.data_ptr(), nf, nc,
                           dacc[0].data_ptr(), dacc[1].data_ptr(), _DTYPE_CODES[dt], build.launch_stream(dev))
    name = "dft_accum_shard" if box is not None else "dft_accum"
    launches[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({lib.dft_error_string(rc).decode()})")


def plain_fold(means: torch.Tensor, weights: torch.Tensor, dacc) -> None:
    """The plain version of the fold kernel: :func:`fdtd_tpu_torch.dft.
    accumulate` of each buffered level in step order."""
    for d in range(weights.shape[0]):
        accumulate(tuple(means[d]), weights[d, 0], weights[d, 1], dacc)


def fold(means: torch.Tensor, weights: torch.Tensor, dacc) -> None:
    """Add the first ``depth`` = ``weights.shape[0]`` levels of the means
    buffer ``means`` ((>= depth, 3, *cells) fp32: each level's E cell
    means) to the E components of the (re, im) sums ``dacc`` ((nf, nc,
    *cells)) in place; ``weights``: the buffered steps' (depth, 2, nf) fp32
    (cos, sin) rows on the sums' device."""
    re, im = dacc
    depth = weights.shape[0] if weights.dim() == 3 else -1
    cells = tuple(re.shape[2:])
    if (means.dtype != torch.float32 or means.dim() != 5 or means.shape[1] != 3 or tuple(means.shape[2:]) != cells
            or not means.is_contiguous() or means.device != re.device or not 1 <= depth <= min(means.shape[0], FOLD_MAX)):
        raise ValueError(f"the fold takes a contiguous float32 (depth, 3, *{cells}) means buffer on {re.device} and "
                         f"1 to {FOLD_MAX} levels of it; got {means.dtype} {tuple(means.shape)} on {means.device}, "
                         f"weights {tuple(weights.shape)}")
    for a in (re, im):
        if (a.device != re.device or a.dtype != torch.float32 or a.dim() != 5 or a.shape != re.shape
                or a.shape[1] not in (3, 6) or not a.is_contiguous()):
            raise ValueError(f"the DFT sums must be contiguous float32 (nf, 3 or 6, *{cells}) tensors; got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
    nf, nc = re.shape[0], re.shape[1]
    check_weights(weights, re, (depth, 2, nf))
    dev = re.device
    if dev.type == "cpu":
        plain_fold(means, weights, dacc)
        return
    if dev.type != "cuda":
        raise ValueError(f"the fold kernel runs on CUDA tensors; got device {dev}")
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.dft_fold(means.data_ptr(), depth, math.prod(cells), weights.data_ptr(), nf, nc, re.data_ptr(),
                          im.data_ptr(), build.launch_stream(dev))
    launches["dft_fold"] += 1
    if rc != 0:
        raise RuntimeError(f"dft_fold launch failed: CUDA error {rc} ({lib.dft_error_string(rc).decode()})")
