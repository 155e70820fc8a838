"""Wrappers of the two-pass Hopper kernels (``csrc/yee_twopass.cu``).

``update_h`` and ``update_e`` replace the TPU kernels
``fdtd_tpu/ops/pallas_fused.py::_h_kernel2`` and ``::_e_kernel2``: the
vacuum kernels take scalar factors; with materials, ``update_h`` launches
the heterogeneous-mu_r variant (``hf_x/y/z`` arrays) when the coefficients
carry them, and ``update_e`` the lossy variant (six ca/cb arrays).  On
CUDA tensors they launch the kernel on the current stream, in place,
allocating nothing; they raise on anything the kernel does not take
(another dtype, shape, device or a non-contiguous tensor).  On CPU
tensors, and only there, they run the plain versions in
:mod:`fdtd_tpu_torch.ops.curl`.

``launches`` counts kernel launches per kernel variant, so a run can show
that it went through the kernels; plain-version calls do not count.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import Params
from ..state import FieldState, UpdateCoefs
from . import build, curl

KERNEL_SOURCE = "yee_twopass"
launches = {"yee_update_h": 0, "yee_update_e": 0, "yee_update_h_het": 0, "yee_update_e_lossy": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_bound: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        lib = build.load(KERNEL_SOURCE)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.yee_update_h.argtypes = [ptr] * 6 + [i32] * 3 + [f32] + [i32] * 5 + [i32, ptr]
        lib.yee_update_h.restype = i32
        lib.yee_update_e.argtypes = [ptr] * 6 + [i32] * 3 + [f32] + [i32, ptr]
        lib.yee_update_e.restype = i32
        lib.yee_update_h_het.argtypes = [ptr] * 3 + [i32] * 3 + [i32] * 5 + [i32, ptr]
        lib.yee_update_h_het.restype = i32
        lib.yee_update_e_lossy.argtypes = [ptr] * 3 + [i32] * 3 + [i32, ptr]
        lib.yee_update_e_lossy.restype = i32
        lib.yee_error_string.argtypes = [i32]
        lib.yee_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _on_cpu(p: Params, s: FieldState) -> bool:
    """True when the whole state is on the CPU; validates a CUDA state for
    the kernels and raises on anything else."""
    tensors = s.tensors()
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all six field tensors must be on one device")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"the Yee kernels run on CUDA tensors; got device {dev}")
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODES:
        raise ValueError(f"the Yee kernels take float32 or bfloat16 fields; got {dt}")
    for t in tensors:
        if t.dtype != dt or tuple(t.shape) != p.padded_shape or not t.is_contiguous():
            raise ValueError(
                f"each field must be a contiguous {dt} tensor of shape {p.padded_shape}; "
                f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    return False


def check_coefficients(p: Params, like: torch.Tensor, arrays: tuple[torch.Tensor, ...]) -> None:
    """Coefficient arrays must match the fields: device, dtype, the padded
    shape, contiguous."""
    for a in arrays:
        if (a.device != like.device or a.dtype != like.dtype or tuple(a.shape) != p.padded_shape
                or not a.is_contiguous()):
            raise ValueError(
                f"coefficient arrays must be contiguous {like.dtype} tensors of shape "
                f"{p.padded_shape} on {like.device}; got {a.dtype} {tuple(a.shape)} on {a.device}"
            )


def pointers(tensors) -> ctypes.Array:
    """A C array of the tensors' data pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _check(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().yee_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def update_h(p: Params, s: FieldState, coefs: UpdateCoefs,
             patch: tuple[int, int, int, int] | None = None) -> None:
    """H half-step in place; ``patch`` as in :func:`curl.update_h`."""
    if _on_cpu(p, s):
        curl.update_h(p, s, coefs, patch)
        return
    lib = _lib()
    j0, j1, i0, i1 = patch if patch is not None else (0, 0, 0, 0)
    dtype = _DTYPE_CODES[s.hx.dtype]
    with torch.cuda.device(s.hx.device):
        stream = torch.cuda.current_stream().cuda_stream
        if coefs.heterogeneous_mu:
            hf = (coefs.hf_x, coefs.hf_y, coefs.hf_z)
            check_coefficients(p, s.hx, hf)
            name = "yee_update_h_het"
            rc = lib.yee_update_h_het(
                pointers((s.ex, s.ey, s.ez)), pointers((s.hx, s.hy, s.hz)), pointers(hf),
                p.maxk, p.maxj, p.maxi, int(patch is not None), j0, j1, i0, i1, dtype, stream,
            )
        else:
            name = "yee_update_h"
            rc = lib.yee_update_h(
                *(t.data_ptr() for t in s.tensors()),
                p.maxk, p.maxj, p.maxi, curl.scalar(coefs.h_factor, s.hx.dtype),
                int(patch is not None), j0, j1, i0, i1, dtype, stream,
            )
    launches[name] += 1
    _check(rc, name)


def update_e(p: Params, s: FieldState, coefs: UpdateCoefs) -> None:
    """E half-step in place: one scalar cb in vacuum, the ca/cb arrays of
    ``coefs`` with materials."""
    if _on_cpu(p, s):
        curl.update_e(p, s, coefs)
        return
    lib = _lib()
    dtype = _DTYPE_CODES[s.ex.dtype]
    with torch.cuda.device(s.ex.device):
        stream = torch.cuda.current_stream().cuda_stream
        if coefs.lossy:
            cf = (coefs.ca_x, coefs.ca_y, coefs.ca_z, coefs.cb_x, coefs.cb_y, coefs.cb_z)
            check_coefficients(p, s.ex, cf)
            name = "yee_update_e_lossy"
            rc = lib.yee_update_e_lossy(
                pointers((s.hx, s.hy, s.hz)), pointers((s.ex, s.ey, s.ez)), pointers(cf),
                p.maxk, p.maxj, p.maxi, dtype, stream,
            )
        else:
            name = "yee_update_e"
            rc = lib.yee_update_e(
                s.hx.data_ptr(), s.hy.data_ptr(), s.hz.data_ptr(),
                s.ex.data_ptr(), s.ey.data_ptr(), s.ez.data_ptr(),
                p.maxk, p.maxj, p.maxi, curl.scalar(coefs.cb_x, s.ex.dtype), dtype, stream,
            )
    launches[name] += 1
    _check(rc, name)
