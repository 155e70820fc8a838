"""ctypes binding of the C++ snapshot writer ``native/libfdtd_io.so``.

The library is the same one the JAX package uses (``native/fdtd_io.cpp``,
built by ``make -C native``); it has no JAX in it.  It is built on first use
when a C++ toolchain is present.  Where it is unavailable the callers write
with the pure-Python :mod:`fdtd_tpu_torch.io.vtr`, whose output is
byte-identical.  ctypes calls release the GIL, so native encodes overlap the
step loop when they run on the snapshot worker threads.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfdtd_io.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        r = subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return r.returncode == 0 and os.path.exists(_LIB_PATH)


def get_lib():
    """The loaded library, or None if it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.fdtd_write_vtr.restype = ctypes.c_int
        lib.fdtd_write_vtr.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def write_vtr_native(path: str, coords, cell_arrays: dict[str, np.ndarray]) -> bool:
    """Write via the C++ library; returns False if it is unavailable (the
    caller then uses :func:`fdtd_tpu_torch.io.vtr.write_vtr`)."""
    lib = get_lib()
    if lib is None:
        return False
    x, y, z = (np.ascontiguousarray(c, dtype=np.float64) for c in coords)
    names, datas, dtypes, keep = [], [], [], []  # keep: ndarray refs alive across the call
    expected = (len(z) - 1, len(y) - 1, len(x) - 1)
    for name, arr in cell_arrays.items():
        a = np.ascontiguousarray(arr)
        if a.dtype == np.float64:
            dt = 1
        else:
            a = np.ascontiguousarray(a, dtype=np.float32)
            dt = 0
        if a.shape != expected:
            raise ValueError(f"{name}: shape {a.shape} != {expected}")
        keep.append(a)
        names.append(name.encode())
        datas.append(a.ctypes.data_as(ctypes.c_void_p))
        dtypes.append(dt)

    n = len(names)
    rc = lib.fdtd_write_vtr(
        path.encode(),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(x),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(y),
        z.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(z),
        n,
        (ctypes.c_char_p * n)(*names),
        (ctypes.c_void_p * n)(*datas),
        (ctypes.c_int * n)(*dtypes),
    )
    if rc != 0:
        raise OSError(f"fdtd_write_vtr failed with code {rc} for {path}")
    return True
