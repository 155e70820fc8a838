"""dft_ms_per_step (ms/step): device time of the DFT monitors' kernels
(dft_fold_kernel, the means mode's fold, and dft_accum_kernel, the
per-step sums) per simulated step of the window."""

from core import kernels
from core import trace as tr


def read(trace: dict, ctx: dict) -> float | None:
    us = sum(d for name, _, d, kind in tr.in_window(trace) if kind == "kernel" and kernels.base(name) in kernels.DFT)
    if us <= 0 or trace["steps"] <= 0:
        return None
    return us / 1e3 / trace["steps"]
