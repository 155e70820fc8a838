"""sweep_ms_per_step (ms/step): device time of the field-update kernels
(the sweeps and the two passes: ring_kernel, pml_kernel, march_kernel,
h_kernel, e_kernel, ade_e_kernel) per simulated step of the window."""

from core import kernels
from core import trace as tr


def read(trace: dict, ctx: dict) -> float | None:
    us = sum(d for name, _, d, kind in tr.in_window(trace)
             if kind == "kernel" and kernels.base(name) in kernels.FIELD_UPDATE)
    if us <= 0 or trace["steps"] <= 0:
        return None
    return us / 1e3 / trace["steps"]
