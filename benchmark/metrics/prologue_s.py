"""prologue_s (s): host time from the call into run_simulation (the
start of the benchmark's span) to the start of the first field-update
kernel: the coefficients, the plan, the state, the runner and the
checkpoint's load, which users pay on every run."""

from core import kernels
from core import trace as tr


def read(trace: dict, ctx: dict) -> float | None:
    starts = [s for name, s, _, kind in tr.in_window(trace)
              if kind == "kernel" and kernels.base(name) in kernels.FIELD_UPDATE]
    if not starts:
        return None
    return (min(starts) - trace["window"][0]) / 1e6
