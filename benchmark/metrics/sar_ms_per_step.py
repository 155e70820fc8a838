"""sar_ms_per_step (ms/step): device time of the kernels launched inside
the program's "sar_increment" profiler range (the per-step SAR increment
as torch ops, diagnostics.accumulate_power) per simulated step of the
window.  A sweep that deposits inside its kernel opens no range: then
there is nothing to read."""

LABEL = "sar_increment"


def read(trace: dict, ctx: dict) -> float | None:
    a, b = trace["window"]
    us = sum(dev for s, _, dev in trace["ranges"].get(LABEL, []) if a <= s < b)
    if us <= 0 or trace["steps"] <= 0:
        return None
    return us / 1e3 / trace["steps"]
