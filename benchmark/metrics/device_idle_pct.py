"""device_idle_pct (%): the share of the traced window in which no device
operation runs, 1 - (union of the device operations' intervals) / (the
window's wall time).  The window is the benchmark's span around the
run_simulation call, so the per-run prologue counts."""

from core import trace as tr


def read(trace: dict, ctx: dict) -> float | None:
    window = tr.window_us(trace)
    if window <= 0 or not tr.in_window(trace):
        return None
    return 100.0 * (1.0 - tr.busy_us(trace) / window)
