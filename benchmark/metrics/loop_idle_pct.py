"""loop_idle_pct (%): the device's idle share inside the program's
"fdtd.loop" span alone, 1 - (union of the device operations' intervals
inside the span) / (the span's length): device_idle_pct without the
call's prologue and epilogue."""

from core import spans
from core import trace as tr


def read(trace: dict, ctx: dict) -> float | None:
    loops = spans.found(trace, spans.LOOP)
    length = sum(e - s for s, e in loops)
    if length <= 0:
        return None
    busy = sum(tr.busy_us({**trace, "window": [s, e]}) for s, e in loops)
    return 100.0 * (1.0 - busy / length)
