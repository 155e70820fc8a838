"""resume_s (s): host time of the program's "fdtd.resume" spans in the
window: the checkpoint found, loaded and copied into the state, the SAR
map, psi, P and the monitors' sums, part of prologue_s."""

from core import spans


def read(trace: dict, ctx: dict) -> float | None:
    us = spans.total_us(trace, spans.RESUME)
    return None if us is None else us / 1e6
