"""coefs_s (s): host time of the program's "fdtd.coefs" spans in the
window: the material coefficients built inside the runner's build
(state.update_coefs, fp64 edge averages on the host, and the Debye maps),
part of prologue_s."""

from core import spans


def read(trace: dict, ctx: dict) -> float | None:
    us = spans.total_us(trace, spans.COEFS)
    return None if us is None else us / 1e6
