"""finalize_s (s): host time of the program's "fdtd.finalize" spans in
the window: the epilogue after the chunk loop, the DFT sums copied to the
host and turned into fp64 complex phasors, and the probe rows
concatenated."""

from core import spans


def read(trace: dict, ctx: dict) -> float | None:
    us = spans.total_us(trace, spans.FINALIZE)
    return None if us is None else us / 1e6
