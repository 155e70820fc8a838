"""enqueue_ms_per_step (ms/step): host time of the program's "fdtd.chunk"
spans in the window per simulated step.  The chunk runners do not
synchronize, so this is the host's cost of enqueueing a chunk's work, plus
any wait inside a chunk (such as a pageable upload's stream sync)."""

from core import spans


def read(trace: dict, ctx: dict) -> float | None:
    us = spans.total_us(trace, spans.CHUNK)
    if us is None or trace["steps"] <= 0:
        return None
    return us / 1e3 / trace["steps"]
