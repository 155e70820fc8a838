"""The program's own host spans in a summary (``core.trace.summarize``):
the ``torch.profiler`` ranges that ``fdtd_tpu_torch/spans.py`` opens, kept
in ``cpu_ops`` on the same clock as the device operations.  The names are
the program's, copied here: nothing here imports the program.  A program
that opens no such span gives nothing to read.
"""

from __future__ import annotations

COEFS = "fdtd.coefs"  # the material coefficients' build, in the runner's build
RESUME = "fdtd.resume"  # the checkpoint's load
FINALIZE = "fdtd.finalize"  # after the loop: the DFT phasors on the host, the probe rows
LOOP = "fdtd.loop"  # the chunk loop between its two synchronizes
CHUNK = "fdtd.chunk"  # one chunk's enqueue


def found(trace: dict, name: str) -> list[tuple[float, float]]:
    """(start_us, end_us) of each host span ``name`` that starts inside
    the window."""
    a, b = trace["window"]
    return [(s, e) for n, s, e in trace["cpu_ops"] if n == name and a <= s < b]


def total_us(trace: dict, name: str) -> float | None:
    """The host time of the spans ``name`` in the window, or None where
    the program opened none."""
    spans = found(trace, name)
    return sum(e - s for s, e in spans) if spans else None
