"""kernels_roofline_pct (%): the least time the card could take for the
step's operations, ops / 67 TFLOP/s (fp32 outside the tensor cores, the
H100 SXM data sheet), over the device time of all kernels per step.

The operations are counted once from the plain reference's update
(core/opcount.py: Yee H and E, the loss terms, the SAR map, the DFT
sums, the probes, the energy log), whatever the implementation does.
Bytes are not counted: a temporally blocked sweep reads the state once
per s steps, so the bytes a step moves depend on the plan."""

from core import trace as tr


def read(trace: dict, ctx: dict) -> float | None:
    us = sum(d for _, _, d, kind in tr.in_window(trace) if kind == "kernel")
    if us <= 0 or trace["steps"] <= 0:
        return None
    least_us = ctx["ops_per_step"] / ctx["peak_flops"] * 1e6
    return 100.0 * least_us / (us / trace["steps"])
