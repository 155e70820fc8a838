"""The leapfrog step and the chunk runner.

One step replicates the reference loop body (reference: main.c:765-779):
[source] -> update_H -> [source] -> update_E, with the source applied twice
per step in computation mode.  Two backends:

- ``torch``: the plain slice updates of :mod:`fdtd_tpu_torch.ops.curl` on any
  device and dtype, the reference order step for step (the counterpart of
  the JAX package's ``xla`` backend, and the only fp64 path);
- ``twopass``: the Hopper kernels of :mod:`fdtd_tpu_torch.ops.yee` (the
  counterpart of ``pallas_fused``), fp32 or bf16.  The H kernel leaves the
  source patch of Hx/Hz at k=0 untouched, so the source is set once per
  step, before H: the second hard-set of the reference would write the same
  values again.  On CPU tensors the wrappers run their plain versions.

Steps update the state in place.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .ops import curl, yee
from .params import Mode, Params
from .source import apply_source, drive_values, make_source_plan, profile_tensor
from .state import FieldState, Materials, update_coefs

BACKENDS = ("torch", "twopass")

Step = Callable[[FieldState, tuple], None]


def make_step(p: Params, device, materials: Materials | None = None,
              backend: str = "torch") -> Step:
    """Build ``step(state, (t, amp))``, which advances ``state`` in place.

    ``amp`` is the drive amplitude sin(2*pi*f*t) (see :func:`scan_inputs`),
    a Python float or a 0-d fp64 tensor on ``device``; validation mode
    ignores it.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of {BACKENDS}")
    if backend == "twopass" and p.dtype == "float64":
        raise ValueError("the twopass kernels store float32 or bfloat16; float64 runs on the torch backend")
    coefs = update_coefs(p, materials)
    plan = make_source_plan(p) if p.mode == Mode.COMPUTATION else None
    profile = profile_tensor(plan, device) if plan is not None else None

    if backend == "twopass":
        patch = plan.patch if plan is not None else None

        def step(s: FieldState, x) -> None:
            if plan is not None:
                apply_source(plan, s, x[1], profile)
            yee.update_h(p, s, coefs, patch)
            yee.update_e(p, s, coefs)

        return step

    def step(s: FieldState, x) -> None:
        if plan is not None:
            apply_source(plan, s, x[1], profile)
        curl.update_h(p, s, coefs)
        if plan is not None:
            apply_source(plan, s, x[1], profile)
        curl.update_e(p, s, coefs)

    return step


def scan_inputs(p: Params, times) -> tuple[np.ndarray, np.ndarray]:
    """Per-step inputs (times, drive amplitudes), both host fp64 arrays;
    the amplitudes are zero in validation mode."""
    times = np.asarray(times, dtype=np.float64)
    if p.mode == Mode.COMPUTATION:
        amps = drive_values(make_source_plan(p), times)
    else:
        amps = np.zeros_like(times)
    return times, amps


def make_chunk_runner(p: Params, device, materials: Materials | None = None,
                      backend: str = "torch"):
    """``run(state, xs)``: advance ``state`` in place over the chunk
    ``xs = (times, amps)`` of :func:`scan_inputs`.

    The amplitudes go to the device once per chunk; the loop itself only
    enqueues work, with no host synchronisation inside it.
    """
    step = make_step(p, device, materials, backend)

    def run(s: FieldState, xs) -> FieldState:
        ts, amps = xs
        amps_dev = torch.as_tensor(np.asarray(amps, dtype=np.float64), device=device)
        for n in range(len(ts)):
            step(s, (ts[n], amps_dev[n]))
        return s

    return run
