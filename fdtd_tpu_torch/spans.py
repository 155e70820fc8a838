"""The program's named host spans, on the profiler's clock.

A span is a ``torch.profiler.record_function`` range, opened only while a
profiler records: it lands in the same trace as the kernels (one clock,
kept by the profiler and written out by whoever owns the profile, such as
the CLI's ``--profile DIR``).  With no profiler recording, :func:`span`
returns a shared null context, so a span costs one flag read.

The spans of one ``runner.run_simulation`` call:

    fdtd.run            the whole call
    fdtd.resolve        the backend's choice, the free-memory query and
                        the plan's check (under ``--shard`` the sharded
                        runner's build nests inside it)
    fdtd.runner_build   the chunk runner's build
    fdtd.coefs          the material coefficients (``state.update_coefs``,
                        the Debye maps), inside the runner's build
    fdtd.plan           the stream plan's pick, inside the runner's build
    fdtd.state_alloc    the state, the SAR map, psi, P and the DFT sums
    fdtd.resume         the checkpoint's load into them
    fdtd.loop           the chunk loop, between its two synchronizes (the
                        interval that ``RunResult.wall_seconds`` times)
    fdtd.chunk          one chunk's enqueue (the runners do not synchronize)
    fdtd.energy_log     one energy record (it waits for the device)
    fdtd.probe_rows     one chunk's probe rows copied to the host
    fdtd.snapshot, fdtd.checkpoint, fdtd.gather
                        an output: a snapshot, a checkpoint, the shards
                        gathered into the whole grid
    fdtd.finalize       after the loop: the DFT phasors on the host and the
                        probe rows' concatenation

and inside the chunk runners, each step: ``sar_increment`` (the SAR map's
increment: the ``sar_accum`` kernel's launch, or its torch ops on the
``torch`` backend and on CPU tensors), ``probe_gather`` (the probe row's
gather) and,
under ``--shard``, ``halo_exchange`` (the halo copies).
"""

from __future__ import annotations

import contextlib
import functools

import torch

RUN = "fdtd.run"
RESOLVE = "fdtd.resolve"
RUNNER_BUILD = "fdtd.runner_build"
COEFS = "fdtd.coefs"
PLAN = "fdtd.plan"
STATE_ALLOC = "fdtd.state_alloc"
RESUME = "fdtd.resume"
LOOP = "fdtd.loop"
CHUNK = "fdtd.chunk"
ENERGY_LOG = "fdtd.energy_log"
PROBE_ROWS = "fdtd.probe_rows"
SNAPSHOT = "fdtd.snapshot"
CHECKPOINT = "fdtd.checkpoint"
GATHER = "fdtd.gather"
FINALIZE = "fdtd.finalize"
SAR_INCREMENT = "sar_increment"
HALO_EXCHANGE = "halo_exchange"
PROBE_GATHER = "probe_gather"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler range ``name`` while a profiler
    records, else a null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """A decorator that runs the whole function inside :func:`span`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
