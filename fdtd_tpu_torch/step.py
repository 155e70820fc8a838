"""The leapfrog step and the chunk runner.

One step replicates the reference loop body (reference: main.c:765-779):
[source] -> update_H -> [source] -> update_E, with the source applied twice
per step in computation mode.  Three backends:

- ``torch``: the plain slice updates of :mod:`fdtd_tpu_torch.ops.curl` on any
  device and dtype, the reference order step for step (the counterpart of
  the JAX package's ``xla`` backend, and the only fp64 path);
- ``twopass``: the Hopper kernels of :mod:`fdtd_tpu_torch.ops.yee` (the
  counterpart of ``pallas_fused``), fp32 or bf16.  The H kernel leaves the
  source patch of Hx/Hz at k=0 untouched, so the source is set once per
  step, before H: the second hard-set of the reference would write the same
  values again.  On CPU tensors the wrappers run their plain versions;
- ``stream``: the streaming sweep kernel of :mod:`fdtd_tpu_torch.ops.stream`
  (the counterpart of ``pallas_stream``), fp32 or bf16: each launch
  advances the state by s steps (the plan of
  :mod:`fdtd_tpu_torch.ops.stream_plan`), and a chunk's trailing
  ``n % s`` steps run on the ``twopass`` kernels.  In fp32 it gives the
  bits of ``twopass``; in bf16 it keeps every step of a sweep in fp32 and
  rounds once per sweep.

Steps update the state in place; the ``stream`` chunk runner writes each
sweep into a second state of its own and swaps the tensors back into the
caller's :class:`FieldState`.

Materials (lossy and heterogeneous-mu_r media) run on all three backends:
the coefficient tensors are built once per runner on the device, and the
kernels take their material variants.  With ``accumulate_power`` the
chunk runner adds every step's deposition sigma*|E|^2*dt to an fp32
accumulator (:func:`zero_power_acc`) in place: after each step on
``torch`` as torch ops (``diagnostics.accumulate_power``, the JAX
package's per-step jnp increment, ``fdtd_tpu/step.py:385-403``) and on
``twopass`` in one launch of the ``sar_accum`` kernel
(:func:`~fdtd_tpu_torch.ops.sar.accumulate_power`, its plain version on
CPU tensors), on ``stream`` inside the sweep kernel, with the trailing
``n % s`` two-pass steps adding theirs through ``sar_accum``.  In
fp32 every backend gives the same accumulator bits; a bf16 sweep deposits
from its fp32 levels, not from rounded states.

CPML (``pml``, a :class:`~fdtd_tpu_torch.ops.cpml.PMLConfig`) runs on all
three backends; the twelve psi tensors (:class:`~fdtd_tpu_torch.ops.cpml.
PsiState`, :func:`~fdtd_tpu_torch.ops.cpml.init_psi`) ride beside the state
and are advanced in place: ``step(state, x, psi)`` and ``run(state, xs,
power, psi)``.  ``torch`` applies the corrections of ``ops/cpml.py`` after
each pass in the JAX package's xla order; ``twopass`` runs the CPML
variants of the two-pass kernels; ``stream`` the CPML sweeps (psi written
into a second set and swapped back, like the state), with the trailing
``n % s`` steps on the two-pass CPML kernels, on the same psi tensors.

Debye media (a :class:`~fdtd_tpu_torch.ops.dispersive.DebyeMaterials` as
``materials``) run on all three backends too, with the polarization
(:class:`~fdtd_tpu_torch.ops.dispersive.PolState`,
:func:`~fdtd_tpu_torch.ops.dispersive.zero_polarization`) beside the
state, advanced in place: ``step(state, x, pol)`` and ``run(state, xs,
power, psi, pol)``.  The H pass is the vacuum one; ``torch`` runs the ADE E
update of ``ops/dispersive.py``, ``twopass`` the ADE E kernel, ``stream``
the ADE sweep (P written into a second set and swapped back), with the
trailing ``n % s`` steps on the two-pass kernels.  With
``accumulate_power`` each step adds the Debye work of its E pass
(``diagnostics.accumulate_work``; inside the sweep on ``stream``).  Debye
media with CPML run on ``torch`` only
(``dispersive.make_dispersive_pml_step``: the JAX package has no kernel
for them either).

The frequency-domain monitors (``dft``, a :class:`~fdtd_tpu_torch.dft.
DftConfig`, and ``probes``, a :class:`~fdtd_tpu_torch.monitors.ProbeSet`)
ride every chunk runner: ``xs`` then carries the steps' (cos, sin) weight
rows (``(times, amps, cw, sw)``, :func:`~fdtd_tpu_torch.dft.dft_weights`
sliced to the chunk; they go to the device once per chunk) and the (re,
im) sums ``dacc`` (:func:`~fdtd_tpu_torch.dft.zero_dft_acc`) are updated
in place.  The per-step backends call
:func:`~fdtd_tpu_torch.monitors.apply_monitors` after every step (the
``dft_accum`` kernel for the E sums on ``twopass``, its plain version on
``torch``; torch ops for the H sums of ``fields="eh"`` and the probe
rows); ``stream`` carries the E sums in the DFT bands of its sweeps and
calls ``apply_monitors`` after its trailing two-pass steps.  Where the
bands cannot hold the frequencies, its plan takes their means mode
(``plan.fold``): each sweep stores its steps' E cell means into a buffer
of ``plan.fold`` levels, which the fold kernel (:func:`~fdtd_tpu_torch.
ops.dft.fold`) adds to the sums whenever it is full and at the end of
every chunk, before the trailing steps, so snapshots, the energy log,
checkpoints and the result always see whole sums.  Probes, the H
sums and validation mode need per-step states, so ``stream`` refuses
them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import diagnostics, spans
from .dft import DftConfig
from .monitors import ProbeSet, apply_monitors, weight_rows
from .ops import cpml, curl, dispersive, sar, stream, stream_plan, yee
from .ops import dft as dft_ops
from .ops.cpml import PMLConfig, PsiState
from .ops.dispersive import DebyeCoefs, DebyeMaterials, PolState
from .params import Mode, Params
from .source import (apply_source, drive_values, make_source_plan, profile_tensor,
                     sweep_drive_rows)
from .state import FieldState, Materials, UpdateCoefs, update_coefs

BACKENDS = ("torch", "twopass", "stream")

Step = Callable[..., None]


def make_step(p: Params, device, materials: Materials | DebyeMaterials | None = None,
              backend: str = "torch", coefs: UpdateCoefs | None = None,
              pml: PMLConfig | None = None) -> Step:
    """Build ``step(state, (t, amp))``, which advances ``state`` in place;
    with ``pml``, ``step(state, (t, amp), psi)``, which advances psi too;
    in a Debye medium, ``step(state, (t, amp), pol, psi=None, work=None)``,
    which advances the polarization (and writes the E pass's edge work
    into ``work``, :func:`~fdtd_tpu_torch.ops.dispersive.zero_work`).

    ``amp`` is the drive amplitude sin(2*pi*f*t) (see :func:`scan_inputs`),
    a Python float or a 0-d fp64 tensor on ``device``; validation mode
    ignores it.  ``coefs`` (built from ``materials`` on ``device`` when
    None) are the update coefficients.  A single step of ``stream`` is a
    ``twopass`` step (the sweeps need whole chunks:
    :func:`make_chunk_runner`).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of {BACKENDS}")
    if backend in ("twopass", "stream") and p.dtype == "float64":
        raise ValueError(f"the {backend} kernels store float32 or bfloat16; "
                         "float64 runs on the torch backend")
    if isinstance(materials, DebyeMaterials):
        return _debye_step(p, device, dispersive.debye_coefs(p, materials, device), backend, pml)
    if coefs is None:
        coefs = update_coefs(p, materials, device)
    plan = make_source_plan(p) if p.mode == Mode.COMPUTATION else None
    profile = profile_tensor(plan, device) if plan is not None else None
    if pml is not None and backend == "torch":
        return cpml.make_pml_step(p, pml, coefs, device)

    if backend in ("twopass", "stream"):
        cp = cpml.make_cpml(p, pml, coefs, device) if pml is not None else None
        return _kernel_step(p, coefs, plan, profile, cp)

    def step(s: FieldState, x) -> None:
        if plan is not None:
            apply_source(plan, s, x[1], profile)
        curl.update_h(p, s, coefs)
        if plan is not None:
            apply_source(plan, s, x[1], profile)
        curl.update_e(p, s, coefs)

    return step


def _kernel_step(p: Params, coefs: UpdateCoefs, plan, profile, cp: cpml.Cpml | None) -> Step:
    """The ``twopass`` step: the source once, then the H and E kernels
    (their CPML variants with ``cp``)."""
    patch = plan.patch if plan is not None else None

    def step(s: FieldState, x, psi: PsiState | None = None) -> None:
        if plan is not None:
            apply_source(plan, s, x[1], profile)
        yee.update_h(p, s, coefs, patch, cp, psi)
        yee.update_e(p, s, coefs, cp, psi)

    return step


def _debye_step(p: Params, device, dc: DebyeCoefs, backend: str, pml: PMLConfig | None) -> Step:
    """The step of a Debye medium: ``step(s, x, pol, psi=None, work=None)``.
    ``torch``: the reference order with the ADE E update (with ``pml``,
    :func:`~fdtd_tpu_torch.ops.dispersive.make_dispersive_pml_step`);
    ``twopass`` and ``stream``: the source once, the vacuum H kernel and
    the ADE E kernel."""
    if pml is not None:
        if backend != "torch":
            raise ValueError(f"Debye media with CPML run the torch ADE+CPML ops, not the {backend} kernels "
                             "(the JAX package has no kernel for them either); use --backend torch")
        pml_step = dispersive.make_dispersive_pml_step(p, dc, pml, device)

        def step(s: FieldState, x, pol: PolState, psi: PsiState | None = None, work=None) -> None:
            _need_psi(pml, psi)
            pml_step(s, x, pol, psi, work)

        return step
    hcoefs = update_coefs(p)  # the vacuum H factor
    plan = make_source_plan(p) if p.mode == Mode.COMPUTATION else None
    profile = profile_tensor(plan, device) if plan is not None else None
    if backend == "torch":
        def step(s: FieldState, x, pol: PolState, psi: PsiState | None = None, work=None) -> None:
            if plan is not None:
                apply_source(plan, s, x[1], profile)
            curl.update_h(p, s, hcoefs)
            if plan is not None:
                apply_source(plan, s, x[1], profile)
            dispersive.update_e_ade(p, s, pol, dc, work)

        return step
    patch = plan.patch if plan is not None else None

    def kernel_step(s: FieldState, x, pol: PolState, psi: PsiState | None = None, work=None) -> None:
        if plan is not None:
            apply_source(plan, s, x[1], profile)
        yee.update_h(p, s, hcoefs, patch)
        yee.update_e_ade(p, s, pol, dc, work)

    return kernel_step


def zero_power_acc(p: Params, device) -> torch.Tensor:
    """The fp32 (maxk, maxj, maxi) deposited-energy accumulator (J/m^3),
    zero."""
    return torch.zeros((p.maxk, p.maxj, p.maxi), dtype=torch.float32, device=device)


def scan_inputs(p: Params, times) -> tuple[np.ndarray, np.ndarray]:
    """Per-step inputs (times, drive amplitudes), both host fp64 arrays;
    the amplitudes are zero in validation mode."""
    times = np.asarray(times, dtype=np.float64)
    if p.mode == Mode.COMPUTATION:
        amps = drive_values(make_source_plan(p), times)
    else:
        amps = np.zeros_like(times)
    return times, amps


def make_chunk_runner(p: Params, device, materials: Materials | DebyeMaterials | None = None,
                      backend: str = "torch", stream_s: int | None = None,
                      accumulate_power: bool = False, pml: PMLConfig | None = None,
                      dft: DftConfig | None = None, probes: ProbeSet | None = None,
                      dc: DebyeCoefs | None = None, memory_bytes: int | None = None):
    """``run(state, xs, power=None, psi=None, pol=None, dacc=None)``:
    advance ``state`` in place over the chunk ``xs = (times, amps)`` of
    :func:`scan_inputs`, and with ``accumulate_power`` add each step's
    deposition to ``power`` (the fp32 map of :func:`zero_power_acc`) in
    place; with ``pml`` advance ``psi``
    (:func:`~fdtd_tpu_torch.ops.cpml.init_psi`) in place too, and in a
    Debye medium ``pol``
    (:func:`~fdtd_tpu_torch.ops.dispersive.zero_polarization`).  With
    ``dft``, ``xs = (times, amps, cw, sw)`` and each step is added to the
    (re, im) sums ``dacc`` in place.  Returns ``state``, or with
    ``probes`` the chunk's probe rows, a (n, n_probes, 6) fp32 tensor on
    the device.  ``stream_s`` forces the steps per sweep of the ``stream``
    backend (still checked to fit), and ``memory_bytes`` the device memory
    its plan is sized for (None: the H100's 80 GB), so that the plan and
    the means buffer it allocates are those that ``runner.resolve_backend``
    checked against the device's free memory.  ``dc``: the Debye maps of
    ``materials`` on ``device`` when already built
    (:func:`~fdtd_tpu_torch.ops.dispersive.debye_coefs`, a few seconds of
    host time at 256^3).

    The amplitudes and the DFT weights go to the device once per chunk;
    the loop itself only enqueues work, with no host synchronisation inside
    it.
    """
    debye = isinstance(materials, DebyeMaterials)
    with spans.span(spans.COEFS):
        if not debye:
            dc = None
        elif dc is None:
            dc = dispersive.debye_coefs(p, materials, device)
        coefs = update_coefs(p, None if debye else materials, device)
    if probes is not None:
        probes.validate(p)
    cells = probes.cells if probes is not None else None
    if backend == "stream":
        if probes is not None or (dft is not None and not stream_plan.dft_gates(p, dft)):
            raise ValueError("probes, the H sums of --dft-fields eh and the DFT in validation mode need per-step "
                             "states; the stream backend steps s at a time (use twopass or torch)")
        with spans.span(spans.PLAN):
            plan = stream_plan.pick_plan(p, s=stream_s, memory_bytes=memory_bytes, lossy=coefs.lossy,
                                         het=coefs.heterogeneous_mu, sar=accumulate_power, pml=pml, ade=debye,
                                         dft=dft)
        if plan is None:
            kind = "Debye" if debye else "materials" if coefs.lossy else "vacuum"
            raise ValueError(
                f"no stream plan fits {p.maxk}x{p.maxj}x{p.maxi} {p.dtype} "
                f"({kind}, {p.mode.name.lower()} mode"
                f"{', SAR' if accumulate_power else ''}{', CPML' if pml else ''}): the sweep needs a "
                "second copy of the state in device memory, materials and Debye media stream in "
                "computation mode only, SAR needs materials, the CPML sweep takes computation mode, "
                "uniform mu_r, no SAR and a source patch clear of the j and i slabs, and Debye media "
                "with CPML run on the torch backend"
            )
        cp = cpml.make_cpml(p, pml, coefs, device) if pml is not None else None
        return _stream_chunk_runner(p, device, plan, coefs, accumulate_power, cp, dc, dft)
    if debye:
        step = _debye_step(p, device, dc, backend, pml)
    else:
        step = make_step(p, device, backend=backend, coefs=coefs, pml=pml)
    work = dispersive.zero_work(p, device) if debye and accumulate_power else None
    deposit = sar.accumulate_power if backend != "torch" else diagnostics.accumulate_power

    def run(s: FieldState, xs, power: torch.Tensor | None = None,
            psi: PsiState | None = None, pol: PolState | None = None, dacc=None):
        _need_power(accumulate_power, power)
        _need_psi(pml, psi)
        _need_pol(dc, pol)
        ts, amps, w_dev = _chunk_inputs(xs, dft, dacc, device)
        amps_dev = torch.as_tensor(np.asarray(amps, dtype=np.float64), device=device)
        rows = []
        for n in range(len(ts)):
            if debye:
                step(s, (ts[n], amps_dev[n]), pol, psi, work)
            elif pml is not None:
                step(s, (ts[n], amps_dev[n]), psi)
            else:
                step(s, (ts[n], amps_dev[n]))
            if dft is not None or cells is not None:
                row = apply_monitors(p, s, w_dev[n] if w_dev is not None else None, dft, cells, dacc,
                                     kernel=backend != "torch")
                if row is not None:
                    rows.append(row)
            if work is not None:
                diagnostics.accumulate_work(p, work, power)
            elif accumulate_power:
                deposit(p, s, coefs.sigma_cells, power)
        if cells is not None:
            return torch.stack(rows) if rows else torch.zeros((0, len(cells), 6), dtype=torch.float32, device=device)
        return s

    return run


def _chunk_inputs(xs, dft: DftConfig | None, dacc, device):
    """(times, amps, the (n, 2, nf) weight rows on the device or None) of a
    chunk's inputs."""
    if dft is None:
        ts, amps = xs
        return ts, amps, None
    if len(xs) != 4:
        raise ValueError("a DFT chunk takes xs = (times, amps, cw, sw) (dft.dft_weights sliced to the chunk)")
    if dacc is None:
        raise ValueError("a DFT chunk needs its (re, im) sums (dft.zero_dft_acc)")
    ts, amps, cw, sw = xs
    return ts, amps, weight_rows(cw, sw, device)


def _need_power(accumulate_power: bool, power) -> None:
    if accumulate_power and power is None:
        raise ValueError("accumulate_power needs the power accumulator (zero_power_acc)")


def _need_psi(pml, psi) -> None:
    if pml is not None and psi is None:
        raise ValueError("a CPML chunk needs its psi state (ops.cpml.init_psi)")


def _need_pol(dc, pol) -> None:
    if dc is not None and pol is None:
        raise ValueError("a Debye chunk needs its polarization (ops.dispersive.zero_polarization)")


def _stream_chunk_runner(p: Params, device, plan: stream_plan.StreamPlan, coefs: UpdateCoefs,
                         accumulate_power: bool, cp: cpml.Cpml | None, dc: DebyeCoefs | None = None,
                         dft: DftConfig | None = None):
    """``n // s`` sweeps of the stream kernel, then ``n % s`` twopass steps
    (the counterpart of ``fdtd_tpu/step.py``'s ``run_stream``); with CPML
    (``cp``) each sweep writes psi into a second set, swapped back, and in
    a Debye medium (``dc``) the polarization likewise; with ``dft`` the
    sweeps carry the DFT bands (or their means mode, folded into the sums
    when the buffer is full and at the chunk's end) and the trailing steps
    run the ``dft_accum`` kernel."""
    s_steps = plan.s
    src = make_source_plan(p) if p.mode == Mode.COMPUTATION else None
    profile = profile_tensor(src, device) if src is not None else None
    if dc is not None:
        odd_step = _debye_step(p, device, dc, "twopass", None)
    else:
        odd_step = _kernel_step(p, coefs, src, profile, cp)
    spare: list = []  # the second state (and psi or P set), allocated at first use
    trailing_work: list = []  # the Debye SAR's edge work of the trailing steps, at first use
    means_buf: list = []  # the means mode's buffer of plan.fold levels, at first use

    def run(s: FieldState, xs, power: torch.Tensor | None = None,
            psi: PsiState | None = None, pol: PolState | None = None, dacc=None) -> FieldState:
        _need_power(accumulate_power, power)
        _need_psi(cp, psi)
        _need_pol(dc, pol)
        acc = power if accumulate_power else None
        ts, amps, w_dev = _chunk_inputs(xs, dft, dacc, device)
        n = len(ts)
        n_sw = n // s_steps
        amps_dev = torch.as_tensor(np.asarray(amps, dtype=np.float64), device=device)
        if n_sw:
            if not spare or spare[0].ex.shape != s.ex.shape or spare[0].ex.dtype != s.ex.dtype \
                    or spare[0].ex.device != s.ex.device:
                spare[:] = [FieldState(*(torch.empty_like(t) for t in s.tensors())),
                            psi.clone() if cp is not None else None,
                            pol.clone() if dc is not None else None]
            out, psi_out, pol_out = spare
            if src is not None:
                ez_rows, hx_rows = sweep_drive_rows(src, amps_dev, s_steps, s.ex.dtype, profile)
            if plan.fold and not means_buf:
                means_buf.append(torch.empty(stream.means_shape(p, plan.fold), dtype=torch.float32, device=device))
            level = 0  # the means mode's levels in the buffer
            for g in range(n_sw):
                drive = None
                if src is not None:
                    apply_source(src, s, amps_dev[g * s_steps], profile)
                    drive = stream.SweepDrive(src.patch, ez_rows[g], hx_rows[g])
                wts = w_dev[g * s_steps:(g + 1) * s_steps] if w_dev is not None else None
                if plan.fold:
                    if level == plan.fold:
                        dft_ops.fold(means_buf[0], w_dev[g * s_steps - level:g * s_steps], dacc)
                        level = 0
                    stream.sweep(p, s, out, coefs, plan, drive, acc, cp, psi, psi_out, dc, pol, pol_out,
                                 means=means_buf[0][level:level + s_steps])
                    level += s_steps
                else:
                    stream.sweep(p, s, out, coefs, plan, drive, acc, cp, psi, psi_out, dc, pol, pol_out,
                                 dacc if dft is not None else None, wts)
                s.swap(out)
                if cp is not None:
                    psi.swap(psi_out)
                if dc is not None:
                    pol.swap(pol_out)
            if level:  # the chunk's last levels, before the trailing steps add theirs
                dft_ops.fold(means_buf[0], w_dev[n_sw * s_steps - level:n_sw * s_steps], dacc)
        if dc is not None and acc is not None and n % s_steps and not trailing_work:
            trailing_work.append(dispersive.zero_work(p, device))
        work = trailing_work[0] if trailing_work else None
        for r in range(n_sw * s_steps, n):
            if dc is not None:
                odd_step(s, (ts[r], amps_dev[r]), pol, None, work)
            elif cp is not None:
                odd_step(s, (ts[r], amps_dev[r]), psi)
            else:
                odd_step(s, (ts[r], amps_dev[r]))
            if dft is not None:
                apply_monitors(p, s, w_dev[r], dft, None, dacc)
            if work is not None:
                diagnostics.accumulate_work(p, work, acc)
            elif acc is not None:
                sar.accumulate_power(p, s, coefs.sigma_cells, acc)
        return s

    run.plan = plan
    return run
