"""Wrapper of the streaming sweep kernel (``csrc/yee_stream.cu``).

:func:`sweep` replaces the TPU kernel
``fdtd_tpu/ops/pallas_stream.py::_kernel`` on a single device: one
launch advances the state by ``plan.s`` leapfrog steps.  It reads
``state`` and writes ``out``, a second state of the same shape (blocks run
concurrently, so the sweep cannot work in place).  With materials the
coefficient arrays of ``coefs`` (lossy ca/cb, heterogeneous-mu_r hf) ride
along, and with ``acc`` the sweep adds every step's sigma*|E|^2*dt to that
fp32 map in place, as S per-step increments would.  With ``cpml`` it is
the CPML sweep (vacuum or lossy), replacing
``fdtd_tpu/ops/pallas_stream_pml.py::_kernel_pml``: it reads the twelve
psi of ``psi`` and writes them advanced into ``psi_out`` (a second set,
as for the fields), in two launches (``plan.core``: the psi-free interior
on the K3 sweep, counted under ``plan.kernel`` + ``_interior``; the shell
on the CPML kernel's block list, ``plan.pml_blocks``).  With ``dc`` (Debye media,
:class:`~fdtd_tpu_torch.ops.dispersive.DebyeCoefs`) it is the ADE sweep,
replacing ``fdtd_tpu/ops/pallas_dispersive.py::_kernel_ade_stream``: the
H update is vacuum, the E update the ADE update of ``dc``; it reads the
polarization ``pol`` and writes it advanced into ``pol_out``, and with
``acc`` it adds every step's Debye work (``diagnostics.accumulate_work``)
to the map.  With ``dacc`` (the canonical (re, im) fp32 DFT sums of
:func:`fdtd_tpu_torch.dft.zero_dft_acc`, fields "e") and ``wts`` (the
sweep's (s, 2, nf) fp32 (cos, sin) rows on the device) it is the variant
with the DFT bands of the three TPU kernels: every step's E cell means,
weighted, are added to the sums in place, as s per-step
:func:`fdtd_tpu_torch.dft.accumulate` calls would.  With ``means``
instead (a plan with ``fold``: the bands' means mode, for more
frequencies than a block's shared memory holds), the sweep writes every
step's three E cell means, fp32, into ``means[m - 1]`` (an (s, 3, *cells)
slice of the run's buffer) and touches no sums: the caller folds the
buffer into them (:func:`fdtd_tpu_torch.ops.dft.fold`), counted under the
variant's name with ``_dft_means``.  On CUDA tensors it launches the kernel variant
``plan.kernel`` on the current stream of their device and allocates
nothing; it raises on anything the kernel does not take (a bf16 array that
does not start 4-byte aligned among them: the kernels copy aligned words
ahead into shared memory).  On CPU tensors, and only there, it runs
:func:`plain_sweep`.

With ``box`` (a :class:`~fdtd_tpu_torch.grid.Box`: a shard of a sharded
run, :mod:`fdtd_tpu_torch.parallel`) it advances a shard in its own arrays,
replacing ``fdtd_tpu/ops/pallas_stream.py::build_stream_shard_call`` (and
its j-tiled form ``_build_stream_shard_call_jt``: this sweep always tiles
j and i): the arrays hold ``plan.s`` halo planes on each side the shard
shares with a neighbour (``plan.s + 1`` with SAR), filled by the caller
before the sweep, and only the owned window of ``out`` is written; the SAR
map, sigma and the DFT sums are the shard's parts (its owned cells).  The
vacuum and material variants shard, with or without the DFT bands (those
replace ``build_stream_shard_call(dft_nf > 0)``); the CPML and Debye sweeps
have no shard variant (nor have they in the JAX package).

Source: the caller hard-sets step 1 on ``state`` (``source.apply_source``)
before the sweep; ``drive`` carries steps 2..s (``source.sweep_drive_rows``).

``launches`` counts kernel launches per variant (a shard's under the
variant's name with ``_shard``), and ``staged_launches`` the bfloat16
launches of ``ring_kernel`` (every sweep but a CPML sweep's shell), whose
planes reach shared memory as whole aligned words staged by the warp;
plain-version calls count in neither.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import diagnostics
from ..dft import accumulate
from ..grid import Box
from ..params import Params
from ..state import FieldState, UpdateCoefs
from . import build, curl, dispersive, yee
from .cpml import TERM_NAMES, Cpml, PsiState
from .dispersive import DebyeCoefs, PolState
from .dft import check_sums, check_weights
from .stream_plan import SHARD_VARIANTS, VARIANTS, StreamPlan, variant_name

INTERIOR = "_interior"  # the launch counter suffix of a CPML sweep's interior

KERNEL_SOURCE = "yee_stream"
# the means mode's instantiations: a build of the same source of their own
# (csrc/yee_stream.cu, "DFT"), which compiles beside the default one
FOLD_DEFINES = ("YEE_STREAM_FOLD",)
# every variant, and the means mode of each DFT variant (v[5])
_KINDS = [(v, means) for v in VARIANTS for means in ((False, True) if v[5] else (False,))]
launches = {variant_name(*v, means): 0 for v, means in _KINDS}
launches.update({variant_name(*v, means) + "_shard": 0 for v, means in _KINDS if v in SHARD_VARIANTS})
# the interior launch of a CPML sweep (ring_kernel on the psi-free window)
launches.update({variant_name(*v, means) + INTERIOR: 0 for v, means in _KINDS if v[3]})
staged_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_bound: ctypes.CDLL | None = None
_bound_fold: ctypes.CDLL | None = None


@dataclasses.dataclass(frozen=True)
class SweepDrive:
    """The source of steps 2..s of one sweep: ``patch`` = (j0, j1, i0, i1)
    of the k=0 rectangle, and the Ez and Hx rows, each (s - 1, i1 - i0) in
    the storage dtype (Ex and Hz are set to zero there)."""

    patch: tuple[int, int, int, int]
    ez_rows: torch.Tensor
    hx_rows: torch.Tensor


def reset_launches() -> None:
    global staged_launches
    for name in launches:
        launches[name] = 0
    staged_launches = 0


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        _bound = _declare(build.load(KERNEL_SOURCE))
    return _bound


def _lib_fold() -> ctypes.CDLL:
    """The means mode's build of the sweeps' source (``FOLD_DEFINES``)."""
    global _bound_fold
    if _bound_fold is None:
        _bound_fold = _declare(ctypes.CDLL(str(build.build(KERNEL_SOURCE, defines=FOLD_DEFINES))))
    return _bound_fold


def use_library(path) -> None:
    """Launch the sweeps from the library at ``path``, a build of
    csrc/yee_stream.cu with macros of its own (``build.build(...,
    defines=...)``), instead of the default build."""
    global _bound
    _bound = _declare(ctypes.CDLL(str(path)))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of its C interface set."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.yee_stream_sweep.argtypes = (
        [ptr, ptr] + [i32] * 3 + [ptr, ptr] + [f32, f32] + [i32] * 10 + [ptr] * 6 + [f32] + [ptr] * 4 + [i32]
        + [ptr, i32] + [ptr] * 5 + [i32, i32, ptr, i32, ptr]
    )
    lib.yee_stream_sweep.restype = i32
    lib.yee_stream_error_string.argtypes = [i32]
    lib.yee_stream_error_string.restype = ctypes.c_char_p
    return lib


def plain_sweep(p: Params, state: FieldState, coefs: UpdateCoefs, s: int,
                drive: SweepDrive | None = None, out: FieldState | None = None,
                acc: torch.Tensor | None = None, cpml: Cpml | None = None,
                psi: PsiState | None = None, psi_out: PsiState | None = None,
                dc: DebyeCoefs | None = None, pol: PolState | None = None,
                pol_out: PolState | None = None, dacc=None, wts: torch.Tensor | None = None,
                box: Box | None = None, means: torch.Tensor | None = None) -> FieldState:
    """The plain version of the kernel: ``s`` steps of :mod:`.curl` on a
    copy of ``state`` in the compute type (fp32 for bf16 storage), with
    steps 2..s hard-set from ``drive``, rounded once to the storage dtype
    into ``out`` (a new state when None).  With ``acc``, each step's
    deposition of the fp32 working copy is added to it in place
    (:func:`diagnostics.accumulate_power`).  With ``cpml``, the steps are
    the CPML passes (``Cpml.plain_h``/``plain_e``) on a working copy of
    ``psi``, rounded once into ``psi_out``.  With ``dc``, the E pass is
    :func:`dispersive.update_e_ade` on a working copy of ``pol``, rounded
    once into ``pol_out``, and ``acc`` takes each step's Debye work
    (:func:`diagnostics.accumulate_work`).  With ``dacc`` and ``wts`` each
    step's E cell means of the working copy are added to the DFT sums
    (:func:`fdtd_tpu_torch.dft.accumulate`, weights ``wts[m - 1]``); with
    ``means`` (the means mode) they are written into ``means[m - 1]``.  In
    fp32 this is exactly ``s`` steps of the ``torch`` backend (with their
    per-step SAR increments and DFT sums, with CPML, or in a Debye
    medium).  With ``box`` (a shard; vacuum and materials) the steps update
    every cell of the shard's arrays whose neighbours they hold (the halos
    lose one plane of exactness a step, so the owned cells stay exact),
    ``acc`` and ``dacc`` take the owned cells' deposition and sums, and only
    the owned window is written into ``out``."""
    cd = curl.compute_dtype(state.ex.dtype)
    work = FieldState(*(t.to(cd, copy=True) for t in state.tensors()))
    wpsi = wpol = w_edge = None
    if cpml is not None:
        if psi is None or psi_out is None:
            raise ValueError("a CPML sweep needs psi and psi_out")
        wpsi = PsiState(*(t.to(cd, copy=True) for t in psi.tensors()))
    if dc is not None:
        if pol is None or pol_out is None:
            raise ValueError("a Debye sweep needs pol and pol_out")
        wpol = PolState(*(t.to(cd, copy=True) for t in pol.tensors()))
        if acc is not None:
            w_edge = tuple(torch.empty(p.padded_shape, dtype=dispersive.work_dtype(cd), device=state.ex.device)
                           for _ in range(3))
    patch = drive.patch if drive is not None else None
    local = box.patch(patch) if box is not None and patch is not None else None
    region = (box.lo, box.hi) if box is not None else None
    for m in range(1, s + 1):
        if m >= 2 and drive is not None and (box is None or local is not None):
            j0, j1, i0, i1 = patch
            sl, rows = ((0, slice(j0, j1), slice(i0, i1)), slice(None)) if box is None else ((0,) + local[0], local[1])
            work.ez[sl] = drive.ez_rows[m - 2, rows].to(cd)
            work.ex[sl] = 0
            work.hx[sl] = drive.hx_rows[m - 2, rows].to(cd)
            work.hz[sl] = 0
        if cpml is not None:
            cpml.plain_h(p, work, coefs, wpsi, patch)
            cpml.plain_e(p, work, coefs, wpsi)
        elif dc is not None:
            curl.update_h(p, work, coefs, patch)
            dispersive.update_e_ade(p, work, wpol, dc, w_edge)
        else:
            curl.update_h(p, work, coefs, patch, box, region)
            curl.update_e(p, work, coefs, box, region)
        if acc is not None:
            if dc is not None:
                diagnostics.accumulate_work(p, w_edge, acc)
            else:
                diagnostics.accumulate_power(p, work, coefs.sigma_cells, acc, box)
        if dacc is not None or means is not None:
            cells = diagnostics._e_cell_means(p, work, *(box.local(*box.cells(p)) if box is not None else ()))
            if means is not None:
                for c in range(3):
                    means[m - 1, c] = cells[c]
            else:
                accumulate(cells, wts[m - 1, 0], wts[m - 1, 1], dacc)
    if wpsi is not None:
        for o, w in zip(psi_out.tensors(), wpsi.tensors()):
            o.copy_(w)
    if wpol is not None:
        for o, w in zip(pol_out.tensors(), wpol.tensors()):
            o.copy_(w)
    if out is None:
        return work.to(dtype=state.ex.dtype)
    own = box.owned if box is not None else (slice(None),) * 3
    for o, w in zip(out.tensors(), work.tensors()):
        o[own] = w[own]
    return out


def _on_cpu(p: Params, state: FieldState, out: FieldState, shape: tuple[int, int, int]) -> bool:
    """True when both states lie on the CPU; validates CUDA states (of
    ``shape``) for the kernel and raises on anything else."""
    tensors = state.tensors() + out.tensors()
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("the input and output fields must all be on one device")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"the stream kernel runs on CUDA tensors; got device {dev}")
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODES:
        raise ValueError(f"the stream kernel takes float32 or bfloat16 fields; got {dt}")
    for t in tensors:
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"each field must be a contiguous {dt} tensor of shape {shape}; "
                f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    ptrs = {t.data_ptr() for t in tensors}
    if len(ptrs) != len(tensors):
        raise ValueError("the sweep's output fields must not alias its input fields")
    return False


def _check_psi(p: Params, state: FieldState, cpml: Cpml, psi: PsiState, psi_out: PsiState) -> None:
    """Both psi sets as the kernel takes them (it indexes them with 32-bit
    offsets), and not aliasing each other."""
    yee.check_psi(p, cpml, state.ex, psi, TERM_NAMES)
    yee.check_psi(p, cpml, state.ex, psi_out, TERM_NAMES)
    if any(t.numel() >= 2**31 for t in psi.tensors()):
        raise ValueError("the CPML sweep indexes psi with 32-bit offsets: a psi array has 2^31 elements or more")
    if {t.data_ptr() for t in psi.tensors()} & {t.data_ptr() for t in psi_out.tensors()}:
        raise ValueError("the sweep's output psi must not alias its input psi")


def sweep(p: Params, state: FieldState, out: FieldState, coefs: UpdateCoefs,
          plan: StreamPlan, drive: SweepDrive | None = None,
          acc: torch.Tensor | None = None, cpml: Cpml | None = None,
          psi: PsiState | None = None, psi_out: PsiState | None = None,
          dc: DebyeCoefs | None = None, pol: PolState | None = None,
          pol_out: PolState | None = None, dacc=None, wts: torch.Tensor | None = None,
          box: Box | None = None, means: torch.Tensor | None = None) -> FieldState:
    """Advance ``state`` by ``plan.s`` steps into ``out``; returns ``out``.
    ``plan`` must be made for the variant of ``coefs``, ``acc``, ``cpml``,
    ``dc`` and ``dacc`` (``stream_plan.plan_for(p, s, coefs.lossy,
    coefs.heterogeneous_mu, acc is not None, cpml.cfg if cpml else None,
    dc is not None, dft=...)``); with ``cpml``, ``psi`` is read and
    ``psi_out`` written; with ``dc`` (and the vacuum ``coefs`` of the H
    pass), ``pol`` is read and ``pol_out`` written; with ``dacc`` (E sums
    updated in place) the weights ``wts``; a means-mode plan (``plan.fold``)
    takes ``means``, the sweep's (s, 3, *cells) fp32 slice of the buffer,
    instead of both.  ``box``: a shard's arrays (the plan made for its
    owned window, ``plan_for(..., window=...)``)."""
    if box is not None and box.is_full(p):
        box = None
    if box is not None:
        if cpml is not None or dc is not None:
            raise ValueError("the CPML and Debye sweeps have no shard variant: a sharded CPML or Debye scene runs "
                             "the two-pass kernels or torch ops")
        _check_halos(p, box, plan)
    variant = (coefs.lossy, coefs.heterogeneous_mu, acc is not None, cpml is not None, dc is not None,
               dacc is not None or means is not None)
    if (plan.lossy, plan.het, plan.sar, plan.pml, plan.ade, plan.dft) != variant:
        raise ValueError(
            f"the plan is for (lossy, het, sar, pml, ade, dft) = "
            f"{(plan.lossy, plan.het, plan.sar, plan.pml, plan.ade, plan.dft)}, "
            f"the coefficients, accumulator, CPML and Debye maps and DFT sums are {variant}"
        )
    nf = nc = 0
    if bool(plan.fold) != (means is not None) or (means is not None and dacc is not None):
        raise ValueError(f"a means-mode sweep (plan.fold > 0) takes the means buffer and no sums, a sweep with the "
                         f"bands its sums; the plan's fold is {plan.fold}")
    if means is not None:
        _check_means(p, state.ex, means, plan.s, box)
    if dacc is not None:
        nf, nc = check_sums(p, state.ex, dacc, box)
        if wts is None:
            raise ValueError("a DFT sweep needs its (s, 2, nf) weight rows")
        check_weights(wts, state.ex, (plan.s, 2, nf))
        if nf > plan.dft_max_nf:
            raise ValueError(f"the DFT bands of {plan.kernel} at s={plan.s} take at most {plan.dft_max_nf} "
                             f"frequencies (shared memory); got {nf}")
    if cpml is not None and (psi is None or psi_out is None):
        raise ValueError("a CPML sweep needs psi and psi_out")
    if dc is not None and (pol is None or pol_out is None):
        raise ValueError("a Debye sweep needs pol and pol_out")
    dt = state.ex.dtype
    if acc is not None and dc is not None:
        if (acc.device != state.ex.device or acc.dtype != torch.float32
                or tuple(acc.shape) != (p.maxk, p.maxj, p.maxi) or not acc.is_contiguous()):
            raise ValueError(
                f"the accumulator must be a contiguous float32 {(p.maxk, p.maxj, p.maxi)} tensor on "
                f"{state.ex.device}; got {acc.dtype} {tuple(acc.shape)} on {acc.device}"
            )
    elif acc is not None:  # the plan's variant implies lossy coefficients, so sigma exists
        cells = box.cell_shape(p) if box is not None else (p.maxk, p.maxj, p.maxi)
        for a, want in ((coefs.sigma_cells, dt), (acc, torch.float32)):
            if (a.device != state.ex.device or a.dtype != want or tuple(a.shape) != cells
                    or not a.is_contiguous()):
                raise ValueError(
                    f"sigma and the accumulator must be contiguous {cells} tensors on "
                    f"{state.ex.device} (sigma {dt}, accumulator float32); got "
                    f"{a.dtype} {tuple(a.shape)} on {a.device}"
                )
    if _on_cpu(p, state, out, box.shape if box is not None else p.padded_shape):
        return plain_sweep(p, state, coefs, plan.s, drive, out, acc, cpml, psi, psi_out, dc, pol, pol_out, dacc, wts,
                           box, means)
    lib = _lib_fold() if plan.fold else _lib()
    fh = curl.scalar(coefs.h_factor, dt)
    if drive is not None:
        j0, j1, i0, i1 = drive.patch
        rows_shape = (plan.s - 1, i1 - i0)
        for r in (drive.ez_rows, drive.hx_rows):
            if (r.device != state.ex.device or r.dtype != dt or tuple(r.shape) != rows_shape
                    or not r.is_contiguous()):
                raise ValueError(
                    f"drive rows must be contiguous {dt} tensors of shape {rows_shape} on "
                    f"{state.ex.device}; got {r.dtype} {tuple(r.shape)} on {r.device}"
                )
        rows = (drive.ez_rows.data_ptr(), drive.hx_rows.data_ptr())
    else:
        j0 = j1 = i0 = i1 = 0
        rows = (None, None)
    PtrArray = ctypes.c_void_p * 6
    ins = PtrArray(*(t.data_ptr() for t in state.tensors()))
    outs = PtrArray(*(t.data_ptr() for t in out.tensors()))
    geometry = (plan.s, plan.bj, plan.bi, int(plan.cr), plan.tk, int(drive is not None), j0, j1, i0, i1)
    cf = hf = ()
    if dc is not None:
        cf = dc.arrays(acc is not None)
        yee.check_coefficients(p, state.ex, pol.tensors() + pol_out.tensors() + cf)
        if {t.data_ptr() for t in pol.tensors()} & {t.data_ptr() for t in pol_out.tensors()}:
            raise ValueError("the sweep's output pol must not alias its input pol")
    elif coefs.lossy:
        cf = (coefs.ca_x, coefs.ca_y, coefs.ca_z, coefs.cb_x, coefs.cb_y, coefs.cb_z)
        hf = (coefs.hf_x, coefs.hf_y, coefs.hf_z) if coefs.heterogeneous_mu else ()
        yee.check_coefficients(p, state.ex, cf + hf)
    fe = 0.0 if cf else curl.scalar(coefs.cb_x, dt)
    dft_args = ((dacc[0].data_ptr(), dacc[1].data_ptr(), wts.data_ptr(), nf, nc, None) if dacc is not None
                else (None, None, None, 0, 0, means.data_ptr() if means is not None else None))
    sigma = coefs.sigma_cells.data_ptr() if acc is not None and dc is None else None
    if dt == torch.bfloat16:
        ringed = state.tensors() + cf + hf + (pol.tensors() if dc is not None else ())
        ringed += (coefs.sigma_cells,) if sigma is not None else ()
        ringed += psi.tensors() if cpml is not None else ()
        if any(t.data_ptr() % 4 for t in ringed):
            raise ValueError("the sweep's bfloat16 arrays must start 4-byte aligned (the kernels copy aligned 4-byte words)")
    dev = state.ex.device
    call = functools.partial(lib.yee_stream_sweep, ins, outs, p.maxk, p.maxj, p.maxi)
    mats = (yee.pointers(cf) if cf else None, yee.pointers(hf) if hf else None, sigma,
            acc.data_ptr() if acc is not None else None, curl.scalar(p.time_step, torch.float32))
    with torch.cuda.device(dev):
        stream_ptr = build.launch_stream(dev)
        if cpml is not None:
            _check_psi(p, state, cpml, psi, psi_out)
            if plan.core is not None:
                # the interior: the K3 sweep of the variant on the psi-free
                # window of the whole grid's arrays, sums and all
                core = plan.core
                window = [x for lo, w in zip(core.origin, core.window) for x in (lo, lo + w)]
                geom = (ctypes.c_int * 12)(*p.padded_shape, 0, 0, 0, *window)
                cells = (ctypes.c_int * 6)(0, 0, 0, p.maxk, p.maxj, p.maxi)
                rc = call(geom, cells, fh, fe, core.s, core.bj, core.bi, int(core.cr), core.tk, 0, 0, 0, 0, 0,
                          None, None, *mats, None, None, None, None, 0, None, 0, None, None, *dft_args,
                          _DTYPE_CODES[dt], stream_ptr)
                _count(lib, plan.kernel + INTERIOR, rc, dt == torch.bfloat16)
            if plan.pml_blocks:  # a plan without them launches the interior alone (chip_smoke.py times it so)
                rc = call(None, None, fh, fe, *geometry, *rows, *mats, yee.pointers(psi.tensors(TERM_NAMES)),
                          yee.pointers(psi_out.tensors(TERM_NAMES)), cpml.table_h.data_ptr(), cpml.table_e.data_ptr(),
                          cpml.cfg.cells, _pml_blocks(plan, dev).data_ptr(), plan.blocks, None, None, *dft_args,
                          _DTYPE_CODES[dt], stream_ptr)
                _count(lib, plan.kernel, rc)
            return out
        pol_args = (yee.pointers(pol.tensors()), yee.pointers(pol_out.tensors())) if dc is not None else (None, None)
        rc = call(yee.geometry(p, box), None, fh, fe, *geometry, *rows, *mats, None, None, None, None, 0, None, 0,
                  *pol_args, *dft_args, _DTYPE_CODES[dt], stream_ptr)
    _count(lib, plan.kernel + ("_shard" if box is not None else ""), rc, dt == torch.bfloat16)
    return out


def means_shape(p: Params, levels: int, box: Box | None = None) -> tuple[int, ...]:
    """The shape of ``levels`` levels of the means mode's fp32 buffer:
    each level's three E cell means of every cell (a shard's: of its cell
    box)."""
    return (levels, 3) + (box.cell_shape(p) if box is not None else (p.maxk, p.maxj, p.maxi))


def _check_means(p: Params, like: torch.Tensor, means: torch.Tensor, s: int, box: Box | None) -> None:
    """The sweep's slice of the means buffer: a contiguous fp32
    :func:`means_shape` tensor of ``s`` levels on the fields' device."""
    shape = means_shape(p, s, box)
    if (means.device != like.device or means.dtype != torch.float32 or tuple(means.shape) != shape
            or not means.is_contiguous()):
        raise ValueError(f"the means buffer's slice must be a contiguous float32 {shape} tensor on "
                         f"{like.device}; got {means.dtype} {tuple(means.shape)} on {means.device}")


def _count(lib: ctypes.CDLL, name: str, rc: int, staged: bool = False) -> None:
    """Count a launch under ``name`` (``staged``: a bfloat16 ring_kernel
    launch, also in ``staged_launches``); raise when it failed."""
    global staged_launches
    launches[name] += 1
    staged_launches += staged
    if rc != 0:
        msg = lib.yee_stream_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _pml_blocks(plan: StreamPlan, dev: torch.device) -> torch.Tensor:
    """A CPML plan's block list as the kernel reads it: (blocks, 8) int32
    on ``dev``, copied once per plan and device."""
    if dev not in plan.device_blocks:
        plan.device_blocks[dev] = torch.tensor(plan.pml_blocks, dtype=torch.int32).to(dev)
    return plan.device_blocks[dev]


def _check_halos(p: Params, box: Box, plan: StreamPlan) -> None:
    """A shard's arrays hold ``plan.s`` planes before its owned window
    and ``plan.s`` after it (``plan.s + 1`` with the cell means of SAR and
    the DFT bands), as far as the grid reaches, and the plan is made for
    that window."""
    depth = plan.s + int(plan.sar or plan.dft)
    for a, n in enumerate(p.padded_shape):
        lo, hi = box.own_lo[a], box.own_hi[a]
        if box.lo[a] > max(lo - plan.s, 0) or box.hi[a] < min(hi + depth, n):
            raise ValueError(f"a shard's arrays {box.lo}..{box.hi} lack the {depth} halo planes of an s={plan.s} "
                             f"sweep around its owned planes {box.own_lo}..{box.own_hi}")
    window = tuple(h - lo for lo, h in zip(box.own_lo, box.own_hi))
    if (plan.window or p.padded_shape) != window:
        raise ValueError(f"the plan is made for a window of {plan.window or p.padded_shape} planes, the shard owns "
                         f"{window}")

