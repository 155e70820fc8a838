"""Wrappers of the two-pass Hopper kernels (``csrc/yee_twopass.cu``).

``update_h`` and ``update_e`` replace the TPU kernels
``fdtd_tpu/ops/pallas_fused.py::_h_kernel2`` and ``::_e_kernel2``: the
vacuum kernels take scalar factors; with materials, ``update_h`` launches
the heterogeneous-mu_r variant (``hf_x/y/z`` arrays) when the coefficients
carry them, and ``update_e`` the lossy variant (six ca/cb arrays).  With
``cpml`` and ``psi`` (:mod:`fdtd_tpu_torch.ops.cpml`) they launch the CPML
variants, which replace ``fdtd_tpu/ops/cpml_kernel.py::_h_kernel_pml`` and
``::_e_kernel_pml`` and advance the pass's six psi terms in place.
``update_e_ade`` is the ADE E pass of a Debye medium (replacing
``fdtd_tpu/ops/pallas_dispersive.py::_e_kernel_ade``): E and the
polarization P in place, and with ``work`` the three fp32 edge work arrays
of the SAR; its plain version is
:func:`fdtd_tpu_torch.ops.dispersive.update_e_ade`.  On
CUDA tensors they launch the kernel on the current stream of the tensors'
device, in place, allocating nothing; they raise on anything the kernel
does not take (another dtype, shape, device or a non-contiguous tensor).
On CPU tensors, and only there, they run the plain versions in
:mod:`fdtd_tpu_torch.ops.curl` (with CPML: ``Cpml.plain_h``/``plain_e``).

With ``box`` (a :class:`~fdtd_tpu_torch.grid.Box`: a shard of a sharded
run, :mod:`fdtd_tpu_torch.parallel`) ``update_h`` and ``update_e`` update
the shard's owned cells in its own arrays, halos included, with the walls
and the source patch at global indices: they replace the TPU's per-shard
calls of ``_h_kernel2``/``_e_kernel2`` (``fdtd_tpu/ops/pallas_fused.py::
build_twopass_calls`` with its offset operand and ``jwin``), vacuum and
with materials; the coefficient arrays are the shard's parts.  With CPML
(``cpml`` made for the shard's box, :func:`~fdtd_tpu_torch.ops.cpml.
make_cpml`) they launch the CPML variants on the shard's psi parts
(:func:`~fdtd_tpu_torch.ops.cpml.psi_part_slices`), replacing the TPU's
per-shard K1/K2 with XLA slab corrections
(``fdtd_tpu/parallel/sharded_pml_fast.py::make_sharded_pml_fast_step``).

``update_h_batch`` and ``update_e_batch`` are the vacuum passes of every
member of a sweep's batch (six contiguous (N, K+1, J+1, I+1) tensors) in
one launch, the batched K1/K2 (``march_kernel`` with ``BATCH``: each
member gets the whole-grid vacuum pass's operations on its own arrays),
which replace the JAX package's vmapped ``_h_kernel2``/``_e_kernel2``
(``fdtd_tpu/sweep.py``'s ``pallas_fused`` members); their plain versions
are the per-member :mod:`fdtd_tpu_torch.ops.curl` passes.

The vacuum, the batched and the CPML passes run ``march_kernel``, the
k-marching core (the header of ``csrc/yee_twopass.cu``), whose launch
geometry (:func:`vacuum_geometry`, :func:`march_geometry`: the box, the psi
parts and the planes a block marches, ``stream_plan.march_plan``, for a
batch picked for all its members) is made once per grid, box and member
count; the het-mu H and lossy E passes and the ADE E pass run the first
design.  The march core copies rows in aligned 16-byte chunks, so the other
field's three tensors must start alike within 16 bytes, and so must the
pass's own three with its coefficients (:func:`check_aligned`; a batched
launch checks its member 0's, and its members then start alike too, each
at its own lead).

``launches`` counts kernel launches per kernel variant (a shard's under
the variant's name with ``_shard``, a batch's with ``_batch``), so a run
can show that it went through the kernels; plain-version calls do not
count.
"""

from __future__ import annotations

import ctypes

import torch

from ..grid import Box
from ..params import Params
from ..state import FieldState, UpdateCoefs
from . import build, curl, dispersive, stream_plan
from .cpml import E_TERMS, H_TERMS, Cpml, PsiState
from .dispersive import DebyeCoefs, PolState

KERNEL_SOURCE = "yee_twopass"
launches = {name + suffix: 0
            for suffix in ("", "_pml")
            for name in ("yee_update_h", "yee_update_e", "yee_update_h_het", "yee_update_e_lossy")}
launches.update(yee_update_e_ade=0, yee_update_e_ade_sar=0, yee_update_h_batch=0, yee_update_e_batch=0)
launches.update({name + suffix + "_shard": 0
                 for suffix in ("", "_pml")
                 for name in ("yee_update_h", "yee_update_e", "yee_update_h_het", "yee_update_e_lossy")})

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_bound: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        _bound = _declare(build.load(KERNEL_SOURCE))
    return _bound


def use_library(path) -> None:
    """Launch the passes from the library at ``path``, a build of
    csrc/yee_twopass.cu with macros of its own (``build.build(...,
    defines=...)``), instead of the default build."""
    global _bound
    _bound = _declare(ctypes.CDLL(str(path)))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of its C interface set."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (K, J, I, geom): the grid and the launch's geometry (a shard's box, null for the whole grid; the
    # march_kernel passes' 43 ints, never null)
    grid = [i32] * 3 + [ptr]
    lib.yee_update_h.argtypes = [ptr] * 6 + grid + [f32] + [i32] * 5 + [i32, ptr]
    lib.yee_update_h.restype = i32
    lib.yee_update_e.argtypes = [ptr] * 6 + grid + [f32] + [i32, ptr]
    lib.yee_update_e.restype = i32
    lib.yee_update_h_het.argtypes = [ptr] * 3 + grid + [i32] * 5 + [i32, ptr]
    lib.yee_update_h_het.restype = i32
    lib.yee_update_e_lossy.argtypes = [ptr] * 3 + grid + [i32, ptr]
    lib.yee_update_e_lossy.restype = i32
    lib.yee_update_h_pml.argtypes = [ptr] * 4 + [i32] + grid + [f32] + [i32] * 5 + [i32, ptr]
    lib.yee_update_h_pml.restype = i32
    lib.yee_update_h_het_pml.argtypes = [ptr] * 5 + [i32] + grid + [i32] * 5 + [i32, ptr]
    lib.yee_update_h_het_pml.restype = i32
    lib.yee_update_e_pml.argtypes = [ptr] * 4 + [i32] + grid + [f32] + [i32, ptr]
    lib.yee_update_e_pml.restype = i32
    lib.yee_update_e_lossy_pml.argtypes = [ptr] * 5 + [i32] + grid + [i32, ptr]
    lib.yee_update_e_lossy_pml.restype = i32
    lib.yee_update_e_ade.argtypes = [ptr] * 5 + grid + [f32, i32, ptr]
    lib.yee_update_e_ade.restype = i32
    # (e or h, h or e, members, K, J, I, geom, ...): a batch's member 0 pointers
    lib.yee_update_h_batch.argtypes = [ptr] * 2 + [i32] + grid + [f32] + [i32] * 5 + [i32, ptr]
    lib.yee_update_h_batch.restype = i32
    lib.yee_update_e_batch.argtypes = [ptr] * 2 + [i32] + grid + [f32, i32, ptr]
    lib.yee_update_e_batch.restype = i32
    lib.yee_error_string.argtypes = [i32]
    lib.yee_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "yee_march_candidate"):  # a -DYEE_TWOPASS_CANDIDATES build (tune_twopass)
        lib.yee_march_candidate.argtypes = [i32] * 2 + [ptr] * 5 + [i32] + grid + [f32] + [i32] * 5 + [i32, ptr]
        lib.yee_march_candidate.restype = i32
        lib.yee_march_batch_candidate.argtypes = [i32] * 2 + [ptr] * 2 + [i32] + grid + [f32] + [i32] * 5 + [i32, ptr]
        lib.yee_march_batch_candidate.restype = i32
    return lib


def geometry(p: Params, box: Box | None):
    """The C interface's ``geom`` of a shard's box (its arrays' extents,
    the global index of their origin, the owned window), None for the whole
    grid."""
    if box is None or box.is_full(p):
        return None
    window = [x for lo_hi in zip(box.own_lo, box.own_hi) for x in lo_hi]
    return (ctypes.c_int * 12)(*box.shape, *box.lo, *window)


_VACUUM: dict = {}  # vacuum_geometry's arrays by (K, J, I, box, E pass, members)


def vacuum_geometry(p: Params, box: Box | None, e_pass: bool, members: int = 1):
    """The vacuum passes' ``geom`` (march_kernel without CPML) of ``box``'s
    owned window (None: the whole grid), for a launch over ``members``
    members (a batched one when more than one):
    ``stream_plan.march_geometry``, made once per grid, box, pass and
    member count."""
    box = None if box is None or box.is_full(p) else box
    key = (p.maxk, p.maxj, p.maxi, box, e_pass, members)
    geom = _VACUUM.get(key)
    if geom is None:
        ints = stream_plan.march_geometry(p, None, box, e_pass, members=members)
        geom = _VACUUM[key] = (ctypes.c_int * len(ints))(*ints)
    return geom


def march_geometry(p: Params, cpml: Cpml, names: tuple[str, ...]):
    """The CPML kernels' ``geom`` of the pass of the terms ``names`` on
    ``cpml.box`` (the whole grid's too): the box, its psi parts and the
    planes a block marches (``stream_plan.march_geometry``), made once per
    :class:`Cpml` and pass."""
    geom = cpml.march.get(names)
    if geom is None:
        ints = stream_plan.march_geometry(p, cpml.cfg, cpml.box, names == E_TERMS)
        geom = cpml.march[names] = (ctypes.c_int * len(ints))(*ints)
    return geom


def _on_cpu(p: Params, s: FieldState, shape: tuple[int, int, int] | None = None) -> bool:
    """True when the whole state is on the CPU; validates a CUDA state (of
    ``shape``, default the padded grid) for the kernels and raises on
    anything else."""
    tensors = s.tensors()
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all six field tensors must be on one device")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"the Yee kernels run on CUDA tensors; got device {dev}")
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODES:
        raise ValueError(f"the Yee kernels take float32 or bfloat16 fields; got {dt}")
    shape = shape or p.padded_shape
    for t in tensors:
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"each field must be a contiguous {dt} tensor of shape {shape}; "
                f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    return False


def check_coefficients(p: Params, like: torch.Tensor, arrays: tuple[torch.Tensor, ...]) -> None:
    """Coefficient arrays must match the fields: device, dtype, shape,
    contiguous."""
    for a in arrays:
        if (a.device != like.device or a.dtype != like.dtype or a.shape != like.shape
                or not a.is_contiguous()):
            raise ValueError(
                f"coefficient arrays must be contiguous {like.dtype} tensors of shape "
                f"{tuple(like.shape)} on {like.device}; got {a.dtype} {tuple(a.shape)} on {a.device}"
            )


def check_psi(p: Params, cpml: Cpml, like: torch.Tensor, psi: PsiState, names: tuple[str, ...]) -> None:
    """The psi tensors of ``names`` and the (b, c) tables must match the
    fields: device, dtype, the slab-restricted shapes (a shard's part
    shapes with ``cpml.box``), contiguous."""
    shapes = cpml.shapes
    want = {n: shapes[n] for n in names}
    got = {n: getattr(psi, n) for n in names}
    tables = (cpml.table_h, cpml.table_e)
    for n, t in list(got.items()) + [("table", tb) for tb in tables]:
        shape = want.get(n, (6, 2, 2 * cpml.cfg.cells))
        if (t.device != like.device or t.dtype != like.dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"psi {n} must be a contiguous {like.dtype} tensor of shape {shape} on "
                f"{like.device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def check_aligned(*groups) -> None:
    """march_kernel copies rows in aligned 16-byte chunks: the tensors of a
    group (the other field's three; the pass's own three with their
    coefficients) must start alike within 16 bytes (tensors of their own
    do, and so do a sweep member's views of its batches)."""
    for tensors in groups:
        starts = {t.data_ptr() % 16 for t in tensors}
        if len(starts) > 1:
            raise ValueError(f"the two-pass kernels take field (and coefficient) tensors that start alike within "
                             f"16 bytes; got offsets {sorted(starts)}")


def pointers(tensors) -> ctypes.Array:
    """A C array of the tensors' data pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _shard_box(p: Params, box: Box | None, cpml: Cpml | None) -> Box | None:
    """``box`` unless it is the whole grid; ``cpml`` must be made for it."""
    if box is not None and box.is_full(p):
        box = None
    if cpml is not None and cpml.box != box:
        raise ValueError(f"the CPML of a pass must be made for its box (make_cpml(..., box=)): {cpml.box} != {box}")
    return box


def _check(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().yee_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def update_h(p: Params, s: FieldState, coefs: UpdateCoefs,
             patch: tuple[int, int, int, int] | None = None,
             cpml: Cpml | None = None, psi: PsiState | None = None, box: Box | None = None) -> None:
    """H half-step in place; ``patch`` as in :func:`curl.update_h`; with
    ``cpml`` and ``psi`` the CPML H pass (the six H psi terms advance in
    place too); with ``box`` a shard's owned cells."""
    if (cpml is None) != (psi is None):
        raise ValueError("the CPML pass needs both cpml and psi")
    box = _shard_box(p, box, cpml)
    if _on_cpu(p, s, box.shape if box else None):
        if cpml is not None:
            cpml.plain_h(p, s, coefs, psi, patch)
        else:
            curl.update_h(p, s, coefs, patch, box)
        return
    lib = _lib()
    j0, j1, i0, i1 = patch if patch is not None else (0, 0, 0, 0)
    hf = (coefs.hf_x, coefs.hf_y, coefs.hf_z) if coefs.heterogeneous_mu else ()
    grid = (p.maxk, p.maxj, p.maxi, march_geometry(p, cpml, H_TERMS) if cpml is not None else
            geometry(p, box) if hf else vacuum_geometry(p, box, False))
    patch_args = (int(patch is not None), j0, j1, i0, i1)
    dtype = _DTYPE_CODES[s.hx.dtype]
    e_ptr, h_ptr = pointers((s.ex, s.ey, s.ez)), pointers((s.hx, s.hy, s.hz))
    if hf:
        check_coefficients(p, s.hx, hf)
    f = curl.scalar(coefs.h_factor, s.hx.dtype)
    dev = s.hx.device
    with torch.cuda.device(dev):
        stream = build.launch_stream(dev)
        if cpml is not None:
            check_psi(p, cpml, s.hx, psi, H_TERMS)
            check_aligned((s.ex, s.ey, s.ez), (s.hx, s.hy, s.hz) + hf)
            pml = (pointers(psi.tensors(H_TERMS)), cpml.table_h.data_ptr(), cpml.cfg.cells)
            if hf:
                name = "yee_update_h_het_pml"
                rc = lib.yee_update_h_het_pml(e_ptr, h_ptr, pointers(hf), *pml, *grid, *patch_args,
                                              dtype, stream)
            else:
                name = "yee_update_h_pml"
                rc = lib.yee_update_h_pml(e_ptr, h_ptr, *pml, *grid, f, *patch_args, dtype, stream)
        elif hf:
            name = "yee_update_h_het"
            rc = lib.yee_update_h_het(e_ptr, h_ptr, pointers(hf), *grid, *patch_args, dtype, stream)
        else:
            name = "yee_update_h"
            check_aligned((s.ex, s.ey, s.ez), (s.hx, s.hy, s.hz))
            rc = lib.yee_update_h(*(t.data_ptr() for t in s.tensors()), *grid, f, *patch_args,
                                  dtype, stream)
    name += "_shard" if box is not None else ""
    launches[name] += 1
    _check(rc, name)


def update_e(p: Params, s: FieldState, coefs: UpdateCoefs,
             cpml: Cpml | None = None, psi: PsiState | None = None, box: Box | None = None) -> None:
    """E half-step in place: one scalar cb in vacuum, the ca/cb arrays of
    ``coefs`` with materials; with ``cpml`` and ``psi`` the CPML E pass;
    with ``box`` a shard's owned cells."""
    if (cpml is None) != (psi is None):
        raise ValueError("the CPML pass needs both cpml and psi")
    box = _shard_box(p, box, cpml)
    if _on_cpu(p, s, box.shape if box else None):
        if cpml is not None:
            cpml.plain_e(p, s, coefs, psi)
        else:
            curl.update_e(p, s, coefs, box)
        return
    lib = _lib()
    cf = (coefs.ca_x, coefs.ca_y, coefs.ca_z, coefs.cb_x, coefs.cb_y, coefs.cb_z) if coefs.lossy else ()
    grid = (p.maxk, p.maxj, p.maxi, march_geometry(p, cpml, E_TERMS) if cpml is not None else
            geometry(p, box) if cf else vacuum_geometry(p, box, True))
    dtype = _DTYPE_CODES[s.ex.dtype]
    h_ptr, e_ptr = pointers((s.hx, s.hy, s.hz)), pointers((s.ex, s.ey, s.ez))
    if cf:
        check_coefficients(p, s.ex, cf)
    dev = s.ex.device
    with torch.cuda.device(dev):
        stream = build.launch_stream(dev)
        if cpml is not None:
            check_psi(p, cpml, s.ex, psi, E_TERMS)
            check_aligned((s.hx, s.hy, s.hz), (s.ex, s.ey, s.ez) + cf)
            pml = (pointers(psi.tensors(E_TERMS)), cpml.table_e.data_ptr(), cpml.cfg.cells)
            if cf:
                name = "yee_update_e_lossy_pml"
                rc = lib.yee_update_e_lossy_pml(h_ptr, e_ptr, pointers(cf), *pml, *grid, dtype, stream)
            else:
                name = "yee_update_e_pml"
                rc = lib.yee_update_e_pml(h_ptr, e_ptr, *pml, *grid, curl.scalar(coefs.cb_x, s.ex.dtype),
                                          dtype, stream)
        elif cf:
            name = "yee_update_e_lossy"
            rc = lib.yee_update_e_lossy(h_ptr, e_ptr, pointers(cf), *grid, dtype, stream)
        else:
            name = "yee_update_e"
            check_aligned((s.hx, s.hy, s.hz), (s.ex, s.ey, s.ez))
            rc = lib.yee_update_e(
                s.hx.data_ptr(), s.hy.data_ptr(), s.hz.data_ptr(),
                s.ex.data_ptr(), s.ey.data_ptr(), s.ez.data_ptr(),
                *grid, curl.scalar(coefs.cb_x, s.ex.dtype), dtype, stream,
            )
    name += "_shard" if box is not None else ""
    launches[name] += 1
    _check(rc, name)


def update_e_ade(p: Params, s: FieldState, P: PolState, dc: DebyeCoefs,
                 work: tuple[torch.Tensor, ...] | None = None) -> None:
    """The ADE E half-step in place (E and P); with ``work`` (three fp32
    tensors of the padded shape) also the edge work of the SAR, every
    cell written (0 off the update bounds)."""
    if _on_cpu(p, s):
        dispersive.update_e_ade(p, s, P, dc, work)
        return
    lib = _lib()
    sar = work is not None
    cf = dc.arrays(sar)
    check_coefficients(p, s.ex, P.tensors() + cf)
    if sar:
        for w in work:
            if (w.device != s.ex.device or w.dtype != torch.float32 or tuple(w.shape) != p.padded_shape
                    or not w.is_contiguous()):
                raise ValueError(
                    f"the work arrays must be contiguous float32 tensors of shape {p.padded_shape} on "
                    f"{s.ex.device}; got {w.dtype} {tuple(w.shape)} on {w.device}"
                )
    name = "yee_update_e_ade_sar" if sar else "yee_update_e_ade"
    dev = s.ex.device
    with torch.cuda.device(dev):
        rc = lib.yee_update_e_ade(
            pointers((s.hx, s.hy, s.hz)), pointers((s.ex, s.ey, s.ez)), pointers(P.tensors()), pointers(cf),
            pointers(work) if sar else None, p.maxk, p.maxj, p.maxi, None,
            curl.scalar(p.time_step, torch.float32), _DTYPE_CODES[s.ex.dtype], build.launch_stream(dev),
        )
    launches[name] += 1
    _check(rc, name)


def _batch_on_cpu(p: Params, states: FieldState) -> bool:
    """True when the batch is on the CPU; validates a CUDA batch (contiguous
    (N, K+1, J+1, I+1) tensors of one dtype) and raises on anything else
    (the launch refuses tensors that do not start alike within 16 bytes:
    tensors of their own do)."""
    tensors = states.tensors()
    n = tensors[0].shape[0] if tensors[0].dim() == 4 else 0
    if n < 1 or any(tuple(t.shape) != (n,) + p.padded_shape for t in tensors):
        raise ValueError(f"a batch is six (N, {', '.join(map(str, p.padded_shape))}) tensors; got "
                         f"{[tuple(t.shape) for t in tensors]}")
    on_cpu = _on_cpu(p, FieldState(*(t[0] for t in tensors)))
    if not on_cpu and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the batched passes take contiguous batches")
    return on_cpu


def _member_chunks(n: int):
    """(first, count) of the members each batched launch takes: at most
    ``stream_plan.MARCH_MEMBERS`` (the launch's ``gridDim.y``)."""
    per = stream_plan.MARCH_MEMBERS
    return [(m, min(per, n - m)) for m in range(0, n, per)]


def update_h_batch(p: Params, states: FieldState, coefs: UpdateCoefs,
                   patch: tuple[int, int, int, int] | None = None) -> None:
    """The vacuum H half-step of every member of a batch (six contiguous
    (N, K+1, J+1, I+1) tensors) in place: one launch of the batched K1
    (``march_kernel<T, false, false, false, ..., true>``) for up to
    ``stream_plan.MARCH_MEMBERS`` members; on CPU tensors
    :func:`curl.update_h` on each member's view."""
    if coefs.lossy or coefs.heterogeneous_mu:
        raise ValueError("the batched passes are the vacuum ones")
    if _batch_on_cpu(p, states):
        for b in range(states.ex.shape[0]):
            curl.update_h(p, FieldState(*(t[b] for t in states.tensors())), coefs, patch)
        return
    lib = _lib()
    j0, j1, i0, i1 = patch if patch is not None else (0, 0, 0, 0)
    f = curl.scalar(coefs.h_factor, states.hx.dtype)
    dev = states.hx.device
    with torch.cuda.device(dev):
        stream = build.launch_stream(dev)
        for m, count in _member_chunks(states.ex.shape[0]):
            rc = lib.yee_update_h_batch(pointers(tuple(t[m] for t in (states.ex, states.ey, states.ez))),
                                        pointers(tuple(t[m] for t in (states.hx, states.hy, states.hz))), count,
                                        p.maxk, p.maxj, p.maxi, vacuum_geometry(p, None, False, count), f,
                                        int(patch is not None), j0, j1, i0, i1, _DTYPE_CODES[states.hx.dtype], stream)
            launches["yee_update_h_batch"] += 1
            _check(rc, "yee_update_h_batch")


def update_e_batch(p: Params, states: FieldState, coefs: UpdateCoefs) -> None:
    """The vacuum E half-step of every member of a batch in place: one
    launch of the batched K2 (``march_kernel<T, true, false, false, ...,
    true>``) for up to ``stream_plan.MARCH_MEMBERS`` members; on CPU tensors
    :func:`curl.update_e` on each member's view."""
    if coefs.lossy or coefs.heterogeneous_mu:
        raise ValueError("the batched passes are the vacuum ones")
    if _batch_on_cpu(p, states):
        for b in range(states.ex.shape[0]):
            curl.update_e(p, FieldState(*(t[b] for t in states.tensors())), coefs)
        return
    lib = _lib()
    f = curl.scalar(coefs.cb_x, states.ex.dtype)
    dev = states.ex.device
    with torch.cuda.device(dev):
        stream = build.launch_stream(dev)
        for m, count in _member_chunks(states.ex.shape[0]):
            rc = lib.yee_update_e_batch(pointers(tuple(t[m] for t in (states.hx, states.hy, states.hz))),
                                        pointers(tuple(t[m] for t in (states.ex, states.ey, states.ez))), count,
                                        p.maxk, p.maxj, p.maxi, vacuum_geometry(p, None, True, count), f,
                                        _DTYPE_CODES[states.ex.dtype], stream)
            launches["yee_update_e_batch"] += 1
            _check(rc, "yee_update_e_batch")
