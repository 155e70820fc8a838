"""Time the streaming sweeps of K3 and K12 (``csrc/yee_stream.cu::
ring_kernel``) and of K11 (the CPML sweep: ``pml_kernel`` on the shell, with
or without ``ring_kernel`` on the psi-free interior) at their candidate
shapes on the card, beside ptxas's registers and spills and, in the same
call, the design of another checkout: the measurement behind the shapes
each variant is built at (``ops/stream_plan.py``: ``BLOCK_J``,
``BLOCK_J_MATERIAL``, ``COEF_RING_MATERIAL``, ``BLOCK_J_DFT``,
``BLOCK_J_ADE``, ``BLOCK_J_ADE_SAR``, ``BLOCK_J_PML``, ``BLOCK_J_PML_DFT``).

    python -m fdtd_tpu_torch.tune_stream [--n 256] [--reps 20] [--dtypes float32 bfloat16]
        [--scenes vacuum heating ...] [--built] [--only means] [--parent CHECKOUT] [--out FILE]

It builds ``csrc/yee_stream.cu`` with ``YEE_STREAM_CANDIDATES`` defined
(every variant at every shape of :data:`CANDIDATES`, the built ones among
them), checks each shape against ``stream.plain_sweep`` once on a small
ragged box (fields, P, the SAR map and the DFT sums, bit for bit, from
random fields, P, map and sums), and times one sweep of the scene at n^3
(``profile_chunk.scene``, with the heating scene's water block, a ferrite
slab for the het-mu variants, the water block as a Debye medium for the
ADE variants, one frequency for the DFT bands, 10-cell CPML walls and random
psi of every term for the CPML scenes) with CUDA events, the mean of
``--reps`` launches after one.  ``--built`` times the built shapes only,
from the default build.  A CPML scene checks each shape against
``plain_sweep`` with 6-cell walls, every psi term engaged, and also times
its shell's launch alone (``shell_ms``) and its interior's launch alone
(``interior.ms``; ``stream_plan.pml_blocks``).

With ``--parent`` (a checkout of another commit, e.g. unpacked with ``git
archive``) it also times that checkout's sweep of the same scene at that
checkout's own plan, built from its own sources into its own ``_build``, in
turns with this one (parent, this, this, parent) so that both share the
call and the card; each JSON line then carries the parent's ms and the
ratio.

``--only means`` times the DFT bands' means mode instead (the ``FOLD``
instantiations, ``StreamPlan.fold``, from their own build): each DFT
scene's means-mode sweep at its built shape, checked against
``plain_sweep`` with its buffer levels, then the fold kernel
(``csrc/dft_accum.cu``) checked against ``ops.dft.plain_fold`` on ragged
boxes and timed at :data:`FOLD_SHAPES` beside ``torch.addmm`` of the same
weights.  With ``--parent`` the parent's sweep and fold run in turns with
these, and each means-mode line also carries both trees' ms a step with
their fold at :data:`MEANS_FOLD_NF` frequencies (a 32-level buffer) added.

One JSON line per scene, dtype and shape: ms per sweep and per step, the
grid (blocks and waves of 132 SMs), the bound (each array read once and
written once at 3.35 TB/s) and its share, registers and spill-store bytes,
the check's max |diff|, the parent's numbers, and the card's name and
power limit.  ``--out`` writes the lines to a file too.  Exits 1 when a
check fails or no CUDA device is available.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .convert import state_from_numpy
from .dft import DftConfig
from .grid import COMPONENTS
from .ops import build, stream, stream_plan
from .ops.cpml import Cpml, PMLConfig, PsiState, make_cpml, psi_shapes
from .ops.dispersive import PolState, debye_coefs, water_debye_load
from .params import Mode, Params
from .profile_chunk import scene
from .source import apply_source, make_source_plan, profile_tensor, sweep_drive_rows
from .state import FieldState, ferrite_slab, field_dtype, update_coefs, water_block

DEFINE = "YEE_STREAM_CANDIDATES"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# the variants: (materials, het-mu, SAR, Debye, DFT, CPML)
SCENES = {
    "vacuum": (False, False, False, False, False, False),
    "lossy": (True, False, False, False, False, False),
    "heating": (True, False, True, False, False, False),
    "het": (True, True, False, False, False, False),
    "het_sar": (True, True, True, False, False, False),
    "vacuum_dft": (False, False, False, False, True, False),
    "lossy_dft": (True, False, False, False, True, False),
    "heating_dft": (True, False, True, False, True, False),
    "het_dft": (True, True, False, False, True, False),
    "het_sar_dft": (True, True, True, False, True, False),
    "dispersive": (False, False, False, True, False, False),
    "dispersive_sar": (False, False, True, True, False, False),
    "dispersive_dft": (False, False, False, True, True, False),
    "dispersive_sar_dft": (False, False, True, True, True, False),
    "pml": (False, False, False, False, False, True),
    "lossy_pml": (True, False, False, False, False, True),
    "pml_dft": (False, False, False, False, True, True),
    "lossy_pml_dft": (True, False, False, False, True, True),
}
# (s, threads along j, coefficient ring) of each family beside its built
# shapes: the YEE_STREAM_CANDIDATES cases of csrc/yee_stream.cu::dispatch_ring
# and ::dispatch_pml
CANDIDATES = {
    "vacuum": ((4, 24, False),),
    "material": ((4, 32, True), (2, 24, True)),
    "dft": ((2, 32, False), (2, 24, False)),
    "dft_material": ((2, 32, False), (4, 24, False)),
    "ade": ((2, 32, False), (2, 16, True), (4, 24, False)),
    "ade_sar": ((2, 32, False), (2, 24, True)),
    "ade_dft": ((2, 32, False), (2, 24, True), (4, 24, False)),
    "ade_sar_dft": ((2, 32, False), (2, 24, True)),
    "pml": ((2, 32, False), (2, 20, False), (2, 16, False)),
    "pml_material": ((2, 32, True), (2, 20, True), (2, 24, False)),
    "pml_dft": ((2, 16, False),),
    "pml_dft_material": ((2, 16, False),),
}
MEANS_FOLD_NF = (4, 16)  # frequencies of the fold added to a means-mode sweep's time a step
# the fold's timed (cells a side, frequencies, levels): the means mode runs
# from 3 frequencies (vacuum) and 4-6 (Debye, CPML) up
FOLD_SHAPES = ((128, 16, 32), (256, 3, 32), (256, 4, 32), (256, 5, 32), (256, 6, 32), (256, 16, 32))
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
DFT_FREQUENCY = 2.45e10
PML_TIMED = PMLConfig(cells=10)  # the timed CPML scenes' walls (--pml 10)
PML_CHECKED = PMLConfig(cells=6)  # the checked box's walls
# a mangled ring_kernel<T, S, BJ, CR, LOSSY, HET, SAR, ADE, DFT, BOX> entry,
# and a pml_kernel<T, S, BJ, CR, LOSSY, DFT> one
# the flags of an entry's mangled name; the last (FOLD, the means mode) is absent before it existed
_ENTRY = re.compile(r"ring_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E" + r"Lb([01])E" * 7 + r"(?:Lb([01])E)?")
_PML_ENTRY = re.compile(r"pml_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E" + r"Lb([01])E" * 3 + r"(?:Lb([01])E)?")


def family(lossy: bool, sar: bool, ade: bool, dft: bool, pml: bool = False) -> str:
    """The shape family of a variant (the branches of dispatch_ring and
    dispatch_pml)."""
    if pml:
        return "pml" + ("_dft" if dft else "") + ("_material" if lossy else "")
    if ade:
        return "ade" + ("_sar" if sar else "") + ("_dft" if dft else "")
    if dft:
        return "dft_material" if lossy else "dft"
    return "material" if lossy else "vacuum"


def _pml(name: str) -> PMLConfig | None:
    return PML_TIMED if SCENES[name][5] else None


def built_shapes(name: str, p: Params) -> list[tuple[int, int, bool]]:
    """The (s, bj, cr) a scene's variant is built at."""
    lossy, het, sar, ade, dft, pml = SCENES[name]
    cfg = DftConfig((DFT_FREQUENCY,)) if dft else None
    table = stream_plan._block_j(lossy and not ade, pml, ade, sar, dft)
    plans = (stream_plan.plan_for(p, s, lossy, het, sar, _pml(name), ade=ade, dft=cfg) for s in table)
    return [(pl.s, pl.bj, pl.cr) for pl in plans]


def shapes(name: str, p: Params, built_only: bool) -> list[tuple[int, int, bool]]:
    lossy, _, sar, ade, dft, pml = SCENES[name]
    out = built_shapes(name, p)
    if not built_only:
        out += [c for c in CANDIDATES[family(lossy, sar, ade, dft, pml)] if c not in out]
    return out


def ptxas_report(log: str) -> dict[tuple, tuple[int, int]]:
    """(dtype, s, bj, cr, lossy, het, sar, ade, dft, box) ->
    (registers, spill-store bytes) of the ring_kernel entries of an ``nvcc
    -Xptxas -v`` log, and ("pml", dtype, s, bj, cr, lossy, dft) -> the same
    of its pml_kernel entries; the means mode's instantiations (``FOLD``)
    under the same key with "fold" appended."""
    out: dict[tuple, tuple[int, int]] = {}
    key, spill = None, 0
    for line in log.splitlines():
        m = _ENTRY.search(line) if "Compiling entry function" in line else None
        q = _PML_ENTRY.search(line) if "Compiling entry function" in line else None
        if m is not None:
            dtype = "float32" if m.group(1) == "f" else "bfloat16"
            key = (dtype, int(m.group(2)), int(m.group(3)), *(g == "1" for g in m.group(*range(4, 11))))
            key += ("fold",) if m.group(11) == "1" else ()
            spill = 0
        elif q is not None:
            dtype = "float32" if q.group(1) == "f" else "bfloat16"
            key = ("pml", dtype, int(q.group(2)), int(q.group(3)), *(g == "1" for g in q.group(4, 5, 6)))
            key += ("fold",) if q.group(7) == "1" else ()
            spill = 0
        elif key is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif key is not None and "registers" in line:
            out[key] = (int(re.search(r"Used (\d+) registers", line).group(1)), spill)
            key = None
    return out


@dataclasses.dataclass
class Case:
    """One sweep's inputs, built for a scene at a shape."""

    p: Params
    plan: stream_plan.StreamPlan
    coefs: object
    st: FieldState
    drive: stream.SweepDrive
    dc: object = None
    pol: PolState | None = None
    acc0: torch.Tensor | None = None
    d0: tuple | None = None
    wts: torch.Tensor | None = None
    cp: Cpml | None = None
    psi: PsiState | None = None
    mshape: tuple | None = None  # the means mode: the sweep's slice of the buffer

    def outputs(self):
        """Fresh outputs: the state, P, a copy of the map and of the sums,
        psi, the means buffer's slice."""
        nan = float("nan")
        return (FieldState(*(torch.full_like(t, nan) for t in self.st.tensors())),
                PolState(*(torch.full_like(t, nan) for t in self.pol.tensors())) if self.pol else None,
                self.acc0.clone() if self.acc0 is not None else None,
                tuple(t.clone() for t in self.d0) if self.d0 is not None else None,
                PsiState(*(torch.full_like(t, nan) for t in self.psi.tensors())) if self.psi else None,
                torch.full(self.mshape, nan, device=self.st.ex.device) if self.mshape else None)

    def run(self, outs, sweep=None, p=None, plan=None) -> list[torch.Tensor]:
        """One sweep into ``outs`` (``sweep``: another checkout's wrapper,
        with its own params and plan); returns the arrays it wrote."""
        out, pol_o, acc, dacc, psi_o, means = outs
        extra = {"means": means} if means is not None else {}
        (sweep or stream.sweep)(p or self.p, self.st, out, self.coefs, plan or self.plan, self.drive, acc,
                                self.cp, self.psi, psi_o, dc=self.dc, pol=self.pol, pol_out=pol_o, dacc=dacc,
                                wts=self.wts, **extra)
        return _arrays(outs)

    def plain(self) -> list[torch.Tensor]:
        outs = self.outputs()
        out, pol_o, acc, dacc, psi_o, means = outs
        stream.plain_sweep(self.p, self.st, self.coefs, self.plan.s, self.drive, out, acc, self.cp, self.psi, psi_o,
                           dc=self.dc, pol=self.pol, pol_out=pol_o, dacc=dacc, wts=self.wts, means=means)
        return _arrays(outs)


def _arrays(outs) -> list[torch.Tensor]:
    out, pol_o, acc, dacc, psi_o, means = outs
    return (list(out.tensors()) + (list(pol_o.tensors()) if pol_o else []) + ([acc] if acc is not None else [])
            + (list(dacc) if dacc else []) + (list(psi_o.tensors()) if psi_o else [])
            + ([means] if means is not None else []))


_MAPS: dict = {}  # (grid, dtype, scene's materials) -> its coefficients (a host fp64 build each)


def _maps(p: Params, name: str, dev: torch.device):
    """The scene's (coefs, Debye coefs), built once per grid, dtype and
    materials: the water block (a ferrite slab with het-mu), or the water
    block as a Debye medium."""
    lossy, het, _, ade, _, _ = SCENES[name]
    key = (p.padded_shape, p.dtype, lossy, het, ade)
    if key not in _MAPS:
        small = min(p.maxk, p.maxj, p.maxi) < 100
        mats = None
        if lossy:
            mats = water_block(p, lo=(0.05,) * 3, hi=(0.95,) * 3) if small else water_block(p)
            if het:
                mats = ferrite_slab(p, base=mats)
        dc = None
        if ade:
            dm = (water_debye_load(p, lo=(0.05,) * 3, hi=(0.95,) * 3, sigma_ion25=0.5) if small
                  else water_debye_load(p))
            dc = debye_coefs(p, dm, dev)
        _MAPS[key] = (update_coefs(p, mats, dev), dc)
    return _MAPS[key]


def make_case(p: Params, name: str, s: int, bj: int, cr: bool, dev: torch.device,
              rng: np.random.Generator, pml: PMLConfig | None = None, means: bool = False) -> Case:
    """A sweep of scene ``name`` at the shape (s, bj, cr) on the grid of
    ``p`` from random fields (step 1 hard-set by the source), random P where
    the load relaxes, a random map and random sums, random psi of every
    term (``pml``: the walls, default the timed scene's); ``means``: the
    DFT scene's means mode (a buffer of s levels) instead of its bands."""
    lossy, het, sar, ade, dft, with_pml = SCENES[name]
    dt = field_dtype(p)
    coefs, dc = _maps(p, name, dev)
    cfg = DftConfig((DFT_FREQUENCY,)) if dft else None
    pml = (pml or PML_TIMED) if with_pml else None
    plan = stream_plan.plan_for(p, s, lossy, het, sar, pml, ade=ade, bj=bj, dft=cfg, cr=cr, fold=s if means else 0)
    st = state_from_numpy({c: rng.uniform(-1.0, 1.0, p.padded_shape).astype(np.float32) for c in COMPONENTS}, dev, dt)
    src = make_source_plan(p)
    amps = torch.tensor(rng.uniform(-1.0, 1.0, s), dtype=torch.float64, device=dev)
    prof = profile_tensor(src, dev)
    apply_source(src, st, amps[0], prof)
    ez_rows, hx_rows = sweep_drive_rows(src, amps, s, dt, prof)
    drive = stream.SweepDrive(src.patch, ez_rows[0], hx_rows[0])
    pol = (PolState(*(torch.where(dc.k2[c] > 0, torch.tensor(rng.uniform(-1e-9, 1e-9, p.padded_shape), dtype=dt,
                                                             device=dev), 0.0) for c in "xyz")) if ade else None)
    acc0 = (torch.tensor(rng.uniform(0.0, 1e-11, (p.maxk, p.maxj, p.maxi)), dtype=torch.float32, device=dev)
            if sar else None)
    d0 = wts = None
    if dft and not means:
        shape = (1, 3, p.maxk, p.maxj, p.maxi)
        d0 = tuple(torch.tensor(rng.uniform(-1.0, 1.0, shape), dtype=torch.float32, device=dev) for _ in range(2))
        wts = torch.tensor(rng.uniform(-1.0, 1.0, (s, 2, 1)), dtype=torch.float32, device=dev)
    cp = psi = None
    if pml is not None:
        cp = make_cpml(p, pml, coefs, dev)
        shapes_ = psi_shapes(p, pml)
        psi = PsiState(**{n: torch.tensor(rng.uniform(-1e-2, 1e-2, shapes_[n]), dtype=dt, device=dev)
                          for n in PsiState.names()})
    return Case(p, plan, coefs, st, drive, dc, pol, acc0, d0, wts, cp, psi,
                stream.means_shape(p, s) if means else None)


def bound_ms(case: Case) -> float:
    """The least time of one sweep: every array it reads once and every
    array it writes once at the device memory's rate (the flops, about 30 a
    cell and step, bind nothing here)."""
    p, plan = case.p, case.plan
    item = {torch.float32: 4, torch.bfloat16: 2}[case.st.ex.dtype]
    arr = math.prod(p.padded_shape) * item
    cells = p.maxk * p.maxj * p.maxi
    b = 12 * arr  # six fields read and written
    if plan.ade:
        b += (6 + 15 + (3 if plan.sar else 0)) * arr  # P read and written, the maps
    elif plan.lossy:
        b += (6 + (3 if plan.het else 0)) * arr + (cells * item if plan.sar else 0)
    if plan.sar:
        b += 8 * cells  # the map read and written
    if plan.dft and plan.fold:
        b += 4 * math.prod(stream.means_shape(p, plan.s))  # the means mode: its fp32 buffer levels written
    elif plan.dft:
        b += 2 * 2 * 3 * 4 * cells  # (re, im) of three components, read and written
    if plan.pml:
        b += 2 * sum(t.numel() for t in case.psi.tensors()) * item  # psi read and written
    return b / HBM_BYTES_PER_S * 1e3


def event_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` keeps the card busy, over ``reps``
    calls between two CUDA events, queued behind a spin kernel (about 25
    ms) so that the host's time per launch is not counted (a CPML sweep's
    launch alone takes a few tenths of a ms, not far above its wrapper's
    host time)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def load_parent(path: Path):
    """Another checkout's ``fdtd_tpu_torch`` as a package of its own name
    (``fdtd_tpu_torch_parent``): its wrapper, plans and build dir."""
    name = "fdtd_tpu_torch_parent"
    root = Path(path) / "fdtd_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, root / "__init__.py", submodule_search_locations=[str(root)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    for sub in ("params", "dft", "ops.stream", "ops.stream_plan"):
        __import__(f"{name}.{sub}")
    return mod


def parent_run(parent, p: Params, name: str, dev: torch.device, rng: np.random.Generator):
    """(plan, run) of the parent checkout's sweep of scene ``name`` at that
    checkout's own plan (``pick_plan`` there), from inputs of its depth."""
    lossy, het, sar, ade, dft, _ = SCENES[name]
    fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    pp = parent.params.Params(**{**fields, "mode": parent.params.Mode(p.mode.value)})
    cfg = parent.dft.DftConfig((DFT_FREQUENCY,)) if dft else None
    plan = parent.ops.stream_plan.pick_plan(pp, lossy=lossy, het=het, sar=sar, pml=_pml(name), ade=ade, dft=cfg)
    case = make_case(p, name, plan.s, plan.bj, False, dev, rng)
    outs = case.outputs()
    return plan, lambda: case.run(outs, parent.ops.stream.sweep, pp, plan)


def parent_means_run(parent, p: Params, name: str, dev: torch.device, rng: np.random.Generator,
                     like: Case | None = None):
    """(plan, run) of the parent checkout's means-mode sweep of scene
    ``name`` (its plan for 16 frequencies), from inputs of its depth (those
    of ``like``, a case of this tree at the same depth, where given) into a
    slice of the means buffer."""
    lossy, het, sar, ade, _, _ = SCENES[name]
    fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    pp = parent.params.Params(**{**fields, "mode": parent.params.Mode(p.mode.value)})
    cfg = parent.dft.DftConfig(tuple(DFT_FREQUENCY + 1e7 * q for q in range(16)))
    plan = parent.ops.stream_plan.pick_plan(pp, lossy=lossy, het=het, sar=sar, pml=_pml(name), ade=ade, dft=cfg)
    if like is None or like.plan.s != plan.s:
        like = make_case(p, name, plan.s, plan.bj, plan.cr, dev, rng)
    case = dataclasses.replace(like, d0=None, wts=None, mshape=stream.means_shape(p, plan.s))
    outs = case.outputs()
    return plan, lambda: case.run(outs, parent.ops.stream.sweep, pp, plan)


def fold_inputs(cells: tuple, nf: int, depth: int, dev: torch.device, gen: torch.Generator):
    """A random buffer of ``FOLD_DEPTH`` levels, weights and (re, im) sums
    for a fold of ``depth`` levels and ``nf`` frequencies over ``cells``."""
    def rand(sh):
        return torch.rand(sh, generator=gen, device=dev) * 2 - 1

    return (rand((stream_plan.FOLD_DEPTH, 3, *cells)), rand((depth, 2, nf)),
            tuple(rand((nf, 3, *cells)) for _ in range(2)))


def parent_fold(parent, cells: tuple, nf: int, depth: int, dev: torch.device, gen: torch.Generator):
    """A call of the parent checkout's fold of ``depth`` levels and ``nf``
    frequencies over ``cells``, on inputs of its own."""
    buf, w, sums = fold_inputs(cells, nf, depth, dev, gen)
    return lambda: parent.ops.dft.fold(buf, w, sums)


def time_fold(dev: torch.device, card: str, reps: int, parent, emit) -> bool:
    """The fold against ``plain_fold`` (ragged boxes), then timed at
    :data:`FOLD_SHAPES` beside torch.addmm and the parent's fold (in turns:
    parent, this, this, parent)."""
    from .ops import dft as dft_ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    ok = True
    for cells, nf, depth in (((35, 29, 31), 5, 32), ((36, 29, 31), 33, 7), ((12, 12, 12), 1, 1)):
        buf, w, d0 = fold_inputs(cells, nf, depth, dev, gen)
        want = tuple(t.clone() for t in d0)
        dft_ops.plain_fold(buf, w, want)
        dft_ops.fold(buf, w, d0)
        torch.cuda.synchronize(dev)
        err = max(float((a - b).abs().max()) for a, b in zip(d0, want))
        ok = ok and err == 0.0
        emit({"fold_check": list(cells), "nf": nf, "depth": depth, "max_abs_err": err, "card": card})
    for n, nf, depth in FOLD_SHAPES:
        cells = (n, n, n)
        buf, w, sums = fold_inputs(cells, nf, depth, dev, gen)
        ncell = math.prod(cells)
        b = 12 * depth * ncell + 2 * 2 * 4 * nf * 3 * ncell
        bound = max(b / HBM_BYTES_PER_S, 12 * depth * nf * ncell / FP32_FLOPS) * 1e3
        line = {"fold": f"{n}^3", "nf": nf, "depth": depth, "bound_ms": bound, "card": card}
        built = lambda: dft_ops.fold(buf, w, sums)  # noqa: E731
        if parent is not None:
            prun = parent_fold(parent, cells, nf, depth, dev, gen)
            first = event_ms(prun, reps)
            ms = (event_ms(built, reps) + event_ms(built, reps)) / 2
            pms = (first + event_ms(prun, reps)) / 2
            line.update({"parent_ms": pms, "speedup": pms / ms})
            del prun
        else:
            ms = event_ms(built, reps)
        line.update({"ms": ms, "bound_share": bound / ms})
        lhs = torch.cat([w[:, 0, :].T, -w[:, 1, :].T]).contiguous()
        stacked = torch.cat([sums[0].reshape(nf, -1), sums[1].reshape(nf, -1)])
        m2 = buf[:depth].reshape(depth, -1)
        line["torch_addmm_ms"] = event_ms(lambda: stacked.addmm_(lhs, m2), reps)
        emit(line)
        del buf, w, sums, stacked, m2, lhs
        torch.cuda.empty_cache()
    return ok


def tune_means(args, dev: torch.device, card: str, parent, emit) -> bool:
    """``--only means``: every DFT scene's means-mode sweep at its built
    shape (its plan for 16 frequencies), checked against ``plain_sweep`` on
    a small ragged box and timed at n^3 (with ``parent``: the parent's
    means-mode sweep in turns, and both trees' ms a step with the fold
    added); then :func:`time_fold`."""
    from .ops import dft as dft_ops

    path = build.build(stream.KERNEL_SOURCE, defines=stream.FOLD_DEFINES)
    regs = ptxas_report(path.with_suffix(".log").read_text())
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    cfg = DftConfig(tuple(DFT_FREQUENCY + 1e7 * q for q in range(16)))
    ok = True
    fold_ms: dict = {}  # (tree, nf) -> ms of a 32-level fold at n^3

    def fold_step(tree, nf: int) -> float:
        """ms a step of a 32-level fold of ``nf`` frequencies at n^3 (``tree``: the parent, or None: this one)."""
        if (tree is None, nf) not in fold_ms:
            pb = scene(args.n, "float32")
            cells, depth = (pb.maxk, pb.maxj, pb.maxi), stream_plan.FOLD_DEPTH
            if tree is None:
                buf, w, sums = fold_inputs(cells, nf, depth, dev, gen)
                run = lambda: dft_ops.fold(buf, w, sums)  # noqa: E731
            else:
                run = parent_fold(tree, cells, nf, depth, dev, gen)
            fold_ms[(tree is None, nf)] = event_ms(run, args.reps) / depth
            del run
            torch.cuda.empty_cache()
        return fold_ms[(tree is None, nf)]

    scenes = [n for n in args.scenes if SCENES[n][4]]
    for dtype in args.dtypes:
        small = Params(length=0.0615, width=0.0505, height=0.0705, spatial_step=0.001, time_step=1e-12,
                       simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype=dtype)
        big = scene(args.n, dtype)
        for name in scenes:
            lossy, het, sar, ade, _, pml = SCENES[name]
            built = stream_plan.pick_plan(big, lossy=lossy, het=het, sar=sar, pml=_pml(name), ade=ade, dft=cfg)
            s, bj, cr = built.s, built.bj, built.cr
            line = {"scene": name + "_means", "dtype": dtype, "n": args.n, "s": s, "bj": bj, "cr": cr, "card": card}
            check = make_case(small, name, s, bj, cr, dev, rng, PML_CHECKED, means=True)
            got = check.run(check.outputs())
            want = check.plain()
            torch.cuda.synchronize(dev)
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
            err = float("inf") if err != err else err
            ok = ok and err == 0.0
            del check, got, want
            case = make_case(big, name, s, bj, cr, dev, rng, means=True)
            plan = case.plan
            outs = case.outputs()
            if parent is not None:
                pplan, prun = parent_means_run(parent, big, name, dev, rng, case)
                first = event_ms(prun, args.reps)
                ms = (event_ms(lambda: case.run(outs), args.reps) + event_ms(lambda: case.run(outs), args.reps)) / 2
                pms = (first + event_ms(prun, args.reps)) / 2
                line["parent"] = {"s": pplan.s, "bj": pplan.bj, "blocks": pplan.blocks, "ms_per_sweep": pms,
                                  "ms_per_step": pms / pplan.s}
                line["speedup_per_step"] = (pms / pplan.s) / (ms / s)
                line["with_fold"] = {
                    f"nf={nf}": {"ms_per_step": ms / s + fold_step(None, nf),
                                 "parent_ms_per_step": pms / pplan.s + fold_step(parent, nf),
                                 "speedup_per_step": (pms / pplan.s + fold_step(parent, nf))
                                 / (ms / s + fold_step(None, nf))} for nf in MEANS_FOLD_NF}
                del prun
            else:
                ms = event_ms(lambda: case.run(outs), args.reps)
            key_pml = ("pml", dtype, s, bj, cr, plan.lossy, plan.dft, "fold")
            key_ring = (dtype, s, bj, cr, plan.lossy, plan.het, plan.sar, plan.ade, plan.dft, False, "fold")
            reg, spill = regs.get(key_pml if pml else key_ring, (None, None))
            bound = bound_ms(case)
            line.update({"kernel": plan.kernel, "threads": plan.threads, "tile": [plan.tk, plan.tj, plan.ti],
                         "blocks": plan.blocks, "waves": plan.waves, "ms_per_sweep": ms, "ms_per_step": ms / s,
                         "bound_ms": bound, "bound_share": bound / ms, "registers": reg,
                         "spill_store_bytes": spill, "max_abs_err": err})
            if plan.core is not None:
                shell, inner = dataclasses.replace(plan, core=None), dataclasses.replace(plan, pml_blocks=())
                line["shell_ms"] = event_ms(lambda: case.run(outs, plan=shell), args.reps)
                core = plan.core
                line["interior"] = {
                    "window": list(core.window), "bj": core.bj, "cr": core.cr, "blocks": core.blocks,
                    "ms": event_ms(lambda: case.run(outs, plan=inner), args.reps),
                    "registers": regs.get((dtype, core.s, core.bj, core.cr, core.lossy, False, False, False,
                                           core.dft, True, "fold"))}
            emit(line)
            del case, outs
            torch.cuda.empty_cache()
    return time_fold(dev, card, args.reps, parent, emit) and ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fdtd_tpu_torch.tune_stream", description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256, help="cells per side of the timed scene (default 256)")
    ap.add_argument("--reps", type=int, default=20, help="timed sweeps per shape (default 20)")
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--scenes", nargs="+", default=list(SCENES), choices=list(SCENES))
    ap.add_argument("--built", action="store_true", help="the built shapes only")
    ap.add_argument("--only", choices=["means"], default=None,
                    help="means: the DFT bands' means mode and the fold kernel instead")
    ap.add_argument("--parent", default=None, help="a checkout of another commit to time in the same call")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: tune_stream measures a CUDA device and none is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    parent = load_parent(Path(args.parent)) if args.parent else None
    sink = open(args.out, "w") if args.out else None

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")

    if args.only == "means":
        ok = tune_means(args, dev, card, parent, emit)
        if sink:
            sink.close()
        return 0 if ok else 1
    path = build.build(stream.KERNEL_SOURCE, defines=() if args.built else (DEFINE,))
    regs = ptxas_report(path.with_suffix(".log").read_text())
    stream.use_library(path)
    rng = np.random.default_rng(0)
    ok = True

    for dtype in args.dtypes:
        small = Params(length=0.0615, width=0.0505, height=0.0705, spatial_step=0.001, time_step=1e-12,
                       simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype=dtype)
        big = scene(args.n, dtype)
        for name in args.scenes:
            lossy, het, sar, ade, dft, pml = SCENES[name]
            cfg = DftConfig((DFT_FREQUENCY,)) if dft else None
            picked = stream_plan.pick_plan(big, lossy=lossy, het=het, sar=sar, pml=_pml(name), ade=ade, dft=cfg)
            cases: dict[int, Case] = {}  # the n^3 inputs a depth
            for s, bj, cr in shapes(name, big, args.built):
                line = {"scene": name, "dtype": dtype, "n": args.n, "s": s, "bj": bj, "cr": cr, "card": card}
                check = make_case(small, name, s, bj, cr, dev, rng, PML_CHECKED)
                if check.plan.smem_bytes + check.plan.dft_smem_bytes(1) > stream_plan.SMEM_PER_BLOCK:
                    emit({**line, "skipped": "shared memory"})
                    continue
                got = check.run(check.outputs())
                want = check.plain()
                torch.cuda.synchronize(dev)
                err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
                err = float("inf") if err != err else err  # a NaN left in an output counts as a difference
                ok = ok and err == 0.0
                del check, got, want
                if s not in cases:
                    cases.clear()
                    torch.cuda.empty_cache()
                    cases[s] = make_case(big, name, s, bj, cr, dev, rng)
                plan = stream_plan.plan_for(big, s, lossy, het, sar, _pml(name), ade=ade, bj=bj, dft=cfg, cr=cr)
                case = dataclasses.replace(cases[s], plan=plan)
                outs = case.outputs()
                line["picked"] = (s, bj, cr) == (picked.s, picked.bj, picked.cr)
                if parent is not None and line["picked"]:
                    # the parent's design of the same variant, in turns with this one
                    pplan, prun = parent_run(parent, big, name, dev, rng)
                    first = event_ms(prun, args.reps)
                    ms = (event_ms(lambda: case.run(outs), args.reps) + event_ms(lambda: case.run(outs), args.reps)) / 2
                    pms = (first + event_ms(prun, args.reps)) / 2
                    line["parent"] = {"s": pplan.s, "bj": pplan.bj, "blocks": pplan.blocks,
                                      "waves": pplan.blocks / stream_plan.SM_COUNT, "ms_per_sweep": pms,
                                      "ms_per_step": pms / pplan.s}
                    line["speedup_per_step"] = (pms / pplan.s) / (ms / s)
                    del prun
                else:
                    ms = event_ms(lambda: case.run(outs), args.reps)
                if pml:
                    reg, spill = regs.get(("pml", dtype, s, bj, cr, plan.lossy, plan.dft), (None, None))
                else:
                    reg, spill = regs.get((dtype, s, bj, cr, plan.lossy, plan.het, plan.sar, plan.ade, plan.dft,
                                           False), (None, None))
                bound = bound_ms(case)
                line.update({
                    "kernel": plan.kernel, "threads": plan.threads, "tile": [plan.tk, plan.tj, plan.ti],
                    "blocks": plan.blocks, "waves": plan.waves, "ms_per_sweep": ms, "ms_per_step": ms / s,
                    "bound_ms": bound, "bound_share": bound / ms,
                    "modelled_bytes_per_cell_step": plan.bytes_per_cell_step, "registers": reg,
                    "spill_store_bytes": spill, "smem_bytes": plan.smem_bytes + plan.dft_smem_bytes(1),
                    "max_abs_err": err, "built": (s, bj, cr) in built_shapes(name, big),
                })
                if plan.core is not None:
                    # each launch alone: the shell (no interior) and the interior (no shell blocks)
                    shell, inner = dataclasses.replace(plan, core=None), dataclasses.replace(plan, pml_blocks=())
                    line["shell_ms"] = event_ms(lambda: case.run(outs, plan=shell), args.reps)
                    core = plan.core
                    line["interior"] = {
                        "window": list(core.window), "s": core.s, "bj": core.bj, "cr": core.cr,
                        "blocks": core.blocks, "ms": event_ms(lambda: case.run(outs, plan=inner), args.reps),
                        "registers": regs.get((dtype, core.s, core.bj, core.cr, core.lossy, False, False, False,
                                               core.dft, True))}
                emit(line)
                del case, outs
            del cases
            torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
