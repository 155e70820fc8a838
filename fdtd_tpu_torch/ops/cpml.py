"""Convolutional PML (CPML) absorbing boundaries: the torch ground truth and
the plain versions of the CPML kernels.

Counterpart of ``fdtd_tpu/ops/cpml.py`` (Roden & Gedney's CPML with
kappa = 1; Taflove & Hagness ch. 7), backed by the cavity's PEC walls.
Every spatial difference Delta_w(u) feeding a curl gains a memory variable

    psi^{n+1} = b_w psi^n + c_w Delta_w(u)
    b_w = exp(-(sigma_w + alpha_w) dt / EPSILON)
    c_w = sigma_w / (sigma_w + alpha_w) * (b_w - 1)

and the field update adds ``+-f * psi`` (H pass) or ``+-cb * psi`` (E
pass) on top of the unchanged curl term.  sigma_w is graded polynomially
over the ``cells``-deep slab at each face, sampled at each component's own
staggered position along the PML axis (integer for E, half-integer for H).

psi is SLAB-RESTRICTED, as in the JAX package: each of the twelve arrays
of :class:`PsiState` holds only the ``2 * cells`` rows of its PML axis
(lo slab then hi slab) over its target's update region.  This is the port's
hot layout and its checkpoint layout: the kernels (``csrc/yee_twopass.cu``,
``csrc/yee_stream.cu``) read and write these tensors in place, so nothing
packs or unpacks between steps.  A shard of a sharded run holds its part of
each array: the slab rows whose cells lie in its owned window
(:func:`psi_part_slices`; :func:`cut_psi` and :func:`join_psi` move them
to and from the canonical arrays), and its corrections and plain passes
(a :class:`Cpml` made with the shard's ``box``) work on its arrays.

Per target the adds follow ``_TERMS``: the curl update, then the j/i-axis
term(s), then the k-axis term, each add rounded on its own.  The correction
factors are per cell where the coefficients are (cb with lossy media, hf
with heterogeneous mu_r), the scalar otherwise.

Two step orders compute the same fields:

- the ``torch`` backend (:func:`make_pml_step`) is the JAX package's xla
  order: [source] -> H -> H corrections -> [source] -> E -> E corrections;
  the second source application overwrites any psi add on the patch;
- the kernels and their plain versions (:meth:`Cpml.plain_h`,
  :meth:`Cpml.plain_e`) set the source once, before H, and the H pass
  leaves Hx/Hz on the k=0 patch alone: it skips the curl update AND the
  psi adds there (hx_y, hx_z, hz_y, hz_x), while those psi recursions
  still run.  The same bits, one source application fewer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import EPSILON, MU
from ..grid import Box, full_box
from ..params import Mode, Params
from ..source import apply_source, make_source_plan, profile_tensor
from ..state import FieldState, UpdateCoefs, field_dtype
from . import curl

ETA0 = float(np.sqrt(MU / EPSILON))  # free-space impedance (~376.73 ohm)


@dataclasses.dataclass(frozen=True)
class PMLConfig:
    """CPML absorber configuration (``fdtd_tpu.ops.cpml.PMLConfig``).

    ``cells``: slab depth at each of the six faces.  ``m``: polynomial
    grading order.  ``sigma_scale``: multiplies the textbook optimum
    sigma_max = 0.8 (m+1) / (eta0 dx).  ``alpha``: CFS alpha (S/m).
    """

    cells: int = 10
    m: float = 3.0
    sigma_scale: float = 1.0
    alpha: float = 0.0


# The 12 correction terms: (name, target, sign, pml_axis, src, e_pass).
# H terms difference src at +1 along the pml axis; E terms at -1.  Per
# target the j/i-axis terms precede the k-axis term (the order of
# fdtd_tpu/ops/cpml.py, which every path keeps so corner cells round alike).
_TERMS = (
    ("hx_y", "hx", -1, 1, "ez", False),
    ("hx_z", "hx", +1, 0, "ey", False),
    ("hy_x", "hy", +1, 2, "ez", False),
    ("hy_z", "hy", -1, 0, "ex", False),
    ("hz_y", "hz", +1, 1, "ex", False),
    ("hz_x", "hz", -1, 2, "ey", False),
    ("ex_y", "ex", +1, 1, "hz", True),
    ("ex_z", "ex", -1, 0, "hy", True),
    ("ey_x", "ey", -1, 2, "hz", True),
    ("ey_z", "ey", +1, 0, "hx", True),
    ("ez_x", "ez", +1, 2, "hy", True),
    ("ez_y", "ez", -1, 1, "hx", True),
)
TERM_NAMES = tuple(t[0] for t in _TERMS)  # the kernels' psi order: six H, then six E
H_TERMS = TERM_NAMES[:6]
E_TERMS = TERM_NAMES[6:]


@dataclasses.dataclass
class PsiState:
    """The 12 CPML memory variables, one per curl difference term
    (``<comp>_<axis>``), in the slab-restricted layout of
    :func:`psi_shapes`; field order as in the JAX package's PsiState."""

    hx_z: torch.Tensor
    hx_y: torch.Tensor
    hy_x: torch.Tensor
    hy_z: torch.Tensor
    hz_y: torch.Tensor
    hz_x: torch.Tensor
    ex_y: torch.Tensor
    ex_z: torch.Tensor
    ey_z: torch.Tensor
    ey_x: torch.Tensor
    ez_x: torch.Tensor
    ez_y: torch.Tensor

    @staticmethod
    def names() -> tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(PsiState))

    def tensors(self, order: tuple[str, ...] | None = None) -> tuple[torch.Tensor, ...]:
        """The twelve tensors, in ``order`` (default: field order)."""
        return tuple(getattr(self, n) for n in (order or self.names()))

    def to(self, dtype: torch.dtype) -> "PsiState":
        return PsiState(*(t.to(dtype=dtype) for t in self.tensors()))

    def clone(self) -> "PsiState":
        return PsiState(*(t.clone() for t in self.tensors()))

    def swap(self, other: "PsiState") -> None:
        """Exchange the tensors of ``self`` and ``other`` (no copy)."""
        for n in self.names():
            a, b = getattr(self, n), getattr(other, n)
            setattr(self, n, b)
            setattr(other, n, a)


def _profile(pos: np.ndarray, extent: int, p: Params, cfg: PMLConfig):
    """(b, c) fp64 1-D CPML recursion coefficients at positions ``pos``
    (cell units along the PML axis; walls at 0 and ``extent``).  Outside
    the two slabs sigma = 0 gives (b, c) = (1, 0)."""
    d = np.maximum(cfg.cells - pos, pos - (extent - cfg.cells)) / cfg.cells
    d = np.clip(d, 0.0, 1.0)
    sigma_max = cfg.sigma_scale * 0.8 * (cfg.m + 1) / (ETA0 * p.spatial_step)
    sigma = sigma_max * d**cfg.m
    tot = sigma + cfg.alpha
    b = np.exp(-tot * p.time_step / EPSILON)
    with np.errstate(invalid="ignore", divide="ignore"):
        c = np.where(tot > 0.0, sigma / np.where(tot > 0, tot, 1.0) * (b - 1.0), 0.0)
    return b, c


def _update_regions(p: Params) -> dict[str, tuple[slice, slice, slice]]:
    """Array-coordinate update regions (the bounds of :mod:`.curl`)."""
    K, J, I = p.maxk, p.maxj, p.maxi
    return {
        "hx": (slice(0, K), slice(0, J), slice(0, I + 1)),
        "hy": (slice(0, K), slice(0, J + 1), slice(0, I)),
        "hz": (slice(0, K + 1), slice(0, J), slice(0, I)),
        "ex": (slice(1, K), slice(1, J), slice(0, I)),
        "ey": (slice(1, K), slice(0, J), slice(1, I)),
        "ez": (slice(0, K), slice(1, J), slice(1, I)),
    }


def _slab_slices(region, axis: int, npml: int):
    """(lo, hi) sub-regions: the npml rows at each end of ``region`` along
    ``axis`` (the rows whose sigma can be non-zero)."""
    r = region[axis]
    lo, hi = list(region), list(region)
    lo[axis] = slice(r.start, r.start + npml)
    hi[axis] = slice(r.stop - npml, r.stop)
    return tuple(lo), tuple(hi)


def _check_cfg(p: Params, cfg: PMLConfig) -> None:
    K, J, I = p.maxk, p.maxj, p.maxi
    if cfg.cells < 1:
        raise ValueError("PML needs cells >= 1")
    if 2 * cfg.cells >= min(K, J, I):
        raise ValueError(f"PML slabs ({cfg.cells} cells/face) overlap: grid is ({K}, {J}, {I}) cells")


def psi_shapes(p: Params, cfg: PMLConfig) -> dict[str, tuple[int, int, int]]:
    """The slab-restricted psi array shapes: each term's target update
    region with ``2 * cells`` rows along its PML axis."""
    regions = _update_regions(p)
    shapes = {}
    for name, target, _sign, axis, _src, _e in _TERMS:
        shape = [s.stop - s.start for s in regions[target]]
        shape[axis] = 2 * cfg.cells
        shapes[name] = tuple(shape)
    return shapes


def psi_boxes(p: Params, cfg: PMLConfig) -> dict[str, tuple[tuple[tuple[int, int], ...], ...]]:
    """The cells that hold psi, per term: its two slabs (lo, hi) as
    (start, stop) index ranges of the padded grid along k, j and i (the
    term's update region with ``cells`` rows at each end of its PML axis)."""
    regions = _update_regions(p)
    out = {}
    for name, target, _sign, axis, _src, _e in _TERMS:
        out[name] = tuple(tuple((s.start, s.stop) for s in sl) for sl in _slab_slices(regions[target], axis, cfg.cells))
    return out


def psi_bytes(p: Params, cfg: PMLConfig) -> int:
    """Device bytes of one :class:`PsiState` in the field dtype."""
    item = {"float32": 4, "bfloat16": 2, "float64": 8}[p.dtype]
    return item * sum(int(np.prod(s)) for s in psi_shapes(p, cfg).values())


def init_psi(p: Params, cfg: PMLConfig, device) -> PsiState:
    """Zero memory variables in the slab-restricted layout, in the field
    dtype of ``p`` on ``device``."""
    _check_cfg(p, cfg)
    shapes = psi_shapes(p, cfg)
    return PsiState(**{n: torch.zeros(shapes[n], dtype=field_dtype(p), device=device)
                       for n in PsiState.names()})


def _shifted(sl, axis: int, d: int):
    out = list(sl)
    out[axis] = slice(sl[axis].start + d, sl[axis].stop + d)
    return tuple(out)


def psi_part_slices(p: Params, cfg: PMLConfig, box: Box | None = None) -> dict[str, tuple[slice, slice, slice]]:
    """A shard's part of each term's slab-restricted array (:func:`psi_shapes`):
    the slices of the canonical array whose cells lie in the box's owned
    window (default: the whole grid, the whole array).  Along the term's PML
    axis these are the slab rows that fall in the window, contiguous because
    the hi slab's rows follow the lo slab's at higher planes; along the other
    axes the region's cells in the window.  A part may be empty, hold part
    of one slab (a k slab straddling two shards) or rows of both."""
    box = box or full_box(p)
    n = cfg.cells
    regions = _update_regions(p)
    out = {}
    for name, target, _sign, axis, _src, _e in _TERMS:
        sl = []
        for a, r in enumerate(regions[target]):
            w0, w1 = box.own_lo[a], box.own_hi[a]
            if a == axis:
                top = r.stop - 2 * n  # hi slab row q lies on plane top + q
                rows = [(x0, x1) for x0, x1 in ((max(w0 - r.start, 0), min(w1 - r.start, n)),
                                                 (max(w0 - top, n), min(w1 - top, 2 * n))) if x0 < x1]
                a0, a1 = (rows[0][0], rows[-1][1]) if rows else (0, 0)
            else:
                a0, a1 = max(w0, r.start) - r.start, min(w1, r.stop) - r.start
            sl.append(slice(a0, a1) if a1 > a0 else slice(0, 0))
        out[name] = tuple(sl)
    return out


def psi_part_shapes(p: Params, cfg: PMLConfig, box: Box | None = None) -> dict[str, tuple[int, int, int]]:
    """The shapes of a shard's psi parts (:func:`psi_part_slices`)."""
    return {n: tuple(s.stop - s.start for s in sl) for n, sl in psi_part_slices(p, cfg, box).items()}


def cut_psi(p: Params, cfg: PMLConfig, psi: PsiState, box: Box, device) -> PsiState:
    """Copies of a shard's parts of the canonical ``psi`` on ``device``
    (the counterpart of ``fdtd_tpu/parallel/sharded_pml_fast.py::
    embed_psi_pack`` and ``sharded_step.embed_psi12``)."""
    parts = {}
    for n, sl in psi_part_slices(p, cfg, box).items():
        view = getattr(psi, n)[sl]
        parts[n] = torch.empty(view.shape, dtype=view.dtype, device=device).copy_(view)
    return PsiState(**parts)


def join_psi(p: Params, cfg: PMLConfig, part: PsiState, box: Box, psi: PsiState) -> None:
    """Write a shard's parts into the canonical ``psi`` in place (the
    counterpart of ``extract_psi_pack`` and ``extract_psi12``)."""
    for n, sl in psi_part_slices(p, cfg, box).items():
        getattr(psi, n)[sl].copy_(getattr(part, n))


def psi_part_geometry(p: Params, cfg: PMLConfig, box: Box, names: tuple[str, ...]) -> list[int]:
    """The kernels' view of a shard's psi parts of the terms ``names``: per
    term its origin in the canonical array and its extents along axes 1
    and 2, five ints."""
    parts = psi_part_slices(p, cfg, box)
    out = []
    for n in names:
        sl = parts[n]
        out += [s.start for s in sl] + [sl[1].stop - sl[1].start, sl[2].stop - sl[2].start]
    return out


def build_plan(p: Params, cfg: PMLConfig, device) -> dict:
    """Per-term correction plan: ``{name: (lo_sl, hi_sl, sign, axis, src,
    target, b, c)}`` with the target's slab sub-regions in array
    coordinates and the (b, c) recursion tables, computed in fp64 numpy
    and rounded once to the field dtype on ``device``, shaped to broadcast
    along the PML axis (``2 * cells`` rows: the lo slab, then the hi)."""
    npml = cfg.cells
    dt = field_dtype(p)
    regions = _update_regions(p)
    extents = {0: p.maxk, 1: p.maxj, 2: p.maxi}
    plan = {}
    for name, target, sign, axis, src, e_pass in _TERMS:
        lo_sl, hi_sl = _slab_slices(regions[target], axis, npml)
        off = 0.0 if e_pass else 0.5
        pos = np.concatenate([
            np.arange(lo_sl[axis].start, lo_sl[axis].stop, dtype=np.float64),
            np.arange(hi_sl[axis].start, hi_sl[axis].stop, dtype=np.float64),
        ]) + off
        b, c = _profile(pos, extents[axis], p, cfg)
        shape = [1, 1, 1]
        shape[axis] = 2 * npml
        plan[name] = (
            lo_sl, hi_sl, sign, axis, src, target,
            torch.tensor(b, dtype=dt, device=device).reshape(shape),
            torch.tensor(c, dtype=dt, device=device).reshape(shape),
        )
    return plan


def _rows(t: torch.Tensor, axis: int, rows: slice) -> torch.Tensor:
    return t.narrow(axis, rows.start, rows.stop - rows.start)


def _box_runs(p: Params, cfg: PMLConfig, plan: dict, box: Box) -> dict:
    """``plan`` (:func:`build_plan`) over a box's owned cells: ``{name:
    (runs, b, c)}``, ``runs`` the target's slab cells in the window as
    (local slices of the box's arrays, the rows of the term's psi part
    along its PML axis), one run per slab the part holds, and ``b``, ``c``
    the part's rows of the tables."""
    parts = psi_part_slices(p, cfg, box)
    out = {}
    for name, (lo_sl, hi_sl, _sign, axis, _src, _tg, b, c) in plan.items():
        rows = parts[name][axis]
        runs = []
        for q, sl in enumerate((lo_sl, hi_sl)):
            lo = [max(s.start, w) for s, w in zip(sl, box.own_lo)]
            hi = [min(s.stop, w) for s, w in zip(sl, box.own_hi)]
            if all(h > g for g, h in zip(lo, hi)):
                q0 = q * cfg.cells + lo[axis] - sl[axis].start - rows.start
                runs.append((box.local(lo, hi), slice(q0, q0 + hi[axis] - lo[axis])))
        out[name] = (runs, _rows(b, axis, rows), _rows(c, axis, rows))
    return out


def make_cpml_corrections(p: Params, cfg: PMLConfig, coefs: UpdateCoefs, device, box: Box | None = None):
    """``(h_correct, e_correct)``, both in place.

    ``h_correct(s, psi, patch=None)`` advances the six H-pass memory
    variables from the (unchanged) E fields and adds ``+-f * psi`` over
    the slab rows of each H component's update region; ``e_correct(s,
    psi)`` is the E-pass analogue adding ``+-cb * psi``.  With ``patch`` =
    (j0, j1, i0, i1), Hx and Hz on the k=0 patch keep the values they
    had before the corrections (the recursions still run there).  The
    arithmetic runs in the compute type of the tensors it is given (fp32
    for bf16 storage, rounded once per add).  Outside the slabs nothing is
    touched.  With ``box`` (a shard, :class:`~fdtd_tpu_torch.grid.Box`)
    they work on the shard's arrays and its psi parts
    (:func:`psi_part_slices`) over its owned cells, with its parts of the
    coefficients, reading the neighbour planes from its halos; a cell gets
    the operations of the whole grid's corrections.
    """
    _check_cfg(p, cfg)
    box = box or full_box(p)
    return _corrections(coefs, _box_runs(p, cfg, build_plan(p, cfg, device), box), box)


def _corrections(coefs: UpdateCoefs, runs: dict, box: Box):
    """The corrections of :func:`make_cpml_corrections` on the runs and
    tables of ``runs`` (:func:`_box_runs`) over ``box``."""

    def factor(target: str, sub, e_pass: bool, cd: torch.dtype):
        if e_pass:
            cb = getattr(coefs, f"cb_{target[1]}")
            return cb[sub].to(cd) if coefs.lossy else curl.scalar(cb, cd)
        if coefs.heterogeneous_mu:
            return getattr(coefs, f"hf_{target[1]}")[sub].to(cd)
        return curl.scalar(coefs.h_factor, cd)

    def apply(s: FieldState, psi: PsiState, e_pass: bool) -> None:
        # sources are never targets within a pass (H reads E, E reads the
        # just-updated H), so every difference sees the pass's inputs
        for name, target, sign, axis, src, e in _TERMS:
            term_runs, b, c = runs[name]
            if e != e_pass or not term_runs:
                continue
            u = getattr(s, src)
            cd = curl.compute_dtype(u.dtype)
            u = u.to(cd)
            ps = getattr(psi, name)
            t = getattr(s, target)
            for sl, rows in term_runs:
                if e_pass:
                    d = u[sl] - u[_shifted(sl, axis, -1)]
                else:
                    d = u[_shifted(sl, axis, 1)] - u[sl]
                pr = _rows(ps, axis, rows)
                pnew = _rows(b, axis, rows).to(cd) * pr.to(cd) + _rows(c, axis, rows).to(cd) * d
                pr.copy_(pnew)
                t[sl] = t[sl].to(cd) + (sign * factor(target, sl, e_pass, cd)) * pnew

    def h_correct(s: FieldState, psi: PsiState, patch: tuple[int, int, int, int] | None = None) -> None:
        local = box.patch(patch) if patch is not None else None
        keep = None
        if local is not None:
            psl = (0,) + local[0]
            keep = (s.hx[psl].clone(), s.hz[psl].clone())
        apply(s, psi, e_pass=False)
        if keep is not None:
            s.hx[psl] = keep[0]
            s.hz[psl] = keep[1]

    def e_correct(s: FieldState, psi: PsiState) -> None:
        apply(s, psi, e_pass=True)

    return h_correct, e_correct


@dataclasses.dataclass(frozen=True)
class Cpml:
    """Everything a runner needs for CPML on one device, or on one shard
    (``box``): the config, the kernels' (b, c) tables (one (6, 2, 2*cells)
    tensor per pass: b and c of each term in ``_TERMS`` order over the
    canonical slab rows, field dtype; a shard's kernels index them by
    canonical row too), the corrections of :func:`make_cpml_corrections`
    over the box, the psi (part) shapes the passes take, worked out once,
    and ``march``, the kernels' launch geometry of each pass (the box, its
    psi parts and the launch shape: ``ops/stream_plan.py::march_geometry``,
    keyed by ``H_TERMS`` and ``E_TERMS``), cached at the first launch."""

    cfg: PMLConfig
    table_h: torch.Tensor
    table_e: torch.Tensor
    h_correct: object
    e_correct: object
    box: Box | None = None
    shapes: dict = dataclasses.field(default_factory=dict)
    march: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def plain_h(self, p: Params, s: FieldState, coefs: UpdateCoefs, psi: PsiState,
                patch: tuple[int, int, int, int] | None = None) -> None:
        """The plain version of the CPML H kernel: :func:`curl.update_h`
        then the H corrections, both leaving the source patch alone, in
        place (with ``box``: a shard's owned cells and psi parts).  bf16
        storage computes on fp32 copies and rounds once."""
        self._pass(p, s, coefs, psi, patch, e_pass=False)

    def plain_e(self, p: Params, s: FieldState, coefs: UpdateCoefs, psi: PsiState) -> None:
        """The plain version of the CPML E kernel: :func:`curl.update_e`
        then the E corrections, in place (bf16: on fp32 copies)."""
        self._pass(p, s, coefs, psi, None, e_pass=True)

    def _pass(self, p, s, coefs, psi, patch, e_pass: bool) -> None:
        cd = curl.compute_dtype(s.ex.dtype)
        w, wp = (s, psi) if cd == s.ex.dtype else (s.to(dtype=cd), psi.to(cd))
        if e_pass:
            curl.update_e(p, w, coefs, self.box)
            self.e_correct(w, wp)
        else:
            curl.update_h(p, w, coefs, patch, self.box)
            self.h_correct(w, wp, patch)
        if w is not s:
            for c in (("ex", "ey", "ez") if e_pass else ("hx", "hy", "hz")):
                getattr(s, c).copy_(getattr(w, c))
            for n in (E_TERMS if e_pass else H_TERMS):
                getattr(psi, n).copy_(getattr(wp, n))


def make_cpml(p: Params, cfg: PMLConfig, coefs: UpdateCoefs, device, box: Box | None = None) -> Cpml:
    """The :class:`Cpml` of ``cfg`` on the grid of ``p`` with ``coefs``;
    with ``box`` a shard's (``coefs`` its parts, psi its parts)."""
    _check_cfg(p, cfg)
    if box is not None and box.is_full(p):
        box = None
    plan = build_plan(p, cfg, device)

    def table(names):
        return torch.stack([torch.stack([plan[n][6].reshape(-1), plan[n][7].reshape(-1)]) for n in names])

    h_correct, e_correct = _corrections(coefs, _box_runs(p, cfg, plan, box or full_box(p)), box or full_box(p))
    return Cpml(cfg, table(H_TERMS).contiguous(), table(E_TERMS).contiguous(), h_correct, e_correct, box,
                psi_part_shapes(p, cfg, box))


def make_pml_step(p: Params, cfg: PMLConfig, coefs: UpdateCoefs, device):
    """One leapfrog step with CPML in the JAX package's xla order:
    ``step(s, (t, amp), psi)`` advances both in place ([source] ->
    update_H -> H corrections -> [source] -> update_E -> E corrections)."""
    plan = make_source_plan(p) if p.mode == Mode.COMPUTATION else None
    profile = profile_tensor(plan, device) if plan is not None else None
    h_correct, e_correct = make_cpml_corrections(p, cfg, coefs, device)

    def step(s: FieldState, x, psi: PsiState) -> None:
        if plan is not None:
            apply_source(plan, s, x[1], profile)
        curl.update_h(p, s, coefs)
        h_correct(s, psi)
        if plan is not None:
            apply_source(plan, s, x[1], profile)
        curl.update_e(p, s, coefs)
        e_correct(s, psi)

    return step
