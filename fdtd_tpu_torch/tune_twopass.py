"""Time the two-pass kernels of ``csrc/yee_twopass.cu`` on the card.

    python -m fdtd_tpu_torch.tune_twopass [--parent CHECKOUT] [--n 256] [--reps 20]
        [--dtypes float32 bfloat16] [--only passes|batch] [--out FILE]

Builds ``yee_twopass.cu`` with ``-DYEE_TWOPASS_CANDIDATES`` (every entry
point of the default build, and ``yee_march_candidate``: the k-marching
core, ``march_kernel``, at the shapes of ``SHAPES``, with and without
CPML) and launches everything from it:

- the CPML passes as built (``march_kernel`` with CPML: K10-H,
  K10-H-het, K10-E, K10-E-lossy, on the whole grid and on a middle slab
  of ``--shard 4``), each checked against its plain version
  (``Cpml.plain_h`` / ``plain_e``) bit for bit, fields and psi, from
  random fields, coefficients and psi, on the whole grid and every shard
  of a 4-slab and a 2 x 3 mesh of a ragged 35 x 27 x 31 box with a 10-cell
  absorber (k and j slabs straddling shards), then timed at ``--n``^3;
  with ``--parent`` (another checkout, e.g. ``git archive`` of the parent
  commit) the parent's same pass from the same inputs, equal bit for bit,
  and timed in turns with this one (parent, this, this, parent);
- the passes without CPML as built (K1/K2 on ``march_kernel``, K1-het and
  K2-lossy on the first design, ``h_kernel`` / ``e_kernel``), timed;
- then, for every pass, ``march_kernel`` at each candidate shape
  (``SHAPES``), checked against the plain versions the same way and timed
  after the built pass: the measurement that decides which core and shape
  each instantiation runs;
- the batched vacuum passes of a sweep (K1-batch, K2-batch:
  ``update_h_batch`` / ``update_e_batch``, ``march_kernel`` with
  ``BATCH``) at ``BATCHES`` (256^3 x 4 and 64^3 x 8 members), each checked
  against its plain version (each member's ``curl`` pass) and the
  per-member passes bit for bit there and on a ragged 35 x 29 x 31 batch of
  8 members (every lead of a 16-byte chunk, edge blocks), timed beside the
  per-member launches; with ``--parent`` the parent's batched pass from
  the same inputs, equal bit for bit and timed in turns; then the built
  shape at other chunk depths (``CHUNKS``) and each shape of
  ``BATCH_SHAPES`` forced whatever the members' width (the wide and the
  narrow built ones, and candidates) at its plan's depth and others,
  checked and timed the same way: the measurements that pick the batch's
  shapes and depths (``stream_plan.MARCH_BATCH_WIDE``, ``MARCH_BATCH_NARROW``,
  ``MARCH_BATCH_TK``).

``--only passes`` times the single passes alone, ``--only batch`` the
batched ones.  One JSON line a kernel and dtype (a batched pass: and
size): ms, the byte bound (inputs read once, outputs written once, psi
read and written once) and its share, registers and spill stores from
ptxas, the parent's ms and the ratio (CPML, batched), each candidate
shape's ms, ratio to the built pass, registers and check, and the card's
name and power limit.
Exits 1 when a check fails or no CUDA device is available.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

from .grid import Box, full_box
from .ops import build, curl, stream_plan, yee
from .ops.cpml import E_TERMS, H_TERMS, PMLConfig
from .params import Mode, Params
from .state import FieldState
from .profile_chunk import scene
from .tune_stream import HBM_BYTES_PER_S, event_ms, load_parent

DEFINE = "YEE_TWOPASS_CANDIDATES"
# the march core's candidate shapes (AH planes ahead, BJ and BI threads along
# j and i, NB blocks an SM, CB bytes a copy), in the order of
# csrc/yee_twopass.cu::march_shape
SHAPES = ((2, 2, 128, 3, 16), (3, 2, 128, 3, 16), (2, 2, 128, 4, 16), (2, 1, 256, 4, 16), (3, 2, 128, 4, 16))
# the shape the library is built at (csrc/yee_twopass.cu::MARCH_*): its ptxas key
BUILT = (stream_plan.MARCH_AHEAD, stream_plan.MARCH_BJ, stream_plan.MARCH_BI, stream_plan.MARCH_BLOCKS_PER_SM, 16)
# the batched passes' shapes forced whatever the width (the single passes', the narrow, the wide, the narrow three
# planes ahead), in the order of csrc/yee_twopass.cu::batch_shape
BATCH_SHAPES = ((2, 2, 128, 4, 16), (2, 4, 64, 4, 16), (3, 2, 128, 4, 16), (3, 4, 64, 4, 16))
# the batched passes' timed sizes: (cells a side, members)
BATCHES = ((256, 4), (64, 8))
CHUNKS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64)  # the batched passes' timed chunk counts a member
# the ragged check batch: 35 x 29 x 31 a member (narrow tiles with edge blocks), an odd size, so 8 members
# take every lead
RAGGED_MEMBERS = 8
PML = PMLConfig(cells=10)  # --pml 10
# (H pass?, materials) of each entry point's name
PASSES = {"yee_update_h": (True, False), "yee_update_h_het": (True, True), "yee_update_e": (False, False),
          "yee_update_e_lossy": (False, True)}
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_KERNEL = re.compile(r"(march|h|e)_kernelI(f|13__nv_bfloat16)((?:Lb[01]E)+)((?:Li\d+E)*)((?:Lb[01]E)*)")


def ptxas_report(log: str) -> dict[tuple, tuple[int, int]]:
    """(kernel, dtype, flags..., ints..., flags...) -> (registers,
    spill-store bytes) of the march_kernel, h_kernel and e_kernel entries of
    an ``nvcc -Xptxas -v`` log (march_kernel: (E, MAT, PML), its shape (AH,
    BJ, BI, NB, CB) and, where the build has it, BATCH)."""
    out: dict[tuple, tuple[int, int]] = {}
    key, spill = None, 0
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m is not None:
            k = _KERNEL.search(m.group(1))
            key = None if k is None else (k.group(1), "float32" if k.group(2) == "f" else "bfloat16",
                                          *(b == "1" for b in re.findall(r"Lb([01])E", k.group(3))),
                                          *(int(v) for v in re.findall(r"Li(\d+)E", k.group(4))),
                                          *(b == "1" for b in re.findall(r"Lb([01])E", k.group(5))))
            spill = 0
        elif key is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif key is not None and "registers" in line:
            out[key] = (int(re.search(r"Used (\d+) registers", line).group(1)), spill)
            key = None
    return out


def march_regs(regs: dict, dtype: str, e: bool, mat: bool, pml: bool, shape: tuple = BUILT,
               batch: bool = False) -> tuple:
    """(registers, spill-store bytes) of a march_kernel instantiation in a
    :func:`ptxas_report` (a build from before BATCH: its key without it),
    (None, None) when the build has none."""
    key = ("march", dtype, e, mat, pml) + tuple(shape)
    return regs.get(key + (batch,), (None, None) if batch else regs.get(key, (None, None)))


def middle_slab(p: Params) -> Box:
    """The second shard's box of ``--shard 4`` with one halo plane (what
    the two-pass runner scatters)."""
    from .parallel import mesh

    return mesh.shard_boxes(p, mesh.make_mesh((4, 1, 1), "cpu"), 1)[1]


@dataclasses.dataclass
class Case:
    """One pass's inputs in a package (this one or the parent's): its
    params, box, state, coefficients, CPML and psi."""

    pkg: object
    p: object
    box: object
    state: object
    coefs: object
    cp: object
    psi: object
    patch: tuple | None

    def run(self, h: bool) -> None:
        yee_ = self.pkg.ops.yee
        box = None if self.box is None else self.box
        if h:
            yee_.update_h(self.p, self.state, self.coefs, self.patch, self.cp, self.psi, box=box)
        else:
            yee_.update_e(self.p, self.state, self.coefs, self.cp, self.psi, box=box)

    def outputs(self) -> list[torch.Tensor]:
        return list(self.state.tensors()) + (list(self.psi.tensors()) if self.psi is not None else [])


def make_case(pkg, p: Params, box: Box | None, name: str, pml: PMLConfig | None, seed: int,
              dev: torch.device, like: Case | None = None) -> Case:
    """The inputs of pass ``name`` in package ``pkg`` (``fdtd_tpu_torch`` or
    a parent checkout's): random fields over the box, random coefficient
    arrays with materials and random psi (parts), drawn on ``dev`` from
    ``seed``, or copies of ``like``'s (another package's case of the same
    pass), so two packages get the same values."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, mat = PASSES[name]
    fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    pp = pkg.params.Params(**{**fields, "mode": pkg.params.Mode(p.mode.value)})
    pbox = None if box is None else pkg.grid.Box(box.lo, box.hi, box.own_lo, box.own_hi)
    shape = box.shape if box is not None else p.padded_shape
    dt = pkg.state.field_dtype(pp)

    def arr(sh, lo, hi):
        return torch.empty(sh, dtype=torch.float32, device=dev).uniform_(lo, hi, generator=gen).to(dt)

    st = (pkg.state.FieldState(*(t.clone() for t in like.state.tensors())) if like is not None else
          pkg.state.FieldState(*(arr(shape, -1.0, 1.0) for _ in range(6))))
    coefs = pkg.state.update_coefs(pp)
    if mat:
        names = ("hf_x", "hf_y", "hf_z") if h else ("ca_x", "ca_y", "ca_z", "cb_x", "cb_y", "cb_z")
        if like is not None:
            vals = {n: getattr(like.coefs, n).clone() for n in names}
        elif h:
            vals = {n: arr(shape, 0.5, 1.0) * coefs.h_factor for n in names}
        else:
            vals = {n: arr(shape, 0.8, 1.0) if n[1] == "a" else arr(shape, 0.5, 1.0) * coefs.cb_x for n in names}
        coefs = dataclasses.replace(coefs, **vals)
    cp = psi = None
    if pml is not None:
        pcfg = pkg.ops.cpml.PMLConfig(cells=pml.cells)
        cp = pkg.ops.cpml.make_cpml(pp, pcfg, coefs, dev, pbox)
        names = pkg.ops.cpml.PsiState.names()
        psi = pkg.ops.cpml.PsiState(**{n: getattr(like.psi, n).clone() if like is not None else
                                       arr(cp.shapes[n], -1e-2, 1e-2) for n in names})
    patch = pkg.source.make_source_plan(pp).patch if h and p.mode == Mode.COMPUTATION else None
    return Case(pkg, pp, pbox, st, coefs, cp, psi, patch)


def maxdiff(a: list[torch.Tensor], b: list[torch.Tensor]) -> float:
    d = max([float((x.float() - y.float()).abs().max()) for x, y in zip(a, b) if x.numel()] + [0.0])
    return float("inf") if d != d else d


def plain(case: Case, h: bool) -> list[torch.Tensor]:
    """The plain version of the case's pass on copies of its inputs."""
    st = case.state.clone()
    psi = case.psi.clone() if case.psi is not None else None
    if case.cp is not None:
        (case.cp.plain_h(case.p, st, case.coefs, psi, case.patch) if h
         else case.cp.plain_e(case.p, st, case.coefs, psi))
    elif h:
        curl.update_h(case.p, st, case.coefs, case.patch, case.box)
    else:
        curl.update_e(case.p, st, case.coefs, case.box)
    return list(st.tensors()) + (list(psi.tensors()) if psi is not None else [])


def march_candidate(case: Case, h: bool, q: int) -> None:
    """The case's pass on the march core at shape ``SHAPES[q]``
    (yee_march_candidate), with CPML when the case has it."""
    p, s, coefs = case.p, case.state, case.coefs
    lib = yee._lib()
    src, dst = ((s.ex, s.ey, s.ez), (s.hx, s.hy, s.hz)) if h else ((s.hx, s.hy, s.hz), (s.ex, s.ey, s.ez))
    mat = ((coefs.hf_x, coefs.hf_y, coefs.hf_z) if h and coefs.heterogeneous_mu else
           (coefs.ca_x, coefs.ca_y, coefs.ca_z, coefs.cb_x, coefs.cb_y, coefs.cb_z) if not h and coefs.lossy else ())
    _ah, bj, bi, nb, _cb = SHAPES[q]
    cfg = case.cp.cfg if case.cp is not None else PMLConfig(cells=1)
    ints = stream_plan.march_geometry(p, cfg, case.box, not h, bj, nb, bi)
    geom = (ctypes.c_int * len(ints))(*ints)
    j0, j1, i0, i1 = case.patch if case.patch is not None else (0, 0, 0, 0)
    f = curl.scalar(coefs.h_factor if h else coefs.cb_x, s.ex.dtype) if not mat else 0.0
    psi = tab = None
    if case.cp is not None:
        psi = yee.pointers(case.psi.tensors(E_TERMS if not h else H_TERMS))
        tab = (case.cp.table_h if h else case.cp.table_e).data_ptr()
    rc = lib.yee_march_candidate(q, 0 if h else 1, yee.pointers(src), yee.pointers(dst),
                                 yee.pointers(mat) if mat else None, psi, tab, cfg.cells, p.maxk, p.maxj, p.maxi,
                                 geom, f, int(case.patch is not None), j0, j1, i0, i1,
                                 {torch.float32: 0, torch.bfloat16: 1}[s.ex.dtype], build.launch_stream(s.ex.device))
    if rc != 0:
        raise RuntimeError(f"yee_march_candidate failed: CUDA error {rc}")


def bound_ms(p: Params, box: Box | None, name: str, pml: bool, item: int, psi_elems: int) -> float:
    """Bytes over the card's rate: the pass's own field (and coefficients)
    over the owned window read and written, the other field over the
    window and the plane it reads past it on a sharded side, psi read and
    written once."""
    h, mat = PASSES[name]
    box = box or full_box(p)
    own = math.prod(hi - lo for lo, hi in zip(box.own_lo, box.own_hi))
    side = "hi" if h else "lo"
    other = math.prod(hi - lo + ((h_ > hi) if side == "hi" else (lo > l0))
                      for l0, h_, lo, hi in zip(box.lo, box.hi, box.own_lo, box.own_hi))
    n_mat = (3 if h else 6) if mat else 0
    return ((3 + n_mat) * own + 3 * other + 3 * own + (2 * psi_elems if pml else 0)) * item / HBM_BYTES_PER_S * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fdtd_tpu_torch.tune_twopass", description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256, help="cells per side of the timed scene (default 256)")
    ap.add_argument("--reps", type=int, default=20, help="timed passes per measurement (default 20)")
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--parent", default=None, help="a checkout of another commit to time in the same call")
    ap.add_argument("--only", choices=("passes", "batch"), default=None,
                    help="time only the single passes or only the batched ones (default: both)")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: tune_twopass measures a CUDA device and none is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0] if smi else torch.cuda.get_device_name(0)
    path = build.build(yee.KERNEL_SOURCE, defines=(DEFINE,))
    regs = ptxas_report(path.with_suffix(".log").read_text())
    yee.use_library(path)
    this = sys.modules[__package__]
    parent = load_parent(Path(args.parent)) if args.parent else None
    parent_regs = {}
    if parent is not None:
        for sub in ("grid", "state", "source", "ops.yee", "ops.cpml"):
            __import__(f"{parent.__name__}.{sub}")
        parent_regs = ptxas_report(parent.ops.build.build(parent.ops.yee.KERNEL_SOURCE)
                                   .with_suffix(".log").read_text())
    sink = open(args.out, "w") if args.out else None
    ok = True

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")

    for dtype in args.dtypes if args.only != "batch" else ():
        small = Params(length=0.0305, width=0.0265, height=0.0345, spatial_step=0.001, time_step=1e-12,
                       simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype=dtype)
        from .parallel import mesh

        small_boxes = [None] + [b for shape in ((4, 1, 1), (2, 3, 1))
                                for b in mesh.shard_boxes(small, mesh.make_mesh(shape, "cpu"), 1)]
        big = scene(args.n, dtype)
        item = 4 if dtype == "float32" else 2
        for name, (h, mat) in PASSES.items():
            for pml in (True, False):
                # the checks on the small box, every shard: the built pass (CPML) and every candidate shape
                err = {q: 0.0 for q in range(len(SHAPES))}
                err["built"] = 0.0
                for q_box, box in enumerate(small_boxes):
                    for q in (["built"] if pml else []) + list(range(len(SHAPES))):
                        case = make_case(this, small, box, name, PML if pml else None, q_box, dev)
                        want = plain(case, h)
                        case.run(h) if q == "built" else march_candidate(case, h, q)
                        torch.cuda.synchronize()
                        err[q] = max(err[q], maxdiff(case.outputs(), want))
                        del case
                ok = ok and all(v == 0.0 for v in err.values())
                for shard in (False, True):
                    box = middle_slab(big) if shard else None
                    kernel = name + ("_pml" if pml else "") + ("_shard" if shard else "")
                    case = make_case(this, big, box, name, PML if pml else None, 7, dev)
                    psi_elems = sum(t.numel() for t in case.psi.tensors()) if pml else 0
                    line = {"kernel": kernel, "dtype": dtype, "n": args.n, "card": card,
                            "check_max_abs_err": err["built"] if pml else None,
                            "bound_ms": bound_ms(big, box, name, pml, item, psi_elems)}
                    if pml:
                        line["core"] = "march_kernel"
                        line["registers"], line["spill_store_bytes"] = march_regs(regs, dtype, not h, mat, True)
                        if parent is not None:
                            other = make_case(parent, big, box, name, PML, 7, dev, like=case)
                            case.run(h)
                            other.run(h)
                            torch.cuda.synchronize()
                            line["equal_parent_max_abs_err"] = maxdiff(case.outputs(), other.outputs())
                            ok = ok and line["equal_parent_max_abs_err"] == 0.0
                            first = event_ms(lambda: other.run(h), args.reps)
                            ms = (event_ms(lambda: case.run(h), args.reps)
                                  + event_ms(lambda: case.run(h), args.reps)) / 2
                            pms = (first + event_ms(lambda: other.run(h), args.reps)) / 2
                            # the parent's pass on the march core, or on the first design (h_kernel / e_kernel
                            # <T, HET or LOSSY, PML, BOX, BATCH>)
                            pr = march_regs(parent_regs, dtype, not h, mat, True)
                            if pr == (None, None):
                                pr = parent_regs.get(("h" if h else "e", dtype, mat, True, shard, False), pr)
                            line["parent"] = {"ms": pms, "registers": pr[0], "spill_store_bytes": pr[1],
                                              "bound_share": line["bound_ms"] / pms}
                            line["speedup"] = pms / ms
                            del other
                        else:
                            ms = event_ms(lambda: case.run(h), args.reps)
                    else:  # vacuum: the march core as built; het-mu H and lossy E: the first design
                        line["core"] = "h_kernel" if h else "e_kernel" if mat else "march_kernel"
                        line["registers"], line["spill_store_bytes"] = (
                            regs.get(("h" if h else "e", dtype, mat, shard), (None, None)) if mat else
                            march_regs(regs, dtype, not h, False, False))
                        ms = event_ms(lambda: case.run(h), args.reps)
                    line["ms"] = ms
                    line["bound_share"] = line["bound_ms"] / ms
                    shapes = {}
                    for q, (ah, bj, bi, nb, cb) in enumerate(SHAPES):
                        mq = event_ms(lambda: march_candidate(case, h, q), args.reps)
                        rq = march_regs(regs, dtype, not h, mat, pml, (ah, bj, bi, nb, cb))
                        shapes[f"{ah},{bj},{bi},{nb},{cb}"] = {"ms": mq, "bound_share": line["bound_ms"] / mq,
                                                     "vs": ms / mq, "registers": rq[0], "spill_store_bytes": rq[1],
                                                     "check_max_abs_err": err[q]}
                    if not pml:  # the built pass once more, after the candidates
                        line["ms"] = (ms + event_ms(lambda: case.run(h), args.reps)) / 2
                        line["bound_share"] = line["bound_ms"] / line["ms"]
                    line["march_shapes"] = shapes
                    emit(line)
                    del case
                    torch.cuda.empty_cache()
    if args.only != "passes":
        for dtype in args.dtypes:
            for line in batched_lines(dtype, args.reps, dev, card, regs, parent, parent_regs):
                ok = ok and line.pop("ok")
                emit(line)
    if sink:
        sink.close()
    return 0 if ok else 1


@dataclasses.dataclass
class Batch:
    """A batch's inputs in a package (this one or the parent's): its params,
    the (N, K+1, J+1, I+1) fields, the vacuum coefficients and the source
    patch."""

    pkg: object
    p: object
    states: object
    coefs: object
    patch: tuple | None

    def run(self, h: bool) -> None:
        yee_ = self.pkg.ops.yee
        if h:
            yee_.update_h_batch(self.p, self.states, self.coefs, self.patch)
        else:
            yee_.update_e_batch(self.p, self.states, self.coefs)

    def member(self, b: int):
        return self.pkg.state.FieldState(*(t[b] for t in self.states.tensors()))


def make_batch(pkg, p: Params, members: int, seed: int, dev: torch.device, like: Batch | None = None) -> Batch:
    """A batch of ``members`` random members of ``p``'s grid in package
    ``pkg``, drawn on ``dev`` from ``seed``, or copies of ``like``'s."""
    fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    pp = pkg.params.Params(**{**fields, "mode": pkg.params.Mode(p.mode.value)})
    if like is not None:
        st = pkg.state.FieldState(*(t.clone() for t in like.states.tensors()))
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        st = pkg.state.FieldState(*(torch.empty((members,) + p.padded_shape, device=dev).uniform_(
            -1.0, 1.0, generator=gen).to(pkg.state.field_dtype(pp)) for _ in range(6)))
    patch = pkg.source.make_source_plan(pp).patch if p.mode == Mode.COMPUTATION else None
    return Batch(pkg, pp, st, pkg.state.update_coefs(pp), patch)


def batch_candidate(bt: Batch, h: bool, q: int, tk: int | None = None) -> None:
    """The batch's pass on the batched march core at shape
    ``BATCH_SHAPES[q]`` (yee_march_batch_candidate), at the plan's chunk
    depth or ``tk``."""
    p, s = bt.p, bt.states
    src, dst = ((s.ex, s.ey, s.ez), (s.hx, s.hy, s.hz)) if h else ((s.hx, s.hy, s.hz), (s.ex, s.ey, s.ez))
    _ah, bj, bi, nb, _cb = BATCH_SHAPES[q]
    n = s.ex.shape[0]
    ints = stream_plan.march_geometry(p, None, None, not h, bj, nb, bi, members=n, tk=tk)
    geom = (ctypes.c_int * len(ints))(*ints)
    j0, j1, i0, i1 = bt.patch if bt.patch is not None and h else (0, 0, 0, 0)
    f = curl.scalar(bt.coefs.h_factor if h else bt.coefs.cb_x, s.ex.dtype)
    rc = yee._lib().yee_march_batch_candidate(
        q, 0 if h else 1, yee.pointers(tuple(t[0] for t in src)), yee.pointers(tuple(t[0] for t in dst)), n,
        p.maxk, p.maxj, p.maxi, geom, f, int(h and bt.patch is not None), j0, j1, i0, i1,
        {torch.float32: 0, torch.bfloat16: 1}[s.ex.dtype], build.launch_stream(s.ex.device))
    if rc != 0:
        raise RuntimeError(f"yee_march_batch_candidate failed: CUDA error {rc}")


def batch_errors(bt: Batch, h: bool, run) -> float:
    """max |diff| of ``run()`` (the batch's pass, some way) against the
    plain pass of each member and against the per-member march passes, from
    the batch's inputs (which it leaves as they were)."""
    init = bt.states.clone()
    plain, each = bt.states.clone(), bt.states.clone()
    for b in range(init.ex.shape[0]):
        pl, ke = (FieldState(*(t[b] for t in x.tensors())) for x in (plain, each))
        if h:
            curl.update_h(bt.p, pl, bt.coefs, bt.patch)
            yee.update_h(bt.p, ke, bt.coefs, bt.patch)
        else:
            curl.update_e(bt.p, pl, bt.coefs)
            yee.update_e(bt.p, ke, bt.coefs)
    run()
    torch.cuda.synchronize()
    err = max(maxdiff(list(bt.states.tensors()), list(plain.tensors())),
              maxdiff(list(bt.states.tensors()), list(each.tensors())))
    for dst, src in zip(bt.states.tensors(), init.tensors()):
        dst.copy_(src)
    return err


def batched_lines(dtype: str, reps: int, dev: torch.device, card: str, regs: dict, parent, parent_regs: dict):
    """The batched passes' lines (one a pass and size, with "ok": every
    check equal): the built pass and every candidate shape checked on the
    ragged batch and at the size, timed beside the per-member launches and,
    with ``parent``, beside the parent's batched pass in turns."""
    this = sys.modules[__package__]
    item = 4 if dtype == "float32" else 2
    ragged = make_batch(this, Params(length=0.0305, width=0.0285, height=0.0345, spatial_step=0.001,
                                     time_step=1e-12, simulation_time=1e-11, sampling_rate=5,
                                     mode=Mode.COMPUTATION, dtype=dtype), RAGGED_MEMBERS, 3, dev)
    for n, members in BATCHES:
        big = make_batch(this, scene(n, dtype), members, 11, dev)
        for h in (True, False):
            name = "yee_update_h_batch" if h else "yee_update_e_batch"
            err = {q: max(batch_errors(bt, h, lambda: batch_candidate(bt, h, q)) for bt in (ragged, big))
                   for q in range(len(BATCH_SHAPES))}
            err["built"] = max(batch_errors(bt, h, lambda: bt.run(h)) for bt in (ragged, big))
            plan = stream_plan.march_plan(big.p, None, not h, members=members)
            planes = plan.window[0][1] - plan.window[0][0]
            shape = (plan.ahead, plan.bj, plan.bi, plan.blocks_per_sm, 16)
            built = BATCH_SHAPES.index(shape)  # the built shape's instantiation in the candidates' build
            reg = march_regs(regs, dtype, not h, False, False, shape, batch=True)
            line = {"kernel": name, "dtype": dtype, "n": n, "members": members, "card": card, "core": "march_kernel",
                    "check_max_abs_err": err["built"],
                    "bound_ms": members * bound_ms(big.p, None, "yee_update_e" if not h else "yee_update_h", False,
                                                   item, 0),
                    "registers": reg[0], "spill_store_bytes": reg[1],
                    "grid": {"shape": shape, "blocks": plan.blocks, "member_blocks": plan.member_blocks,
                             "tk": plan.tk, "waves": plan.waves}}
            ok = all(v == 0.0 for v in err.values())
            views = [big.member(b) for b in range(members)]
            if h:
                each = lambda: [yee.update_h(big.p, v, big.coefs, big.patch) for v in views]  # noqa: E731
            else:
                each = lambda: [yee.update_e(big.p, v, big.coefs) for v in views]  # noqa: E731
            if parent is not None:
                other = make_batch(parent, big.p, members, 0, dev, like=big)
                big.run(h)
                other.run(h)
                torch.cuda.synchronize()
                line["equal_parent_max_abs_err"] = maxdiff(list(big.states.tensors()), list(other.states.tensors()))
                ok = ok and line["equal_parent_max_abs_err"] == 0.0
                first = event_ms(lambda: other.run(h), reps)
                ms = (event_ms(lambda: big.run(h), reps) + event_ms(lambda: big.run(h), reps)) / 2
                pms = (first + event_ms(lambda: other.run(h), reps)) / 2
                pr = parent_regs.get(("h" if h else "e", dtype, False, False, True),
                                     march_regs(parent_regs, dtype, not h, False, False, batch=True))
                line["parent"] = {"ms": pms, "registers": pr[0], "spill_store_bytes": pr[1],
                                  "bound_share": line["bound_ms"] / pms}
                line["speedup"] = pms / ms
                del other
            else:
                ms = event_ms(lambda: big.run(h), reps)
            line["per_member_ms"] = event_ms(each, reps)
            shapes = {}
            for q, (ah, bj, bi, nb, cb) in enumerate(BATCH_SHAPES):
                mq = event_ms(lambda: batch_candidate(big, h, q), reps)
                rq = march_regs(regs, dtype, not h, False, False, (ah, bj, bi, nb, cb), batch=True)
                qplan = stream_plan.march_plan(big.p, None, not h, bj, nb, bi, members)
                at = {}
                for tk in (tk for tk in (32, 16, 11, 8, 6, 4) if tk < planes):
                    err_tk = batch_errors(big, h, lambda: batch_candidate(big, h, q, tk))
                    ok = ok and err_tk == 0.0
                    at[str(tk)] = event_ms(lambda: batch_candidate(big, h, q, tk), reps)
                shapes[f"{ah},{bj},{bi},{nb},{cb}"] = {"ms": mq, "bound_share": line["bound_ms"] / mq, "vs": ms / mq,
                                                     "registers": rq[0], "spill_store_bytes": rq[1],
                                                     "tk": qplan.tk, "blocks": qplan.blocks,
                                                     "check_max_abs_err": err[q], "tk_depths": at}
            # the built shape at other chunk depths (1 to 64 chunks a member)
            depths = {}
            for tk in sorted({-(-planes // c) for c in CHUNKS if c <= planes}, reverse=True):
                err_tk = batch_errors(big, h, lambda: batch_candidate(big, h, built, tk))
                ok = ok and err_tk == 0.0
                mt = event_ms(lambda: batch_candidate(big, h, built, tk), reps)
                depths[str(tk)] = {"ms": mt, "vs": ms / mt, "chunks": -(-planes // tk), "check_max_abs_err": err_tk}
            line["tk_depths"] = depths
            line["ms"] = (ms + event_ms(lambda: big.run(h), reps)) / 2  # the built pass once more, after them
            line["bound_share"] = line["bound_ms"] / line["ms"]
            line["batch_shapes"] = shapes
            line["ok"] = ok
            yield line
        del big
        torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main())
