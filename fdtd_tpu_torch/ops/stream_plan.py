"""Plans of the streaming sweep kernel (``csrc/yee_stream.cu``).

The counterpart of ``pick_plan`` / ``stream_vmem_estimate`` / ``pick_s`` /
``supported`` in ``fdtd_tpu/ops/pallas_stream.py`` (``pick_s`` is
``pick_plan(p).s``), sized for Hopper instead of a TPU's VMEM.

One launch advances the state by ``s`` leapfrog steps.  A block owns a
(j, i) column tile and marches a segment of k planes through a skewed
pipeline: at pipeline step r, level m (the state after m steps) updates
plane r - m.  Each thread keeps one (j, i) column's levels in registers
(6 values per level, fp32), and a block shares one (j, i) plane of E and
one of H in shared memory for the neighbour reads.  The TPU kernel keeps
whole (j, i) planes in VMEM; a 257^2 fp32 plane alone exceeds a block's
227 KB of shared memory, so here the tile carries a recompute halo of s
columns per side: a level's validity shrinks by one column per side, and
the block emits only the interior ``bj - 2s`` x ``bi - 2s`` columns.  The
k segments of one column tile start s planes early (a lead-in that is
recomputed, not emitted), so the segments are independent blocks.

Every variant runs ``ring_kernel``, the Hopper design of the sweep (the
header of ``csrc/yee_stream.cu``), or its CPML form: the next plane's fields and,
with ``cr``, the coefficients of the last s + 1 planes ride a ring in
shared memory (:attr:`StreamPlan.ring_words`), so a plan's shared memory
(:attr:`StreamPlan.smem_bytes`) counts the ring beside the exchange
buffers.  Its grid is k segments of every tile, block b walking segment
b // tiles of tile b % tiles (:func:`segments`): the blocks of a wave walk
neighbouring tiles' planes together, so the halo columns they share come
from L2 (an equal-share walk of the (tile, plane) list, which put
neighbouring tiles at different planes, measured 1.5-2.2x slower).  The
segment depth is the one whose waves take the fewest pipeline steps an SM
(:func:`pick_tk`): a last wave half full costs a whole wave.

Plans are ranked by modelled device-memory bytes per cell and step: each
sweep reads the six fields (and the coefficient arrays of the material
variants) once per halo-amplified tile and writes the fields once.  The
sweep writes into a second state (blocks run concurrently, so in place
would race a neighbour's halo reads); a plan whose two states, with the
coefficient arrays, sigma, the SAR accumulator and the SAR increment's
temporaries, do not fit in device memory is refused.  The ``twopass``
footprint (one state) is modelled here too (:func:`twopass_bytes`).

The material variants mirror the gates of ``pallas_stream.pick_plan``:
lossy or heterogeneous-mu_r media stream only in computation mode, and
SAR needs lossy media.  They keep more per thread (coefficient loads, the
SAR registers), so they have block shapes of their own
(``BLOCK_J_MATERIAL``), and a SAR tile emits one column fewer per axis
(the cell mean reads E one column past the tile).

The CPML variants (``pml``: vacuum or lossy) are two launches a sweep
(:func:`pml_blocks`): the interior window, whose blocks' recompute
regions hold no psi, on ``ring_kernel``'s box instantiation of the
variant without CPML (``StreamPlan.core``), and the shell around it on
``pml_kernel``, the ring core with the twelve psi terms, from a block list
(``StreamPlan.pml_blocks``).  ``pml_kernel`` keeps more per thread, so its
blocks are smaller and it is built at s=2 alone (``BLOCK_J_PML``,
``BLOCK_J_PML_DFT``), and the variants mirror the gates of
``fdtd_tpu/ops/pallas_stream_pml.py::stream_pml_supported``: computation
mode, homogeneous mu_r, no SAR, and the source patch clear of the j and i
slabs.  A sweep reads one psi set and writes a second (a neighbour's halo
reads level-0 psi of cells this block writes), so a plan counts two.

The ADE variants (Debye media, ``ade``: vacuum H, with or without SAR)
carry each level's polarization (and with SAR its edge work) in registers
beside the fields and read the 15 coefficient maps per level and plane, so
they have block shapes of their own (``BLOCK_J_ADE``, ``BLOCK_J_ADE_SAR``),
each at the one shape that measured fastest (``python -m
fdtd_tpu_torch.tune_stream``): the bytes model ranks deeper sweeps first,
but registers bind them and they run slower.  Their gates are the material
variants' (computation mode) plus no CPML (Debye x CPML runs the torch
ops) and no heterogeneous mu_r.  A sweep reads one P set and writes a
second, like the state.

The DFT variants (``dft``: the phasor sums of fields "e" ride the sweep)
exist for every variant above.  They form each level's E cell means as the
SAR variants do, so their tiles emit one column fewer per axis and the
pipeline runs one step further; a thread keeps the 6 * nf sums of the s
cells it has in flight in dynamic shared memory (loaded at level 1, stored
at level s), so ``nf`` is a runtime value that needs no registers, up to
what fits beside the exchange buffers and the ring
(:attr:`StreamPlan.dft_max_nf`).  A scene with more frequencies than
every built depth's bands hold takes the means mode at the same shape
(``StreamPlan.fold``: the buffer's depth D; ``FOLD`` instantiations of
their own, so the bands keep their machine code; the lossy CPML sweep's
shell and interior also carry the coefficient ring, which the bands have
no room for): each level
stores its three E cell means, fp32, into a (D, 3, cells) buffer in
device memory, and ``csrc/dft_accum.cu``'s fold kernel adds the buffered
levels to the sums, in step order, whenever the buffer is full and at
every chunk end (:func:`fold_depth`: D as deep as memory allows, up to
``FOLD_DEPTH``).  Each is built at one depth: the vacuum variant at
``BLOCK_J_DFT`` (a shard also at the CPML interior's s = 2 shape,
:func:`built_depths`), the material variants at
``BLOCK_J_DFT_MATERIAL`` (with the coefficient ring), the ADE variants at
the ADE SAR shape and the CPML variants at ``BLOCK_J_PML_DFT`` (their
interior at ``BLOCK_J_PML_INTERIOR_DFT``).  The sums (8 * nf * nc B a cell)
count in every footprint, and the means buffer (12 * D B a cell) in the
means mode's; a DFT sweep reads and writes the sums once, a means-mode
sweep writes 12 B a cell and level, read once by the fold, and each fold
reads and writes the sums once.

Every footprint counts the temporaries of the output reductions (the k
slabs of the energies and snapshot aggregation) or of the SAR increment,
whichever is larger: they never run at the same time.  With Debye SAR the
increment also needs the three fp32 edge work arrays of the E pass.

The two-pass vacuum and CPML passes (``csrc/yee_twopass.cu::march_kernel``)
have launch plans of their own here too (:func:`march_plan`): tiles of
``MARCH_BJ`` x ``MARCH_BI`` columns, the last row and column to edge blocks
where the window is one past whole tiles, and the chunk of planes a block
marches (:func:`pick_march_tk`); :func:`march_counts` mirrors how the
kernel maps threads to cells, so a CPU test can hold each launch to every
owned cell once.

A shard of a sharded run (:mod:`fdtd_tpu_torch.parallel`) sweeps its owned
window: :func:`plan_for` with ``window``, the vacuum and material variants
with or without the DFT bands (``SHARD_VARIANTS``).  :func:`shard_bytes`
sums the shards' arrays per device (one or two states with their halos,
their coefficient parts, SAR map parts, psi parts, P and the Debye maps and
work arrays, their parts of the DFT sums) and the canonical grid the run
gathers into for its outputs.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import math

import numpy as np

from .. import diagnostics
from ..dft import DftConfig, acc_bytes
from ..grid import Box, full_box
from ..params import Mode, Params
from ..source import make_source_plan
from .cpml import E_TERMS, H_TERMS, TERM_NAMES, PMLConfig, psi_boxes, psi_bytes, psi_part_geometry

STEPS = (8, 4, 2)  # steps per sweep, deepest first
SM_COUNT = 132  # H100 SXM
SMEM_PER_BLOCK = 227 * 1024  # opt-in shared memory of one block
DEVICE_BYTES = 80 * 10**9  # H100 80 GB, the default when no free size is given
MEMORY_MARGIN = 0.9  # share of device memory a sweep's (or twopass's) arrays may take
BLOCK_I = 32  # threads along i: one warp, consecutive addresses
# threads along j per steps-per-sweep; must match the instantiations in
# csrc/yee_stream.cu (s=8 keeps 6*9 fp32 level values a thread, so its
# block is smaller to leave each thread more registers)
BLOCK_J = {8: 24, 4: 32, 2: 32}
# the same for the material variants (lossy, het-mu, SAR): at s=4 a
# 768-thread block leaves 80 registers a thread instead of 64
BLOCK_J_MATERIAL = {8: 24, 4: 24, 2: 32}
# the material depths whose coefficients (ca/cb, hf, with SAR sigma and the
# map value) ride the ring in shared memory: s=8 reads them from memory at
# every level (its s+1 ring planes would not fit); the Debye sweeps and the
# material DFT sweeps carry theirs in the ring too (plan_for: cr), the
# vacuum sweeps have none
COEF_RING_MATERIAL = {8: False, 4: True, 2: True}
# the CPML variants (vacuum and lossy) run pml_kernel, the ring core with
# the twelve psi terms (level 0's psi of the next plane in the ring, levels
# 1..s-1 in registers), on the blocks of the CPML shell; the interior, whose
# recompute region holds no psi, runs the K3 sweep (ring_kernel with a box)
# at the same depth.  Built shapes: threads along j per depth without and
# with the DFT bands (the bands at 640 threads keep nf <= 5 beside the psi
# ring), the lossy ca/cb on the coefficient ring without the bands
BLOCK_J_PML = {2: 24}
BLOCK_J_PML_DFT = {2: 20}
# the interior of a CPML sweep with the DFT bands: ring_kernel's box
# instantiation at s = 2, 768 threads, coefficients from memory (nf <= 5)
BLOCK_J_PML_INTERIOR_DFT = {2: 24}
# the ADE variants (Debye media) keep three P (and with SAR three work
# values) a level a thread more and read 15 maps a level (18 with SAR), all
# from the coefficient ring; each is built at the one shape that measured
# fastest at 256^3 (python -m fdtd_tpu_torch.tune_stream; NVIDIA H100 80GB
# HBM3, 700 W), the Debye DFT variants at the SAR shape, whose 512-thread
# block leaves the DFT sums room for nf <= 3 beside the ring
BLOCK_J_ADE = {2: 24}
BLOCK_J_ADE_SAR = {2: 16}
# the DFT variants of the vacuum sweep (s=4 with 768 threads: nf <= 2 in
# shared memory beside the ring) and of the material sweeps (s=2 with 768
# threads and the coefficient ring: nf <= 2 or 3 beside it)
BLOCK_J_DFT = {4: 24}
BLOCK_J_DFT_MATERIAL = {2: 24}
# a shard's vacuum sweep with the DFT bands also runs at s = 2 on the box
# instantiation of the CPML interior (BLOCK_J_PML_INTERIOR_DFT), but only
# where the shards refuse s = 4: a shard owning 3 or 4 planes has too few
# for the s = 4 sweep's 5-plane halo (pick_shard_plan)
BLOCK_J_DFT_SHARD = {4: 24, 2: 24}
# the means mode (StreamPlan.fold) keeps no sums in shared memory but runs
# at the bands' shapes all the same: at 256^3 the wider ones (32 threads
# along j; Debye 24) ran 1.06-1.43x slower a sweep in fp32 (python -m
# fdtd_tpu_torch.tune_stream; NVIDIA H100 80GB HBM3, 700 W; PERF.md)
# the means mode's buffer depth at most (levels): the fold kernel keeps a
# cell's buffered means in registers (csrc/dft_accum.cu::FOLD_MAX)
FOLD_DEPTH = 32


def variant_name(lossy: bool, het: bool, sar: bool, pml: bool = False, ade: bool = False,
                 dft: bool = False, means: bool = False) -> str:
    """The name of a kernel variant of csrc/yee_stream.cu (its launch
    counter): ``yee_stream`` in vacuum, else ``yee_stream_lossy`` with
    ``_het`` and ``_sar`` as they apply; ``_pml`` for the CPML variants;
    ``yee_stream_ade`` (``_sar``) for Debye media; ``_dft`` last for the
    variants with the DFT bands, ``_dft_means`` for their means mode."""
    suffix = ("_dft_means" if means else "_dft") if dft else ""
    if ade:
        return "yee_stream_ade" + ("_sar" if sar else "") + suffix
    base = "yee_stream" if not lossy else "yee_stream_lossy" + ("_het" if het else "") + ("_sar" if sar else "")
    return base + ("_pml" if pml else "") + suffix


# every variant the sweep is built for: (lossy, het, sar, pml, ade), each
# with and without the DFT bands
VARIANTS = tuple((lossy, het, sar, pml, ade, dft) for dft in (False, True)
                 for lossy, het, sar, pml, ade in (
                     (False, False, False, False, False), (True, False, False, False, False),
                     (True, False, True, False, False), (True, True, False, False, False),
                     (True, True, True, False, False), (False, False, False, True, False),
                     (True, False, False, True, False), (False, False, False, False, True),
                     (False, False, True, False, True)))
# the variants a shard sweeps: vacuum and the material variants, each with
# and without the DFT bands (the JAX package has no sharded CPML or Debye
# sweep: those shard scenes run the two-pass kernels and torch ops)
SHARD_VARIANTS = tuple(v for v in VARIANTS if not (v[3] or v[4]))


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """One sweep's geometry: ``s`` steps; blocks of ``bj`` x ``bi``
    threads, each emitting a ``tk`` x ``tj`` x ``ti`` (k, j, i) tile;
    ``nk`` x ``nj`` x ``ni`` blocks (:func:`segments`; CPML: the whole grid's
    tiling at that depth, the launch runs ``pml_blocks``); ``cr``, the
    coefficients ride the ring."""

    s: int
    tk: int
    tj: int
    ti: int
    bj: int
    bi: int
    nk: int
    nj: int
    ni: int
    bytes_per_cell_step: float  # modelled device-memory traffic
    lossy: bool = False  # ca/cb arrays (any non-vacuum scene)
    het: bool = False  # hf arrays (heterogeneous mu_r)
    sar: bool = False  # the SAR accumulator
    pml: bool = False  # the twelve CPML psi terms
    ade: bool = False  # Debye media: P and the 15 ADE maps
    dft: bool = False  # the DFT bands (E phasor sums)
    window: tuple[int, int, int] | None = None  # a shard's owned planes (k, j, i); None: the grid
    cr: bool = False  # the coefficients ride the ring
    origin: tuple[int, int, int] | None = None  # the window's first planes where they are not the arrays' first
    pml_cells: int = 0  # CPML: the slab depth
    pml_blocks: tuple = ()  # CPML: pml_kernel's block list (pml_blocks)
    core: "StreamPlan | None" = None  # CPML: the interior's ring_kernel plan (window and origin), if any
    fold: int = 0  # DFT: the means mode's buffer depth in levels (0: the bands in shared memory)
    # CPML: pml_blocks copied to each device it ran on (ops/stream.py), kept with the plan
    device_blocks: dict = dataclasses.field(default_factory=dict, init=False, compare=False, repr=False)

    @property
    def kernel(self) -> str:
        """The kernel variant, as ``ops.stream.launches`` counts it."""
        return variant_name(self.lossy, self.het, self.sar, self.pml, self.ade, self.dft, self.fold > 0)

    @property
    def blocks(self) -> int:
        """The blocks of the launch (CPML: of pml_kernel's, the shell's)."""
        return len(self.pml_blocks) if self.pml else self.nk * self.nj * self.ni

    @property
    def waves(self) -> float:
        """Blocks over what the card holds at once (one on each SM)."""
        return self.blocks / SM_COUNT

    @property
    def threads(self) -> int:
        return self.bj * self.bi

    @property
    def means(self) -> bool:
        """The cell means of SAR or the DFT bands (tiles one column
        narrower, one more E plane and a third exchange)."""
        return self.sar or self.dft

    @property
    def ring_words(self) -> int:
        """The ring, 4-byte words a thread: the next plane's six fields (and
        three P), and with ``cr`` the coefficient words of the last s + 1
        planes (lossy ca/cb, het hf, SAR sigma and map value; the Debye maps
        and map value); CPML: the fields, level 0's twelve psi of the next
        plane and with ``cr`` the ca/cb of s + 1 planes."""
        if self.pml:
            return 6 + 12 + ((self.s + 1) * 6 if self.cr else 0)
        nc = 0
        if self.cr and self.ade:
            nc = 19 if self.sar else 15
        elif self.cr and self.lossy:
            nc = 6 + (3 if self.het else 0) + (2 if self.sar else 0)
        return (9 if self.ade else 6) + (self.s + 1) * nc

    @property
    def smem_bytes(self) -> int:
        """Shared memory before the DFT sums: the Ex, Ez and Hx, Hz planes
        of the j exchanges (i neighbours move by warp shuffles), the three
        values a column of the cell means, and the ring; CPML: and the
        (b, c) tables of the twelve terms in fp32."""
        n = self.bj * self.bi
        tables = 24 * 2 * self.pml_cells * 4 if self.pml else 0
        return (4 * n + (3 * n if self.means else self.bi)) * 4 + self.ring_words * n * 4 + tables

    def dft_smem_bytes(self, nf: int) -> int:
        """Dynamic shared memory of the DFT bands: 6 * nf fp32 sums of s
        cells a thread (none in the means mode)."""
        return self.s * 6 * nf * self.bj * self.bi * 4 if self.dft and not self.fold else 0

    @property
    def dft_max_nf(self) -> int:
        """The most frequencies the DFT bands take at this shape (0 without
        them, and in the means mode, ``fold``, which keeps no sums in shared
        memory and takes any number): what fits in a block's shared memory
        beside the static buffers and the ring (CPML: in both launches)."""
        if not self.dft or self.fold:
            return 0
        own = (SMEM_PER_BLOCK - self.smem_bytes) // (self.s * 6 * self.bj * self.bi * 4)
        return min(own, self.core.dft_max_nf) if self.core is not None else own


def segments(nj: int, ni: int, planes: int, tk: int) -> list[tuple[int, int, int]]:
    """The segments of a sweep's grid, as csrc/yee_stream.cu walks them:
    block b advances the tk planes of segment b // tiles of tile b % tiles
    (tiles in (j, i) order with i fastest), so the blocks of a wave walk
    neighbouring tiles' planes together.  (tile, k0, k1), k relative to the
    first plane of the grid (or window)."""
    tiles = nj * ni
    return [(b % tiles, (b // tiles) * tk, min((b // tiles + 1) * tk, planes)) for b in range(-(-planes // tk) * tiles)]


def pick_tk(planes: int, tiles: int, s: int, sh: int) -> int:
    """The segment depth of a ring_kernel grid: of the splits of
    ``planes`` into equal segments at least 2s deep, the one whose waves
    (one block on each of the 132 SMs) take the fewest pipeline steps an
    SM, each segment's lead-in and tail (2s + sh) counted; ties to the
    deeper segment.  Whole waves come first: a last wave half full costs a
    whole wave's time."""
    def steps(tk: int) -> int:
        return -(-(-(-planes // tk) * tiles) // SM_COUNT) * (tk + 2 * s + sh)

    return min((-(-planes // nk) for nk in range(1, max(1, planes // (2 * s)) + 1)), key=lambda tk: (steps(tk), -tk))


def _itemsize(p: Params) -> int:
    return {"float32": 4, "bfloat16": 2, "float64": 8}[p.dtype]


def state_bytes(p: Params) -> int:
    return 6 * math.prod(p.padded_shape) * _itemsize(p)


def pol_bytes(p: Params) -> int:
    """Device bytes of one polarization set (three arrays of the padded
    shape in the field dtype)."""
    return 3 * math.prod(p.padded_shape) * _itemsize(p)


def material_bytes(p: Params, lossy: bool = False, het: bool = False, sar: bool = False,
                   ade: bool = False) -> int:
    """Device bytes beside the state: six ca/cb and three hf arrays of the
    padded shape, sigma (maxk, maxj, maxi) in the field dtype and the fp32
    SAR accumulator; for Debye media (``ade``) the 15 ADE maps and, with
    SAR, three edge sigma maps of the padded shape and the accumulator."""
    arr = math.prod(p.padded_shape) * _itemsize(p)
    cells = p.maxk * p.maxj * p.maxi
    if ade:
        return (15 + (3 if sar else 0)) * arr + (4 * cells if sar else 0)
    return ((6 * arr + cells * _itemsize(p) if lossy else 0) + (3 * arr if het else 0)
            + (4 * cells if sar else 0))


def sar_work_bytes(p: Params, ade: bool = False) -> int:
    """Device bytes of the temporaries of the per-step SAR increment
    (``diagnostics.accumulate_power`` / ``accumulate_work``, one slab of k
    planes at a time); Debye media add the three fp32 edge work arrays the
    E pass writes."""
    slab = diagnostics.SAR_SLAB_TEMPS * 4 * diagnostics.sar_slab_planes(p) * p.maxj * p.maxi
    return slab + (3 * 4 * math.prod(p.padded_shape) if ade else 0)


def output_work_bytes(p: Params) -> int:
    """Device bytes of the temporaries of the energy log and the snapshot
    aggregation (``diagnostics.output_slabs``: at most 8 fp32 values a
    cell of one k slab)."""
    return diagnostics.SAR_SLAB_TEMPS * 4 * diagnostics.output_slab_planes(p) * p.maxj * p.maxi


def dft_work_bytes(p: Params, dft: DftConfig | None) -> int:
    """Device bytes of the temporaries of one step's H sums (fields "eh":
    torch ops over the whole grid: the three cell means, their stack and
    the nf products); the E sums (the kernel, or the sweep's bands)
    allocate nothing."""
    if dft is None or dft.fields != "eh":
        return 0
    return (7 + 3 * dft.nf) * 4 * p.maxk * p.maxj * p.maxi


def work_bytes(p: Params, sar: bool = False, ade: bool = False, dft: DftConfig | None = None) -> int:
    """The larger of the output, the SAR and the DFT temporaries (never
    live at the same time; the Debye work arrays stay allocated, so they
    add)."""
    if sar and ade:
        return sar_work_bytes(p, ade=True) + max(output_work_bytes(p) - sar_work_bytes(p), dft_work_bytes(p, dft), 0)
    return max(output_work_bytes(p), sar_work_bytes(p) if sar else 0, dft_work_bytes(p, dft))


def twopass_bytes(p: Params, lossy: bool = False, het: bool = False, sar: bool = False,
                  pml: PMLConfig | None = None, ade: bool = False, dft: DftConfig | None = None) -> int:
    """Device bytes of a ``twopass`` run: the state (updated in place), the
    material arrays, one psi set with CPML, the DFT sums, and the
    temporaries of the SAR increment, of the H sums or of the snapshots
    and energy log; with Debye media (``ade``) P, the 15 maps, sigma and
    the three fp32 work arrays."""
    lossy = lossy or het
    return (state_bytes(p) + (pol_bytes(p) if ade else 0) + material_bytes(p, lossy, het, sar, ade)
            + (psi_bytes(p, pml) if pml else 0) + (acc_bytes(p, dft) if dft else 0) + work_bytes(p, sar, ade, dft))


def twopass_fits(p: Params, memory_bytes: int | None = None, lossy: bool = False,
                 het: bool = False, sar: bool = False, pml: PMLConfig | None = None,
                 ade: bool = False, dft: DftConfig | None = None) -> bool:
    """:func:`twopass_bytes` fits in ``memory_bytes`` (default: the
    H100's 80 GB) with the margin the stream plans keep."""
    mem = DEVICE_BYTES if memory_bytes is None else memory_bytes
    return twopass_bytes(p, lossy, het, sar, pml, ade, dft) <= MEMORY_MARGIN * mem


def _block_j(lossy: bool, pml: bool, ade: bool = False, sar: bool = False, dft: bool = False,
             shard: bool = False) -> dict[int, int]:
    """The depths a variant's kernel is built at, with their threads
    along j (``shard``: a shard's box sweep)."""
    if ade:
        return BLOCK_J_ADE_SAR if sar or dft else BLOCK_J_ADE
    if pml:
        return BLOCK_J_PML_DFT if dft else BLOCK_J_PML
    if dft:
        return BLOCK_J_DFT_MATERIAL if lossy else BLOCK_J_DFT_SHARD if shard else BLOCK_J_DFT
    return BLOCK_J_MATERIAL if lossy else BLOCK_J


def built_depths(lossy: bool, dft: bool = False, shard: bool = False) -> tuple[int, ...]:
    """The steps per sweep the vacuum (or, ``lossy``, the material) sweep
    is built at, deepest first (``dft``: with the DFT bands; ``shard``: a
    shard's)."""
    return tuple(_block_j(lossy, False, dft=dft, shard=shard))


def shard_block_j(lossy: bool, dft: bool, s: int) -> int:
    """The threads along j of a shard's sweep at depth ``s``."""
    return _block_j(lossy, False, dft=dft, shard=True)[s]


def plan_for(p: Params, s: int, lossy: bool = False, het: bool = False,
             sar: bool = False, pml: PMLConfig | None = None, ade: bool = False,
             bj: int | None = None, dft: DftConfig | None = None,
             window: tuple[int, int, int] | None = None, cr: bool | None = None, fold: int = 0) -> StreamPlan:
    """The tile geometry of ``s`` steps per sweep on the grid of ``p``, for
    the kernel variant the flags name (het and sar imply lossy, except
    for Debye media, ``ade``: vacuum H and the ADE E update), with the DFT
    bands of ``dft`` (``fold``: their means mode with a buffer of that
    many levels, a multiple of ``s``).  ``bj`` (threads along j) and ``cr``
    (the coefficient ring) are the variant's built values unless given,
    for a build with other shapes (``tune_stream``).
    ``window``: a shard's owned (k, j, i) planes, tiled instead of the
    grid.  CPML (``pml``): the two launches of :func:`pml_blocks`."""
    lossy = not ade and (lossy or het or sar)
    if fold and (dft is None or fold % s):
        raise ValueError(f"the means mode takes the DFT bands and a buffer of whole sweeps; got fold={fold} at s={s}")
    table = _block_j(lossy, pml is not None, ade, sar, dft is not None, window is not None)
    if bj is None:
        if s not in table:
            raise ValueError(f"steps per sweep must be one of {tuple(table)} for this variant; got {s}")
        bj = table[s]
    if pml is not None:
        return _pml_plan(p, s, lossy, pml, bj, dft, lossy and (dft is None or fold > 0) if cr is None else cr, fold)
    if cr is None:
        cr = ade or lossy and (dft is not None or COEF_RING_MATERIAL.get(s, False))
    K1, J1, I1 = window or p.padded_shape
    bi = BLOCK_I
    sh = int(sar or dft is not None)  # the cell means read E one column past
    tj, ti = bj - 2 * s - sh, bi - 2 * s - sh
    nj, ni = -(-J1 // tj), -(-I1 // ti)
    # k segments of every tile, as many as fill whole waves best
    tk = pick_tk(K1, nj * ni, s, sh)
    nk = -(-K1 // tk)
    # each segment loads its s lead-in planes and the s (+1) planes past
    # it, clamped at the grid's walls (a shard's halo planes count)
    lo, hi = (0, K1 - 1) if window is None else (-(s + sh), K1 - 1 + s + sh)
    loaded = sum(min(k1 - 1 + s + sh, hi) - max(k0 - s, lo) + 1 for _, k0, k1 in segments(nj, ni, K1, tk))
    amp_k = loaded / (nj * ni * K1)
    amp_ji = (bj * bi) / (tj * ti)
    item = _itemsize(p)
    cells = p.maxk * p.maxj * p.maxi / (K1 * J1 * I1)
    if ade:  # fields, P and the 15 maps (+3 sigma) read; fields and P written
        arrays_read, written = 6 + 3 + 15 + (3 if sar else 0), 9
        sar_bytes = 8 * cells if sar else 0.0  # the accumulator read and written
    else:
        arrays_read, written = 6 + (6 if lossy else 0) + (3 if het else 0), 6
        # sigma is read and the accumulator read and written once per cell
        sar_bytes = (item + 8) * cells if sar else 0.0
    dft_bytes = dft_sweep_bytes(p, dft, s, fold) / (K1 * J1 * I1)
    per_step = (arrays_read * item * amp_ji * amp_k + written * item + sar_bytes + dft_bytes) / s
    return StreamPlan(s, tk, tj, ti, bj, bi, nk, nj, ni, per_step, lossy, het, sar, False, ade,
                      dft is not None, window, bool(cr), fold=fold)


def dft_sweep_bytes(p: Params, dft: DftConfig | None, s: int, fold: int = 0) -> float:
    """Device bytes of the DFT sums a sweep of ``s`` steps moves: the
    bands read and write them once; the means mode writes 12 B a cell and
    level, which the fold reads once, and its fold (one every ``fold``
    levels) reads and writes the sums once."""
    if dft is None:
        return 0.0
    if not fold:
        return float(acc_bytes(p, dft))
    cells = p.maxk * p.maxj * p.maxi
    return s * (24 * cells + 2 * acc_bytes(p, dft) / fold)


def means_bytes(p: Params, fold: int, cells: int | None = None) -> int:
    """Device bytes of the means mode's (fold, 3, cells) fp32 buffer
    (``cells``: a shard's; the grid's when None)."""
    return 12 * fold * (p.maxk * p.maxj * p.maxi if cells is None else cells)


def psi_free(p: Params, cfg: PMLConfig) -> tuple[tuple[int, int], ...]:
    """Per axis (k, j, i), the planes [a, b) of the padded grid that hold
    no psi of a term whose PML axis it is: every psi cell lies below a or
    at b or above along some axis (:func:`.cpml.psi_boxes`)."""
    lo, hi = [0, 0, 0], list(p.padded_shape)
    for name, slabs in psi_boxes(p, cfg).items():
        axis = PML_AXES[name]
        lo[axis] = max(lo[axis], slabs[0][axis][1])
        hi[axis] = min(hi[axis], slabs[1][axis][0])
    return tuple(zip(lo, hi))


# the PML axis of each psi term (ops/cpml.py::_TERMS): the letter after "_"
PML_AXES = {name: "zyx".index(name[-1]) for name in TERM_NAMES}


@functools.lru_cache(maxsize=64)  # a few tenths of a second at 256^3; plans are made again for every run
def pml_blocks(shape: tuple[int, int, int], free: tuple[tuple[int, int], ...], s: int, tj: int, ti: int,
               sh: int) -> tuple[tuple[int, int, int, int, int, int] | None, int, tuple]:
    """The layout of a CPML sweep on a padded grid of ``shape`` whose psi
    lies outside ``free`` (:func:`psi_free`), at ``s`` steps with tiles of
    ``tj`` x ``ti`` columns (``sh``: the cell means' extra column).

    A block's recompute region is its emitted window with s cells more
    below and s + sh above along each axis (the tile's s-column halo, s +
    1 with the cell means; the segment's s lead-in planes and the s + sh
    planes past it).  The interior window, whose blocks' regions hold no
    psi (narrowed along j and i so that the shell's slabs there are whole
    tiles wide: their tiles compute those columns anyway), runs ring_kernel
    (the K3 sweep); the six boxes around it (the k slabs, then the j slabs
    between them, then the i slabs) run pml_kernel, or the whole grid does
    where no interior is left.  Each box is tiled like ring_kernel's grid (k
    segments of every tile, tiles in (j, i) order), at the segment depth
    whose blocks, longest first, finish soonest on the 132 SMs (each block's
    pipeline steps counted, handed to the SM that frees first).  Returns
    (the interior window (k0, k1, j0, j1, i0, i1) or None, the segment
    depth, pml_kernel's blocks (k0, k1, j0, j1, i0, i1, 0, 0))."""
    inner = [(a + s, b - s - sh) for a, b in free]
    for axis, t in ((1, tj), (2, ti)):
        a, b = inner[axis]
        wa, wb = -(-a // t) * t, shape[axis] - -(-(shape[axis] - b) // t) * t
        if wa < wb:
            inner[axis] = (wa, wb)
    window = None
    K1, J1, I1 = shape
    boxes = [((0, K1), (0, J1), (0, I1))]
    if all(a < b for a, b in inner):
        (k0, k1), (j0, j1), (i0, i1) = inner
        window = (k0, k1, j0, j1, i0, i1)
        boxes = [((0, k0), (0, J1), (0, I1)), ((k1, K1), (0, J1), (0, I1)),
                 ((k0, k1), (0, j0), (0, I1)), ((k0, k1), (j1, J1), (0, I1)),
                 ((k0, k1), (j0, j1), (0, i0)), ((k0, k1), (j0, j1), (i1, I1))]

    def layout(tk: int) -> list[tuple[int, ...]]:
        out = []
        for (ka, kb), (ja, jb), (ia, ib) in boxes:
            nseg = -(-(kb - ka) // tk)
            depth = -(-(kb - ka) // nseg)
            tiles = [(j, min(j + tj, jb), i, min(i + ti, ib)) for j in range(ja, jb, tj) for i in range(ia, ib, ti)]
            for k in range(ka, kb, depth):
                out += [(k, min(k + depth, kb), *t, 0, 0) for t in tiles]
        return sorted(out, key=lambda b: -cost(b))

    def cost(b) -> int:
        return b[1] + s + sh - max(b[0] - s, 0)

    def makespan(blocks) -> int:
        sms = [0] * SM_COUNT
        for b in blocks:
            heapq.heapreplace(sms, sms[0] + cost(b))
        return max(sms)

    planes = shape[0]
    best = None
    for nk in range(1, max(1, min(planes // (2 * s), 32)) + 1):
        tk = -(-planes // nk)
        blocks = layout(tk)
        key = (makespan(blocks), -tk)
        if best is None or key < best[0]:
            best = (key, tk, blocks)
    return window, best[1], tuple(best[2])


def _pml_plan(p: Params, s: int, lossy: bool, pml: PMLConfig, bj: int, dft: DftConfig | None,
              cr: bool, fold: int = 0) -> StreamPlan:
    """The CPML sweep's plan: pml_kernel's blocks and the interior's
    ring_kernel plan (``core``: the K3 sweep of the variant at depth s on
    the interior window, with its origin), where the grid has one."""
    bi = BLOCK_I
    sh = int(dft is not None)
    tj, ti = bj - 2 * s - sh, bi - 2 * s - sh
    shape = p.padded_shape
    window, tk, blocks = pml_blocks(shape, psi_free(p, pml), s, tj, ti, sh)
    core = None
    if window is not None:
        k0, k1, j0, j1, i0, i1 = window
        cbj, ccr = ((BLOCK_J_PML_INTERIOR_DFT[s], lossy and fold > 0) if dft is not None else
                    ((BLOCK_J_MATERIAL if lossy else BLOCK_J)[s], lossy and COEF_RING_MATERIAL.get(s, False)))
        core = dataclasses.replace(plan_for(p, s, lossy, bj=cbj, dft=dft, window=(k1 - k0, j1 - j0, i1 - i0), cr=ccr,
                                            fold=fold), origin=(k0, j0, i0))
    # bytes: pml_kernel's blocks read the fields (and ca/cb) of their
    # columns and planes, the interior its own model; every cell written
    # once; psi read once per amplified shell cell and written once
    item = _itemsize(p)
    K1 = shape[0]
    loaded = sum((min(b[1] - 1 + s + sh, K1 - 1) - max(b[0] - s, 0) + 1) * bj * bi for b in blocks)
    shell = sum((b[1] - b[0]) * (b[3] - b[2]) * (b[5] - b[4]) for b in blocks)
    reads = (6 + (6 if lossy else 0)) * item * loaded
    inner = core.bytes_per_cell_step * s * math.prod(core.window) if core is not None else 0.0
    psi_b = psi_bytes(p, pml) * (loaded / shell + 1)
    dft_b = dft_sweep_bytes(p, dft, s, fold)
    per_step = (reads + 6 * item * shell + inner + psi_b + dft_b) / (s * math.prod(shape))
    nj, ni = -(-shape[1] // tj), -(-shape[2] // ti)
    return StreamPlan(s, tk, tj, ti, bj, bi, -(-K1 // tk), nj, ni, per_step, lossy, False, False, True, False,
                      dft is not None, None, cr, None, pml.cells, blocks, core, fold)


def pml_gates(p: Params, cfg: PMLConfig, het: bool = False, sar: bool = False) -> bool:
    """The scenes the CPML sweep takes (the gates of
    ``fdtd_tpu/ops/pallas_stream_pml.py::stream_pml_supported``):
    computation mode, homogeneous mu_r, no SAR, and the source patch clear
    of the j and i slabs.  Every other CPML scene runs on ``twopass``."""
    if p.mode != Mode.COMPUTATION or het or sar:
        return False
    n = cfg.cells
    src = make_source_plan(p)
    return src.j0 > n and src.j1 < p.maxj - n and src.i0 > n and src.i1 < p.maxi - n


def stream_bytes(p: Params, lossy: bool = False, het: bool = False, sar: bool = False,
                 pml: PMLConfig | None = None, ade: bool = False, dft: DftConfig | None = None,
                 fold: int = 0) -> int:
    """Device bytes of a ``stream`` run: two states (and two P sets with
    Debye media, two psi sets with CPML), the material arrays, the DFT
    sums (one set, updated in place) and in the means mode its buffer of
    ``fold`` levels, and the temporaries of the trailing two-pass steps'
    SAR increment or of the outputs."""
    lossy = not ade and (lossy or het)
    return (2 * state_bytes(p) + (2 * pol_bytes(p) if ade else 0) + material_bytes(p, lossy, het, sar, ade)
            + work_bytes(p, sar, ade) + (2 * psi_bytes(p, pml) if pml else 0) + (acc_bytes(p, dft) if dft else 0)
            + means_bytes(p, fold))


# the torch ADE step's temporaries (update_e_ade on one component: the
# curl, E', P', the work's midpoint and the products in flight; with bf16
# storage the fp32 copies of H, E and P too), in arrays of a shard's box in
# the compute type
ADE_TORCH_TEMPS = 12


def shard_bytes(p: Params, shapes, devices, main, stream: bool, lossy: bool = False, het: bool = False,
                sar: bool = False, pml: PMLConfig | None = None, ade: bool = False, dft: DftConfig | None = None,
                psi_elems: list[int] | None = None, fold: int = 0) -> dict:
    """Device bytes of a sharded run, per device: of each shard (its arrays'
    ``shapes`` (k, j, i) with halos, its cell count, on its ``devices``
    entry) one state (two on ``stream``) and its parts of the material
    arrays, sigma and the SAR map; with ``pml`` its psi parts
    (``psi_elems``, elements per shard); in a Debye medium (``ade``) P, the
    15 maps (18 with SAR) and the fp32 work arrays over its box; with
    ``dft`` its part of the sums (and in the means mode its buffer of
    ``fold`` levels); per device the temporaries of the torch
    ADE step or of the H sums of fields "eh" on its largest shard; and on
    ``main`` the canonical grid the run gathers into (the state, the SAR
    map, psi, P and the sums) with the temporaries of the outputs (or the
    SAR increment's, the larger)."""
    item = _itemsize(p)
    cd = 8 if p.dtype == "float64" else 4
    lossy = (lossy or het) and not ade
    per, temps = {}, {}
    for q, ((shape, cells), dev) in enumerate(zip(shapes, devices)):
        arr = math.prod(shape) * item
        b = ((2 if stream else 1) * 6 * arr + (6 * arr + cells * item if lossy else 0) + (3 * arr if het else 0)
             + (4 * cells if sar else 0))
        if pml is not None:
            b += psi_elems[q] * item
        if ade:
            b += (3 + 15 + (3 if sar else 0)) * arr + (3 * cd * math.prod(shape) if sar else 0)
        if dft is not None:
            b += 8 * dft.nf * dft.nc * cells + means_bytes(p, fold, cells)
        t = max(ADE_TORCH_TEMPS * cd * math.prod(shape) if ade else 0,
                (7 + 3 * dft.nf) * 4 * cells if dft is not None and dft.fields == "eh" else 0)
        per[dev] = per.get(dev, 0) + b
        temps[dev] = max(temps.get(dev, 0), t)
    for dev, t in temps.items():
        per[dev] += t
    per[main] = (per.get(main, 0) + state_bytes(p) + (4 * p.maxk * p.maxj * p.maxi if sar else 0)
                 + (psi_bytes(p, pml) if pml is not None else 0) + (pol_bytes(p) if ade else 0)
                 + (acc_bytes(p, dft) if dft is not None else 0) + work_bytes(p, sar))
    return per


def shard_fits(per_device: dict, free) -> bool:
    """Every device's :func:`shard_bytes` fits in its free memory (``free``:
    device -> bytes; a device not in it, a CPU, is held to the H100's 80 GB
    that the CPU path plans for) with the margin the other plans keep."""
    return all(b <= MEMORY_MARGIN * free.get(d, DEVICE_BYTES) for d, b in per_device.items())


def dft_gates(p: Params, dft: DftConfig) -> bool:
    """The DFT scenes the sweep's bands take (the gates of
    ``fdtd_tpu/ops/pallas_stream.py``'s streamed DFT): fields "e" in
    computation mode.  The H sums of "eh", validation mode and probes need
    per-step states: they run on ``twopass`` (or ``torch``)."""
    return dft.fields == "e" and p.mode == Mode.COMPUTATION


def ade_gates(p: Params, het: bool = False, pml: PMLConfig | None = None) -> bool:
    """The Debye scenes the kernels take (``fdtd_tpu/ops/pallas_dispersive.
    py::dispersive_fused_supported``, plus what the port's ADE kernels do
    not carry): computation mode, float32 or bfloat16, homogeneous mu_r
    and no CPML (Debye x CPML runs the torch ops)."""
    return (p.mode == Mode.COMPUTATION and p.dtype in ("float32", "bfloat16") and not het
            and pml is None)


def feasible(p: Params, memory_bytes: int | None = None, lossy: bool = False,
             het: bool = False, sar: bool = False, pml: PMLConfig | None = None,
             ade: bool = False, dft: DftConfig | None = None, fold: int = 0) -> bool:
    """The kernel takes the dtype and the scene, and the two states, with
    the material arrays (and two psi sets with CPML, two P sets with
    Debye media, the DFT sums and the means mode's buffer of ``fold``
    levels), fit in ``memory_bytes`` (default: the H100's 80 GB).
    Every plan's block fits an SM (at most 1024 threads and 227 KB of
    shared memory), so the grid, the dtype and the gates decide: materials
    stream in computation mode only, SAR needs materials, CPML takes
    :func:`pml_gates`, Debye media :func:`ade_gates` and the DFT bands
    :func:`dft_gates`."""
    if p.dtype not in ("float32", "bfloat16"):
        return False
    if dft is not None and not dft_gates(p, dft):
        return False
    mem = DEVICE_BYTES if memory_bytes is None else memory_bytes
    if ade:
        return ade_gates(p, het, pml) and stream_bytes(p, sar=sar, ade=True, dft=dft, fold=fold) <= MEMORY_MARGIN * mem
    lossy = lossy or het
    if lossy and p.mode != Mode.COMPUTATION:
        return False
    if sar and not lossy:
        return False  # vacuum deposits nothing: no SAR variant
    if pml is not None and not pml_gates(p, pml, het, sar):
        return False
    # the trailing n % s two-pass steps add the SAR increment's temporaries
    return stream_bytes(p, lossy, het, sar, pml, dft=dft, fold=fold) <= MEMORY_MARGIN * mem


def fold_depth(s: int, fits) -> int:
    """The means mode's buffer depth at ``s`` steps a sweep: the deepest
    multiple of ``s`` up to ``FOLD_DEPTH`` levels for which ``fits(depth)``
    (the run's arrays with the buffer fit in memory), or 0 where none
    does.  A deeper buffer folds less often: each fold reads and writes the
    sums once (48 * nf B a cell), while the levels cost 24 B a cell and
    step whatever the depth."""
    return next((d for d in range(FOLD_DEPTH // s * s, 0, -s) if fits(d)), 0)


def pick_plan(p: Params, s: int | None = None, memory_bytes: int | None = None,
              lossy: bool = False, het: bool = False, sar: bool = False,
              pml: PMLConfig | None = None, ade: bool = False, dft: DftConfig | None = None) -> StreamPlan | None:
    """Of the depths the variant's kernel is built at, the feasible plan
    with the fewest modelled bytes per cell and step (ties to the deeper
    sweep), or None.  A forced ``s`` is checked for feasibility like any
    other.  With ``dft``, the plans whose bands hold its frequencies in
    shared memory; where no depth's do, the means mode of every depth, each
    with the deepest buffer that fits (:func:`fold_depth`)."""
    steps = (s,) if s is not None else tuple(_block_j(not ade and (lossy or het or sar), pml is not None, ade, sar,
                                                      dft is not None))
    cands = [plan_for(p, x, lossy, het, sar, pml, ade, dft=dft) for x in steps]
    if dft is not None:
        bands = [c for c in cands if c.dft_max_nf >= dft.nf]
        if not bands:  # the means mode
            depths = [(c.s, fold_depth(c.s, lambda d: feasible(p, memory_bytes, lossy, het, sar, pml, ade, dft, d)))
                      for c in cands]
            return min((plan_for(p, x, lossy, het, sar, pml, ade, dft=dft, fold=d) for x, d in depths if d),
                       key=lambda c: (c.bytes_per_cell_step, -c.s), default=None)
        cands = bands
    if not cands or not feasible(p, memory_bytes, lossy, het, sar, pml, ade, dft):
        return None
    return min(cands, key=lambda c: (c.bytes_per_cell_step, -c.s))


def supported(p: Params, memory_bytes: int | None = None, lossy: bool = False,
              het: bool = False, sar: bool = False, pml: PMLConfig | None = None,
              ade: bool = False, dft: DftConfig | None = None) -> bool:
    """True when some streaming plan fits (see :func:`pick_plan`)."""
    return pick_plan(p, memory_bytes=memory_bytes, lossy=lossy, het=het, sar=sar, pml=pml,
                     ade=ade, dft=dft) is not None


# ---------------------------------------------------------------------------
# The two-pass CPML kernels' launch (csrc/yee_twopass.cu::march_kernel)
# ---------------------------------------------------------------------------

MARCH_BI = 128  # a tile's threads along i (csrc/yee_twopass.cu::MARCH_BI)
MARCH_BJ = 2  # and along j (MARCH_BJ)
MARCH_BLOCKS_PER_SM = 4  # the kernel's launch bounds (MARCH_NB): 256 threads at 64 registers at most
MARCH_AHEAD = 2  # the planes its copies run ahead (MARCH_AH)
MARCH_MEMBERS = 65535  # a batched launch's members at most: they lie along gridDim.y (MARCH_MEMBERS)
# the batched passes' shapes, (planes ahead, BJ, blocks an SM, BI) (csrc/yee_twopass.cu::BATCH_*): wide members
# three planes ahead on the single passes' tiles, narrow ones (batch_is_narrow) on 4 x 64 tiles
MARCH_BATCH_WIDE = (3, MARCH_BJ, MARCH_BLOCKS_PER_SM, MARCH_BI)
MARCH_BATCH_NARROW = (MARCH_AHEAD, 4, MARCH_BLOCKS_PER_SM, 64)
# the planes a batched pass's chunk holds at most (pick_batch_tk; tune_twopass's tk_depths, PERF.md)
MARCH_BATCH_TK = 6


@dataclasses.dataclass(frozen=True)
class MarchPlan:
    """The launch of one CPML two-pass pass (H or E) on ``march_kernel``:
    ``window``, the cells it updates (global (lo, hi) per axis: the box's
    owned window within the pass's update bounds); ``tiles`` (j, i) of
    ``MARCH_BJ`` x ``MARCH_BI`` columns, one block each per chunk of ``tk``
    planes, block b marching chunk b // tiles of tile b % tiles (tiles in
    (j, i) order, i fastest); ``extra`` (j, i): the window's last row
    (column) lies one past whole tiles (so 257 columns take 8 tiles of 32,
    not 9 with one column in the ninth), and the edge blocks after the
    tiles' update it, one cell and plane a thread (:attr:`edge_cells` a
    plane: the last row, then the last column, the corner once).
    ``members``: a batched launch (the vacuum passes of a sweep's members,
    ``march_kernel`` with ``BATCH``): every member's blocks laid out as one
    launch's along x, member b at ``blockIdx.y`` = b.  ``ahead``: the
    planes the copies run ahead (the instantiation's; no cell depends on
    it)."""

    window: tuple[tuple[int, int], tuple[int, int], tuple[int, int]]
    tiles: tuple[int, int]
    extra: tuple[bool, bool]
    tk: int
    bj: int = MARCH_BJ
    blocks_per_sm: int = MARCH_BLOCKS_PER_SM
    bi: int = MARCH_BI
    members: int = 1
    ahead: int = MARCH_AHEAD

    @property
    def chunks(self) -> int:
        return -(-(self.window[0][1] - self.window[0][0]) // self.tk)

    @property
    def edge_cells(self) -> int:
        (_k0, _k1), (j0, j1), (i0, i1) = self.window
        xj, xi = self.extra
        return (i1 - i0 if xj else 0) + (j1 - j0 - xj if xi else 0)

    @property
    def member_blocks(self) -> int:
        """A member's blocks: the tiles' blocks of every chunk, then the
        edge blocks (``gridDim.x``)."""
        planes = self.window[0][1] - self.window[0][0]
        return self.tiles[0] * self.tiles[1] * self.chunks + -(-self.edge_cells * planes // (self.bi * self.bj))

    @property
    def blocks(self) -> int:
        return self.members * self.member_blocks

    @property
    def waves(self) -> float:
        """Blocks over what the card holds at once (``MARCH_BLOCKS_PER_SM``
        on each SM)."""
        return self.blocks / (SM_COUNT * self.blocks_per_sm)


def march_tiles(extent: int, b: int) -> tuple[int, bool]:
    """(tiles, extra) of ``extent`` columns in tiles of ``b``: whole tiles
    over all but the last column, which the edge blocks take when the
    tiles stop one short of it."""
    n = max(1, -(-(extent - 1) // b))
    return n, n * b < extent


def pick_march_tk(planes: int, tiles: int, blocks_per_sm: int = MARCH_BLOCKS_PER_SM) -> int:
    """The planes a block of march_kernel marches: of the splits of
    ``planes`` into equal chunks that give every block slot of the card
    (``blocks_per_sm`` on each SM) a block, the one whose waves take the
    fewest plane steps an SM, each chunk's two planes of start-up (the
    other field's second plane and the first plane's wait) counted; ties
    to the deeper chunk.  Whole waves first, as :func:`pick_tk`: a last
    wave half full costs a whole wave.  A card with fewer blocks than
    slots leaves SMs short of the copies in flight a memory-bound pass
    needs, so a split that fills the slots comes first (the finest split
    when none does)."""
    slots = SM_COUNT * blocks_per_sm
    splits = [-(-planes // nk) for nk in range(1, planes + 1)]
    full = [tk for tk in splits if -(-planes // tk) * tiles >= slots] or [min(splits)]

    def steps(tk: int) -> int:
        return -(-(-(-planes // tk) * tiles) // slots) * (tk + 2)

    return min(full, key=lambda tk: (steps(tk), -tk))


def batch_is_narrow(width: int) -> bool:
    """Whether a batch's members of ``width`` columns in the pass's window
    take the narrow tiles (``MARCH_BATCH_NARROW``): their 64-wide tiles hold
    fewer lanes a row than 128-wide ones (a 65-wide member of a 64^3 sweep
    fills half a 128-wide tile; ``csrc/yee_twopass.cu::batch_narrow``)."""
    bi = MARCH_BATCH_NARROW[3]
    return march_tiles(width, bi)[0] * bi < march_tiles(width, MARCH_BI)[0] * MARCH_BI


def pick_batch_tk(planes: int, tiles: int, depth: int, blocks_per_sm: int = MARCH_BLOCKS_PER_SM) -> int:
    """The planes a block of a batched pass marches: the deepest split of
    ``planes`` into equal chunks of at most ``depth`` planes
    (``MARCH_BATCH_TK``) whose blocks (``tiles`` of all members a chunk)
    give every block slot of the card a block; the finest split when none
    does.  Whole waves do not decide it: a chunk of every member's planes
    (:func:`pick_march_tk`'s pick for a batch at 256^3 x 4: two waves)
    measured 11-14% slower than chunks of 16 (fp32) or 6 (bf16) planes, tens
    of waves, on an NVIDIA H100 80GB HBM3 (PERF.md)."""
    slots = SM_COUNT * blocks_per_sm
    splits = [-(-planes // nk) for nk in range(1, planes + 1)]
    fill = [tk for tk in splits if tk <= depth and -(-planes // tk) * tiles >= slots]
    return max(fill) if fill else min(splits)


def march_plan(p: Params, box: Box | None, e_pass: bool, bj: int | None = None,
               blocks_per_sm: int | None = None, bi: int | None = None, members: int = 1,
               tk: int | None = None) -> MarchPlan | None:
    """The launch of the two-pass H (``e_pass`` False) or E pass over
    ``box``'s owned window (None: the whole grid), or None when the window
    holds no cell the pass updates.  The H pass updates planes, rows and
    columns up to K, J, I; the E pass stops one short on each axis (the
    walls).  ``members``: a batched launch over that many members (1 to
    ``MARCH_MEMBERS``; the vacuum passes of a sweep), at the batch's shape
    (:func:`batch_is_narrow`) and chunks of :func:`pick_batch_tk`.  ``bj``, ``blocks_per_sm``, ``bi`` and ``tk``:
    another shape or chunk depth of the kernel (``tune_twopass``)."""
    if not 1 <= members <= MARCH_MEMBERS:
        raise ValueError(f"a batched launch takes 1 to {MARCH_MEMBERS} members; got {members}")
    box = box or full_box(p)
    top = (p.maxk, p.maxj, p.maxi) if e_pass else (p.maxk + 1, p.maxj + 1, p.maxi + 1)
    window = tuple((lo, min(hi, t)) for lo, hi, t in zip(box.own_lo, box.own_hi, top))
    if any(hi <= lo for lo, hi in window):
        return None
    ahead, *shape = ((MARCH_BATCH_NARROW if batch_is_narrow(window[2][1] - window[2][0]) else MARCH_BATCH_WIDE)
                     if members > 1 else (MARCH_AHEAD, MARCH_BJ, MARCH_BLOCKS_PER_SM, MARCH_BI))
    bj, blocks_per_sm, bi = (given if given is not None else built
                             for given, built in zip((bj, blocks_per_sm, bi), shape))
    (ntj, xj), (nti, xi) = (march_tiles(window[a][1] - window[a][0], b) for a, b in ((1, bj), (2, bi)))
    planes, tiles = window[0][1] - window[0][0], members * ntj * nti
    if tk is None:
        tk = (pick_batch_tk(planes, tiles, MARCH_BATCH_TK, blocks_per_sm) if members > 1
              else pick_march_tk(planes, tiles, blocks_per_sm))
    return MarchPlan(window, (ntj, nti), (xj, xi), tk, bj, blocks_per_sm, bi, members, ahead)


def member_start(member: int, shape: tuple[int, ...]) -> int:
    """The element at which member ``member`` of a batch of contiguous
    arrays of ``shape`` starts, past member 0
    (``csrc/yee_twopass.cu::member_start``)."""
    return member * math.prod(shape)


def member_lead(lead0: int, start: int, item: int) -> int:
    """Where a batch member's arrays start within their 16-byte chunk, in
    elements of ``item`` bytes: member 0's lead ``lead0`` moved by the
    member's ``start`` (:func:`member_start`), modulo the chunk's elements
    (``csrc/yee_twopass.cu::member_lead``, at each block's start)."""
    return (lead0 + start) & (16 // item - 1)


def march_geometry(p: Params, cfg: PMLConfig | None, box: Box | None, e_pass: bool, bj: int | None = None,
                   blocks_per_sm: int | None = None, bi: int | None = None, members: int = 1,
                   tk: int | None = None) -> tuple[int, ...]:
    """The 43 ints of march_kernel's ``geom``: the box (its arrays' extents,
    the global index of their origin, its owned window; the whole grid's own
    box for None), the pass's psi parts with ``cfg`` (origin and extents
    along axes 1 and 2 a term, :func:`~fdtd_tpu_torch.ops.cpml.
    psi_part_geometry`; zeros for a pass without CPML) and the planes a
    block marches (:func:`march_plan`, for ``members`` members, or ``tk``)."""
    box = box or full_box(p)
    plan = march_plan(p, box, e_pass, bj, blocks_per_sm, bi, members, tk)
    window = [x for lo_hi in zip(box.own_lo, box.own_hi) for x in lo_hi]
    parts = psi_part_geometry(p, cfg, box, E_TERMS if e_pass else H_TERMS) if cfg is not None else [0] * 30
    return (*box.shape, *box.lo, *window, *parts, plan.tk if plan is not None else 1)


def march_counts(p: Params, plan: MarchPlan, e_pass: bool) -> np.ndarray:
    """How many times the launch of ``plan`` updates each cell of the padded
    grid, per component (x, y, z): an int8 (3, K+1, J+1, I+1) array, with
    blocks and threads mapped to cells as ``march_kernel`` maps them (block
    x below the tiles' blocks: tile x % tiles, chunk x // tiles, planes
    k0 + chunk * tk on; tile (tj, ti), thread (ty, tx): column (j0 + tj * bj
    + ty, i0 + ti * bi + tx) inside the window less its last row and column
    where the edge blocks take them; edge thread e: plane k0 + e //
    edge_cells, cell e % edge_cells) and each component's update bounds as
    the kernel tests them.  A batched plan: an (members, 3, K+1, J+1, I+1)
    array, the blocks of ``blockIdx.y`` = b counted in each component's
    batch from :func:`member_start` on, as the kernel moves its pointers."""
    if plan.members > 1:
        one = march_counts(p, dataclasses.replace(plan, members=1), e_pass).reshape(3, -1)
        batch = np.zeros((3, plan.members * one.shape[1]), np.int8)
        for b in range(plan.members):
            start = member_start(b, p.padded_shape)
            batch[:, start:start + one.shape[1]] += one
        return batch.reshape(3, plan.members, *p.padded_shape).swapaxes(0, 1)
    K, J, I = p.maxk, p.maxj, p.maxi
    (k0, k1), (j0, j1), (i0, i1) = plan.window
    (ntj, nti), (xj, xi) = plan.tiles, plan.extra
    tiles = ntj * nti
    cells = np.zeros((K + 1, J + 2, I + 2), np.int8)  # one spare row and column: a thread past the grid shows
    ne, nr = plan.edge_cells, (i1 - i0 if xj else 0)
    for x in range(plan.member_blocks):
        if x < tiles * plan.chunks:
            tj, ti = divmod(x % tiles, nti)
            kb0 = k0 + (x // tiles) * plan.tk
            j = j0 + tj * plan.bj + np.arange(plan.bj)[:, None]
            i = i0 + ti * plan.bi + np.arange(plan.bi)[None, :]
            live = (j < j1 - xj) & (i < i1 - xi)
            jl, il = np.broadcast_to(j, live.shape)[live], np.broadcast_to(i, live.shape)[live]
            cells[kb0:min(kb0 + plan.tk, k1), jl, il] += 1
        else:
            e = (x - tiles * plan.chunks) * plan.bi * plan.bj + np.arange(plan.bi * plan.bj)
            e = e[e < ne * (k1 - k0)]
            u = e % ne
            np.add.at(cells, (k0 + e // ne, np.where(u < nr, j1 - 1, j0 + u - nr), np.where(u < nr, i0 + u, i1 - 1)), 1)
    if cells[:, J + 1].any() or cells[:, :, I + 1].any():
        raise AssertionError("the launch maps a thread past the grid")
    cells = cells[:, :J + 1, :I + 1]
    jj, ii, kk = np.arange(J + 1)[:, None], np.arange(I + 1)[None, :], np.arange(K + 1)
    if e_pass:
        col_bounds = ((jj >= 1) & (jj < J) & (ii < I), (jj < J) & (ii >= 1) & (ii < I),
                      (jj >= 1) & (jj < J) & (ii >= 1) & (ii < I))
        k_bounds = ((kk >= 1) & (kk < K), (kk >= 1) & (kk < K), kk < K)
    else:
        col_bounds = (np.broadcast_to(jj < J, (J + 1, I + 1)), np.broadcast_to(ii < I, (J + 1, I + 1)),
                      (jj < J) & (ii < I))
        k_bounds = (kk < K, kk < K, kk <= K)
    return np.stack([cells * kb[:, None, None] * cb[None] for kb, cb in zip(k_bounds, col_bounds)])

