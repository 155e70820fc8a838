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

The CPML variants (``pml``: vacuum or lossy) carry the twelve psi terms of
every level in registers beside the fields, so their blocks are smaller
and they are built at s=2 alone (``BLOCK_J_PML``), and they mirror the gates of
``fdtd_tpu/ops/pallas_stream_pml.py::stream_pml_supported``: computation
mode, homogeneous mu_r, no SAR, and the source patch clear of the j and i
slabs.  A sweep reads one psi set and writes a second (a neighbour's halo
reads level-0 psi of cells this block writes), so a plan counts two.

The ADE variants (Debye media, ``ade``: vacuum H, with or without SAR)
carry each level's polarization (and with SAR its edge work) in registers
beside the fields and read the 15 coefficient maps per level and plane, so
they have block shapes of their own (``BLOCK_J_ADE``, ``BLOCK_J_ADE_SAR``),
each at the one shape that measured fastest (``python -m
fdtd_tpu_torch.tune_ade``): the bytes model ranks deeper sweeps first, but
registers bind them and they run slower.  Their gates are the material
variants' (computation mode) plus no CPML (Debye x CPML runs the torch
ops) and no heterogeneous mu_r.  A sweep reads one P set and writes a
second, like the state.

The DFT variants (``dft``: the phasor sums of fields "e" ride the sweep)
exist for every variant above.  They form each level's E cell means as the
SAR variants do, so their tiles emit one column fewer per axis and the
pipeline runs one step further; a thread keeps the 6 * nf sums of the s
cells it has in flight in dynamic shared memory (loaded at level 1, stored
at level s), so ``nf`` is a runtime value that needs no registers, up to
what fits beside the static buffers (:attr:`StreamPlan.dft_max_nf`; a
scene with more frequencies runs ``twopass`` with the ``dft_accum``
kernel).  Each is built at one depth: the
material and vacuum variants at ``BLOCK_J_DFT``, the CPML and ADE variants
at the shape of their variant without DFT.  The sums (8 * nf * nc B a cell)
count in every footprint; a DFT sweep reads and writes them once.

Every footprint counts the temporaries of the output reductions (the k
slabs of the energies and snapshot aggregation) or of the SAR increment,
whichever is larger: they never run at the same time.  With Debye SAR the
increment also needs the three fp32 edge work arrays of the E pass.

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
import math

from .. import diagnostics
from ..dft import DftConfig, acc_bytes
from ..params import Mode, Params
from ..source import make_source_plan
from .cpml import PMLConfig, psi_bytes

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
# the CPML variants (vacuum and lossy) keep twelve psi a level a thread
# more, and are built at s=2 only: measured at 256^3 fp32 (NVIDIA H100 80GB
# HBM3), s=2 with 768-thread blocks fits 80 registers without spills (0.74
# ms a step; 512 threads 1.00, 1024 threads 0.85 with 88 B of spills); s=4
# spilled 160 B (1.08 ms a step) and s=8 about 540 B (7.4 ms a step)
BLOCK_J_PML = {2: 24}
# the ADE variants (Debye media) keep three P (and with SAR three work
# values) a level a thread more and read 15 maps a level; each is built at
# the one shape that measured fastest at 256^3 (python -m
# fdtd_tpu_torch.tune_ade; NVIDIA H100 80GB HBM3, 700 W; ms a step fp32 /
# bf16): without SAR s=4 with 768 threads, 80 registers, no spills, 0.776 /
# 0.660 (s=2 at 768 threads 0.771 / 0.659; s=4 at 1024 threads 0.894 /
# 0.601 with 68 B of spills; s=8 3.31 / 2.40 with 296 B); with SAR s=2 with
# 1024 threads, 64 registers and 32 B of spills, 1.479 / 1.189 (s=2 at 768
# threads, no spills, 1.655 / 1.469; s=4 2.38-3.04 / 1.77-2.42; s=8 9.2 / 8.1)
BLOCK_J_ADE = {4: 24}
BLOCK_J_ADE_SAR = {2: 32}
# the DFT variants of the vacuum and material sweeps: one depth, measured at
# 256^3 (python -m fdtd_tpu_torch.tune_ade --dft; NVIDIA H100 80GB HBM3, 700
# W; ms a step fp32, nf = 1, vacuum / water + SAR): s=4 with 768 threads,
# 80 registers, no spills, 0.635 / 1.028, and room for nf <= 2 in shared
# memory (s=4 with 1024 threads 0.591 / 0.949 but nf <= 1; s=2 with 1024
# threads 0.670 / 1.051; s=4 with 512 threads 0.813 / 1.453; s=8 1.303 /
# 2.510 with 32-136 B of spills)
BLOCK_J_DFT = {4: 24}
BLOCKS_WANTED = 2 * SM_COUNT  # split k until a sweep has this many blocks


def variant_name(lossy: bool, het: bool, sar: bool, pml: bool = False, ade: bool = False,
                 dft: bool = False) -> str:
    """The name of a kernel variant of csrc/yee_stream.cu (its launch
    counter): ``yee_stream`` in vacuum, else ``yee_stream_lossy`` with
    ``_het`` and ``_sar`` as they apply; ``_pml`` for the CPML variants;
    ``yee_stream_ade`` (``_sar``) for Debye media; ``_dft`` last for the
    variants with the DFT bands."""
    suffix = "_dft" if dft else ""
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
    ``nk`` x ``nj`` x ``ni`` blocks."""

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

    @property
    def kernel(self) -> str:
        """The kernel variant, as ``ops.stream.launches`` counts it."""
        return variant_name(self.lossy, self.het, self.sar, self.pml, self.ade, self.dft)

    @property
    def blocks(self) -> int:
        return self.nk * self.nj * self.ni

    @property
    def threads(self) -> int:
        return self.bj * self.bi

    @property
    def smem_bytes(self) -> int:
        """Static shared memory: one fp32 E plane and one H plane, and the
        five E (or work) values a column of the SAR and DFT cell means."""
        return (11 if self.sar or self.dft else 6) * self.bj * self.bi * 4

    def dft_smem_bytes(self, nf: int) -> int:
        """Dynamic shared memory of the DFT bands: 6 * nf fp32 sums of s
        cells a thread."""
        return self.s * 6 * nf * self.bj * self.bi * 4 if self.dft else 0

    @property
    def dft_max_nf(self) -> int:
        """The most frequencies the DFT bands take at this shape (0 without
        them): what fits in a block's shared memory beside the static
        buffers."""
        return (SMEM_PER_BLOCK - self.smem_bytes) // self.dft_smem_bytes(1) if self.dft else 0


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


def _block_j(lossy: bool, pml: bool, ade: bool = False, sar: bool = False, dft: bool = False) -> dict[int, int]:
    """The depths a variant's kernel is built at, with their threads along j."""
    if ade:
        return BLOCK_J_ADE_SAR if sar else BLOCK_J_ADE
    if pml:
        return BLOCK_J_PML
    if dft:
        return BLOCK_J_DFT
    return BLOCK_J_MATERIAL if lossy else BLOCK_J


def built_depths(lossy: bool, dft: bool = False) -> tuple[int, ...]:
    """The steps per sweep the vacuum (or, ``lossy``, the material) sweep
    is built at, deepest first (``dft``: with the DFT bands)."""
    return tuple(_block_j(lossy, False, dft=dft))


def plan_for(p: Params, s: int, lossy: bool = False, het: bool = False,
             sar: bool = False, pml: PMLConfig | None = None, ade: bool = False,
             bj: int | None = None, dft: DftConfig | None = None,
             window: tuple[int, int, int] | None = None) -> StreamPlan:
    """The tile geometry of ``s`` steps per sweep on the grid of ``p``, for
    the kernel variant the flags name (het and sar imply lossy, except
    for Debye media, ``ade``: vacuum H and the ADE E update), with the DFT
    bands of ``dft``.  ``bj`` (threads along j) is the variant's built
    value unless given, for a build with other shapes (``tune_ade``).
    ``window``: a shard's owned (k, j, i) planes, tiled instead of the
    grid."""
    lossy = not ade and (lossy or het or sar)
    table = _block_j(lossy, pml is not None, ade, sar, dft is not None)
    if bj is None:
        if s not in table:
            raise ValueError(f"steps per sweep must be one of {tuple(table)} for this variant; got {s}")
        bj = table[s]
    K1, J1, I1 = window or p.padded_shape
    bi = BLOCK_I
    sh = int(sar or dft is not None)  # the cell means read E one column past
    tj, ti = bj - 2 * s - sh, bi - 2 * s - sh
    nj, ni = -(-J1 // tj), -(-I1 // ti)
    nk_want = max(1, -(-BLOCKS_WANTED // (nj * ni)))
    # a segment at least 2s planes deep keeps the lead-in below 2x
    tk = min(K1, max(-(-K1 // nk_want), 2 * s))
    nk = -(-K1 // tk)
    amp_ji = (bj * bi) / (tj * ti)
    amp_k = (tk + 2 * s) / tk if nk > 1 else 1.0
    item = _itemsize(p)
    cells = p.maxk * p.maxj * p.maxi / (K1 * J1 * I1)
    if ade:  # fields, P and the 15 maps (+3 sigma) read; fields and P written
        arrays_read, written = 6 + 3 + 15 + (3 if sar else 0), 9
        sar_bytes = 8 * cells if sar else 0.0  # the accumulator read and written
    else:
        arrays_read, written = 6 + (6 if lossy else 0) + (3 if het else 0), 6
        # sigma is read and the accumulator read and written once per cell
        sar_bytes = (item + 8) * cells if sar else 0.0
    # psi: read once per halo-amplified tile, written once, per sweep
    pml_bytes = psi_bytes(p, pml) * (amp_ji * amp_k + 1) / (K1 * J1 * I1) if pml else 0.0
    # the DFT sums: read and written once per sweep
    dft_bytes = acc_bytes(p, dft) / (K1 * J1 * I1) if dft is not None else 0.0
    per_step = (arrays_read * item * amp_ji * amp_k + written * item + sar_bytes + pml_bytes + dft_bytes) / s
    return StreamPlan(s, tk, tj, ti, bj, bi, nk, nj, ni, per_step, lossy, het, sar, pml is not None, ade,
                      dft is not None, window)


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
                 pml: PMLConfig | None = None, ade: bool = False, dft: DftConfig | None = None) -> int:
    """Device bytes of a ``stream`` run: two states (and two P sets with
    Debye media, two psi sets with CPML), the material arrays, the DFT
    sums (one set, updated in place), and the temporaries of the trailing
    two-pass steps' SAR increment or of the outputs."""
    lossy = not ade and (lossy or het)
    return (2 * state_bytes(p) + (2 * pol_bytes(p) if ade else 0) + material_bytes(p, lossy, het, sar, ade)
            + work_bytes(p, sar, ade) + (2 * psi_bytes(p, pml) if pml else 0) + (acc_bytes(p, dft) if dft else 0))


# the torch ADE step's temporaries (update_e_ade on one component: the
# curl, E', P', the work's midpoint and the products in flight; with bf16
# storage the fp32 copies of H, E and P too), in arrays of a shard's box in
# the compute type
ADE_TORCH_TEMPS = 12


def shard_bytes(p: Params, shapes, devices, main, stream: bool, lossy: bool = False, het: bool = False,
                sar: bool = False, pml: PMLConfig | None = None, ade: bool = False, dft: DftConfig | None = None,
                psi_elems: list[int] | None = None) -> dict:
    """Device bytes of a sharded run, per device: of each shard (its arrays'
    ``shapes`` (k, j, i) with halos, its cell count, on its ``devices``
    entry) one state (two on ``stream``) and its parts of the material
    arrays, sigma and the SAR map; with ``pml`` its psi parts
    (``psi_elems``, elements per shard); in a Debye medium (``ade``) P, the
    15 maps (18 with SAR) and the fp32 work arrays over its box; with
    ``dft`` its part of the sums; per device the temporaries of the torch
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
            b += 8 * dft.nf * dft.nc * cells
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
             ade: bool = False, dft: DftConfig | None = None) -> bool:
    """The kernel takes the dtype and the scene, and the two states, with
    the material arrays (and two psi sets with CPML, two P sets with
    Debye media), fit in ``memory_bytes`` (default: the H100's 80 GB).
    Every plan's block fits an SM (at most 1024 threads and 45 KB of
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
        return ade_gates(p, het, pml) and stream_bytes(p, sar=sar, ade=True, dft=dft) <= MEMORY_MARGIN * mem
    lossy = lossy or het
    if lossy and p.mode != Mode.COMPUTATION:
        return False
    if sar and not lossy:
        return False  # vacuum deposits nothing: no SAR variant
    if pml is not None and not pml_gates(p, pml, het, sar):
        return False
    # the trailing n % s two-pass steps add the SAR increment's temporaries
    return stream_bytes(p, lossy, het, sar, pml, dft=dft) <= MEMORY_MARGIN * mem


def pick_plan(p: Params, s: int | None = None, memory_bytes: int | None = None,
              lossy: bool = False, het: bool = False, sar: bool = False,
              pml: PMLConfig | None = None, ade: bool = False, dft: DftConfig | None = None) -> StreamPlan | None:
    """Of the depths the variant's kernel is built at, the feasible plan
    with the fewest modelled bytes per cell and step (ties to the deeper
    sweep), or None.  A forced ``s`` is checked for feasibility like any
    other."""
    steps = (s,) if s is not None else tuple(_block_j(not ade and (lossy or het or sar), pml is not None, ade, sar,
                                                      dft is not None))
    cands = [plan_for(p, x, lossy, het, sar, pml, ade, dft=dft) for x in steps]
    if dft is not None:  # the bands' sums must fit in shared memory
        cands = [c for c in cands if c.dft_max_nf >= dft.nf]
    if not cands or not feasible(p, memory_bytes, lossy, het, sar, pml, ade, dft):
        return None
    return min(cands, key=lambda c: (c.bytes_per_cell_step, -c.s))


def supported(p: Params, memory_bytes: int | None = None, lossy: bool = False,
              het: bool = False, sar: bool = False, pml: PMLConfig | None = None,
              ade: bool = False, dft: DftConfig | None = None) -> bool:
    """True when some streaming plan fits (see :func:`pick_plan`)."""
    return pick_plan(p, memory_bytes=memory_bytes, lossy=lossy, het=het, sar=sar, pml=pml,
                     ade=ade, dft=dft) is not None
