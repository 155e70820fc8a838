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
sweep reads the six fields once per halo-amplified tile and writes them
once.  The sweep writes into a second state (blocks run concurrently, so
in place would race a neighbour's halo reads); a plan whose two states do
not fit in device memory is refused.
"""

from __future__ import annotations

import dataclasses
import math

from ..params import Params

STEPS = (8, 4, 2)  # steps per sweep, deepest first
SM_COUNT = 132  # H100 SXM
SMEM_PER_BLOCK = 227 * 1024  # opt-in shared memory of one block
DEVICE_BYTES = 80 * 10**9  # H100 80 GB, the default when no free size is given
MEMORY_MARGIN = 0.9  # share of device memory the two states may take
BLOCK_I = 32  # threads along i: one warp, consecutive addresses
# threads along j per steps-per-sweep; must match the instantiations in
# csrc/yee_stream.cu (s=8 keeps 6*9 fp32 level values a thread, so its
# block is smaller to leave each thread more registers)
BLOCK_J = {8: 24, 4: 32, 2: 32}
BLOCKS_WANTED = 2 * SM_COUNT  # split k until a sweep has this many blocks


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

    @property
    def blocks(self) -> int:
        return self.nk * self.nj * self.ni

    @property
    def threads(self) -> int:
        return self.bj * self.bi

    @property
    def smem_bytes(self) -> int:
        return 6 * self.bj * self.bi * 4  # one fp32 E plane and one H plane


def _itemsize(p: Params) -> int:
    return {"float32": 4, "bfloat16": 2, "float64": 8}[p.dtype]


def state_bytes(p: Params) -> int:
    return 6 * math.prod(p.padded_shape) * _itemsize(p)


def plan_for(p: Params, s: int) -> StreamPlan:
    """The tile geometry of ``s`` steps per sweep on the grid of ``p``."""
    if s not in STEPS:
        raise ValueError(f"steps per sweep must be one of {STEPS}; got {s}")
    K1, J1, I1 = p.padded_shape
    bj, bi = BLOCK_J[s], BLOCK_I
    tj, ti = bj - 2 * s, bi - 2 * s
    nj, ni = -(-J1 // tj), -(-I1 // ti)
    nk_want = max(1, -(-BLOCKS_WANTED // (nj * ni)))
    # a segment at least 2s planes deep keeps the lead-in below 2x
    tk = min(K1, max(-(-K1 // nk_want), 2 * s))
    nk = -(-K1 // tk)
    amp_ji = (bj * bi) / (tj * ti)
    amp_k = (tk + 2 * s) / tk if nk > 1 else 1.0
    per_step = 6 * _itemsize(p) * (amp_ji * amp_k + 1.0) / s
    return StreamPlan(s, tk, tj, ti, bj, bi, nk, nj, ni, per_step)


def feasible(p: Params, memory_bytes: int | None = None) -> bool:
    """The kernel takes the dtype, and the two states fit in
    ``memory_bytes`` (default: the H100's 80 GB).  Every plan's block fits
    an SM (at most 1024 threads and 24 KB of shared memory), so only the
    grid and the dtype decide."""
    if p.dtype not in ("float32", "bfloat16"):
        return False
    mem = DEVICE_BYTES if memory_bytes is None else memory_bytes
    return 2 * state_bytes(p) <= MEMORY_MARGIN * mem


def pick_plan(p: Params, s: int | None = None,
              memory_bytes: int | None = None) -> StreamPlan | None:
    """The feasible plan with the fewest modelled bytes per cell and step
    (ties to the deeper sweep), or None.  A forced ``s`` is checked for
    feasibility like any other."""
    cands = [plan_for(p, s)] if s is not None else [plan_for(p, x) for x in STEPS]
    if not feasible(p, memory_bytes):
        return None
    return min(cands, key=lambda c: (c.bytes_per_cell_step, -c.s))


def supported(p: Params, memory_bytes: int | None = None) -> bool:
    """True when some streaming plan fits (see :func:`pick_plan`)."""
    return pick_plan(p, memory_bytes=memory_bytes) is not None
