"""The device mesh of a spatially sharded run, its shards and their halo
exchange.

The counterpart of ``fdtd_tpu/parallel/mesh.py`` and of the halo parts of
``fdtd_tpu/parallel/sharded_step.py`` (``_grid_ops.shift_up/shift_down``)
and ``sharded_fast.py`` (the ``exchange`` closures, ``to_sharded_fast`` /
``from_sharded_fast``).  The JAX mesh is single-controller: one process
drives every device and the halos ride ``lax.ppermute``.  The port's mesh
is in-process too:

- a (nz, ny, nx) grid of ``torch.device``s (:func:`make_mesh`), each shard
  owning a block of the canonical (k, j, i) planes (:func:`owned_ranges`:
  the share of :func:`padded_divisible_shape`, the last shard the rest);
- each shard's fields in arrays of its own, a :class:`~fdtd_tpu_torch.
  grid.Box`: its owned planes plus ``depth`` halo planes on each side it
  shares with a neighbour, i fastest (no dead slab, no lane strips);
- the exchange (:func:`exchange`) is a tensor copy between neighbours' halo
  planes, a peer copy across devices;
- beside the fields, each shard holds its parts of the run's other state
  (:class:`Shard`): the SAR map and the DFT sums over its owned cells, the
  CPML psi parts of its owned window (:func:`~fdtd_tpu_torch.ops.cpml.
  psi_part_slices`) and the Debye polarization over its box.  :func:`scatter`
  cuts them from the canonical arrays and :func:`gather` writes them back,
  so a run keeps the canonical layout (its checkpoints) and gathers only
  where an output is due.

It is not ``torch.distributed``: NCCL cannot put two ranks on one GPU and
gloo cannot send CUDA tensors, so a multi-process mesh could not run on one
card.  With fewer CUDA devices than shards, the shards go round-robin onto
the visible devices, with a notice; they never move to the CPU unless the
caller asks for it (``device="cpu"``), unlike the JAX package's virtual-CPU
fallback.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..grid import COMPONENTS, Box
from ..ops.cpml import PMLConfig, PsiState, cut_psi, join_psi
from ..ops.dispersive import PolState
from ..params import Params
from ..spans import HALO_EXCHANGE, span
from ..state import FieldState

AXES = ("z", "y", "x")


def factor3(n: int) -> tuple[int, int, int]:
    """Split n into 3 factors, as cubic as possible, z-major."""
    best = (n, 1, 1)
    best_cost = float("inf")
    for a in range(1, n + 1):
        if n % a:
            continue
        m = n // a
        for b in range(1, m + 1):
            if m % b:
                continue
            c = m // b
            cost = max(a, b, c) / min(a, b, c)
            if cost < best_cost:
                best_cost = cost
                best = tuple(sorted((a, b, c), reverse=True))
    return best


def padded_divisible_shape(p: Params, shape: tuple[int, int, int]) -> tuple[int, int, int]:
    """Global shape, padded up so each (k, j, i) axis divides the mesh axis
    (the JAX package's layout; here each shard but the last owns
    ``padded // parts`` planes, and nothing is padded)."""
    up = lambda v, m: ((v + m - 1) // m) * m  # noqa: E731
    return tuple(up(v, m) for v, m in zip(p.padded_shape, shape))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` = (nz, ny, nx) shards; ``devices`` one per shard, in C
    order of the shard index (iz, iy, ix)."""

    shape: tuple[int, int, int]
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def index(self, flat: int) -> tuple[int, int, int]:
        nz, ny, nx = self.shape
        return (flat // (ny * nx), (flat // nx) % ny, flat % nx)


def make_mesh(shape: tuple[int, int, int], device="cuda", log: Callable[[str], None] | None = None) -> Mesh:
    """The (nz, ny, nx) mesh on ``device``'s type: on ``cuda`` every visible
    CUDA device (only the given one for ``cuda:N``), round-robin when there
    are fewer than shards (with a notice through ``log``); on ``cpu``
    every shard on the CPU."""
    shape = tuple(int(x) for x in shape)
    if len(shape) != 3 or any(x < 1 for x in shape):
        raise ValueError(f"a mesh shape is three positive counts (nz, ny, nx); got {shape}")
    n = math.prod(shape)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available on this machine; pass --device cpu (device='cpu') to run "
                               "the shards on the host")
        pool = [dev] if dev.index is not None else [torch.device("cuda", q) for q in range(torch.cuda.device_count())]
        if len(pool) < n and log is not None:
            log(f"notice: {n} shards on {len(pool)} CUDA device(s): the shards share them round-robin")
        return Mesh(shape, tuple(pool[q % len(pool)] for q in range(n)))
    return Mesh(shape, (dev,) * n)


def owned_ranges(p: Params, shape: tuple[int, int, int], depth: int) -> list[list[tuple[int, int]]]:
    """Per axis, the (lo, hi) planes of each shard of a ``shape`` mesh: the
    share of :func:`padded_divisible_shape` each, the last shard the rest.
    Raises ``ValueError`` where a shard would own nothing, or fewer planes
    than a neighbour's ``depth`` halo reads."""
    out = []
    for n, parts, padded, axis in zip(p.padded_shape, shape, padded_divisible_shape(p, shape), AXES):
        share = padded // parts
        ranges = [(q * share, min(n, (q + 1) * share)) for q in range(parts)]
        if ranges[-1][0] >= n or (parts > 1 and share < depth):
            raise ValueError(f"{parts} shards along {axis} are too many for its {n} planes: each shard needs at "
                             f"least {max(depth, 1)} plane(s) of its own (a neighbour's halo reads {depth}), and "
                             f"{share} a shard leave {max(n - (parts - 1) * share, 0)} to the last")
        out.append(ranges)
    return out


def shard_boxes(p: Params, mesh: Mesh, depth: int) -> list[Box]:
    """Each shard's box, in the mesh's order: its owned planes and ``depth``
    halo planes on each side it shares (clipped to the grid)."""
    ranges = owned_ranges(p, mesh.shape, depth)
    boxes = []
    for q in range(mesh.size):
        own = [ranges[a][x] for a, x in enumerate(mesh.index(q))]
        lo = tuple(max(0, o[0] - depth) if parts > 1 else o[0] for o, parts in zip(own, mesh.shape))
        hi = tuple(min(n, o[1] + depth) if parts > 1 else o[1]
                   for o, parts, n in zip(own, mesh.shape, p.padded_shape))
        boxes.append(Box(lo, hi, tuple(o[0] for o in own), tuple(o[1] for o in own)))
    return boxes


@dataclasses.dataclass
class Shard:
    """One shard: its device, its box, its fields (the box's arrays) and
    its parts of the other state: with SAR the fp32 map over its owned
    cells, with CPML its psi parts, in a Debye medium the polarization over
    its box, with the DFT the (re, im) sums over its owned cells."""

    device: torch.device
    box: Box
    state: FieldState
    power: torch.Tensor | None = None
    psi: PsiState | None = None
    pol: PolState | None = None
    dacc: tuple[torch.Tensor, torch.Tensor] | None = None


def part(t: torch.Tensor, lo, hi, device) -> torch.Tensor:
    """A contiguous copy of the global block [lo, hi) of ``t`` (its last
    three axes) on ``device``."""
    view = t[(...,) + tuple(slice(a, b) for a, b in zip(lo, hi))]
    return torch.empty(view.shape, dtype=view.dtype, device=device).copy_(view)


def _cells(p: Params, box: Box) -> tuple:
    lo, hi = box.cells(p)
    return (...,) + tuple(slice(a, b) for a, b in zip(lo, hi))


def scatter(p: Params, state: FieldState, mesh: Mesh, depth: int, power: torch.Tensor | None = None,
            psi: PsiState | None = None, pml: PMLConfig | None = None, pol: PolState | None = None,
            dacc=None) -> list[Shard]:
    """The canonical ``state`` cut into the mesh's shards with
    ``depth``-plane halos (copies; the halos hold the neighbours' values),
    with the parts of the SAR map ``power``, the CPML ``psi`` (of ``pml``),
    the polarization ``pol`` and the DFT sums ``dacc`` that are given."""
    shards = []
    for box, dev in zip(shard_boxes(p, mesh, depth), mesh.devices):
        fields = FieldState(*(part(t, box.lo, box.hi, dev) for t in state.tensors()))
        sh = Shard(dev, box, fields)
        if power is not None:
            sh.power = part(power, *box.cells(p), dev)
        if psi is not None:
            sh.psi = cut_psi(p, pml, psi, box, dev)
        if pol is not None:
            sh.pol = PolState(*(part(t, box.lo, box.hi, dev) for t in pol.tensors()))
        if dacc is not None:
            sh.dacc = tuple(part(t, *box.cells(p), dev) for t in dacc)
        shards.append(sh)
    return shards


def gather(p: Params, shards: list[Shard], state: FieldState, power: torch.Tensor | None = None,
           psi: PsiState | None = None, pml: PMLConfig | None = None, pol: PolState | None = None,
           dacc=None) -> None:
    """Write every shard's owned planes into the canonical ``state`` in
    place, and its parts into those of ``power``, ``psi`` (of ``pml``),
    ``pol`` and ``dacc`` that are given."""
    for sh in shards:
        own = tuple(slice(a, b) for a, b in zip(sh.box.own_lo, sh.box.own_hi))
        for dst, src in zip(state.tensors(), sh.state.tensors()):
            dst[own].copy_(src[sh.box.owned])
        if power is not None:
            power[_cells(p, sh.box)].copy_(sh.power)
        if psi is not None:
            join_psi(p, pml, sh.psi, sh.box, psi)
        if pol is not None:
            for dst, src in zip(pol.tensors(), sh.pol.tensors()):
                dst[own].copy_(src[sh.box.owned])
        if dacc is not None:
            for dst, src in zip(dacc, sh.dacc):
                dst[_cells(p, sh.box)].copy_(src)


HALO_LABEL = HALO_EXCHANGE  # the profiler span of the halo copies


def exchange(mesh: Mesh, shards: list[Shard], names=COMPONENTS, sides=("lo", "hi"),
             planes: int | None = None, arrays: Callable | None = None) -> None:
    """Fill the halo planes of the fields ``names`` from the neighbours'
    owned planes: ``"hi"`` the halos above each shard's owned planes (E
    before the H pass, which reads E at +1), ``"lo"`` those below (H before
    the E pass); ``planes``: only that many next to the owned window (None:
    the whole halo).  Axes go i, j, k, each copy over the whole extent of
    the other axes, so the halo corners hold the diagonal neighbours'
    values.  ``arrays(shard, name)`` picks other arrays of the box's shape
    (default: the shard's field ``name``)."""
    arrays = arrays or (lambda sh, name: getattr(sh.state, name))
    nz, ny, nx = mesh.shape
    stride = (ny * nx, nx, 1)
    with span(HALO_LABEL):
        for a in (2, 1, 0):
            if mesh.shape[a] == 1:
                continue
            for q, lower in enumerate(shards):
                if mesh.index(q)[a] == mesh.shape[a] - 1:
                    continue
                upper = shards[q + stride[a]]
                pairs = []
                if "hi" in sides:  # lower's planes above its own, from upper
                    g0 = lower.box.own_hi[a]
                    pairs.append((lower, upper, g0, lower.box.hi[a] if planes is None else
                                  min(lower.box.hi[a], g0 + planes)))
                if "lo" in sides:  # upper's planes below its own, from lower
                    g1 = upper.box.own_lo[a]
                    pairs.append((upper, lower, upper.box.lo[a] if planes is None else
                                  max(upper.box.lo[a], g1 - planes), g1))
                for dst, src, g0, g1 in pairs:
                    for name in names:
                        d, s_ = arrays(dst, name), arrays(src, name)
                        d.narrow(a, g0 - dst.box.lo[a], g1 - g0).copy_(s_.narrow(a, g0 - src.box.lo[a], g1 - g0))
