"""The sharded runs on the Hopper kernels: the two-pass kernels and the
streaming sweep per shard.

- :func:`~fdtd_tpu_torch.parallel.sharded_step.make_sharded_chunk_runner`
  with ``twopass`` is the counterpart of
  ``fdtd_tpu/parallel/sharded_fast.py::make_sharded_fast_step`` /
  ``_runner`` (:199, :396) and of the 2-D versions (:535, :763), with
  ``make_sharded_power_inc`` (:324, :676): per step, exchange E (the halo
  plane above each shard), K1 per shard, exchange H (below), K2 per
  shard, and with SAR the k-slab torch increment on each shard's owned
  cells; with CPML (``pml=``) the counterpart of
  ``fdtd_tpu/parallel/sharded_pml_fast.py::make_sharded_pml_fast_step`` /
  ``_runner`` (:341, :618): K10-shard per shard and pass (all twelve psi
  terms in the kernels on each shard's psi parts), the SAR as above; with
  the monitors K4-shard after each step (with CPML and the DFT the
  counterpart of ``make_sharded_pml_fast_dft_runner``, :658).
- :func:`make_sharded_stream_runner` is the counterpart of
  ``make_sharded_stream_step`` / ``_runner`` (:1470, :1686) and of
  ``make_sharded_stream_2d_step`` / ``_runner`` (:1137, :1335): per sweep,
  the step-1 source on every shard, one exchange of every field's ``s``
  halo planes (``s + 1`` above with SAR or the DFT bands, whose cell means
  read E one plane further), then one K3-shard launch per shard into the
  shard's second buffer, swapped back; the trailing ``n % s`` steps run
  the two-pass step, whose exchanges copy the one plane it reads.  With
  ``dft`` it is the counterpart of ``make_sharded_stream_dft_runner``
  (:1862): the sweeps carry the DFT bands (K3-shard-DFT) into each shard's
  part of the sums (past the frequencies the bands hold, their means mode:
  each shard buffers its cells' means and folds them into its part of the
  sums), and the trailing steps add theirs with K4-shard.  A 1-D z mesh
  and a 2-D z x y mesh run the same code: the kernel always tiles j and i
  with a recompute halo, so the TPU's j-tiled shard
  calls (``_build_stream_shard_call_jt``, :1728) need no counterpart.  The
  TPU's sharded temporal tiers (``make_sharded_temporal_step``/``_2d``,
  :801, :941) fold into this sweep at the depth a forced ``s`` gives.

:func:`pick_shard_plan` is the counterpart of ``pick_shard_plan`` (:1430),
``pick_shard_2d_s`` (:1508), ``_shard_config_gates`` (:1486) and
``sharded_stream_dft_supported`` (:1847): the gates of one device (lossy
and het-mu_r media need computation mode, SAR needs lossy media, the DFT
bands fields "e" in computation mode), the unsharded sweep's depth where
every shard owns at least its halo depth, and the shards' arrays fitting
every device's free memory (:func:`~fdtd_tpu_torch.ops.stream_plan.
shard_bytes`).
"""

from __future__ import annotations

import math

import torch

from ..dft import DftConfig
from ..ops import dft as dft_ops
from ..ops import stream, stream_plan
from ..params import Mode, Params
from ..source import sweep_drive_rows
from ..spans import PLAN, span
from ..state import FieldState, Materials
from .mesh import Mesh, Shard, exchange, shard_boxes
from .sharded_step import ShardContext, check_scene, make_step, run_chunk


def free_bytes(mesh: Mesh) -> dict:
    """Each CUDA device's free memory now (device -> bytes); CPU shards
    are left out, and plan as on one H100
    (:func:`~fdtd_tpu_torch.ops.stream_plan.shard_fits`)."""
    return {d: torch.cuda.mem_get_info(d)[0] for d in set(mesh.devices) if d.type == "cuda"}


def _gates(p: Params, lossy: bool, het: bool, sar: bool, dft: DftConfig | None) -> bool:
    """The scenes a shard sweeps: the single-device gates without memory."""
    if p.dtype not in ("float32", "bfloat16"):
        return False
    if (lossy or het) and p.mode != Mode.COMPUTATION:
        return False
    if dft is not None and not stream_plan.dft_gates(p, dft):
        return False
    return not sar or lossy or het


def pick_shard_plan(p: Params, mesh: Mesh, s: int | None = None, lossy: bool = False, het: bool = False,
                    sar: bool = False, free: dict | None = None,
                    dft: DftConfig | None = None) -> list[stream_plan.StreamPlan] | None:
    """Each shard's sweep plan (in the mesh's order) at the first depth,
    in the unsharded picker's order (the whole grid's modelled bytes, ties
    to the deeper sweep; a forced ``s`` alone), that the shards admit, or
    None: the scene fails the gates, a shard owns fewer planes than the
    halo depth (s, s + 1 with SAR or the DFT bands), or the shards do not
    fit the devices' ``free`` memory (device -> bytes; None:
    :func:`free_bytes` now).  With ``dft``, at each depth: its bands where
    they hold the frequencies, else their means mode with the deepest
    buffer that fits (``stream_plan.fold_depth``), as the unsharded picker
    takes them; a shallower depth only where the shards refuse this one
    (the vacuum bands at s = 2 serve shards too thin for the s = 4 halo).
    (Ranked by each shard's own bytes instead, bf16 lossy + SAR shards took
    s = 8, whose sweep spills and ran 2.6x slower a step than at s = 4 on
    an H100.)"""
    lossy = lossy or het or sar
    if not _gates(p, lossy, het, sar, dft):
        return None
    if free is None:
        free = free_bytes(mesh)
    depths = stream_plan.built_depths(lossy, dft is not None, shard=True)
    order = (s,) if s is not None else sorted(
        depths, key=lambda x: (stream_plan.plan_for(p, x, lossy, het, sar, dft=dft, bj=stream_plan.shard_block_j(
            lossy, dft is not None, x)).bytes_per_cell_step, -x))
    for x in order:
        if x not in depths:
            continue
        try:
            boxes = shard_boxes(p, mesh, x + int(sar or dft is not None))
        except ValueError:
            continue
        windows = [tuple(h - lo for lo, h in zip(b.own_lo, b.own_hi)) for b in boxes]
        cells = [(b.shape, math.prod(b.cell_shape(p))) for b in boxes]

        def fits(fold: int) -> bool:
            return stream_plan.shard_fits(stream_plan.shard_bytes(
                p, cells, mesh.devices, mesh.devices[0], True, lossy, het, sar, dft=dft, fold=fold), free)

        plans = [stream_plan.plan_for(p, x, lossy, het, sar, dft=dft, window=w) for w in windows]
        if dft is None or plans[0].dft_max_nf >= dft.nf:
            if fits(0):
                return plans
        elif fold := stream_plan.fold_depth(x, fits):  # the means mode
            return [stream_plan.plan_for(p, x, lossy, het, sar, dft=dft, window=w, fold=fold) for w in windows]
    return None


def make_sharded_stream_runner(p: Params, mesh: Mesh, materials: Materials | None = None,
                               accumulate_power: bool = False, s: int | None = None, free: dict | None = None,
                               dft: DftConfig | None = None):
    """``run(shards, xs)`` on the per-shard sweep (K3-shard; ``plain_sweep``
    on CPU shards): ``n // s`` sweeps, then ``n % s`` steps of the
    two-pass step, shards with ``run.depth`` halo planes (``s``, ``s + 1``
    with SAR or the DFT bands).  ``s`` forces the steps per sweep;
    ``run.plans`` are the shards' plans; ``free`` as in
    :func:`pick_shard_plan`.  With ``dft`` (fields "e"; ``xs = (times,
    amps, cw, sw)``) each shard's part of the sums takes every step: the
    sweeps' bands (K3-shard-DFT), then K4-shard after each trailing step.
    Raises ``ValueError`` where no plan fits."""
    check_scene(materials, accumulate_power)
    lossy = materials is not None and not materials.is_vacuum
    het = lossy and materials.mu_r is not None
    with span(PLAN):
        plans = pick_shard_plan(p, mesh, s, lossy, het, accumulate_power, free, dft)
    if plans is None:
        raise ValueError(
            f"no sharded stream plan fits {p.maxk}x{p.maxj}x{p.maxi} {p.dtype} on a {mesh.shape} mesh"
            f"{f' at s={s}' if s else ''}: each shard must own at least s planes (s + 1 with SAR or the DFT "
            "bands) along a sharded axis, materials stream in computation mode only, SAR needs materials, the "
            "DFT bands take fields 'e' in computation mode, and two states of every shard, with its DFT sums and "
            "means buffer, must fit its device; use --backend twopass"
        )
    s_steps = plans[0].s
    depth = s_steps + int(accumulate_power or dft is not None)
    ctx = ShardContext(p, mesh, shard_boxes(p, mesh, depth), materials, dft=dft)
    odd_step = make_step(ctx, "twopass", accumulate_power)
    spare: dict[int, FieldState] = {}  # each shard's second buffer, at first use
    fold = plans[0].fold
    means_buf: dict[int, torch.Tensor] = {}  # the means mode: each shard's buffer, at first use

    def _fold(shards: list[Shard], bufs: dict, w: dict, end: int, level: int) -> None:
        """Fold each shard's buffered levels (the steps before ``end``)
        into its part of the sums."""
        for q, sh in enumerate(shards):
            dft_ops.fold(bufs[q], w[sh.device][end - level:end], sh.dacc)

    def run(shards: list[Shard], xs) -> list[Shard]:
        ts, amps_h = xs[:2]
        n = len(ts)
        n_sw = n // s_steps
        amps = ctx.amps(amps_h)
        w = ctx.weights(xs)
        if n_sw:
            drives = {}
            if ctx.src is not None:
                for d, a in amps.items():
                    ez_rows, hx_rows = sweep_drive_rows(ctx.src, a, s_steps, shards[0].state.ex.dtype,
                                                        ctx.profile[d])
                    drives[d] = (ez_rows, hx_rows)
            for q, sh in enumerate(shards):
                out = spare.get(q)
                if out is None or out.ex.shape != sh.state.ex.shape or out.ex.dtype != sh.state.ex.dtype:
                    spare[q] = FieldState(*(torch.empty_like(t) for t in sh.state.tensors()))
                if fold and q not in means_buf:
                    means_buf[q] = torch.empty(stream.means_shape(p, fold, sh.box), dtype=torch.float32,
                                               device=sh.device)
            level = 0  # the means mode's levels in every shard's buffer
            for g in range(n_sw):
                ctx.source(shards, amps, g * s_steps)
                exchange(mesh, shards)
                if level == fold > 0:
                    _fold(shards, means_buf, w, g * s_steps, level)
                    level = 0
                for q, (sh, cf, plan) in enumerate(zip(shards, ctx.coefs, plans)):
                    drive = None
                    if ctx.src is not None:
                        ez_rows, hx_rows = drives[sh.device]
                        drive = stream.SweepDrive(ctx.src.patch, ez_rows[g], hx_rows[g])
                    if fold:
                        stream.sweep(p, sh.state, spare[q], cf, plan, drive, sh.power, box=sh.box,
                                     means=means_buf[q][level:level + s_steps])
                    else:
                        wts = w[sh.device][g * s_steps:(g + 1) * s_steps] if w is not None else None
                        stream.sweep(p, sh.state, spare[q], cf, plan, drive, sh.power, dacc=sh.dacc, wts=wts,
                                     box=sh.box)
                    sh.state.swap(spare[q])
                level += s_steps if fold else 0
            if level:  # the chunk's last levels, before the trailing steps add theirs
                _fold(shards, means_buf, w, n_sw * s_steps, level)
        return run_chunk(ctx, odd_step, shards, xs, n_sw * s_steps, amps, w)

    run.depth = depth
    run.plans = plans
    run.backend = "stream"
    return run
