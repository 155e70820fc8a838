"""Snapshot assembly and asynchronous host writing.

The cell-centered aggregation runs on the device a k slab at a time
(``diagnostics.output_slabs``), and each slab is copied to the host as it
is made, so a snapshot's device temporaries are a slab's, not six
full-grid cell arrays; ``SnapshotWriter.submit`` takes the host arrays and
hands the file encode and write to a worker pool, so the step loop does
not wait on the disk.  At most 2 snapshots are in flight.  ``close``
writes the ``.pvd`` catalog of the series for ParaView.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from .. import analytic, grid
from ..diagnostics import output_slabs
from ..params import Params
from ..state import FieldState
from .checkpoint import to_host
from .native import write_vtr_native
from .vtr import write_vtr


def _host_cells(p: Params, like: torch.Tensor) -> np.ndarray:
    """An empty host (maxk, maxj, maxi) array of the host dtype of ``like``
    (bfloat16 widens to float32, as :func:`to_host` does)."""
    dt = np.float32 if like.dtype in (torch.bfloat16, torch.float32) else np.float64
    return np.empty((p.maxk, p.maxj, p.maxi), dtype=dt)


def aggregate_all(p: Params, s: FieldState) -> dict[str, np.ndarray]:
    """Zone-centered variables with the reference's names and semantics
    (reference: main.c:563-579), as host arrays: aggregated on the device
    a k slab at a time (the same bits as one whole-grid aggregation)."""
    out = {c: _host_cells(p, getattr(s, c)) for c in ("ex", "ey", "ez", "hx", "hy", "hz")}
    for k_lo, k_hi in output_slabs(p):
        kr = (k_lo, k_hi)
        for c in ("ex", "ey", "ez"):
            out[c][k_lo:k_hi] = to_host(grid.aggregate_e(p, getattr(s, c), c, kr))
        for c in ("hx", "hy", "hz"):
            out[c][k_lo:k_hi] = to_host(grid.aggregate_h(p, getattr(s, c), c, kr))
    return out


def validation_extras(p: Params, s: FieldState, t: float, quirk_compat: bool = True) -> dict[str, np.ndarray]:
    """aEy/aHx/aHz zone-centered variables (reference: main.c:581-589), as
    host arrays made a k slab at a time.

    With ``quirk_compat`` (default) it replicates the reference, where aHx
    and aHz aggregate the computed Hx/Hz instead of the error fields
    (main.c:585-588), with the C-compat analytic formulas; otherwise all
    three are physics-correct (analytic - computed) error fields.
    """
    out = {name: _host_cells(p, s.ey) for name in ("aEy", "aHx", "aHz")}
    for k_lo, k_hi in output_slabs(p):
        # the error fields of the planes this slab's cells read (k_lo..k_hi)
        err = analytic.error_fields(p, s, t, ccompat=quirk_compat, k_range=(k_lo, k_hi + 1))
        local = (0, k_hi - k_lo)
        out["aEy"][k_lo:k_hi] = to_host(grid.aggregate_e(p, err["aEy"], "ey", local))
        if quirk_compat:
            out["aHx"][k_lo:k_hi] = to_host(grid.aggregate_h(p, s.hx, "hx", (k_lo, k_hi)))
            out["aHz"][k_lo:k_hi] = to_host(grid.aggregate_h(p, s.hz, "hz", (k_lo, k_hi)))
        else:
            out["aHx"][k_lo:k_hi] = to_host(grid.aggregate_h(p, err["aHx"], "hx", local))
            out["aHz"][k_lo:k_hi] = to_host(grid.aggregate_h(p, err["aHz"], "hz", local))
        del err
    return out


class SnapshotWriter:
    """Double-buffered asynchronous ``.vtr`` writer."""

    def __init__(self, p: Params, out_dir: str, pattern: str = "result%04d.vtr"):
        self.out_dir = out_dir
        self.pattern = pattern
        self.coords = grid.node_coords(p)
        os.makedirs(out_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._inflight: list[Future] = []
        self._series: list[tuple[float, str]] = []  # (time, filename)

    def submit(self, variables: dict[str, np.ndarray], iteration: int, t: float = 0.0) -> None:
        """Write the host arrays of :func:`aggregate_all` (and
        :func:`validation_extras`) as one snapshot; they must not change
        until the file is written."""
        while len(self._inflight) >= 2:  # backpressure
            self._inflight.pop(0).result()
        fname = self.pattern % iteration
        self._series.append((t, fname))
        self._inflight.append(self._pool.submit(self._write, os.path.join(self.out_dir, fname), variables))

    def _write(self, path: str, host: dict[str, np.ndarray]) -> None:
        if not write_vtr_native(path, self.coords, host):
            write_vtr(path, self.coords, host)

    def close(self) -> None:
        try:
            for f in self._inflight:
                f.result()
        finally:
            self._inflight.clear()
            self._pool.shutdown(wait=True)
        self._write_series_index()

    def _write_series_index(self) -> None:
        """ParaView .pvd catalog: the snapshot series with physical times."""
        if not self._series:
            return
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">',
            "  <Collection>",
        ]
        for t, fname in self._series:
            lines.append(f'    <DataSet timestep="{t!r}" group="" part="0" file="{fname}"/>')
        lines += ["  </Collection>", "</VTKFile>", ""]
        with open(os.path.join(self.out_dir, "series.pvd"), "w") as f:
            f.write("\n".join(lines))
