"""Snapshot assembly and asynchronous host writing.

The cell-centered aggregation runs on the device; ``SnapshotWriter.submit``
copies the aggregated arrays to the host on the calling thread and hands the
file encode and write to a worker pool, so the step loop does not wait on the
disk.  At most 2 snapshots are in flight.  ``close`` writes the ``.pvd``
catalog of the series for ParaView.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from .. import analytic, grid
from ..params import Params
from ..state import FieldState
from .checkpoint import to_host
from .native import write_vtr_native
from .vtr import write_vtr


def aggregate_all(p: Params, s: FieldState) -> dict[str, torch.Tensor]:
    """Zone-centered variables with the reference's names and semantics
    (reference: main.c:563-579)."""
    return {
        "ex": grid.aggregate_e(p, s.ex, "ex"),
        "ey": grid.aggregate_e(p, s.ey, "ey"),
        "ez": grid.aggregate_e(p, s.ez, "ez"),
        "hx": grid.aggregate_h(p, s.hx, "hx"),
        "hy": grid.aggregate_h(p, s.hy, "hy"),
        "hz": grid.aggregate_h(p, s.hz, "hz"),
    }


def validation_extras(p: Params, s: FieldState, t: float, quirk_compat: bool = True) -> dict[str, torch.Tensor]:
    """aEy/aHx/aHz zone-centered variables (reference: main.c:581-589).

    With ``quirk_compat`` (default) it replicates the reference, where aHx
    and aHz aggregate the computed Hx/Hz instead of the error fields
    (main.c:585-588), with the C-compat analytic formulas; otherwise all
    three are physics-correct (analytic - computed) error fields.
    """
    err = analytic.error_fields(p, s, t, ccompat=quirk_compat)
    a_ey = grid.aggregate_e(p, err["aEy"], "ey")
    if quirk_compat:
        a_hx = grid.aggregate_h(p, s.hx, "hx")
        a_hz = grid.aggregate_h(p, s.hz, "hz")
    else:
        a_hx = grid.aggregate_h(p, err["aHx"], "hx")
        a_hz = grid.aggregate_h(p, err["aHz"], "hz")
    return {"aEy": a_ey, "aHx": a_hx, "aHz": a_hz}


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

    def submit(self, variables: dict[str, torch.Tensor], iteration: int, t: float = 0.0) -> None:
        while len(self._inflight) >= 2:  # backpressure
            self._inflight.pop(0).result()
        fname = self.pattern % iteration
        self._series.append((t, fname))
        host = {k: to_host(v) for k, v in variables.items()}
        self._inflight.append(self._pool.submit(self._write, os.path.join(self.out_dir, fname), host))

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
