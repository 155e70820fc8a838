"""A cell of the benchmark: its entry in BENCHMARK.json, its configuration
file and its traffic file, found by name.

    configs/<config>.json   the deployment: box, grid step, time step,
                            source, load, dtype
    traffic/<traffic>.json  what one run does: output cadence, warm-up
                            steps, SAR map, DFT frequencies, probes, the
                            amplitudes of the seeded fields
    limits/<workload>.json  the limit of each number the check compares
    metrics/<metric>.py     the reader of one per-layer metric; a metric
                            <reader>.<part> without a file of its own (one
                            quantity split by the end-to-end metric it
                            moves) is read by metrics/<reader>.py

Nothing here imports the program.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _named(kind: str, name: str) -> Path:
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    return path


def _merge(base: dict, over: dict | None) -> dict:
    out = copy.deepcopy(base)
    out.update(over or {})
    return out


class Cell:
    """One workload with its configuration and traffic (``config_over``,
    ``traffic_over``: keys replaced in either, for the CPU tests' tiny
    grids and the control's dtype)."""

    def __init__(self, workload: str, config_over: dict | None = None, traffic_over: dict | None = None):
        bench = load_benchmark()
        found = [w for w in bench["workloads"] if w["name"] == workload]
        if not found:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = workload
        self.chips = int(self.entry["chips"])
        self.config = _merge(json.loads(_named("configs", self.entry["config"]).read_text()), config_over)
        self.traffic = _merge(json.loads(_named("traffic", self.entry["traffic"]).read_text()), traffic_over)
        self.per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
        self.end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]

    def limits(self) -> dict:
        return json.loads(_named("limits", self.name).read_text())

    # the grid, as the reference's parser derives it (main.c:237-239): the
    # box sizes pass through C float, the steps stay double
    @property
    def box(self) -> tuple[float, float, float]:
        return tuple(float(np.float32(v)) for v in self.config["box_m"])

    @property
    def grid(self) -> tuple[int, int, int]:
        """(maxk, maxj, maxi)."""
        lx, ly, lz = self.box
        dx = float(self.config["spatial_step_m"])
        return int(lz / dx), int(ly / dx), int(lx / dx)

    @property
    def cells(self) -> int:
        k, j, i = self.grid
        return k * j * i

    @property
    def dtype(self) -> str:
        return self.config["dtype"]

    @property
    def output_every(self) -> int:
        return int(self.traffic["output_every"])

    @property
    def sar(self) -> bool:
        return bool(self.traffic["sar"])

    @property
    def dft_hz(self) -> tuple[float, ...]:
        return tuple(float(f) for f in self.traffic["dft_hz"])

    @property
    def probes(self) -> tuple[tuple[int, int, int], ...]:
        return tuple(tuple(int(c) for c in cell) for cell in self.traffic["probes"])

    def check_grid(self) -> None:
        want = self.config.get("cells")
        if want is not None and list(reversed(self.grid)) != list(want):
            raise ValueError(f"{self.name}: the box and step give {list(reversed(self.grid))} cells, "
                             f"the configuration states {want}")


def simulation_time(time_step: float, steps: int) -> float:
    """A simulation time whose loop (``while t <= T: t += dt``) runs
    exactly ``steps`` steps."""
    limit = (steps - 0.5) * time_step
    t, n = 0.0, 0
    while t <= limit:
        n += 1
        t += time_step
    if n != steps:
        raise ValueError(f"a simulation time for {steps} steps of {time_step} s gave {n}")
    return limit


LOAD_KINDS = ("block", "debye_block")


def load_mask(cell: Cell) -> np.ndarray | None:
    """Boolean (maxk, maxj, maxi) mask of the configuration's load block,
    or None: the cells [int(lo*n), int(hi*n)) of each axis, lo and hi
    given as (x, y, z) fractions."""
    load = cell.config.get("load")
    if not load:
        return None
    if load["kind"] not in LOAD_KINDS:
        raise ValueError(f"unknown load kind {load['kind']!r}")
    K, J, I = cell.grid
    lo, hi = load["lo"], load["hi"]
    mask = np.zeros((K, J, I), dtype=bool)
    mask[int(lo[2] * K):int(hi[2] * K), int(lo[1] * J):int(hi[1] * J), int(lo[0] * I):int(hi[0] * I)] = True
    return mask


def is_debye(cell: Cell) -> bool:
    """Whether the configuration's load is a single-pole Debye medium."""
    load = cell.config.get("load")
    return bool(load) and load["kind"] == "debye_block"


def load_maps(cell: Cell) -> tuple[np.ndarray, ...] | None:
    """The fp64 cell maps of the load, or None in an empty cavity: a
    ``block`` gives (eps_r, sigma); a ``debye_block`` gives (eps_inf,
    sigma, d_eps, tau), the medium eps_inf + d_eps / (1 + i w tau) with the
    ionic conductivity sigma, and (1, 0, 0, 0) outside the block."""
    mask = load_mask(cell)
    if mask is None:
        return None
    load = cell.config["load"]
    if is_debye(cell):
        return (np.where(mask, float(load["eps_inf"]), 1.0), np.where(mask, float(load["sigma_s_per_m"]), 0.0),
                np.where(mask, float(load["d_eps"]), 0.0), np.where(mask, float(load["tau_s"]), 0.0))
    return (np.where(mask, float(load["eps_r"]), 1.0), np.where(mask, float(load["sigma_s_per_m"]), 0.0))
