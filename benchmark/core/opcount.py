"""Floating-point operations a step of a cell needs, counted once from
the plain reference's update (``reference/plain.py``): each add,
subtract, multiply and divide of an element is one operation, a sum over n
elements n - 1.  What the program runs in place of an operation (a
fused multiply-add, a sweep that keeps several steps in registers) does
not change the count, so the share of the card's peak reads the same
work whatever implements it.

Not counted: the source's drive rows (fp64 on the host, 2 x (i1 - i0)
values a step) and copies.
"""

from __future__ import annotations

from .cell import is_debye

# NVIDIA's data sheet for the H100 SXM, dense fp32 outside the tensor
# cores, at the card's 700 W limit
PEAK_FP32_FLOPS = 67e12


def parts(grid: tuple[int, int, int], lossy: bool, sar: bool, nf: int, n_probes: int, ade: bool = False) -> dict:
    """Operations of one step, by layer, and of one energy record
    (``ade``: a Debye load, whose E update and SAR are its own)."""
    K, J, I = grid
    cells = K * J * I
    # H: (E - E') - (E - E') scaled and added, 5 a value
    h = 5 * (K * J * (I + 1) + K * (J + 1) * I + (K + 1) * J * I)
    edges = (K - 1) * (J - 1) * I + (K - 1) * J * (I - 1) + K * (J - 1) * (I - 1)
    # E inside the walls: 3 subtracts, cb times the curl, plus E (times ca when lossy);
    # Debye: ca E + cb curl + cp P (8 with the curl), then P' = k1 P + k2 (E' + E) (4)
    e = (12 if ade else 6 if lossy else 5) * edges
    # the cell means of E: 3 adds and a multiply each of three
    means = 12 * cells
    if ade:
        # a work density an edge, E_mid ((P' - P) / dt + sigma E_mid) with E_mid = (E' + E) / 2
        # (7), then the three cell means of the work (12), summed (2), times dt, added
        sar_ops = (7 * edges + means + 2 * cells + 2 * cells) if sar else 0
    else:
        # |E|^2 (3 multiplies, 2 adds), times sigma, times dt, added
        sar_ops = (means + 5 * cells + 3 * cells) if sar else 0
    return {
        "h": h,
        "e": e,
        "sar": sar_ops,
        # per frequency and component: cos times E added, sin times E subtracted
        "dft": (means + 12 * nf * cells) if nf else 0,
        # six means a probe: E 4 each, H 2 each
        "probes": 18 * n_probes,
        # a record: the E means, the H means (an add and a multiply each of
        # three), squared and summed per component
        "energy_record": means + 6 * cells + 6 * cells + 6 * (cells - 1),
    }


def per_step(grid, lossy: bool, sar: bool, nf: int, n_probes: int, output_every: int, ade: bool = False) -> float:
    """Operations a step, the energy log's share included."""
    p = parts(grid, lossy, sar, nf, n_probes, ade)
    return p["h"] + p["e"] + p["sar"] + p["dft"] + p["probes"] + p["energy_record"] / output_every


def for_cell(cell) -> float:
    """:func:`per_step` of a :class:`~core.cell.Cell`."""
    ade = is_debye(cell)
    return per_step(cell.grid, cell.config.get("load") is not None and not ade, cell.sar, len(cell.dft_hz),
                    len(cell.probes), cell.output_every, ade)
