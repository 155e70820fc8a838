"""The comparison that decides ``correct``.

The program's outputs are held against the plain reference
(``reference/plain.py``) run from the same seeded state over the same
steps.  Each number is the widest gap between the two, as a share of
the reference's largest magnitude (or, for an energy, of the energy
itself), and has a limit of its own in ``limits/<workload>.json``.

    state_err   the six field components after the warm-up call
    energy_err  the energy log's records (electric and magnetic) of the
                warm-up call and of the window's call, up to the steps
                the reference follows
    sar_err     the SAR map after the warm-up call
    dft_err     the E phasor sums (re and im) after the warm-up call
    probe_err   the probe rows of the warm-up call and the window's
                first rows
    window_bad  records due in the window that are missing or not
                finite, and final outputs of the window that are not
                finite (limit 0)
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rel_gap(prog, ref: torch.Tensor) -> float:
    """max |prog - ref| / max |ref|, in fp64, on ``ref``'s device."""
    r = ref.to(torch.float64)
    p = torch.as_tensor(np.asarray(prog) if not isinstance(prog, torch.Tensor) else prog).to(r.device, torch.float64)
    scale = float(r.abs().max())
    gap = float((p - r).abs().max())
    if not math.isfinite(gap):
        return math.inf
    return gap / scale if scale > 0 else gap


def energy_gap(records: list[dict], ref_energy: dict) -> float:
    """The widest relative gap of the records' E and H energies to the
    reference's, over the iterations both have (inf where a record the
    reference has is missing)."""
    worst = 0.0
    for rec in records:
        by_it = {r["iteration"]: r for r in rec["log"]}
        for it, (e, h) in ref_energy.items():
            if it > rec["steps"]:
                continue
            r = by_it.get(it)
            if r is None:
                return math.inf
            for prog, want in ((r["E_energy"], e), (r["H_energy"], h)):
                g = abs(prog - want) / abs(want) if want else abs(prog)
                worst = max(worst, g if math.isfinite(g) else math.inf)
    return worst


def checks(warm: dict, window: dict, ref: dict, limits: dict) -> dict:
    """{name: {'value', 'limit'}} of every number the cell compares: the
    reference ran the warm-up call's steps, the window's first
    ``window['steps']`` of them are held against it too."""
    out = {}

    def put(name: str, value: float) -> None:
        if name not in limits:
            raise KeyError(f"no limit for {name!r} in this cell's limits file")
        out[name] = {"value": float(value), "limit": float(limits[name])}

    put("state_err", max(rel_gap(warm["state"][n], ref["state"][n]) for n in ref["state"]))
    put("energy_err", energy_gap([warm, window], ref["energy"]))
    if ref["power"] is not None:
        put("sar_err", rel_gap(warm["power"], ref["power"]))
    if ref["dft"] is not None:
        gaps = []
        for part, sums in zip(("re", "im"), ref["dft"]):
            prog = warm["dft"][part]
            gaps += [rel_gap(prog[q], sums[q]) for q in range(sums.shape[0])]
        put("dft_err", max(gaps))
    if ref["probes"] is not None:
        want = ref["probes"]
        gaps = [rel_gap(warm["probes"], want) if warm["probes"].shape == tuple(want.shape) else math.inf]
        rows = window["probes"]
        n = window["steps"]
        gaps.append(rel_gap(rows, want[:n]) if rows.shape == tuple(want[:n].shape) else math.inf)
        put("probe_err", max(gaps))
    put("window_bad", window["bad"])
    return out


def correct(found: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in found.values())
