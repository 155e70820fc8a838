"""The plain reference against the program's torch backend at a tiny grid,
through the whole run of each cell (set-up, warm-up call, window, check)."""

import numpy as np
import pytest
import torch

from conftest import WORKLOADS
from core import seeded
from core.cell import Cell
from reference.plain import Reference, Scene, energies, source_patch


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_agrees_with_the_torch_backend(run_tiny, workload):
    r = run_tiny(workload)
    assert r["correct"], r["checks"]
    for name, c in r["checks"].items():
        # fp32 on the same order of operations: the fields, maps, sums and rows agree exactly;
        # the energies differ by the program's fp32 sums against the reference's fp64 ones,
        # the DFT sums by the fp64 round trip of the phasors' 2/N
        tol = {"energy_err": 1e-6, "dft_err": 1e-15}.get(name, 0.0)
        assert c["value"] <= tol, (name, c)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in Cell(workload).end_to_end}
    assert {"device_peak_gib", "setup_s"} <= set(r["metrics"])
    assert ("mcells_per_s" in r["metrics"]) == (workload != "oven_water_256.probes")
    assert list(r)[-1] == "checks"


def test_seeded_fields_keep_walls_and_padding_zero():
    f = seeded.seeded_fields((6, 7, 8), 5, 1.0, 0.01, "cpu").float()
    K, J, I = 6, 7, 8
    ex, ey, ez, hx, hy, hz = f
    assert ex[:, :, I:].abs().max() == 0 and ex[0].abs().max() == 0 and ex[:, J].abs().max() == 0
    assert ey[:, :, 0].abs().max() == 0 and ey[K].abs().max() == 0 and ey[:, J:].abs().max() == 0
    assert ez[K:].abs().max() == 0 and ez[:, :, I].abs().max() == 0
    assert hx[:, :, 0].abs().max() == 0 and hy[:, J].abs().max() == 0 and hz[K].abs().max() == 0
    assert ex[1:K, 1:J, :I].abs().min() > 0 and hx.abs().max() <= 0.01 * (1 + 2 ** -8)  # bf16 rounding
    again = seeded.seeded_fields((6, 7, 8), 5, 1.0, 0.01, "cpu")
    other = seeded.seeded_fields((6, 7, 8), 6, 1.0, 0.01, "cpu")
    assert torch.equal(f, again.float()) and not torch.equal(f, other.float())


def test_checkpoint_round_trip_is_exact(tmp_path):
    f = seeded.seeded_fields((4, 5, 6), 2 ** 31 + 17, 1.0, 0.01, "cpu")
    path = seeded.write_checkpoint(str(tmp_path), f, (4, 5, 6))
    back = seeded.read_checkpoint_fields(path)
    for n, name in enumerate(seeded.COMPONENTS):
        assert np.array_equal(back[name], f[n].float().numpy())
    with np.load(path) as z:
        assert int(z["iteration"]) == 0 and float(z["t"]) == 0.0
        assert z["power_acc"].shape == (4, 5, 6) and not z["power_acc"].any()
        assert not [k for k in z.files if k.startswith("aux_")]


def test_seeded_polarization_is_zero_off_the_load_edges():
    K, J, I = 8, 9, 10
    d_eps = np.zeros((K, J, I))
    d_eps[2:5, 3:6, 4:8] = 74.9
    amp = seeded.polarization_amplitude(74.9, 1.0)
    pol = seeded.seeded_polarization((K, J, I), 2 ** 31 + 5, amp, d_eps, "cpu")
    assert pol.dtype == torch.bfloat16 and pol.shape == (3, K + 1, J + 1, I + 1)
    for n, axes in enumerate(((0, 1), (0, 2), (1, 2))):  # Px, Py, Pz: the cell axes each edge averages over
        # the edge average of d_eps in numpy: the wall cells repeated, then neighbours averaged
        edge = np.pad(d_eps, [(1, 1) if ax in axes else (0, 0) for ax in range(3)], mode="edge")
        for ax in axes:
            edge = 0.5 * (np.delete(edge, -1, axis=ax) + np.delete(edge, 0, axis=ax))
        on = np.zeros((K + 1, J + 1, I + 1), bool)
        on[:edge.shape[0], :edge.shape[1], :edge.shape[2]] = edge > 0
        p = pol[n].float().numpy()
        assert (p[~on] == 0).all() and (p[on] != 0).all()
        assert np.abs(p).max() <= amp * (1 + 2 ** -8)
    assert torch.equal(pol, seeded.seeded_polarization((K, J, I), 2 ** 31 + 5, amp, d_eps, "cpu"))
    assert not torch.equal(pol, seeded.seeded_polarization((K, J, I), 2 ** 31 + 6, amp, d_eps, "cpu"))


def test_checkpoint_carries_the_seeded_polarization(tmp_path):
    f = seeded.seeded_fields((4, 5, 6), 9, 1.0, 0.01, "cpu")
    d_eps = np.zeros((4, 5, 6))
    d_eps[1:3, 1:4, 2:5] = 74.9
    pol = seeded.seeded_polarization((4, 5, 6), 9, 1e-9, d_eps, "cpu")
    path = seeded.write_checkpoint(str(tmp_path), f, (4, 5, 6), pol)
    with np.load(path) as z:
        for n, key in enumerate(seeded.POL_KEYS):
            assert z[key].dtype == np.dtype("V2") and np.array_equal(seeded.widen(z[key]), pol[n].float().numpy())


def test_reference_source_and_energy_of_a_known_state():
    sc = Scene((16, 16, 16), (0.016, 0.016, 0.016), 0.001, 1e-12, 2.45e10, (0.005, 0.005))
    j0, j1, i0, i1, inv_z, profile = source_patch(sc)
    assert (j0, j1, i0, i1) == (4, 11, 4, 11) and profile[0] == 0.0 and inv_z > 0
    ref = Reference(sc, "cpu")
    f = {n: torch.zeros(sc.padded) for n in seeded.COMPONENTS}
    f["ex"][:, :, :] = 2.0  # every Ex edge 2: each cell mean 2, E energy eps0/2 * 4 * cells * dv
    e, h = energies(f, sc)
    assert np.isclose(e, 8.854e-12 / 2 * 4 * 16 ** 3 * 1e-9, rtol=1e-12) and h == 0.0
    out = ref.follow({n: t.numpy() for n, t in f.items()}, 3)
    assert out["state"]["ez"][0, j0:j1, i0:i1].abs().max() > 0  # the source drove the patch
    assert out["state"]["ex"][0, j0:j1, i0:i1].abs().max() == 0
