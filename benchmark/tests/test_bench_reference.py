"""The plain reference against the program's torch backend at a tiny grid,
through the whole run of each cell (set-up, warm-up call, window, check);
a bfloat16 cell also against the stream backend's plain sweeps, the
reference's rounding cadence against the program's plan, and the fp32
reference's outputs pinned as they were before it learnt bfloat16."""

import hashlib

import numpy as np
import pytest
import torch

from conftest import BF16_WORKLOADS, TINY_CONFIG, WORKLOADS, tiny_traffic
from core import compare, run_cell, seeded
from core.cell import Cell, load_maps
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


def _reference_digest(workload: str, run_dir: str, seed: int = 20260101) -> str:
    """sha256 of the reference's outputs (fields, P, SAR map, probe rows,
    DFT sums, energies) over a tiny cell's warm-up steps."""
    cell = Cell(workload, config_over=TINY_CONFIG, traffic_over=tiny_traffic(workload))
    amp = cell.traffic["seeded_fields"]
    fields = seeded.seeded_fields(cell.grid, seed, amp["e_v_per_m"], amp["h_a_per_m"], "cpu")
    pol = run_cell.seeded_pol(cell, seed, load_maps(cell), "cpu")
    ckpt = seeded.write_checkpoint(run_dir, fields, cell.grid if cell.sar else None, pol)
    out = run_cell.reference_outputs(cell, ckpt, int(cell.traffic["warm_steps"]), "cpu", seed)
    h = hashlib.sha256()
    arrays = [out["state"][n] for n in seeded.COMPONENTS]
    arrays += [out["pol"][c] for c in "xyz"] if out["pol"] is not None else []
    arrays += [out[k] for k in ("power", "probes") if out[k] is not None]
    arrays += list(out["dft"]) if out["dft"] is not None else []
    for a in arrays:
        h.update(a.contiguous().numpy().tobytes())
    h.update(np.array([v for it in sorted(out["energy"]) for v in (it, *out["energy"][it])], np.float64).tobytes())
    return h.hexdigest()


# the fp32 reference's outputs for the cells before bfloat16, taken before the reference learnt it
@pytest.mark.parametrize("workload,digest", [
    ("oven_256.long", "564777f4838ab4b88d91d8fb060020f4445270075edaaf8b9d2c7bfe271ddd23"),
    ("oven_water_256.sar", "5cb2ec7eb01bb89f0648c3325fc9aee5f6a1e695f5a0419b9416ff9f5501b185"),
    ("oven_256.dft4", "4701df0f6fc0b110f1492671c888f3a55d40a7d1e764700e3a1f70c0e1cc53f1"),
    ("oven_water_256.probes", "3eee1937d39011c9b78635e8e06af646c4b17118556cbc38360a717a415582fa"),
    ("debye_256.sar", "46cae2e7c4024e96e98882f32b6b9013a9b53f9c9cc7d341a5d713b7a042f589"),
])
def test_fp32_reference_outputs_are_unchanged(tmp_path, workload, digest):
    assert _reference_digest(workload, str(tmp_path)) == digest


def _stream_at(monkeypatch, s: int) -> None:
    """Make the program take its stream backend on the CPU (the sweeps'
    plain versions, ``ops/stream.py::plain_sweep``) at ``s`` steps a sweep."""
    from fdtd_tpu_torch import runner
    from fdtd_tpu_torch.ops import stream_plan

    real = stream_plan.pick_plan
    monkeypatch.setattr(runner, "resolve_backend", lambda *a, **kw: "stream")
    monkeypatch.setattr(stream_plan, "pick_plan", lambda p, **kw: real(p, **dict(kw, s=s)))


def _bf16_plan_s(workload: str) -> int:
    """The sweep depth ``pick_plan`` gives the cell at its own size."""
    from fdtd_tpu_torch.ops import stream_plan

    cell = Cell(workload)
    prog = run_cell.Program(cell, torch.device("cpu"), "", cell.dtype)
    return stream_plan.pick_plan(prog.params(cell.output_every), lossy=True, sar=cell.sar).s


@pytest.mark.parametrize("workload", BF16_WORKLOADS)
def test_bf16_reference_follows_the_stream_sweeps_bit_for_bit(run_tiny, monkeypatch, workload):
    s = _bf16_plan_s(workload)
    _stream_at(monkeypatch, s)
    passed = []
    real = run_cell.reference_outputs
    monkeypatch.setattr(run_cell, "reference_outputs",
                        lambda *a: passed.append(a[-1]) or real(*a))
    said = []
    # whole sweeps in every chunk: output every 2 s steps
    r = run_tiny(workload, traffic_over={"output_every": 2 * s, "warm_steps": 4 * s}, say=said.append)
    assert passed == [s] and f"backend stream, s {s}," in said[0] and f"every {s} step(s)" in said[0], said[0]
    assert r["correct"], r["checks"]
    assert r["checks"]["state_err"]["value"] == 0 and r["checks"]["sar_err"]["value"] == 0, r["checks"]


def _rounding_gap(workload: str, steps: int, every_a: int, every_b: int) -> float:
    """The state gap of the bf16 reference stored every ``every_a`` and
    every ``every_b`` steps, from one seeded state of the tiny cell."""
    cell = Cell(workload, config_over=TINY_CONFIG, traffic_over=tiny_traffic(workload))
    amp = cell.traffic["seeded_fields"]
    f = seeded.seeded_fields(cell.grid, 7, amp["e_v_per_m"], amp["h_a_per_m"], "cpu")
    fields = {n: f[i].float().numpy() for i, n in enumerate(seeded.COMPONENTS)}
    outs = []
    for every in (every_a, every_b):
        sc = Scene(cell.grid, cell.box, cell.config["spatial_step_m"], cell.config["time_step_s"],
                   cell.config["source_hz"], cell.config["source_patch_m"], maps=load_maps(cell), sar=cell.sar,
                   output_every=steps, dtype=cell.dtype, round_every=every)
        outs.append(Reference(sc, "cpu").follow(fields, steps)["state"])
    return max(compare.rel_gap(outs[0][n], outs[1][n]) for n in seeded.COMPONENTS)


@pytest.mark.parametrize("workload", BF16_WORKLOADS)
def test_bf16_per_step_and_per_sweep_rounding_differ_above_the_limit(workload):
    s = _bf16_plan_s(workload)
    assert s > 1
    limit = Cell(workload).limits()["state_err"]
    assert _rounding_gap(workload, 4 * s, 1, s) > 10 * limit
    assert _rounding_gap(workload, 4 * s, s, 2 * s) > 10 * limit


@pytest.mark.parametrize("workload", BF16_WORKLOADS)
def test_bf16_coefficients_are_the_program_s(workload):
    from fdtd_tpu_torch import state

    cell = Cell(workload, config_over=TINY_CONFIG, traffic_over=tiny_traffic(workload))
    maps = load_maps(cell)
    prog = run_cell.Program(cell, torch.device("cpu"), "", cell.dtype)
    uc = state.update_coefs(prog.params(cell.output_every), prog.materials, "cpu")
    ref, fp32 = (Reference(Scene(cell.grid, cell.box, cell.config["spatial_step_m"], cell.config["time_step_s"],
                                 cell.config["source_hz"], cell.config["source_patch_m"], maps=maps, sar=True,
                                 dtype=dtype), "cpu") for dtype in ("bfloat16", "float32"))
    for c in "xyz":
        ca, cb = ref.coefs[c]
        assert getattr(uc, f"ca_{c}").dtype == torch.bfloat16
        assert torch.equal(ca, getattr(uc, f"ca_{c}").float()) and torch.equal(cb, getattr(uc, f"cb_{c}").float())
        assert len(torch.unique(cb)) > 2 and not torch.equal(ca, fp32.coefs[c][0])
    assert torch.equal(ref.sigma, uc.sigma_cells.float()) and float(ref.sigma.max()) == 1.703125


def test_a_bf16_run_without_its_plan_fails(run_tiny, monkeypatch):
    def unread(self, dtype=None):
        raise RuntimeError("no plan")

    monkeypatch.setattr(run_cell.Program, "plan", unread)
    said = []
    # an fp32 cell prints the failure and runs on: its reference rounds nothing
    assert run_tiny("oven_water_256.sar", say=said.append)["correct"]
    assert said[0].startswith("plan: not read (RuntimeError: no plan); the reference stores float32")
    for workload in BF16_WORKLOADS:
        with pytest.raises(RuntimeError, match="plan"):
            run_tiny(workload)


def test_cadence_comes_from_the_plan():
    assert run_cell.round_every("float32", None) == 1
    assert run_cell.round_every("float32", {"backend": "stream", "s": 4, "fold": None}) == 1
    assert run_cell.round_every("bfloat16", {"backend": "stream", "s": 4, "fold": None}) == 4
    assert run_cell.round_every("bfloat16", {"backend": "twopass", "s": None, "fold": None}) == 1
    with pytest.raises(RuntimeError):
        run_cell.round_every("bfloat16", None)


def test_bf16_scene_refuses_what_it_does_not_mirror():
    base = dict(grid=(8, 8, 8), box=(0.008,) * 3, dx=1e-3, dt=1e-12, source_hz=2.45e10, patch=(0.005, 0.005),
                dtype="bfloat16")
    with pytest.raises(ValueError, match="DFT"):
        Scene(**base, dft_hz=(2.45e10,))
    with pytest.raises(ValueError, match="between the stores"):
        Scene(**base, output_every=10, round_every=4)
    with pytest.raises(ValueError, match="storage"):
        Scene(**dict(base, dtype="float16"))
    ref = Reference(Scene(**base, output_every=8, round_every=4), "cpu")
    with pytest.raises(ValueError, match="between the stores"):
        ref.follow({n: np.zeros((9, 9, 9), np.float32) for n in seeded.COMPONENTS}, 6)
