"""The port's design sweeps and stability map (fdtd_tpu_torch/sweep.py,
utils/stability.py) against the JAX package's (fdtd_tpu/sweep.py,
utils/stability.py).

- ``frequency_sweep`` and ``material_sweep`` in fp64 against the JAX
  package (vmap over xla steps): the states and the per-member energies at
  atol 1e-15 / rtol 1e-11 (both step each member in the reference order;
  the energies are reductions in another order).  The same on a batch mesh
  (8 and 4 members over the devices; the port's CPU mesh puts every member
  on the host), on a spatial (b, z) mesh (each member's grid in z slabs
  through the port's sharded step), and for CPML members (a gaussian drive,
  so the amplitudes go through ``drive_values``).  A batch that does not
  divide over a batch mesh, CPML with a spatial mesh, CPML on the kernels
  and an unknown backend are refused with the JAX package's messages.
- fp32 ``backend="pallas_fused"`` (the batched K1/K2; their plain versions
  on CPU tensors) equal bit for bit to single ``run_simulation`` runs at
  each frequency, and to the members' own ``twopass`` steps; the JAX
  backend names map with the runner's notice.
- ``stability_map``: the same classification as the JAX package's, the
  energy growth at rtol 1e-9 where the run is stable (an unstable run's
  growth amplifies rounding, so there both only cross the bar).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import sweep as js  # noqa: E402
from fdtd_tpu.ops.cpml import PMLConfig as JPMLConfig  # noqa: E402
from fdtd_tpu.params import Mode, SourceConfig  # noqa: E402
from fdtd_tpu.state import water_block  # noqa: E402
from fdtd_tpu.utils.stability import stability_map as j_stability_map  # noqa: E402
from fdtd_tpu_torch import convert, runner  # noqa: E402
from fdtd_tpu_torch import sweep as ts  # noqa: E402
from fdtd_tpu_torch.ops import stream_plan, yee  # noqa: E402
from fdtd_tpu_torch.ops.cpml import PMLConfig  # noqa: E402
from fdtd_tpu_torch.params import time_values  # noqa: E402
from fdtd_tpu_torch.step import make_step  # noqa: E402
from fdtd_tpu_torch.utils.stability import stability_map  # noqa: E402

COMPONENTS = ["ex", "ey", "ez", "hx", "hy", "hz"]
FREQS = [2.45e10, 1.0e10, 5.0e9]


def _same(got, want):
    for c in COMPONENTS:
        np.testing.assert_allclose(getattr(got.states, c).numpy(), np.asarray(getattr(want.states, c)),
                                   rtol=1e-11, atol=1e-15, err_msg=c)
    for a, b in ((got.e_energy, want.e_energy), (got.h_energy, want.h_energy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11, atol=1e-300)


def _computation(p, dtype="float64"):
    return dataclasses.replace(p, mode=Mode.COMPUTATION, dtype=dtype)


def _mats(p, sigmas=(0.5, 2.0, 8.0)):
    return [water_block(p, lo=(0.1, 0.1, 0.1), hi=(0.5, 0.5, 0.5), eps_r=1.0 + s, sigma=s) for s in sigmas]


def test_frequency_sweep_matches_jax(tiny_params):
    p = _computation(tiny_params)
    want = js.frequency_sweep(p, FREQS, n_steps=12)
    got = ts.frequency_sweep(convert.params_from(p), FREQS, n_steps=12, device="cpu")
    assert tuple(got.states.ex.shape) == (3,) + p.padded_shape and got.e_energy.shape == (3,)
    _same(got, want)
    assert not np.allclose(got.states.ez[0].numpy(), got.states.ez[2].numpy())


def test_frequency_sweep_batch_mesh_matches_jax(tiny_params, capsys):
    p = _computation(tiny_params)
    freqs = [2.45e10 * (1 + 0.05 * i) for i in range(8)]
    want = js.frequency_sweep(p, freqs, n_steps=8, mesh=js.batch_mesh(8, devices=jax.devices("cpu")))
    mesh = ts.batch_mesh(8, device="cpu")
    assert mesh.shape == (8, 1) and mesh.nz == 1
    got = ts.frequency_sweep(convert.params_from(p), freqs, n_steps=8, mesh=mesh, device="cpu")
    _same(got, want)
    with pytest.raises(ValueError, match="must divide"):
        js.frequency_sweep(p, [2.45e10] * 3, n_steps=4, mesh=js.batch_mesh(8, devices=jax.devices("cpu")))
    with pytest.raises(ValueError, match="sweep size 3 must divide over 8 mesh devices"):
        ts.frequency_sweep(convert.params_from(p), [2.45e10] * 3, n_steps=4, mesh=mesh)


def test_frequency_sweep_spatial_mesh_matches_jax(tiny_params):
    """(2, 4) ("b", "z"): members over b, each member's grid in four z
    slabs (one-plane halos through the sharded step)."""
    p = _computation(tiny_params)
    want = js.frequency_sweep(p, FREQS[:2], n_steps=8, mesh=js.spatial_batch_mesh(2, 4, devices=jax.devices("cpu")))
    mesh = ts.spatial_batch_mesh(2, 4, device="cpu")
    assert (mesh.nb, mesh.nz) == (2, 4) and len(mesh.devices) == 8
    got = ts.frequency_sweep(convert.params_from(p), FREQS[:2], n_steps=8, mesh=mesh)
    _same(got, want)
    with pytest.raises(ValueError, match="needs 8 devices"):
        ts.spatial_batch_mesh(2, 4, devices=[torch.device("cpu")] * 3)


def test_frequency_sweep_pml_matches_jax(tiny_params):
    p = dataclasses.replace(_computation(tiny_params), source=SourceConfig(envelope="gaussian"))
    tp = convert.params_from(p)
    want = js.frequency_sweep(p, FREQS[:2], n_steps=10, pml=JPMLConfig(cells=3))
    got = ts.frequency_sweep(tp, FREQS[:2], n_steps=10, pml=PMLConfig(cells=3), device="cpu")
    _same(got, want)
    with pytest.raises(ValueError, match="xla"):
        js.frequency_sweep(p, FREQS, n_steps=4, pml=JPMLConfig(cells=3), backend="pallas_fused")
    with pytest.raises(ValueError, match=r"PML sweeps run the xla path \(got backend='pallas_fused'\)"):
        ts.frequency_sweep(tp, FREQS, n_steps=4, pml=PMLConfig(cells=3), backend="pallas_fused", device="cpu")
    with pytest.raises(ValueError, match="spatial"):
        ts.frequency_sweep(tp, FREQS, n_steps=4, pml=PMLConfig(cells=3), mesh=ts.spatial_batch_mesh(2, 2, device="cpu"))
    with pytest.raises(ValueError, match="unknown backend 'pallas_stream'"):
        ts.frequency_sweep(tp, FREQS, n_steps=4, backend="pallas_stream", device="cpu")
    with pytest.raises(ValueError, match="computation mode"):
        ts.frequency_sweep(convert.params_from(tiny_params), FREQS, n_steps=4, device="cpu")


def test_material_sweep_matches_jax(tiny_params):
    p = dataclasses.replace(tiny_params, dtype="float64")
    want = js.material_sweep(p, _mats(p), n_steps=15)
    got = ts.material_sweep(convert.params_from(p), [convert.materials_from(m) for m in _mats(p)], n_steps=15,
                            device="cpu")
    _same(got, want)
    e = (got.e_energy + got.h_energy).numpy()
    assert e[0] > e[1] > e[2] > 0  # a more conductive load dissipates more
    with pytest.raises(ValueError, match="non-vacuum"):
        ts.material_sweep(convert.params_from(p), [None], device="cpu")


@pytest.mark.parametrize("mesh", ["batch", "spatial"])
def test_material_sweep_meshes_match_jax(tiny_params, mesh):
    p = dataclasses.replace(tiny_params, dtype="float64")
    mats = _mats(p, (0.25, 0.5, 1.0, 2.0)) if mesh == "batch" else _mats(p, (0.5, 2.0))
    jmesh = (js.batch_mesh(4, devices=jax.devices("cpu")) if mesh == "batch"
             else js.spatial_batch_mesh(2, 2, devices=jax.devices("cpu")))
    tmesh = ts.batch_mesh(4, device="cpu") if mesh == "batch" else ts.spatial_batch_mesh(2, 2, device="cpu")
    want = js.material_sweep(p, mats, n_steps=8, mesh=jmesh)
    got = ts.material_sweep(convert.params_from(p), [convert.materials_from(m) for m in mats], n_steps=8, mesh=tmesh)
    _same(got, want)


def test_material_sweep_pml_matches_jax(tiny_params):
    p = _computation(tiny_params)
    mats = [water_block(p, lo=(0.3, 0.3, 0.3), hi=(0.7, 0.7, 0.7)), water_block(p, lo=(0.4, 0.4, 0.4),
                                                                                 hi=(0.8, 0.8, 0.8))]
    want = js.material_sweep(p, mats, n_steps=10, pml=JPMLConfig(cells=3))
    got = ts.material_sweep(convert.params_from(p), [convert.materials_from(m) for m in mats], n_steps=10,
                            pml=PMLConfig(cells=3), device="cpu")
    _same(got, want)


@pytest.mark.parametrize("backend", ["pallas_fused", "pallas"])
def test_fp32_kernel_sweep_equals_single_runs(tiny_params, tmp_path, backend):
    """fp32 on the batched K1/K2 (plain versions on CPU tensors): each
    member equals a single run at its frequency bit for bit; the JAX name
    maps to twopass with the runner's notice; no kernel launch counts on
    CPU tensors."""
    p = convert.params_from(_computation(tiny_params, "float32"))
    notices = []
    yee.reset_launches()
    got = ts.frequency_sweep(p, FREQS, backend=backend, device="cpu", log=notices.append)  # the whole schedule
    assert notices == [f"notice: backend {backend!r} is the JAX package's; running the port's 'twopass' backend"]
    assert yee.launches == dict.fromkeys(yee.launches, 0)
    for b, f in enumerate(FREQS):
        pf = dataclasses.replace(p, source=dataclasses.replace(p.source, frequency=f))
        one = runner.run_simulation(pf, "cpu", out_dir=str(tmp_path / str(b)), write_snapshots=False, log=lambda m: None)
        assert one.iterations == len(time_values(p)) > 10
        for c in COMPONENTS:
            assert torch.equal(getattr(got.states, c)[b], getattr(one.state, c)), (b, c)
    # the members' own twopass steps, one launch a member and half-step
    states = ts.initial_batch(p, len(FREQS), "cpu")
    amps = torch.tensor([[np.sin(2 * np.pi * f * t) for t in (0.0,)] for f in FREQS], dtype=torch.float64)
    step = make_step(p, "cpu", backend="twopass")
    batched = ts.initial_batch(p, len(FREQS), "cpu")
    ts.batch_step(p, "cpu")(batched, amps[:, 0])
    for b in range(len(FREQS)):
        step(ts.member(states, b), (0.0, amps[b, 0]))
    for c in COMPONENTS:
        assert torch.equal(getattr(batched, c), getattr(states, c)), c


def test_sweep_backend_names_and_device_defaults(tiny_params):
    import inspect

    for fn in (ts.frequency_sweep, ts.material_sweep, stability_map):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    p = convert.params_from(_computation(tiny_params, "float32"))
    for name in ("xla", "torch"):
        notices = []
        ts.frequency_sweep(p, FREQS[:1], n_steps=2, backend=name, device="cpu", log=notices.append)
        assert len(notices) == (name == "xla")
    with pytest.raises(ValueError, match="float64 runs on the torch backend"):
        ts.frequency_sweep(dataclasses.replace(p, dtype="float64"), FREQS[:1], n_steps=2, backend="twopass",
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            ts.frequency_sweep(p, FREQS[:1], n_steps=2)


def test_stability_map_matches_jax(tiny_params):
    limit = tiny_params.cfl_limit()
    dts = [0.5 * limit, 0.95 * limit, 1.6 * limit, 3.0 * limit]
    want = j_stability_map(tiny_params, dts)
    got = stability_map(convert.params_from(tiny_params), dts, device="cpu")
    for g, w in zip(got, want):
        assert (g.time_step, g.cfl_ratio, g.stable_predicted, g.stable_observed) == (
            w.time_step, w.cfl_ratio, w.stable_predicted, w.stable_observed)
        assert g.stable_observed == g.stable_predicted
        if w.stable_observed:
            assert g.energy_growth == pytest.approx(w.energy_growth, rel=1e-9)
        else:
            assert g.energy_growth > 1e6 and w.energy_growth > 1e6


def test_stability_map_matches_cfl_prediction(tiny_params):
    """The JAX package's own pin, fp32, on the port."""
    p = convert.params_from(dataclasses.replace(tiny_params, dtype="float32"))
    limit = p.cfl_limit()
    for pt in stability_map(p, [0.5 * limit, 0.95 * limit, 1.6 * limit, 3.0 * limit], device="cpu"):
        assert pt.stable_observed == pt.stable_predicted, vars(pt)


def test_batched_passes_validate_and_split(tiny_params):
    """The batched K1/K2 wrappers: a launch takes at most 65535 members
    (``stream_plan.MARCH_MEMBERS``: they lie along the march core's
    gridDim.y, whatever the grid), a batch must be six (N, K+1, J+1, I+1)
    tensors, and only the vacuum passes batch."""
    p = convert.params_from(_computation(tiny_params, "float32"))
    assert stream_plan.MARCH_MEMBERS == 65535
    assert yee._member_chunks(600) == [(0, 600)]
    assert yee._member_chunks(3) == [(0, 3)]
    assert yee._member_chunks(140000) == [(0, 65535), (65535, 65535), (131070, 8930)]
    states = ts.initial_batch(p, 2, "cpu")
    from fdtd_tpu_torch.state import FieldState, update_coefs

    with pytest.raises(ValueError, match="a batch is six"):
        yee.update_h_batch(p, FieldState(*(t[0] for t in states.tensors())), update_coefs(p))
    lossy = update_coefs(p, convert.materials_from(_mats(tiny_params)[0]), "cpu")
    with pytest.raises(ValueError, match="vacuum"):
        yee.update_e_batch(p, states, lossy)
