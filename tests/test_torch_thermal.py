"""The port's thermal solve (fdtd_tpu_torch/thermal.py) against the JAX
package's (fdtd_tpu/thermal.py) and against the physics.

- The constants and the host maps (air, water box, mask, the harmonic face
  conductivities, ``stable_dt``): equal exactly (numpy in fp64 on both
  sides).
- One FTCS step and ``run_thermal`` (full steps and the shortened last
  one, with and without an initial field): fp64 at rtol 1e-12 (atol
  1e-12 of the rise's scale, for entries near zero); fp32 within 4 fp32
  ulps of the rise's scale (2**-22 of its largest magnitude).  Both
  integrate the rise in the JAX package's order of operations; XLA may
  fuse or reassociate its glue, torch runs each op as written, so the
  bits may differ at rounding level.
- The physics tests of tests/test_thermal.py against the port itself:
  adiabatic exactness, conservation and the max principle, Gaussian
  diffusion against the analytic kernel, the two-slab interface flux, the
  step count, and a sub-ulp-of-300K rise that survives fp32.
- The CLI: ``--water-block --sar --thermal`` (and ``--thermal-power``)
  writes the JAX CLI's temperature.vtr (fp64, the map at rtol 1e-6: the
  EM runs' fp32 power accumulators round their increments in another
  order, the bar of tests/test_torch_runner.py) and its lines; the JAX
  CLI's refusals exit 1.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import thermal as jt  # noqa: E402
from fdtd_tpu.cli import main as jmain  # noqa: E402
from fdtd_tpu.io.vtr import read_vtr_cell_arrays  # noqa: E402
from fdtd_tpu.params import Mode, Params  # noqa: E402
from fdtd_tpu_torch import cli, convert  # noqa: E402
from fdtd_tpu_torch import thermal as tt  # noqa: E402
from fdtd_tpu_torch.params import load_parameters  # noqa: E402
from fdtd_tpu_torch.state import block_mask, sphere_mask  # noqa: E402


def _box_params(n, dtype="float64"):
    return Params(
        length=n * 1e-3, width=n * 1e-3, height=n * 1e-3,
        spatial_step=1e-3, time_step=1e-12, simulation_time=1e-11,
        sampling_rate=10**9, mode=Mode.VALIDATION, dtype=dtype,
    )


def _ragged_params(dtype="float64"):
    """A non-cubic box: the axes' face arrays differ."""
    return Params(length=0.013, width=0.011, height=0.009, spatial_step=1e-3, time_step=1e-12,
                  simulation_time=1e-11, sampling_rate=10**9, mode=Mode.VALIDATION, dtype=dtype)


def _tm(tm):
    return tt.ThermalMaterials(rho_c=tm.rho_c, k=tm.k)


def _scene(dtype):
    """A water box in air with a random source and start field."""
    p = _ragged_params(dtype)
    tm = jt.water_thermal(p)
    rng = np.random.default_rng(7)
    q = rng.uniform(0.0, 1e6, (p.maxk, p.maxj, p.maxi))
    T0 = rng.uniform(10.0, 90.0, q.shape)
    return p, tm, q, T0


def _close(got, want, dtype):
    scale = float(np.abs(want).max())
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)
    else:
        assert float(np.abs(got - want).max()) <= 2.0**-22 * scale


def test_constants_and_host_maps_match_jax():
    for name in ("AIR_RHO_C", "AIR_K", "WATER_RHO_C", "WATER_K"):
        assert getattr(tt, name) == getattr(jt, name), name
    p = _ragged_params()
    tp = convert.params_from(p)
    for a, b in ((jt.air_thermal(p), tt.air_thermal(tp)),
                 (jt.water_thermal(p), tt.water_thermal(tp)),
                 (jt.water_thermal(p, lo=(0.1, 0.2, 0.3), hi=(0.6, 0.9, 0.5), rho_c=2e6, k=0.3),
                  tt.water_thermal(tp, lo=(0.1, 0.2, 0.3), hi=(0.6, 0.9, 0.5), rho_c=2e6, k=0.3))):
        np.testing.assert_array_equal(a.rho_c, b.rho_c)
        np.testing.assert_array_equal(a.k, b.k)
    mask = np.random.default_rng(0).uniform(size=(p.maxk, p.maxj, p.maxi)) > 0.6
    a, b = jt.thermal_from_mask(p, mask), tt.thermal_from_mask(tp, mask)
    np.testing.assert_array_equal(a.rho_c, b.rho_c)
    np.testing.assert_array_equal(a.k, b.k)
    # face conductivities and the stable step, with zero-k cells (s = 0 faces)
    k = np.where(mask, 0.0, np.random.default_rng(1).uniform(0.01, 2.0, mask.shape))
    for axis in range(3):
        np.testing.assert_array_equal(tt._face_k(k, axis), jt._face_k(k, axis))
    tm = jt.ThermalMaterials(rho_c=np.random.default_rng(2).uniform(1e3, 5e6, mask.shape), k=k)
    assert tt.stable_dt(tp, _tm(tm)) == jt.stable_dt(p, tm)
    assert tt.stable_dt(tp, _tm(tm), safety=0.5) == jt.stable_dt(p, tm, safety=0.5)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_thermal_step_matches_jax(dtype):
    p, tm, q, T0 = _scene(dtype)
    dt = jt.stable_dt(p, tm)
    want = np.asarray(jt.make_thermal_step(p, tm, q, dt)(jnp.asarray(T0 - 20.0, dtype)), np.float64)
    step = tt.make_thermal_step(convert.params_from(p), _tm(tm), q, dt, device="cpu")
    T = torch.tensor(T0 - 20.0, dtype=getattr(torch, dtype))
    step(T)
    _close(T.double().numpy(), want, dtype)
    with pytest.raises(ValueError, match="contiguous"):
        step(T.double() if dtype == "float32" else T.float())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("start", ["ambient", "field"])
def test_run_thermal_matches_jax(dtype, start):
    """37 full steps and the shortened last one, the rise from ambient or
    from a start field."""
    p, tm, q, T0 = _scene(dtype)
    dt = jt.stable_dt(p, tm)
    t0 = T0 if start == "field" else None
    want = jt.run_thermal(p, tm, q, 37.3 * dt, ambient=20.0, t0=t0)
    got = tt.run_thermal(convert.params_from(p), _tm(tm), q, 37.3 * dt, ambient=20.0, t0=t0, device="cpu")
    assert (got.steps, got.dt, got.ambient) == (want.steps, want.dt, want.ambient) == (38, dt, 20.0)
    assert got.rise.dtype == getattr(torch, dtype) and got.rise.device.type == "cpu"
    _close(got.rise.double().numpy(), np.asarray(want.rise, np.float64), dtype)
    _close(got.temperature, np.asarray(want.temperature), dtype)
    with pytest.raises(ValueError, match="positive"):
        tt.run_thermal(convert.params_from(p), _tm(tm), q, 0.0, device="cpu")


def test_thermal_adiabatic_exact():
    """k = 0: every cell heats by exactly q * t / rho_c (fp64 rounding),
    the shortened last step included."""
    p = convert.params_from(_box_params(12))
    shape = (p.maxk, p.maxj, p.maxi)
    rng = np.random.default_rng(0)
    rho_c = rng.uniform(1e3, 5e6, shape)
    q = rng.uniform(0.0, 1e6, shape)
    tm = tt.ThermalMaterials(rho_c=rho_c, k=np.zeros(shape))
    res = tt.run_thermal(p, tm, q, 7.3, ambient=20.0, dt=0.5, device="cpu")
    np.testing.assert_allclose(res.temperature, 20.0 + q * 7.3 / rho_c, rtol=1e-12, atol=0)


def test_thermal_conservation_and_max_principle():
    """q = 0, insulated walls, a water block in air: the heat content
    sum(rho_c * T) is conserved and T stays inside its initial range."""
    p = convert.params_from(_box_params(16))
    tm = tt.water_thermal(p)
    T0 = np.random.default_rng(1).uniform(10.0, 90.0, (p.maxk, p.maxj, p.maxi))
    dt = tt.stable_dt(p, tm)
    T = tt.run_thermal(p, tm, np.zeros_like(T0), duration=200 * dt, t0=T0, dt=dt, device="cpu").temperature
    np.testing.assert_allclose(float((tm.rho_c * T).sum()), float((tm.rho_c * T0).sum()), rtol=1e-12)
    assert T.min() >= T0.min() - 1e-9 and T.max() <= T0.max() + 1e-9
    assert T.max() - T.min() < 0.999 * (T0.max() - T0.min())


def test_thermal_gaussian_matches_analytic():
    """A Gaussian hot spot in a uniform medium diffuses with variance
    sigma^2 + 2 alpha t: the peak within 2%, the field within 2% of the
    amplitude."""
    p = convert.params_from(_box_params(32))
    shape = (p.maxk, p.maxj, p.maxi)
    rho_c, k = 2.0e6, 0.5
    tm = tt.ThermalMaterials(rho_c=np.full(shape, rho_c), k=np.full(shape, k))
    alpha, dx = k / rho_c, p.spatial_step
    sig = 3.0 * dx
    c = np.array([s / 2 - 0.5 for s in shape]) * dx
    kk, jj, ii = np.meshgrid(*[np.arange(s) * dx for s in shape], indexing="ij")
    r2 = (kk - c[0]) ** 2 + (jj - c[1]) ** 2 + (ii - c[2]) ** 2
    amp = 50.0
    t_end = 2.0 * sig**2 / alpha
    T = tt.run_thermal(p, tm, np.zeros(shape), duration=t_end,
                       t0=20.0 + amp * np.exp(-r2 / (2 * sig**2)), device="cpu").temperature
    sig2_t = sig**2 + 2 * alpha * t_end
    np.testing.assert_allclose(T.max() - 20.0, amp * (sig**2 / sig2_t) ** 1.5, rtol=0.02)
    want = 20.0 + amp * (sig**2 / sig2_t) ** 1.5 * np.exp(-r2 / (2 * sig2_t))
    np.testing.assert_allclose(T, want, atol=0.02 * amp)


def test_thermal_two_slab_interface_flux():
    """Harmonic-mean faces: one step moves only the two rows at the
    interface, by dt * k_face * dT / (rho_c dx^2) with k_face = 2 k1 k2 /
    (k1 + k2)."""
    p = convert.params_from(_box_params(8))
    shape = (p.maxk, p.maxj, p.maxi)
    k1, k2 = 0.2, 5.0
    kmap = np.full(shape, k1)
    half = shape[0] // 2
    kmap[half:] = k2
    tm = tt.ThermalMaterials(rho_c=np.full(shape, 1e6), k=kmap)
    T0 = np.broadcast_to(np.where(np.arange(shape[0])[:, None, None] < half, 80.0, 20.0), shape).copy()
    dt = tt.stable_dt(p, tm)
    T = torch.tensor(T0)
    tt.make_thermal_step(p, tm, np.zeros(shape), dt, device="cpu")(T)
    T1 = T.numpy()
    dT = dt * (2 * k1 * k2 / (k1 + k2)) * 60.0 / (1e6 * p.spatial_step**2)
    np.testing.assert_allclose(T1[half - 1], 80.0 - dT, rtol=1e-12)
    np.testing.assert_allclose(T1[half], 20.0 + dT, rtol=1e-12)
    np.testing.assert_allclose(T1[: half - 1], 80.0)
    np.testing.assert_allclose(T1[half + 1:], 20.0)


def test_thermal_steps_count_matches_integration():
    p = convert.params_from(_box_params(6))
    tm, shape = tt.air_thermal(p), (p.maxk, p.maxj, p.maxi)
    assert tt.run_thermal(p, tm, np.zeros(shape), duration=1.0, dt=0.25, device="cpu").steps == 4
    assert tt.run_thermal(p, tm, np.zeros(shape), duration=1.1, dt=0.25, device="cpu").steps == 5


def test_thermal_rise_resolves_in_fp32():
    """The fp32 state is the rise: a 1e-9 K heating signal, far below the
    ulp of ~300 K, survives, and the hot cell is the deposition peak."""
    p = convert.params_from(_box_params(10, "float32"))
    shape = (p.maxk, p.maxj, p.maxi)
    tm = tt.water_thermal(p)
    q = np.zeros(shape)
    q[5, 4, 6] = 1e-3
    res = tt.run_thermal(p, tm, q, 1.0, ambient=20.0, device="cpu")
    assert res.rise.dtype == torch.float32
    rise = res.temperature - 20.0
    assert 0 < rise.max() < 1e-8
    assert np.unravel_index(int(rise.argmax()), shape) == (5, 4, 6)
    # in fp64 the same rise to the fp32 rounding of 166 steps (2**-16 of
    # the peak: about 0.8 ulp a step at most; measured 1.2e-6, 20 ulps)
    want = tt.run_thermal(dataclasses.replace(p, dtype="float64"), tm, q, 1.0, device="cpu").rise.numpy()
    assert float(np.abs(res.rise.double().numpy() - want).max()) <= 2.0**-16 * float(want.max())


def _cli_params(tmp_path, steps=30):
    path = tmp_path / "p.txt"
    path.write_text(f"0.02\n0.02\n0.02\n0.001\n1e-12\n{steps}e-12\n1000000000\n1\n")
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--thermal-power", "900", "--load-shape", "sphere"]])
def test_thermal_cli_matches_jax(tmp_path, capsys, extra):
    """--water-block --sar --thermal 30 (fp64): temperature.vtr and sar.vtr
    against the JAX CLI's; the hot spot inside the load, the air corner at
    ambient, the JAX CLI's lines."""
    params = _cli_params(tmp_path)
    flags = ["--water-block", "--sar", "--thermal", "30", "--thermal-ambient", "20", "--dtype", "float64", *extra]
    assert jmain([params, "--out", str(tmp_path / "j"), *flags]) == 0
    capsys.readouterr()
    assert cli.main([params, "--out", str(tmp_path / "t"), "--device", "cpu", *flags]) == 0
    out = capsys.readouterr().out
    assert "Integrating the heat equation for 30 s of cook time" in out and "Peak deposited power" in out
    assert ("Deposited power normalized to 900 W total" in out) == bool(extra)
    for name in ("temperature.vtr", "sar.vtr"):
        got = read_vtr_cell_arrays(str(tmp_path / "t" / name))
        want = read_vtr_cell_arrays(str(tmp_path / "j" / name))
        assert set(got) == set(want)
        for key in want:
            if key == "temperature_c":  # the rise's scale, not ambient's
                np.testing.assert_allclose(got[key] - 20.0, want[key] - 20.0, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(want[key] - 20.0).max()), err_msg=key)
            else:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6 * float(np.abs(want[key]).max()),
                                           err_msg=key)
    T = read_vtr_cell_arrays(str(tmp_path / "t" / "temperature.vtr"))["temperature_c"]
    assert float(T.max()) > 20.0
    tp = load_parameters(params)
    mask = sphere_mask(tp, center=(0.5, 0.5, 0.5)) if extra else block_mask(tp)
    assert mask[np.unravel_index(int(T.argmax()), T.shape)]  # the hot cell is a load cell
    if not extra:  # 900 W into this small box heats the air corner too
        assert abs(float(T[0, 0, 0]) - 20.0) < 1e-6


@pytest.mark.parametrize("flags", [["--sar", "--water-block", "--thermal", "-1"], ["--thermal", "10"],
                                   ["--water-block", "--sar", "--thermal", "5", "--thermal-power", "0"]])
def test_thermal_cli_refusals_match_jax(tmp_path, capsys, flags):
    params = _cli_params(tmp_path, steps=5)
    assert jmain([params, "--out", str(tmp_path / "j"), *flags]) == 1
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert cli.main([params, "--out", str(tmp_path / "t"), "--device", "cpu", *flags]) == 1
    assert capsys.readouterr().err.strip().splitlines()[-1] == want
