"""The port's two-way EM <-> thermal coupling and turntable
(fdtd_tpu_torch/coupled.py, turntable.py) against the JAX package's
(fdtd_tpu/coupled.py, turntable.py).

- Host functions, exact: ``water_debye`` and ``water_eps_static``,
  ``materials_at_temperature``, ``normalize_power``, ``LoadGeometry``,
  ``geometry_mask`` (every shape, arbitrary angles) and ``rotate_field``
  (random fields, arbitrary and quarter turns, both floor plans).
- ``run_coupled`` in fp64 against the JAX package's ``backend="xla"``: the
  rise at rtol 1e-6 (atol 1e-6 of its scale), the bar of
  tests/test_torch_runner.py for the SAR map the cook integrates: the fp32
  power accumulator rounds its per-step increments from reductions in
  another order.  The same for the turntable (``rpm``), the per-interval
  phasors (``dft``, ``cw_absorbed_w``) and CPML (``pml``); the interval
  summaries (materials ranges exactly where the temperatures agree to the
  bit, else at rtol 1e-6).
- The interval checkpoint across packages: the port's file read by the
  JAX package's loader, the JAX package's writer read by the port's, each
  resumed cook equal bit for bit to the port's uninterrupted one (the JAX
  package resuming the port's file equals its own cook at rtol 1e-6).
- fp32 cooks on ``torch`` and with ``shard="2"`` (CPU shards, torch ops):
  equal bit for bit (the ``twopass``/``stream`` kernels run on the card
  only; chip_smoke.py holds ``auto`` against ``twopass`` there).
- The CLI: ``--coupled`` (with ``--rotate``, ``--dft``,
  ``--checkpoint-every``/``--resume``) writes the JAX CLI's
  temperature.vtr, temperature_NN.vtr, dft_iNN_MM.vtr and coupled.jsonl
  (fp64, rtol 1e-6), and refuses what it refuses with its messages.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import coupled as jc  # noqa: E402
from fdtd_tpu import turntable as jtt  # noqa: E402
from fdtd_tpu.cli import main as jmain  # noqa: E402
from fdtd_tpu.dft import DftConfig as JDftConfig  # noqa: E402
from fdtd_tpu.io.vtr import read_vtr_cell_arrays  # noqa: E402
from fdtd_tpu.ops.cpml import PMLConfig as JPMLConfig  # noqa: E402
from fdtd_tpu.params import Mode, Params  # noqa: E402
from fdtd_tpu.state import block_mask  # noqa: E402
from fdtd_tpu_torch import cli, convert  # noqa: E402
from fdtd_tpu_torch import coupled as tc  # noqa: E402
from fdtd_tpu_torch import turntable as ttt  # noqa: E402
from fdtd_tpu_torch.dft import DftConfig  # noqa: E402
from fdtd_tpu_torch.ops.cpml import PMLConfig  # noqa: E402


def _box_params(n, steps=20, mode=Mode.COMPUTATION, dtype="float64"):
    return Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=1e-3, time_step=1e-12,
                  simulation_time=steps * 1e-12, sampling_rate=10**9, mode=mode, dtype=dtype)


def _geoms(mod):
    return [mod.LoadGeometry(shape="box", center=(0.62, 0.45), half_x=0.15, half_y=0.11),
            mod.LoadGeometry(shape="sphere", center=(0.4, 0.55), radius=0.18, z_center=0.45),
            mod.LoadGeometry(shape="cylinder", center=(0.7, 0.5), radius=0.12, z_lo=0.2, z_hi=0.8)]


def _quiet(_msg):
    pass


def _rise_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))


# --- host functions --------------------------------------------------------------------------------


def test_water_debye_and_materials_match_jax():
    T = np.linspace(-40.0, 150.0, 97)
    np.testing.assert_array_equal(tc.water_eps_static(T), jc.water_eps_static(T))
    for f, s in ((2.45e9, 0.0), (2.45e10, 0.7), (9.15e8, 2.0)):
        for a, b in zip(tc.water_debye(T, f, s), jc.water_debye(T, f, s)):
            np.testing.assert_array_equal(a, b)
    assert tc.EPS_INF == jc.EPS_INF
    p = _box_params(9)
    rng = np.random.default_rng(3)
    Tmap = rng.uniform(5.0, 95.0, (p.maxk, p.maxj, p.maxi))
    mask = rng.uniform(size=Tmap.shape) > 0.5
    a = tc.materials_at_temperature(convert.params_from(p), Tmap, mask, 2.45e10, 0.3)
    b = jc.materials_at_temperature(p, Tmap, mask, 2.45e10, 0.3)
    np.testing.assert_array_equal(a.eps_r, b.eps_r)
    np.testing.assert_array_equal(a.sigma, b.sigma)
    assert a.mu_r is None


def test_normalize_power_matches_jax():
    p = _box_params(8)
    q = np.random.default_rng(4).uniform(0.0, 3.0, (p.maxk, p.maxj, p.maxi))
    np.testing.assert_array_equal(tc.normalize_power(convert.params_from(p), q, 700.0), jc.normalize_power(p, q, 700.0))
    with pytest.raises(ValueError, match="zero power map"):
        tc.normalize_power(convert.params_from(p), np.zeros_like(q), 700.0)


def test_load_geometry_validates():
    with pytest.raises(ValueError, match="unknown load shape"):
        ttt.LoadGeometry(shape="cone")
    assert ttt.LoadGeometry() == ttt.LoadGeometry(shape="box", center=(0.5, 0.5))


@pytest.mark.parametrize("gi", range(3))
def test_geometry_mask_matches_jax(gi):
    p = Params(length=0.026, width=0.021, height=0.018, spatial_step=1e-3, time_step=1e-12, simulation_time=1e-11,
               sampling_rate=1, mode=Mode.COMPUTATION)
    tp = convert.params_from(p)
    for theta in (0.0, 0.37, math.pi / 2, 2.6, -1.1, 2 * math.pi):
        for axis in ((0.5, 0.5), (0.45, 0.6)):
            np.testing.assert_array_equal(ttt.geometry_mask(tp, _geoms(ttt)[gi], theta, axis),
                                          jtt.geometry_mask(p, _geoms(jtt)[gi], theta, axis), err_msg=str(theta))


def test_rotate_field_matches_jax():
    """Bilinear resampling, bit for bit, at arbitrary angles and quarter
    turns, about centered and off-center axes, with fills, on square and
    oblong floor plans."""
    rng = np.random.default_rng(5)
    for n_i, n_j in ((24, 24), (19, 23)):
        p = Params(length=n_i * 1e-3, width=n_j * 1e-3, height=0.01, spatial_step=1e-3, time_step=1e-12,
                   simulation_time=1e-11, sampling_rate=1, mode=Mode.COMPUTATION)
        tp = convert.params_from(p)
        arr = rng.uniform(-5.0, 50.0, (p.maxk, p.maxj, p.maxi))
        for theta in (0.0, 0.3, math.pi / 2, math.pi, 4.0, -0.7):
            for axis, fill in (((0.5, 0.5), 0.0), ((0.4, 0.55), 20.0)):
                np.testing.assert_array_equal(ttt.rotate_field(tp, arr, theta, axis, fill),
                                              jtt.rotate_field(p, arr, theta, axis, fill), err_msg=str(theta))


# --- run_coupled against the JAX package ---------------------------------------------------------


def _cooks(p, tkw=None, jkw=None, **kw):
    kw = dict(cook_time=8.0, intervals=2, power_watts=5e3, ambient=20.0, log=_quiet, **kw)
    want = jc.run_coupled(p, backend="xla", **kw, **(jkw or {}))
    got = tc.run_coupled(convert.params_from(p), backend="torch", device="cpu", **kw, **(tkw or {}))
    return got, want


def _summaries_close(got, want):
    assert [sorted(s) for s in got] == [sorted(s) for s in want]
    for g, w in zip(got, want):
        assert (g["interval"], g["thermal_steps"], g["theta_deg"]) == (w["interval"], w["thermal_steps"],
                                                                         w["theta_deg"])
        for key in w:
            if key not in ("interval", "thermal_steps", "theta_deg"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6, err_msg=key)


def test_run_coupled_matches_jax(tmp_path):
    """Two intervals of a salty load (the feedback moves eps and sigma)."""
    p = _box_params(10, steps=20)
    got, want = _cooks(p, sigma_ion25=0.5, out_dir=str(tmp_path))
    _rise_close(got.rise, want.rise)
    np.testing.assert_array_equal(got.temperature, got.rise + 20.0)
    assert got.final_theta == want.final_theta == 0.0
    _summaries_close(got.intervals, want.intervals)
    assert got.intervals[1]["eps_r_range"] != got.intervals[0]["eps_r_range"]  # the load heated: its dielectrics moved
    np.testing.assert_allclose(got.intervals[1]["absorbed_w"], 5e3, rtol=1e-12)


def test_run_coupled_rotating_matches_jax(tmp_path):
    """The turntable: an off-center cylinder at two mid-interval angles."""
    p = _box_params(12, steps=24)
    got, want = _cooks(p, rpm=10.0, out_dir=str(tmp_path),
                       tkw={"geometry": ttt.LoadGeometry(shape="cylinder", center=(0.65, 0.5), radius=0.15)},
                       jkw={"geometry": jtt.LoadGeometry(shape="cylinder", center=(0.65, 0.5), radius=0.15)})
    _rise_close(got.rise, want.rise)
    assert got.final_theta == want.final_theta == 2.0 * np.pi * 10.0 / 60.0 * 8.0
    _summaries_close(got.intervals, want.intervals)
    assert [s["theta_deg"] for s in got.intervals] == pytest.approx([120.0, 360.0])


def test_run_coupled_dft_matches_jax(tmp_path):
    """Per-interval phasors: cw_absorbed_w and the callback's maps."""
    p = _box_params(10, steps=60)
    seen = {}
    got, want = _cooks(p, out_dir=str(tmp_path),
                       tkw={"dft": DftConfig((2.45e10, 1.5e10)),
                            "on_interval_dft": lambda it, d, sg, th: seen.setdefault("t", []).append((d, sg))},
                       jkw={"dft": JDftConfig((2.45e10, 1.5e10)),
                            "on_interval_dft": lambda it, d, sg, th: seen.setdefault("j", []).append((d, sg))})
    _rise_close(got.rise, want.rise)
    _summaries_close(got.intervals, want.intervals)
    assert all(len(s["cw_absorbed_w"]) == 2 and s["cw_absorbed_w"][0] > 0 for s in got.intervals)
    for (dt_, st), (dj, sj) in zip(seen["t"], seen["j"]):
        np.testing.assert_array_equal(st, sj)
        for fi in range(2):
            m = np.asarray(dj.magnitude(fi))
            np.testing.assert_allclose(dt_.magnitude(fi), m, rtol=1e-5, atol=1e-5 * float(m.max()))


def test_run_coupled_pml_matches_jax(tmp_path):
    p = _box_params(12, steps=20)
    got, want = _cooks(p, out_dir=str(tmp_path), tkw={"pml": PMLConfig(cells=3)}, jkw={"pml": JPMLConfig(cells=3)})
    _rise_close(got.rise, want.rise)
    _summaries_close(got.intervals, want.intervals)


def test_run_coupled_refusals_match_jax(tmp_path):
    for p, kw, match in ((_box_params(8, mode=Mode.VALIDATION), {}, "computation mode"),
                         (_box_params(8), {"intervals": 0}, "at least 1"),
                         (_box_params(8), {"mask": np.zeros((8, 8, 8), bool)}, "mask is empty"),
                         (_box_params(8), {"rpm": 5.0}, "needs a LoadGeometry")):
        kw = {"intervals": 1, **kw}
        with pytest.raises(ValueError, match=match):
            jc.run_coupled(p, cook_time=1.0, backend="xla", log=_quiet, **kw)
        with pytest.raises(ValueError, match=match):
            tc.run_coupled(convert.params_from(p), cook_time=1.0, log=_quiet, device="cpu", **kw)
    with pytest.raises(ValueError, match="either mask or geometry"):
        tc.run_coupled(convert.params_from(_box_params(8)), 1.0, 1, mask=block_mask(_box_params(8)),
                       geometry=ttt.LoadGeometry(), device="cpu", log=_quiet)
    out = str(tmp_path / "o")
    tc._save_coupled_ckpt(out, np.zeros((3, 3, 3)), 1, [])
    with pytest.raises(ValueError, match="does not match"):
        tc.run_coupled(convert.params_from(_box_params(8)), 1.0, 2, resume=True, out_dir=out, device="cpu",
                       log=_quiet)


# --- checkpoints across packages, fp32 equalities --------------------------------------------------


class _Kill(Exception):
    pass


def _die_after_two(it, T, theta):
    if it == 1:
        raise _Kill()


def test_coupled_checkpoint_resumes_across_packages(tmp_path):
    """Kill the port's cook after interval 2 of 4: the JAX package reads
    its checkpoint (the fp64 rise, the index, the summaries), the JAX
    writer's copy resumes in the port bit for bit against the port's
    uninterrupted cook, and the JAX package resumes the port's file to its
    own cook at rtol 1e-6."""
    p = _box_params(10, steps=20)
    tp = convert.params_from(p)
    kw = dict(cook_time=4.0, intervals=4, power_watts=500.0, sigma_ion25=0.5, log=_quiet)
    full = tc.run_coupled(tp, out_dir=str(tmp_path / "full"), device="cpu", **kw)
    ck = str(tmp_path / "ck")
    with pytest.raises(_Kill):
        tc.run_coupled(tp, out_dir=ck, checkpoint=True, on_interval=_die_after_two, device="cpu", **kw)
    R, done, summaries = jc._load_coupled_ckpt(ck)
    assert done == 2 and R.dtype == np.float64 and summaries == full.intervals[:2]
    with np.load(tmp_path / "ck" / "coupled_ckpt.npz") as z:
        assert (z["rise"].dtype, z["intervals_done"].dtype, z["summaries"].dtype) == (np.float64, np.int64, np.uint8)
    jck = str(tmp_path / "jck")
    jc._save_coupled_ckpt(jck, R, done, summaries)
    for out in (ck, jck):
        resumed = tc.run_coupled(tp, out_dir=out, checkpoint=True, resume=True, device="cpu", **kw)
        np.testing.assert_array_equal(resumed.rise, full.rise)
        np.testing.assert_array_equal(resumed.temperature, full.temperature)
        assert resumed.intervals == full.intervals
    jfull = jc.run_coupled(p, out_dir=str(tmp_path / "jfull"), backend="xla", **kw)
    jc._save_coupled_ckpt(str(tmp_path / "jres"), R, done, summaries)
    jres = jc.run_coupled(p, out_dir=str(tmp_path / "jres"), backend="xla", resume=True, **kw)
    _rise_close(jres.rise, jfull.rise)
    assert jres.intervals[:2] == full.intervals[:2]


def test_coupled_fp32_cooks_equal_on_torch_and_shards(tmp_path):
    """fp32: the cook on torch ops and on two z shards (torch ops a shard)
    give the same bits: the shards' fields and SAR map equal the unsharded
    run's bit for bit."""
    p = convert.params_from(_box_params(10, steps=20, dtype="float32"))
    kw = dict(cook_time=8.0, intervals=2, power_watts=5e3, sigma_ion25=0.3, log=_quiet, device="cpu")
    a = tc.run_coupled(p, backend="torch", out_dir=str(tmp_path / "a"), **kw)
    b = tc.run_coupled(p, backend="torch", shard="2", out_dir=str(tmp_path / "b"), **kw)
    np.testing.assert_array_equal(a.rise, b.rise)
    assert a.intervals == b.intervals
    assert a.intervals[0]["peak_t_c"] > 20.0


# --- the CLI ---------------------------------------------------------------------------------------


def _cli_pair(tmp_path, capsys, flags, steps=20):
    params = tmp_path / "p.txt"
    params.write_text(f"0.01\n0.01\n0.01\n0.001\n1e-12\n{steps}e-12\n1000000000\n1\n")
    flags = [str(params), *flags]
    rc_j = jmain(flags + ["--out", str(tmp_path / "j"), "--backend", "xla"])
    capsys.readouterr()
    rc_t = cli.main(flags + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    return rc_j, rc_t, capsys.readouterr()


def _outputs_close(tmp_path, names):
    for name in names:
        got = read_vtr_cell_arrays(str(tmp_path / "t" / name))
        want = read_vtr_cell_arrays(str(tmp_path / "j" / name))
        assert list(got) == list(want), name
        for key in want:
            base = 20.0 if key.startswith("temperature") else 0.0
            _rise_close(got[key] - base, want[key] - base)
    got = [json.loads(line) for line in (tmp_path / "t" / "coupled.jsonl").read_text().splitlines()]
    want = [json.loads(line) for line in (tmp_path / "j" / "coupled.jsonl").read_text().splitlines()]
    _summaries_close(got, want)
    return got


@pytest.mark.parametrize("extra, files", [
    ([], ["temperature.vtr", "temperature_00.vtr", "temperature_01.vtr"]),
    (["--rotate", "10", "--load-center", "0.35,0.5", "--load-shape", "cylinder"],
     ["temperature.vtr", "temperature_00.vtr", "temperature_01.vtr"]),
    (["--dft", "2.45e10", "--salt-sigma", "0.4"], ["temperature.vtr", "dft_i00_00.vtr", "dft_i01_00.vtr"]),
])
def test_coupled_cli_matches_jax(tmp_path, capsys, extra, files):
    rc_j, rc_t, cap = _cli_pair(tmp_path, capsys, ["--water-block", "--coupled", "2", "--thermal", "8",
                                                   "--thermal-power", "2e3", "--dtype", "float64", *extra])
    assert rc_j == rc_t == 0, cap.err
    lines = _outputs_close(tmp_path, files)
    assert len(lines) == 2 and lines[1]["interval"] == 1
    assert "Load eps_r drifted" in cap.out and "Simulation complete!" in cap.out
    if "--rotate" in extra:
        t = read_vtr_cell_arrays(str(tmp_path / "t" / "temperature.vtr"))
        assert {"temperature_c_material_frame", "temperature_c_lab"} <= set(t)
        assert "Turntable: 10 rpm" in cap.out and "end-of-cook angle 480.0 deg" in cap.out


def test_coupled_cli_checkpoint_resume(tmp_path, capsys):
    """--checkpoint-every under --coupled checkpoints intervals; --resume
    after a full cook runs no interval and writes the same maps."""
    flags = ["--water-block", "--coupled", "2", "--thermal", "4", "--checkpoint-every", "1"]
    rc_j, rc_t, _ = _cli_pair(tmp_path, capsys, flags)
    assert rc_j == rc_t == 0 and (tmp_path / "t" / "coupled_ckpt.npz").exists()
    first = read_vtr_cell_arrays(str(tmp_path / "t" / "temperature.vtr"))["temperature_c"]
    params = str(tmp_path / "p.txt")
    assert cli.main([params, *flags, "--resume", "--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert "Resuming coupled cook after interval 2" in capsys.readouterr().out
    np.testing.assert_array_equal(read_vtr_cell_arrays(str(tmp_path / "t" / "temperature.vtr"))["temperature_c"],
                                  first)


@pytest.mark.parametrize("flags", [
    ["--water-block", "--coupled", "2"],  # no --thermal
    ["--coupled", "2", "--thermal", "5"],  # no load
    ["--water-block", "--ferrite-slab", "--coupled", "2", "--thermal", "5"],
    ["--water-block", "--rotate", "10"],  # no --coupled
    ["--water-block", "--dispersive", "--coupled", "2", "--thermal", "5"],
    ["--water-block", "--coupled", "2", "--thermal", "5", "--probe", "5,5,5"],
])
def test_coupled_cli_refusals_match_jax(tmp_path, capsys, flags):
    rc_j, rc_t, cap = _cli_pair(tmp_path, capsys, flags, steps=5)
    assert rc_j == rc_t == 1
    err = cap.err.strip().splitlines()
    assert err and err[-1].startswith("error: --")


def test_coupled_cli_validation_mode_exits_1(tmp_path, capsys):
    params = tmp_path / "v.txt"
    params.write_text("0.01\n0.01\n0.01\n0.001\n1e-12\n2e-11\n1000000000\n0\n")
    assert cli.main([str(params), "--water-block", "--coupled", "2", "--thermal", "5", "--device", "cpu"]) == 1
    assert "--coupled needs computation mode" in capsys.readouterr().err


def test_run_coupled_device_default_is_cuda():
    import inspect

    for fn in (tc.run_coupled,):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    p = dataclasses.replace(convert.params_from(_box_params(8)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tc.run_coupled(p, 1.0, 1, log=_quiet)
