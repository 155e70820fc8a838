"""The port's frequency-domain monitors (``monitors.py``, the runner's DFT
and probe path, the CLI's ``dft_NN.vtr`` and ``probes.csv``, checkpoints)
against the JAX package's.

- whole monitored runs on the ``torch`` backend against ``fdtd_tpu``'s
  ``run_simulation(backend="xla")``: vacuum, lossy + SAR, CPML, Debye and
  Debye x CPML, fields "e" and "eh", probes.  fp64: the fields at rtol
  1e-11; the phasor sums and probe rows, fp32 in both packages from fp64
  cell means rounded to fp32, within 2^-22 of their scale (two fp32 ulps:
  fields equal to reassociation level can round to neighbouring fp32
  values).  fp32: phasors atol 1e-6 x scale, fields 5e-7
  (``tests/test_dft.py``'s bars);
- the DFT bands of the CPML sweep (K11) and of the ADE sweep with and
  without SAR (K12), in their plain versions, against the interpret-mode
  ``make_stream_pml_dft_chunk_runner`` and ``run_simulation(backend=
  "pallas_stream")`` (``make_dispersive_stream_dft_chunk_runner``):
  phasors atol 2e-6 x scale (``tests/test_stream_pml.py``,
  ``tests/test_dispersive.py``), fields 1e-6 / 5e-7;
- physics: the TE101 pattern, the standing wave's Poynting vector, probe
  spectra (``utils/spectrum.py``);
- the CLI's files and checkpoints across the packages.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import dft as jdft  # noqa: E402
from fdtd_tpu import monitors as jmon  # noqa: E402
from fdtd_tpu.analytic import mode_constants  # noqa: E402
from fdtd_tpu.io.vtr import read_vtr_cell_arrays as j_read_vtr  # noqa: E402
from fdtd_tpu.ops.cpml import PMLConfig as JPMLConfig  # noqa: E402
from fdtd_tpu.ops.dispersive import water_debye_load as j_water_debye_load  # noqa: E402
from fdtd_tpu.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu.runner import run_simulation as j_run  # noqa: E402
from fdtd_tpu.state import water_block as j_water_block  # noqa: E402
from fdtd_tpu_torch import cli, convert, diagnostics, dft, monitors  # noqa: E402
from fdtd_tpu_torch.grid import COMPONENTS  # noqa: E402
from fdtd_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from fdtd_tpu_torch.io.vtr import read_vtr_cell_arrays  # noqa: E402
from fdtd_tpu_torch.ops.cpml import PMLConfig, init_psi  # noqa: E402
from fdtd_tpu_torch.runner import initial_state, run_simulation  # noqa: E402
from fdtd_tpu_torch.step import make_chunk_runner, scan_inputs  # noqa: E402
from fdtd_tpu_torch.utils import spectrum  # noqa: E402


def _box(n, steps, dtype="float64", mode=Mode.COMPUTATION):
    return Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=1e-3, time_step=1e-12,
                  simulation_time=(steps - 0.5) * 1e-12, sampling_rate=10**9, mode=mode, dtype=dtype)


def t_run(p, **kw):
    kw.setdefault("log", lambda m: None)
    return run_simulation(convert.params_from(p), "cpu", write_snapshots=False, **kw)


def _t_materials(jm):
    if jm is None:
        return None
    return convert.debye_from(jm) if hasattr(jm, "d_eps") else convert.materials_from(jm)


def _close_to_scale(got, want, frac, label):
    scale = float(np.abs(want).max())
    assert scale > 0, label
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale, err_msg=label)


SCENES = {
    "vacuum": dict(),
    "water_sar": dict(mats="water", sar=True),
    "pml": dict(pml=3),
    "debye_sar": dict(mats="debye", sar=True),
    "debye_pml": dict(mats="debye", pml=3),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("fields", ["e", "eh"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_torch_monitored_run_matches_jax_xla(scene, fields, dtype):
    kw = SCENES[scene]
    p = _box(10, 18, dtype)
    jm = {"water": j_water_block(p), "debye": j_water_debye_load(p, sigma_ion25=0.3), None: None}[kw.get("mats")]
    freqs, cells = (2.45e10, 1.5e10), ((3, 4, 5), (5, 5, 5))
    common = dict(accumulate_power=kw.get("sar", False))
    want = j_run(p, out_dir="unused", write_snapshots=False, backend="xla", log=lambda m: None,
                 materials=jm, pml=JPMLConfig(cells=kw["pml"]) if "pml" in kw else None,
                 dft=jdft.DftConfig(freqs, fields), probes=jmon.ProbeSet(cells), **common)
    got = t_run(p, backend="torch", materials=_t_materials(jm), pml=PMLConfig(cells=kw["pml"]) if "pml" in kw else None,
                dft=dft.DftConfig(freqs, fields), probes=monitors.ProbeSet(cells), **common)
    fp64 = dtype == "float64"
    for c in COMPONENTS:
        w = np.asarray(getattr(want.state, c))
        g = getattr(got.state, c).numpy()
        if fp64:
            np.testing.assert_allclose(g, w, rtol=1e-11, atol=1e-15 * float(np.abs(w).max()), err_msg=c)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-7, err_msg=c)
    assert got.dft.phasors.shape == want.dft.phasors.shape == (2, 6 if fields == "eh" else 3, 10, 10, 10)
    assert got.dft.steps == want.dft.steps == 18
    _close_to_scale(got.dft.phasors, want.dft.phasors, 2.0**-22 if fp64 else 1e-6, "phasors")
    assert got.probes.values.shape == want.probes.values.shape == (18, 2, 6)
    np.testing.assert_array_equal(got.probes.times, want.probes.times)
    _close_to_scale(got.probes.values, want.probes.values, 2.0**-22 if fp64 else 1e-6, "probes")


def test_plain_k11_bands_match_interpret_stream_pml_dft():
    from fdtd_tpu.ops.pallas_stream_pml import make_stream_pml_dft_chunk_runner, pack_psi_stream
    from fdtd_tpu.state import zeros as j_zeros
    from fdtd_tpu.step import backend_adapters

    steps = 23
    p = _box(24, steps, "float32")
    jcfg = jdft.DftConfig((2.45e10,))
    tv = time_values(p)[:steps]
    xs = scan_inputs(p, tv) + jdft.dft_weights(jcfg, np.asarray(tv))
    prep, rest = backend_adapters(p, "pallas_fused", None)
    run_s = make_stream_pml_dft_chunk_runner(p, JPMLConfig(cells=5), None, jcfg, interpret=True, s=4)
    (st_w, _psi), _pw, dacc_w, _ = run_s((prep(j_zeros(p)), pack_psi_stream(p, JPMLConfig(cells=5), None)), xs, None,
                                         jdft.zero_dft_acc(p, jcfg))
    want = rest(st_w)
    tp = convert.params_from(p)
    cfg, pml = dft.DftConfig(jcfg.frequencies), PMLConfig(cells=5)
    run = make_chunk_runner(tp, "cpu", backend="stream", pml=pml, dft=cfg)
    assert run.plan.kernel == "yee_stream_pml_dft" and steps % run.plan.s
    s = initial_state(tp, "cpu")
    sums = dft.zero_dft_acc(tp, cfg, "cpu")
    run(s, xs, None, init_psi(tp, pml, "cpu"), None, sums)
    for g, w, name in zip(sums, dacc_w, ("re", "im")):
        _close_to_scale(g.numpy(), np.asarray(w), 2e-6, name)
    for c in COMPONENTS:
        np.testing.assert_allclose(getattr(s, c).numpy(), np.asarray(getattr(want, c)), rtol=0, atol=1e-6, err_msg=c)


@pytest.mark.parametrize("sar", [False, True])
def test_plain_k12_bands_match_interpret_dispersive_stream_dft(sar):
    p = _box(12, 22, "float32")
    jdm = j_water_debye_load(p, lo=(0.25,) * 3, hi=(0.75,) * 3, sigma_ion25=0.2)
    jcfg = jdft.DftConfig((p.source.frequency, 1.5e10))
    want = j_run(p, materials=jdm, write_snapshots=False, backend="pallas_stream", dft=jcfg, accumulate_power=sar,
                 log=lambda m: None)
    tp = convert.params_from(p)
    cfg = dft.DftConfig(jcfg.frequencies)
    dm = convert.debye_from(jdm)
    from fdtd_tpu_torch.ops.dispersive import zero_polarization
    from fdtd_tpu_torch.step import zero_power_acc

    run = make_chunk_runner(tp, "cpu", dm, "stream", accumulate_power=sar, dft=cfg)
    assert run.plan.kernel == ("yee_stream_ade_sar_dft" if sar else "yee_stream_ade_dft")
    s, sums = initial_state(tp, "cpu"), dft.zero_dft_acc(tp, cfg, "cpu")
    power = zero_power_acc(tp, "cpu") if sar else None
    tv = time_values(p)
    run(s, scan_inputs(p, tv) + dft.dft_weights(cfg, tv), power, None, zero_polarization(tp, "cpu"), sums)
    _close_to_scale(dft.finalize(cfg, sums, len(tv)).phasors, want.dft.phasors, 2e-6, "phasors")
    for c in COMPONENTS:
        np.testing.assert_allclose(getattr(s, c).numpy(), np.asarray(getattr(want.state, c)), rtol=0, atol=5e-7,
                                   err_msg=c)
    if sar:
        np.testing.assert_allclose(power.numpy(), np.asarray(want.power_j), rtol=3e-6, atol=1e-18)


# --- physics --------------------------------------------------------------------------------------

def _validation_params(n=10, periods=3, per_period=32):
    """A validation-mode box whose dt divides the TE101 period exactly
    (``tests/test_dft.py``)."""
    base = Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=1e-3, time_step=1e-13,
                  simulation_time=1e-12, sampling_rate=10**9, mode=Mode.VALIDATION, dtype="float32")
    f101, _ = mode_constants(base)
    dt = 1.0 / (f101 * per_period)
    steps = periods * per_period
    return dataclasses.replace(base, time_step=dt, simulation_time=(steps - 0.5) * dt), f101


def test_dft_extracts_the_te101_pattern():
    p, f101 = _validation_params()
    res = t_run(p, dft=dft.DftConfig((f101,)))
    ph = res.dft.phasors[0]
    tp = convert.params_from(p)
    mex, mey, mez = (m.numpy() for m in diagnostics._e_cell_means(tp, initial_state(tp, "cpu")))
    peak = np.abs(mey).max()
    assert peak > 0.5
    hot = np.unravel_index(np.abs(ph[1]).argmax(), ph[1].shape)
    theta = np.angle(ph[1][hot] * np.sign(mey[hot]))
    assert abs(theta) < 0.45
    rot = ph[1] * np.exp(-1j * theta)
    np.testing.assert_allclose(rot.real, mey, atol=0.06 * peak)
    assert np.abs(rot.imag).max() < 0.06 * peak
    assert np.abs(ph[0]).max() < 0.05 * peak and np.abs(ph[2]).max() < 0.05 * peak
    np.testing.assert_allclose(res.dft.magnitude(0), np.abs(mey), atol=0.12 * peak)


def test_standing_wave_poynting_vanishes():
    p, f101 = _validation_params()
    res = t_run(p, dft=dft.DftConfig((f101,), fields="eh"))
    ph = res.dft.phasors[0]
    assert ph.shape[0] == 6
    scale = float(np.abs(ph[:3]).max()) * float(np.abs(ph[3:]).max())
    S = res.dft.poynting(0)
    assert np.abs(S).max() < 0.04 * scale
    raw = ph.copy()
    raw[3:] = raw[3:] * np.exp(-0.5j * 2 * np.pi * f101 * p.time_step)
    S_raw = 0.5 * np.real(np.cross(raw[:3], np.conj(raw[3:]), axis=0))
    assert np.abs(S_raw).max() > 2.5 * np.abs(S).max()


def test_probe_spectrum_finds_the_te101_resonance():
    """The port's copy of utils/spectrum.py reads the cavity's mode off a
    probe series, as the JAX package's does on the same series."""
    from fdtd_tpu.utils import spectrum as jspectrum

    p, f101 = _validation_params(periods=6)
    res = t_run(p, probes=monitors.ProbeSet(((5, 5, 5),)))
    freqs, amp, peaks = spectrum.probe_mode_spectrum(res, component="ey")
    jf, ja = jspectrum.amplitude_spectrum(res.probes.times, res.probes.series(0, "ey"))
    np.testing.assert_array_equal(freqs, jf)
    np.testing.assert_array_equal(amp, ja)
    assert peaks == jspectrum.find_peaks(jf, ja)
    assert abs(peaks[0][0] - f101) < 0.05 * f101


# --- the CLI's files and checkpoints -------------------------------------------------------------

def _params_file(tmp_path, text="0.01 0.01 0.01 0.001 1e-12 2e-11 1000000000 1"):
    path = tmp_path / "params.txt"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("extra", [["--water-block", "--dft", "2.45e10,2.45e9"],
                                   ["--dft", "2.45e10", "--dft-fields", "eh", "--probe", "2,3,4", "--probe", "5,5,5"],
                                   ["--water-block", "--dispersive", "--dft", "2.45e10"]])
def test_cli_writes_the_jax_clis_dft_and_probe_files(tmp_path, capsys, extra):
    from fdtd_tpu.cli import main as j_main

    params = _params_file(tmp_path)
    t_out, j_out = tmp_path / "t", tmp_path / "j"
    assert j_main([params, "--out", str(j_out), "--backend", "xla"] + extra) == 0
    assert cli.main([params, "--device", "cpu", "--out", str(t_out)] + extra) == 0
    assert "DFT phasors at 2.45e+10 Hz written to" in capsys.readouterr().out
    names = sorted(os.path.basename(f) for f in glob.glob(str(j_out / "dft_*.vtr")))
    assert names and names == sorted(os.path.basename(f) for f in glob.glob(str(t_out / "dft_*.vtr")))
    for name in names:
        got, want = read_vtr_cell_arrays(str(t_out / name)), j_read_vtr(str(j_out / name))
        assert set(got) == set(want), name
        for k in want:
            _close_to_scale(got[k], want[k], 1e-5, f"{name}/{k}") if np.abs(want[k]).max() > 0 else None
    if "--probe" in extra:
        got, want = (open(d / "probes.csv").read().splitlines() for d in (t_out, j_out))
        assert got[:2] == want[:2] and len(got) == len(want) == 2 + 20
        assert [len(r.split(",")) for r in got[2:]] == [1 + 6 * 2] * 20
        g = np.array([[float(v) for v in r.split(",")] for r in got[2:]])
        w = np.array([[float(v) for v in r.split(",")] for r in want[2:]])
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        _close_to_scale(g[:, 1:], w[:, 1:], 1e-5, "probes.csv")
    assert cli.main([params, "--device", "cpu", "--dft", "not-a-number"]) == 1
    assert "bad --dft spec" in capsys.readouterr().err
    assert cli.main([params, "--device", "cpu", "--probe", "99,0,0"]) == 1
    assert "bad --probe spec" in capsys.readouterr().err


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_monitor_checkpoints_resume_across_packages(tmp_path, writer):
    """A DFT + probe run checkpointed after step 14 by one package resumes
    in the other, and its phasors and probe series cover the whole run:
    equal to the reader's uninterrupted run (fp32, at the fp32 bars)."""
    p = dataclasses.replace(_box(8, 21, "float32"), sampling_rate=7)
    freqs, cells = (2.45e10,), ((2, 3, 4),)
    out = tmp_path / "ck"
    if writer == "jax":
        j_run(p, out_dir=str(out), write_snapshots=False, checkpoint_every=7, backend="xla", log=lambda m: None,
              dft=jdft.DftConfig(freqs), probes=jmon.ProbeSet(cells))
    else:
        t_run(p, out_dir=str(out), checkpoint_every=7, dft=dft.DftConfig(freqs), probes=monitors.ProbeSet(cells))
    for f in glob.glob(str(out / "ckpt*.npz")):
        if int(os.path.basename(f)[4:-4]) > 14:
            os.remove(f)
    aux = tckpt.load_aux(tckpt.latest_checkpoint(str(out)))
    assert aux["dft_re"].shape == (1, 3, 8, 8, 8) and aux["probe_rows"].shape == (14, 1, 6)
    if writer == "jax":
        resumed = t_run(p, out_dir=str(out), resume=True, dft=dft.DftConfig(freqs), probes=monitors.ProbeSet(cells))
        full = t_run(p, out_dir=str(tmp_path / "full"), dft=dft.DftConfig(freqs), probes=monitors.ProbeSet(cells))
        rv, fv = resumed.dft.phasors, full.dft.phasors
        rp, fp = resumed.probes, full.probes
    else:
        resumed = j_run(p, out_dir=str(out), write_snapshots=False, resume=True, backend="xla", log=lambda m: None,
                        dft=jdft.DftConfig(freqs), probes=jmon.ProbeSet(cells))
        full = j_run(p, out_dir=str(tmp_path / "full"), write_snapshots=False, backend="xla", log=lambda m: None,
                     dft=jdft.DftConfig(freqs), probes=jmon.ProbeSet(cells))
        rv, fv = resumed.dft.phasors, full.dft.phasors
        rp, fp = resumed.probes, full.probes
    assert resumed.dft.steps == 21 and rp.values.shape == fp.values.shape == (21, 1, 6)
    np.testing.assert_array_equal(rp.times, fp.times)
    _close_to_scale(rv, fv, 1e-6, "phasors")
    _close_to_scale(rp.values, fp.values, 1e-6, "probes")


def test_resume_equals_uninterrupted_run_bit_for_bit(tmp_path):
    p = convert.params_from(dataclasses.replace(_box(8, 21, "float32"), sampling_rate=7))
    kw = dict(dft=dft.DftConfig((2.45e10, 1.5e10), "eh"), probes=monitors.ProbeSet(((2, 3, 4),)))
    full = run_simulation(p, "cpu", out_dir=str(tmp_path / "a"), write_snapshots=False, log=lambda m: None, **kw)
    run_simulation(p, "cpu", out_dir=str(tmp_path / "b"), write_snapshots=False, checkpoint_every=7,
                   log=lambda m: None, **kw)
    for f in glob.glob(str(tmp_path / "b" / "ckpt*.npz")):
        if int(os.path.basename(f)[4:-4]) > 7:
            os.remove(f)
    res = run_simulation(p, "cpu", out_dir=str(tmp_path / "b"), write_snapshots=False, resume=True,
                         log=lambda m: None, **kw)
    np.testing.assert_array_equal(res.dft.phasors, full.dft.phasors)
    np.testing.assert_array_equal(res.probes.values, full.probes.values)
    np.testing.assert_array_equal(res.probes.times, full.probes.times)


def test_resume_without_monitor_aux_warns(tmp_path):
    p = convert.params_from(dataclasses.replace(_box(8, 14, "float32"), sampling_rate=7))
    out = str(tmp_path / "ck")
    run_simulation(p, "cpu", out_dir=out, write_snapshots=False, checkpoint_every=7, log=lambda m: None)
    res = run_simulation(p, "cpu", out_dir=out, write_snapshots=False, resume=True, log=lambda m: None,
                         dft=dft.DftConfig((2.45e10,)), probes=monitors.ProbeSet(((1, 1, 1),)))
    assert any("no DFT accumulators" in w for w in res.warnings)
    assert any("no probe rows" in w for w in res.warnings)
    assert res.dft.steps == 0 and res.probes.values.shape == (0, 1, 6)
    # the checkpoint helpers take host arrays beside tensors
    assert isinstance(tckpt.to_host(np.zeros(2)), np.ndarray)



def test_convert_carries_the_sums_and_rows():
    p = _box(6, 4, "float32")
    rng = np.random.default_rng(9)
    acc = [rng.uniform(-1, 1, (2, 3, 6, 6, 6)).astype(np.float32) for _ in range(2)]
    got = convert.dft_from_numpy(acc, "cpu")
    assert all(t.dtype == torch.float32 and t.shape == (2, 3, 6, 6, 6) for t in got)
    for a, b in zip(convert.dft_to_numpy(got), acc):
        np.testing.assert_array_equal(a, b)
    # the port's sums finalize as the JAX package's do
    jres = jdft.finalize(jdft.DftConfig((1e9, 2e9)), acc, 4)
    np.testing.assert_array_equal(dft.finalize(dft.DftConfig((1e9, 2e9)), got, 4).phasors, jres.phasors)
    assert p.maxk == 6
