"""The port's runner, IO and CLI against the JAX package.

Runs of both packages on the shipped 50^3 scene (fp64, sampling rate 50,
both modes) write the same .vtr file list; the arrays agree at rtol 1e-11
(atol 1e-15 for entries near zero) and the JSONL energies at rtol 1e-10:
the steps agree to reassociation level (tests/test_torch_step.py), the
energies are reductions in another order.  Checkpoints move between the two
packages.  The .vtr writer is byte-identical to the golden fixture.
"""

import dataclasses
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu.io import checkpoint as jckpt  # noqa: E402
from fdtd_tpu.io.vtr import read_vtr_cell_arrays as j_read_vtr  # noqa: E402
from fdtd_tpu.params import Mode, time_values  # noqa: E402
from fdtd_tpu.runner import run_simulation as j_run  # noqa: E402
from fdtd_tpu.state import FieldState as JFieldState  # noqa: E402
from fdtd_tpu.state import init_validation  # noqa: E402
from fdtd_tpu_torch import cli, convert, runner  # noqa: E402
from fdtd_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from fdtd_tpu_torch.io import native, vtr  # noqa: E402

COMPONENTS = ["ex", "ey", "ez", "hx", "hy", "hz"]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def t_run(p, out, **kw):
    kw.setdefault("log", lambda m: None)
    return runner.run_simulation(convert.params_from(p), "cpu", out_dir=str(out), **kw)


def _files(out):
    return sorted(os.path.basename(f) for f in glob.glob(os.path.join(str(out), "*.vtr")))


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_run_matches_jax_on_default_scene(default_params, tmp_path, mode):
    p = dataclasses.replace(default_params, mode=mode, sampling_rate=50)
    j_out, t_out = tmp_path / "j", tmp_path / "t"
    j_run(p, out_dir=str(j_out), backend="xla", diagnostics_log=str(tmp_path / "j.jsonl"))
    res = t_run(p, t_out, backend="torch", diagnostics_log=str(tmp_path / "t.jsonl"))
    n = len(time_values(p))
    assert res.iterations == n and res.mcells_per_s > 0 and not res.warnings

    files = _files(t_out)
    assert files == _files(j_out)
    assert files == ["result0001.vtr"] + [f"result{m:04d}.vtr" for m in range(50, n + 1, 50)]
    for f in files:
        got = vtr.read_vtr_cell_arrays(os.path.join(t_out, f))
        want = j_read_vtr(os.path.join(j_out, f))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-11, atol=1e-15, err_msg=f"{f}/{k}")
    with open(t_out / "series.pvd") as a, open(j_out / "series.pvd") as b:
        assert a.read() == b.read()

    got, want = _jsonl(tmp_path / "t.jsonl"), _jsonl(tmp_path / "j.jsonl")
    assert [r["iteration"] for r in got] == [r["iteration"] for r in want]
    for g, w in zip(got, want):
        assert g["t"] == w["t"]
        for k in ("E_energy", "H_energy", "total"):
            assert g[k] == pytest.approx(w[k], rel=1e-10, abs=1e-300), k


def test_snapshot_cadence_matches_reference(tiny_params, tmp_path):
    """rate=2 gives files 0001, 0002, 0004, ... (tests/test_io.py)."""
    p = dataclasses.replace(tiny_params, sampling_rate=2)
    out = tmp_path / "r"
    t_run(p, out, diagnostics_log=str(tmp_path / "d.jsonl"))
    n = len(time_values(p))
    assert _files(out) == sorted(["result0001.vtr"] + [f"result{m:04d}.vtr" for m in range(2, n + 1, 2)])
    arrs = vtr.read_vtr_cell_arrays(os.path.join(out, "result0002.vtr"))
    for name in ["ex", "ey", "ez", "hx", "hy", "hz", "aEy", "aHx", "aHz"]:
        assert name in arrs and arrs[name].shape == (p.maxk, p.maxj, p.maxi)
    # quirk-compat: aHx equals the aggregated computed hx (main.c:585-588)
    np.testing.assert_allclose(arrs["aHx"], arrs["hx"], rtol=1e-6)
    lines = _jsonl(tmp_path / "d.jsonl")
    assert len(lines) == 1 + n // 2
    assert {"iteration", "t", "E_energy", "H_energy", "total"} <= set(lines[0])
    with open(out / "series.pvd") as f:
        assert f.read().count("<DataSet") == len(_files(out))


def test_physics_correct_export_differs(tiny_params, tmp_path):
    p = dataclasses.replace(tiny_params, sampling_rate=4)
    t_run(p, tmp_path / "q", quirk_compat=False)
    arrs = vtr.read_vtr_cell_arrays(os.path.join(tmp_path / "q", "result0004.vtr"))
    assert not np.allclose(arrs["aHx"], arrs["hx"])


def test_vtr_golden_bytes(tmp_path):
    """The port's writers give the committed golden .vtr byte for byte (the
    native C++ writer too, where it builds)."""
    with np.load(os.path.join(GOLDEN, "golden_small_inputs.npz")) as z:
        coords = (z["x"], z["y"], z["z"])
        arrays = {k: z[k] for k in ("ex", "ey", "hz")}
    with open(os.path.join(GOLDEN, "golden_small.vtr"), "rb") as f:
        golden = f.read()
    out = str(tmp_path / "py.vtr")
    vtr.write_vtr(out, coords, arrays)
    with open(out, "rb") as f:
        assert f.read() == golden
    got = vtr.read_vtr_cell_arrays(out)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, dtype=got[k].dtype))
    out_n = str(tmp_path / "native.vtr")
    if native.write_vtr_native(out_n, coords, arrays):
        with open(out_n, "rb") as f:
            assert f.read() == golden


def test_vtr_round_trip_and_shape_check(tmp_path):
    rng = np.random.default_rng(1)
    coords = (np.arange(5.0), np.arange(4.0), np.arange(3.0))
    arrays = {"ex": rng.normal(size=(2, 3, 4)), "hy": rng.normal(size=(2, 3, 4)).astype(np.float32)}
    path = str(tmp_path / "t.vtr")
    vtr.write_vtr(path, coords, arrays)
    got = vtr.read_vtr_cell_arrays(path)
    np.testing.assert_array_equal(got["ex"], arrays["ex"])
    np.testing.assert_array_equal(got["hy"], arrays["hy"])
    with pytest.raises(ValueError, match="cell shape"):
        vtr.write_vtr(path, coords, {"bad": np.zeros((3, 3, 3))})


def test_checkpoints_move_between_packages(tiny_params, tmp_path):
    p = tiny_params
    tp = convert.params_from(p)
    rng = np.random.default_rng(2)
    arrays = {c: rng.normal(size=p.padded_shape) for c in COMPONENTS}

    jpath = str(tmp_path / "ckpt000010.npz")
    jckpt.save_checkpoint(jpath, JFieldState(**{c: jnp.array(a) for c, a in arrays.items()}), 10, 1e-11)
    s, it, t, power = tckpt.load_checkpoint(jpath, tp, "cpu")
    assert (it, t, power) == (10, 1e-11, None)
    for c in COMPONENTS:
        np.testing.assert_array_equal(getattr(s, c).numpy(), arrays[c], err_msg=c)

    tdir = tmp_path / "t"
    with tckpt.CheckpointWriter(str(tdir)) as w:
        w.submit(convert.state_from_numpy(arrays, "cpu", torch.float64), 12, 1.2e-11)
    tpath = tckpt.latest_checkpoint(str(tdir))
    assert tpath.endswith("ckpt000012.npz") and jckpt.latest_checkpoint(str(tdir)) == tpath
    js, it, t, power = jckpt.load_checkpoint(tpath, p)
    assert (it, t, power) == (12, 1.2e-11, None)
    for c in COMPONENTS:
        np.testing.assert_array_equal(np.asarray(getattr(js, c)), arrays[c], err_msg=c)

    # bfloat16: the JAX package stores raw bf16 records, the port float32
    pb = dataclasses.replace(p, dtype="bfloat16")
    jckpt.save_checkpoint(jpath, init_validation(pb), 10, 1e-11)
    s, *_ = tckpt.load_checkpoint(jpath, convert.params_from(pb), "cpu")
    assert s.ey.dtype == torch.bfloat16
    np.testing.assert_array_equal(s.ey.float().numpy(), np.asarray(init_validation(pb).ey, np.float32))

    with pytest.raises(ValueError, match="shape"):
        tckpt.load_checkpoint(jpath, convert.params_from(dataclasses.replace(p, length=0.02)), "cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(tiny_params, tmp_path, writer):
    """A run interrupted after step 14 resumes in the other package and ends
    where an uninterrupted run of that package ends."""
    p = dataclasses.replace(tiny_params, sampling_rate=7)
    n = len(time_values(p))
    assert n > 14
    out = tmp_path / "ck"
    if writer == "jax":
        j_run(p, out_dir=str(out), write_snapshots=False, checkpoint_every=7, backend="xla")
    else:
        t_run(p, out, write_snapshots=False, checkpoint_every=7)
    for f in glob.glob(str(out / "ckpt*.npz")):
        if int(os.path.basename(f)[4:-4]) > 14:
            os.remove(f)
    if writer == "jax":
        resumed = convert.state_to_numpy(t_run(p, out, write_snapshots=False, resume=True).state)
        full = convert.state_to_numpy(t_run(p, tmp_path / "full", write_snapshots=False).state)
    else:
        r = j_run(p, out_dir=str(out), write_snapshots=False, resume=True, backend="xla")
        resumed = {c: np.asarray(getattr(r.state, c)) for c in COMPONENTS}
        r = j_run(p, out_dir=str(tmp_path / "full"), write_snapshots=False, backend="xla")
        full = {c: np.asarray(getattr(r.state, c)) for c in COMPONENTS}
    for c in COMPONENTS:
        np.testing.assert_allclose(resumed[c], full[c], rtol=1e-11, atol=1e-15, err_msg=c)


def test_resume_equals_uninterrupted_run(tiny_params, tmp_path):
    """Full run == run, interrupt, resume, bit for bit (fp64)."""
    p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION, sampling_rate=7)
    ra = t_run(p, tmp_path / "a", write_snapshots=False, checkpoint_every=7)
    t_run(p, tmp_path / "b", write_snapshots=False, checkpoint_every=7)
    for f in glob.glob(str(tmp_path / "b" / "ckpt*.npz")):
        if int(os.path.basename(f)[4:-4]) > 14:
            os.remove(f)
    rb = t_run(p, tmp_path / "b", write_snapshots=False, resume=True)
    for c in COMPONENTS:
        assert torch.equal(getattr(ra.state, c), getattr(rb.state, c)), c


def test_checkpoint_cadence_decoupled_from_sampling(tiny_params, tmp_path):
    p = dataclasses.replace(tiny_params, sampling_rate=7)
    out = tmp_path / "cc"
    t_run(p, out, write_snapshots=False, checkpoint_every=3)
    steps = sorted(int(os.path.basename(f)[4:-4]) for f in glob.glob(str(out / "ckpt*.npz")))
    assert steps == list(range(3, len(time_values(p)) + 1, 3))


def test_runner_detects_divergence(tiny_params, tmp_path):
    """An unstable dt aborts with a clear error at the next sample."""
    p = dataclasses.replace(tiny_params, dtype="float32", time_step=4e-12,
                            simulation_time=4.8e-10, sampling_rate=20)
    with pytest.raises(RuntimeError, match="diverged"):
        t_run(p, tmp_path / "r", write_snapshots=False, diagnostics_log=str(tmp_path / "d.jsonl"))


def test_bfloat16_guardrail_warns(tiny_params, tmp_path):
    notices = []
    p = dataclasses.replace(tiny_params, dtype="bfloat16")
    r = t_run(p, tmp_path / "w", write_snapshots=False, log=notices.append)
    assert any("bfloat16" in w for w in r.warnings) and any("bfloat16" in m for m in notices)
    assert r.state.ey.dtype == torch.bfloat16
    r2 = t_run(dataclasses.replace(p, mode=Mode.COMPUTATION), tmp_path / "c", write_snapshots=False)
    assert not r2.warnings


@pytest.mark.parametrize("feature, kw, item", [
    ("materials", {"materials": "water"}, "item 5"),
    ("accumulate_power", {"accumulate_power": True}, "item 5"),
    ("pml", {"pml": object()}, "item 7"),
    ("dft", {"dft": object()}, "item 9"),
    ("probes", {"probes": object()}, "item 9"),
    ("shard", {"shard": "2"}, "item 11"),
])
def test_unported_features_name_their_roadmap_item(tiny_params, tmp_path, feature, kw, item):
    """Sharding (items 11 and 11b) is ported: ``shard="2"`` on the tiny
    scene in computation mode matches the JAX package's sharded xla run and
    its unsharded run (fp64, fields at atol 1e-15 / rtol 1e-11), and with a
    3-cell CPML the JAX package's sharded xla CPML run (fields and the
    twelve psi, the same bar).  The frequency-domain
    monitors (item 9) are ported: a two-frequency DFT, and probes at two
    cells, on the tiny scene in computation mode match the JAX package's
    xla run (fp64 fields; the fp32 phasor sums and probe rows within one
    fp32 ulp of their scale: both round fp64 cell means to fp32).
    Materials and SAR (item 5) are ported: a lossy scene, and a water
    block with ``accumulate_power``, run and match the JAX package (fp64,
    the fields at atol 1e-15 / rtol 1e-11, the fp32 accumulator at rtol
    1e-6: its per-step increments round to fp32 from reductions in another
    order).  CPML (item 7) is ported: a 3-cell absorber on the tiny scene
    in computation mode matches the JAX package's xla CPML run (fp64,
    fields and the twelve psi at atol 1e-15 / rtol 1e-11)."""
    if feature == "pml":
        from fdtd_tpu.ops.cpml import PMLConfig as JPMLConfig

        from fdtd_tpu_torch.ops.cpml import PMLConfig, PsiState

        p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION)
        got = t_run(p, tmp_path / "t", write_snapshots=False, pml=PMLConfig(cells=3))
        want = j_run(p, out_dir=str(tmp_path / "j"), write_snapshots=False, pml=JPMLConfig(cells=3),
                     backend="xla", checkpoint_every=len(time_values(p)), log=lambda m: None)
        for c in COMPONENTS:
            np.testing.assert_allclose(getattr(got.state, c).numpy(), np.asarray(getattr(want.state, c)),
                                       rtol=1e-11, atol=1e-15, err_msg=c)
        aux = jckpt.load_aux(jckpt.latest_checkpoint(str(tmp_path / "j")))
        for n in PsiState.names():
            np.testing.assert_allclose(getattr(got.psi, n).numpy(), aux[f"psi_{n}"],
                                       rtol=1e-11, atol=1e-15, err_msg=n)
        assert float(np.abs(aux["psi_hx_z"]).max()) > 0
        return
    if feature in ("dft", "probes"):
        from fdtd_tpu.dft import DftConfig as JDftConfig
        from fdtd_tpu.monitors import ProbeSet as JProbeSet

        from fdtd_tpu_torch.dft import DftConfig
        from fdtd_tpu_torch.monitors import ProbeSet

        p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION)
        freqs, cells = (2.45e10, 1.5e10), ((2, 3, 4), (5, 5, 5))
        t_kw = {"dft": DftConfig(freqs)} if feature == "dft" else {"probes": ProbeSet(cells)}
        j_kw = {"dft": JDftConfig(freqs)} if feature == "dft" else {"probes": JProbeSet(cells)}
        got = t_run(p, tmp_path / "t", write_snapshots=False, **t_kw)
        want = j_run(p, out_dir=str(tmp_path / "j"), write_snapshots=False, backend="xla", log=lambda m: None, **j_kw)
        for c in COMPONENTS:
            np.testing.assert_allclose(getattr(got.state, c).numpy(), np.asarray(getattr(want.state, c)),
                                       rtol=1e-11, atol=1e-15, err_msg=c)
        if feature == "dft":
            g, w = got.dft.phasors, want.dft.phasors
            assert g.shape == w.shape == (2, 3, p.maxk, p.maxj, p.maxi) and got.dft.steps == want.dft.steps
        else:
            g, w = got.probes.values, want.probes.values
            assert g.shape == w.shape and got.probes.cells == want.probes.cells
            np.testing.assert_array_equal(got.probes.times, want.probes.times)
        scale = float(np.abs(w).max())
        assert scale > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=2.0**-23 * scale)
        return
    if feature in ("materials", "accumulate_power"):
        from fdtd_tpu.state import Materials as JMaterials
        from fdtd_tpu.state import water_block

        p = tiny_params
        if feature == "materials":
            jm = JMaterials(sigma=np.ones((p.maxk, p.maxj, p.maxi)))
        else:
            p = dataclasses.replace(p, mode=Mode.COMPUTATION)
            jm = water_block(p)
        sar = feature == "accumulate_power"
        got = t_run(p, tmp_path / "t", write_snapshots=False, materials=convert.materials_from(jm),
                    accumulate_power=sar)
        want = j_run(p, out_dir=str(tmp_path / "j"), write_snapshots=False, materials=jm,
                     accumulate_power=sar, log=lambda m: None)
        for c in COMPONENTS:
            np.testing.assert_allclose(getattr(got.state, c).numpy(), np.asarray(getattr(want.state, c)),
                                       rtol=1e-11, atol=1e-15, err_msg=c)
        assert (got.power_j is None) == (want.power_j is None) == (not sar)
        if sar:
            w = np.asarray(want.power_j)
            assert got.power_j.dtype == torch.float32 and float(w.max()) > 0
            np.testing.assert_allclose(got.power_j.numpy(), w, rtol=1e-6, atol=1e-6 * float(w.max()))
        return
    if feature == "shard":
        from fdtd_tpu.ops.cpml import PMLConfig as JPMLConfig

        from fdtd_tpu_torch.ops.cpml import PMLConfig, PsiState

        p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION)
        got = t_run(p, tmp_path / "t", write_snapshots=False, **kw)
        for j_kw, sub in ((kw, "js"), ({}, "j")):
            want = j_run(p, out_dir=str(tmp_path / sub), write_snapshots=False, backend="xla", log=lambda m: None,
                         **j_kw)
            for c in COMPONENTS:
                np.testing.assert_allclose(getattr(got.state, c).numpy(), np.asarray(getattr(want.state, c)),
                                           rtol=1e-11, atol=1e-15, err_msg=f"{sub}/{c}")
        # item 11b is ported too: sharded CPML against the JAX package's sharded xla CPML run
        got = t_run(p, tmp_path / "tp", write_snapshots=False, pml=PMLConfig(cells=3), **kw)
        want = j_run(p, out_dir=str(tmp_path / "jp"), write_snapshots=False, backend="xla", pml=JPMLConfig(cells=3),
                     checkpoint_every=len(time_values(p)), log=lambda m: None, **kw)
        for c in COMPONENTS:
            np.testing.assert_allclose(getattr(got.state, c).numpy(), np.asarray(getattr(want.state, c)),
                                       rtol=1e-11, atol=1e-15, err_msg=f"pml/{c}")
        aux = jckpt.load_aux(jckpt.latest_checkpoint(str(tmp_path / "jp")))
        for n in PsiState.names():
            np.testing.assert_allclose(getattr(got.psi, n).numpy(), aux[f"psi_{n}"], rtol=1e-11, atol=1e-15,
                                       err_msg=n)
        assert float(np.abs(aux["psi_hx_z"]).max()) > 0
        return
    with pytest.raises(NotImplementedError, match=item):
        t_run(tiny_params, tmp_path / "x", **kw)


def _params_file(tmp_path, text="0.01 0.01 0.01 0.001 1e-12 1e-11 5 0"):
    path = tmp_path / f"params-{len(list(tmp_path.glob('params-*')))}.txt"
    path.write_text(text)
    return str(path)


def test_cli_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "r"
    rc = cli.main([_params_file(tmp_path), "--device", "cpu", "--dtype", "float64",
                   "--out", str(out), "--diag-log", str(tmp_path / "d.jsonl")])
    stdout = capsys.readouterr().out
    assert rc == 0
    for line in ("Welcome into our microwave oven eletrico-magnetic field simulator! ",
                 "Loading the parameters...", "Initializing fields", "Validation mode activated. ",
                 "Creating mesh", "Setting initial conditions", "Launching simulation",
                 "Simulation complete!"):
        assert line in stdout.splitlines(), line
    assert "iterations in" in stdout
    assert _files(out) == ["result0001.vtr", "result0005.vtr", "result0010.vtr"]
    assert len(_jsonl(tmp_path / "d.jsonl")) == 3


def test_cli_checkpoint_resume_and_source_flags(tmp_path, capsys):
    params = _params_file(tmp_path, "0.012 0.012 0.012 0.001 1e-12 2e-11 5 1")
    out = str(tmp_path / "r")
    common = [params, "--device", "cpu", "--out", out, "--no-output",
              "--source-frequency", "2.45e9", "--source-envelope", "gaussian"]
    assert cli.main(common + ["--checkpoint-every", "10"]) == 0
    assert tckpt.latest_checkpoint(out).endswith("ckpt000020.npz")
    assert cli.main(common + ["--resume"]) == 0
    assert "Simulation complete!" in capsys.readouterr().out
    assert cli.main(common + ["--source-pulse-width", "-1"]) == 1
    assert "positive" in capsys.readouterr().err


@pytest.mark.parametrize("case", ["missing", "short", "dt", "twopass_cpu", "twopass_fp64", "cuda"])
def test_cli_error_paths(tmp_path, capsys, case):
    args = {
        "missing": [str(tmp_path / "nope.txt"), "--device", "cpu"],
        "short": [_params_file(tmp_path, "0.05 0.05 0.05 0.001"), "--device", "cpu"],
        "dt": [_params_file(tmp_path, "0.01 0.01 0.01 0.001 1e-9 1e-11 5 0"), "--device", "cpu"],
        "twopass_cpu": [_params_file(tmp_path), "--device", "cpu", "--backend", "twopass"],
        "twopass_fp64": [_params_file(tmp_path), "--device", "cuda", "--backend", "twopass",
                         "--dtype", "float64"],
        "cuda": [_params_file(tmp_path), "--no-output"],
    }[case]
    expect = {
        "missing": "Unable to open parameters file!",
        "short": "needs 8 values",
        "dt": "lower than the simulation time",
        "twopass_cpu": "--backend torch",
        "twopass_fp64": "float32 or bfloat16" if torch.cuda.is_available() else "--device cpu",
        "cuda": "--device cpu",
    }[case]
    if case == "cuda" and torch.cuda.is_available():
        return  # a CUDA run is not an error where there is a card
    rc = cli.main(args + ["--out", str(tmp_path / "r")])
    assert rc == 1
    assert expect in capsys.readouterr().err
