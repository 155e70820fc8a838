"""CPML, Debye media and the monitors under spatial sharding (``--shard``),
against the JAX package and against the port's own unsharded runs.

- fp64: the port's sharded torch path matches the JAX package's sharded
  xla runs on the conftest's virtual CPU mesh (``fdtd_tpu.runner.
  run_simulation(shard=..., backend="xla")``: ``make_sharded_step(pml=)``
  with and without SAR on 1-D and 2-D meshes, ``make_sharded_dispersive_
  chunk_runner`` with and without SAR, the monitored shard_map scan with
  the DFT of fields "e" and "eh" and probes, and the ``--dft --pml
  --shard`` triple) at rtol 1e-11 / atol 1e-15, fields, the twelve psi and
  P included; the SAR map at rtol 1e-6 (as ``test_torch_sharded.py``); the
  fp32 phasor sums and probe rows within one fp32 ulp of their scale (both
  round fp64 cell means to fp32).
- fp32: every composition's sharded run equals its unsharded run bit for
  bit on ``torch``, ``twopass`` and ``stream`` (the plain versions of the
  kernels on CPU shards), ragged and even shards, 1-D and 2-D meshes, and
  a CPML k slab straddling two shards; fields, psi, P, the SAR map, the
  sums and the probe rows.
- Interpret mode: the TPU's per-shard CPML composition
  (``make_sharded_pml_fast_runner``), the ``--dft --pml --shard`` triple
  (``make_sharded_pml_fast_dft_runner``) and the sharded DFT bands
  (``make_sharded_stream_dft_runner``), reached through the JAX runner,
  against the port's sharded runs at the JAX tests' bars
  (``tests/test_pml.py``, ``tests/test_dft.py``).
- Checkpoints: a sharded CPML, Debye or DFT run resumes unsharded and in
  the JAX package, and a JAX sharded checkpoint resumes sharded in the port.
- The psi parts tile the canonical arrays; ``stream_plan.shard_bytes``
  counts the new parts; the routing of ``sharded_runner``; the CLI.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import runner as jrunner  # noqa: E402
from fdtd_tpu.dft import DftConfig as JDftConfig  # noqa: E402
from fdtd_tpu.io import checkpoint as jckpt  # noqa: E402
from fdtd_tpu.io.vtr import read_vtr_cell_arrays  # noqa: E402
from fdtd_tpu.monitors import ProbeSet as JProbeSet  # noqa: E402
from fdtd_tpu.ops import dispersive as jd  # noqa: E402
from fdtd_tpu.ops.cpml import PMLConfig as JPMLConfig  # noqa: E402
from fdtd_tpu.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu.state import ferrite_slab, water_block  # noqa: E402
from fdtd_tpu_torch import cli, convert, runner  # noqa: E402
from fdtd_tpu_torch.dft import DftConfig, dft_weights, zero_dft_acc  # noqa: E402
from fdtd_tpu_torch.monitors import ProbeSet  # noqa: E402
from fdtd_tpu_torch.ops import cpml, stream_plan  # noqa: E402
from fdtd_tpu_torch.ops.cpml import PMLConfig, PsiState, init_psi  # noqa: E402
from fdtd_tpu_torch.ops.dispersive import zero_polarization  # noqa: E402
from fdtd_tpu_torch.parallel import mesh as M  # noqa: E402
from fdtd_tpu_torch.parallel import sharded_fast, sharded_step  # noqa: E402
from fdtd_tpu_torch.step import make_chunk_runner, scan_inputs, zero_power_acc  # noqa: E402

COMPONENTS = ("ex", "ey", "ez", "hx", "hy", "hz")
POL = ("pol_x", "pol_y", "pol_z")
FREQS = (2.45e10, 1.5e10)
CELLS = ((2, 3, 4), (7, 5, 5))  # one probe on each shard of a 2-slab mesh
ATOL = 1e-6  # the JAX package's interpret-mode bar for fields (tests/test_pml.py, tests/test_sharded_fast.py)


def _params(dtype="float64", height=0.01, steps=19, mode=Mode.COMPUTATION):
    """The tiny scene: 11 planes a side (6 + 5 over two shards); ``height``
    0.0115 gives 12 planes along k (3 a shard over four, so the 3-cell CPML
    k slabs straddle two shards)."""
    return Params(length=0.01, width=0.01, height=height, spatial_step=0.001, time_step=1e-12,
                  simulation_time=(steps - 0.5) * 1e-12, sampling_rate=10**6, mode=mode, dtype=dtype)


def _quiet(**kw):
    return {"write_snapshots": False, "log": lambda m: None, **kw}


def _close(got, want, err_msg, rtol=1e-11, atol=1e-15):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


def _jax_aux(out):
    return jckpt.load_aux(jckpt.latest_checkpoint(str(out)))


def _hold_fields(got, want, **kw):
    for c in COMPONENTS:
        _close(getattr(got.state, c).numpy(), getattr(want.state, c), c, **kw)


def _hold_monitors(got, want, rel=2.0**-23):
    """The fp32 phasor sums and probe rows within ``rel`` of their scale
    (default one fp32 ulp)."""
    for g, w in ((got.dft, want.dft), (got.probes, want.probes)):
        if w is None:
            assert g is None
            continue
        a, b = (g.phasors, w.phasors) if hasattr(w, "phasors") else (g.values, w.values)
        scale = float(np.abs(b).max())
        assert a.shape == b.shape and scale > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


# -- fp64: the sharded torch path against the JAX package's sharded xla runs ---

@pytest.mark.parametrize("sar", [False, True])
@pytest.mark.parametrize("shard", ["2", "2x2"])
def test_sharded_cpml_matches_jax(tmp_path, shard, sar):
    """``make_sharded_step(pml=)``: fields, the twelve psi and the SAR map."""
    jp = _params()
    mats = water_block(jp, lo=(0.2,) * 3, hi=(0.8,) * 3) if sar else None
    want = jrunner.run_simulation(jp, out_dir=str(tmp_path / "j"), backend="xla", shard=shard, pml=JPMLConfig(cells=3),
                                  materials=mats, accumulate_power=sar,
                                  checkpoint_every=len(time_values(jp)), **_quiet())
    got = runner.run_simulation(convert.params_from(jp), "cpu", out_dir=str(tmp_path / "t"), shard=shard,
                                pml=PMLConfig(cells=3), accumulate_power=sar,
                                materials=convert.materials_from(mats) if sar else None, **_quiet())
    _hold_fields(got, want)
    aux = _jax_aux(tmp_path / "j")
    for n in PsiState.names():
        _close(getattr(got.psi, n).numpy(), aux[f"psi_{n}"], n)
    assert float(np.abs(aux["psi_hx_z"]).max()) > 0
    if sar:
        w = np.asarray(want.power_j)
        assert float(w.max()) > 0
        _close(got.power_j.numpy(), w, "SAR", rtol=1e-6, atol=1e-6 * float(w.max()))


@pytest.mark.parametrize("sar", [False, True])
def test_sharded_debye_matches_jax(tmp_path, sar):
    """``make_sharded_dispersive_chunk_runner``: fields, P and the SAR map
    (the Debye work)."""
    jp = _params()
    jdm = jd.water_debye_load(jp, lo=(0.2,) * 3, hi=(0.8,) * 3, sigma_ion25=0.5)
    want = jrunner.run_simulation(jp, out_dir=str(tmp_path / "j"), backend="xla", shard="2", materials=jdm,
                                  accumulate_power=sar, checkpoint_every=len(time_values(jp)), **_quiet())
    got = runner.run_simulation(convert.params_from(jp), "cpu", out_dir=str(tmp_path / "t"), shard="2",
                                materials=convert.debye_from(jdm), accumulate_power=sar, **_quiet())
    _hold_fields(got, want)
    aux = _jax_aux(tmp_path / "j")
    for n, t in zip(POL, got.pol.tensors()):
        _close(t.numpy(), aux[n], n)
    assert float(np.abs(aux["pol_z"]).max()) > 0
    if sar:
        w = np.asarray(want.power_j)
        assert float(w.max()) > 0
        _close(got.power_j.numpy(), w, "SAR", rtol=1e-6, atol=1e-6 * float(w.max()))


_MONITOR_CASES = {
    "dft_e": dict(dft=FREQS),
    "dft_eh": dict(dft=FREQS, fields="eh"),
    "probes": dict(probes=CELLS),
    "dft_pml": dict(dft=FREQS, pml=3),  # the --dft --pml --shard triple
    "debye_probes_dft": dict(dft=FREQS[:1], probes=CELLS, debye=True),
}


def _monitor_kw(case, jp, port):
    c = _MONITOR_CASES[case]
    kw = {}
    if "dft" in c:
        kw["dft"] = (DftConfig if port else JDftConfig)(c["dft"], fields=c.get("fields", "e"))
    if "probes" in c:
        kw["probes"] = (ProbeSet if port else JProbeSet)(c["probes"])
    if "pml" in c:
        kw["pml"] = (PMLConfig if port else JPMLConfig)(cells=c["pml"])
    if c.get("debye"):
        jdm = jd.water_debye_load(jp, sigma_ion25=0.5)
        kw["materials"] = convert.debye_from(jdm) if port else jdm
        kw["accumulate_power"] = True
    return kw


@pytest.mark.parametrize("case", list(_MONITOR_CASES))
def test_sharded_monitors_match_jax(tmp_path, case):
    """The monitored shard_map scan (``fdtd_tpu/runner.py:499-581``) and the
    Debye runner's monitors: fields in fp64, the sums and probe rows within
    an fp32 ulp of their scale.  The triple's sums within two ulps, the bar
    of the unsharded comparison (``tests/test_torch_monitors.py``, 2**-22 of
    their scale): the CPML corrections' fp64 operation order rounds a few
    cell means to the other fp32 neighbour, so the port's sums, the sharded
    and the unsharded alike (bit for bit equal), stand 1.07 ulps of their
    scale from the JAX package's (whose sharded and unsharded sums are equal
    too)."""
    jp = _params()
    want = jrunner.run_simulation(jp, out_dir=str(tmp_path / "j"), backend="xla", shard="2",
                                  **_quiet(**_monitor_kw(case, jp, False)))
    got = runner.run_simulation(convert.params_from(jp), "cpu", out_dir=str(tmp_path / "t"), shard="2",
                                **_quiet(**_monitor_kw(case, jp, True)))
    _hold_fields(got, want)
    _hold_monitors(got, want, rel=2.0**-22 if case == "dft_pml" else 2.0**-23)
    if case == "dft_pml":
        one = runner.run_simulation(convert.params_from(jp), "cpu", out_dir=str(tmp_path / "u"),
                                    **_quiet(**_monitor_kw(case, jp, True)))
        assert np.array_equal(got.dft.phasors, one.dft.phasors)


# -- fp32: sharded == unsharded, bit for bit ---------------------------------

def _composition(p, name):
    """(materials, sar, pml, dft, probes) of a composition (port objects)."""
    wb = convert.materials_from(water_block(p))
    return {
        "pml": (None, False, PMLConfig(cells=3), None, None),
        "pml_het_sar": (convert.materials_from(ferrite_slab(p, base=water_block(p))), True, PMLConfig(cells=3),
                        None, None),
        "dft": (None, False, None, DftConfig(FREQS), None),
        "dft_sar": (wb, True, None, DftConfig(FREQS[:1]), None),
        "eh_probes": (None, False, None, DftConfig(FREQS[:1], fields="eh"), ProbeSet(CELLS)),
        "dft_pml": (None, False, PMLConfig(cells=3), DftConfig(FREQS[:1]), None),
        "debye_sar_dft": (convert.debye_from(jd.water_debye_load(p, sigma_ion25=0.5)), True, None,
                          DftConfig(FREQS[:1]), ProbeSet(CELLS)),
    }[name]


def _run32(p, comp, backend, shape, arrays, steps=19, split=7):
    """The fp32 run of a composition from ``arrays`` on the CPU, in two
    chunks: unsharded on ``torch`` (``shape`` None) or sharded on
    ``backend``; returns (state, power, psi, pol, dacc, probe rows)."""
    tp = convert.params_from(p)
    mats, sar, pml, dft, probes = _composition(p, comp)
    s = convert.state_from_numpy(arrays, "cpu", torch.float32)
    ts, amps = scan_inputs(p, time_values(p)[:steps])
    xs = (ts, amps) + (dft_weights(dft, ts) if dft is not None else ())
    power = zero_power_acc(tp, "cpu") if sar else None
    psi = init_psi(tp, pml, "cpu") if pml is not None else None
    pol = zero_polarization(tp, "cpu") if hasattr(mats, "d_eps") else None
    dacc = zero_dft_acc(tp, dft, "cpu") if dft is not None else None
    rows = []
    if shape is None:
        run = make_chunk_runner(tp, "cpu", mats, "torch", accumulate_power=sar, pml=pml, dft=dft, probes=probes)
    else:
        mesh = M.make_mesh(shape, "cpu")
        if backend == "stream":
            run = sharded_fast.make_sharded_stream_runner(tp, mesh, mats, sar, dft=dft)
        else:
            run = sharded_step.make_sharded_chunk_runner(tp, mesh, mats, sar, backend, pml, dft, probes)
        shards = M.scatter(tp, s, mesh, run.depth, power, psi, pml, pol, dacc)
    for a, b in ((0, split), (split, steps)):
        chunk = tuple(x[a:b] for x in xs)
        out = run(s, chunk, power, psi, pol, dacc) if shape is None else run(shards, chunk)
        if probes is not None:
            rows.append(out)
    if shape is not None:
        M.gather(tp, shards, s, power, psi, pml, pol, dacc)
    return s, power, psi, pol, dacc, torch.cat(rows) if rows else None


_FP32_CASES = [(comp, backend, shape)
               for comp in ("pml", "pml_het_sar", "dft", "dft_sar", "eh_probes", "dft_pml", "debye_sar_dft")
               for backend in (("torch",) if comp.startswith("debye") else ("torch", "twopass", "stream"))
               if backend != "stream" or comp in ("dft", "dft_sar")
               for shape in ((2, 1, 1), (4, 1, 1), (2, 2, 1))
               if not (backend == "stream" and shape == (4, 1, 1))]  # the bands' 5-plane halo: 3 a shard is too few


@pytest.mark.parametrize("comp, backend, shape", _FP32_CASES)
def test_sharded_fp32_equals_unsharded(comp, backend, shape):
    """11 planes over two shards (6 + 5, ragged), 12 over four (3 each: the
    3-cell CPML's k slabs straddle two shards), 2 x 2; random fields, so
    every absorber cell and load cell is live from the first step."""
    p = _params("float32", height=0.0115 if shape == (4, 1, 1) else 0.01)
    rng = np.random.default_rng(11)
    arrays = {c: rng.uniform(-1.0, 1.0, convert.params_from(p).padded_shape) for c in COMPONENTS}
    want = _run32(p, comp, "torch", None, arrays)
    got = _run32(p, comp, backend, shape, arrays)
    for g, w, what in zip(got, want, ("fields", "SAR", "psi", "P", "sums", "probe rows")):
        if w is None:
            assert g is None, what
            continue
        gs = g.tensors() if hasattr(g, "tensors") else g if isinstance(g, tuple) else (g,)
        ws = w.tensors() if hasattr(w, "tensors") else w if isinstance(w, tuple) else (w,)
        for a, b in zip(gs, ws):
            assert torch.equal(a, b), what
        assert any(float(b.abs().max()) > 0 for b in ws), what


# -- interpret mode: the TPU's sharded compositions ---------------------------

def test_tpu_sharded_pml_fast_interpret_matches_the_port(tmp_path):
    """``make_sharded_pml_fast_runner`` (per-shard K1/K2 plus slab
    corrections, in interpret mode) against the port's sharded CPML run:
    fields and psi at atol 1e-6."""
    from fdtd_tpu.parallel.sharded_pml_fast import sharded_pml_fast_supported

    jp = _params("float32", steps=12)
    assert sharded_pml_fast_supported(jp, JPMLConfig(cells=3), 2)
    notices = []
    want = jrunner.run_simulation(jp, out_dir=str(tmp_path / "j"), backend="pallas_fused", shard="2",
                                  pml=JPMLConfig(cells=3), checkpoint_every=12, write_snapshots=False,
                                  log=notices.append)
    assert not any("xla" in m for m in notices), notices  # the kernel tier ran
    got = runner.run_simulation(convert.params_from(jp), "cpu", out_dir=str(tmp_path / "t"), shard="2",
                                pml=PMLConfig(cells=3), **_quiet())
    _hold_fields(got, want, rtol=0, atol=ATOL)
    aux = _jax_aux(tmp_path / "j")
    for n in PsiState.names():
        _close(getattr(got.psi, n).numpy(), aux[f"psi_{n}"], n, rtol=0, atol=ATOL)
    assert float(np.abs(aux["psi_hy_x"]).max()) > 0


@pytest.mark.parametrize("tier", ["pml_fast_dft", "stream_dft"])
def test_tpu_sharded_dft_interpret_matches_the_port(tmp_path, tier):
    """``make_sharded_pml_fast_dft_runner`` (the triple) and
    ``make_sharded_stream_dft_runner`` (the sharded DFT bands, 5 sweeps of 4
    and 2 trailing steps), in interpret mode, against the port's sharded
    runs: phasors at atol 2e-6 of their scale, fields at 1e-6
    (``tests/test_pml.py::test_pml_shard_fast_dft_matches_xla``) and 5e-7
    (``tests/test_dft.py::test_dft_sharded_stream_kernel_matches_xla``)."""
    jp = _params("float32", height=0.0115, steps=22)
    if tier == "pml_fast_dft":
        jkw = dict(backend="pallas_fused", pml=JPMLConfig(cells=3), dft=JDftConfig((jp.source.frequency,)))
        tkw = dict(pml=PMLConfig(cells=3), dft=DftConfig((jp.source.frequency,)))
        atol = 1e-6
    else:
        jkw = dict(backend="pallas_stream", dft=JDftConfig((jp.source.frequency, 1.5e10)))
        tkw = dict(dft=DftConfig((jp.source.frequency, 1.5e10)))
        atol = 5e-7
    notices = []
    want = jrunner.run_simulation(jp, out_dir=str(tmp_path / "j"), shard="2", write_snapshots=False,
                                  log=notices.append, **jkw)
    assert not any("xla" in m for m in notices), notices  # the kernel tier ran
    got = runner.run_simulation(convert.params_from(jp), "cpu", out_dir=str(tmp_path / "t"), shard="2",
                                **_quiet(**tkw))
    scale = float(np.abs(want.dft.phasors).max())
    assert scale > 0
    np.testing.assert_allclose(got.dft.phasors, want.dft.phasors, rtol=0, atol=2e-6 * scale)
    _hold_fields(got, want, rtol=0, atol=atol)


# -- checkpoints ---------------------------------------------------------------

@pytest.mark.parametrize("scene", ["pml", "debye", "dft"])
def test_sharded_checkpoints_move_between_topologies_and_packages(tmp_path, scene):
    """A sharded run checkpointing at step 10 of 20 resumes unsharded in the
    port (bit for bit the straight run) and in the JAX package, and a JAX
    sharded checkpoint resumes sharded in the port (fp64; fields, psi and P
    at rtol 1e-11 / atol 1e-15, the phasors within an fp32 ulp of their
    scale).  The counterparts of ``tests/test_pml.py:530``,
    ``tests/test_dispersive.py:290`` and ``tests/test_monitors.py:323``."""
    jp = _params(steps=20)
    half = dataclasses.replace(jp, simulation_time=9.5e-12)
    p, p_half = convert.params_from(jp), convert.params_from(half)
    if scene == "pml":
        jkw, tkw = dict(pml=JPMLConfig(cells=3)), dict(pml=PMLConfig(cells=3))
    elif scene == "debye":
        jdm = jd.water_debye_load(jp, sigma_ion25=0.5)
        jkw = dict(materials=jdm, accumulate_power=True)
        tkw = dict(materials=convert.debye_from(jdm), accumulate_power=True)
    else:
        jkw, tkw = dict(dft=JDftConfig(FREQS)), dict(dft=DftConfig(FREQS))
    straight = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "s"), **_quiet(**tkw))
    runner.run_simulation(p_half, "cpu", out_dir=str(tmp_path / "a"), shard="2", checkpoint_every=10,
                          **_quiet(**tkw))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    resumed = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "a"), resume=True, **_quiet(**tkw))
    for a, b in zip(resumed.state.tensors(), straight.state.tensors()):
        assert torch.equal(a, b)
    for x, y in ((resumed.psi, straight.psi), (resumed.pol, straight.pol)):
        if y is not None:
            assert all(torch.equal(a, b) for a, b in zip(x.tensors(), y.tensors()))
    if straight.dft is not None:
        assert np.array_equal(resumed.dft.phasors, straight.dft.phasors) and resumed.dft.steps == 20
    # the port's sharded checkpoint resumed in the JAX package, and a JAX sharded checkpoint in the port
    j_res = jrunner.run_simulation(jp, out_dir=str(tmp_path / "b"), resume=True, backend="xla",
                                   checkpoint_every=20, **_quiet(**jkw))
    jrunner.run_simulation(half, out_dir=str(tmp_path / "c"), shard="2", backend="xla", checkpoint_every=10,
                           **_quiet(**jkw))
    t_res = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "c"), resume=True, shard="2", **_quiet(**tkw))
    aux = _jax_aux(tmp_path / "b")
    for res in (j_res, t_res):
        for c in COMPONENTS:
            _close(np.asarray(getattr(res.state, c)), getattr(straight.state, c).numpy(), c)
    if scene == "pml":
        for n in PsiState.names():
            _close(aux[f"psi_{n}"], getattr(straight.psi, n).numpy(), n)
            _close(getattr(t_res.psi, n).numpy(), getattr(straight.psi, n).numpy(), n)
    if scene == "debye":
        for n, t, u in zip(POL, straight.pol.tensors(), t_res.pol.tensors()):
            _close(aux[n], t.numpy(), n)
            _close(u.numpy(), t.numpy(), n)
    if scene == "dft":
        scale = float(np.abs(straight.dft.phasors).max())
        for res in (j_res, t_res):
            assert res.dft.steps == 20
            np.testing.assert_allclose(res.dft.phasors, straight.dft.phasors, rtol=0, atol=2.0**-23 * scale)


# -- the pieces: psi parts, the memory model, routing, the CLI -----------------

@pytest.mark.parametrize("shape, height", [((2, 1, 1), 0.01), ((4, 1, 1), 0.0115), ((2, 3, 1), 0.0115),
                                           ((1, 1, 3), 0.01)])
def test_psi_parts_tile_the_canonical_arrays(shape, height):
    """Each element of every canonical psi array lies in exactly one
    shard's part (:func:`cpml.psi_part_slices`), cut and join are inverse,
    and the 4-slab mesh has k slabs straddling two shards."""
    p = convert.params_from(_params(height=height))
    cfg = PMLConfig(cells=3)
    rng = np.random.default_rng(4)
    psi = init_psi(p, cfg, "cpu")
    for t in psi.tensors():
        t.copy_(torch.tensor(rng.uniform(-1, 1, tuple(t.shape))))
    boxes = M.shard_boxes(p, M.make_mesh(shape, "cpu"), 1)
    count = {n: torch.zeros(t.shape, dtype=torch.int64) for n, t in zip(PsiState.names(), psi.tensors())}
    back = PsiState(*(torch.full_like(t, float("nan")) for t in psi.tensors()))
    straddle = False
    for box in boxes:
        parts = cpml.psi_part_slices(p, cfg, box)
        for n in PsiState.names():
            count[n][parts[n]] += 1
        cpml.join_psi(p, cfg, cpml.cut_psi(p, cfg, psi, box, "cpu"), box, back)
        rows = parts["hx_z"][0]
        straddle |= 0 < rows.stop - rows.start < cfg.cells
    for n in PsiState.names():
        assert bool((count[n] == 1).all()), n
        assert torch.equal(getattr(back, n), getattr(psi, n)), n
    assert straddle == (shape == (4, 1, 1))


def _march_scene(n, height=None):
    """An ``n``-cell cube (``height`` cells along k when given) in the port's
    Params."""
    h = (height or n) * 0.001
    return convert.params_from(Params(length=n * 0.001, width=n * 0.001, height=h, spatial_step=0.001,
                                      time_step=1e-12, simulation_time=1e-11, sampling_rate=5,
                                      mode=Mode.COMPUTATION, dtype="float32"))


@pytest.mark.parametrize("n, height, shape, cells", [
    (20, None, None, 3), (50, None, None, 10), (256, None, None, 10),   # the whole grid
    (256, None, (4, 1, 1), 10),    # --shard 4: 65, 65, 65, 62 planes, middle shards hold no k slab row
    (256, None, (2, 2, 1), 10),    # --shard 2x2: j windows of 129 (one row past whole tiles) and 128
    (34, 34, (4, 1, 1), 10),       # 35 planes over 4 (9, 9, 9, 8): the 10-cell k slabs straddle shards
    (30, 34, (3, 1, 1), 10), (30, 34, (2, 3, 1), 10), (20, 20, (1, 1, 3), 3)])
def test_march_launch_covers_every_owned_cell_once(n, height, shape, cells):
    """The launch of the two-pass CPML kernels (``stream_plan.march_plan``:
    tiles, the extra row and column, the k chunks; threads mapped to cells
    by ``march_counts`` as ``csrc/yee_twopass.cu::march_kernel`` maps them)
    updates every cell of each component's staggered update region in a
    box's owned window exactly once and nothing else, on the whole grid and
    on the boxes ``parallel/mesh.py::shard_boxes`` gives; the psi rows the
    updates touch are exactly the box's parts (``cpml.psi_part_slices``),
    each element once; ``march_geometry`` carries the box, the parts and
    the chunk depth."""
    p = _march_scene(n, height)
    cfg = PMLConfig(cells=cells)
    boxes = [None] if shape is None else M.shard_boxes(p, M.make_mesh(shape, "cpu"), 1)
    regions = cpml._update_regions(p)
    shapes = cpml.psi_shapes(p, cfg)
    straddle = extras = False
    for e_pass in (False, True):
        targets = ("ex", "ey", "ez") if e_pass else ("hx", "hy", "hz")
        for box in boxes:
            own = box or cpml.full_box(p)
            plan = stream_plan.march_plan(p, box, e_pass)
            counts = stream_plan.march_counts(p, plan, e_pass)
            extras |= any(plan.extra)
            for c, target in enumerate(targets):
                want = np.zeros(p.padded_shape, np.int8)
                want[tuple(slice(max(r.start, lo), min(r.stop, hi))
                           for r, lo, hi in zip(regions[target], own.own_lo, own.own_hi))] = 1
                np.testing.assert_array_equal(counts[c], want, err_msg=f"{target} on {own}")
            parts = cpml.psi_part_slices(p, cfg, box)
            for name, target, _sign, axis, _src, e in cpml._TERMS:
                if e != e_pass:
                    continue
                lo_sl, hi_sl = cpml._slab_slices(regions[target], axis, cfg.cells)
                c = targets.index(target)
                touched = np.concatenate([counts[c][lo_sl], counts[c][hi_sl]], axis=axis)
                want = np.zeros(shapes[name], np.int8)
                want[parts[name]] = 1
                np.testing.assert_array_equal(touched, want, err_msg=f"{name} on {own}")
                rows = parts[name][axis]
                straddle |= axis == 0 and 0 < rows.stop - rows.start < cfg.cells
            geom = stream_plan.march_geometry(p, cfg, box, e_pass)
            window = [x for lo_hi in zip(own.own_lo, own.own_hi) for x in lo_hi]
            assert geom == (*own.shape, *own.lo, *window,
                            *cpml.psi_part_geometry(p, cfg, own, cpml.E_TERMS if e_pass else cpml.H_TERMS), plan.tk)
            assert plan.tk == stream_plan.pick_march_tk(plan.window[0][1] - plan.window[0][0],
                                                        plan.tiles[0] * plan.tiles[1])
    assert straddle == (height == 34 and shape == (4, 1, 1))
    assert extras or n < 256  # at 256^3: 257 columns, or a j window of 129 rows, one past whole tiles


def test_march_plan_fills_the_card_in_whole_waves():
    """At 256^3 the H pass's 257 columns take 2 tiles of 128 and its 257
    rows 128 tiles of 2 (the last row and column go to edge blocks; the
    first design's 64 x 4 blocks left a fifth block a row with one cell of
    64), the E pass's 256 x 256 whole tiles; the chunks give every block
    slot of the card (four an SM) a block in two waves, on the whole grid
    and on a middle shard of --shard 4 (65 planes)."""
    p = _march_scene(256)
    slots = stream_plan.SM_COUNT * stream_plan.MARCH_BLOCKS_PER_SM
    h, e = (stream_plan.march_plan(p, None, e_pass) for e_pass in (False, True))
    assert h.tiles == e.tiles == (128, 2) and h.extra == (True, True) and e.extra == (False, False)
    assert (h.tk, e.tk) == (65, 64) and h.edge_cells == 513 and e.edge_cells == 0
    mid = M.shard_boxes(p, M.make_mesh((4, 1, 1), "cpu"), 1)[1]
    hm = stream_plan.march_plan(p, mid, False)
    assert hm.window[0] == (65, 130) and hm.tk == 17 and hm.chunks == 4
    for plan in (h, e, hm):
        tile_blocks = plan.tiles[0] * plan.tiles[1] * plan.chunks
        assert slots <= tile_blocks <= 2 * slots
    # a box whose window holds no cell the E pass updates (the top wall plane alone)
    top = dataclasses.replace(cpml.full_box(p), own_lo=(256, 0, 0))
    assert stream_plan.march_plan(p, top, True) is None and stream_plan.march_plan(p, top, False) is not None



def _ragged_scene(width=0.0265):
    """The 35 x 27 x 31 box of ``tune_twopass``'s checks (34 x 26 x 30
    cells); ``width`` 0.0285: 35 x 29 x 31, whose H pass leaves narrow
    tiles one row short (edge blocks)."""
    return convert.params_from(Params(length=0.0305, width=width, height=0.0345, spatial_step=0.001,
                                      time_step=1e-12, simulation_time=1e-11, sampling_rate=5,
                                      mode=Mode.COMPUTATION, dtype="float32"))


@pytest.mark.parametrize("n, members", [(256, 4), (64, 8), ("ragged", 3), ("ragged29", 3)])
def test_batched_march_launch_covers_each_member_once(n, members):
    """The batched vacuum passes of a sweep (``march_kernel`` with
    ``BATCH``: member b on ``blockIdx.y`` = b, its arrays from
    ``member_start`` on): ``march_counts`` of the batched plan updates each
    member's cells of each component's update region exactly once and
    nothing else, at 257^3 x 4 (2 x 128 tiles, edge blocks), 65^3 x 8 and
    ragged 35 x 27 x 31 x 3 and 35 x 29 x 31 x 3 batches (narrow members:
    4 x 64 tiles; at 65^3 and 35 x 29 x 31 with edge blocks); the chunk
    depth, which ``march_geometry`` carries, is ``pick_batch_tk``'s for the
    dtype."""
    p = (_ragged_scene() if n == "ragged" else _ragged_scene(0.0285) if n == "ragged29" else _march_scene(n))
    regions = cpml._update_regions(p)
    for e_pass in (False, True):
        targets = ("ex", "ey", "ez") if e_pass else ("hx", "hy", "hz")
        plan = stream_plan.march_plan(p, None, e_pass, members=members)
        one = stream_plan.march_plan(p, None, e_pass)
        width = plan.window[2][1] - plan.window[2][0]
        assert (plan.window, plan.members) == (one.window, members)
        assert stream_plan.batch_is_narrow(width) == (n != 256)
        assert (plan.ahead, plan.bj, plan.blocks_per_sm, plan.bi) == (
            stream_plan.MARCH_BATCH_NARROW if n != 256 else stream_plan.MARCH_BATCH_WIDE)
        assert (one.ahead, one.bj, one.blocks_per_sm, one.bi) == (
            stream_plan.MARCH_AHEAD, stream_plan.MARCH_BJ, stream_plan.MARCH_BLOCKS_PER_SM, stream_plan.MARCH_BI)
        tiles = plan.tiles[0] * plan.tiles[1]
        planes = plan.window[0][1] - plan.window[0][0]
        assert plan.tk == stream_plan.pick_batch_tk(planes, members * tiles, stream_plan.MARCH_BATCH_TK)
        assert plan.blocks == members * plan.member_blocks
        counts = stream_plan.march_counts(p, plan, e_pass)
        assert counts.shape == (members, 3) + p.padded_shape
        for c, target in enumerate(targets):
            want = np.zeros(p.padded_shape, np.int8)
            want[regions[target]] = 1
            for b in range(members):
                np.testing.assert_array_equal(counts[b, c], want, err_msg=f"{target} of member {b}")
        geom = stream_plan.march_geometry(p, None, None, e_pass, members=members)
        assert geom[:-1] == stream_plan.march_geometry(p, None, None, e_pass)[:-1] and geom[-1] == plan.tk
    assert any(stream_plan.march_plan(p, None, False, members=members).extra) == (n != "ragged")  # edge blocks
    with pytest.raises(ValueError, match="1 to 65535 members"):
        stream_plan.march_plan(p, None, False, members=stream_plan.MARCH_MEMBERS + 1)


def test_batched_march_plan_fills_the_card():
    """A batch has members x as many tiles as one grid, and marches chunks of
    at most ``MARCH_BATCH_TK`` = 6 planes (one chunk of every member's
    planes, which the whole-wave rule of ``pick_march_tk`` gives 256^3 x 4,
    ran 11-14% slower): at 256^3 x 4 the 257 (256) planes in 43 chunks of
    6 on the wide shape; at 64^3 x 8 the narrow members' 16 tiles of 4 x 64
    in 11 chunks of 6; every batched plan gives each block slot of the card
    a block, with the deepest split that does."""
    slots = stream_plan.SM_COUNT * stream_plan.MARCH_BLOCKS_PER_SM
    p = _march_scene(256)
    h, e = (stream_plan.march_plan(p, None, e_pass, members=4) for e_pass in (False, True))
    assert (h.tk, e.tk, h.chunks, e.chunks) == (6, 6, 43, 43)
    assert h.tiles == e.tiles == (128, 2) and h.edge_cells == 513 and e.edge_cells == 0
    assert stream_plan.pick_march_tk(257, 4 * 256) == 257  # the whole-wave rule: one chunk, two waves
    q = _march_scene(64)
    hq = stream_plan.march_plan(q, None, False, members=8)
    assert hq.tiles == (16, 1) and hq.extra == (True, True) and (hq.tk, hq.chunks) == (6, 11)
    for n, members in ((256, 4), (64, 8), (64, 2), (16, 3)):
        for e_pass in (False, True):
            plan = stream_plan.march_plan(_march_scene(n), None, e_pass, members=members)
            tile_blocks = members * plan.tiles[0] * plan.tiles[1] * plan.chunks
            planes = plan.window[0][1] - plan.window[0][0]
            splits = {-(-planes // c) for c in range(1, planes + 1)}
            fill = [tk for tk in splits if tk <= stream_plan.MARCH_BATCH_TK
                    and -(-planes // tk) * (tile_blocks // plan.chunks) >= slots]
            assert plan.tk == (max(fill) if fill else 1) and plan.waves == plan.blocks / slots, (n, members, e_pass)
            assert tile_blocks >= slots or plan.tk == 1


@pytest.mark.parametrize("dtype, item", [(torch.float32, 4), (torch.bfloat16, 2)])
def test_member_lead_covers_every_lead(dtype, item):
    """``stream_plan.member_lead`` (the kernel's ``member_lead``, each
    block's lead at its start) gives where each member's view of a batch
    starts within 16 bytes, from every lead of member 0 (a batch cut out of
    a larger buffer at each element offset); an odd member size moves the
    lead by one element or its complement a member, so 257^3 x 4 takes the
    four fp32 leads, 65^3 x 8 and the ragged batches of 8 every bf16 lead."""
    ce = 16 // item
    ragged = (_ragged_scene().padded_shape, _ragged_scene(0.0285).padded_shape)
    for shape, members in (((65, 65, 65), 8), (ragged[0], 8), (ragged[1], 8), (ragged[0], 3)):
        elems = int(np.prod(shape))
        buf = torch.empty(members * elems + ce, dtype=dtype)
        for off in range(ce):
            batch = buf[off:off + members * elems].view((members,) + shape)
            lead0 = batch[0].data_ptr() % 16 // item
            got = [batch[b].data_ptr() % 16 // item for b in range(members)]
            want = [stream_plan.member_lead(lead0, stream_plan.member_start(b, shape), item)
                    for b in range(members)]
            assert got == want, (shape, off)
            if members == 8:
                assert sorted(set(got)) == list(range(ce)), (shape, off, got)
    leads = {stream_plan.member_lead(0, stream_plan.member_start(b, (257,) * 3), 4) for b in range(4)}
    assert leads == {0, 1, 2, 3}

def test_shard_bytes_counts_the_new_parts():
    """psi parts, P, the Debye maps and work arrays and the sums per
    device, beside the canonical arrays the run gathers into."""
    p = convert.params_from(Params(length=0.256, width=0.256, height=0.256, spatial_step=0.001, time_step=1e-12,
                                   simulation_time=1e-9, sampling_rate=100, mode=Mode.COMPUTATION))
    mesh = M.make_mesh((4, 1, 1), "cpu")
    boxes = M.shard_boxes(p, mesh, 1)
    shapes = [(b.shape, int(np.prod(b.cell_shape(p)))) for b in boxes]
    dev = torch.device("cpu")
    cfg, dft = PMLConfig(cells=10), DftConfig((2.45e10,))
    psi = [sum(int(np.prod(s)) for s in cpml.psi_part_shapes(p, cfg, b).values()) for b in boxes]
    base = stream_plan.shard_bytes(p, shapes, mesh.devices, dev, False)[dev]
    with_pml = stream_plan.shard_bytes(p, shapes, mesh.devices, dev, False, pml=cfg, psi_elems=psi)[dev]
    assert sum(psi) * 4 == cpml.psi_bytes(p, cfg) and with_pml - base == 2 * cpml.psi_bytes(p, cfg)
    with_dft = stream_plan.shard_bytes(p, shapes, mesh.devices, dev, False, dft=dft)[dev]
    from fdtd_tpu_torch.dft import acc_bytes

    assert with_dft - base == 2 * acc_bytes(p, dft)
    ade = stream_plan.shard_bytes(p, shapes, mesh.devices, dev, False, sar=True, ade=True)[dev]
    elems = sum(int(np.prod(s)) for s, _c in shapes)
    temps = stream_plan.ADE_TORCH_TEMPS * 4 * max(int(np.prod(s)) for s, _c in shapes)
    sar = stream_plan.shard_bytes(p, shapes, mesh.devices, dev, False, sar=True)[dev]
    assert ade - sar == (3 + 18) * 4 * elems + 3 * 4 * elems + temps + stream_plan.pol_bytes(p)
    assert stream_plan.shard_fits({dev: ade}, {}) and ade < 40e9


def test_sharded_routing_off_the_card(tmp_path):
    """On the CPU every composition runs the sharded torch step; Debye
    media ignore an explicit backend with the JAX package's notice; the
    kernels' names raise as they do unsharded; Debye x CPML keeps the JAX
    refusal."""
    jp = _params(steps=4)
    p = convert.params_from(jp)
    debye = convert.debye_from(jd.water_debye_load(jp))
    for kw in ({"pml": PMLConfig(cells=3)}, {"dft": DftConfig(FREQS)}, {"probes": ProbeSet(CELLS)},
               {"materials": debye}):
        _, run = runner.sharded_runner(p, "2", "cpu", log=lambda m: None, **kw)
        assert run.backend == "torch" and run.depth == 1
    notices = []
    _, run = runner.sharded_runner(p, "2", "cpu", materials=debye, backend="pallas_stream", log=notices.append)
    assert run.backend == "torch" and any("dispersive media under --shard" in m for m in notices)
    with pytest.raises(ValueError, match="use --backend torch"):
        runner.sharded_runner(p, "2", "cpu", backend="twopass", pml=PMLConfig(cells=3), log=lambda m: None)
    with pytest.raises(ValueError, match=r"^dispersive media with --pml run single-chip for now \(no --shard\)$"):
        runner.run_simulation(p, "cpu", out_dir=str(tmp_path), shard="2x2", materials=debye,
                              pml=PMLConfig(cells=3), **_quiet())


def test_cli_shard_writes_the_unsharded_monitor_outputs(tmp_path):
    """``--shard 2x2`` with ``--pml 3 --dft ... --dft-fields eh --probe``
    writes the unsharded run's dft_00.vtr, probes.csv, snapshots and
    energy log, bit for bit."""
    params = tmp_path / "p.txt"
    params.write_text("0.01 0.01 0.01 0.001 1e-12 1.2e-11 6 1")
    argv = ["--device", "cpu", "--pml", "3", "--dft", "2.45e10", "--dft-fields", "eh", "--probe", "2,3,4",
            "--probe", "7,5,5"]
    for sub, extra in (("one", []), ("zy", ["--shard", "2x2"])):
        assert cli.main([str(params), *argv, "--out", str(tmp_path / sub), "--diag-log",
                         str(tmp_path / f"{sub}.jsonl"), *extra]) == 0
    names = sorted(os.listdir(tmp_path / "one"))
    assert {"dft_00.vtr", "probes.csv", "result0006.vtr"} <= set(names) and names == sorted(os.listdir(tmp_path / "zy"))
    for name in names:
        if name.endswith(".vtr"):
            a, b = (read_vtr_cell_arrays(str(tmp_path / d / name)) for d in ("one", "zy"))
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}/{k}")
        else:
            assert (tmp_path / "one" / name).read_text() == (tmp_path / "zy" / name).read_text(), name
    assert (tmp_path / "one.jsonl").read_text() == (tmp_path / "zy.jsonl").read_text()
