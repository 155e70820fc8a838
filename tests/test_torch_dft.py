"""The port's DFT (``fdtd_tpu_torch/dft.py``, ``ops/dft.py``, the DFT bands
of ``ops/stream.py``) against the JAX package's.

- the pieces (config checks, weights, one step of the sums, the 2/N and
  half-step finalize, magnitude, CW power, Poynting) on equal inputs: bit
  for bit in fp32, fp64 at rtol 1e-15;
- the plain version of K4 (the ``dft_accum`` kernel) against the
  interpret-mode ``build_dft_accum_call`` through ``embed_dft_acc`` /
  ``crop_dft_acc``, nf = 2: fp32 within 1e-7 of the sums' scale, bf16
  fields within one fp32 ulp of it;
- the plain sweep with the DFT bands (vacuum and lossy + SAR, two
  frequencies, 12^3 x 22 steps: sweeps and trailing two-pass steps)
  against the interpret-mode ``make_stream_dft_chunk_runner`` that
  ``run_simulation(backend="pallas_stream")`` runs: phasors atol 1e-6 x
  scale, fields 5e-7, SAR rtol 3e-6 (``tests/test_dft.py``'s bars);
- the port against itself: stream (plain) = twopass (plain) + K4 = torch,
  fp32 bit for bit, every variant with bands;
- the stream plans with bands, the shared-memory limit on nf (past it the
  bands' means mode), the memory model and the routing of every monitored
  scene.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import dft as jdft  # noqa: E402
from fdtd_tpu.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu.runner import run_simulation as j_run  # noqa: E402
from fdtd_tpu.state import water_block as j_water_block  # noqa: E402
from fdtd_tpu_torch import convert, dft, runner  # noqa: E402
from fdtd_tpu_torch.grid import COMPONENTS  # noqa: E402
from fdtd_tpu_torch.monitors import ProbeSet  # noqa: E402
from fdtd_tpu_torch.ops import dft as dft_ops  # noqa: E402
from fdtd_tpu_torch.ops import stream, stream_plan  # noqa: E402
from fdtd_tpu_torch.ops.cpml import PMLConfig, init_psi  # noqa: E402
from fdtd_tpu_torch.ops.dispersive import DebyeMaterials, water_debye_load, zero_polarization  # noqa: E402
from fdtd_tpu_torch.state import ferrite_slab, water_block  # noqa: E402
from fdtd_tpu_torch.step import make_chunk_runner, scan_inputs, zero_power_acc  # noqa: E402


def _box(n, steps, dtype="float32", mode=Mode.COMPUTATION):
    return Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=1e-3, time_step=1e-12,
                  simulation_time=(steps - 0.5) * 1e-12, sampling_rate=10**9, mode=mode, dtype=dtype)


# --- the pieces ---------------------------------------------------------------------------------

def test_config_checks_and_weights_are_the_jax_packages():
    for bad, msg in (((), "at least one"), ((2.45e9, -1.0), "positive")):
        with pytest.raises(ValueError, match=msg):
            dft.DftConfig(bad)
        with pytest.raises(ValueError, match=msg):
            jdft.DftConfig(bad)
    with pytest.raises(ValueError, match="'e' or 'eh'"):
        dft.DftConfig((1e9,), fields="x")
    cfg, jcfg = dft.DftConfig((2.45e10, 1e9), "eh"), jdft.DftConfig((2.45e10, 1e9), "eh")
    assert (cfg.nf, cfg.nc, cfg.frequencies) == (jcfg.nf, jcfg.nc, jcfg.frequencies) == (2, 6, (2.45e10, 1e9))
    ts = time_values(_box(8, 40))
    for a, b in zip(dft.dft_weights(cfg, ts), jdft.dft_weights(jcfg, ts)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert dft.supported_backend("torch") and dft.supported_backend("twopass") and not dft.supported_backend("stream")
    assert jdft.supported_backend("xla") and not jdft.supported_backend("pallas_stream")


def test_accumulate_is_the_jax_packages_bit_for_bit():
    p = _box(6, 4)
    rng = np.random.default_rng(3)
    cfg = dft.DftConfig((2.45e10, 1.5e10))
    cells = [rng.uniform(-1, 1, (p.maxk, p.maxj, p.maxi)).astype(np.float32) for _ in range(3)]
    cw, sw = (rng.uniform(-1, 1, 2).astype(np.float32) for _ in range(2))
    acc0 = [rng.uniform(-1, 1, dft.acc_shape(p, cfg)).astype(np.float32) for _ in range(2)]
    want = jdft.accumulate(p, [jnp.asarray(c) for c in cells], jnp.asarray(cw), jnp.asarray(sw),
                           tuple(jnp.asarray(a) for a in acc0))
    got = tuple(torch.tensor(a) for a in acc0)
    dft.accumulate([torch.tensor(c) for c in cells], torch.tensor(cw), torch.tensor(sw), got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the H components of "eh" go to components 3..5
    six = tuple(torch.zeros((2, 6, p.maxk, p.maxj, p.maxi)) for _ in range(2))
    dft.accumulate([torch.tensor(c) for c in cells], torch.tensor(cw), torch.tensor(sw), six, c0=3)
    np.testing.assert_array_equal(six[0][:, 3:].numpy(), np.asarray(jdft.accumulate(
        p, [jnp.asarray(c) for c in cells], jnp.asarray(cw), jnp.asarray(sw),
        (jnp.zeros((2, 3, p.maxk, p.maxj, p.maxi)),) * 2)[0]))
    assert float(six[0][:, :3].abs().max()) == 0


@pytest.mark.parametrize("fields", ["e", "eh"])
def test_finalize_and_result_maps_match_jax(fields):
    p = _box(6, 4)
    rng = np.random.default_rng(4)
    cfg, jcfg = dft.DftConfig((2.45e10, 3e9), fields), jdft.DftConfig((2.45e10, 3e9), fields)
    acc = [rng.uniform(-1, 1, dft.acc_shape(p, cfg)).astype(np.float32) for _ in range(2)]
    got = dft.finalize(cfg, tuple(torch.tensor(a) for a in acc), 37, time_step=p.time_step)
    want = jdft.finalize(jcfg, tuple(jnp.asarray(a) for a in acc), 37, time_step=p.time_step)
    assert got.phasors.dtype == np.complex128 and got.steps == 37 and got.fields == fields
    np.testing.assert_allclose(got.phasors, want.phasors, rtol=1e-15, atol=0)
    sigma = rng.uniform(0, 2, (p.maxk, p.maxj, p.maxi))
    for fi in (0, 1):
        np.testing.assert_allclose(got.magnitude(fi), want.magnitude(fi), rtol=1e-15)
        np.testing.assert_allclose(got.cw_power(sigma, fi), want.cw_power(sigma, fi), rtol=1e-15)
        if fields == "eh":
            np.testing.assert_allclose(got.poynting(fi), want.poynting(fi), rtol=1e-15, atol=1e-300)
        else:
            with pytest.raises(ValueError, match="eh"):
                got.poynting(fi)
    if fields == "eh":
        with pytest.raises(ValueError, match="time_step"):
            dft.finalize(cfg, tuple(torch.tensor(a) for a in acc), 37)


# --- K4 -------------------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k4_matches_interpret_dft_accum_call(dtype):
    from fdtd_tpu.ops.pallas_fused import to_stripped
    from fdtd_tpu.ops.pallas_stream import build_dft_accum_call, crop_dft_acc, embed_dft_acc
    from fdtd_tpu.state import FieldState as JFieldState

    p = _box(10, 4, dtype)
    tp = convert.params_from(p)
    rng = np.random.default_rng(5)
    arrays = {c: rng.uniform(-1, 1, p.padded_shape) for c in COMPONENTS}
    for c in ("ey", "ez"):  # the PEC wall at i = maxi (the TPU layout's zero last lane)
        arrays[c][:, :, p.maxi] = 0.0
    nf = 2
    shape = (nf, 3, p.maxk, p.maxj, p.maxi)
    acc0 = [rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(2)]
    w = rng.uniform(-1, 1, (2, nf)).astype(np.float32)
    js = JFieldState(**{c: jnp.asarray(a, p.dtype) for c, a in arrays.items()})
    st = to_stripped(p, js)
    call = build_dft_accum_call(p, nf, interpret=True)
    out = call(st.ex, st.ey, st.ez, jnp.asarray(w.reshape(1, 2 * nf)), embed_dft_acc(p, acc0, nf))
    want = [np.asarray(a) for a in crop_dft_acc(p, out, nf)]
    s = convert.state_from_numpy({c: np.asarray(getattr(js, c), np.float64) for c in COMPONENTS}, "cpu",
                                 torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = tuple(torch.tensor(a) for a in acc0)
    dft_ops.accumulate_e(tp, s, torch.tensor(w), got)
    assert dft_ops.launches["dft_accum"] == 0  # CPU tensors: the plain version
    for g, wa in zip(got, want):
        scale = float(np.abs(wa).max())
        tol = 1e-7 * scale if dtype == "float32" else 2.0**-23 * scale
        np.testing.assert_allclose(g.numpy(), wa, rtol=0, atol=tol)
        assert float(np.abs(g.numpy() - acc0[0]).max()) > 0 or g is got[1]


def test_k4_wrapper_refuses_what_the_kernel_does_not_take():
    p = convert.params_from(_box(6, 4))
    s = convert.state_from_numpy({c: np.zeros(p.padded_shape) for c in COMPONENTS}, "cpu", torch.float32)
    sums = dft.zero_dft_acc(p, dft.DftConfig((1e9,)), "cpu")
    with pytest.raises(ValueError, match="weights"):
        dft_ops.accumulate_e(p, s, torch.zeros((2, 2)), sums)
    with pytest.raises(ValueError, match="DFT sums"):
        dft_ops.accumulate_e(p, s, torch.zeros((2, 1)), (sums[0].double(), sums[1]))


# --- the DFT bands of the sweep -------------------------------------------------------------------

def _port_chunk(p, mats, backend, steps, cfg, sar=False, pml=None):
    tv = time_values(p)[:steps]
    xs = scan_inputs(p, tv) + dft.dft_weights(cfg, tv)
    s = convert.state_from_numpy({c: np.zeros(p.padded_shape) for c in COMPONENTS}, "cpu",
                                 torch.float32 if p.dtype == "float32" else torch.float64)
    power = zero_power_acc(p, "cpu") if sar else None
    psi = init_psi(p, pml, "cpu") if pml is not None else None
    pol = zero_polarization(p, "cpu") if isinstance(mats, DebyeMaterials) else None
    sums = dft.zero_dft_acc(p, cfg, "cpu")
    make_chunk_runner(p, "cpu", mats, backend, accumulate_power=sar, pml=pml, dft=cfg)(s, xs, power, psi, pol, sums)
    return s, power, psi, pol, sums


@pytest.mark.parametrize("lossy_sar", [False, True])
def test_plain_k3_bands_match_interpret_stream_dft(lossy_sar):
    n = 23  # an odd count: the port's sweeps (s = 4 vacuum, 2 lossy + SAR) leave trailing steps
    p = _box(12, n)
    jm = j_water_block(p) if lossy_sar else None
    jcfg = jdft.DftConfig((p.source.frequency, 1.5e10))
    want = j_run(p, materials=jm, write_snapshots=False, backend="pallas_stream", dft=jcfg,
                 accumulate_power=lossy_sar, log=lambda m: None)
    tp = convert.params_from(p)
    cfg = dft.DftConfig(jcfg.frequencies)
    plan = stream_plan.pick_plan(tp, lossy=lossy_sar, sar=lossy_sar, dft=cfg)
    assert n % plan.s  # trailing two-pass steps with dft_accum
    s, power, _, _, sums = _port_chunk(tp, convert.materials_from(jm) if jm else None, "stream", n, cfg, lossy_sar)
    got = dft.finalize(cfg, sums, n)
    scale = float(np.abs(want.dft.phasors).max())
    np.testing.assert_allclose(got.phasors, want.dft.phasors, rtol=0, atol=1e-6 * scale)
    for c in COMPONENTS:
        np.testing.assert_allclose(getattr(s, c).numpy(), np.asarray(getattr(want.state, c)), rtol=0, atol=5e-7,
                                   err_msg=c)
    if lossy_sar:
        np.testing.assert_allclose(power.numpy(), np.asarray(want.power_j), rtol=3e-6, atol=1e-18)


_VARIANTS = {
    "vacuum": dict(), "water": dict(mats="water"), "water_sar": dict(mats="water", sar=True),
    "ferrite": dict(mats="ferrite"), "ferrite_sar": dict(mats="ferrite", sar=True), "pml": dict(pml=1),
    "water_pml": dict(mats="water", pml=1), "debye": dict(mats="debye"), "debye_sar": dict(mats="debye", sar=True),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_stream_equals_twopass_plus_k4_equals_torch(variant):
    """fp32, two frequencies, 23 steps (sweeps and trailing steps): the
    plain sweep with bands = the plain two-pass steps with K4's plain
    version = torch, fields, sums, SAR map, psi and P bit for bit."""
    kw = _VARIANTS[variant]
    p = convert.params_from(_box(12, 23))
    mats = {"water": water_block(p), "ferrite": ferrite_slab(p, base=water_block(p)),
            "debye": water_debye_load(p), None: None}[kw.get("mats")]
    pml = PMLConfig(cells=kw["pml"]) if "pml" in kw else None
    sar = kw.get("sar", False)
    cfg = dft.DftConfig((2.45e10, 1.5e10))
    plan = stream_plan.pick_plan(p, lossy=mats is not None and not isinstance(mats, DebyeMaterials),
                                 het=variant.startswith("ferrite"), sar=sar, pml=pml,
                                 ade=isinstance(mats, DebyeMaterials), dft=cfg)
    assert plan is not None and plan.dft and plan.kernel.endswith("_dft") and 23 % plan.s
    runs = {b: _port_chunk(p, mats, b, 23, cfg, sar, pml) for b in ("stream", "twopass", "torch")}
    assert float(runs["torch"][4][0].abs().max()) > 0
    for b in ("twopass", "torch"):
        for got, want in zip(runs["stream"], runs[b]):
            if got is None:
                continue
            ga = got.tensors() if hasattr(got, "tensors") else got if isinstance(got, tuple) else (got,)
            wa = want.tensors() if hasattr(want, "tensors") else want if isinstance(want, tuple) else (want,)
            for x, y in zip(ga, wa):
                assert torch.equal(x, y), (variant, b)


def test_sweep_checks_its_dft_inputs():
    p = convert.params_from(_box(12, 4))
    cfg = dft.DftConfig((2.45e10,))
    plan = stream_plan.pick_plan(p, dft=cfg)
    from fdtd_tpu_torch.state import FieldState, update_coefs

    s = convert.state_from_numpy({c: np.zeros(p.padded_shape) for c in COMPONENTS}, "cpu", torch.float32)
    out = FieldState(*(torch.empty_like(t) for t in s.tensors()))
    with pytest.raises(ValueError, match="DFT sums"):
        stream.sweep(p, s, out, update_coefs(p), plan)
    sums = dft.zero_dft_acc(p, cfg, "cpu")
    with pytest.raises(ValueError, match="weight rows"):
        stream.sweep(p, s, out, update_coefs(p), plan, dacc=sums)
    with pytest.raises(ValueError, match="weights"):
        stream.sweep(p, s, out, update_coefs(p), plan, dacc=sums, wts=torch.zeros((plan.s, 2, 2)))


# --- plans, memory, routing ----------------------------------------------------------------------

def test_dft_plans_and_the_shared_memory_limit():
    p = convert.params_from(_box(256, 4))
    one, two, three = (dft.DftConfig(tuple(1e9 * (k + 1) for k in range(n))) for n in (1, 2, 3))
    heat = stream_plan.pick_plan(p, lossy=True, sar=True, dft=one)
    assert (heat.s, heat.bj, heat.cr, heat.kernel, heat.dft_max_nf) == (2, 24, True, "yee_stream_lossy_sar_dft", 3)
    assert heat.tj == heat.bj - 2 * heat.s - 1  # the cell means: one column fewer
    assert heat.smem_bytes + heat.dft_smem_bytes(2) <= stream_plan.SMEM_PER_BLOCK
    assert stream_plan.pick_plan(p, dft=two).kernel == "yee_stream_dft"
    # three frequencies: past the vacuum bands' shared memory, their means mode
    vac3 = stream_plan.pick_plan(p, dft=three)
    assert (vac3.kernel, vac3.s, vac3.dft_max_nf, vac3.fold) == ("yee_stream_dft_means", 4, 0, stream_plan.FOLD_DEPTH)
    assert vac3.dft_smem_bytes(3) == 0
    assert stream_plan.pick_plan(p, pml=PMLConfig(cells=10), dft=three).dft_max_nf == 5
    assert stream_plan.pick_plan(p, sar=True, ade=True, dft=three).kernel == "yee_stream_ade_sar_dft"
    # fields "eh" and validation mode need per-step states
    assert stream_plan.pick_plan(p, dft=dft.DftConfig((1e9,), "eh")) is None
    assert stream_plan.pick_plan(dataclasses.replace(p, mode=Mode.VALIDATION), dft=one) is None
    # the sums count in both footprints and in the bytes a sweep moves
    assert stream_plan.stream_bytes(p, dft=two) - stream_plan.stream_bytes(p) == dft.acc_bytes(p, two)
    assert stream_plan.twopass_bytes(p, dft=two) - stream_plan.twopass_bytes(p) == dft.acc_bytes(p, two)
    assert heat.bytes_per_cell_step > stream_plan.plan_for(p, 4, True, sar=True).bytes_per_cell_step


def test_sums_at_1024_fit_twopass_not_stream():
    """At 1024^3 fp32 the (re, im) sums are as large as a state: a DFT run
    fits twopass + dft_accum in an H100's 80 GB, not stream."""
    p = convert.params_from(_box(1024, 4))
    cfg = dft.DftConfig((2.45e10,))
    assert dft.acc_bytes(p, cfg) == 24 * 1024**3
    assert stream_plan.supported(p) and not stream_plan.supported(p, dft=cfg)
    assert stream_plan.twopass_fits(p, dft=cfg)
    assert runner.resolve_backend(p, "auto", "cuda", dft=cfg) == "twopass"


def test_memory_warning():
    big = convert.params_from(_box(512, 4, mode=Mode.VALIDATION))
    note = runner._dft_memory_note(big, dft.DftConfig((1e9, 2e9, 3e9, 4e9), fields="eh"))
    assert note and "24.0 GB" in note
    assert runner._dft_memory_note(convert.params_from(_box(256, 4)), dft.DftConfig((1e9,))) is None
    # the JAX package's text for the same request
    from fdtd_tpu.runner import _dft_memory_note

    assert note == _dft_memory_note(_box(512, 4, mode=Mode.VALIDATION), jdft.DftConfig((1e9, 2e9, 3e9, 4e9), "eh"))


_E, _EH = dft.DftConfig((2.45e10,)), dft.DftConfig((2.45e10,), "eh")
_PROBES = ProbeSet(((1, 1, 1),))
_STREAM_NOTICE = "notice: per-step monitors (--probe/--dft eh/validation) run the twopass kernels " \
                 "(backend 'stream' ignored)"


@pytest.mark.parametrize("case, backend, device, kw, want, notice", [
    ("vacuum e", "auto", "cuda", dict(dft=_E), "stream", None),
    ("heating e", "auto", "cuda", dict(dft=_E, mats="water", sar=True), "stream", None),
    ("vacuum eh", "auto", "cuda", dict(dft=_EH), "twopass", None),
    ("probes", "auto", "cuda", dict(probes=_PROBES), "twopass", None),
    ("validation e", "auto", "cuda", dict(dft=_E, mode=Mode.VALIDATION), "twopass", None),
    ("eh stream", "stream", "cuda", dict(dft=_EH), "twopass", _STREAM_NOTICE),
    ("probes stream", "pallas_stream", "cuda", dict(dft=_E, probes=_PROBES), "twopass", _STREAM_NOTICE),
    # three frequencies take the bands' means mode; where the device's free
    # memory refuses the sweep's second state, sums and buffer (3 GB free:
    # twopass + dft_accum fits) they run twopass with the notice
    ("three frequencies stream", "stream", "cuda", dict(dft=dft.DftConfig((1e9, 2e9, 3e9)), free=3 * 10**9),
     "twopass", "notice: the DFT bands of the stream sweep do not fit this scene; running the twopass kernels with "
     "the dft_accum kernel (backend 'stream' ignored)"),
    ("pml auto", "auto", "cuda", dict(dft=_E, pml=True), "stream", None),
    ("pml stream", "stream", "cuda", dict(dft=_E, pml=True), "stream", None),
    ("pml probes stream", "stream", "cuda", dict(dft=_E, pml=True, probes=_PROBES), "twopass", _STREAM_NOTICE),
    ("debye e", "auto", "cuda", dict(dft=_E, mats="debye", sar=True), "stream", None),
    ("debye eh", "auto", "cuda", dict(dft=_EH, mats="debye", sar=True), "twopass", None),
    ("debye probes stream", "stream", "cuda", dict(dft=_E, mats="debye", probes=_PROBES), "twopass",
     _STREAM_NOTICE),
    ("debye pml", "auto", "cuda", dict(dft=_E, mats="debye", pml=True), "torch", None),
    ("fp64", "auto", "cuda", dict(dft=_E, dtype="float64"), "torch", None),
    ("cpu", "auto", "cpu", dict(dft=_E, probes=_PROBES), "torch", None),
    ("three frequencies stream fits", "stream", "cuda", dict(dft=dft.DftConfig((1e9, 2e9, 3e9))), "stream", None),
    ("three frequencies auto", "auto", "cuda", dict(dft=dft.DftConfig((1e9, 2e9, 3e9))), "stream", None),
])
def test_routing_of_monitored_scenes(case, backend, device, kw, want, notice, monkeypatch):
    p = convert.params_from(dataclasses.replace(_box(256, 4, kw.get("dtype", "float32")),
                                                mode=kw.get("mode", Mode.COMPUTATION)))
    if "free" in kw:
        monkeypatch.setattr(runner, "_free_memory", lambda dev: kw["free"])
    mats = {"water": water_block(p), "debye": water_debye_load(p), None: None}[kw.get("mats")]
    notices = []
    got = runner.resolve_backend(p, backend, device, mats, kw.get("sar", False),
                                 PMLConfig(cells=10) if kw.get("pml") else None, notices.append,
                                 kw.get("dft"), kw.get("probes"))
    assert got == want, case
    expected = ([f"notice: backend {backend!r} is the JAX package's; running the port's 'stream' backend"]
                if backend == "pallas_stream" else [])
    expected += [notice] if notice else []
    if case == "debye pml":
        expected = [n for n in notices if "torch ADE+CPML" in n]
    assert notices == expected, case


def test_stream_runner_refuses_per_step_monitors():
    p = convert.params_from(_box(12, 4))
    with pytest.raises(ValueError, match="per-step states"):
        make_chunk_runner(p, "cpu", backend="stream", dft=_EH)
    with pytest.raises(ValueError, match="per-step states"):
        make_chunk_runner(p, "cpu", backend="stream", probes=_PROBES)
    run = make_chunk_runner(p, "cpu", backend="twopass", dft=_E)
    s = convert.state_from_numpy({c: np.zeros(p.padded_shape) for c in COMPONENTS}, "cpu", torch.float32)
    with pytest.raises(ValueError, match="cw, sw"):
        run(s, scan_inputs(p, time_values(p)[:2]), None, None, None, dft.zero_dft_acc(p, _E, "cpu"))
    with pytest.raises(ValueError, match="re, im"):
        run(s, scan_inputs(p, time_values(p)[:2]) + dft.dft_weights(_E, time_values(p)[:2]))
