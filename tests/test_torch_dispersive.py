"""Debye dispersion (ADE) in the port, held against the JAX package.

Inputs come from numpy (seeded where random) and go through both packages.

- The water load, ``effective_sigma`` and the ADE coefficient maps are the
  same fp64 host arithmetic rounded once to the field dtype: equal,
  exactly, in fp64, fp32 and bf16.
- ``torch`` against ``fdtd_tpu`` ``xla`` (``make_dispersive_chunk_runner``)
  with the SAR work, 24 steps on 10^3, both modes: fp64 fields and P at
  rtol 1e-12 (reassociation level), the fp32 SAR map at rtol 1e-6 (fp64
  increments rounded to fp32); fp32 fields at atol 5e-7 and the map at
  rtol 3e-6, the JAX package's own bars (``tests/test_dispersive.py``: the
  three-product update lets XLA contract to FMA).
- The plain K9 (``twopass`` on CPU tensors: the vacuum H pass and
  ``update_e_ade`` with work) against the interpret-mode
  ``make_dispersive_fused_step`` (``_e_kernel_ade``), 4 steps from seeded
  random E, H and P (the PEC walls zero; P only where the medium relaxes):
  fp32 within 2^-21 of each array's scale (four fp32 ulps of the largest
  value: the random fields grow to a few units, where an absolute 2e-7 is
  less than one ulp, and H and P are far smaller), bf16 within one bf16
  ulp (2^-8) of each array's scale.
- The plain K12 (``stream`` on CPU tensors; with SAR the port's sweep is
  built at s = 2) against the interpret-mode
  ``make_dispersive_stream_chunk_runner`` (``_kernel_ade_stream``, s = 4),
  23 steps (the TPU: 5 sweeps + 3 trailing two-pass steps; the port: 11 +
  1): fp32 fields and P within 2^-21 of each array's scale (as K9) and SAR
  at rtol 1e-5; bf16 (where the two round to bf16 on different schedules)
  no further from the port's fp32 result than the TPU's bf16 result is,
  plus scale/128, and SAR within 2^-6 of its peak (the materials' bars:
  the TPU sums a band of increments first, the port adds them step by
  step).
- ADE x CPML (``torch``) against ``make_dispersive_pml_chunk_runner`` in
  fp64, 40 steps, a Debye cube reaching into the absorber: fields, P and
  all twelve psi at rtol 1e-12.
- The port's own physics (d_eps = 0 is the lossy path; the ring-down's
  energy books close within 15%), the runner, checkpoints across
  packages, the CLI, the routing and the memory model.

The interpret-mode runs take most of this file's 40-60 s on one CPU.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from fdtd_tpu import cli as jcli  # noqa: E402
from fdtd_tpu import coupled as jcoupled  # noqa: E402
from fdtd_tpu import state as jstate  # noqa: E402
from fdtd_tpu.io.vtr import read_vtr_cell_arrays as j_read_vtr  # noqa: E402
from fdtd_tpu.ops import cpml as jcpml  # noqa: E402
from fdtd_tpu.ops import dispersive as jd  # noqa: E402
from fdtd_tpu.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu.runner import run_simulation as j_run  # noqa: E402
from fdtd_tpu.step import backend_adapters  # noqa: E402
from fdtd_tpu.step import scan_inputs as j_scan_inputs  # noqa: E402
from fdtd_tpu.step import zero_power_acc as j_zero_power_acc  # noqa: E402
from fdtd_tpu_torch import cli, convert, diagnostics, grid, profile_chunk, runner, tune_stream  # noqa: E402
from fdtd_tpu_torch import state as tstate  # noqa: E402
from fdtd_tpu_torch import step as tstep  # noqa: E402
from fdtd_tpu_torch.ops import cpml, stream, stream_plan, yee  # noqa: E402
from fdtd_tpu_torch.ops import dispersive as td  # noqa: E402
from fdtd_tpu_torch.source import apply_source, make_source_plan, profile_tensor, sweep_drive_rows  # noqa: E402

COMPONENTS = ["ex", "ey", "ez", "hx", "hy", "hz"]
MAPS = ("ca", "cb", "cp", "k1", "k2", "sig")


def _box(n, steps, mode=Mode.COMPUTATION, dtype="float32", dt=1e-12):
    return Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=1e-3, time_step=dt,
                  simulation_time=(steps - 0.5) * dt, sampling_rate=10**9, mode=mode, dtype=dtype)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _uniform_debye(p, eps_inf=1.0, d_eps=0.2, tau=8e-12, sigma=0.0):
    shape = (p.maxk, p.maxj, p.maxi)
    return jd.DebyeMaterials(base=jstate.Materials(eps_r=np.full(shape, eps_inf), sigma=np.full(shape, sigma)),
                             d_eps=np.full(shape, d_eps), tau=np.full(shape, tau))


def _updated_fields(p, seed, dm=None):
    """Seeded uniform fields on each component's update region (the PEC
    walls zero), E of order 1 and H of order 1/eta0, and with the Debye
    medium ``dm`` P of order eps0*d_eps on the edges it relaxes on (k2 >
    0; P stays zero where the medium has no dispersion)."""
    rng = np.random.default_rng(seed)
    regions = cpml._update_regions(convert.params_from(p))
    out = {}
    for c in COMPONENTS:
        a = np.zeros(p.padded_shape)
        a[regions[c]] = rng.uniform(-1, 1, a[regions[c]].shape) / (cpml.ETA0 if c[0] == "h" else 1.0)
        out[c] = a
    if dm is None:
        return out
    k2 = jd.debye_coefs(dataclasses.replace(p, dtype="float64"), dm).k2
    pol = tuple(np.where(np.asarray(k2[c]) > 0, rng.uniform(-1e-9, 1e-9, p.padded_shape), 0.0) for c in "xyz")
    assert all(float(np.abs(a).max()) > 0 for a in pol)
    return out, pol


def _jax_state(arrays, dtype):
    return jstate.FieldState(**{c: jnp.asarray(arrays[c], dtype) for c in COMPONENTS})


def _port(jp, jdm, init, steps, backend="torch", sar=True, pol0=None, pml_cells=None, **kw):
    """The port's chunk runner on CPU tensors: (state, pol, power, psi)."""
    tp = convert.params_from(jp)
    dt = tstate.field_dtype(tp)
    st = convert.state_from_numpy(init, "cpu", dt) if init is not None else tstate.zeros(tp, "cpu")
    pol = convert.pol_from_numpy(pol0, "cpu", dt) if pol0 is not None else td.zero_polarization(tp, "cpu")
    power = tstep.zero_power_acc(tp, "cpu") if sar else None
    cfg = cpml.PMLConfig(cells=pml_cells) if pml_cells else None
    psi = cpml.init_psi(tp, cfg, "cpu") if cfg else None
    run = tstep.make_chunk_runner(tp, "cpu", convert.debye_from(jdm), backend, accumulate_power=sar, pml=cfg, **kw)
    assert run(st, tstep.scan_inputs(tp, time_values(jp)[:steps]), power, psi, pol) is st
    return st, pol, power, psi


# --- loads and coefficients -------------------------------------------------------------


def test_water_constants_are_the_jax_packages():
    assert td.EPS_INF == jcoupled.EPS_INF
    np.testing.assert_array_equal(td._TAU_T_C, jcoupled._TAU_T_C)
    np.testing.assert_array_equal(td._TAU_PS, jcoupled._TAU_PS)
    T = np.linspace(-5.0, 105.0, 23)
    np.testing.assert_array_equal(td.water_eps_static(T), jcoupled.water_eps_static(T))


SCENES = {
    "box": lambda p, lib: lib.water_debye_load(p),
    "sphere_salt_hot": lambda p, lib: lib.water_debye_load(
        p, temperature=63.0, sigma_ion25=0.7, mask=jstate.sphere_mask(p, radius=0.3)),
    "cube_cold": lambda p, lib: lib.water_debye_load(p, lo=(0.1, 0.2, 0.0), hi=(0.8, 0.65, 0.5),
                                                     temperature=4.0, sigma_ion25=0.1),
}


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_load_and_coefs_match_jax_exactly(scene, dtype):
    jp = dataclasses.replace(_box(12, 4, dtype=dtype), width=0.0095, length=0.0115)  # (12, 9, 11)
    tp = convert.params_from(jp)
    want = SCENES[scene](jp, jd)
    got = SCENES[scene](tp, td)
    for name in ("d_eps", "tau"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("eps_r", "sigma"):
        np.testing.assert_array_equal(getattr(got.base, name), getattr(want.base, name), err_msg=name)
    assert got.base.mu_r is None and float(got.d_eps.max()) > 0
    np.testing.assert_array_equal(td.effective_sigma(got, 2.45e9), jd.effective_sigma(want, 2.45e9))
    dc = td.debye_coefs(tp, convert.debye_from(want), "cpu")
    jdc = jd.debye_coefs(jp, want)
    assert dc.h_factor == float(jdc.h_factor)
    for name in MAPS:
        for c in td.COMPS:
            g, w = getattr(dc, name)[c], getattr(jdc, name)[c]
            assert g.dtype == tstate.field_dtype(tp) and tuple(g.shape) == tp.padded_shape, (name, c)
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"{name}_{c}")
    assert len(dc.arrays()) == 15 and len(dc.arrays(sar=True)) == 18
    assert dc.arrays(sar=True)[15] is dc.sig["x"] and dc.arrays()[14] is dc.k2["z"]


def test_debye_materials_refuse_bad_maps():
    shape = (3, 3, 3)
    base = tstate.Materials(eps_r=np.ones(shape))
    with pytest.raises(ValueError, match="d_eps must be >= 0"):
        td.DebyeMaterials(base=base, d_eps=-np.ones(shape), tau=np.ones(shape))
    with pytest.raises(ValueError, match="tau must be > 0"):
        td.DebyeMaterials(base=base, d_eps=np.ones(shape), tau=np.zeros(shape))
    p = convert.params_from(_box(8, 2))
    dm = td.water_debye_load(p)
    het = td.DebyeMaterials(base=dataclasses.replace(dm.base, mu_r=np.ones((8, 8, 8))), d_eps=dm.d_eps, tau=dm.tau)
    with pytest.raises(NotImplementedError, match="heterogeneous mu_r"):
        td.debye_coefs(p, het, "cpu")


# --- torch backend against xla -----------------------------------------------------------


@pytest.mark.parametrize("mode", [Mode.COMPUTATION, Mode.VALIDATION])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_torch_matches_jax_xla(dtype, mode):
    steps = 24
    jp = _box(10, steps, mode, dtype)
    jdm = jd.water_debye_load(jp, sigma_ion25=0.5)
    s0 = jstate.init_validation(jp) if mode == Mode.VALIDATION else jstate.zeros(jp)
    run = jd.make_dispersive_chunk_runner(jp, jdm, accumulate_power=True)
    (want, want_p), want_acc, _, _ = run((s0, jd.zero_polarization(jp)),
                                         j_scan_inputs(jp, time_values(jp)[:steps]), j_zero_power_acc(jp), None)
    init = {c: np.asarray(getattr(s0, c)) for c in COMPONENTS}
    got, pol, acc, _ = _port(jp, jdm, init, steps)
    tol = {"rtol": 1e-12, "atol": 1e-15} if dtype == "float64" else {"rtol": 0, "atol": 5e-7}
    for c in COMPONENTS:
        np.testing.assert_allclose(_np(getattr(got, c)), np.asarray(getattr(want, c)), err_msg=c, **tol)
    p_tol = {"rtol": 1e-12, "atol": 1e-27} if dtype == "float64" else {"rtol": 0, "atol": 5e-7 * 1e-10}
    for g, w, c in zip(pol.tensors(), want_p, "xyz"):
        assert float(np.abs(np.asarray(w)).max()) > 0, c
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=f"P{c}", **p_tol)
    aw = np.asarray(want_acc)
    peak = float(aw.max())
    assert peak > 0 and acc.dtype == torch.float32
    np.testing.assert_allclose(acc.numpy(), aw, rtol=1e-6 if dtype == "float64" else 3e-6, atol=1e-6 * peak)


# --- the plain versions of the kernels against the interpret-mode TPU kernels ---------------


def _close(got, want, tol, tag):
    scale = float(np.abs(_np(want)).max())
    assert scale > 0, tag  # an array that never moved would pass any tolerance
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err <= tol(scale), (tag, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k9_matches_interpret_e_kernel_ade(dtype):
    """K9's plain version (``update_e_ade`` with work, after the vacuum H
    pass) against ``_e_kernel_ade`` through ``make_dispersive_fused_step``,
    4 steps from seeded random E, H and P, with the SAR work."""
    from fdtd_tpu.ops.pallas_dispersive import extract_pol, make_ade_state, make_dispersive_fused_step

    steps = 4
    jp = _box(10, steps, dtype=dtype)
    jdm = jd.water_debye_load(jp, lo=(0.1,) * 3, hi=(0.9,) * 3, sigma_ion25=0.5)
    init, pol0 = _updated_fields(jp, 61, jdm)
    prep, rest = backend_adapters(jp, "pallas_fused")
    step = make_dispersive_fused_step(jp, jdm, accumulate_power=True, interpret=True)
    carry = (prep(_jax_state(init, jp.dtype)),
             make_ade_state(jp, jdm, True, pol=tuple(jnp.asarray(a, jp.dtype) for a in pol0)))
    acc_w = j_zero_power_acc(jp)
    ts, amps = j_scan_inputs(jp, time_values(jp)[:steps])
    for n in range(steps):
        carry, acc_w = step(carry, (ts[n], amps[n]), acc_w)
    want, want_p = rest(carry[0]), extract_pol(jp, carry[1])
    yee.reset_launches()
    got, pol, acc, _ = _port(jp, jdm, init, steps, "twopass", pol0=pol0)
    assert yee.launches == dict.fromkeys(yee.launches, 0)  # CPU tensors: the plain versions
    tol = (lambda s: s * 2.0**-21) if dtype == "float32" else (lambda s: s / 256)
    for c in COMPONENTS:
        _close(getattr(got, c), getattr(want, c), tol, c)
    for g, w, c in zip(pol.tensors(), want_p, "xyz"):
        _close(g, w, tol, f"P{c}")
    peak = float(np.abs(np.asarray(acc_w)).max())  # random fields: the work has both signs
    assert peak > 0
    if dtype == "float32":
        np.testing.assert_allclose(acc.numpy(), np.asarray(acc_w), rtol=1e-5, atol=1e-6 * peak)
    else:
        assert float(np.abs(acc.numpy() - np.asarray(acc_w)).max()) <= peak / 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k12_matches_interpret_kernel_ade_stream(dtype):
    """K12's plain version (the port's SAR sweep at its s = 2, with its
    trailing two-pass step) against ``_kernel_ade_stream`` through
    ``make_dispersive_stream_chunk_runner`` (s = 4), 23 steps, from seeded
    random fields and P, with the SAR work."""
    from fdtd_tpu.ops.pallas_dispersive import extract_pol, make_ade_state, make_dispersive_stream_chunk_runner

    steps = 23
    jp = _box(10, steps, dtype=dtype)
    jdm = jd.water_debye_load(jp, sigma_ion25=0.5)
    init, pol0 = _updated_fields(jp, 62, jdm)
    prep, rest = backend_adapters(jp, "pallas_fused")
    run = make_dispersive_stream_chunk_runner(jp, jdm, accumulate_power=True, interpret=True)
    carry = (prep(_jax_state(init, jp.dtype)),
             make_ade_state(jp, jdm, True, pol=tuple(jnp.asarray(a, jp.dtype) for a in pol0)))
    (st, ade), acc_w = run(carry, j_scan_inputs(jp, time_values(jp)[:steps]), j_zero_power_acc(jp))
    want, want_p, acc_w = rest(st), extract_pol(jp, ade), np.asarray(acc_w)
    stream.reset_launches()
    yee.reset_launches()
    got, pol, acc, _ = _port(jp, jdm, init, steps, "stream", pol0=pol0)
    assert stream.launches == dict.fromkeys(stream.launches, 0)
    assert yee.launches == dict.fromkeys(yee.launches, 0)
    if dtype == "float32":
        for c in COMPONENTS:
            _close(getattr(got, c), getattr(want, c), lambda s: s * 2.0**-21, c)
        for g, w, c in zip(pol.tensors(), want_p, "xyz"):
            _close(g, w, lambda s: s * 2.0**-21, f"P{c}")
    else:
        ref, ref_pol, _, _ = _port(dataclasses.replace(jp, dtype="float32"), jdm, init, steps, "stream", pol0=pol0)
        pairs = [(getattr(got, c), getattr(want, c), getattr(ref, c), c) for c in COMPONENTS]
        pairs += [(g, w, r, f"P{c}") for g, w, r, c in zip(pol.tensors(), want_p, ref_pol.tensors(), "xyz")]
        for g, w, r, tag in pairs:
            r = _np(r)
            scale = float(np.abs(r).max())
            assert scale > 0, tag
            port_err, tpu_err = float(np.abs(_np(g) - r).max()), float(np.abs(_np(w) - r).max())
            assert port_err <= tpu_err + scale / 128, (tag, port_err, tpu_err, scale)
    peak = float(np.abs(acc_w).max())  # random fields: the work has both signs
    assert peak > 0
    if dtype == "float32":
        np.testing.assert_allclose(acc.numpy(), acc_w, rtol=1e-5, atol=1e-6 * peak)
    else:
        assert float(np.abs(acc.numpy() - acc_w).max()) <= peak / 64


# --- port-internal, bit for bit in fp32 -----------------------------------------------------


def _debye_scene(n=10, dtype="float32"):
    jp = dataclasses.replace(_box(n, 8, dtype=dtype), width=(n - 1) * 1e-3 + 5e-4, length=(n + 1) * 1e-3 + 5e-4)
    tp = convert.params_from(jp)
    return tp, td.water_debye_load(tp, lo=(0.1,) * 3, hi=(0.9,) * 3, sigma_ion25=0.4)


@pytest.mark.parametrize("sar", [False, True])
@pytest.mark.parametrize("s", [4, 2])
def test_plain_sweep_is_torch_steps(s, sar):
    """fp32: an ADE sweep is s torch ADE steps (with each step's work)."""
    tp, dm = _debye_scene()
    dc = td.debye_coefs(tp, dm, "cpu")
    hco = tstate.update_coefs(tp)
    init, pol0 = _updated_fields(tp, 63, dm)
    a = convert.state_from_numpy(init, "cpu", torch.float32)
    b = a.clone()
    pol_a = convert.pol_from_numpy(pol0, "cpu", torch.float32)
    pol_b = pol_a.clone()
    src = make_source_plan(tp)
    amps = torch.tensor(np.random.default_rng(64).uniform(-1, 1, s), dtype=torch.float64)
    prof = profile_tensor(src, "cpu")
    apply_source(src, a, amps[0], prof)
    ez, hx = sweep_drive_rows(src, amps, s, torch.float32, prof)
    acc0 = torch.tensor(np.random.default_rng(65).uniform(0, 1e-11, (tp.maxk, tp.maxj, tp.maxi)),
                        dtype=torch.float32)
    acc_a, acc_b = acc0.clone(), acc0.clone()
    pol_out = td.PolState(*(torch.full_like(t, float("nan")) for t in pol_a.tensors()))
    got = stream.plain_sweep(tp, a, hco, s, stream.SweepDrive(src.patch, ez[0], hx[0]),
                             acc=acc_a if sar else None, dc=dc, pol=pol_a, pol_out=pol_out)
    step = tstep.make_step(tp, "cpu", dm, backend="torch")
    work = td.zero_work(tp, "cpu")
    for m in range(s):
        step(b, (0.0, float(amps[m])), pol_b, None, work)
        if sar:
            diagnostics.accumulate_work(tp, work, acc_b)
    for c in COMPONENTS:
        assert torch.equal(getattr(got, c), getattr(b, c)), c
    assert all(torch.equal(x, y) for x, y in zip(pol_out.tensors(), pol_b.tensors()))
    assert torch.equal(acc_a, acc_b) and torch.equal(acc_a, acc0) != sar


@pytest.mark.parametrize("sar", [False, True])
def test_stream_and_twopass_equal_torch(sar):
    """fp32: 23 steps of stream (its sweeps and the trailing two-pass
    step: s = 2 with and without SAR) and of twopass give torch's fields,
    P (and SAR map)."""
    tp, dm = _debye_scene()
    jp_like = _box(10, 23)
    init, pol0 = _updated_fields(tp, 66, dm)
    out = {}
    for backend in ("torch", "twopass", "stream"):
        st = convert.state_from_numpy(init, "cpu", torch.float32)
        pol = convert.pol_from_numpy(pol0, "cpu", torch.float32)
        power = tstep.zero_power_acc(tp, "cpu") if sar else None
        run = tstep.make_chunk_runner(tp, "cpu", dm, backend, accumulate_power=sar)
        run(st, tstep.scan_inputs(tp, time_values(jp_like)[:23]), power, None, pol)
        out[backend] = (st, pol, power)
        if backend == "stream":
            assert run.plan.s == 2 and 23 % run.plan.s
    assert not sar or float(out["torch"][2].abs().max()) > 0
    for key in ("twopass", "stream"):
        for c in COMPONENTS:
            assert torch.equal(getattr(out[key][0], c), getattr(out["torch"][0], c)), (key, c)
        assert all(torch.equal(a, b) for a, b in zip(out[key][1].tensors(), out["torch"][1].tensors())), key
        assert not sar or torch.equal(out[key][2], out["torch"][2]), key


def test_work_increment_in_slabs_is_the_whole_grid_increment(monkeypatch):
    tp, dm = _debye_scene(12)
    rng = np.random.default_rng(67)
    work = tuple(torch.tensor(rng.uniform(-1e3, 1e3, tp.padded_shape), dtype=torch.float32) for _ in range(3))
    acc0 = torch.tensor(rng.uniform(0, 1e-9, (tp.maxk, tp.maxj, tp.maxi)), dtype=torch.float32)
    whole = acc0.clone()
    diagnostics.accumulate_work(tp, work, whole)
    monkeypatch.setattr(diagnostics, "SAR_SLAB_CELLS", 5 * tp.maxj * tp.maxi + 5)
    assert diagnostics.sar_slab_planes(tp) == 5 and tp.maxk % 5
    slabs = acc0.clone()
    diagnostics.accumulate_work(tp, work, slabs)
    assert torch.equal(slabs, whole)
    inc = td.work_cell_means(tp, *work)
    assert torch.equal(whole, acc0 + (inc * float(np.float32(tp.time_step))).to(torch.float32))
    np.testing.assert_array_equal(inc.numpy(), np.asarray(jd.work_cell_means(tp, *(w.numpy() for w in work))))


def test_runner_needs_pol_and_sweep_checks_its_variant():
    tp, dm = _debye_scene()
    run = tstep.make_chunk_runner(tp, "cpu", dm, "torch")
    with pytest.raises(ValueError, match="zero_polarization"):
        run(tstate.zeros(tp, "cpu"), tstep.scan_inputs(tp, time_values(tp)[:2]))
    dc = td.debye_coefs(tp, dm, "cpu")
    st, out = tstate.zeros(tp, "cpu"), tstate.zeros(tp, "cpu")
    pol = td.zero_polarization(tp, "cpu")
    with pytest.raises(ValueError, match="plan is for"):
        stream.sweep(tp, st, out, tstate.update_coefs(tp), stream_plan.plan_for(tp, 4), dc=dc, pol=pol,
                     pol_out=pol.clone())
    with pytest.raises(ValueError, match="pol and pol_out"):
        stream.sweep(tp, st, out, tstate.update_coefs(tp), stream_plan.plan_for(tp, 2, ade=True), dc=dc)
    with pytest.raises(ValueError, match="torch ADE\\+CPML"):
        tstep.make_step(tp, "cpu", dm, backend="twopass", pml=cpml.PMLConfig(cells=2))


# --- Debye x CPML ------------------------------------------------------------------------------


@pytest.mark.parametrize("mode, sar", [(Mode.COMPUTATION, True), (Mode.VALIDATION, False)])
def test_pml_torch_matches_jax(mode, sar):
    """ADE x CPML in fp64, 40 steps, a Debye cube reaching into the
    5-cell absorber, from seeded random fields: fields, P and all twelve
    psi at rtol 1e-12 (and the SAR map)."""
    steps, cells = 40, 5
    jp = _box(24, steps, mode, "float64")
    jdm = jd.water_debye_load(jp, lo=(0.05,) * 3, hi=(0.95,) * 3, sigma_ion25=0.3)
    init = _updated_fields(jp, 68)
    run = jd.make_dispersive_pml_chunk_runner(jp, jdm, jcpml.PMLConfig(cells=cells), accumulate_power=sar)
    (want, want_p, want_psi), want_acc, _, _ = run(
        (_jax_state(init, jp.dtype), jd.zero_polarization(jp), jcpml.init_psi(jp, jcpml.PMLConfig(cells=cells))),
        j_scan_inputs(jp, time_values(jp)[:steps]), j_zero_power_acc(jp) if sar else None, None)
    got, pol, acc, psi = _port(jp, jdm, init, steps, sar=sar, pml_cells=cells)
    tol = {"rtol": 1e-12, "atol": 1e-14}
    for c in COMPONENTS:
        np.testing.assert_allclose(getattr(got, c).numpy(), np.asarray(getattr(want, c)), err_msg=c, **tol)
    for g, w, c in zip(pol.tensors(), want_p, "xyz"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-24, err_msg=f"P{c}")
    engaged = 0
    for name in cpml.PsiState.names():
        b = np.asarray(getattr(want_psi, name))
        np.testing.assert_allclose(getattr(psi, name).numpy(), b, err_msg=f"psi/{name}", **tol)
        engaged += float(np.abs(b).max()) > 0
    assert engaged == 12
    if sar:
        aw = np.asarray(want_acc)
        assert float(aw.max()) > 0
        np.testing.assert_allclose(acc.numpy(), aw, rtol=1e-6, atol=1e-6 * float(aw.max()))


# --- physics -------------------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "twopass", "stream"])
def test_deps_zero_reduces_to_the_lossy_path(backend):
    """d_eps = 0: the ADE update is the lossy update algebraically, so the
    Debye run matches the lossy run on the same eps_inf/sigma maps
    (tests/test_dispersive.py's bars)."""
    tp = convert.params_from(_box(8, 20))
    plain = tstate.water_block(tp)
    zero = np.zeros((tp.maxk, tp.maxj, tp.maxi))
    dm = td.DebyeMaterials(base=plain, d_eps=zero, tau=zero)
    xs = tstep.scan_inputs(tp, time_values(tp))
    a, b = tstate.zeros(tp, "cpu"), tstate.zeros(tp, "cpu")
    tstep.make_chunk_runner(tp, "cpu", plain, backend)(a, xs)
    pol = td.zero_polarization(tp, "cpu")
    tstep.make_chunk_runner(tp, "cpu", dm, backend)(b, xs, None, None, pol)
    assert float(a.ez.abs().max()) > 0
    for c in COMPONENTS:
        np.testing.assert_allclose(getattr(b, c).numpy(), getattr(a, c).numpy(), rtol=2e-5, atol=1e-7, err_msg=c)
    assert all(float(t.abs().max()) == 0 for t in pol.tensors())


def test_sar_energy_balance():
    """A source-free ring-down through a uniform weak Debye medium (fp64):
    the field energy lost equals the accumulated work within 15% (the
    bar of tests/test_dispersive.py; sigma|E|^2 alone would be ~3x off)."""
    from fdtd_tpu.analytic import mode_constants

    base = _box(10, 4, Mode.VALIDATION, "float64")
    f_vac, _ = mode_constants(base)
    dt = 1.0 / (f_vac * 40)
    tp = convert.params_from(_box(10, 12 * 40, Mode.VALIDATION, "float64", dt=dt))
    dm = convert.debye_from(_uniform_debye(tp, eps_inf=1.0, d_eps=0.15, tau=1.0 / (2 * np.pi * 2.0e10),
                                           sigma=0.05))
    e0 = float(diagnostics.total_energy(tp, runner.initial_state(tp, "cpu")))
    res = runner.run_simulation(tp, "cpu", materials=dm, accumulate_power=True, write_snapshots=False,
                                log=lambda m: None)
    e1 = float(diagnostics.total_energy(tp, res.state))
    dissipated = float(res.power_j.double().sum()) * tp.spatial_step**3
    lost = e0 - e1
    assert lost > 0.2 * e0
    np.testing.assert_allclose(dissipated, lost, rtol=0.15)


# --- runner, checkpoints, CLI ---------------------------------------------------------------


def test_run_simulation_matches_jax_and_carries_pol(tmp_path):
    jp = dataclasses.replace(_box(10, 16), sampling_rate=8)
    jdm = jd.water_debye_load(jp, sigma_ion25=0.5)
    quiet = {"log": lambda m: None, "write_snapshots": False}
    want = j_run(jp, materials=jdm, accumulate_power=True, backend="xla", **quiet)
    res = runner.run_simulation(convert.params_from(jp), "cpu", materials=convert.debye_from(jdm),
                                accumulate_power=True, out_dir=str(tmp_path), checkpoint_every=8, **quiet)
    assert res.pol is not None and res.psi is None
    for c in COMPONENTS:
        np.testing.assert_allclose(_np(getattr(res.state, c)), np.asarray(getattr(want.state, c)), atol=5e-7,
                                   rtol=0, err_msg=c)
    np.testing.assert_allclose(res.power_j.numpy(), np.asarray(want.power_j), rtol=3e-6,
                               atol=1e-6 * float(np.asarray(want.power_j).max()))
    with np.load(tmp_path / "ckpt000016.npz") as z:
        for name, t in zip(("pol_x", "pol_y", "pol_z"), res.pol.tensors()):
            np.testing.assert_array_equal(z[f"aux_{name}"], t.numpy())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pol_checkpoint_resumes_across_packages(tmp_path, writer):
    """A checkpoint with ``aux_pol_x/y/z`` written by either package
    resumes in the other; the resumed run equals an uninterrupted one
    (fp32, the fields' tolerance)."""
    jp = dataclasses.replace(_box(8, 16), sampling_rate=8)
    jdm = jd.water_debye_load(jp)
    tp, tdm = convert.params_from(jp), convert.debye_from(jdm)
    quiet = {"log": lambda m: None, "write_snapshots": False}
    ck = tmp_path / "ck"
    if writer == "jax":
        j_run(jp, out_dir=str(ck), materials=jdm, checkpoint_every=8, backend="xla", **quiet)
        os.remove(ck / "ckpt000016.npz")
        res = runner.run_simulation(tp, "cpu", out_dir=str(ck), materials=tdm, resume=True, **quiet)
        assert not res.warnings
        got, got_p = res.state, res.pol.tensors()
        full = runner.run_simulation(tp, "cpu", materials=tdm, **quiet)
        want, want_p = full.state, full.pol.tensors()
    else:
        runner.run_simulation(tp, "cpu", out_dir=str(ck), materials=tdm, checkpoint_every=8, **quiet)
        with np.load(ck / "ckpt000008.npz") as z:
            assert float(np.abs(z["aux_pol_y"]).max()) > 0
        os.remove(ck / "ckpt000016.npz")
        res = j_run(jp, out_dir=str(ck), materials=jdm, resume=True, backend="xla", **quiet)
        got = res.state
        want = j_run(jp, materials=jdm, backend="xla", **quiet).state
        got_p = want_p = None
    for c in COMPONENTS:
        np.testing.assert_allclose(_np(getattr(got, c)), _np(getattr(want, c)), atol=5e-7, rtol=0, err_msg=c)
    if got_p is not None:
        for g, w in zip(got_p, want_p):
            np.testing.assert_allclose(_np(g), _np(w), atol=5e-17, rtol=0)


def test_resume_without_pol_warns(tmp_path):
    jp = dataclasses.replace(_box(8, 16), sampling_rate=8)
    tp = convert.params_from(jp)
    quiet = {"log": lambda m: None, "write_snapshots": False}
    runner.run_simulation(tp, "cpu", out_dir=str(tmp_path), materials=tstate.water_block(tp), checkpoint_every=8,
                          **quiet)
    os.remove(tmp_path / "ckpt000016.npz")
    res = runner.run_simulation(tp, "cpu", out_dir=str(tmp_path), materials=td.water_debye_load(tp),
                                resume=True, **quiet)
    assert any("no polarization state" in w for w in res.warnings)
    assert float(res.pol.py.abs().max()) > 0


@pytest.mark.parametrize("args, msg", [
    (["--dispersive"], "needs --water-block"),
    (["--dispersive", "--water-block", "--ferrite-slab"], "no --ferrite-slab"),
])
def test_cli_dispersive_refusals(tmp_path, capsys, args, msg):
    params = tmp_path / "p.txt"
    params.write_text("0.01 0.01 0.01 0.001 1e-12 1e-11 5 1")
    assert cli.main([str(params), "--device", "cpu", "--out", str(tmp_path / "r"), *args]) == 1
    assert msg in capsys.readouterr().err
    assert jcli.main([str(params), "--out", str(tmp_path / "j"), *args]) == 1
    assert msg in capsys.readouterr().err


def test_cli_dispersive_sar_writes_the_jax_sar_map(tmp_path, capsys):
    params = tmp_path / "p.txt"
    params.write_text("0.012\n0.011\n0.013\n0.001\n1e-12\n1.6e-11\n8\n1\n")
    flags = ["--water-block", "--dispersive", "--sar", "--salt-sigma", "0.4", "--thermal-ambient", "35"]
    assert jcli.main([str(params), *flags, "--backend", "xla", "--out", str(tmp_path / "j")]) == 0
    assert cli.main([str(params), *flags, "--device", "cpu", "--out", str(tmp_path / "t")]) == 0
    out = capsys.readouterr().out
    assert "SAR map written to" in out and "Simulation complete!" in out
    want = j_read_vtr(str(tmp_path / "j" / "sar.vtr"))
    got = j_read_vtr(str(tmp_path / "t" / "sar.vtr"))
    assert set(got) == set(want) and {"power_j_m3", "avg_power_w_m3"} <= set(want)
    for name in want:
        peak = float(want[name].max())
        assert peak > 0
        np.testing.assert_allclose(got[name], want[name], rtol=3e-6, atol=1e-6 * peak, err_msg=name)


# --- routing and memory ------------------------------------------------------------------------


def _cube(n, dtype="float32", mode=Mode.COMPUTATION):
    return convert.params_from(_box(n, 8, mode, dtype))


def test_routing_with_cpml_runs_torch_with_a_notice():
    p = _cube(64)
    dm = td.water_debye_load(p)
    cfg = cpml.PMLConfig(cells=4)
    notices = []
    assert runner.resolve_backend(p, "auto", "cuda", dm, True, cfg, notices.append) == "torch"
    assert len(notices) == 1 and "torch ADE+CPML" in notices[0]
    for backend in ("twopass", "stream"):
        with pytest.raises(ValueError, match="--backend torch"):
            runner.resolve_backend(p, backend, "cuda", dm, True, cfg)
    assert runner.resolve_backend(p, "torch", "cuda", dm, True, cfg) == "torch"


@pytest.mark.parametrize("device, dtype, mode, want", [
    ("cuda", "float32", Mode.COMPUTATION, "stream"),
    ("cuda", "bfloat16", Mode.COMPUTATION, "stream"),
    ("cuda", "float32", Mode.VALIDATION, "torch"),
    ("cuda", "float64", Mode.COMPUTATION, "torch"),
    ("cpu", "float32", Mode.COMPUTATION, "torch"),
])
def test_routing_of_debye_scenes(device, dtype, mode, want):
    p = _cube(256, dtype, mode)
    dm = td.water_debye_load(p)
    assert runner.resolve_backend(p, "auto", device, dm, True) == want
    if want == "torch":
        for backend in ("twopass", "stream"):
            with pytest.raises(ValueError, match="--backend torch"):
                runner.resolve_backend(p, backend, device, dm, True)
    else:
        assert runner.resolve_backend(p, "twopass", device, dm, True) == "twopass"


@pytest.mark.parametrize("n, twopass, stream_", [(256, True, True), (512, True, True), (1024, False, False)])
def test_memory_model_verdicts(n, twopass, stream_):
    """fp32 Debye + SAR at 80 GB: twopass holds the state, P, the 15 maps,
    sigma, the map, the three work arrays and the slab temporaries; stream
    a second state and P set more.  1024^3 fits neither: resolve_backend
    refuses it with the port's message."""
    p = _cube(n)
    arr = 4 * int(np.prod(p.padded_shape))
    tp_need = stream_plan.twopass_bytes(p, sar=True, ade=True)
    st_need = stream_plan.stream_bytes(p, sar=True, ade=True)
    assert tp_need >= (6 + 3 + 18 + 3) * arr and st_need - tp_need == 9 * arr
    assert stream_plan.twopass_fits(p, 80 * 10**9, sar=True, ade=True) == twopass
    assert stream_plan.supported(p, 80 * 10**9, sar=True, ade=True) == stream_
    if n == 256:
        assert 2.0e9 < tp_need < 2.8e9 and 2.5e9 < st_need < 3.4e9
    if n == 512:
        assert st_need < 30e9
    if n == 1024:
        assert tp_need > 116e9
        dm = td.DebyeMaterials(base=tstate.Materials(eps_r=np.ones(1)), d_eps=np.zeros(1), tau=np.zeros(1))
        for backend in ("auto", "twopass"):
            with pytest.raises(ValueError, match="does not fit in device memory"):
                runner.resolve_backend(p, backend, "cuda", dm, True)


def test_ade_plans():
    p = _cube(256)
    for sar in (False, True):
        plan = stream_plan.pick_plan(p, sar=sar, ade=True)
        table = stream_plan.BLOCK_J_ADE_SAR if sar else stream_plan.BLOCK_J_ADE
        assert plan.ade and not plan.lossy and plan.sar == sar and (plan.s, plan.bj) in table.items()
        assert plan.kernel == ("yee_stream_ade_sar" if sar else "yee_stream_ade")
        assert plan.kernel in stream.launches
        assert plan.tj == plan.bj - 2 * plan.s - sar
    assert stream_plan.pick_plan(p, ade=True, pml=cpml.PMLConfig(cells=4)) is None
    assert stream_plan.pick_plan(_cube(64, mode=Mode.VALIDATION), ade=True) is None
    with pytest.raises(ValueError, match="steps per sweep"):
        stream_plan.plan_for(p, 8, ade=True)
    with pytest.raises(ValueError, match="steps per sweep"):
        stream_plan.plan_for(p, 4, sar=True, ade=True)


def test_tune_ade_reads_ptxas_and_plans_its_candidates():
    """The sweep tuner (``tune_stream``, which took over the ADE tuner's
    candidates) keeps the ring_kernel entries of a ptxas log, and every ADE
    candidate shape (the built ones among them) has a plan."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_111ring_kernelIfLi2ELi24ELb1ELb0ELb0ELb1ELb1ELb0"
        "ELb0EEEvNS_6FieldsIT_EE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4_GLOBAL__N_111ring_kernelIfLi2ELi24ELb1ELb0ELb0ELb1ELb1ELb0ELb0EEEv",
        "    0 bytes stack frame, 164 bytes spill stores, 164 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 44032 bytes smem",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_111ring_kernelI13__nv_bfloat16Li2ELi32ELb0ELb0"
        "ELb0ELb0ELb1ELb0ELb0EEEv' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_113stream_kernelIfLi2ELi24ELb1ELb0EEEv'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers",
    ])
    assert tune_stream.ptxas_report(log) == {
        ("float32", 2, 24, True, False, False, True, True, False, False): (80, 164),
        ("bfloat16", 2, 32, False, False, False, False, True, False, False): (64, 0)}
    p = _cube(256)
    for sar in (False, True):
        fam = "ade_sar" if sar else "ade"
        built = set(tune_stream.built_shapes("dispersive_sar" if sar else "dispersive", p))
        table = stream_plan.BLOCK_J_ADE_SAR if sar else stream_plan.BLOCK_J_ADE
        assert {(s, bj) for s, bj, _ in built} == set(table.items())
        assert built <= set(tune_stream.shapes("dispersive_sar" if sar else "dispersive", p, False))
        for s, bj, cr in tune_stream.CANDIDATES[fam]:
            plan = stream_plan.plan_for(p, s, sar=sar, ade=True, bj=bj, cr=cr)
            assert (plan.s, plan.bj, plan.cr) == (s, bj, cr)
            assert (plan.tj, plan.ti) == (bj - 2 * s - sar, 32 - 2 * s - sar)
            assert plan.kernel == ("yee_stream_ade_sar" if sar else "yee_stream_ade") and plan.blocks > 0
            assert plan.smem_bytes <= stream_plan.SMEM_PER_BLOCK
    assert stream_plan.plan_for(p, 2, ade=True) == stream_plan.plan_for(p, 2, ade=True, bj=24, cr=True)

def test_convert_debye_and_pol():
    jp = _box(8, 2, dtype="bfloat16")
    jdm = jd.water_debye_load(jp, sigma_ion25=0.3)
    tdm = convert.debye_from(jdm)
    assert tdm.d_eps is not jdm.d_eps and np.array_equal(tdm.tau, jdm.tau)
    assert np.array_equal(tdm.base.sigma, jdm.base.sigma) and tdm.base.mu_r is None
    P = jd.zero_polarization(jp)
    P = tuple(a + jnp.asarray(0.5 * (i + 1), a.dtype) for i, a in enumerate(P))
    pol = convert.pol_from_numpy(P, "cpu", torch.bfloat16)
    assert pol.px.dtype == torch.bfloat16 and float(pol.pz.max()) == 1.5
    back = convert.pol_to_numpy(pol)
    assert back[1].dtype == np.float32 and back[1].shape == jp.padded_shape and float(back[1].max()) == 1.0


def test_profile_groups_the_ade_kernels():
    assert profile_chunk._group("void (anonymous namespace)::ade_e_kernel<float, true>(float const*)") == \
        "yee_update_e_ade_sar"
    assert profile_chunk._group("void (anonymous namespace)::ade_e_kernel<__nv_bfloat16, false>(x)") == \
        "yee_update_e_ade"
    assert profile_chunk._group(
        "void (anonymous namespace)::ring_kernel<float, 2, 16, true, false, false, true, true, false, false>(x)") == \
        "yee_stream_ade_sar"
    assert profile_chunk._group(
        "void (anonymous namespace)::ring_kernel<float, 4, 24, true, true, false, true, false, false, false>(x)") == \
        "yee_stream_lossy_sar"
    assert "dispersive" in profile_chunk.SCENES
    assert grid.COMPONENTS == tuple(COMPONENTS) or list(grid.COMPONENTS) == COMPONENTS


def test_profile_groups_the_ring_kernels():
    """ring_kernel<T, S, BJ, CR, LOSSY, HET, SAR, ADE, DFT, BOX> and the CPML
    sweep's pml_kernel<T, S, BJ, CR, LOSSY, DFT> map to their variants' launch
    counters; in an unsharded CPML scene a box sweep is the CPML sweep's
    interior."""
    g = profile_chunk._group
    assert g("void (anonymous namespace)::ring_kernel<float, 2, 16, true, false, false, true, true, false, false>(x)"
             ) == "yee_stream_ade_sar"
    assert g("void (anonymous namespace)::ring_kernel<float, 4, 24, true, true, false, true, false, false, false>(x)"
             ) == "yee_stream_lossy_sar"
    assert g("void (anonymous namespace)::ring_kernel<__nv_bfloat16, 4, 32, false, false, false, false, false, "
             "false, true>(x)") == "yee_stream_shard"
    assert g("void (anonymous namespace)::ring_kernel<float, 2, 24, true, true, true, true, false, true, true>(x)"
             ) == "yee_stream_lossy_het_sar_dft_shard"
    assert g("void (anonymous namespace)::pml_kernel<float, 2, 24, false, false, false>(x)") == "yee_stream_pml"
    assert g("void (anonymous namespace)::pml_kernel<__nv_bfloat16, 2, 20, false, true, true>(x)"
             ) == "yee_stream_lossy_pml_dft"
    assert g("void (anonymous namespace)::ring_kernel<float, 2, 24, false, false, false, false, false, true, true>(x)",
             True) == "yee_stream_pml_dft_interior"


def test_profile_groups_the_two_pass_kernels():
    """h_kernel<T, HET, BOX>, e_kernel<T, LOSSY, BOX> and
    march_kernel<T, E, MAT, PML, AH, BJ, BI, NB, CB, BATCH> (the vacuum,
    batched and CPML passes) map to their launch counters; in a sharded
    scene a march_kernel pass is the shard's; a batched one is a sweep's."""
    g = profile_chunk._group
    assert g("void (anonymous namespace)::h_kernel<__nv_bfloat16, true, true>(x)") == "yee_update_h_het_shard"
    assert g("void (anonymous namespace)::h_kernel<float, true, false>(x)") == "yee_update_h_het"
    assert g("void (anonymous namespace)::e_kernel<float, true, false>(x)") == "yee_update_e_lossy"
    assert g("void (anonymous namespace)::e_kernel<float, true, true>(x)") == "yee_update_e_lossy_shard"
    march = "void (anonymous namespace)::march_kernel<{}, {}, {}, {}, 2, 2, 128, 4, 16, {}>(x)"
    assert g(march.format("float", "false", "false", "false", "false")) == "yee_update_h"
    assert g(march.format("float", "true", "false", "false", "false"), False, True) == "yee_update_e_shard"
    assert g(march.format("float", "false", "false", "true", "false")) == "yee_update_h_pml"
    assert g(march.format("float", "true", "true", "true", "false"), True) == "yee_update_e_lossy_pml"
    assert g(march.format("__nv_bfloat16", "false", "true", "true", "false"), False, True) == \
        "yee_update_h_het_pml_shard"
    assert g(march.format("float", "false", "false", "false", "true")) == "yee_update_h_batch"
    assert g(march.format("__nv_bfloat16", "true", "false", "false", "true")) == "yee_update_e_batch"
    assert g("void (anonymous namespace)::march_kernel<float, false, false, false, 2, 2, 64, 8, 16, true>(x)"
             ) == "yee_update_h_batch"
