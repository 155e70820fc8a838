"""Materials and heating in the port: lossy and heterogeneous-mu_r media and
the SAR (power deposition) accumulator, held against the JAX package.

Inputs come from numpy (seeded where random) and go through both packages.

- Masks, loads and the update coefficients are the same fp64 host
  arithmetic rounded once to the field dtype: equal, exactly, in fp64, fp32
  and bf16.
- ``torch`` backend against ``fdtd_tpu`` ``xla`` with ``accumulate_power``:
  fp64 fields at atol 1e-15 / rtol 1e-11 (reassociation level), the fp32
  accumulator at rtol 1e-6 (its increments are fp64 reductions in another
  order, rounded to fp32); fp32 fields at atol 2e-7 and the accumulator at
  rtol 1e-5 (the tolerances of tests/test_materials.py), both modes, 8
  steps (XLA rounds some sums differently: 3 ulp of the O(1) fields by
  step 8, 4 ulp by step 12).
- The plain versions of the two-pass material kernels (``twopass`` on CPU
  tensors) against interpret-mode ``pallas_fused`` with materials, 8 steps:
  fp32 at atol 2e-7; bf16 within one bf16 ulp (2^-8) of each component's
  scale.
- ``plain_sweep`` with lossy + het-mu + SAR (the ``stream`` backend on CPU
  tensors) against interpret-mode ``pallas_stream``, 19 steps at s=8 (two
  sweeps and three two-pass steps), computation mode: fp32 fields at atol
  1e-6 and SAR at rtol 1e-5; bf16 fields within scale/128 (the
  tolerances of tests/test_torch_stream.py for the vacuum sweep) and SAR
  within 2^-6 of its peak (the TPU kernel sums each sweep's increments
  before adding them, the port adds them step by step, and the bf16
  trailing steps see fields that may differ by a bf16 rounding).  The two interpret-mode runs take about 7 s
  (fp32) and 10 s (bf16) on one CPU.
- Port-internal: ``plain_sweep`` with SAR is s ``torch`` steps with their
  per-step increments, bit for bit in fp32; the runner, CLI, checkpoints
  and the backend choice with materials.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import cli as jcli  # noqa: E402
from fdtd_tpu import state as jstate  # noqa: E402
from fdtd_tpu.io.vtr import read_vtr_cell_arrays as j_read_vtr  # noqa: E402
from fdtd_tpu.params import Mode, Params, load_parameters, time_values  # noqa: E402
from fdtd_tpu.runner import run_simulation as j_run  # noqa: E402
from fdtd_tpu.step import backend_adapters  # noqa: E402
from fdtd_tpu.step import make_chunk_runner as j_chunk_runner  # noqa: E402
from fdtd_tpu.step import scan_inputs as j_scan_inputs  # noqa: E402
from fdtd_tpu.step import zero_power_acc as j_zero_power_acc  # noqa: E402
from fdtd_tpu_torch import cli, convert, diagnostics, runner  # noqa: E402
from fdtd_tpu_torch import state as tstate  # noqa: E402
from fdtd_tpu_torch import step as tstep  # noqa: E402
from fdtd_tpu_torch.ops import stream, stream_plan, yee  # noqa: E402
from fdtd_tpu_torch.source import (apply_source, make_source_plan, profile_tensor,  # noqa: E402
                                   sweep_drive_rows)

COMPONENTS = ["ex", "ey", "ez", "hx", "hy", "hz"]
COEF_FIELDS = ("ca_x", "ca_y", "ca_z", "cb_x", "cb_y", "cb_z", "sigma_cells", "hf_x", "hf_y", "hf_z")


def _box(length, width, height, mode=Mode.COMPUTATION, dtype="float32", sim=1e-11):
    return Params(length=length, width=width, height=height, spatial_step=0.001, time_step=1e-12,
                  simulation_time=sim, sampling_rate=5, mode=mode, dtype=dtype)


# (K, J, I) = (12, 9, 11): non-cubic
NONCUBIC = (0.0115, 0.0095, 0.0125)


def _ferrite_water(p):
    """eps, sigma and mu all heterogeneous: a lossy block and a ferrite
    slab (the scene of tests/test_materials.py::_ferrite_water_scene)."""
    K, J, I = p.maxk, p.maxj, p.maxi
    er, sg, mu = np.ones((K, J, I)), np.zeros((K, J, I)), np.ones((K, J, I))
    er[2 : K - 2, 2 : J - 2, 2 : I - 2] = 20.0
    sg[2 : K - 2, 2 : J - 2, 2 : I - 2] = 0.8
    mu[K // 2 :, : J // 2, :] = 4.0
    return jstate.Materials(eps_r=er, sigma=sg, mu_r=mu)


SCENES = {
    "water": lambda p: jstate.water_block(p, lo=(0.2, 0.2, 0.2), hi=(0.8, 0.8, 0.8)),
    "ferrite": lambda p: jstate.ferrite_slab(p),
    "water_ferrite": _ferrite_water,
}


def _as_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp_np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# --- masks, loads, coefficients ------------------------------------------------


MASKS = [
    ("block_mask", {}),
    ("block_mask", {"lo": (0.1, 0.25, 0.0), "hi": (0.65, 1.0, 0.45)}),
    ("sphere_mask", {}),
    ("sphere_mask", {"center": (0.35, 0.6, 0.5), "radius": 0.3}),
    ("cylinder_mask", {}),
    ("cylinder_mask", {"center": (0.6, 0.45), "radius": 0.25, "lo": 0.1, "hi": 0.9}),
]


@pytest.mark.parametrize("name, kw", MASKS)
@pytest.mark.parametrize("box", [NONCUBIC, (0.02, 0.02, 0.02)])
def test_masks_match_jax(box, name, kw):
    jp = _box(*box)
    tp = convert.params_from(jp)
    got = getattr(tstate, name)(tp, **kw)
    want = getattr(jstate, name)(jp, **kw)
    assert got.dtype == want.dtype == bool and got.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("load", ["water_block", "water_from_mask", "ferrite", "water_ferrite"])
def test_loads_match_jax(load):
    jp = _box(*NONCUBIC)
    tp = convert.params_from(jp)
    if load == "water_block":
        got, want = tstate.water_block(tp, eps_r=60.0, sigma=2.2), jstate.water_block(jp, eps_r=60.0, sigma=2.2)
    elif load == "water_from_mask":
        m = tstate.sphere_mask(tp, radius=0.35)
        got, want = tstate.water_from_mask(tp, m), jstate.water_from_mask(jp, m)
    elif load == "ferrite":
        got, want = tstate.ferrite_slab(tp, mu_r=3.0), jstate.ferrite_slab(jp, mu_r=3.0)
    else:
        got = tstate.ferrite_slab(tp, base=tstate.water_block(tp))
        want = jstate.ferrite_slab(jp, base=jstate.water_block(jp))
    for f in ("eps_r", "sigma", "mu_r"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert not got.is_vacuum


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_update_coefs_match_jax_exactly(scene, dtype):
    jp = _box(*NONCUBIC, dtype=dtype)
    tp = convert.params_from(jp)
    jm = SCENES[scene](jp)
    got = tstate.update_coefs(tp, convert.materials_from(jm), "cpu")
    want = jstate.update_coefs(jp, jm)
    assert got.lossy and got.heterogeneous_mu == want.heterogeneous_mu == (scene != "water")
    assert got.h_factor == want.h_factor
    for f in COEF_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is None:
            continue
        assert g.dtype == tstate.field_dtype(tp) and g.device.type == "cpu", f
        np.testing.assert_array_equal(_as_np(g), _jnp_np(w), err_msg=f)


def test_vacuum_coefs_stay_scalars():
    tp = convert.params_from(_box(*NONCUBIC))
    for m in (None, tstate.Materials()):
        c = tstate.update_coefs(tp, m)
        assert not c.lossy and not c.heterogeneous_mu and c.sigma_cells is None
        assert all(isinstance(getattr(c, f), float) for f in ("ca_x", "cb_z", "h_factor"))


def test_material_coefs_need_the_device():
    tp = convert.params_from(_box(*NONCUBIC))
    with pytest.raises(ValueError, match="needs the device"):
        tstate.update_coefs(tp, tstate.water_block(tp))


# --- torch backend against xla -------------------------------------------------


def _jax_xla(jp, jm, n):
    s0 = jstate.init_validation(jp) if jp.mode == Mode.VALIDATION else jstate.zeros(jp)
    xs = j_scan_inputs(jp, time_values(jp)[:n])
    st, acc = j_chunk_runner(jp, jm, backend="xla", accumulate_power=True)(s0, xs, j_zero_power_acc(jp))
    return s0, st, np.asarray(acc)


def _port_run(jp, jm, init, n, backend, **kw):
    tp = convert.params_from(jp)
    st = convert.state_from_numpy({c: np.asarray(getattr(init, c)) for c in COMPONENTS}, "cpu",
                                  tstate.field_dtype(tp))
    power = tstep.zero_power_acc(tp, "cpu")
    run = tstep.make_chunk_runner(tp, "cpu", convert.materials_from(jm), backend,
                                  accumulate_power=True, **kw)
    assert run(st, tstep.scan_inputs(tp, time_values(jp)[:n]), power) is st
    return st, power


@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_torch_backend_matches_jax_xla(tiny_params, dtype, mode):
    jp = dataclasses.replace(tiny_params, dtype=dtype, mode=mode)
    jm = _ferrite_water(jp)
    s0, want, acc_w = _jax_xla(jp, jm, 8)
    got, acc = _port_run(jp, jm, s0, 8, "torch")
    atol, rtol = (1e-15, 1e-11) if dtype == "float64" else (2e-7, 0)
    for c in COMPONENTS:
        np.testing.assert_allclose(getattr(got, c).numpy(), np.asarray(getattr(want, c)),
                                   atol=atol, rtol=rtol, err_msg=c)
    assert acc.dtype == torch.float32 and acc_w.dtype == np.float32 and float(acc_w.max()) > 0
    np.testing.assert_allclose(acc.numpy(), acc_w, rtol=1e-6 if dtype == "float64" else 1e-5,
                               atol=1e-6 * float(acc_w.max()))


# --- the plain versions of the kernels against interpret-mode Pallas ---------------


def _jax_pallas(jp, jm, n, backend, monkeypatch):
    monkeypatch.setenv("FDTD_STREAM_S", "8")
    s0 = jstate.zeros(jp)
    prep, rest = backend_adapters(jp, backend, jm)
    xs = j_scan_inputs(jp, time_values(jp)[:n])
    run = j_chunk_runner(jp, jm, backend=backend, accumulate_power=True)
    st, acc = run(prep(s0), xs, j_zero_power_acc(jp))
    got = rest(st)
    return s0, {c: _jnp_np(getattr(got, c)).astype(np.float32) for c in COMPONENTS}, np.asarray(acc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twopass_plain_matches_interpret_pallas_fused(tiny_params, monkeypatch, dtype):
    """K1-het and K2-lossy's plain versions, with the per-step SAR."""
    jp = dataclasses.replace(tiny_params, dtype=dtype, mode=Mode.COMPUTATION)
    jm = _ferrite_water(jp)
    s0, want, acc_w = _jax_pallas(jp, jm, 8, "pallas_fused", monkeypatch)
    yee.reset_launches()
    got, acc = _port_run(jp, jm, s0, 8, "twopass")
    assert yee.launches == dict.fromkeys(yee.launches, 0)  # CPU tensors: the plain versions
    for c in COMPONENTS:
        g = _as_np(getattr(got, c))
        if dtype == "float32":
            np.testing.assert_allclose(g, want[c], atol=2e-7, rtol=0, err_msg=c)
        else:
            scale = max(float(np.abs(want[c]).max()), 1e-30)
            assert float(np.abs(g - want[c]).max()) <= scale / 256, c
    assert float(np.abs(want["ez"]).max()) > 0 and float(acc_w.max()) > 0
    if dtype == "float32":
        np.testing.assert_allclose(acc.numpy(), acc_w, rtol=1e-5, atol=1e-6 * float(acc_w.max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_plain_matches_interpret_pallas_stream(tiny_params, monkeypatch, dtype):
    """K3's lossy + het-mu + SAR plain version: 19 steps at s=8."""
    jp = dataclasses.replace(tiny_params, dtype=dtype, mode=Mode.COMPUTATION)
    jm = _ferrite_water(jp)
    s0, want, acc_w = _jax_pallas(jp, jm, 19, "pallas_stream", monkeypatch)
    stream.reset_launches()
    got, acc = _port_run(jp, jm, s0, 19, "stream", stream_s=8)
    assert stream.launches == dict.fromkeys(stream.launches, 0)
    peak = float(acc_w.max())
    assert peak > 0 and float(np.abs(want["ez"]).max()) > 0
    for c in COMPONENTS:
        g = _as_np(getattr(got, c))
        if dtype == "float32":
            np.testing.assert_allclose(g, want[c], atol=1e-6, rtol=0, err_msg=c)
        else:
            scale = max(float(np.abs(want[c]).max()), 1e-30)
            assert float(np.abs(g - want[c]).max()) <= scale / 128, c
    if dtype == "float32":
        np.testing.assert_allclose(acc.numpy(), acc_w, rtol=1e-5, atol=1e-6 * peak)
    else:
        assert float(np.abs(acc.numpy() - acc_w).max()) <= peak / 64


# --- port-internal ---------------------------------------------------------


def _random_state(p, seed, dtype):
    rng = np.random.default_rng(seed)
    return convert.state_from_numpy({c: rng.uniform(-1, 1, p.padded_shape) for c in COMPONENTS}, "cpu", dtype)


@pytest.mark.parametrize("s", [8, 4, 2])
@pytest.mark.parametrize("het", [False, True])
def test_plain_sweep_with_sar_is_torch_steps(s, het):
    """fp32: a sweep with SAR is s torch steps each followed by its increment."""
    jp = _box(*NONCUBIC)
    tp = convert.params_from(jp)
    jm = _ferrite_water(jp)
    if not het:
        jm = dataclasses.replace(jm, mu_r=None)
    coefs = tstate.update_coefs(tp, convert.materials_from(jm), "cpu")
    a = _random_state(tp, 21, torch.float32)
    b = a.clone()
    src = make_source_plan(tp)
    amps = torch.tensor(np.random.default_rng(22).uniform(-1, 1, s), dtype=torch.float64)
    prof = profile_tensor(src, "cpu")
    apply_source(src, a, amps[0], prof)
    ez, hx = sweep_drive_rows(src, amps, s, torch.float32, prof)
    acc0 = torch.tensor(np.random.default_rng(23).uniform(0, 1e-3, (tp.maxk, tp.maxj, tp.maxi)),
                        dtype=torch.float32)
    acc_a, acc_b = acc0.clone(), acc0.clone()
    got = stream.plain_sweep(tp, a, coefs, s, stream.SweepDrive(src.patch, ez[0], hx[0]), acc=acc_a)
    step = tstep.make_step(tp, "cpu", backend="torch", coefs=coefs)
    for m in range(s):
        step(b, (0.0, float(amps[m])))
        diagnostics.accumulate_power(tp, b, coefs.sigma_cells, acc_b)
    for c in COMPONENTS:
        assert torch.equal(getattr(got, c), getattr(b, c)), c
    assert torch.equal(acc_a, acc_b) and not torch.equal(acc_a, acc0)


def test_stream_chunk_runner_with_sar_equals_torch():
    """fp32: 8k+3 steps of stream (two sweeps, three twopass steps) give
    the torch backend's fields and accumulator bit for bit."""
    jp = _box(*NONCUBIC, sim=1.9e-11)
    tp = convert.params_from(jp)
    mats = convert.materials_from(_ferrite_water(jp))
    xs = tstep.scan_inputs(tp, time_values(jp)[:19])
    out = {}
    for backend in ("stream", "torch", "twopass"):
        st, power = tstate.zeros(tp, "cpu"), tstep.zero_power_acc(tp, "cpu")
        kw = {"stream_s": 8} if backend == "stream" else {}
        tstep.make_chunk_runner(tp, "cpu", mats, backend, accumulate_power=True, **kw)(st, xs, power)
        out[backend] = (st, power)
    assert float(out["torch"][1].max()) > 0
    for backend in ("stream", "twopass"):
        for c in COMPONENTS:
            assert torch.equal(getattr(out[backend][0], c), getattr(out["torch"][0], c)), (backend, c)
        assert torch.equal(out[backend][1], out["torch"][1]), backend


def test_chunk_runner_needs_the_accumulator():
    tp = convert.params_from(_box(*NONCUBIC))
    run = tstep.make_chunk_runner(tp, "cpu", tstate.water_block(tp), "torch", accumulate_power=True)
    with pytest.raises(ValueError, match="zero_power_acc"):
        run(tstate.zeros(tp, "cpu"), tstep.scan_inputs(tp, time_values(tp)[:2]))


def test_sweep_refuses_a_plan_of_another_variant():
    tp = convert.params_from(_box(*NONCUBIC))
    coefs = tstate.update_coefs(tp, tstate.water_block(tp), "cpu")
    st = tstate.zeros(tp, "cpu")
    out = tstate.zeros(tp, "cpu")
    with pytest.raises(ValueError, match="plan is for"):
        stream.sweep(tp, st, out, coefs, stream_plan.plan_for(tp, 4))  # a vacuum plan
    with pytest.raises(ValueError, match="plan is for"):
        stream.sweep(tp, st, out, coefs, stream_plan.plan_for(tp, 4, lossy=True),
                     acc=tstep.zero_power_acc(tp, "cpu"))


# --- plans and backend choice ------------------------------------------------


def _cube(n, dtype, mode=Mode.COMPUTATION):
    return convert.params_from(_box(n * 1e-3, n * 1e-3, n * 1e-3, mode=mode, dtype=dtype))


def test_material_plans_gate_and_fit():
    p = _cube(256, "float32")
    plan = stream_plan.pick_plan(p, lossy=True, sar=True)
    assert plan.kernel == "yee_stream_lossy_sar" and plan.blocks >= stream_plan.SM_COUNT
    assert plan.bj == stream_plan.BLOCK_J_MATERIAL[plan.s]
    assert (plan.tj, plan.ti) == (plan.bj - 2 * plan.s - 1, plan.bi - 2 * plan.s - 1)  # SAR tile
    het = stream_plan.pick_plan(p, het=True)
    assert het.kernel == "yee_stream_lossy_het" and het.tj == het.bj - 2 * het.s
    assert stream_plan.pick_plan(p, lossy=True, het=True, sar=True).kernel == "yee_stream_lossy_het_sar"
    # gates: materials stream in computation mode only; SAR needs materials
    pv = _cube(256, "float32", Mode.VALIDATION)
    assert stream_plan.pick_plan(pv, lossy=True) is None and stream_plan.pick_plan(pv) is not None
    assert stream_plan.pick_plan(p, sar=True) is None


def test_plan_refuses_1024_fp32_heating_with_het_at_80gb():
    p = _cube(1024, "float32")
    need = 2 * stream_plan.state_bytes(p) + stream_plan.material_bytes(p, True, True, True)
    assert 98e9 < need < 100e9  # about 99 GB: more than the card's 80 GB
    assert stream_plan.pick_plan(p, lossy=True, het=True, sar=True) is None
    assert stream_plan.pick_plan(p) is not None  # vacuum fits
    assert stream_plan.pick_plan(_cube(1024, "bfloat16"), lossy=True, het=True, sar=True) is not None


@pytest.mark.parametrize(
    "device, dtype, mode, memory, want",
    [
        ("cuda", "float32", Mode.COMPUTATION, None, "stream"),
        ("cuda", "bfloat16", Mode.COMPUTATION, None, "stream"),
        ("cuda", "float32", Mode.VALIDATION, None, "twopass"),
        ("cuda", "float32", Mode.COMPUTATION, 2 * 10**9, "twopass"),
        ("cpu", "float32", Mode.COMPUTATION, None, "torch"),
        ("cuda", "float64", Mode.COMPUTATION, None, "torch"),
    ],
)
def test_resolve_backend_with_materials(monkeypatch, device, dtype, mode, memory, want):
    p = _cube(256, dtype, mode)
    if memory is not None:
        monkeypatch.setattr(stream_plan, "DEVICE_BYTES", memory)
    mats = tstate.water_block(p)
    assert runner.resolve_backend(p, "auto", device, mats, accumulate_power=True) == want
    if want == "twopass" and dtype == "float32":
        with pytest.raises(ValueError, match="no stream plan"):
            runner.resolve_backend(p, "stream", device, mats, accumulate_power=True)


def test_twopass_memory_at_1024_fp32_heating_with_het(monkeypatch):
    """Where no stream plan fits, twopass holds one state, the nine
    coefficient arrays, sigma, the map and the SAR increment's slab
    temporaries; resolve_backend refuses the scene when even that does
    not fit."""
    p = _cube(1024, "float32")
    need = stream_plan.twopass_bytes(p, True, True, True)
    resident = stream_plan.state_bytes(p) + stream_plan.material_bytes(p, True, True, True)
    assert 73e9 < resident < need < 75e9  # about 74.3 GB
    assert need - resident == stream_plan.sar_work_bytes(p) <= 2**30  # slabs of 32 planes
    # resolve_backend reads only which maps are set, not their size
    mats = tstate.Materials(eps_r=np.ones(1), sigma=np.zeros(1), mu_r=np.ones(1))
    monkeypatch.setattr(stream_plan, "DEVICE_BYTES", 84 * 10**9)  # about an H100 80GB's free bytes
    assert runner.resolve_backend(p, "auto", "cuda", mats, accumulate_power=True) == "twopass"
    monkeypatch.setattr(stream_plan, "DEVICE_BYTES", 80 * 10**9)
    for backend in ("auto", "twopass"):
        with pytest.raises(ValueError, match="does not fit in device memory"):
            runner.resolve_backend(p, backend, "cuda", mats, accumulate_power=True)
    assert runner.resolve_backend(_cube(1024, "bfloat16"), "auto", "cuda", mats, accumulate_power=True) == "stream"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sar_increment_in_slabs_is_the_whole_grid_increment(monkeypatch, dtype):
    """The per-step increment a slab of k planes at a time gives the bits
    of one whole-grid increment (sigma*|E|^2*dt per cell)."""
    jp = _box(*NONCUBIC, dtype=dtype)
    tp = convert.params_from(jp)
    coefs = tstate.update_coefs(tp, tstate.water_block(tp), "cpu")
    st = _random_state(tp, 31, tstate.field_dtype(tp))
    # increments are about sigma * dt = 1.7e-12: an accumulator of that size
    acc0 = torch.tensor(np.random.default_rng(32).uniform(0, 1e-11, (tp.maxk, tp.maxj, tp.maxi)),
                        dtype=torch.float32)
    whole = acc0.clone()
    diagnostics.accumulate_power(tp, st, coefs.sigma_cells, whole)
    assert diagnostics.sar_slab_planes(tp) == tp.maxk  # one slab at this size
    monkeypatch.setattr(diagnostics, "SAR_SLAB_CELLS", 5 * tp.maxj * tp.maxi + 5)
    assert diagnostics.sar_slab_planes(tp) == 5 and tp.maxk % 5  # a ragged last slab
    slabs = acc0.clone()
    diagnostics.accumulate_power(tp, st, coefs.sigma_cells, slabs)
    assert torch.equal(slabs, whole) and not torch.equal(whole, acc0)
    esq = diagnostics.e_center_sq(tp, st)
    inc = coefs.sigma_cells.to(esq.dtype) * esq
    assert torch.equal(whole, acc0 + (inc * float(np.float32(tp.time_step))).to(torch.float32))


def test_resolve_backend_sar_needs_materials():
    p = _cube(256, "float32")
    assert runner.resolve_backend(p, "auto", "cuda", None, accumulate_power=True) == "twopass"
    assert runner.resolve_backend(p, "auto", "cuda", tstate.ferrite_slab(p)) == "stream"


# --- runner, CLI and checkpoints on the CPU -------------------------------------------


def test_cli_water_block_sar_writes_jax_sar_map(tmp_path, capsys):
    params = tmp_path / "p.txt"
    params.write_text("0.012\n0.011\n0.013\n0.001\n1e-12\n1.2e-11\n4\n1\n")
    assert jcli.main([str(params), "--water-block", "--sar", "--backend", "xla",
                      "--out", str(tmp_path / "j")]) == 0
    assert cli.main([str(params), "--water-block", "--sar", "--device", "cpu",
                     "--out", str(tmp_path / "t")]) == 0
    out = capsys.readouterr().out
    assert "SAR map written to" in out and "Simulation complete!" in out
    want = j_read_vtr(str(tmp_path / "j" / "sar.vtr"))
    got = j_read_vtr(str(tmp_path / "t" / "sar.vtr"))
    assert set(got) == set(want) and {"power_j_m3", "avg_power_w_m3"} <= set(want)
    for name in want:
        peak = float(want[name].max())
        assert peak > 0 and got[name].dtype == want[name].dtype
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-6 * peak, err_msg=name)
    # the snapshots of the lossy run agree too (fp32, the fields' tolerance)
    for f in sorted(os.listdir(tmp_path / "j")):
        if f.startswith("result"):
            a, b = j_read_vtr(str(tmp_path / "t" / f)), j_read_vtr(str(tmp_path / "j" / f))
            for k in a:
                np.testing.assert_allclose(a[k], b[k], atol=2e-7, rtol=0, err_msg=f"{f}/{k}")


@pytest.mark.parametrize("args, msg", [
    (["--load-shape", "sphere"], "need --water-block"),
    (["--water-block", "--load-center", "0.5"], "X,Y"),
    (["--water-block", "--load-center", "1.2,0.5"], "in (0, 1)"),
])
def test_cli_load_flag_errors(tmp_path, capsys, args, msg):
    params = tmp_path / "p.txt"
    params.write_text("0.01 0.01 0.01 0.001 1e-12 1e-11 5 1")
    assert cli.main([str(params), "--device", "cpu", "--out", str(tmp_path / "r"), *args]) == 1
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("shape, center", [("sphere", None), ("cylinder", "0.4,0.6"), ("box", "0.45,0.55")])
def test_cli_load_shapes_deposit_inside_the_load(tmp_path, shape, center):
    params = tmp_path / "p.txt"
    params.write_text("0.014 0.014 0.014 0.001 1e-12 1.5e-11 1000 1")
    argv = [str(params), "--device", "cpu", "--water-block", "--sar", "--load-shape", shape,
            "--out", str(tmp_path / "r")] + (["--load-center", center] if center else [])
    assert cli.main(argv) == 0
    p = load_parameters(str(params))  # the JAX parser: the grid of both CLIs
    cx, cy = (float(v) for v in center.split(",")) if center else (0.5, 0.5)
    ox, oy = cx - 0.5, cy - 0.5
    mask = {"sphere": lambda: jstate.sphere_mask(p, center=(cx, cy, 0.5)),
            "cylinder": lambda: jstate.cylinder_mask(p, center=(cx, cy)),
            "box": lambda: jstate.block_mask(p, lo=(0.3 + ox, 0.3 + oy, 0.3),
                                             hi=(0.7 + ox, 0.7 + oy, 0.7))}[shape]()
    sar = j_read_vtr(str(tmp_path / "r" / "sar.vtr"))["power_j_m3"]
    assert float(sar[~mask].max()) == 0.0 and float(sar[mask].max()) > 0.0


def test_cli_sar_on_vacuum_is_a_zero_map(tmp_path):
    params = tmp_path / "p.txt"
    params.write_text("0.01 0.01 0.01 0.001 1e-12 1e-11 1000 1")
    assert cli.main([str(params), "--device", "cpu", "--sar", "--out", str(tmp_path / "r")]) == 0
    sar = j_read_vtr(str(tmp_path / "r" / "sar.vtr"))["power_j_m3"]
    p = load_parameters(str(params))
    assert sar.shape == (p.maxk, p.maxj, p.maxi) and not sar.any()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sar_checkpoint_resumes_across_packages(tiny_params, tmp_path, writer):
    """A checkpoint with ``power_acc`` written by either package resumes in
    the other; the resumed totals equal an uninterrupted run's (fp32)."""
    jp = dataclasses.replace(tiny_params, dtype="float32", mode=Mode.COMPUTATION,
                             simulation_time=1.6e-11, sampling_rate=8)
    jm = jstate.water_block(jp)
    tm = convert.materials_from(jm)
    quiet = {"log": lambda m: None, "write_snapshots": False}
    full = runner.run_simulation(convert.params_from(jp), "cpu", out_dir=str(tmp_path / "full"),
                                 materials=tm, accumulate_power=True, **quiet)
    ck_dir = tmp_path / "ck"
    if writer == "jax":
        j_run(jp, out_dir=str(ck_dir), materials=jm, accumulate_power=True, checkpoint_every=8, **quiet)
        os.remove(ck_dir / "ckpt000016.npz")  # resume from step 8
        res = runner.run_simulation(convert.params_from(jp), "cpu", out_dir=str(ck_dir), materials=tm,
                                    accumulate_power=True, resume=True, **quiet)
        got_state, got_power = res.state, res.power_j.numpy()
        want_state, want_power = full.state, full.power_j.numpy()
        tol = (2e-7, 1e-5)  # JAX's first half against the port's
    else:
        runner.run_simulation(convert.params_from(jp), "cpu", out_dir=str(ck_dir), materials=tm,
                              accumulate_power=True, checkpoint_every=8, **quiet)
        with np.load(ck_dir / "ckpt000008.npz") as z:
            assert z["power_acc"].dtype == np.float32 and float(z["power_acc"].max()) > 0
        os.remove(ck_dir / "ckpt000016.npz")
        res = j_run(jp, out_dir=str(ck_dir), materials=jm, accumulate_power=True, resume=True, **quiet)
        got_state, got_power = res.state, np.asarray(res.power_j)
        want = j_run(jp, out_dir=str(tmp_path / "jfull"), materials=jm, accumulate_power=True, **quiet)
        want_state, want_power = want.state, np.asarray(want.power_j)
        tol = (2e-7, 1e-5)
    for c in COMPONENTS:
        np.testing.assert_allclose(np.asarray(getattr(got_state, c)), np.asarray(getattr(want_state, c)),
                                   atol=tol[0], rtol=0, err_msg=c)
    peak = float(want_power.max())
    assert peak > 0
    np.testing.assert_allclose(got_power, want_power, rtol=tol[1], atol=1e-6 * peak)


def test_resume_without_power_warns(tiny_params, tmp_path):
    jp = dataclasses.replace(tiny_params, dtype="float32", mode=Mode.COMPUTATION,
                             simulation_time=1.6e-11, sampling_rate=8)
    tp = convert.params_from(jp)
    quiet = {"log": lambda m: None, "write_snapshots": False}
    runner.run_simulation(tp, "cpu", out_dir=str(tmp_path), checkpoint_every=8, **quiet)
    os.remove(tmp_path / "ckpt000016.npz")
    res = runner.run_simulation(tp, "cpu", out_dir=str(tmp_path), materials=tstate.water_block(tp),
                                accumulate_power=True, resume=True, **quiet)
    assert any("no power accumulator" in w for w in res.warnings)
    assert res.power_j is not None and float(res.power_j.max()) > 0


def test_convert_materials_and_power():
    jp = _box(*NONCUBIC)
    jm = _ferrite_water(jp)
    tm = convert.materials_from(jm)
    assert tm.eps_r is not jm.eps_r and np.array_equal(tm.mu_r, jm.mu_r)
    assert convert.materials_from(jstate.Materials()).is_vacuum
    acc = np.asarray(j_zero_power_acc(jp)) + np.float32(0.5)
    t = convert.power_from_numpy(acc, "cpu")
    assert t.dtype == torch.float32 and t.shape == (jp.maxk, jp.maxj, jp.maxi) and float(t.max()) == 0.5
