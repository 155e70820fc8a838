"""The CPML open boundary in the port, held against the JAX package.

Inputs are made from a seed with numpy and go through both packages.

- ``build_plan``'s (b, c) tables and ``psi_shapes`` are the same fp64 host
  arithmetic rounded once to the field dtype: equal, exactly, in fp64, fp32
  and bf16.
- The ``torch`` backend against ``fdtd_tpu`` xla ``make_pml_chunk_runner``
  (the scene of tests/test_pml.py::test_pml_kernel_matches_xla: 24^3, 5
  cells, 40 steps; computation mode from zero fields and the source,
  validation mode from a smooth pulse in every component), cases vacuum,
  lossy + SAR, het-mu and a water + ferrite load that overlaps the
  absorber.  fp64: fields and all twelve psi at rtol 1e-12 / atol 1e-14
  (reassociation level), every psi engaged; the fp32 SAR map at rtol 1e-6
  (the bound of tests/test_torch_materials.py: fp64 increments rounded to fp32 from reductions in
  another order).  fp32: fields and psi at atol 5e-6 of fields of order 1,
  the SAR map at rtol 1e-5 (XLA groups some sums differently; 40 steps).
- The plain versions of the CPML kernels against the interpret-mode TPU
  kernels, 24^3, 5 cells, computation mode, from seeded random fields (on
  the update regions: the PEC walls zero) so that all twelve psi terms
  engage from the first step (asserted): the
  two-pass step (12 steps) against
  ``cpml_kernel.make_pml_kernel_chunk_runner`` through ``unpack_psi``;
  fp32 with each array within 2^-20 of its own scale; bf16 against the
  fp32 result, the port no further from it than the TPU plus 2^-6 of the
  scale (the TPU rounds to bf16 before its k-axis adds and rounds their
  factors to bf16, the port rounds once per pass).  The port's sweep (8
  steps at s = 2, vacuum and lossy) against
  ``make_stream_pml_chunk_runner`` at s = 4 and 2 through
  ``unpack_psi_stream``: fp32 within 2^-20 of each array's scale; bf16
  within 2^-7 of the scale.  The interpret-mode runs take 3-6 s each on
  one CPU.
- Port-internal, bit for bit in fp32: a CPML sweep is s ``torch`` steps;
  ``stream`` (with an odd tail) = ``twopass`` = ``torch``; the source patch
  rule (the kernels skip the Hx/Hz adds on the patch, the xla order
  overwrites them).
- Physics through the port: the inert test, the absorption test and the
  gaussian ring-down of tests/test_pml.py at that file's thresholds.
- ``poynting_flux`` against the JAX function; checkpoints with psi across
  packages; the CLI against the JAX CLI; the backend gates and memory
  model; the k-slab outputs (snapshots and energies) against whole-grid
  ones.
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

from fdtd_tpu import cli as jcli  # noqa: E402
from fdtd_tpu import diagnostics as jdiag  # noqa: E402
from fdtd_tpu import state as jstate  # noqa: E402
from fdtd_tpu.io.vtr import read_vtr_cell_arrays as j_read_vtr  # noqa: E402
from fdtd_tpu.ops import cpml as jcpml  # noqa: E402
from fdtd_tpu.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu.runner import run_simulation as j_run  # noqa: E402
from fdtd_tpu.step import backend_adapters  # noqa: E402
from fdtd_tpu.step import scan_inputs as j_scan_inputs  # noqa: E402
from fdtd_tpu.step import zero_power_acc as j_zero_power_acc  # noqa: E402
from fdtd_tpu_torch import cli, convert, diagnostics, grid, runner  # noqa: E402
from fdtd_tpu_torch import state as tstate  # noqa: E402
from fdtd_tpu_torch import step as tstep  # noqa: E402
from fdtd_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from fdtd_tpu_torch.io import snapshots  # noqa: E402
from fdtd_tpu_torch.ops import cpml, stream, stream_plan, yee  # noqa: E402
from fdtd_tpu_torch.source import (apply_source, make_source_plan, profile_tensor,  # noqa: E402
                                   sweep_drive_rows)

COMPONENTS = ["ex", "ey", "ez", "hx", "hy", "hz"]
PSI = cpml.PsiState.names()


def _box(n, steps, mode=Mode.COMPUTATION, dtype="float64"):
    return Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=1e-3,
                  time_step=1e-12, simulation_time=steps * 1e-12, sampling_rate=10**9,
                  mode=mode, dtype=dtype)


def _random_fields(p, seed, scale=1.0):
    """Seeded uniform fields, zero outside each component's physical extent."""
    rng = np.random.default_rng(seed)
    ext = grid.extents(convert.params_from(p))
    out = {}
    for c in COMPONENTS:
        a = np.zeros(p.padded_shape)
        k, j, i = getattr(ext, c)
        a[:k, :j, :i] = rng.uniform(-scale, scale, (k, j, i))
        out[c] = a
    return out


def _updated_fields(p, seed):
    """Seeded uniform fields on each component's update region (the PEC
    walls zero, as in every real state), E of order 1 and H of order
    1/eta0."""
    raw = _random_fields(p, seed)
    regions = cpml._update_regions(convert.params_from(p))
    out = {}
    for c in COMPONENTS:
        mask = np.zeros(p.padded_shape, bool)
        mask[regions[c]] = True
        out[c] = np.where(mask, raw[c], 0.0) / (cpml.ETA0 if c[0] == "h" else 1.0)
    return out


def _pulse_fields(p):
    """Zero fields in computation mode (the source drives them); in
    validation mode a smooth pulse in every component, so that all twelve
    psi terms engage (the TE101 seed leaves Ex, Ez and Hy at zero)."""
    if p.mode == Mode.COMPUTATION:
        return {c: np.zeros(p.padded_shape) for c in COMPONENTS}
    out = _solenoidal(p, 2.0)
    g = _gaussian_ey(p, 2.0, 12.0)["ey"]
    out["ez"] = 0.5 * np.roll(g, 2, axis=2)
    out["hx"] = 1e-3 * g
    out["hy"] = 1e-3 * np.roll(g, -1, axis=1)
    ext = grid.extents(convert.params_from(p))
    for c in COMPONENTS:
        k, j, i = getattr(ext, c)
        mask = np.zeros(p.padded_shape, bool)
        mask[:k, :j, :i] = True
        out[c] = np.where(mask, out[c], 0.0)
    return out


def _jax_state(arrays, dtype):
    return jstate.FieldState(**{c: jnp.asarray(arrays[c], dtype) for c in COMPONENTS})


def _np(a):
    a = a.float().numpy() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _case(p, case):
    """(materials, accumulate_power) of a parity case on the grid of ``p``."""
    K, J, I = p.maxk, p.maxj, p.maxi
    if case == "vacuum":
        return None, False
    if case == "lossy+sar":
        return jstate.water_block(p, lo=(0.35,) * 3, hi=(0.65,) * 3), True
    if case == "het-mu":  # interior, clear of the slabs
        er, sg, mu = np.ones((K, J, I)), np.zeros((K, J, I)), np.ones((K, J, I))
        c0, c1 = K // 2 - 3, K // 2 + 3
        er[c0:c1, c0:c1, c0:c1] = 8.0
        sg[c0:c1, c0:c1, c0:c1] = 0.4
        mu[c0:c1, c0:c1, c0:c1] = 3.0
        return jstate.Materials(eps_r=er, sigma=sg, mu_r=mu), False
    # a water block and a ferrite slab reaching into the absorber
    water = jstate.water_block(p, lo=(0.05,) * 3, hi=(0.95,) * 3, eps_r=20.0, sigma=0.8)
    return jstate.ferrite_slab(p, base=water, lo=(0.0, 0.0, 0.5), hi=(1.0, 0.6, 1.0), mu_r=3.0), True


def _xla(jp, cfg, mats, sar, init, steps):
    xs = j_scan_inputs(jp, time_values(jp)[:steps])
    run = jcpml.make_pml_chunk_runner(jp, cfg, mats, accumulate_power=sar)
    (st, psi), pw = run((_jax_state(init, jp.dtype), jcpml.init_psi(jp, cfg)), xs,
                        j_zero_power_acc(jp) if sar else None)
    return st, psi, (np.asarray(pw) if sar else None)


def _port(jp, cells, mats, sar, init, steps, backend="torch", **kw):
    tp = convert.params_from(jp)
    st = convert.state_from_numpy(init, "cpu", tstate.field_dtype(tp))
    psi = cpml.init_psi(tp, cpml.PMLConfig(cells=cells), "cpu")
    power = tstep.zero_power_acc(tp, "cpu") if sar else None
    run = tstep.make_chunk_runner(tp, "cpu", convert.materials_from(mats) if mats is not None else None,
                                  backend, accumulate_power=sar, pml=cpml.PMLConfig(cells=cells), **kw)
    assert run(st, tstep.scan_inputs(tp, time_values(jp)[:steps]), power, psi) is st
    return st, psi, power


# --- tables and shapes -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_build_plan_and_psi_shapes_match_jax_exactly(dtype):
    jp = dataclasses.replace(_box(24, 4), length=0.0215, width=0.0195, dtype=dtype)  # (24, 19, 21)
    tp = convert.params_from(jp)
    jcfg, tcfg = jcpml.PMLConfig(cells=5, alpha=0.05), cpml.PMLConfig(cells=5, alpha=0.05)
    assert cpml.psi_shapes(tp, tcfg) == jcpml.psi_shapes(jp, jcfg)
    want = jcpml.build_plan(jp, jcfg, jnp.dtype(dtype))
    got = cpml.build_plan(tp, tcfg, "cpu")
    assert set(got) == set(want) == set(cpml.TERM_NAMES)
    for name in want:
        for q in range(6):
            assert got[name][q] == want[name][q], (name, q)
        for q in (6, 7):
            g, w = got[name][q], want[name][q]
            assert g.dtype == tstate.field_dtype(tp) and tuple(g.shape) == w.shape
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"{name}/{q}")
    assert float(np.abs(_np(want["hx_z"][7])).max()) > 0
    psi = cpml.init_psi(tp, tcfg, "cpu")
    jpsi = jcpml.init_psi(jp, jcfg)
    for n in PSI:
        assert tuple(getattr(psi, n).shape) == getattr(jpsi, n).shape
        assert getattr(psi, n).dtype == tstate.field_dtype(tp)
    assert cpml.psi_bytes(tp, tcfg) == sum(getattr(jpsi, n).nbytes for n in PSI)
    cp = cpml.make_cpml(tp, tcfg, tstate.update_coefs(tp), "cpu")
    assert tuple(cp.table_h.shape) == tuple(cp.table_e.shape) == (6, 2, 10)
    np.testing.assert_array_equal(_np(cp.table_e[3, 1]), _np(want["ey_z"][7]).ravel())
    with pytest.raises(ValueError, match="overlap"):
        cpml.init_psi(tp, cpml.PMLConfig(cells=10), "cpu")


# --- torch backend against xla --------------------------------------------------


@pytest.mark.parametrize("mode", [Mode.COMPUTATION, Mode.VALIDATION])
@pytest.mark.parametrize("case", ["vacuum", "lossy+sar", "het-mu", "overlap"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_torch_pml_matches_xla(case, mode, dtype):
    n, steps = 24, 40
    jp = _box(n, steps, mode, dtype)
    mats, sar = _case(jp, case)
    init = _pulse_fields(jp)
    want, psi_w, pw_w = _xla(jp, jcpml.PMLConfig(cells=5), mats, sar, init, steps)
    got, psi, pw = _port(jp, 5, mats, sar, init, steps)
    tol = {"rtol": 1e-12, "atol": 1e-14} if dtype == "float64" else {"rtol": 0, "atol": 5e-6}
    for c in COMPONENTS:
        np.testing.assert_allclose(getattr(got, c).numpy(), np.asarray(getattr(want, c)),
                                   err_msg=f"{case}/{c}", **tol)
    engaged = 0
    for name in PSI:
        b = np.asarray(getattr(psi_w, name))
        np.testing.assert_allclose(getattr(psi, name).numpy(), b, err_msg=f"{case}/psi/{name}", **tol)
        engaged += float(np.abs(b).max()) > 0
    assert engaged == 12, case
    if sar:
        peak = float(pw_w.max())
        assert peak > 0 and pw.dtype == torch.float32
        np.testing.assert_allclose(pw.numpy(), pw_w, rtol=1e-6 if dtype == "float64" else 1e-5,
                                   atol=1e-6 * peak)


# --- the plain versions of the kernels against the interpret-mode TPU kernels ---


def _kernel_scene(dtype, lossy):
    jp = _box(24, 12, Mode.COMPUTATION, dtype)
    mats = None
    if lossy:  # interior: the TPU kernels need slab-constant factors
        mats = jstate.ferrite_slab(jp, base=jstate.water_block(jp, lo=(0.35,) * 3, hi=(0.65,) * 3),
                                   lo=(0.35, 0.35, 0.35), hi=(0.65, 0.5, 0.65), mu_r=3.0)
    return jp, mats


def _close(got, want, dtype, tag):
    """``got`` within 2^-20 (fp32) or 2^-7 (bf16) of ``want``'s scale, its
    largest magnitude: a few fp32 roundings of the largest term, one bf16
    rounding."""
    scale = float(np.abs(_np(want)).max())
    assert scale > 0, tag  # an array that never moved would pass any tolerance
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err <= scale * (2.0**-20 if dtype == "float32" else 2.0**-7), (tag, err, scale)


def _engaged(psi):
    """The number of psi terms (of twelve) that hold a non-zero value."""
    return sum(float(np.abs(_np(getattr(psi, n))).max()) > 0 for n in PSI)


@pytest.mark.parametrize("materials", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_twopass_pml_matches_interpret_cpml_kernel(dtype, materials):
    """K10's plain versions (the het-mu H and lossy E variants with
    materials) against ``_h_kernel_pml``/``_e_kernel_pml``, 12 steps.
    From seeded random fields: all twelve terms engage.  bf16: the TPU
    rounds to bf16 before its k-axis adds and rounds their factors f and
    cb to bf16 (fdtd_tpu/ops/cpml_fast.py:191), the port rounds once per
    pass with fp32 factors; so each bf16 result is held to the fp32 one:
    the port's no further from it than the TPU's, plus 2^-6 of each
    array's scale (four bf16 roundings: a slab psi is a small difference
    of rounded fields)."""
    from fdtd_tpu.ops.cpml_kernel import make_pml_kernel_chunk_runner, pack_psi, unpack_psi

    jp, mats = _kernel_scene(dtype, materials)
    jcfg = jcpml.PMLConfig(cells=5)
    prep, restore = backend_adapters(jp, "pallas_fused", mats)
    run_k = make_pml_kernel_chunk_runner(jp, jcfg, mats, interpret=True)
    xs = j_scan_inputs(jp, time_values(jp)[:12])
    init = _updated_fields(jp, 51)
    (st, pp), _ = run_k((prep(_jax_state(init, jp.dtype)), pack_psi(jp, jcfg, None)), xs, None)
    want, psi_w = restore(st), unpack_psi(jp, jcfg, pp)
    yee.reset_launches()
    got, psi, _ = _port(jp, 5, mats, False, init, 12, "twopass")
    assert yee.launches == dict.fromkeys(yee.launches, 0)  # CPU tensors: the plain versions
    assert _engaged(psi_w) == _engaged(psi) == 12
    if dtype == "float32":
        for c in COMPONENTS:
            _close(getattr(got, c), getattr(want, c), dtype, c)
        for name in PSI:
            _close(getattr(psi, name), getattr(psi_w, name), dtype, f"psi/{name}")
        return
    ref, ref_psi, _ = _port(dataclasses.replace(jp, dtype="float32"), 5, mats, False, init, 12, "twopass")
    pairs = [(getattr(got, c), getattr(want, c), getattr(ref, c), c) for c in COMPONENTS]
    pairs += [(getattr(psi, n), getattr(psi_w, n), getattr(ref_psi, n), f"psi/{n}") for n in PSI]
    for g, w, r, tag in pairs:
        r = _np(r)
        scale = max(float(np.abs(r).max()), 1e-30)
        port_err = float(np.abs(_np(g) - r).max())
        tpu_err = float(np.abs(_np(w) - r).max())
        assert port_err <= tpu_err + scale / 64, (tag, port_err, tpu_err, scale)


@pytest.mark.parametrize("s", [4, 2])
@pytest.mark.parametrize("lossy", [False, True])
def test_plain_stream_pml_matches_interpret_stream_pml(s, lossy):
    """K11's plain version (the port's sweep, built at s = 2: four sweeps)
    against ``_kernel_pml`` at ``s`` steps a sweep, 8 steps (fp32), from
    seeded random fields: all twelve terms engage."""
    from fdtd_tpu.ops.pallas_stream_pml import make_stream_pml_chunk_runner, pack_psi_stream, \
        unpack_psi_stream

    jp = _box(24, 8, Mode.COMPUTATION, "float32")
    mats = jstate.water_block(jp, lo=(0.35,) * 3, hi=(0.65,) * 3) if lossy else None
    jcfg = jcpml.PMLConfig(cells=5)
    init = _updated_fields(jp, 52 + s)
    prep, restore = backend_adapters(jp, "pallas_fused", mats)
    run_s = make_stream_pml_chunk_runner(jp, jcfg, mats, interpret=True, s=s)
    carry, _ = run_s((prep(_jax_state(init, jp.dtype)), pack_psi_stream(jp, jcfg, None)),
                     j_scan_inputs(jp, time_values(jp)[:8]), None)
    want, psi_w = restore(carry[0]), unpack_psi_stream(jp, jcfg, carry[1])
    stream.reset_launches()
    yee.reset_launches()
    got, psi, _ = _port(jp, 5, mats, False, init, 8, "stream")
    assert stream.launches == dict.fromkeys(stream.launches, 0)  # CPU tensors: the plain versions
    assert yee.launches == dict.fromkeys(yee.launches, 0)
    assert _engaged(psi_w) == _engaged(psi) == 12
    for c in COMPONENTS:
        _close(getattr(got, c), getattr(want, c), "float32", c)
    for name in PSI:
        _close(getattr(psi, name), getattr(psi_w, name), "float32", f"psi/{name}")


def test_plain_stream_pml_matches_interpret_stream_pml_bf16():
    """bf16: both keep the sweep in fp32 and round once a sweep (s = 2, 8
    steps, from seeded random fields)."""
    from fdtd_tpu.ops.pallas_stream_pml import make_stream_pml_chunk_runner, pack_psi_stream, \
        unpack_psi_stream

    jp = _box(24, 8, Mode.COMPUTATION, "bfloat16")
    jcfg = jcpml.PMLConfig(cells=5)
    prep, restore = backend_adapters(jp, "pallas_fused", None)
    init = _updated_fields(jp, 57)
    run_s = make_stream_pml_chunk_runner(jp, jcfg, None, interpret=True, s=2)
    carry, _ = run_s((prep(_jax_state(init, jp.dtype)), pack_psi_stream(jp, jcfg, None)),
                     j_scan_inputs(jp, time_values(jp)[:8]), None)
    want, psi_w = restore(carry[0]), unpack_psi_stream(jp, jcfg, carry[1])
    got, psi, _ = _port(jp, 5, None, False, init, 8, "stream")
    assert _engaged(psi_w) == _engaged(psi) == 12
    for c in COMPONENTS:
        _close(getattr(got, c), getattr(want, c), "bfloat16", c)
    for name in PSI:
        _close(getattr(psi, name), getattr(psi_w, name), "bfloat16", f"psi/{name}")


# --- port-internal, bit for bit in fp32 ---------------------------------------


def _drive(p, st, s, seed):
    src = make_source_plan(p)
    amps = torch.tensor(np.random.default_rng(seed).uniform(-1, 1, s), dtype=torch.float64)
    prof = profile_tensor(src, "cpu")
    apply_source(src, st, amps[0], prof)
    ez, hx = sweep_drive_rows(src, amps, s, st.ex.dtype, prof)
    return amps, stream.SweepDrive(src.patch, ez[0], hx[0])


def _random_psi(p, cfg, seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = cpml.psi_shapes(p, cfg)
    return cpml.PsiState(**{n: torch.tensor(rng.uniform(-1e-2, 1e-2, shapes[n]), dtype=dtype) for n in PSI})


@pytest.mark.parametrize("s", [8, 4, 2])
@pytest.mark.parametrize("lossy", [False, True])
def test_plain_pml_sweep_is_torch_steps(s, lossy):
    """fp32: a CPML sweep of the plain version is s ``torch`` CPML steps
    (the xla order, with its second source application), fields and psi
    bit for bit, at every depth (the kernel is built at s = 2, whose plan
    goes through the wrapper)."""
    jp = _box(24, 8, Mode.COMPUTATION, "float32")
    tp = convert.params_from(jp)
    cfg = cpml.PMLConfig(cells=5)
    mats = tstate.water_block(tp, lo=(0.1,) * 3, hi=(0.9,) * 3) if lossy else None
    coefs = tstate.update_coefs(tp, mats, "cpu")
    a = convert.state_from_numpy(_random_fields(jp, 3), "cpu", torch.float32)
    b = a.clone()
    pa = _random_psi(tp, cfg, 4, torch.float32)
    pb = pa.clone()
    amps, drive = _drive(tp, a, s, 5)
    cp = cpml.make_cpml(tp, cfg, coefs, "cpu")
    out = tstate.FieldState(*(torch.full_like(t, float("nan")) for t in a.tensors()))
    pout = cpml.PsiState(*(torch.full_like(t, float("nan")) for t in pa.tensors()))
    if s in stream_plan.BLOCK_J_PML:
        stream.sweep(tp, a, out, coefs, stream_plan.plan_for(tp, s, lossy, pml=cfg), drive, None, cp, pa, pout)
    else:
        stream.plain_sweep(tp, a, coefs, s, drive, out, None, cp, pa, pout)
    step = tstep.make_step(tp, "cpu", backend="torch", coefs=coefs, pml=cfg)
    for m in range(s):
        step(b, (0.0, float(amps[m])), pb)
    for c in COMPONENTS:
        assert torch.equal(getattr(out, c), getattr(b, c)), c
    for n in PSI:
        assert torch.equal(getattr(pout, n), getattr(pb, n)), n
        assert not torch.equal(getattr(pout, n), getattr(pa, n)), n  # the input set is left alone


@pytest.mark.parametrize("lossy", [False, True])
def test_stream_pml_chunk_runner_with_odd_tail_equals_torch_and_twopass(lossy):
    """fp32, 9 * 2 + 1 steps then a chunk shorter than s: stream (sweeps and
    trailing two-pass CPML steps on the same psi) = twopass = torch."""
    jp = _box(24, 20, Mode.COMPUTATION, "float32")
    mats = jstate.water_block(jp, lo=(0.05,) * 3, hi=(0.95,) * 3) if lossy else None
    init = {c: np.zeros(jp.padded_shape) for c in COMPONENTS}
    got = {}
    for backend in ("torch", "twopass", "stream"):
        tp = convert.params_from(jp)
        st = convert.state_from_numpy(init, "cpu", torch.float32)
        psi = cpml.init_psi(tp, cpml.PMLConfig(cells=5), "cpu")
        tm = convert.materials_from(mats) if mats is not None else None
        run = tstep.make_chunk_runner(tp, "cpu", tm, backend, pml=cpml.PMLConfig(cells=5))
        assert backend != "stream" or run.plan.s == 2
        tv = time_values(jp)
        run(st, tstep.scan_inputs(tp, tv[:19]), None, psi)
        run(st, tstep.scan_inputs(tp, tv[19:20]), None, psi)
        got[backend] = (st, psi)
    assert float(got["torch"][0].ez.abs().max()) > 0 and float(got["torch"][1].hx_z.abs().max()) > 0
    for backend in ("twopass", "stream"):
        for c in COMPONENTS:
            assert torch.equal(getattr(got[backend][0], c), getattr(got["torch"][0], c)), (backend, c)
        for n in PSI:
            assert torch.equal(getattr(got[backend][1], n), getattr(got["torch"][1], n)), (backend, n)


def test_source_patch_rule_in_the_slabs():
    """The kernels' H pass skips the Hx/Hz adds on the k=0 source patch
    while their recursions run; the xla order adds and then overwrites
    them with its second source application.  On a 12^3 box with 4-cell
    slabs the patch lies in the k-lo slab and in the j and i slabs: the
    plain two-pass CPML step equals the torch step bit for bit, psi of
    hx_z and hz_x on the patch is non-zero, and Hx there is the source
    row."""
    jp = _box(12, 6, Mode.COMPUTATION, "float32")
    tp = convert.params_from(jp)
    cfg = cpml.PMLConfig(cells=4)
    src = make_source_plan(tp)
    assert src.j0 < cfg.cells and src.i0 < cfg.cells  # the patch reaches into the j and i slabs
    assert not stream_plan.pml_gates(tp, cfg)  # so the CPML sweep refuses the scene
    init = _random_fields(jp, 11)
    a = convert.state_from_numpy(init, "cpu", torch.float32)
    b = a.clone()
    pa = cpml.init_psi(tp, cfg, "cpu")
    pb = pa.clone()
    coefs = tstate.update_coefs(tp)
    kstep = tstep.make_step(tp, "cpu", backend="twopass", coefs=coefs, pml=cfg)
    tstep_ = tstep.make_step(tp, "cpu", backend="torch", coefs=coefs, pml=cfg)
    amps = np.random.default_rng(12).uniform(-1, 1, 6)
    for m in range(6):
        kstep(a, (0.0, float(amps[m])), pa)
        tstep_(b, (0.0, float(amps[m])), pb)
    for c in COMPONENTS:
        assert torch.equal(getattr(a, c), getattr(b, c)), c
    for n in PSI:
        assert torch.equal(getattr(pa, n), getattr(pb, n)), n
    j0, j1, i0, i1 = src.patch
    # hx_z rows 0..n-1 are k = 0..n-1: row 0 is the patch plane
    assert float(pa.hx_z[0, j0:j1, i0:i1].abs().max()) > 0
    assert float(pa.hz_x[0, j0:j1, i0:cfg.cells].abs().max()) > 0
    row = -src.inv_z_te * float(amps[-1]) * np.asarray(src.profile)
    np.testing.assert_array_equal(a.hx[0, j0, i0:i1].numpy(), row.astype(np.float32))


# --- physics through the port (tests/test_pml.py) ------------------------------


def _gaussian_ey(p, radius, cutoff):
    K1, J1, I1 = p.padded_shape
    k, j, i = np.ogrid[:K1, :J1, :I1]
    r2 = (k - p.maxk / 2) ** 2 + (j - p.maxj / 2) ** 2 + (i - p.maxi / 2) ** 2
    blob = np.where(r2 < cutoff**2, np.exp(-r2 / (2 * radius**2)), 0.0)
    blob[:, p.maxj:, :] = 0.0
    return {c: (blob if c == "ey" else np.zeros(p.padded_shape)) for c in COMPONENTS}


def _solenoidal(p, radius=3.0):
    """E = discrete curl of A_z g: divergence-free, all radiative
    (tests/test_pml.py::_solenoidal_pulse)."""
    K1, J1, I1 = p.padded_shape
    k, j, i = np.ogrid[:K1, :J1, :I1]
    r2 = (k - p.maxk / 2) ** 2 + (j - p.maxj / 2) ** 2 + (i - p.maxi / 2) ** 2
    g = np.broadcast_to(np.exp(-r2 / (2 * radius**2)), (K1, J1, I1))
    ex, ey = np.zeros((K1, J1, I1)), np.zeros((K1, J1, I1))
    ex[:, 1:, :] = g[:, 1:, :] - g[:, :-1, :]
    ey[:, :, 1:] = -(g[:, :, 1:] - g[:, :, :-1])
    ey[:, p.maxj:, :] = 0.0
    return {"ex": ex, "ey": ey, **{c: np.zeros((K1, J1, I1)) for c in ("ez", "hx", "hy", "hz")}}


def _energy(p, s):
    return float(diagnostics.e_energy(p, s)) + float(diagnostics.h_energy(p, s))


def test_pml_inert_until_wave_arrives():
    """A pulse that stays clear of the slabs: psi stays zero and the CPML
    run equals the closed-cavity run bit for bit (fp64)."""
    jp = _box(40, 6, Mode.VALIDATION)
    tp = convert.params_from(jp)
    init = _gaussian_ey(jp, 1.5, 5.0)
    xs = tstep.scan_inputs(tp, time_values(tp)[:6])
    ref = convert.state_from_numpy(init, "cpu", torch.float64)
    tstep.make_chunk_runner(tp, "cpu")(ref, xs)
    got, psi, _ = _port(jp, 8, None, False, init, 6)
    for c in COMPONENTS:
        assert torch.equal(getattr(got, c), getattr(ref, c)), c
    assert all(float(getattr(psi, n).abs().max()) == 0.0 for n in PSI)


@pytest.mark.parametrize("backend", ["torch", "twopass"])
def test_pml_absorbs_outgoing_pulse(backend):
    """32^3, 8-cell slabs, 400 steps fp32: the PEC cavity keeps the pulse,
    CPML walls absorb it (tests/test_pml.py's thresholds)."""
    n, steps = 32, 400
    jp = _box(n, steps, Mode.VALIDATION, "float32")
    tp = convert.params_from(jp)
    init = _solenoidal(jp)
    s0 = convert.state_from_numpy(init, "cpu", torch.float32)
    e0 = _energy(tp, s0)
    pec = s0.clone()
    tstep.make_chunk_runner(tp, "cpu", backend=backend)(pec, tstep.scan_inputs(tp, time_values(tp)[:steps]))
    got, _, _ = _port(jp, 8, None, False, init, steps, backend)
    e_pec, e_pml = _energy(tp, pec), _energy(tp, got)
    assert e_pec > 0.2 * e0
    assert e_pml < 1e-3 * e_pec and e_pml < 1e-3 * e0, (e_pml, e_pec, e0)


def test_gaussian_burst_rings_down_through_pml():
    """A pulsed port drive + CPML: the energy decays far below its
    mid-burst level (tests/test_pml.py::test_gaussian_burst_rings_down_
    through_pml, 16^3, 4 cells, 1200 steps, fp32)."""
    jp = _box(16, 1200, Mode.COMPUTATION, "float32")
    tp = convert.params_from(jp)
    tp = dataclasses.replace(tp, source=dataclasses.replace(tp.source, envelope="gaussian", pulse_width=8e-11))
    cfg = cpml.PMLConfig(cells=4)
    st, psi = tstate.zeros(tp, "cpu"), cpml.init_psi(tp, cfg, "cpu")
    run = tstep.make_chunk_runner(tp, "cpu", pml=cfg)
    tv = time_values(tp)
    run(st, tstep.scan_inputs(tp, tv[:300]), None, psi)
    e_mid = _energy(tp, st)
    run(st, tstep.scan_inputs(tp, tv[300:1200]), None, psi)
    e_end = _energy(tp, st)
    assert e_mid > 0 and e_end < 2e-2 * e_mid, (e_end, e_mid)


# --- diagnostics and outputs ---------------------------------------------------


@pytest.mark.parametrize("margin", [0, 3, 6])
def test_poynting_flux_matches_jax(margin):
    jp = dataclasses.replace(_box(16, 4), length=0.0145, width=0.0175)  # (16, 17, 14)
    init = _random_fields(jp, 21)
    want = float(jdiag.poynting_flux(jp, _jax_state(init, "float64"), margin=margin))
    tp = convert.params_from(jp)
    got = float(diagnostics.poynting_flux(tp, convert.state_from_numpy(init, "cpu", torch.float64),
                                          margin=margin))
    assert want != 0 and got == pytest.approx(want, rel=1e-12)
    with pytest.raises(ValueError, match="margin"):
        diagnostics.poynting_flux(tp, convert.state_from_numpy(init, "cpu", torch.float64), margin=7)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_output_slabs_equal_the_whole_grid(monkeypatch, dtype, mode):
    """Snapshot aggregation (and the validation extras) a k slab at a time
    equal one whole-grid aggregation bit for bit; the energies summed per
    slab stay within rtol 1e-12 in fp64 (only the summation order
    changes), 1e-5 otherwise."""
    jp = dataclasses.replace(_box(15, 4, mode, dtype), length=0.0125, width=0.0135)  # (15, 13, 12)
    tp = convert.params_from(jp)
    st = convert.state_from_numpy(_random_fields(jp, 31), "cpu", tstate.field_dtype(tp))
    assert len(diagnostics.output_slabs(tp)) == 1
    whole = snapshots.aggregate_all(tp, st)
    extras = snapshots.validation_extras(tp, st, 3.2e-12)
    extras_pc = snapshots.validation_extras(tp, st, 3.2e-12, quirk_compat=False)
    energies = (float(diagnostics.e_energy(tp, st)), float(diagnostics.h_energy(tp, st)))
    monkeypatch.setattr(diagnostics, "OUTPUT_SLAB_CELLS", 4 * tp.maxj * tp.maxi + 7)
    assert diagnostics.output_slabs(tp) == [(0, 4), (4, 8), (8, 12), (12, 15)]  # a ragged last slab
    for got, want in ((snapshots.aggregate_all(tp, st), whole),
                      (snapshots.validation_extras(tp, st, 3.2e-12), extras),
                      (snapshots.validation_extras(tp, st, 3.2e-12, quirk_compat=False), extras_pc)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == (tp.maxk, tp.maxj, tp.maxi) and got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the whole grid as before the slabs: one aggregation, one error field
    ref = grid.aggregate_e(tp, st.ey, "ey")
    np.testing.assert_array_equal(whole["ey"], tckpt.to_host(ref))
    rtol = 1e-12 if dtype == "float64" else 1e-5
    assert float(diagnostics.e_energy(tp, st)) == pytest.approx(energies[0], rel=rtol)
    assert float(diagnostics.h_energy(tp, st)) == pytest.approx(energies[1], rel=rtol)


def test_memory_model_counts_psi_and_output_temporaries():
    p = convert.params_from(_box(256, 4, dtype="float32"))
    cfg = cpml.PMLConfig(cells=10)
    psi = cpml.psi_bytes(p, cfg)
    assert 6.0e7 < psi < 6.5e7  # twelve slab arrays: about 63 MB at 256^3 fp32
    base = stream_plan.twopass_bytes(p)
    assert base == stream_plan.state_bytes(p) + stream_plan.output_work_bytes(p)
    assert stream_plan.twopass_bytes(p, pml=cfg) == base + psi
    assert stream_plan.output_work_bytes(p) == 8 * 4 * 256**3  # one slab of 256 planes
    need = 2 * stream_plan.state_bytes(p) + stream_plan.output_work_bytes(p) + 2 * psi
    assert stream_plan.feasible(p, memory_bytes=need / stream_plan.MEMORY_MARGIN + 1, pml=cfg)
    assert not stream_plan.feasible(p, memory_bytes=need / stream_plan.MEMORY_MARGIN - 1e6, pml=cfg)


# --- backend choice -----------------------------------------------------------


@pytest.mark.parametrize(
    "device, dtype, mode, scene, backend, want",
    [
        ("cuda", "float32", Mode.COMPUTATION, None, "stream", "stream"),
        ("cuda", "bfloat16", Mode.COMPUTATION, "water", "stream", "stream"),
        ("cuda", "float32", Mode.COMPUTATION, None, "auto", "stream"),
        ("cuda", "bfloat16", Mode.COMPUTATION, "water", "auto", "stream"),
        ("cuda", "float32", Mode.COMPUTATION, "water+sar", "auto", "twopass"),
        ("cuda", "float32", Mode.COMPUTATION, "ferrite", "auto", "twopass"),
        ("cuda", "float32", Mode.VALIDATION, None, "auto", "twopass"),
        ("cuda", "float32", Mode.COMPUTATION, "small", "auto", "twopass"),
        ("cuda", "float32", Mode.VALIDATION, None, "stream", ValueError),
        ("cuda", "float32", Mode.COMPUTATION, "ferrite", "stream", ValueError),
        ("cpu", "float32", Mode.COMPUTATION, None, "auto", "torch"),
        ("cuda", "float64", Mode.COMPUTATION, None, "auto", "torch"),
    ],
)
def test_resolve_backend_pml_gates(device, dtype, mode, scene, backend, want):
    """The CPML sweep takes the TPU's streaming-PML gates (computation
    mode, uniform mu_r, no SAR, the source patch clear of the j/i slabs),
    and ``auto`` picks it for the scenes that pass them, in fp32 and bf16
    (on an H100 it beats twopass in both: PERF.md); the others run
    on twopass."""
    jp = _box(64, 4, mode, dtype)
    cfg = cpml.PMLConfig(cells=10)
    if scene == "small":  # 24^3 with 10-cell slabs: the 5 mm patch reaches into the j/i slabs
        jp = _box(24, 4, mode, dtype)
    tp = convert.params_from(jp)
    mats = {None: None, "small": None, "water": tstate.water_block(tp), "water+sar": tstate.water_block(tp),
            "ferrite": tstate.ferrite_slab(tp, base=tstate.water_block(tp))}[scene]
    sar = scene == "water+sar"
    if want is ValueError:
        with pytest.raises(ValueError, match="CPML sweep"):
            runner.resolve_backend(tp, backend, device, mats, sar, cfg)
    else:
        assert runner.resolve_backend(tp, backend, device, mats, sar, cfg) == want


def test_resolve_backend_pml_memory(monkeypatch):
    """With CPML, stream counts two psi sets and twopass one: a card that
    fits twopass's footprint and not stream's runs twopass and refuses
    stream."""
    tp = convert.params_from(_box(256, 4, dtype="float32"))
    cfg = cpml.PMLConfig(cells=10)
    need_tp = stream_plan.twopass_bytes(tp, pml=cfg)
    monkeypatch.setattr(stream_plan, "DEVICE_BYTES", int(need_tp / stream_plan.MEMORY_MARGIN) + 10**6)
    assert runner.resolve_backend(tp, "auto", "cuda", None, False, cfg) == "twopass"
    with pytest.raises(ValueError, match="no stream plan fits"):
        runner.resolve_backend(tp, "stream", "cuda", None, False, cfg)
    monkeypatch.setattr(stream_plan, "DEVICE_BYTES", int(need_tp / stream_plan.MEMORY_MARGIN) - 10**6)
    with pytest.raises(ValueError, match="does not fit"):
        runner.resolve_backend(tp, "twopass", "cuda", None, False, cfg)


def test_pml_plans():
    tp = convert.params_from(_box(256, 4, dtype="float32"))
    cfg = cpml.PMLConfig(cells=10)
    plan = stream_plan.pick_plan(tp, pml=cfg)
    assert plan.kernel == "yee_stream_pml" and plan.s == 2 and tuple(stream_plan.BLOCK_J_PML) == (2,)
    assert plan.bj == stream_plan.BLOCK_J_PML[plan.s] and plan.blocks >= stream_plan.SM_COUNT
    assert stream_plan.pick_plan(tp, s=2, pml=cfg) == plan  # a forced depth that is built is taken
    for s in (8, 4):  # the CPML sweep is not built there
        with pytest.raises(ValueError, match="steps per sweep"):
            stream_plan.pick_plan(tp, s=s, pml=cfg)
    lossy = stream_plan.pick_plan(tp, lossy=True, pml=cfg)
    assert lossy.kernel == "yee_stream_lossy_pml" and lossy.lossy
    assert stream_plan.pick_plan(tp, lossy=True, sar=True, pml=cfg) is None
    assert stream_plan.pick_plan(tp, het=True, pml=cfg) is None
    assert stream_plan.variant_name(False, False, False, True) == "yee_stream_pml"


# --- the CPML sweep's two launches (stream_plan.pml_blocks) -------------------


def _psi_mask(jp, cells):
    """Brute force: every cell that holds psi of some term, from the JAX
    package's slab slices of each term (``fdtd_tpu.ops.cpml.build_plan``)."""
    mask = np.zeros(jp.padded_shape, dtype=bool)
    for lo_sl, hi_sl, *_ in jcpml.build_plan(jp, jcpml.PMLConfig(cells=cells), jnp.float32).values():
        mask[lo_sl] = True
        mask[hi_sl] = True
    return mask


def _windows(plan):
    """The emitted windows of a CPML plan's launches: (k0, k1, j0, j1, i0,
    i1, runs K3's arithmetic) of pml_kernel's blocks and of the interior."""
    out = [b[:6] + (False,) for b in plan.pml_blocks]
    if plan.core is not None:
        out.append(tuple(x for lo, w in zip(plan.core.origin, plan.core.window) for x in (lo, lo + w)) + (True,))
    return out


@pytest.mark.parametrize("dft", [False, True])
@pytest.mark.parametrize("shape", ["ragged", "wide", "256"])
def test_pml_blocks_keep_psi_on_pml_kernel_and_tile_the_grid(shape, dft):
    """The interior window (the launch that runs K3's arithmetic) has, for
    every block, a recompute region -- the window with s cells more below
    and s (+1 with the DFT cell means) above along each axis -- that holds
    no psi cell of any term (a brute-force scan of the terms' slabs); the
    emitted windows of both launches tile the padded grid exactly once; a
    pml_kernel block emits at most a tile.  Ragged: 61 x 50 x 70 with
    6-cell walls; wide: the same box with 14-cell walls, whose slabs take
    more than one tile; 256^3 with 10-cell walls."""
    jp = (_box(256, 4, dtype="float32") if shape == "256" else
          Params(length=0.0615, width=0.0505, height=0.0705, spatial_step=0.001, time_step=1e-12,
                 simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype="float32"))
    tp = convert.params_from(jp)
    cells = {"256": 10, "ragged": 6, "wide": 14}[shape]
    cfg = cpml.PMLConfig(cells=cells)
    mask = _psi_mask(jp, cells)
    free = stream_plan.psi_free(tp, cfg)
    covered = np.zeros(jp.padded_shape, dtype=np.int8)
    from fdtd_tpu_torch.dft import DftConfig
    plan = stream_plan.plan_for(tp, 2, pml=cfg, dft=DftConfig((1e9,)) if dft else None)
    s, sh = plan.s, int(dft)
    assert plan.core is not None and plan.blocks == len(plan.pml_blocks)
    k3 = 0
    for k0, k1, j0, j1, i0, i1, plain in _windows(plan):
        assert 0 < j1 - j0 <= plan.tj and 0 < i1 - i0 <= plan.ti or plain and (k0, j0, i0) == plan.core.origin
        covered[k0:k1, j0:j1, i0:i1] += 1
        if plain:
            region = tuple(slice(max(lo - s, 0), hi + s + sh) for lo, hi in ((k0, k1), (j0, j1), (i0, i1)))
            assert not mask[region].any(), (k0, k1, j0, j1, i0, i1)
            assert all(a <= lo - s and hi + s + sh <= b for (lo, hi), (a, b) in zip(((k0, k1), (j0, j1), (i0, i1)),
                                                                                     free))
            k3 += (k1 - k0) * (j1 - j0) * (i1 - i0)
    assert (covered == 1).all()
    # the free planes bound the largest box clear of psi: one plane more on any side holds some
    inner = tuple(slice(a, b) for a, b in free)
    assert not mask[inner].any()
    for axis, (a, b) in enumerate(free):
        for grown in ((a - 1, b), (a, b + 1)):
            assert mask[inner[:axis] + (slice(*grown),) + inner[axis + 1:]].any()
    if shape == "256":  # most cells run K3's arithmetic: 59% in the interior
        assert k3 / mask.size > 0.55


def test_psi_free_planes_are_the_slab_bounds():
    """The planes clear of every term's slabs along each axis are (n + 1,
    K - n), (n + 1, J - n), (n + 1, I - n): the E terms' regions start one
    cell in, so their lo slabs reach one plane further than the H terms'."""
    tp = convert.params_from(Params(length=0.0615, width=0.0505, height=0.0705, spatial_step=0.001, time_step=1e-12,
                                    simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype="float32"))
    for n in (1, 6, 10):
        assert stream_plan.psi_free(tp, cpml.PMLConfig(cells=n)) == (
            (n + 1, tp.maxk - n), (n + 1, tp.maxj - n), (n + 1, tp.maxi - n))


def test_tune_stream_plans_the_cpml_candidates():
    """The tuner's CPML scenes: every candidate shape (the built one among
    them) has a plan that fits a block's shared memory with the DFT sums of
    five frequencies where it has bands; its ptxas reader keeps
    pml_kernel's entries beside ring_kernel's."""
    from fdtd_tpu_torch import tune_stream

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_110pml_kernelIfLi2ELi24ELb1ELb1ELb0EEEvNS_6Fields"
        "IT_EE' for 'sm_90a'",
        "    0 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers",
    ])
    assert tune_stream.ptxas_report(log) == {("pml", "float32", 2, 24, True, True, False): (80, 12)}
    p = convert.params_from(_box(256, 4, dtype="float32"))
    for name in ("pml", "lossy_pml", "pml_dft", "lossy_pml_dft"):
        lossy, dft = name.startswith("lossy"), name.endswith("dft")
        built = tune_stream.built_shapes(name, p)
        assert len(built) == 1 and set(built) < set(tune_stream.shapes(name, p, False))
        for s, bj, cr in tune_stream.shapes(name, p, False):
            plan = stream_plan.plan_for(p, s, lossy, pml=tune_stream.PML_TIMED, bj=bj, cr=cr,
                                        dft=tune_stream.DftConfig((1e9,)) if dft else None)
            assert (plan.s, plan.bj, plan.cr) == (s, bj, cr) and plan.core is not None
            assert plan.kernel == stream_plan.variant_name(lossy, False, False, True, dft=dft)
            assert plan.smem_bytes + plan.dft_smem_bytes(5) <= stream_plan.SMEM_PER_BLOCK


def _plain_split_sweep(p, state, coefs, plan, drive=None, out=None, cp=None, psi=None, psi_out=None, dacc=None,
                      wts=None):
    """The plain version of a CPML sweep as its launches divide the grid
    (``plan``: a CPML plan): ``plain_sweep`` with ``cp`` for pml_kernel's
    blocks, then the K3 steps without psi on the interior launch's window
    (``plain_sweep`` on a box of the whole grid's arrays that owns it)."""
    before = tuple(t.clone() for t in dacc) if dacc is not None else None
    out = stream.plain_sweep(p, state, coefs, plan.s, drive, out, None, cp, psi, psi_out, dacc=dacc, wts=wts)
    core = plan.core
    box = grid.Box((0, 0, 0), p.padded_shape, core.origin, tuple(o + w for o, w in zip(core.origin, core.window)))
    sub = sl = None
    if dacc is not None:
        sl = (slice(None), slice(None)) + tuple(slice(a, b) for a, b in zip(*box.cells(p)))
        sub = tuple(t[sl].contiguous() for t in before)
    stream.plain_sweep(p, state, coefs, plan.s, drive, out, dacc=sub, wts=wts, box=box)
    if dacc is not None:
        for t, u in zip(dacc, sub):
            t[sl] = u
    return out


@pytest.mark.parametrize("cells", [4, 9])
@pytest.mark.parametrize("lossy, dft", [(False, False), (True, False), (False, True), (True, True)])
def test_split_plain_sweep_is_plain_sweep(lossy, dft, cells):
    """fp32: the plain version of the CPML sweep as its launches divide the
    grid (``_plain_split_sweep``: K3's arithmetic on the interior)
    equals ``plain_sweep`` bit for bit -- fields, all twelve psi from
    random psi, and the DFT sums from random sums -- on a 64 x 60 x 70 box
    with 4- and 9-cell walls."""
    from fdtd_tpu_torch.dft import DftConfig
    jp = Params(length=0.07, width=0.06, height=0.064, spatial_step=0.001, time_step=1e-12,
                simulation_time=1e-11, sampling_rate=5, mode=Mode.COMPUTATION, dtype="float32")
    tp = convert.params_from(jp)
    cfg = cpml.PMLConfig(cells=cells)
    mats = tstate.water_block(tp, lo=(0.02,) * 3, hi=(0.98,) * 3) if lossy else None
    coefs = tstate.update_coefs(tp, mats, "cpu")
    st = convert.state_from_numpy(_random_fields(jp, 11), "cpu", torch.float32)
    psi = _random_psi(tp, cfg, 12, torch.float32)
    _, drive = _drive(tp, st, 2, 13)
    cp = cpml.make_cpml(tp, cfg, coefs, "cpu")
    plan = stream_plan.plan_for(tp, 2, lossy, pml=cfg, dft=DftConfig((1e9, 2e9)) if dft else None)
    assert plan.core is not None
    rng = np.random.default_rng(14)
    sums = tuple(torch.tensor(rng.uniform(-1, 1, (2, 3, tp.maxk, tp.maxj, tp.maxi)), dtype=torch.float32)
                 for _ in range(2)) if dft else None
    wts = torch.tensor(rng.uniform(-1, 1, (2, 2, 2)), dtype=torch.float32) if dft else None
    got = []
    for fn in (stream.plain_sweep, _plain_split_sweep):
        out = tstate.FieldState(*(torch.full_like(t, float("nan")) for t in st.tensors()))
        pout = cpml.PsiState(*(torch.full_like(t, float("nan")) for t in psi.tensors()))
        dacc = tuple(t.clone() for t in sums) if dft else None
        if fn is stream.plain_sweep:
            fn(tp, st, coefs, 2, drive, out, None, cp, psi, pout, dacc=dacc, wts=wts)
        else:
            fn(tp, st, coefs, plan, drive, out, cp, psi, pout, dacc, wts)
        got.append((out.tensors(), pout.tensors(), dacc or ()))
    for a, b in zip(*got):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert _engaged(cpml.PsiState(*got[1][1])) == 12


@pytest.mark.parametrize("lossy", [False, True])
def test_split_sweep_matches_interpret_stream_pml(lossy, monkeypatch):
    """The port's CPML sweep as its launches divide the grid (the runner's
    sweeps through ``_plain_split_sweep``: K3's arithmetic on the
    interior) against ``_kernel_pml`` at s = 2, 8 steps, fp32, within 2^-20
    of each array's scale, all twelve terms engaged, from random fields in
    vacuum and with a water block in the middle (the TPU kernel takes slab-
    constant factors only)."""
    from fdtd_tpu.ops.pallas_stream_pml import make_stream_pml_chunk_runner, pack_psi_stream, \
        unpack_psi_stream

    jp = _box(24, 8, Mode.COMPUTATION, "float32")
    jcfg = jcpml.PMLConfig(cells=5)
    mats = jstate.water_block(jp, lo=(0.35,) * 3, hi=(0.65,) * 3) if lossy else None
    init = _updated_fields(jp, 61)
    prep, restore = backend_adapters(jp, "pallas_fused", mats)
    run_s = make_stream_pml_chunk_runner(jp, jcfg, mats, interpret=True, s=2)
    carry, _ = run_s((prep(_jax_state(init, jp.dtype)), pack_psi_stream(jp, jcfg, None)),
                     j_scan_inputs(jp, time_values(jp)[:8]), None)
    want, psi_w = restore(carry[0]), unpack_psi_stream(jp, jcfg, carry[1])
    assert stream_plan.pick_plan(convert.params_from(jp), lossy=lossy, pml=cpml.PMLConfig(cells=5)).core is not None
    split = []

    def sweep(p, state, out, coefs, plan, drive=None, acc=None, cp=None, psi=None, psi_out=None, dc=None, pol=None,
              pol_out=None, dacc=None, wts=None, box=None):
        assert acc is None and dc is None and box is None and plan.core is not None
        split.append(plan.kernel)
        return _plain_split_sweep(p, state, coefs, plan, drive, out, cp, psi, psi_out, dacc, wts)

    monkeypatch.setattr(stream, "sweep", sweep)
    got, psi, _ = _port(jp, 5, mats, False, init, 8, "stream")
    assert len(split) == 4
    assert _engaged(psi_w) == _engaged(psi) == 12
    for c in COMPONENTS:
        _close(getattr(got, c), getattr(want, c), "float32", c)
    for name in PSI:
        _close(getattr(psi, name), getattr(psi_w, name), "float32", f"psi/{name}")


# --- runner, checkpoints and CLI ---------------------------------------------


def test_run_simulation_pml_matches_jax(tmp_path):
    """run_simulation(pml=...) in fp64 against the JAX runner: fields,
    psi and the radiated_W log."""
    jp = dataclasses.replace(_box(16, 24, Mode.COMPUTATION), sampling_rate=8)
    jcfg = jcpml.PMLConfig(cells=4)
    want = j_run(jp, out_dir=str(tmp_path / "j"), backend="xla", pml=jcfg, write_snapshots=False,
                 diagnostics_log=str(tmp_path / "j.jsonl"), log=lambda m: None)
    got = runner.run_simulation(convert.params_from(jp), "cpu", out_dir=str(tmp_path / "t"),
                                pml=cpml.PMLConfig(cells=4), write_snapshots=False,
                                diagnostics_log=str(tmp_path / "t.jsonl"), log=lambda m: None)
    for c in COMPONENTS:
        np.testing.assert_allclose(getattr(got.state, c).numpy(), np.asarray(getattr(want.state, c)),
                                   rtol=1e-11, atol=1e-15, err_msg=c)
    assert got.psi is not None and float(got.psi.hx_z.abs().max()) > 0
    with open(tmp_path / "t.jsonl") as f, open(tmp_path / "j.jsonl") as g:
        t_rec, j_rec = [json.loads(x) for x in f], [json.loads(x) for x in g]
    assert [r["iteration"] for r in t_rec] == [r["iteration"] for r in j_rec] == [0, 8, 16, 24]
    for a, b in zip(t_rec, j_rec):
        assert a["radiated_W"] == pytest.approx(b["radiated_W"], rel=1e-9, abs=1e-30)
    assert any(r["radiated_W"] != 0 for r in t_rec)


def test_run_simulation_sar_with_pml_needs_materials(tmp_path):
    tp = convert.params_from(_box(16, 4))
    with pytest.raises(ValueError, match="--sar needs lossy materials"):
        runner.run_simulation(tp, "cpu", out_dir=str(tmp_path), pml=cpml.PMLConfig(cells=4),
                              accumulate_power=True, write_snapshots=False, log=lambda m: None)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pml_checkpoint_resumes_across_packages(tmp_path, writer):
    """A CPML checkpoint (psi as ``aux_psi_<term>``) written by either
    package resumes in the other and ends where an uninterrupted run ends
    (fp64, rtol 1e-11)."""
    jp = dataclasses.replace(_box(16, 24, Mode.COMPUTATION), sampling_rate=8)
    jcfg, tcfg = jcpml.PMLConfig(cells=4), cpml.PMLConfig(cells=4)
    tp = convert.params_from(jp)
    quiet = {"log": lambda m: None, "write_snapshots": False}
    ck = tmp_path / "ck"
    if writer == "jax":
        j_run(jp, out_dir=str(ck), backend="xla", pml=jcfg, checkpoint_every=8, **quiet)
    else:
        runner.run_simulation(tp, "cpu", out_dir=str(ck), pml=tcfg, checkpoint_every=8, **quiet)
    with np.load(ck / "ckpt000016.npz") as z:
        keys = set(z.files)
        assert {f"aux_psi_{n}" for n in PSI} <= keys
        assert z["aux_psi_hx_z"].shape == jcpml.psi_shapes(jp, jcfg)["hx_z"]
    for f in glob.glob(str(ck / "ckpt*.npz")):
        if int(os.path.basename(f)[4:-4]) > 16:
            os.remove(f)
    if writer == "jax":
        res = runner.run_simulation(tp, "cpu", out_dir=str(ck), pml=tcfg, resume=True, **quiet)
        got = {c: getattr(res.state, c).numpy() for c in COMPONENTS}
        full = runner.run_simulation(tp, "cpu", out_dir=str(tmp_path / "f"), pml=tcfg, **quiet)
        want = {c: getattr(full.state, c).numpy() for c in COMPONENTS}
        assert not res.warnings
    else:
        res = j_run(jp, out_dir=str(ck), backend="xla", pml=jcfg, resume=True, **quiet)
        got = {c: np.asarray(getattr(res.state, c)) for c in COMPONENTS}
        full = j_run(jp, out_dir=str(tmp_path / "f"), backend="xla", pml=jcfg, **quiet)
        want = {c: np.asarray(getattr(full.state, c)) for c in COMPONENTS}
    for c in COMPONENTS:
        np.testing.assert_allclose(got[c], want[c], rtol=1e-11, atol=1e-15, err_msg=c)


def test_pml_resume_is_bit_exact_and_warns_without_psi(tmp_path):
    jp = dataclasses.replace(_box(16, 24, Mode.COMPUTATION, "float32"), sampling_rate=8)
    tp = convert.params_from(jp)
    cfg = cpml.PMLConfig(cells=4)
    quiet = {"log": lambda m: None, "write_snapshots": False}
    full = runner.run_simulation(tp, "cpu", out_dir=str(tmp_path / "a"), pml=cfg, **quiet)
    runner.run_simulation(tp, "cpu", out_dir=str(tmp_path / "b"), pml=cfg, checkpoint_every=8, **quiet)
    os.remove(tmp_path / "b" / "ckpt000024.npz")
    os.remove(tmp_path / "b" / "ckpt000016.npz")
    res = runner.run_simulation(tp, "cpu", out_dir=str(tmp_path / "b"), pml=cfg, resume=True, **quiet)
    for c in COMPONENTS:
        assert torch.equal(getattr(res.state, c), getattr(full.state, c)), c
    for n in PSI:
        assert torch.equal(getattr(res.psi, n), getattr(full.psi, n)), n
    # a closed-cavity checkpoint: psi restarts from zero, with the warning
    runner.run_simulation(tp, "cpu", out_dir=str(tmp_path / "c"), checkpoint_every=8, **quiet)
    os.remove(tmp_path / "c" / "ckpt000024.npz")
    res = runner.run_simulation(tp, "cpu", out_dir=str(tmp_path / "c"), pml=cfg, resume=True, **quiet)
    assert any("CPML psi" in w for w in res.warnings)


def test_convert_psi_round_trip():
    jp = _box(16, 4, dtype="float32")
    jcfg = jcpml.PMLConfig(cells=4)
    rng = np.random.default_rng(41)
    arrays = {n: rng.normal(size=s).astype(np.float32) for n, s in jcpml.psi_shapes(jp, jcfg).items()}
    psi = convert.psi_from_numpy(arrays, "cpu", torch.float32)
    back = convert.psi_to_numpy(psi)
    for n in PSI:
        assert getattr(psi, n).dtype == torch.float32
        np.testing.assert_array_equal(back[n], arrays[n])
        back[n][...] = 0  # copies: the port's tensors are not views of the arrays
        assert float(getattr(psi, n).abs().max()) > 0
    jpsi = jcpml.PsiState(**{n: jnp.asarray(a, jnp.bfloat16) for n, a in arrays.items()})
    bf = convert.psi_from_numpy({n: np.asarray(getattr(jpsi, n)) for n in PSI}, "cpu", torch.bfloat16)
    np.testing.assert_array_equal(bf.ez_y.float().numpy(), np.asarray(jpsi.ez_y, np.float32))


def test_cli_pml_matches_jax_cli(tmp_path, capsys):
    """``--pml 4``: the same .vtr files as the JAX CLI, to atol 5e-7 (fp32
    fields of order 1 after 24 steps: a few ulp where XLA groups sums
    differently), and a radiated_W log within rtol 1e-4."""
    params = tmp_path / "p.txt"
    params.write_text("0.016\n0.016\n0.016\n0.001\n1e-12\n2.4e-11\n12\n1\n")
    assert jcli.main([str(params), "--pml", "4", "--backend", "xla", "--out", str(tmp_path / "j"),
                      "--diag-log", str(tmp_path / "j.jsonl")]) == 0
    assert cli.main([str(params), "--pml", "4", "--device", "cpu", "--out", str(tmp_path / "t"),
                     "--diag-log", str(tmp_path / "t.jsonl")]) == 0
    assert "Simulation complete!" in capsys.readouterr().out
    files = sorted(os.path.basename(f) for f in glob.glob(str(tmp_path / "j" / "*.vtr")))
    assert files == sorted(os.path.basename(f) for f in glob.glob(str(tmp_path / "t" / "*.vtr")))
    assert files == ["result0001.vtr", "result0012.vtr", "result0024.vtr"]
    for f in files:
        a, b = j_read_vtr(str(tmp_path / "t" / f)), j_read_vtr(str(tmp_path / "j" / f))
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], atol=5e-7, rtol=0, err_msg=f"{f}/{k}")
    with open(tmp_path / "t.jsonl") as f, open(tmp_path / "j.jsonl") as g:
        t_rec, j_rec = [json.loads(x) for x in f], [json.loads(x) for x in g]
    assert [r["iteration"] for r in t_rec] == [r["iteration"] for r in j_rec]
    for a, b in zip(t_rec, j_rec):
        assert a["radiated_W"] == pytest.approx(b["radiated_W"], rel=1e-4, abs=1e-12 * max(1.0, abs(b["total"])))
    assert t_rec[-1]["radiated_W"] != 0


def test_cli_pml_on_cuda_without_cuda_names_device_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA run is not an error where there is a card")
    params = tmp_path / "p.txt"
    params.write_text("0.016 0.016 0.016 0.001 1e-12 2.4e-11 12 1")
    assert cli.main([str(params), "--pml", "4", "--no-output", "--out", str(tmp_path / "r")]) == 1
    assert "--device cpu" in capsys.readouterr().err
