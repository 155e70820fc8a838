"""Parity of the port's host-side modules with the JAX package: the params
parser, the time loop, the source plan and drive, grid aggregation, the
TE101 closed forms and the energy diagnostics.

Parser, time values, source plan, drive amplitudes and closed forms are the
same fp64 host arithmetic and must be equal.  Aggregation runs the same
slice arithmetic (fp64, atol 1e-15 / rtol 1e-12).  Energies are reductions
in another order than XLA's (fp64, rtol 1e-12), and the oracle's loop sums
(rtol 1e-10).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import analytic as janalytic  # noqa: E402
from fdtd_tpu import diagnostics as jdiag  # noqa: E402
from fdtd_tpu import grid as jgrid  # noqa: E402
from fdtd_tpu import params as jparams  # noqa: E402
from fdtd_tpu import source as jsource  # noqa: E402
from fdtd_tpu.state import FieldState as JFieldState  # noqa: E402
from fdtd_tpu.state import init_validation, te101_initial_ey, update_coefs  # noqa: E402
from fdtd_tpu_torch import analytic, convert, diagnostics, grid, params, source  # noqa: E402
from fdtd_tpu_torch import state as tstate  # noqa: E402

from .oracle import OracleSim  # noqa: E402

COMPONENTS = ["ex", "ey", "ez", "hx", "hy", "hz"]
PARAM_TEXTS = [
    "0.05 0.05 0.05 0.001 0.0000000000006 0.00000000012 2 0",
    "0.256 0.256 0.256 0.001 0.000000000001 0.000000001 1000000 1",
    "0.0125\n0.012\n0.011\n0.001\n1e-12\n1e-11\n5\n1\n",
    "0.03 0.02 0.025 0.001 1e-12 3e-11 7 0 trailing tokens are ignored",
]


@pytest.mark.parametrize("text", PARAM_TEXTS)
def test_parse_params_and_time_values_match(text):
    jp = jparams.parse_params_text(text)
    tp = params.parse_params_text(text)
    for name in ("length", "width", "height", "spatial_step", "time_step", "simulation_time",
                 "sampling_rate", "maxi", "maxj", "maxk", "padded_shape", "cell_count"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert int(tp.mode) == int(jp.mode)
    assert tp.cfl_limit() == jp.cfl_limit() and tp.is_cfl_stable() == jp.is_cfl_stable()
    np.testing.assert_array_equal(params.time_values(tp), jparams.time_values(jp))
    assert params.num_steps(tp) == jparams.num_steps(jp)
    assert convert.params_from(jp) == tp


@pytest.mark.parametrize("text, err", [
    ("0.05 0.05 0.05 0.001", "needs 8 values"),
    ("0.05 0.05 0.05 0.001 1e-12 1e-11 2 g", "invalid literal"),
    ("0.05 0.05 0.05 0.001 1e-12 1e-11 2 10", "not a valid Mode"),  # %x: "10" is 16
])
def test_parse_errors_match(text, err):
    with pytest.raises(ValueError, match=err):
        jparams.parse_params_text(text)
    with pytest.raises(ValueError, match=err):
        params.parse_params_text(text)


@pytest.mark.parametrize("change, msg", [
    (dict(time_step=0.0), "positive"),
    (dict(time_step=1e-9), "lower than the simulation time"),
    (dict(length=0.0015), "too small"),
])
def test_validate_matches(default_params, change, msg):
    jp = dataclasses.replace(default_params, **change)
    tp = convert.params_from(jp)
    with pytest.raises(ValueError, match=msg):
        jp.validate()
    with pytest.raises(ValueError, match=msg):
        tp.validate()


def test_c_float_promotion_and_hex_mode():
    p = params.parse_params_text("0.1 0.1 0.1 0.001 1e-12 1e-11 3 1")
    assert p.length == float(np.float32(0.1)) and p.length != 0.1
    assert p.mode == params.Mode.COMPUTATION
    assert params.parse_params_text("0.1 0.1 0.1 0.001 1e-12 1e-11 3 0x0").mode == params.Mode.VALIDATION


@pytest.mark.parametrize("src", [
    {},
    {"frequency": 2.45e9, "aprime": 0.004, "bprime": 0.006},
    {"envelope": "gaussian"},
    {"envelope": "gaussian", "pulse_width": 3e-11, "pulse_delay": 5e-11},
])
def test_source_plan_and_drive_values_match(default_params, src):
    jp = dataclasses.replace(default_params, source=jparams.SourceConfig(**src))
    tp = convert.params_from(jp)
    jplan = jsource.make_source_plan(jp)
    tplan = source.make_source_plan(tp)
    for f in ("i0", "i1", "j0", "j1", "frequency", "inv_z_te", "profile", "envelope",
              "pulse_width", "pulse_delay"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    ts = jparams.time_values(jp)
    np.testing.assert_array_equal(source.drive_values(tplan, ts), jsource.drive_values(jplan, ts))


@pytest.mark.parametrize("src, err", [
    ({"envelope": "square"}, "unknown source envelope"),
    ({"pulse_width": 1e-11}, "need envelope='gaussian'"),
    ({"aprime": 0.2}, "exceeds the grid"),
])
def test_source_plan_errors_match(default_params, src, err):
    jp = dataclasses.replace(default_params, source=jparams.SourceConfig(**src))
    with pytest.raises(ValueError, match=err):
        jsource.make_source_plan(jp)
    with pytest.raises(ValueError, match=err):
        source.make_source_plan(convert.params_from(jp))


def test_apply_source_matches(default_params):
    jp = dataclasses.replace(default_params, mode=jparams.Mode.COMPUTATION)
    tp = convert.params_from(jp)
    rng = np.random.default_rng(3)
    arrays = {c: rng.normal(size=jp.padded_shape) for c in COMPONENTS}
    js = JFieldState(**{c: jnp.array(a) for c, a in arrays.items()})
    ts = convert.state_from_numpy(arrays, "cpu", torch.float64)
    jplan, tplan = jsource.make_source_plan(jp), source.make_source_plan(tp)
    amp = float(jsource.drive_values(jplan, [3.3e-12])[0])
    js = jsource.apply_source(jplan, js, np.float64(amp))
    source.apply_source(tplan, ts, amp, source.profile_tensor(tplan, "cpu"))
    got = convert.state_to_numpy(ts)
    for c in COMPONENTS:
        np.testing.assert_array_equal(got[c], np.asarray(getattr(js, c)), err_msg=c)


@pytest.mark.parametrize("name", COMPONENTS)
def test_aggregation_matches(default_params, name):
    p = default_params
    rng = np.random.default_rng(4)
    a = rng.normal(size=p.padded_shape)
    agg_j = jgrid.aggregate_e if name in jgrid.E_COMPONENTS else jgrid.aggregate_h
    agg_t = grid.aggregate_e if name in grid.E_COMPONENTS else grid.aggregate_h
    want = np.asarray(agg_j(p, a, name))
    got = agg_t(convert.params_from(p), torch.from_numpy(a), name).numpy()
    np.testing.assert_allclose(got, want, atol=1e-15, rtol=1e-12)
    assert grid.extents(convert.params_from(p)) == grid.Extents(**dataclasses.asdict(jgrid.extents(p)))
    for t, j in zip(grid.node_coords(convert.params_from(p)), jgrid.node_coords(p)):
        np.testing.assert_array_equal(t, j)


def test_initial_state_matches(default_params):
    tp = convert.params_from(default_params)
    np.testing.assert_array_equal(tstate.te101_initial_ey(tp), te101_initial_ey(default_params))
    ts = tstate.init_validation(tp, "cpu")
    js = init_validation(default_params)
    for c in COMPONENTS:
        np.testing.assert_array_equal(getattr(ts, c).numpy(), np.asarray(getattr(js, c)), err_msg=c)
    coefs, jcoefs = tstate.update_coefs(tp), update_coefs(default_params)
    for f in ("ca_x", "ca_y", "ca_z", "cb_x", "cb_y", "cb_z", "h_factor"):
        assert getattr(coefs, f) == getattr(jcoefs, f), f


def test_non_vacuum_materials_name_their_roadmap_item(default_params):
    """Materials are ported: a non-vacuum scene gives coefficient tensors
    equal to the JAX package's arrays (fp64, exact), and an empty
    ``Materials`` keeps the scalar vacuum coefficients."""
    from fdtd_tpu.state import Materials as JMaterials

    tp = convert.params_from(default_params)
    eps = np.full((tp.maxk, tp.maxj, tp.maxi), 4.0)
    coefs = tstate.update_coefs(tp, tstate.Materials(eps_r=eps), "cpu")
    jcoefs = update_coefs(default_params, JMaterials(eps_r=eps))
    assert coefs.lossy and not coefs.heterogeneous_mu
    for f in ("ca_x", "ca_y", "ca_z", "cb_x", "cb_y", "cb_z", "sigma_cells"):
        np.testing.assert_array_equal(getattr(coefs, f).numpy(), np.asarray(getattr(jcoefs, f)), err_msg=f)
    assert coefs.h_factor == jcoefs.h_factor
    assert tstate.update_coefs(tp, tstate.Materials()) == tstate.update_coefs(tp)


@pytest.mark.parametrize("ccompat", [False, True])
def test_analytic_fields_match(default_params, ccompat):
    tp = convert.params_from(default_params)
    assert analytic.mode_constants(tp) == janalytic.mode_constants(default_params)
    for t in (0.0, 3.7e-11, 1.2e-10):
        want = janalytic.analytic_fields(default_params, t, ccompat=ccompat)
        got = analytic.analytic_fields(tp, t, ccompat=ccompat)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_error_metrics_match(default_params):
    p = default_params
    tp = convert.params_from(p)
    rng = np.random.default_rng(6)
    arrays = {c: rng.normal(size=p.padded_shape) * 1e-2 + np.asarray(getattr(init_validation(p), c))
              for c in COMPONENTS}
    js = JFieldState(**{c: jnp.array(a) for c, a in arrays.items()})
    ts = convert.state_from_numpy(arrays, "cpu", torch.float64)
    t = 5.3e-11
    for fn in ("relative_l2_error", "peak_normalized_error"):
        want = getattr(janalytic, fn)(p, js, t)
        got = getattr(analytic, fn)(tp, ts, t)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), (fn, k)
    jerr = janalytic.error_fields(p, js, t)
    terr = analytic.error_fields(tp, ts, t)
    for k in jerr:
        np.testing.assert_array_equal(terr[k].numpy(), np.asarray(jerr[k]), err_msg=k)


@pytest.mark.parametrize("quirk_compat", [False, True])
def test_energies_match_jax_and_oracle(tiny_params, quirk_compat):
    p = tiny_params
    tp = convert.params_from(p)
    rng = np.random.default_rng(8)
    arrays = {c: rng.normal(size=p.padded_shape) for c in COMPONENTS}
    js = JFieldState(**{c: jnp.array(a) for c, a in arrays.items()})
    ts = convert.state_from_numpy(arrays, "cpu", torch.float64)
    oracle = OracleSim(p)
    for c in COMPONENTS:
        setattr(oracle, c, arrays[c].copy())
    e = float(diagnostics.e_energy(tp, ts, quirk_compat))
    h = float(diagnostics.h_energy(tp, ts))
    assert e == pytest.approx(float(jdiag.e_energy(p, js, quirk_compat)), rel=1e-12)
    assert h == pytest.approx(float(jdiag.h_energy(p, js)), rel=1e-12)
    assert e == pytest.approx(oracle.e_energy(quirk_compat), rel=1e-10)
    assert h == pytest.approx(oracle.h_energy(), rel=1e-10)
    assert float(diagnostics.total_energy(tp, ts, quirk_compat)) == pytest.approx(e + h, rel=1e-15)
    assert diagnostics.theoretical_te101_energy(tp) == jdiag.theoretical_te101_energy(p)
