"""The port's plain H and E updates (the plain versions of its two Hopper
kernels) held against the JAX package.

- fp64: ``fdtd_tpu_torch.ops.curl`` against ``fdtd_tpu.ops.curl`` and the
  loop oracle on random fields, at atol 1e-15 / rtol 1e-11 (the tolerance of
  tests/test_step_parity.py: identical operation order, XLA may reassociate).
- fp32 and bf16: the port's ``twopass`` step, whose wrappers run the plain
  versions on CPU tensors, against ``make_step(backend="pallas_fused")`` in
  Pallas interpret mode, 8 steps.  fp32 is expected exact; the bound is a
  relative L2 of 1e-6 per component, since XLA may reassociate or contract.
  bf16 allows 1 bf16 ulp of each component's maximum magnitude.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu.ops import curl as jcurl  # noqa: E402
from fdtd_tpu.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu.state import FieldState as JFieldState  # noqa: E402
from fdtd_tpu.state import init_validation, update_coefs, zeros  # noqa: E402
from fdtd_tpu.step import backend_adapters, make_step, scan_inputs  # noqa: E402
from fdtd_tpu_torch import convert  # noqa: E402
from fdtd_tpu_torch import state as tstate  # noqa: E402
from fdtd_tpu_torch import step as tstep  # noqa: E402
from fdtd_tpu_torch.ops import curl as tcurl  # noqa: E402
from fdtd_tpu_torch.source import make_source_plan  # noqa: E402

from .oracle import OracleSim  # noqa: E402

COMPONENTS = ["ex", "ey", "ez", "hx", "hy", "hz"]


def _box(length, width, height, mode=Mode.VALIDATION, dtype="float64"):
    return Params(length=length, width=width, height=height, spatial_step=0.001,
                  time_step=1e-12, simulation_time=1e-11, sampling_rate=5,
                  mode=mode, dtype=dtype)


def _random_fields(p, seed):
    rng = np.random.default_rng(seed)
    return {c: rng.uniform(-1.0, 1.0, p.padded_shape) for c in COMPONENTS}


def _jax_state(arrays):
    return JFieldState(**{c: jax.numpy.asarray(a) for c, a in arrays.items()})


# (K, J, I) = (8, 7, 9): non-cubic; and the 10^3 cube
BOXES = [(0.0095, 0.0075, 0.0085), (0.01, 0.01, 0.01)]


@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("half", ["h", "e"])
def test_plain_update_matches_jax_and_oracle_fp64(box, half):
    p = _box(*box)
    tp = convert.params_from(p)
    arrays = _random_fields(p, seed=7)

    ts = convert.state_from_numpy(arrays, "cpu", torch.float64)
    js = _jax_state(arrays)
    oracle = OracleSim(p)
    for c in COMPONENTS:
        setattr(oracle, c, arrays[c].copy())
    if half == "h":
        tcurl.update_h(tp, ts, tstate.update_coefs(tp))
        js = jcurl.update_h(p, js, update_coefs(p))
        oracle.update_h()
    else:
        tcurl.update_e(tp, ts, tstate.update_coefs(tp))
        js = jcurl.update_e(p, js, update_coefs(p))
        oracle.update_e()

    got = convert.state_to_numpy(ts)
    for c in COMPONENTS:
        np.testing.assert_allclose(got[c], np.asarray(getattr(js, c)), atol=1e-15, rtol=1e-11, err_msg=c)
        np.testing.assert_allclose(got[c], getattr(oracle, c), atol=1e-15, rtol=1e-11, err_msg=c)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_patch_leaves_source_cells_of_hx_hz(dtype):
    """update_h with the source patch equals update_h without it everywhere
    except Hx/Hz at k=0 inside the patch, which keep their values."""
    p = convert.params_from(_box(0.0125, 0.012, 0.011, mode=Mode.COMPUTATION))
    j0, j1, i0, i1 = make_source_plan(p).patch
    arrays = _random_fields(p, seed=11)
    a = convert.state_from_numpy(arrays, "cpu", dtype)
    b = convert.state_from_numpy(arrays, "cpu", dtype)
    before = convert.state_from_numpy(arrays, "cpu", dtype)
    coefs = tstate.update_coefs(p)
    tcurl.update_h(p, a, coefs, (j0, j1, i0, i1))
    tcurl.update_h(p, b, coefs)
    sl = (0, slice(j0, j1), slice(i0, i1))
    for c in ("hx", "hz"):
        assert torch.equal(getattr(a, c)[sl], getattr(before, c)[sl])
        assert not torch.equal(getattr(b, c)[sl], getattr(before, c)[sl])
        getattr(a, c)[sl] = getattr(b, c)[sl]
    for c in COMPONENTS:
        assert torch.equal(getattr(a, c), getattr(b, c)), c


def _run_both(p, n_steps=8):
    """(JAX pallas_fused interpret-mode fields, port twopass fields) after
    ``n_steps`` from the same initial state."""
    js = init_validation(p) if p.mode == Mode.VALIDATION else zeros(p)
    tp = convert.params_from(p)
    ts_state = convert.state_from_numpy({c: np.asarray(getattr(js, c)) for c in COMPONENTS},
                                        "cpu", tstate.field_dtype(tp))
    prep, rest = backend_adapters(p, "pallas_fused")
    jst = prep(js)
    jstep = jax.jit(make_step(p, backend="pallas_fused"))
    tstep_fn = tstep.make_step(tp, "cpu", backend="twopass")
    ts, amps = scan_inputs(p, time_values(p)[:n_steps])
    for t, a in zip(ts, amps):
        jst = jstep(jst, (t, a))
        tstep_fn(ts_state, (t, torch.tensor(a, dtype=torch.float64)))
    back = rest(jst)
    want = {c: np.asarray(getattr(back, c)).astype(np.float64) for c in COMPONENTS}
    got = {c: v.astype(np.float64) for c, v in convert.state_to_numpy(ts_state).items()}
    return want, got


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def _assert_matches(want, got, dtype):
    for c in COMPONENTS:
        w, g = want[c], got[c]
        if dtype == "float32":
            norm = np.linalg.norm(w)
            rel = np.linalg.norm(g - w) / norm if norm > 0 else np.linalg.norm(g)
            assert rel <= 1e-6, (c, rel)
        else:
            bound = _bf16_ulp(float(np.abs(w).max()))
            assert float(np.abs(g - w).max()) <= bound, (c, float(np.abs(g - w).max()), bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
@pytest.mark.parametrize("n", [12, 16])
def test_twopass_plain_matches_pallas_fused(dtype, mode, n):
    p = _box(n * 0.001, n * 0.001, n * 0.001, mode=mode, dtype=dtype)
    want, got = _run_both(p)
    _assert_matches(want, got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twopass_plain_matches_pallas_fused_noninteger_box(dtype):
    """The box of tests/test_pallas.py whose i=maxi Ey column is O(1): the
    port reads it in place where pallas_fused folds it into its strips."""
    p = dataclasses.replace(_box(0.0125, 0.012, 0.012), dtype=dtype)
    js = init_validation(p)
    assert float(np.abs(np.asarray(js.ey, np.float64)[:, : p.maxj, p.maxi]).max()) > 1e-3
    want, got = _run_both(p)
    _assert_matches(want, got, dtype)
