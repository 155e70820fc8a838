"""The port's step against the JAX package, the kernel wrappers on CPU
tensors, the kernel build without nvcc, and backend resolution.

Step parity: fp64, 12 steps, both modes, against ``fdtd_tpu`` ``xla`` and
the loop oracle at atol 1e-15 / rtol 1e-11 (tests/test_step_parity.py's
tolerance).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu.params import Mode, time_values  # noqa: E402
from fdtd_tpu.state import init_validation, zeros  # noqa: E402
from fdtd_tpu.step import make_step, scan_inputs  # noqa: E402
from fdtd_tpu_torch import convert, runner  # noqa: E402
from fdtd_tpu_torch import state as tstate  # noqa: E402
from fdtd_tpu_torch import step as tstep  # noqa: E402
from fdtd_tpu_torch.ops import build, curl, yee  # noqa: E402
from fdtd_tpu_torch.source import make_source_plan  # noqa: E402

from .oracle import OracleSim  # noqa: E402

COMPONENTS = ["ex", "ey", "ez", "hx", "hy", "hz"]


def _numpy_state(js):
    return {c: np.asarray(getattr(js, c)) for c in COMPONENTS}


@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_torch_step_matches_xla_and_oracle_fp64(tiny_params, mode):
    p = dataclasses.replace(tiny_params, mode=mode)
    tp = convert.params_from(p)
    js = init_validation(p) if mode == Mode.VALIDATION else zeros(p)
    ts_state = convert.state_from_numpy(_numpy_state(js), "cpu", torch.float64)
    oracle = OracleSim(p)
    for c in COMPONENTS:
        setattr(oracle, c, np.asarray(getattr(js, c)).copy())

    jstep = jax.jit(make_step(p))
    step = tstep.make_step(tp, "cpu", backend="torch")
    ts, amps = scan_inputs(p, time_values(p)[:12])
    t_ts, t_amps = tstep.scan_inputs(tp, time_values(p)[:12])
    np.testing.assert_array_equal(t_ts, ts)
    np.testing.assert_array_equal(t_amps, amps)
    for t, a in zip(ts, amps):
        js = jstep(js, (t, a))
        step(ts_state, (t, float(a)))
        oracle.step(t, computation=mode == Mode.COMPUTATION)

    got = convert.state_to_numpy(ts_state)
    for c in COMPONENTS:
        np.testing.assert_allclose(got[c], np.asarray(getattr(js, c)), atol=1e-15, rtol=1e-11, err_msg=c)
        np.testing.assert_allclose(got[c], getattr(oracle, c), atol=1e-15, rtol=1e-11, err_msg=c)


@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twopass_step_equals_torch_step(tiny_params, mode, dtype):
    """Setting the source once and skipping its Hx/Hz cells in the H pass
    gives the same bits as the reference's double hard-set."""
    p = dataclasses.replace(convert.params_from(tiny_params), mode=mode, dtype=dtype)
    a = tstate.init_validation(p, "cpu") if mode == Mode.VALIDATION else tstate.zeros(p, "cpu")
    b = a.clone()
    xs = tstep.scan_inputs(p, time_values(p)[:12])
    tstep.make_chunk_runner(p, "cpu", backend="twopass")(a, xs)
    tstep.make_chunk_runner(p, "cpu", backend="torch")(b, xs)
    for c in COMPONENTS:
        assert torch.equal(getattr(a, c), getattr(b, c)), c


def test_chunk_runner_equals_steps(tiny_params):
    p = dataclasses.replace(convert.params_from(tiny_params), mode=Mode.COMPUTATION)
    a = tstate.zeros(p, "cpu")
    b = tstate.zeros(p, "cpu")
    ts, amps = tstep.scan_inputs(p, time_values(p)[:9])
    tstep.make_chunk_runner(p, "cpu")(a, (ts, amps))
    step = tstep.make_step(p, "cpu")
    for t, amp in zip(ts, amps):
        step(b, (t, float(amp)))
    for c in COMPONENTS:
        assert torch.equal(getattr(a, c), getattr(b, c)), c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_wrappers_run_plain_on_cpu_without_launching(tiny_params, dtype):
    p = dataclasses.replace(convert.params_from(tiny_params), mode=Mode.COMPUTATION)
    rng = np.random.default_rng(5)
    arrays = {c: rng.normal(size=p.padded_shape) for c in COMPONENTS}
    a = convert.state_from_numpy(arrays, "cpu", dtype)
    b = convert.state_from_numpy(arrays, "cpu", dtype)
    coefs = tstate.update_coefs(p)
    patch = make_source_plan(p).patch
    yee.reset_launches()
    yee.update_h(p, a, coefs, patch)
    yee.update_e(p, a, coefs)
    curl.update_h(p, b, coefs, patch)
    curl.update_e(p, b, coefs)
    for c in COMPONENTS:
        assert torch.equal(getattr(a, c), getattr(b, c)), c
    assert yee.launches == dict.fromkeys(yee.launches, 0) and "yee_update_h" in yee.launches


def test_wrappers_refuse_other_devices(tiny_params):
    """A tensor neither on the CPU nor on a CUDA device raises; nothing is
    launched and nothing falls back to the plain version."""
    p = convert.params_from(tiny_params)
    s = tstate.zeros(p, "meta", torch.float32)
    coefs = tstate.update_coefs(p)
    yee.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        yee.update_h(p, s, coefs)
    with pytest.raises(ValueError, match="CUDA"):
        yee.update_e(p, s, coefs)
    mixed = tstate.zeros(p, "cpu", torch.float32)
    mixed.hx = mixed.hx.to("meta")
    with pytest.raises(ValueError, match="one device"):
        yee.update_h(p, mixed, coefs)
    assert yee.launches == dict.fromkeys(yee.launches, 0) and "yee_update_h" in yee.launches


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc and no built library: a RuntimeError that says so."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    assert build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        build.build(yee.KERNEL_SOURCE, build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_build_names_library_by_source_and_flags(tmp_path):
    a = build.library_path(yee.KERNEL_SOURCE, tmp_path)
    assert a.parent == tmp_path and a.name.startswith("libyee_twopass-") and a.suffix == ".so"
    assert build.library_path(yee.KERNEL_SOURCE, tmp_path) == a


def test_make_step_refuses_fp64_twopass_and_unknown_backends(tiny_params):
    p = convert.params_from(tiny_params)
    assert p.dtype == "float64"
    with pytest.raises(ValueError, match="float64"):
        tstep.make_step(p, "cpu", backend="twopass")
    with pytest.raises(ValueError, match="unknown backend"):
        tstep.make_step(p, "cpu", backend="xla")


@pytest.mark.parametrize(
    "device, dtype, backend, want",
    [
        ("cpu", "float32", "auto", "torch"),
        ("cpu", "float64", "auto", "torch"),
        ("cuda", "float32", "auto", "stream"),
        ("cuda", "bfloat16", "auto", "stream"),
        ("cuda", "float64", "auto", "torch"),
        ("cuda", "float32", "torch", "torch"),
        ("cpu", "float32", "twopass", ValueError),
        ("cuda", "float64", "twopass", ValueError),
        ("cpu", "float32", "pallas_fused", ValueError),
    ],
)
def test_resolve_backend(tiny_params, device, dtype, backend, want):
    p = dataclasses.replace(convert.params_from(tiny_params), dtype=dtype)
    if want is ValueError:
        with pytest.raises(ValueError):
            runner.resolve_backend(p, backend, device)
    else:
        assert runner.resolve_backend(p, backend, device) == want


def test_cuda_device_without_cuda_is_an_error():
    """Asking for CUDA where there is none names --device cpu; it never
    moves to the host silently."""
    if torch.cuda.is_available():
        assert runner.resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        runner.resolve_device("cuda")
    assert runner.resolve_device("cpu").type == "cpu"
