"""The TPU kernels that fold into the port's kernels (K5, K7, K8, K13).

Five Pallas kernels of the JAX package compute what the port's kernels
already compute, on layouts or schedules the port does not need:

- K5, ``pallas_temporal._kernel`` (vacuum temporal blocking, s steps a
  sweep): the port's K3, the streaming sweep, at the depth
  ``--temporal-steps`` forces (``stream_s``);
- K6, ``pallas_temporal._kernel_lossy`` (the same for lossy media, with
  the SAR accumulation in the kernel): K3's lossy and lossy + SAR
  variants at that depth;
- K7, ``pallas_step._h_kernel``/``_e_kernel`` (the two-pass step on the
  uniform padded layout, backend ``pallas``): K1/K2, ``twopass``;
- K8, ``pallas_fused._kernel`` (the single fused whole step,
  ``make_fused_step(two_pass=False)``): K1 then K2, ``twopass``;
- K13, ``attic.pallas_inplace._body`` (the retired manual-DMA whole
  step): K1/K2, ``twopass``.

Each runs in interpret mode from the state the JAX tests seed (the TE101
mode, or zero fields and the source) against the port's plain path (on CPU
tensors the port's kernels run their plain versions), at the JAX tests'
bars: fp32 atol 1e-6 (``tests/test_temporal.py``,
``test_stream_matches_xla``), the SAR map at rtol 2e-5
(``test_temporal_lossy_matches_twopass``).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu.state import FieldState as JFieldState  # noqa: E402
from fdtd_tpu.state import init_validation, update_coefs, zeros  # noqa: E402
from fdtd_tpu.step import backend_adapters, make_chunk_runner, make_step, scan_inputs  # noqa: E402
from fdtd_tpu_torch import convert  # noqa: E402
from fdtd_tpu_torch.step import make_chunk_runner as t_make_chunk_runner  # noqa: E402

COMPONENTS = ("ex", "ey", "ez", "hx", "hy", "hz")
ATOL = 1e-6


def _params(n, mode):
    return Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=1e-3, time_step=1e-12,
                  simulation_time=1e-11, sampling_rate=5, mode=mode, dtype="float32")


def _seeded(p):
    """The mode's initial state as the JAX tests seed it: the TE101 mode in
    validation mode, zero fields (the source drives them) in computation
    mode."""
    s = init_validation(p) if p.mode == Mode.VALIDATION else zeros(p)
    return {c: np.asarray(getattr(s, c)) for c in COMPONENTS}


def _port_run(p, arrays, backend, steps, **kw):
    tp = convert.params_from(p)
    s = convert.state_from_numpy(arrays, "cpu", torch.float32)
    t_make_chunk_runner(tp, "cpu", backend=backend, **kw)(s, scan_inputs(p, time_values(p)[:steps]))
    return convert.state_to_numpy(s)


def _assert_close(got, want, label):
    for c in COMPONENTS:
        g = np.asarray(got[c])[:, :, : want[c].shape[2]]
        np.testing.assert_allclose(g, np.asarray(want[c])[: g.shape[0]], atol=ATOL, rtol=0, err_msg=f"{label}/{c}")


def _jax_steps(p, arrays, step, prep, rest, steps):
    s = prep(JFieldState(**{c: jax.numpy.asarray(a) for c, a in arrays.items()}))
    for t, a in zip(*scan_inputs(p, time_values(p)[:steps])):
        s = step(s, (t, a))
    back = rest(s)
    return {c: np.asarray(getattr(back, c)) for c in COMPONENTS}


@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_k7_pallas_step_folds_into_twopass(mode):
    p = _params(12, mode)
    arrays = _seeded(p)
    prep, rest = backend_adapters(p, "pallas")
    want = _jax_steps(p, arrays, jax.jit(make_step(p, backend="pallas")), prep, rest, 8)
    _assert_close(_port_run(p, arrays, "twopass", 8), want, f"K7 {mode.name}")


@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_k8_fused_whole_step_folds_into_twopass(mode):
    from fdtd_tpu.ops.pallas_fused import make_fused_step

    p = _params(12, mode)
    arrays = _seeded(p)
    prep, rest = backend_adapters(p, "pallas_fused")
    step = jax.jit(make_fused_step(p, update_coefs(p, None), interpret=True, two_pass=False))
    want = _jax_steps(p, arrays, step, prep, rest, 8)
    _assert_close(_port_run(p, arrays, "twopass", 8), want, f"K8 {mode.name}")


@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_k13_inplace_step_folds_into_twopass(mode):
    from fdtd_tpu.attic.pallas_inplace import make_inplace_step

    p = _params(16, mode)
    arrays = _seeded(p)
    prep, rest = backend_adapters(p, "pallas_fused")  # the same stripped layout
    want = _jax_steps(p, arrays, jax.jit(make_inplace_step(p, update_coefs(p, None))), prep, rest, 8)
    _assert_close(_port_run(p, arrays, "twopass", 8), want, f"K13 {mode.name}")


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_k5_temporal_blocking_folds_into_stream(monkeypatch, mode, s):
    """pallas_temporal at FDTD_TEMPORAL_STEPS=s (the JAX CLI's
    --temporal-steps) against the port's stream sweep forced to s steps
    (the port's --temporal-steps), 9 steps so both run a trailing step."""
    monkeypatch.setenv("FDTD_TEMPORAL_STEPS", str(s))
    p = dataclasses.replace(_params(10, mode), simulation_time=9e-12)
    arrays = _seeded(p)
    prep, rest = backend_adapters(p, "pallas_temporal")
    xs = scan_inputs(p, time_values(p)[:9])
    s0 = prep(JFieldState(**{c: jax.numpy.asarray(a) for c, a in arrays.items()}))
    got_j = rest(make_chunk_runner(p, backend="pallas_temporal")(s0, xs, None)[0])
    want = {c: np.asarray(getattr(got_j, c)) for c in COMPONENTS}
    port = _port_run(p, arrays, "stream", 9, stream_s=s)
    _assert_close(port, want, f"K5 s={s} {mode.name}")


@pytest.mark.parametrize("sar", [False, True])
@pytest.mark.parametrize("s", [2, 4])
def test_k6_lossy_temporal_blocking_folds_into_stream(monkeypatch, s, sar):
    """pallas_temporal on a water block (with its in-kernel SAR) at
    FDTD_TEMPORAL_STEPS=s against the port's lossy (+ SAR) stream sweep
    forced to s steps, 7 steps (sweeps and a trailing step)."""
    from fdtd_tpu.state import water_block
    from fdtd_tpu.step import zero_power_acc

    from fdtd_tpu_torch.step import zero_power_acc as t_zero_power_acc

    monkeypatch.setenv("FDTD_TEMPORAL_STEPS", str(s))
    p = _params(10, Mode.COMPUTATION)
    mats = water_block(p, lo=(0.2, 0.2, 0.2), hi=(0.8, 0.8, 0.8))
    prep, rest = backend_adapters(p, "pallas_fused", mats)
    xs = scan_inputs(p, time_values(p)[:7])
    got_j, acc_j = make_chunk_runner(p, mats, backend="pallas_temporal", accumulate_power=sar)(
        prep(zeros(p)), xs, zero_power_acc(p) if sar else None)
    got_j = rest(got_j)
    want = {c: np.asarray(getattr(got_j, c)) for c in COMPONENTS}
    tp = convert.params_from(p)
    st = convert.state_from_numpy(_seeded(p), "cpu", torch.float32)
    acc_t = t_zero_power_acc(tp, "cpu") if sar else None
    t_make_chunk_runner(tp, "cpu", convert.materials_from(mats), "stream", stream_s=s, accumulate_power=sar)(
        st, xs, acc_t)
    _assert_close(convert.state_to_numpy(st), want, f"K6 s={s} sar={sar}")
    if sar:
        np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=2e-5, atol=1e-30)
        assert float(acc_t.max()) > 0
