"""The means mode of the sweeps' DFT bands (six frequencies, past every
built shape's bands), through the port's plain versions on the CPU,
against the JAX package's streaming tiers with their phasor bands in
interpret mode: K3 (vacuum, lossy + SAR; ``run_simulation(backend=
"pallas_stream")``), K11 (``make_stream_pml_dft_chunk_runner``) and K12
with SAR (``run_simulation(backend="pallas_stream")`` on a Debye load).
Odd step counts, so the port's chunk folds its buffer and then runs
trailing two-pass steps with K4.  Bars: the tests of the bands
(``test_torch_dft.py``, ``test_torch_monitors.py``): fields atol 5e-7
(K11: 1e-6), sums or phasors within 1e-6 of their scale (K11, K12: 2e-6),
the SAR map rtol 3e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import dft as jdft  # noqa: E402
from fdtd_tpu.ops.cpml import PMLConfig as JPMLConfig  # noqa: E402
from fdtd_tpu.ops.dispersive import water_debye_load as j_water_debye_load  # noqa: E402
from fdtd_tpu.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu.runner import run_simulation as j_run  # noqa: E402
from fdtd_tpu.state import water_block as j_water_block  # noqa: E402
from fdtd_tpu_torch import convert, dft  # noqa: E402
from fdtd_tpu_torch.grid import COMPONENTS  # noqa: E402
from fdtd_tpu_torch.ops.cpml import PMLConfig, init_psi  # noqa: E402
from fdtd_tpu_torch.ops.dispersive import zero_polarization  # noqa: E402
from fdtd_tpu_torch.runner import initial_state  # noqa: E402
from fdtd_tpu_torch.step import make_chunk_runner, scan_inputs, zero_power_acc  # noqa: E402


def _box(n, steps):
    return Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=1e-3, time_step=1e-12,
                  simulation_time=(steps - 0.5) * 1e-12, sampling_rate=10**9, mode=Mode.COMPUTATION, dtype="float32")


def _freqs(p):
    return tuple(p.source.frequency + 2e8 * k for k in range(6))


def _close_to_scale(got, want, frac, label):
    scale = float(np.abs(want).max())
    assert scale > 0, label
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale, err_msg=label)


def _hold_fields(s, want, atol):
    for c in COMPONENTS:
        np.testing.assert_allclose(getattr(s, c).numpy(), np.asarray(getattr(want, c)), rtol=0, atol=atol, err_msg=c)


@pytest.mark.parametrize("scene", ["vacuum", "lossy_sar", "debye_sar"])
def test_means_route_matches_interpret_stream_dft(scene):
    """K3 (vacuum, lossy + SAR) and K12 + SAR: 23 steps of a 12^3 box."""
    steps = 23
    p = _box(12, steps)
    sar = scene != "vacuum"
    jm = {"vacuum": None, "lossy_sar": j_water_block(p),
          "debye_sar": j_water_debye_load(p, lo=(0.25,) * 3, hi=(0.75,) * 3, sigma_ion25=0.2)}[scene]
    jcfg = jdft.DftConfig(_freqs(p))
    want = j_run(p, materials=jm, write_snapshots=False, backend="pallas_stream", dft=jcfg, accumulate_power=sar,
                 log=lambda m: None)
    tp = convert.params_from(p)
    cfg = dft.DftConfig(jcfg.frequencies)
    mats = (convert.debye_from(jm) if scene == "debye_sar" else convert.materials_from(jm)) if jm is not None else None
    run = make_chunk_runner(tp, "cpu", mats, "stream", accumulate_power=sar, dft=cfg)
    assert run.plan.fold and run.plan.kernel.endswith("_dft_means") and steps % run.plan.s
    s, sums = initial_state(tp, "cpu"), dft.zero_dft_acc(tp, cfg, "cpu")
    power = zero_power_acc(tp, "cpu") if sar else None
    pol = zero_polarization(tp, "cpu") if scene == "debye_sar" else None
    tv = time_values(p)
    run(s, scan_inputs(p, tv) + dft.dft_weights(cfg, tv), power, None, pol, sums)
    _close_to_scale(dft.finalize(cfg, sums, len(tv)).phasors, want.dft.phasors,
                    2e-6 if scene == "debye_sar" else 1e-6, "phasors")
    _hold_fields(s, want.state, 5e-7)
    if sar:
        np.testing.assert_allclose(power.numpy(), np.asarray(want.power_j), rtol=3e-6, atol=1e-18)


def test_means_route_matches_interpret_stream_pml_dft():
    """K11: 23 steps of a 24^3 box with 5-cell walls."""
    from fdtd_tpu.ops.pallas_stream_pml import make_stream_pml_dft_chunk_runner, pack_psi_stream
    from fdtd_tpu.state import zeros as j_zeros
    from fdtd_tpu.step import backend_adapters

    steps = 23
    p = _box(24, steps)
    jcfg = jdft.DftConfig(_freqs(p))
    tv = time_values(p)[:steps]
    xs = scan_inputs(p, tv) + jdft.dft_weights(jcfg, np.asarray(tv))
    prep, rest = backend_adapters(p, "pallas_fused", None)
    run_s = make_stream_pml_dft_chunk_runner(p, JPMLConfig(cells=5), None, jcfg, interpret=True, s=4)
    (st_w, _psi), _pw, dacc_w, _ = run_s((prep(j_zeros(p)), pack_psi_stream(p, JPMLConfig(cells=5), None)), xs, None,
                                         jdft.zero_dft_acc(p, jcfg))
    want = rest(st_w)
    tp = convert.params_from(p)
    cfg, pml = dft.DftConfig(jcfg.frequencies), PMLConfig(cells=5)
    run = make_chunk_runner(tp, "cpu", backend="stream", pml=pml, dft=cfg)
    assert run.plan.kernel == "yee_stream_pml_dft_means" and run.plan.fold and steps % run.plan.s
    s = initial_state(tp, "cpu")
    sums = dft.zero_dft_acc(tp, cfg, "cpu")
    run(s, xs, None, init_psi(tp, pml, "cpu"), None, sums)
    for g, w, name in zip(sums, dacc_w, ("re", "im")):
        _close_to_scale(g.numpy(), np.asarray(w), 2e-6, name)
    _hold_fields(s, want, 1e-6)
