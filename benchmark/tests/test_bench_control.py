"""The check's control and its faults, at a size a test run holds.

The control is the program at the field storage its configuration does
not state, against the reference at the stated one (``control.CONTROL``):
an fp32 cell's is the program's own bfloat16 path, the precision below;
a bfloat16 cell's is the program at float32, the rounding left out.
The faults break the timed path underneath the harness, at the program's
public entry, and leave everything else of a run as it is: a run whose
steps leave the state unchanged, a run that updates only half of the
grid, and runs in which one answer is altered where it is produced; and
in a Debye load: the dispersion dropped (the block run as a lossy eps_inf
+ sigma medium), the polarization left unchanged across steps, and one
seeded polarization value altered in the checkpoint the program resumes;
and in a bfloat16 cell: its fields rounded with one mantissa bit fewer
where the program produces them.  ``correct`` has to come out false each
time.
"""

import json

import numpy as np
import pytest
import torch

from conftest import BF16_WORKLOADS, FP32_WORKLOADS, WORKLOADS
from control import CONTROL
from core import seeded

DEBYE = "debye_256.sar"


@pytest.mark.parametrize("workload", FP32_WORKLOADS)
def test_bfloat16_control_is_not_correct(run_tiny, workload):
    assert CONTROL["float32"] == "bfloat16"
    r = run_tiny(workload, program_dtype="bfloat16")
    assert not r["correct"], r["checks"]
    # the fields themselves give it away, whatever else the cell compares
    assert r["checks"]["state_err"]["value"] > r["checks"]["state_err"]["limit"]


def _initial(kw) -> dict:
    return seeded.read_checkpoint_fields(f"{kw['out_dir']}/{seeded.CHECKPOINT}")


def _rewrite_log(path: str, edit) -> None:
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    recs = edit(recs)
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)


def frozen(res, kw):
    """Every step returns its state unchanged: the fields stay the seeded
    ones, the log repeats the first record, nothing is deposited or summed,
    the probes read the first state."""
    init = _initial(kw)
    for n in seeded.COMPONENTS:
        getattr(res.state, n).copy_(torch.as_tensor(init[n]))
    _rewrite_log(kw["diagnostics_log"], lambda recs: [dict(r, **{k: recs[0][k] for k in
                                                                 ("E_energy", "H_energy", "total")}) for r in recs])
    if res.power_j is not None:
        res.power_j.zero_()
    if res.dft is not None:
        res.dft.phasors[...] = 0
    if res.probes is not None:
        res.probes.values[...] = res.probes.values[:1]


def half(res, kw):
    """Half of the grid (the upper k planes) left out of every step."""
    init = _initial(kw)
    for n in seeded.COMPONENTS:
        t = getattr(res.state, n)
        k = t.shape[0] // 2
        t[k:] = torch.as_tensor(init[n][k:])
    if res.power_j is not None:
        res.power_j[res.power_j.shape[0] // 2:] = 0
    if res.dft is not None:
        res.dft.phasors[:, :, res.dft.phasors.shape[2] // 2:] = 0


def altered_state(res, kw):
    """One field value altered where the step writes it."""
    ez = res.state.ez
    ez[ez.shape[0] // 2, ez.shape[1] // 2, ez.shape[2] // 2] += 0.01 * float(ez.abs().max())


def altered_energy(res, kw):
    """One energy record altered where the log writes it."""
    def edit(recs):
        recs[1]["E_energy"] *= 1.001
        return recs
    _rewrite_log(kw["diagnostics_log"], edit)


def altered_map(res, kw):
    """One cell of the SAR map, one DFT sum or one probe value altered."""
    if res.power_j is not None:
        p = res.power_j
        p[p.shape[0] // 2, p.shape[1] // 2, p.shape[2] // 2] *= 1.01
    if res.dft is not None:
        ph = res.dft.phasors
        ph[0, 0, ph.shape[2] // 2, ph.shape[3] // 2, ph.shape[4] // 2] *= 1.01
    if res.probes is not None:
        res.probes.values[len(res.probes.values) // 2, 0, 2] += np.float32(0.01)


def one_bit_fewer(res, kw):
    """The fields rounded to bfloat16 with one mantissa bit fewer (6 of
    7), to nearest even, where the call produces them."""
    for n in seeded.COMPONENTS:
        t = getattr(res.state, n)
        bits = t.float().view(torch.int32)
        bits = (bits + 0xFFFF + ((bits >> 17) & 1)) & ~0x1FFFF
        t.copy_(bits.view(torch.float32))


FAULTS = {"frozen": frozen, "half": half, "altered_state": altered_state, "altered_energy": altered_energy,
          "altered_map": altered_map, "one_bit_fewer": one_bit_fewer}


def _applies(workload: str, fault: str) -> bool:
    if fault == "altered_map":
        return workload != "oven_256.long"  # the empty long run produces no map, sums or probe rows to alter
    if fault == "one_bit_fewer":
        return workload in BF16_WORKLOADS  # the precision below a bf16 cell's
    return True


CASES = [(w, f) for w in WORKLOADS for f in FAULTS if _applies(w, f)]


@pytest.mark.parametrize("workload,fault", CASES)
def test_faults_are_not_correct(run_tiny, monkeypatch, workload, fault):
    from fdtd_tpu_torch import runner

    real = runner.run_simulation

    def broken(p, device, **kw):
        res = real(p, device, **kw)
        FAULTS[fault](res, kw)
        return res

    monkeypatch.setattr(runner, "run_simulation", broken)
    r = run_tiny(workload)
    assert not r["correct"], (fault, r["checks"])


def dispersion_dropped(monkeypatch):
    """The Debye block run as its instantaneous part alone: a lossy
    medium of eps_inf and the ionic sigma."""
    from fdtd_tpu_torch import runner

    real = runner.run_simulation

    def lossy(p, device, **kw):
        return real(p, device, **dict(kw, materials=kw["materials"].base))

    monkeypatch.setattr(runner, "run_simulation", lossy)


def pol_frozen(monkeypatch):
    """Every ADE E update leaves the polarization as it found it."""
    from fdtd_tpu_torch.ops import dispersive

    real = dispersive.update_e_ade

    def frozen_pol(p, s, P, dc, work=None, box=None):
        before = P.clone()
        real(p, s, P, dc, work, box)
        for t, b in zip(P.tensors(), before.tensors()):
            t.copy_(b)

    monkeypatch.setattr(dispersive, "update_e_ade", frozen_pol)


def pol_altered_in_checkpoint(monkeypatch):
    """The seeded P's largest Px value written with its sign flipped."""
    real = seeded.write_checkpoint

    def altered(run_dir, fields, power_shape, pol=None):
        pol = pol.clone()
        flat = pol[0].view(-1)
        n = int(flat.float().abs().argmax())
        flat[n] = -flat[n]
        return real(run_dir, fields, power_shape, pol)

    monkeypatch.setattr(seeded, "write_checkpoint", altered)


DEBYE_FAULTS = {"dispersion_dropped": dispersion_dropped, "pol_frozen": pol_frozen,
                "pol_altered_in_checkpoint": pol_altered_in_checkpoint}


@pytest.mark.parametrize("fault", DEBYE_FAULTS)
def test_debye_faults_are_not_correct(run_tiny, monkeypatch, fault):
    DEBYE_FAULTS[fault](monkeypatch)
    r = run_tiny(DEBYE)
    assert not r["correct"], (fault, r["checks"])
    assert r["checks"]["state_err"]["value"] > r["checks"]["state_err"]["limit"], (fault, r["checks"])



@pytest.mark.parametrize("workload", BF16_WORKLOADS)
def test_float32_control_of_a_bfloat16_cell_is_not_correct(run_tiny, workload):
    assert CONTROL["bfloat16"] == "float32"
    r = run_tiny(workload, program_dtype="float32")
    assert not r["correct"], r["checks"]
    assert r["checks"]["state_err"]["value"] > r["checks"]["state_err"]["limit"]
