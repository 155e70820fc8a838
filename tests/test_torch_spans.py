"""The port's profiler spans (``fdtd_tpu_torch/spans.py``): a monitored,
resumed ``run_simulation`` call under ``torch.profiler`` opens every span
of the runner and the chunk loop, nested and ordered as the benchmark's
readers take them; with no profiler no range is entered and the outputs
are those of the traced call, bit for bit."""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu_torch import spans  # noqa: E402
from fdtd_tpu_torch.dft import DftConfig  # noqa: E402
from fdtd_tpu_torch.monitors import ProbeSet  # noqa: E402
from fdtd_tpu_torch.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu_torch.runner import run_simulation  # noqa: E402
from fdtd_tpu_torch.state import water_block  # noqa: E402

RATE = 10  # output (and checkpoint) interval, so one chunk a record
RESUME_AT = 10

LOOP_SPANS = {spans.RUN, spans.RESOLVE, spans.RUNNER_BUILD, spans.COEFS, spans.STATE_ALLOC, spans.RESUME,
              spans.LOOP, spans.CHUNK, spans.ENERGY_LOG, spans.PROBE_ROWS, spans.SNAPSHOT, spans.CHECKPOINT,
              spans.FINALIZE, spans.SAR_INCREMENT, spans.PROBE_GATHER}


def _scene() -> Params:
    """16^3, fp32, 30 steps, the energy log every 10."""
    return Params(length=0.016, width=0.016, height=0.016, spatial_step=1e-3, time_step=1e-12,
                  simulation_time=29.5e-12, sampling_rate=RATE, mode=Mode.COMPUTATION, dtype="float32")


def _kw(p: Params, shard):
    return dict(materials=water_block(p), accumulate_power=True, dft=DftConfig((2.45e10, 1.5e10)),
                probes=ProbeSet(((4, 8, 8),)), checkpoint_every=RATE, log=lambda m: None, shard=shard)


def _checkpointed(tmp_path, p: Params, shard) -> str:
    """A run directory whose latest checkpoint is step RESUME_AT."""
    out = tmp_path / "first"
    run_simulation(p, "cpu", out_dir=str(out), write_snapshots=False, **_kw(p, shard))
    for f in out.glob("ckpt*.npz"):
        if int(f.stem[4:]) > RESUME_AT:
            f.unlink()
    return str(out)


def _resumed(src: str, dst, p: Params, shard):
    shutil.copytree(src, dst)
    diag = str(dst / "energy.jsonl")
    res = run_simulation(p, "cpu", out_dir=str(dst), write_snapshots=True, resume=True, diagnostics_log=diag,
                         **_kw(p, shard))
    with open(diag) as f:
        return res, sum(1 for line in f if line.strip())


def _host_ranges(prof) -> dict:
    """{name: [(start_ns, end_ns), ...]} of the profile's host events."""
    cpu = torch.autograd.DeviceType.CPU
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu:
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def _outputs(res) -> dict:
    return {"state": [t.clone() for t in res.state.tensors()], "power": res.power_j.clone(),
            "phasors": res.dft.phasors.copy(), "probes": res.probes.values.copy()}


@pytest.mark.parametrize("shard", [None, "2"])
def test_spans_nest_and_count_as_the_readers_take_them(tmp_path, shard):
    p = _scene()
    src = _checkpointed(tmp_path, p, shard)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res, records = _resumed(src, tmp_path / "traced", p, shard)
    got = _host_ranges(prof)
    want = LOOP_SPANS | ({spans.GATHER, spans.HALO_EXCHANGE} if shard else set())
    assert want <= set(got), sorted(want - set(got))

    (run,), (loop,) = got[spans.RUN], got[spans.LOOP]
    for name in (spans.RESOLVE, spans.RUNNER_BUILD, spans.COEFS, spans.STATE_ALLOC, spans.RESUME):
        for s, e in got[name]:
            assert run[0] <= s <= e <= loop[0], name
    for s, e in got[spans.COEFS]:  # inside the runner's build
        assert any(b0 <= s <= e <= b1 for b0, b1 in got[spans.RUNNER_BUILD])
    (fin,) = got[spans.FINALIZE]
    assert loop[1] <= fin[0] <= fin[1] <= run[1]

    steps = len(time_values(p)) - RESUME_AT
    assert len(got[spans.CHUNK]) == -(-steps // RATE)
    assert all(loop[0] <= s <= e <= loop[1] for s, e in got[spans.CHUNK])
    assert len(got[spans.ENERGY_LOG]) == records == steps // RATE  # no record at step 0 on a resume
    assert len(got[spans.PROBE_ROWS]) == len(got[spans.CHUNK])
    assert len(got[spans.PROBE_GATHER]) == steps
    assert res.iterations == RESUME_AT + steps and res.probes.values.shape[0] == RESUME_AT + steps
    # the SAR increment keeps the name the benchmark reads
    assert spans.SAR_INCREMENT == "sar_increment" and len(got["sar_increment"]) >= steps


def test_untraced_run_enters_no_range_and_matches_the_traced_one(tmp_path, monkeypatch):
    p = _scene()
    src = _checkpointed(tmp_path, p, None)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced, _ = _resumed(src, tmp_path / "traced", p, None)
    want = _outputs(traced)

    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    plain, _ = _resumed(src, tmp_path / "plain", p, None)
    got = _outputs(plain)
    for a, b in zip(got["state"], want["state"]):
        assert torch.equal(a, b)
    assert torch.equal(got["power"], want["power"])
    np.testing.assert_array_equal(got["phasors"], want["phasors"])
    np.testing.assert_array_equal(got["probes"], want["probes"])


def test_span_is_a_shared_null_context_without_a_profiler():
    assert spans.span(spans.LOOP) is spans.span(spans.CHUNK)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span(spans.LOOP):
            torch.ones(2).add_(1)
    assert spans.LOOP in _host_ranges(prof)


def test_span_names_are_distinct_and_the_old_labels_stay():
    from fdtd_tpu_torch import diagnostics
    from fdtd_tpu_torch.parallel import mesh

    names = [v for k, v in vars(spans).items() if k.isupper() and isinstance(v, str)]
    assert len(names) == len(set(names)) == 18
    assert all(n.startswith("fdtd.") for n in names if n not in ("sar_increment", "halo_exchange", "probe_gather"))
    assert diagnostics.SAR_LABEL == "sar_increment" and mesh.HALO_LABEL == "halo_exchange"
