"""The means mode of the sweeps' DFT bands (``StreamPlan.fold``) and the fold
kernel's plain version (``ops/dft.py::plain_fold``), on the CPU.

- coverage: on grids of 12^3 to 256^3 (``configs/bench_256.txt`` and
  ``configs/heating_256.txt`` scaled to n^3) and 1 to 32 frequencies,
  every (variant, grid, dtype, nf) that the JAX package's plan functions
  stream (``pallas_stream.pick_plan``, ``pallas_stream_pml.
  pick_pml_stream_s``, ``pallas_dispersive.pick_ade_plan`` and the
  full-plane ``pick_shard_plan`` of ``sharded_stream_dft_supported`` on a
  4-slab mesh) streams in the port too: every one of them fits an H100's
  80 GB in the port's memory model;
- the port against itself, fp32 bit for bit: with six frequencies (past
  every built shape's bands) stream on the means route = twopass + plain
  K4 = torch for every variant (fields, sums, SAR map, psi, P), with a
  fold depth that does not divide the chunk, and sharded = unsharded on
  1-D and 2-D meshes;
- checkpoints: a run checkpointed in the middle of the buffer resumes to
  the uninterrupted run's bits, and resumes across the packages;
- the plans, the memory model and the routing of the means mode, and the
  fold's checks.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import dft as jdft  # noqa: E402
from fdtd_tpu.ops import pallas_dispersive as jpd  # noqa: E402
from fdtd_tpu.ops import pallas_stream as jps  # noqa: E402
from fdtd_tpu.ops import pallas_stream_pml as jpp  # noqa: E402
from fdtd_tpu.ops.cpml import PMLConfig as JPMLConfig  # noqa: E402
from fdtd_tpu.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu.parallel import sharded_fast as jsf  # noqa: E402
from fdtd_tpu.runner import run_simulation as j_run  # noqa: E402
from fdtd_tpu.state import update_coefs as j_update_coefs  # noqa: E402
from fdtd_tpu_torch import convert, dft, runner  # noqa: E402
from fdtd_tpu_torch.grid import COMPONENTS  # noqa: E402
from fdtd_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from fdtd_tpu_torch.ops import dft as dft_ops  # noqa: E402
from fdtd_tpu_torch.ops import stream, stream_plan  # noqa: E402
from fdtd_tpu_torch.ops.cpml import PMLConfig, init_psi  # noqa: E402
from fdtd_tpu_torch.ops.dispersive import DebyeMaterials, water_debye_load, zero_polarization  # noqa: E402
from fdtd_tpu_torch.parallel import mesh as M  # noqa: E402
from fdtd_tpu_torch.parallel import sharded_fast  # noqa: E402
from fdtd_tpu_torch.state import ferrite_slab, water_block  # noqa: E402
from fdtd_tpu_torch.step import make_chunk_runner, scan_inputs, zero_power_acc  # noqa: E402

NF6 = tuple(2.40e10 + 2e8 * k for k in range(6))  # six frequencies: more than any built shape's bands hold


def _box(n, steps, dtype="float32"):
    return Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=1e-3, time_step=1e-12,
                  simulation_time=(steps - 0.5) * 1e-12, sampling_rate=10**9, mode=Mode.COMPUTATION, dtype=dtype)


# --- coverage against the JAX package's plan functions --------------------------------------------

GRIDS = (12, 16, 24, 32, 48, 64, 96, 128, 160, 192, 224, 256)
# variant: (lossy, het, sar, pml, ade, shard)
COVERAGE = {
    "K3-DFT": (False, False, False, False, False, False),
    "K3-lossy-DFT": (True, False, False, False, False, False),
    "K3-lossy-SAR-DFT": (True, False, True, False, False, False),
    "K3-het-DFT": (True, True, False, False, False, False),
    "K3-het-SAR-DFT": (True, True, True, False, False, False),
    "K11-DFT": (False, False, False, True, False, False),
    "K11-lossy-DFT": (True, False, False, True, False, False),
    "K12-DFT": (False, False, False, False, True, False),
    "K12-SAR-DFT": (False, False, True, False, True, False),
    "K3-DFT-shard": (False, False, False, False, False, True),
    "K3-lossy-DFT-shard": (True, False, False, False, False, True),
    "K3-lossy-SAR-DFT-shard": (True, False, True, False, False, True),
    "K3-het-DFT-shard": (True, True, False, False, False, True),
    "K3-het-SAR-DFT-shard": (True, True, True, False, False, True),
}


def _jax_streams(jp, lossy, het, sar, pml, ade, shard):
    """nf -> whether the JAX package's plan function streams the scene with
    nf phasor bands (``_shard_config_gates`` and ``pick_plan`` look only at
    whether ca and hf are arrays, so a stand-in array marks the media)."""
    coefs = j_update_coefs(jp)
    if lossy:
        coefs = dataclasses.replace(coefs, ca_x=np.zeros(1), hf_x=np.zeros(1) if het else None)
    if pml is not None:
        return lambda nf: jpp.pick_pml_stream_s(jp, pml, lossy, nf) is not None
    if ade:
        return lambda nf: jpd.pick_ade_plan(jp, sar, nf) is not None
    if shard:
        klp = jsf._geometry(jp, 4)[4]  # sharded_stream_dft_supported's full-plane per-shard plan on 4 slabs
        return lambda nf: (jps.pick_shard_plan(jp, coefs, klp, sar=sar, dft_nf=nf) or (0, 0))[1] == 1
    return lambda nf: jps.pick_plan(jp, coefs, sar, nf) is not None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(COVERAGE))
def test_port_streams_every_frequency_count_the_jax_package_streams(variant, dtype):
    lossy, het, sar, pml_v, ade, shard = COVERAGE[variant]
    mesh = M.make_mesh((4, 1, 1), "cpu") if shard else None
    streamed = means = 0
    for n in GRIDS:
        jp = _box(n, 4, dtype)
        tp = convert.params_from(jp)
        cells = max(1, round(10 * n / 256))  # --pml 10 at 256^3, scaled
        pml = PMLConfig(cells=cells) if pml_v else None
        if pml_v and not jpp.stream_pml_supported(jp, JPMLConfig(cells=cells)):
            continue  # the source patch reaches into the j or i slabs: neither package streams the scene
        jax = _jax_streams(jp, lossy, het, sar, JPMLConfig(cells=cells) if pml_v else None, ade, shard)
        for nf in range(1, 33):
            if not jax(nf):
                continue
            cfg = dft.DftConfig(tuple(1e9 * (k + 1) for k in range(nf)))
            if shard:
                plans = sharded_fast.pick_shard_plan(tp, mesh, None, lossy, het, sar, {}, cfg)
                plan = plans[0] if plans else None
            else:
                plan = stream_plan.pick_plan(tp, lossy=lossy, het=het, sar=sar, pml=pml, ade=ade, dft=cfg)
            assert plan is not None and plan.dft, (variant, n, dtype, nf)
            assert (plan.fold > 0) == (nf > plan.dft_max_nf), (variant, n, nf, plan.kernel)
            assert plan.kernel.endswith("_dft_means" if plan.fold else "_dft")
            streamed += 1
            means += plan.fold > 0
    assert streamed > 100 and means > 50, (streamed, means)  # the JAX package streams these counts, the bands hold few


def test_means_plans_count_the_buffer_in_memory_and_bytes():
    p = convert.params_from(_box(256, 4))
    sixteen = dft.DftConfig(tuple(2.40e10 + 6.25e7 * k for k in range(16)))
    plan = stream_plan.pick_plan(p, dft=sixteen)
    assert (plan.kernel, plan.s, plan.fold) == ("yee_stream_dft_means", 4, stream_plan.FOLD_DEPTH)
    # the bands' shape (BLOCK_J_DFT: wider tiles measured slower), the
    # cell-mean column, and no sums in shared memory
    assert (plan.bj, plan.tj, plan.ti, plan.means) == (stream_plan.BLOCK_J_DFT[4], plan.bj - 9, 32 - 9, True)
    bands = stream_plan.plan_for(p, plan.s, dft=sixteen, bj=plan.bj)  # the bands at the means mode's shape
    assert plan.smem_bytes == bands.smem_bytes and plan.dft_smem_bytes(16) == 0 and plan.dft_max_nf == 0
    assert stream_plan.plan_for(p, plan.s, dft=sixteen).dft_max_nf == 2  # the bands at their own shape
    cells = p.maxk * p.maxj * p.maxi
    assert stream_plan.means_bytes(p, 32) == 12 * 32 * cells
    assert (stream_plan.stream_bytes(p, dft=sixteen, fold=32) - stream_plan.stream_bytes(p, dft=sixteen)
            == 12 * 32 * cells)
    # per step: the bands' sums read and written once a sweep against the
    # means written and read (24 B) and the sums once a fold (48 * nf / D B)
    padded = np.prod(p.padded_shape)
    assert plan.bytes_per_cell_step - bands.bytes_per_cell_step == pytest.approx(
        (24 + 2 * 8 * 16 * 3 / 32) * cells / padded - 8 * 16 * 3 * cells / padded / 4, rel=1e-12)
    # the lossy CPML sweep's shell and interior take the coefficient ring, which the bands have no room for
    pml = stream_plan.pick_plan(p, lossy=True, pml=PMLConfig(cells=10), dft=sixteen)
    assert pml.fold and pml.cr and pml.core.cr and not stream_plan.plan_for(p, 2, lossy=True, pml=PMLConfig(cells=10),
                                                                            dft=sixteen).cr
    # the buffer is as deep as memory allows, a multiple of s
    tight = stream_plan.stream_bytes(p, dft=sixteen, fold=12) / stream_plan.MEMORY_MARGIN
    assert stream_plan.pick_plan(p, dft=sixteen, memory_bytes=int(tight) + 1).fold == 12
    assert stream_plan.pick_plan(p, dft=sixteen, memory_bytes=int(stream_plan.stream_bytes(p, dft=sixteen))) is None
    # nf within the bands keeps them, at every variant
    assert stream_plan.pick_plan(p, dft=dft.DftConfig((1e9, 2e9))).fold == 0
    assert stream_plan.pick_plan(p, lossy=True, sar=True, dft=dft.DftConfig((1e9, 2e9, 3e9))).fold == 0
    with pytest.raises(ValueError, match="whole sweeps"):
        stream_plan.plan_for(p, 4, dft=sixteen, fold=6)
    # a shard's buffer counts its cells
    mesh = M.make_mesh((4, 1, 1), "cpu")
    plans = sharded_fast.pick_shard_plan(p, mesh, None, True, False, True, {}, sixteen)
    assert plans[0].kernel == "yee_stream_lossy_sar_dft_means" and plans[0].fold == stream_plan.FOLD_DEPTH
    boxes = M.shard_boxes(p, mesh, plans[0].s + 1)
    shapes = [(b.shape, int(np.prod(b.cell_shape(p)))) for b in boxes]
    need = [stream_plan.shard_bytes(p, shapes, mesh.devices, mesh.devices[0], True, True, False, True, dft=sixteen,
                                    fold=f) for f in (0, 32)]
    assert sum(need[1].values()) - sum(need[0].values()) == 12 * 32 * cells


def test_shards_of_three_planes_stream_the_vacuum_bands_at_s2():
    """12 planes over four shards: the vacuum sweep with the bands runs at
    s = 2 (the CPML interior's box shape), as the s = 4 halo needs five."""
    p = convert.params_from(_box(11, 4))
    plans = sharded_fast.pick_shard_plan(p, M.make_mesh((4, 1, 1), "cpu"), None, dft=dft.DftConfig((1e9,)))
    assert (plans[0].kernel, plans[0].s, plans[0].bj, plans[0].fold) == ("yee_stream_dft", 2, 24, 0)
    assert stream_plan.built_depths(False, True) == (4,) and stream_plan.built_depths(False, True, True) == (4, 2)


@pytest.mark.parametrize("nf", [3, 4, 5])
def test_shards_that_admit_s4_take_its_means_mode_before_the_s2_bands(nf):
    """Past the s = 4 bands' two frequencies, vacuum shards that admit the
    s = 4 halo take its means mode, as the unsharded picker does; the
    s = 2 bands only serve shards too thin for it (16 planes over four)."""
    cfg = dft.DftConfig(tuple(1e9 * (k + 1) for k in range(nf)))
    mesh = M.make_mesh((4, 1, 1), "cpu")
    for n in (64, 256):
        p = convert.params_from(_box(n, 4))
        plan = sharded_fast.pick_shard_plan(p, mesh, None, dft=cfg)[0]
        assert (plan.kernel, plan.s, plan.fold) == ("yee_stream_dft_means", 4, stream_plan.FOLD_DEPTH), n
        assert (plan.kernel, plan.s) == (stream_plan.pick_plan(p, dft=cfg).kernel, stream_plan.pick_plan(p, dft=cfg).s)
    thin = sharded_fast.pick_shard_plan(convert.params_from(_box(15, 4)), mesh, None, dft=cfg)[0]
    assert (thin.kernel, thin.s, thin.fold) == ("yee_stream_dft", 2, 0)


# --- the port against itself, fp32 bit for bit ------------------------------------------------------

def _port_chunk(p, mats, backend, steps, cfg, sar=False, pml=None, split=None):
    tv = time_values(p)[:steps]
    xs = scan_inputs(p, tv) + dft.dft_weights(cfg, tv)
    s = convert.state_from_numpy({c: np.zeros(p.padded_shape) for c in COMPONENTS}, "cpu", torch.float32)
    power = zero_power_acc(p, "cpu") if sar else None
    psi = init_psi(p, pml, "cpu") if pml is not None else None
    pol = zero_polarization(p, "cpu") if isinstance(mats, DebyeMaterials) else None
    sums = dft.zero_dft_acc(p, cfg, "cpu")
    run = make_chunk_runner(p, "cpu", mats, backend, accumulate_power=sar, pml=pml, dft=cfg)
    for a, b in ((0, split), (split, steps)) if split else ((0, steps),):
        run(s, tuple(x[a:b] for x in xs), power, psi, pol, sums)
    return run, (s, power, psi, pol, sums)


def _equal(got, want, label):
    for g, w in zip(got, want):
        if w is None:
            assert g is None, label
            continue
        gs = g.tensors() if hasattr(g, "tensors") else g if isinstance(g, tuple) else (g,)
        ws = w.tensors() if hasattr(w, "tensors") else w if isinstance(w, tuple) else (w,)
        for a, b in zip(gs, ws):
            assert torch.equal(a, b), label


_VARIANTS = {
    "vacuum": dict(), "water": dict(mats="water"), "water_sar": dict(mats="water", sar=True),
    "ferrite": dict(mats="ferrite"), "ferrite_sar": dict(mats="ferrite", sar=True), "pml": dict(pml=1),
    "water_pml": dict(mats="water", pml=1), "debye": dict(mats="debye"), "debye_sar": dict(mats="debye", sar=True),
}


def _scene(p, kw):
    mats = {"water": water_block(p), "ferrite": ferrite_slab(p, base=water_block(p)),
            "debye": water_debye_load(p), None: None}[kw.get("mats")]
    return mats, kw.get("sar", False), PMLConfig(cells=kw["pml"]) if "pml" in kw else None


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_means_stream_equals_twopass_plus_k4_equals_torch(variant):
    """fp32, six frequencies, 23 steps (sweeps and trailing two-pass steps
    with K4): the plain means-mode sweep and plain fold = the plain
    two-pass steps with K4's plain version = torch, fields, sums, SAR map,
    psi and P bit for bit."""
    p = convert.params_from(_box(12, 23))
    mats, sar, pml = _scene(p, _VARIANTS[variant])
    cfg = dft.DftConfig(NF6)
    dft_ops.reset_launches()
    runs = {b: _port_chunk(p, mats, b, 23, cfg, sar, pml) for b in ("stream", "twopass", "torch")}
    plan = runs["stream"][0].plan
    assert plan.fold and plan.kernel.endswith("_dft_means") and 23 % plan.s and 6 > plan.dft_max_nf
    assert dft_ops.launches["dft_fold"] == 0  # CPU tensors: the plain versions
    assert float(runs["torch"][1][4][0].abs().max()) > 0
    for b in ("twopass", "torch"):
        _equal(runs["stream"][1], runs[b][1], (variant, b))


@pytest.mark.parametrize("variant, depth", [("vacuum", 8), ("water_sar", 6), ("pml", 6), ("debye_sar", 6)])
def test_fold_depth_that_does_not_divide_the_chunk(monkeypatch, variant, depth):
    """A buffer of ``depth`` levels folds mid-chunk (23 steps: full buffers,
    then the chunk's last levels, then trailing steps), split into chunks
    of 9 and 14 steps: equal to torch bit for bit."""
    monkeypatch.setattr(stream_plan, "FOLD_DEPTH", depth)
    p = convert.params_from(_box(12, 23))
    mats, sar, pml = _scene(p, _VARIANTS[variant])
    cfg = dft.DftConfig(NF6)
    run, got = _port_chunk(p, mats, "stream", 23, cfg, sar, pml, split=9)
    assert run.plan.fold == depth and 14 // run.plan.s * run.plan.s % depth
    _, want = _port_chunk(p, mats, "torch", 23, cfg, sar, pml)
    _equal(got, want, variant)


def _sharded(p, mats, sar, cfg, shape, arrays, steps=19, split=7):
    s = convert.state_from_numpy(arrays, "cpu", torch.float32)
    ts, amps = scan_inputs(p, time_values(p)[:steps])
    xs = (ts, amps) + dft.dft_weights(cfg, ts)
    power = zero_power_acc(p, "cpu") if sar else None
    dacc = dft.zero_dft_acc(p, cfg, "cpu")
    if shape is None:
        run = make_chunk_runner(p, "cpu", mats, "torch", accumulate_power=sar, dft=cfg)
    else:
        mesh = M.make_mesh(shape, "cpu")
        run = sharded_fast.make_sharded_stream_runner(p, mesh, mats, sar, dft=cfg)
        assert run.plans[0].fold and run.plans[0].kernel.endswith("_dft_means")
        shards = M.scatter(p, s, mesh, run.depth, power, None, None, None, dacc)
    for a, b in ((0, split), (split, steps)):
        chunk = tuple(x[a:b] for x in xs)
        run(s, chunk, power, None, None, dacc) if shape is None else run(shards, chunk)
    if shape is not None:
        M.gather(p, shards, s, power, None, None, None, dacc)
    return s, power, dacc


@pytest.mark.parametrize("sar", [False, True])
@pytest.mark.parametrize("shape", [(2, 1, 1), (4, 1, 1), (2, 2, 1)])
def test_sharded_means_equals_unsharded(shape, sar):
    """Random fields on 11 x 11 x 12 planes (3 a shard over four) with six
    frequencies: the per-shard means-mode sweeps and folds (plain versions
    on CPU shards), in two chunks, equal the unsharded torch run."""
    p = convert.params_from(Params(length=0.01, width=0.01, height=0.0115, spatial_step=0.001, time_step=1e-12,
                                   simulation_time=18.5e-12, sampling_rate=10**6, mode=Mode.COMPUTATION,
                                   dtype="float32"))
    mats = water_block(p, lo=(0.2,) * 3, hi=(0.8,) * 3) if sar else None
    rng = np.random.default_rng(14)
    arrays = {c: rng.uniform(-1.0, 1.0, p.padded_shape) for c in COMPONENTS}
    cfg = dft.DftConfig(NF6)
    got = _sharded(p, mats, sar, cfg, shape, arrays)
    want = _sharded(p, mats, sar, cfg, None, arrays)
    _equal(got, want, shape)
    assert float(want[2][0].abs().max()) > 0


# --- checkpoints --------------------------------------------------------------------------------------

def _force_stream(monkeypatch):
    """run_simulation on the CPU with the stream chunk runner (its plain
    versions): resolve_backend sends the CPU to torch."""
    monkeypatch.setattr(runner, "resolve_backend", lambda *a, **k: "stream")


def test_resume_from_the_middle_of_the_buffer_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    """Checkpoints every 7 steps with an 8-level buffer and s = 4: each
    checkpoint lands with 4 levels buffered (folded at the chunk's end);
    the run resumed from step 14 equals the uninterrupted one bit for bit."""
    _force_stream(monkeypatch)
    monkeypatch.setattr(stream_plan, "FOLD_DEPTH", 8)
    p = dataclasses.replace(convert.params_from(_box(10, 21)), sampling_rate=7)
    kw = dict(write_snapshots=False, log=lambda m: None, dft=dft.DftConfig(NF6))
    full = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "a"), **kw)
    runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "b"), checkpoint_every=7, **kw)
    for f in glob.glob(str(tmp_path / "b" / "ckpt*.npz")):
        if int(os.path.basename(f)[4:-4]) > 14:
            os.remove(f)
    res = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "b"), resume=True, **kw)
    assert res.dft.steps == 21
    np.testing.assert_array_equal(res.dft.phasors, full.dft.phasors)
    for c in COMPONENTS:
        assert torch.equal(getattr(res.state, c), getattr(full.state, c)), c


def test_chunk_runner_sizes_the_buffer_for_the_memory_resolve_backend_checked(tmp_path, monkeypatch):
    """With little device memory free, run_simulation's stream chunk
    runner takes the plan (and the buffer depth) that resolve_backend's
    memory check admitted, not the one an 80 GB card would; the run's
    phasors equal those of the full-depth buffer bit for bit."""
    p = dataclasses.replace(convert.params_from(_box(10, 21)), sampling_rate=7)
    cfg = dft.DftConfig(NF6)
    free = int(stream_plan.stream_bytes(p, dft=cfg, fold=8) / stream_plan.MEMORY_MARGIN) + 1
    monkeypatch.setattr(runner, "_free_memory", lambda dev: free)
    assert runner.resolve_backend(p, "stream", "cuda", dft=cfg) == "stream"
    checked = stream_plan.pick_plan(p, memory_bytes=free, dft=cfg)
    assert checked.fold == 8 < stream_plan.pick_plan(p, dft=cfg).fold
    from fdtd_tpu_torch import step

    made = []
    chunk_runner = step._stream_chunk_runner

    def spy(pp, device, plan, *a, **k):
        made.append(plan)
        return chunk_runner(pp, device, plan, *a, **k)

    monkeypatch.setattr(step, "_stream_chunk_runner", spy)
    _force_stream(monkeypatch)
    kw = dict(write_snapshots=False, log=lambda m: None, dft=cfg)
    tight = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "a"), **kw)
    assert [m.fold for m in made] == [checked.fold]
    monkeypatch.setattr(runner, "_free_memory", lambda dev: None)
    full = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "b"), **kw)
    assert made[-1].fold == stream_plan.FOLD_DEPTH
    np.testing.assert_array_equal(tight.dft.phasors, full.dft.phasors)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_means_checkpoints_resume_across_packages(tmp_path, monkeypatch, writer):
    """A six-frequency run checkpointed after step 14 by one package (the
    port on the means route) resumes in the other; its phasors equal the
    reader's uninterrupted run at the fp32 bar (1e-6 of the scale)."""
    _force_stream(monkeypatch)
    jp = dataclasses.replace(_box(8, 21), sampling_rate=7)
    tp = convert.params_from(jp)
    out = tmp_path / "ck"
    quiet = dict(write_snapshots=False, log=lambda m: None)
    if writer == "jax":
        j_run(jp, out_dir=str(out), checkpoint_every=7, backend="xla", dft=jdft.DftConfig(NF6), **quiet)
    else:
        t = runner.run_simulation(tp, "cpu", out_dir=str(out), checkpoint_every=7, dft=dft.DftConfig(NF6), **quiet)
        assert t.dft.steps == 21
    for f in glob.glob(str(out / "ckpt*.npz")):
        if int(os.path.basename(f)[4:-4]) > 14:
            os.remove(f)
    assert tckpt.load_aux(tckpt.latest_checkpoint(str(out)))["dft_re"].shape == (6, 3, 8, 8, 8)
    if writer == "jax":
        resumed = runner.run_simulation(tp, "cpu", out_dir=str(out), resume=True, dft=dft.DftConfig(NF6), **quiet)
        full = runner.run_simulation(tp, "cpu", out_dir=str(tmp_path / "full"), dft=dft.DftConfig(NF6), **quiet)
    else:
        resumed = j_run(jp, out_dir=str(out), resume=True, backend="xla", dft=jdft.DftConfig(NF6), **quiet)
        full = j_run(jp, out_dir=str(tmp_path / "full"), backend="xla", dft=jdft.DftConfig(NF6), **quiet)
    assert resumed.dft.steps == 21
    scale = float(np.abs(full.dft.phasors).max())
    assert scale > 0
    np.testing.assert_allclose(resumed.dft.phasors, full.dft.phasors, rtol=0, atol=1e-6 * scale)


# --- the fold and the sweep's means ---------------------------------------------------------------

def _ragged_params():
    """A ragged 7 x 9 x 10-cell grid."""
    return convert.params_from(Params(length=0.0105, width=0.0095, height=0.0075, spatial_step=0.001,
                                      time_step=1e-12, simulation_time=10.5e-12, sampling_rate=10**6,
                                      mode=Mode.COMPUTATION, dtype="float32"))


def _fold_case():
    """Random levels of cell means (8 of them), weights of 5 levels and 4
    frequencies (a depth that divides nothing) and "eh" sums on a ragged
    grid, and the sums after dft.accumulate of each level in step order."""
    p = _ragged_params()
    rng = np.random.default_rng(7)
    means = torch.tensor(rng.uniform(-1, 1, stream.means_shape(p, 8)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(-1, 1, (5, 2, 4)), dtype=torch.float32)
    acc0 = tuple(torch.tensor(rng.uniform(-1, 1, (4, 6, p.maxk, p.maxj, p.maxi)), dtype=torch.float32)
                 for _ in range(2))
    want = tuple(a.clone() for a in acc0)
    for d in range(5):
        dft.accumulate(tuple(means[d]), w[d, 0], w[d, 1], want)
    return p, means, w, acc0, want


def test_plain_fold_is_the_per_step_accumulation():
    p, means, w, acc0, want = _fold_case()
    got = tuple(a.clone() for a in acc0)
    dft_ops.fold(means, w, got)
    _equal(got, want, "fold")
    assert torch.equal(got[0][:, 3:], acc0[0][:, 3:])  # the H components of "eh" stay
    assert dft_ops.launches["dft_fold"] == 0
    for bad_w, bad_m, msg in ((torch.zeros(5, 2, 3), means, "weights"), (w, means[:4], "means buffer"),
                              (torch.zeros(33, 2, 4), torch.zeros((33, 3, p.maxk, p.maxj, p.maxi)), "means buffer"),
                              (w, means.double(), "means buffer"), (w, torch.zeros((8, 3) + p.padded_shape), "means")):
        with pytest.raises(ValueError, match=msg):
            dft_ops.fold(bad_m, bad_w, got)


@pytest.mark.parametrize("mesh", [(2, 1, 1), (3, 1, 1), (2, 2, 1)])
def test_plain_fold_of_a_shards_part(mesh):
    """Each shard folds its part of the buffer into its part of the sums
    (the fold sees cells only): the whole grid's sums there, bit for bit."""
    p, means, w, acc0, want = _fold_case()
    for box in M.shard_boxes(p, M.make_mesh(mesh, "cpu"), 1):
        part = (slice(None),) * 2 + tuple(slice(a, b) for a, b in zip(*box.cells(p)))
        got = tuple(a[part].contiguous() for a in acc0)
        assert stream.means_shape(p, 8, box)[2:] == got[0].shape[2:]
        dft_ops.fold(means[part].contiguous(), w, got)
        _equal(got, tuple(a[part] for a in want), f"fold {box}")


@pytest.mark.parametrize("sar", [False, True])
@pytest.mark.parametrize("mesh", [None, (2, 1, 1), (2, 2, 1)])
def test_plain_sweep_writes_each_steps_cell_means_into_the_buffer(mesh, sar):
    """plain_sweep(means=) writes each step's E cell means (of the working
    copy) into its level of the buffer: the last level is the output's
    means, a shard's levels are the whole grid's over its cells (its halo
    gives the plane past its window), and the fold of the levels adds what
    the bands add."""
    from fdtd_tpu_torch import diagnostics
    from fdtd_tpu_torch.parallel.sharded_step import shard_coefs
    from fdtd_tpu_torch.state import FieldState, update_coefs

    p = _ragged_params()
    rng = np.random.default_rng(8)
    mats = water_block(p, lo=(0.2,) * 3, hi=(0.8,) * 3) if sar else None
    coefs = update_coefs(p, mats, "cpu")
    canon = convert.state_from_numpy({c: rng.uniform(-1.0, 1.0, p.padded_shape) for c in COMPONENTS}, "cpu",
                                     torch.float32)
    w = torch.tensor(rng.uniform(-1, 1, (2, 2, 2)), dtype=torch.float32)
    whole = torch.full(stream.means_shape(p, 2), float("nan"))
    out = stream.plain_sweep(p, canon, coefs, 2, None, None, torch.zeros((p.maxk, p.maxj, p.maxi)) if sar else None,
                             means=whole)
    _equal(tuple(whole[1]), diagnostics._e_cell_means(p, out), "the last level: the output's cell means")
    sums_m, sums_b = (tuple(torch.zeros((2, 3, p.maxk, p.maxj, p.maxi)) for _ in range(2)) for _ in range(2))
    dft_ops.fold(whole, w, sums_m)
    stream.plain_sweep(p, canon, coefs, 2, None, None, torch.zeros((p.maxk, p.maxj, p.maxi)) if sar else None,
                       dacc=sums_b, wts=w)
    _equal(sums_m, sums_b, "the fold of the levels == the bands")
    for box in ([] if mesh is None else [sh.box for sh in M.scatter(p, canon, M.make_mesh(mesh, "cpu"), 3)]):
        st = FieldState(*(t[tuple(map(slice, box.lo, box.hi))].clone() for t in canon.tensors()))
        buf = torch.full(stream.means_shape(p, 2, box), float("nan"))
        stream.plain_sweep(p, st, shard_coefs(p, coefs, box, "cpu") if sar else coefs, 2, None, None,
                           torch.zeros(box.cell_shape(p)) if sar else None, box=box, means=buf)
        part = (slice(None),) * 2 + tuple(slice(a, b) for a, b in zip(*box.cells(p)))
        _equal(buf, whole[part], f"a shard's levels, {box}")


def test_sweep_checks_its_means():
    p = convert.params_from(_box(12, 4))
    cfg = dft.DftConfig(NF6)
    plan = stream_plan.pick_plan(p, dft=cfg)
    bands = stream_plan.pick_plan(p, dft=dft.DftConfig((1e9,)))
    from fdtd_tpu_torch.state import FieldState, update_coefs

    s = convert.state_from_numpy({c: np.zeros(p.padded_shape) for c in COMPONENTS}, "cpu", torch.float32)
    out = FieldState(*(torch.empty_like(t) for t in s.tensors()))
    means = torch.zeros(stream.means_shape(p, plan.s))
    assert means.shape == (plan.s, 3, p.maxk, p.maxj, p.maxi)
    sums = dft.zero_dft_acc(p, cfg, "cpu")
    with pytest.raises(ValueError, match="means-mode"):
        stream.sweep(p, s, out, update_coefs(p), plan, dacc=sums, wts=torch.zeros((plan.s, 2, 6)))
    with pytest.raises(ValueError, match="means-mode"):
        stream.sweep(p, s, out, update_coefs(p), bands, means=means)
    with pytest.raises(ValueError, match="means buffer's slice"):
        stream.sweep(p, s, out, update_coefs(p), plan, means=means[:1])
    stream.sweep(p, s, out, update_coefs(p), plan, means=means)
    assert stream.launches[plan.kernel] == 0


@pytest.mark.parametrize("case, backend, kw, want, notice", [
    ("sixteen frequencies stream", "stream", dict(nf=16), "stream", None),
    ("sixteen frequencies auto", "auto", dict(nf=16), "stream", None),
    ("heating 32 auto", "auto", dict(nf=32, mats="water", sar=True), "stream", None),
    ("pml 32 auto", "auto", dict(nf=32, pml=True), "stream", None),
    ("debye 32 auto", "auto", dict(nf=32, mats="debye", sar=True), "stream", None),
    ("sums past memory", "stream", dict(nf=1, n=1024), "twopass",
     "notice: the DFT bands of the stream sweep do not fit this scene; running the twopass kernels with the "
     "dft_accum kernel (backend 'stream' ignored)"),
])
def test_routing_of_the_means_mode(case, backend, kw, want, notice):
    p = convert.params_from(_box(kw.get("n", 256), 4))
    mats = {"water": water_block, "debye": water_debye_load, None: lambda p: None}[kw.get("mats")](p)
    cfg = dft.DftConfig(tuple(2.40e10 + 1e8 * k for k in range(kw["nf"])))
    notices = []
    got = runner.resolve_backend(p, backend, "cuda", mats, kw.get("sar", False),
                                 PMLConfig(cells=10) if kw.get("pml") else None, notices.append, cfg)
    assert got == want, case
    assert notices == ([notice] if notice else []), case
