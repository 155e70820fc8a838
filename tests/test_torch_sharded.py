"""Spatial sharding (``--shard``) of the port, against the JAX package and
against the port's own unsharded runs.

- The sharded ``torch`` path in fp64 matches the JAX package's shard_map
  ground truth (``fdtd_tpu.parallel.sharded_step.make_sharded_chunk_runner``
  on the conftest's virtual CPU mesh) at rtol 1e-11 / atol 1e-15 (the two
  steps agree to reassociation level), on 1-, 2- and 3-axis meshes, in both
  modes, with lossy and heterogeneous-mu_r loads; the fp32 SAR map at rtol
  1e-6 (per-step increments rounded to fp32 from reductions in another
  order).
- In fp32 a sharded run equals the unsharded one bit for bit on ``torch``,
  ``twopass`` and ``stream`` (on CPU shards the kernels run their plain
  versions, given the shards' boxes), 1-D and 2-D meshes, ragged and even
  shards, vacuum and loads with SAR, over 19 steps (sweeps and trailing
  two-pass steps).
- The TPU's per-shard kernels in interpret mode (``make_sharded_fast_runner``,
  ``make_sharded_stream_runner`` with and without its j-tiling, the K3-shard-jt
  fold, and ``make_sharded_stream_2d_runner``) against the port's sharded
  runners at the JAX tests' bar (atol 1e-6, ``tests/test_sharded_fast.py``).
- ``run_simulation(shard=)`` and ``--shard`` write the unsharded snapshots;
  checkpoints move between sharded and unsharded runs and between the
  packages; bad specs give the JAX package's errors; Debye media with CPML
  keep the JAX package's refusal; the mesh, its exchange, the plan picker
  and the launch stream of the kernel wrappers.  (CPML, Debye media and the
  monitors under sharding: ``tests/test_torch_sharded_compose.py``.)
"""

import dataclasses
import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import runner as jrunner  # noqa: E402
from fdtd_tpu.io.vtr import read_vtr_cell_arrays  # noqa: E402
from fdtd_tpu.parallel import mesh as jmesh  # noqa: E402
from fdtd_tpu.parallel.sharded_step import make_sharded_chunk_runner as j_sharded_runner  # noqa: E402
from fdtd_tpu.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu.state import Materials as JMaterials  # noqa: E402
from fdtd_tpu.state import ferrite_slab, init_validation, water_block, zeros  # noqa: E402
from fdtd_tpu.step import scan_inputs  # noqa: E402
from fdtd_tpu_torch import cli, convert, runner  # noqa: E402
from fdtd_tpu_torch.grid import Box  # noqa: E402
from fdtd_tpu_torch.ops import build, stream, stream_plan, yee  # noqa: E402
from fdtd_tpu_torch.ops.cpml import PMLConfig  # noqa: E402
from fdtd_tpu_torch.ops.dispersive import water_debye_load  # noqa: E402
from fdtd_tpu_torch.parallel import mesh as M  # noqa: E402
from fdtd_tpu_torch.parallel import sharded_fast, sharded_step  # noqa: E402
from fdtd_tpu_torch.state import update_coefs  # noqa: E402
from fdtd_tpu_torch.step import make_chunk_runner, zero_power_acc  # noqa: E402

COMPONENTS = ("ex", "ey", "ez", "hx", "hy", "hz")
ATOL = 1e-6  # the JAX package's interpret-mode bar (tests/test_sharded_fast.py)


def _params(mode=Mode.COMPUTATION, dtype="float32", height=0.01):
    """The tiny scene (11 planes a side: 6 + 5 over two shards); ``height``
    0.0115 gives 12 planes along k (3 a shard over four)."""
    return Params(length=0.01, width=0.01, height=height, spatial_step=0.001, time_step=1e-12,
                  simulation_time=2e-11, sampling_rate=5, mode=mode, dtype=dtype)


def _scene(p, name):
    """(JAX materials or None, accumulate_power) of a scene name."""
    if name == "lossy":
        return JMaterials(sigma=np.ones((p.maxk, p.maxj, p.maxi))), False
    if name == "het":
        return ferrite_slab(p, base=water_block(p)), False
    if name == "sar":
        return water_block(p), True
    if name == "het_sar":
        return ferrite_slab(p, base=water_block(p)), True
    return None, False


def _initial(p):
    s = init_validation(p) if p.mode == Mode.VALIDATION else zeros(p)
    return {c: np.asarray(getattr(s, c)) for c in COMPONENTS}


def _port_sharded(p, arrays, shape, backend, mats=None, sar=False, steps=None, split=7):
    """The port's sharded run on CPU shards, in two chunks (split at step
    ``split``): (fields as numpy, the SAR map or None)."""
    tp = convert.params_from(p)
    dt = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}[p.dtype]
    s = convert.state_from_numpy(arrays, "cpu", dt)
    mesh = M.make_mesh(shape, "cpu")
    tm = convert.materials_from(mats) if mats is not None else None
    if backend == "stream":
        run = sharded_fast.make_sharded_stream_runner(tp, mesh, tm, sar)
    elif backend == "twopass":
        run = sharded_step.make_sharded_chunk_runner(tp, mesh, tm, sar, "twopass")
    else:
        run = sharded_step.make_sharded_chunk_runner(tp, mesh, tm, sar)
    power = zero_power_acc(tp, "cpu") if sar else None
    shards = M.scatter(tp, s, mesh, run.depth, power)
    ts, amps = scan_inputs(p, time_values(p)[:steps])
    run(shards, (ts[:split], amps[:split]))
    run(shards, (ts[split:], amps[split:]))
    M.gather(tp, shards, s, power)
    return convert.state_to_numpy(s), (power.numpy() if sar else None)


# -- the fp64 torch path against the JAX package's shard_map step -------------

@pytest.mark.parametrize("scene", ["validation", "computation", "lossy", "het", "sar"])
@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 1), (1, 2, 2)])
def test_sharded_torch_matches_jax_sharded_step(shape, scene):
    mode = Mode.VALIDATION if scene in ("validation", "lossy") else Mode.COMPUTATION
    p = _params(mode, "float64")
    mats, sar = _scene(p, scene)
    arrays = _initial(p)
    n = int(np.prod(shape))
    jm = jmesh.make_mesh(n, shape, devices=jax.devices("cpu"))
    run = j_sharded_runner(p, jm, mats, accumulate_power=sar)
    s0 = jmesh.pad_state_for_mesh(p, zeros(p) if mode == Mode.COMPUTATION else init_validation(p), jm)
    _, amps = scan_inputs(p, time_values(p))
    if sar:
        acc = jnp.zeros(jmesh.padded_divisible_shape(p, jm), jnp.float32)
        st, acc = run(s0, amps, acc)
        want_power = np.asarray(acc)[: p.maxk, : p.maxj, : p.maxi]
    else:
        st = run(s0, amps)
    want = jmesh.unpad_state(p, st)
    got, power = _port_sharded(p, arrays, shape, "torch", mats, sar)
    for c in COMPONENTS:
        np.testing.assert_allclose(got[c], np.asarray(getattr(want, c)), rtol=1e-11, atol=1e-15, err_msg=c)
    if sar:
        peak = float(want_power.max())
        assert peak > 0 and power.dtype == np.float32
        np.testing.assert_allclose(power, want_power, rtol=1e-6, atol=1e-6 * peak)


# -- fp32: sharded == unsharded, bit for bit, on every backend ----------------

_FP32_CASES = [
    ((2, 1, 1), "validation", 0.01),  # 11 planes: 6 + 5
    ((2, 1, 1), "computation", 0.01),
    ((4, 1, 1), "computation", 0.0115),  # 12 planes: 3 + 3 + 3 + 3
    ((3, 1, 1), "sar", 0.01),  # 4 + 4 + 3
    ((2, 2, 1), "computation", 0.01),  # j: 6 + 5
    ((2, 2, 1), "het_sar", 0.01),
    ((1, 3, 1), "het", 0.01),
]


@pytest.mark.parametrize("backend", ["torch", "twopass", "stream"])
@pytest.mark.parametrize("shape, scene, height", _FP32_CASES)
def test_sharded_fp32_equals_unsharded(backend, shape, scene, height):
    mode = Mode.VALIDATION if scene == "validation" else Mode.COMPUTATION
    p = _params(mode, "float32", height)
    mats, sar = _scene(p, scene)
    arrays = _initial(p)
    if mats is not None:  # random fields, so every cell of the load deposits from the first step
        rng = np.random.default_rng(5)
        arrays = {c: rng.uniform(-1.0, 1.0, a.shape) for c, a in arrays.items()}
    tp = convert.params_from(p)
    s = convert.state_from_numpy(arrays, "cpu", torch.float32)
    power = zero_power_acc(tp, "cpu") if sar else None
    tm = convert.materials_from(mats) if mats is not None else None
    make_chunk_runner(tp, "cpu", tm, "torch", accumulate_power=sar)(s, scan_inputs(p, time_values(p)[:19]), power)
    got, got_power = _port_sharded(p, arrays, shape, backend, mats, sar, steps=19)
    for c in COMPONENTS:
        np.testing.assert_array_equal(got[c], getattr(s, c).numpy(), err_msg=c)
    if sar:
        assert float(power.max()) > 0
        np.testing.assert_array_equal(got_power, power.numpy())


def test_sharded_bf16_stream_equals_unsharded_stream():
    """bf16: a sweep keeps its levels in fp32 and rounds once, so the
    sharded sweep equals the unsharded one bit for bit."""
    p = _params(Mode.COMPUTATION, "bfloat16")
    arrays = _initial(p)
    tp = convert.params_from(p)
    s = convert.state_from_numpy(arrays, "cpu", torch.bfloat16)
    make_chunk_runner(tp, "cpu", backend="stream", stream_s=4)(s, scan_inputs(p, time_values(p)[:16]))
    mesh = M.make_mesh((2, 2, 1), "cpu")
    run = sharded_fast.make_sharded_stream_runner(tp, mesh, s=4)
    st = convert.state_from_numpy(arrays, "cpu", torch.bfloat16)
    shards = M.scatter(tp, st, mesh, run.depth)
    run(shards, scan_inputs(p, time_values(p)[:16]))
    M.gather(tp, shards, st)
    for a, b in zip(st.tensors(), s.tensors()):
        assert torch.equal(a, b)


# -- the TPU's per-shard kernels in interpret mode ----------------------------

@pytest.mark.parametrize("runner_name, shape, kw", [
    ("make_sharded_fast_runner", (2, 1, 1), {}),
    ("make_sharded_stream_runner", (2, 1, 1), {}),
    ("make_sharded_stream_runner", (2, 1, 1), {"nj": 2}),  # the j-tiled shard call (K3-shard-jt)
    ("make_sharded_stream_2d_runner", (2, 2, 1), {}),
])
def test_tpu_shard_kernels_interpret_match_the_port(runner_name, shape, kw):
    from fdtd_tpu.parallel import sharded_fast as jsf

    p = _params(Mode.COMPUTATION, "float32")
    arrays = _initial(p)
    mesh = jmesh.make_mesh(int(np.prod(shape)), shape, devices=jax.devices("cpu"))
    two_d = shape[1] > 1
    to_sh = jsf.to_sharded_fast_2d if two_d else jsf.to_sharded_fast
    from_sh = jsf.from_sharded_fast_2d if two_d else jsf.from_sharded_fast
    run = getattr(jsf, runner_name)(p, mesh, interpret=True, **kw)
    xs = scan_inputs(p, time_values(p)[:19])
    want = from_sh(p, run(to_sh(p, zeros(p), mesh), xs), mesh)
    backend = "twopass" if runner_name == "make_sharded_fast_runner" else "stream"
    got, _ = _port_sharded(p, arrays, shape, backend, steps=19)
    for c in COMPONENTS:
        g = got[c][:, :, : p.maxi]
        np.testing.assert_allclose(g, np.asarray(getattr(want, c))[:, :, : p.maxi], atol=ATOL, rtol=0, err_msg=c)


# -- run_simulation, the CLI, checkpoints -------------------------------------

def _vtr(out, name):
    return read_vtr_cell_arrays(os.path.join(str(out), name))


def test_run_simulation_shard_writes_the_unsharded_snapshots(tmp_path):
    """``shard="4"`` and ``"2x2"`` (fp32, ``torch`` on the CPU; with a water
    load and SAR) write the snapshots and SAR map of the unsharded run, bit
    for bit, and gather only where an output is due."""
    p = convert.params_from(dataclasses.replace(_params(), sampling_rate=10))
    tm = convert.materials_from(water_block(_params()))
    ref = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "one"), materials=tm, accumulate_power=True,
                                log=lambda m: None)
    names = sorted(os.path.basename(f) for f in glob.glob(str(tmp_path / "one" / "*.vtr")))
    assert names == ["result0001.vtr", "result0010.vtr", "result0020.vtr"]
    for spec in ("4", "2x2"):
        res = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / spec), materials=tm, accumulate_power=True,
                                    shard=spec, log=lambda m: None)
        for name in names:
            a, b = _vtr(tmp_path / "one", name), _vtr(tmp_path / spec, name)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{spec}/{name}/{k}")
        assert torch.equal(res.power_j, ref.power_j) and float(ref.power_j.max()) > 0
        for a, b in zip(res.state.tensors(), ref.state.tensors()):
            assert torch.equal(a, b)


def test_cli_shard_writes_the_unsharded_outputs(tmp_path):
    params = tmp_path / "p.txt"
    params.write_text("0.01 0.01 0.01 0.001 1e-12 1e-11 5 1")
    for sub, extra in (("one", []), ("zy", ["--shard", "2x2"])):
        assert cli.main([str(params), "--device", "cpu", "--water-block", "--sar", "--out", str(tmp_path / sub),
                         *extra]) == 0
    for name in ("result0001.vtr", "result0005.vtr", "result0010.vtr", "sar.vtr"):
        a, b = _vtr(tmp_path / "one", name), _vtr(tmp_path / "zy", name)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}/{k}")


def test_sharded_checkpoints_resume_unsharded_and_in_jax(tmp_path):
    """A sharded run's checkpoint (canonical schema) resumes unsharded in
    the port and in the JAX package, and a JAX checkpoint resumes sharded
    in the port: each equals the straight run (fp64, the port against
    itself bit for bit, against JAX at rtol 1e-11 / atol 1e-15; the SAR map
    at rtol 1e-6)."""
    jp = dataclasses.replace(_params(Mode.COMPUTATION, "float64"), sampling_rate=20)
    p = convert.params_from(jp)
    jm = water_block(jp)
    tm = convert.materials_from(jm)
    quiet = {"log": lambda m: None, "write_snapshots": False, "accumulate_power": True}
    straight = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "s"), materials=tm, **quiet)
    # sharded run checkpointing at step 10 and stopping there
    half = dataclasses.replace(p, simulation_time=1e-11)
    runner.run_simulation(half, "cpu", out_dir=str(tmp_path / "a"), materials=tm, shard="2x2", checkpoint_every=10,
                          **quiet)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    resumed = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "a"), materials=tm, resume=True, **quiet)
    for a, b in zip(resumed.state.tensors(), straight.state.tensors()):
        assert torch.equal(a, b)
    assert torch.equal(resumed.power_j, straight.power_j)
    j_res = jrunner.run_simulation(jp, out_dir=str(tmp_path / "b"), materials=jm, resume=True, backend="xla",
                                   write_snapshots=False, accumulate_power=True, log=lambda m: None)
    for c in COMPONENTS:
        np.testing.assert_allclose(np.asarray(getattr(j_res.state, c)), getattr(straight.state, c).numpy(),
                                   rtol=1e-11, atol=1e-15, err_msg=c)
    peak = float(straight.power_j.max())
    np.testing.assert_allclose(np.asarray(j_res.power_j), straight.power_j.numpy(), rtol=1e-6, atol=1e-6 * peak)
    # a JAX checkpoint resumed sharded in the port
    jrunner.run_simulation(dataclasses.replace(jp, simulation_time=1e-11), out_dir=str(tmp_path / "c"), materials=jm,
                           checkpoint_every=10, backend="xla", write_snapshots=False, accumulate_power=True,
                           log=lambda m: None)
    t_res = runner.run_simulation(p, "cpu", out_dir=str(tmp_path / "c"), materials=tm, resume=True, shard="2",
                                  **quiet)
    for a, b in zip(t_res.state.tensors(), straight.state.tensors()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-11, atol=1e-15)
    np.testing.assert_allclose(t_res.power_j.numpy(), straight.power_j.numpy(), rtol=1e-6, atol=1e-6 * peak)


# -- errors and refusals -------------------------------------------------------

@pytest.mark.parametrize("spec", ["2y", "0", "2x2x2", "x", "-1"])
def test_bad_shard_specs_give_the_jax_errors(spec):
    with pytest.raises(ValueError) as want:
        jrunner.parse_shard_spec(spec)
    with pytest.raises(ValueError) as got:
        runner.parse_shard_spec(spec)
    assert str(got.value) == str(want.value)
    assert runner.parse_shard_spec("4") == jrunner.parse_shard_spec("4") == (4, 1)
    assert runner.parse_shard_spec("4X2") == jrunner.parse_shard_spec("4X2") == (4, 2)


def test_too_many_shards_for_the_planes(tmp_path):
    p = convert.params_from(_params())
    with pytest.raises(ValueError, match="too many for its 11 planes"):
        runner.run_simulation(p, "cpu", out_dir=str(tmp_path), shard="12", write_snapshots=False, log=lambda m: None)
    with pytest.raises(ValueError, match="along y"):
        runner.run_simulation(p, "cpu", out_dir=str(tmp_path), shard="1x12", write_snapshots=False,
                              log=lambda m: None)


def test_debye_cpml_shard_keeps_the_jax_refusal(tmp_path):
    p = convert.params_from(_params())
    with pytest.raises(ValueError, match=r"^dispersive media with --pml run single-chip for now \(no --shard\)$"):
        runner.run_simulation(p, "cpu", out_dir=str(tmp_path), shard="2", materials=water_debye_load(p),
                              pml=PMLConfig(cells=3), write_snapshots=False, log=lambda m: None)


# -- the mesh, the exchange, the plans ----------------------------------------

def test_factor3_and_padded_shape_match_jax():
    for n in range(1, 17):
        assert M.factor3(n) == jmesh.factor3(n)
    p = _params()
    jm = jmesh.make_mesh(8, (2, 2, 2), devices=jax.devices("cpu"))
    assert M.padded_divisible_shape(convert.params_from(p), (2, 2, 2)) == jmesh.padded_divisible_shape(p, jm)


def test_owned_ranges_and_boxes():
    p256 = convert.params_from(Params(length=0.256, width=0.256, height=0.256, spatial_step=0.001, time_step=1e-12,
                                      simulation_time=1e-9, sampling_rate=100, mode=Mode.COMPUTATION))
    assert M.owned_ranges(p256, (4, 1, 1), 5)[0] == [(0, 65), (65, 130), (130, 195), (195, 257)]
    p12 = convert.params_from(_params(height=0.0115))
    assert M.owned_ranges(p12, (4, 2, 1), 3)[:2] == [[(0, 3), (3, 6), (6, 9), (9, 12)], [(0, 6), (6, 11)]]
    with pytest.raises(ValueError, match="along z"):
        M.owned_ranges(p12, (4, 1, 1), 4)  # a 4-plane halo reads more than a shard owns
    p = convert.params_from(_params())
    boxes = M.shard_boxes(p, M.make_mesh((2, 2, 1), "cpu"), 2)
    assert boxes[0] == Box((0, 0, 0), (8, 8, 11), (0, 0, 0), (6, 6, 11))
    assert boxes[3] == Box((4, 4, 0), (11, 11, 11), (6, 6, 0), (11, 11, 11))
    assert boxes[3].cells(p) == ((6, 6, 0), (10, 10, 10)) and boxes[3].cell_shape(p) == (4, 4, 10)


def test_scatter_exchange_gather():
    """Scatter copies the neighbours' planes into the halos; after the
    halos are overwritten, the exchange restores them (corners included),
    and gather writes back only owned planes."""
    p = convert.params_from(_params())
    rng = np.random.default_rng(2)
    s = convert.state_from_numpy({c: rng.uniform(-1, 1, p.padded_shape) for c in COMPONENTS}, "cpu", torch.float64)
    mesh = M.make_mesh((2, 2, 1), "cpu")
    shards = M.scatter(p, s, mesh, 2)
    want = [sh.state.clone() for sh in shards]
    for sh in shards:
        for t in sh.state.tensors():
            keep = t[sh.box.owned].clone()
            t.fill_(float("nan"))
            t[sh.box.owned] = keep
    M.exchange(mesh, shards)
    for sh, w in zip(shards, want):
        for a, b in zip(sh.state.tensors(), w.tensors()):
            assert torch.equal(a, b)
    out = convert.state_from_numpy({c: np.zeros(p.padded_shape) for c in COMPONENTS}, "cpu", torch.float64)
    M.gather(p, shards, out)
    for a, b in zip(out.tensors(), s.tensors()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("side", ["lo", "hi"])
def test_exchange_of_one_plane(side):
    """``planes=1`` fills only the halo plane next to the owned window on
    ``side`` of each sharded axis (what a two-pass step reads) and leaves
    the deeper halo planes as they were."""
    p = convert.params_from(_params())
    rng = np.random.default_rng(3)
    s = convert.state_from_numpy({c: rng.uniform(-1, 1, p.padded_shape) for c in COMPONENTS}, "cpu", torch.float64)
    mesh = M.make_mesh((2, 2, 1), "cpu")
    shards = M.scatter(p, s, mesh, 3)
    want = [sh.state.clone() for sh in shards]
    for sh in shards:
        for t in sh.state.tensors():
            keep = t[sh.box.owned].clone()
            t.fill_(float("nan"))
            t[sh.box.owned] = keep
    M.exchange(mesh, shards, sides=(side,), planes=1)
    for sh, w in zip(shards, want):
        # the owned window grown by one plane on ``side`` where the box has a halo there
        lo = [o - (side == "lo" and o > b) for o, b in zip(sh.box.own_lo, sh.box.lo)]
        hi = [o + (side == "hi" and o < b) for o, b in zip(sh.box.own_hi, sh.box.hi)]
        filled = torch.zeros(sh.box.shape, dtype=torch.bool)
        filled[tuple(slice(a - b0, c - b0) for a, c, b0 in zip(lo, hi, sh.box.lo))] = True
        assert not filled.all()  # the slab has a halo on ``side``
        for a, b in zip(sh.state.tensors(), w.tensors()):
            assert torch.equal(a[filled], b[filled])
            assert bool(torch.isnan(a[~filled]).all())  # deeper planes and the other side: untouched


def test_make_mesh_places_shards_round_robin(monkeypatch):
    notices = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = M.make_mesh((4, 2, 1), "cuda", notices.append)
    assert [d.index for d in m.devices] == [0, 1, 2, 0, 1, 2, 0, 1] and all(d.type == "cuda" for d in m.devices)
    assert notices and "round-robin" in notices[0]
    assert M.make_mesh((2, 1, 1), "cuda:1").devices == (torch.device("cuda", 1),) * 2
    assert M.make_mesh((2, 1, 1), "cpu").devices == (torch.device("cpu"),) * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        M.make_mesh((2, 1, 1), "cuda")


def test_shard_plans_and_memory_model():
    p256 = convert.params_from(Params(length=0.256, width=0.256, height=0.256, spatial_step=0.001, time_step=1e-12,
                                      simulation_time=1e-9, sampling_rate=100, mode=Mode.COMPUTATION))
    mesh = M.make_mesh((4, 1, 1), "cpu")
    plans = sharded_fast.pick_shard_plan(p256, mesh)
    assert plans is not None and len(plans) == 4 and plans[0].window == (65, 257, 257) and plans[-1].window[0] == 62
    sar = sharded_fast.pick_shard_plan(p256, mesh, lossy=True, sar=True)
    assert sar[0].kernel == "yee_stream_lossy_sar" and sar[0].s in stream_plan.built_depths(True)
    # the shards sweep at the unsharded sweep's depth (ranked by their own bytes, bf16 + SAR took s = 8, which spills)
    for dtype in ("float32", "bfloat16"):
        pd = dataclasses.replace(p256, dtype=dtype)
        for kw in ({}, {"lossy": True}, {"lossy": True, "sar": True}, {"lossy": True, "het": True, "sar": True}):
            assert sharded_fast.pick_shard_plan(pd, mesh, **kw)[0].s == stream_plan.pick_plan(pd, **kw).s, (dtype, kw)
    # the gates of one device: SAR needs a load, loads need computation mode
    assert sharded_fast.pick_shard_plan(p256, mesh, sar=True, lossy=False) is not None  # sar implies lossy
    pval = dataclasses.replace(p256, mode=Mode.VALIDATION)
    assert sharded_fast.pick_shard_plan(pval, mesh, lossy=True) is None
    # shards thinner than the halo depth: no plan at s = 8 on 12 planes over 4
    p12 = convert.params_from(_params(height=0.0115))
    assert sharded_fast.pick_shard_plan(p12, mesh, s=8) is None
    assert sharded_fast.pick_shard_plan(p12, mesh, s=2) is not None
    # the memory model: two states a shard on stream, one on twopass, plus the gathered grid
    boxes = M.shard_boxes(p256, mesh, 4)
    shapes = [(b.shape, int(np.prod(b.cell_shape(p256)))) for b in boxes]
    dev = torch.device("cpu")
    two = stream_plan.shard_bytes(p256, shapes, mesh.devices, dev, True)[dev]
    one = stream_plan.shard_bytes(p256, shapes, mesh.devices, dev, False)[dev]
    state = stream_plan.state_bytes(p256)
    assert two - one == sum(6 * 4 * int(np.prod(b.shape)) for b in boxes) > state
    assert one > 2 * state
    assert stream_plan.shard_fits({dev: one}, {}) and not stream_plan.shard_fits({dev: one}, {dev: one})
    # 1024^3 fp32 on one card: the sharded stream does not fit (two states and the gathered grid)
    p1024 = dataclasses.replace(p256, length=1.024, width=1.024, height=1.024)
    assert sharded_fast.pick_shard_plan(p1024, mesh) is None


def test_sharded_backend_choice_off_the_card(tmp_path):
    """On the CPU ``auto`` runs the sharded torch step; the kernels' names
    raise as they do unsharded."""
    p = convert.params_from(_params())
    _, run = runner.sharded_runner(p, "2", "cpu", log=lambda m: None)
    assert run.backend == "torch" and run.depth == 1
    for backend in ("twopass", "stream", "pallas_fused"):
        with pytest.raises(ValueError, match="use --backend torch"):
            runner.sharded_runner(p, "2", "cpu", backend=backend, log=lambda m: None)


def test_kernel_wrappers_launch_on_the_stream_of_the_tensors_device(monkeypatch):
    """Each wrapper asks for the current stream of its tensors' device (not
    of the current device) and launches under that device: a stand-in
    library records the stream handle it is given."""
    asked, entered = [], []

    class FakeStream:
        def __init__(self, device):
            self.cuda_stream = 1000 + (device.index or 0)

    class FakeDevice:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            return False

    def current_stream(device=None):
        asked.append(device)
        return FakeStream(torch.device(device))

    class FakeLib:
        def __getattr__(self, name):
            def call(*args):
                self.stream = args[-1]
                return 0
            return call

    lib = FakeLib()
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(yee, "_lib", lambda: lib)
    monkeypatch.setattr(yee, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(stream, "_lib", lambda: lib)
    monkeypatch.setattr(stream, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(yee, "launches", dict.fromkeys(yee.launches, 0))
    monkeypatch.setattr(stream, "launches", dict.fromkeys(stream.launches, 0))
    p = convert.params_from(_params())
    s = convert.state_from_numpy(_initial(_params()), "cpu", torch.float32)
    coefs = update_coefs(p)
    dev = s.ex.device
    yee.update_h(p, s, coefs)
    assert asked[-1] == dev and entered[-1] == dev and lib.stream == 1000
    yee.update_e(p, s, coefs)
    assert asked[-1] == dev and entered[-1] == dev
    plan = stream_plan.plan_for(p, 2)
    out = convert.state_from_numpy(_initial(_params()), "cpu", torch.float32)
    stream.sweep(p, s, out, coefs, plan)
    assert asked[-1] == dev and entered[-1] == dev and lib.stream == 1000
    assert build.launch_stream(torch.device("cuda", 3)) == 1003 and asked[-1] == torch.device("cuda", 3)
    assert yee.launches["yee_update_h"] == yee.launches["yee_update_e"] == 1 and stream.launches["yee_stream"] == 1
