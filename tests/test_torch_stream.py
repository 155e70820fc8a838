"""The port's ``stream`` backend (streaming sweep, ``ops/stream.py``) on the
CPU, where the sweep wrapper runs its plain version.

Against the JAX package: ``make_chunk_runner(backend="pallas_stream")`` in
interpret mode on ``tiny_params`` (10^3), as ``tests/test_temporal.py``
runs it, with the steps per sweep forced through ``FDTD_STREAM_S``.  fp32:
19 steps (two 8-step sweeps and three trailing two-pass steps at s=8) to
atol 1e-6, the JAX test's own tolerance (interpret mode lets XLA:CPU group
the unrolled levels differently, a 1-ulp effect).  bf16: 8 steps, one
sweep, to 1/128 of the field's scale: both sides keep the sweep in fp32 and
round once, so they may differ by one bf16 rounding (2^-8 relative) where
the fp32 values straddle a rounding boundary; the JAX test allows 2e-2.

Port-internal: fp32 ``plain_sweep`` is s steps of the ``torch`` backend bit
for bit; bf16 ``plain_sweep`` is the fp32 steps rounded once; the plan
picker and backend resolution.
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu.params import Mode, time_values  # noqa: E402
from fdtd_tpu.state import init_validation, zeros  # noqa: E402
from fdtd_tpu.step import backend_adapters  # noqa: E402
from fdtd_tpu.step import make_chunk_runner as j_chunk_runner  # noqa: E402
from fdtd_tpu.step import scan_inputs as j_scan_inputs  # noqa: E402
from fdtd_tpu_torch import cli, convert, runner  # noqa: E402
from fdtd_tpu_torch import state as tstate  # noqa: E402
from fdtd_tpu_torch import step as tstep  # noqa: E402
from fdtd_tpu_torch.dft import DftConfig  # noqa: E402
from fdtd_tpu_torch.ops import build, stream, stream_plan  # noqa: E402
from fdtd_tpu_torch.ops.cpml import PMLConfig, PsiState, make_cpml, psi_shapes  # noqa: E402
from fdtd_tpu_torch.params import Params  # noqa: E402
from fdtd_tpu_torch.source import (apply_source, make_source_plan, profile_tensor,  # noqa: E402
                                   sweep_drive_rows)

COMPONENTS = ["ex", "ey", "ez", "hx", "hy", "hz"]


def _jax_stream(p, n, s, monkeypatch):
    """``n`` steps of interpret-mode ``pallas_stream`` at s steps per sweep
    from the mode's initial state; (initial, final) as numpy dicts."""
    monkeypatch.setenv("FDTD_STREAM_S", str(s))
    s0 = init_validation(p) if p.mode == Mode.VALIDATION else zeros(p)
    prep, rest = backend_adapters(p, "pallas_stream")
    xs = j_scan_inputs(p, time_values(p)[:n])
    got = rest(j_chunk_runner(p, backend="pallas_stream")(prep(s0), xs, None)[0])
    as_np = lambda st: {c: np.asarray(getattr(st, c), np.float32) for c in COMPONENTS}  # noqa: E731
    return as_np(s0), as_np(got)


def _port_stream(p, init, n, s):
    tp = convert.params_from(p)
    st = convert.state_from_numpy(init, "cpu", tstate.field_dtype(tp))
    run = tstep.make_chunk_runner(tp, "cpu", backend="stream", stream_s=s)
    assert run.plan.s == s
    out = run(st, tstep.scan_inputs(tp, time_values(p)[:n]))
    assert out is st
    return {c: getattr(st, c).float().numpy() for c in COMPONENTS}


@pytest.mark.parametrize("s", [8, 4, 2])
@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_stream_matches_jax_pallas_stream_fp32(tiny_params, monkeypatch, mode, s):
    p = dataclasses.replace(tiny_params, dtype="float32", mode=mode)
    init, want = _jax_stream(p, 19, s, monkeypatch)
    got = _port_stream(p, init, 19, s)
    for c in COMPONENTS:
        np.testing.assert_allclose(got[c], want[c], atol=1e-6, rtol=0, err_msg=f"s={s}/{c}")
    assert max(np.abs(want[c]).max() for c in COMPONENTS) > 1e-3


def test_stream_matches_jax_pallas_stream_bf16(tiny_params, monkeypatch):
    p = dataclasses.replace(tiny_params, dtype="bfloat16", mode=Mode.COMPUTATION,
                            simulation_time=8e-12)
    init, want = _jax_stream(p, 8, 8, monkeypatch)
    got = _port_stream(p, init, 8, 8)
    for c in COMPONENTS:
        scale = max(float(np.abs(want[c]).max()), 1e-30)
        assert float(np.abs(got[c] - want[c]).max()) <= scale / 128, c
    assert float(np.abs(want["ez"]).max()) > 0


def _random_state(p, seed, dtype):
    rng = np.random.default_rng(seed)
    return convert.state_from_numpy({c: rng.uniform(-1, 1, p.padded_shape) for c in COMPONENTS},
                                    "cpu", dtype)


def _drive(p, st, s, seed):
    """Step 1's hard-set on ``st`` and the sweep's rows of steps 2..s."""
    src = make_source_plan(p)
    amps = torch.tensor(np.random.default_rng(seed).uniform(-1, 1, s), dtype=torch.float64)
    prof = profile_tensor(src, "cpu")
    apply_source(src, st, amps[0], prof)
    ez, hx = sweep_drive_rows(src, amps, s, st.ex.dtype, prof)
    return amps, stream.SweepDrive(src.patch, ez[0], hx[0])


@pytest.mark.parametrize("s", [8, 4, 2])
@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_plain_sweep_fp32_is_torch_steps(tiny_params, mode, s):
    p = dataclasses.replace(convert.params_from(tiny_params), mode=mode, dtype="float32")
    a = _random_state(p, 11, torch.float32)
    b = a.clone()
    drive = None
    if mode == Mode.COMPUTATION:
        amps, drive = _drive(p, a, s, 12)
    got = stream.plain_sweep(p, a, tstate.update_coefs(p), s, drive)
    step = tstep.make_step(p, "cpu", backend="torch")
    for m in range(s):
        step(b, (0.0, float(amps[m]) if drive is not None else 0.0))
    for c in COMPONENTS:
        assert torch.equal(getattr(got, c), getattr(b, c)), c


@pytest.mark.parametrize("s", [8, 2])
def test_plain_sweep_bf16_rounds_once(tiny_params, s):
    p = dataclasses.replace(convert.params_from(tiny_params), mode=Mode.VALIDATION, dtype="bfloat16")
    a = _random_state(p, 13, torch.bfloat16)
    wide = a.to(dtype=torch.float32)
    step = tstep.make_step(dataclasses.replace(p, dtype="float32"), "cpu", backend="torch")
    for _ in range(s):
        step(wide, (0.0, 0.0))
    got = stream.plain_sweep(p, a, tstate.update_coefs(p), s)
    per_step = a.clone()
    bstep = tstep.make_step(p, "cpu", backend="torch")
    for _ in range(s):
        bstep(per_step, (0.0, 0.0))
    for c in COMPONENTS:
        assert getattr(got, c).dtype == torch.bfloat16
        assert torch.equal(getattr(got, c), getattr(wide, c).to(torch.bfloat16)), c
    # and it is not s steps of bf16 storage: those round after every pass
    assert any(not torch.equal(getattr(got, c), getattr(per_step, c)) for c in COMPONENTS)


def test_plain_sweep_writes_into_out_and_leaves_input(tiny_params):
    p = dataclasses.replace(convert.params_from(tiny_params), mode=Mode.COMPUTATION, dtype="float32")
    a = _random_state(p, 14, torch.float32)
    _, drive = _drive(p, a, 4, 15)
    before = a.clone()
    out = tstate.FieldState(*(torch.full_like(t, float("nan")) for t in a.tensors()))
    stream.reset_launches()
    r = stream.sweep(p, a, out, tstate.update_coefs(p), stream_plan.plan_for(p, 4), drive)
    want = stream.plain_sweep(p, a, tstate.update_coefs(p), 4, drive)
    assert r is out and stream.launches == dict.fromkeys(stream.launches, 0)
    for c in COMPONENTS:
        assert torch.equal(getattr(a, c), getattr(before, c)), c
        assert torch.equal(getattr(out, c), getattr(want, c)), c


def test_sweep_drive_rows_equal_apply_source(tiny_params):
    """Row m-2 of a sweep is the patch apply_source writes at step m."""
    p = dataclasses.replace(convert.params_from(tiny_params), mode=Mode.COMPUTATION, dtype="bfloat16")
    src = make_source_plan(p)
    prof = profile_tensor(src, "cpu")
    amps = torch.tensor(np.linspace(-0.9, 0.8, 19), dtype=torch.float64)
    ez, hx = sweep_drive_rows(src, amps, 4, torch.bfloat16, prof)
    assert ez.shape == hx.shape == (4, 3, src.i1 - src.i0) and ez.dtype == torch.bfloat16
    st = tstate.zeros(p, "cpu")
    for g in range(4):
        for m in range(2, 5):
            apply_source(src, st, amps[4 * g + m - 1], prof)
            assert torch.equal(st.ez[0, src.j0, src.i0:src.i1], ez[g, m - 2])
            assert torch.equal(st.hx[0, src.j1 - 1, src.i0:src.i1], hx[g, m - 2])


@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_stream_chunk_runner_equals_torch(tiny_params, mode):
    """8k+3 steps: two sweeps at s=8, then three twopass steps."""
    p = dataclasses.replace(convert.params_from(tiny_params), mode=mode, dtype="float32")
    a = tstate.init_validation(p, "cpu") if mode == Mode.VALIDATION else tstate.zeros(p, "cpu")
    b = a.clone()
    xs = tstep.scan_inputs(p, time_values(p)[:19])
    run = tstep.make_chunk_runner(p, "cpu", backend="stream", stream_s=8)
    assert run(a, xs) is a
    run(a, tstep.scan_inputs(p, time_values(p)[19:20]))  # a chunk shorter than s
    tstep.make_chunk_runner(p, "cpu", backend="torch")(b, tstep.scan_inputs(p, time_values(p)[:20]))
    for c in COMPONENTS:
        assert torch.equal(getattr(a, c), getattr(b, c)), c


def _cube(n, dtype):
    return Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3, spatial_step=0.001,
                  time_step=1e-12, simulation_time=1e-11, sampling_rate=5,
                  mode=Mode.COMPUTATION, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [10, 50, 256, 512, 1024])
def test_plan_is_feasible_and_covers_the_grid(n, dtype):
    p = _cube(n, dtype)
    plan = stream_plan.pick_plan(p)
    assert plan is not None and plan.s in stream_plan.STEPS
    K1, J1, I1 = p.padded_shape
    assert plan.tj == plan.bj - 2 * plan.s and plan.ti == plan.bi - 2 * plan.s
    assert plan.nk * plan.tk >= K1 and (plan.nk - 1) * plan.tk < K1
    assert plan.nj * plan.tj >= J1 and (plan.nj - 1) * plan.tj < J1
    assert plan.ni * plan.ti >= I1 and (plan.ni - 1) * plan.ti < I1
    assert plan.threads <= 1024 and plan.smem_bytes <= stream_plan.SMEM_PER_BLOCK
    assert plan.bytes_per_cell_step == min(
        stream_plan.plan_for(p, s).bytes_per_cell_step for s in stream_plan.STEPS)
    if n >= 256:  # the segment count whose waves take the fewest steps an SM (121 whole tiles: one wave)
        assert plan.tk == stream_plan.pick_tk(K1, plan.nj * plan.ni, plan.s, 0)
        assert plan.blocks >= stream_plan.SM_COUNT or plan.nk == 1


# every built variant of ring_kernel (the CPML sweep's shell is pml_kernel's):
# (lossy, het, sar, ade, dft) with its built depths
_RING_VARIANTS = [v[:3] + v[4:] for v in stream_plan.VARIANTS if not v[3]]


def _built_plans(p, window=None):
    """Every built ring_kernel plan of ``p`` (each variant at each built
    depth; the DFT variants at nf = 1, and their means mode at the same
    shapes with a buffer of one sweep)."""
    cfg = DftConfig((1e9,))
    for lossy, het, sar, ade, dft in _RING_VARIANTS:
        for means in (False, True) if dft else (False,):
            table = stream_plan._block_j(lossy or het or sar, False, ade, sar, dft, window is not None)
            for s in table:
                yield stream_plan.plan_for(p, s, lossy, het, sar, ade=ade, dft=cfg if dft else None, window=window,
                                           fold=s if means else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [10, 50, 256, 1024])
def test_ring_grid_fills_whole_waves_and_walks_every_tile_plane_once(n, dtype):
    """A ring_kernel grid's segments cover every (tile, plane) exactly once,
    and its segment depth is the one whose waves take the fewest pipeline
    steps an SM (a last wave half full costs a whole wave): no other split
    into segments at least 2s deep does better."""
    p = _cube(n, dtype)
    K1 = p.padded_shape[0]
    for plan in _built_plans(p):
        tiles, sh = plan.nj * plan.ni, int(plan.means)
        seen = np.zeros((tiles, K1), np.int32)
        for tile, k0, k1 in stream_plan.segments(plan.nj, plan.ni, K1, plan.tk):
            assert 0 <= k0 < k1 <= K1
            seen[tile, k0:k1] += 1
        assert (seen == 1).all(), plan
        assert plan.blocks == len(stream_plan.segments(plan.nj, plan.ni, K1, plan.tk)) == plan.nk * tiles
        assert plan.waves == plan.blocks / stream_plan.SM_COUNT

        def steps(tk):
            return -(-(-(-K1 // tk) * tiles) // stream_plan.SM_COUNT) * (tk + 2 * plan.s + sh)

        best = min(steps(-(-K1 // nk)) for nk in range(1, max(1, K1 // (2 * plan.s)) + 1))
        assert steps(plan.tk) == best and (plan.tk >= 2 * plan.s or plan.nk == 1)
        if n == 256 and not plan.lossy and not plan.ade and not plan.dft and plan.s == 4:
            assert (plan.blocks, plan.nk) == (121, 1)  # vacuum: one wave of whole tiles (121 of 132 SMs)


def test_segments_mirror_the_kernel_walk():
    """Block b advances the tk planes of segment b // tiles of tile b %
    tiles: the blocks of a wave walk neighbouring tiles' planes together."""
    assert stream_plan.segments(1, 2, 5, 3) == [(0, 0, 3), (1, 0, 3), (0, 3, 5), (1, 3, 5)]
    assert stream_plan.segments(2, 1, 4, 4) == [(0, 0, 4), (1, 0, 4)]
    assert stream_plan.pick_tk(257, 121, 4, 0) == 257  # 121 whole tiles: one wave
    assert stream_plan.pick_tk(257, 216, 4, 1) == 86  # 648 blocks: 5 waves of 95 steps beat 2 of 266


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_plans_fit_shared_memory(dtype):
    """Every built shape's static buffers, ring and DFT sums (at the most
    frequencies it takes) fit a block's 227 KB, at 256^3 and on a shard's
    window."""
    p = _cube(256, dtype)
    for window in (None, (65, 257, 257)):
        for plan in _built_plans(p, window):
            nf = max(plan.dft_max_nf, 1) if plan.dft else 0
            assert plan.smem_bytes + plan.dft_smem_bytes(nf) <= stream_plan.SMEM_PER_BLOCK, plan
            assert plan.threads <= 1024
            coefs = (19 if plan.sar else 15) if plan.ade else 6 + 3 * plan.het + 2 * plan.sar
            words = (9 if plan.ade else 6) + ((plan.s + 1) * coefs if plan.cr else 0)
            assert plan.ring_words == words
            exchange = 4 * plan.threads + (3 * plan.threads if plan.means else plan.bi)
            assert plan.smem_bytes == 4 * (exchange + plan.threads * words)


def test_dft_max_nf_keeps_the_frequency_counts():
    """The ring takes shared memory the DFT sums used: the bands still take
    at least two frequencies on the vacuum, material and shard sweeps (and
    the Debye sweep without SAR), three on the Debye SAR sweep, five on the
    CPML sweep, so no --dft scene that streamed leaves for twopass; one
    frequency more takes the same shape's means mode, which has no cap."""
    p = _cube(256, "float32")
    cfg = DftConfig((1e9,))
    for lossy, het, sar, ade, dft in _RING_VARIANTS:
        if not dft:
            continue
        for window in ((None,) if ade else (None, (65, 257, 257))):
            s = stream_plan.pick_plan(p, lossy=lossy, het=het, sar=sar, ade=ade, dft=cfg).s
            plan = stream_plan.plan_for(p, s, lossy, het, sar, ade=ade, dft=cfg, window=window)
            assert plan.dft_max_nf >= (3 if ade and sar else 2), plan
            if window is None:
                more = DftConfig(tuple(1e9 * (k + 1) for k in range(plan.dft_max_nf + 1)))
                past = stream_plan.pick_plan(p, lossy=lossy, het=het, sar=sar, ade=ade, dft=more)
                assert (past.s, past.bj, past.fold) == (s, plan.bj, stream_plan.FOLD_DEPTH // s * s), past
    assert stream_plan.pick_plan(p, pml=PMLConfig(cells=10), dft=cfg).dft_max_nf == 5
    six = DftConfig(tuple(1e9 * (k + 1) for k in range(6)))
    assert stream_plan.pick_plan(p, pml=PMLConfig(cells=10), dft=six).kernel == "yee_stream_pml_dft_means"
    two = DftConfig((1e9, 2e9))
    for lossy, het, sar in ((False, False, False), (True, False, False), (True, False, True), (True, True, True)):
        assert stream_plan.pick_plan(p, lossy=lossy, het=het, sar=sar, dft=two) is not None
    assert stream_plan.pick_plan(p, sar=True, ade=True, dft=DftConfig((1e9, 2e9, 3e9))) is not None


def test_bytes_model_counts_the_lead_in_and_the_halo():
    """bytes_per_cell_step of the vacuum s = 4 sweep (1024 threads emitting
    24 x 24 columns: the six fields read 1024/576 times, written once),
    against planes counted by hand: one segment a tile at 256^3 loads the
    257 planes once; at 47^3 (48 planes, six 8-plane segments) a tile
    loads 12 + 4 * 16 + 12 = 88 planes, each segment's 4 lead-in planes and
    4 past it clamped at the walls; a 65-plane shard window loads its 4
    halo planes on each side, 73."""
    amp_ji = 1024 / 576
    big = stream_plan.plan_for(_cube(256, "float32"), 4)
    assert (big.tk, big.nk, big.tj, big.ti) == (257, 1, 24, 24)
    assert big.bytes_per_cell_step == pytest.approx((24 * amp_ji + 24) / 4, rel=1e-12)  # 50/3
    small = stream_plan.plan_for(_cube(47, "float32"), 4)
    assert (small.tk, small.nk, small.nj, small.ni) == (8, 6, 2, 2)
    assert small.bytes_per_cell_step == pytest.approx((24 * amp_ji * 88 / 48 + 24) / 4, rel=1e-12)  # 230/9
    slab = stream_plan.plan_for(_cube(256, "float32"), 4, window=(65, 257, 257))
    assert (slab.tk, slab.nk) == (65, 1)
    assert slab.bytes_per_cell_step == pytest.approx((24 * amp_ji * 73 / 65 + 24) / 4, rel=1e-12)


def test_plan_refuses_what_does_not_fit():
    p = _cube(1024, "float32")
    need = 2 * stream_plan.state_bytes(p)
    assert stream_plan.pick_plan(p, s=8, memory_bytes=need) is None  # forced s is checked too
    assert stream_plan.pick_plan(p, memory_bytes=need) is None
    assert not stream_plan.supported(p, memory_bytes=need)
    assert stream_plan.pick_plan(p, s=8, memory_bytes=2 * need).s == 8
    assert stream_plan.pick_plan(dataclasses.replace(p, dtype="float64")) is None
    with pytest.raises(ValueError, match="one of"):
        stream_plan.pick_plan(p, s=3)


@pytest.mark.parametrize(
    "device, dtype, backend, want",
    [
        ("cpu", "float32", "auto", "torch"),
        ("cpu", "bfloat16", "auto", "torch"),
        ("cuda", "float32", "auto", "stream"),
        ("cuda", "bfloat16", "auto", "stream"),
        ("cuda", "float32", "stream", "stream"),
        ("cpu", "float32", "stream", ValueError),
        ("cuda", "float64", "stream", ValueError),
    ],
)
def test_resolve_backend_stream(tiny_params, device, dtype, backend, want):
    p = dataclasses.replace(convert.params_from(tiny_params), dtype=dtype)
    if want is ValueError:
        with pytest.raises(ValueError, match="stream"):
            runner.resolve_backend(p, backend, device)
    else:
        assert runner.resolve_backend(p, backend, device) == want


def test_stream_refuses_fp64_and_other_devices(tiny_params):
    p = convert.params_from(tiny_params)
    with pytest.raises(ValueError, match="float64"):
        tstep.make_chunk_runner(p, "cpu", backend="stream")
    p32 = dataclasses.replace(p, dtype="float32")
    s = tstate.zeros(p32, "meta", torch.float32)
    out = tstate.zeros(p32, "meta", torch.float32)
    stream.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        stream.sweep(p32, s, out, tstate.update_coefs(p32), stream_plan.plan_for(p32, 4))
    mixed = tstate.zeros(p32, "cpu", torch.float32)
    with pytest.raises(ValueError, match="one device"):
        stream.sweep(p32, mixed, out, tstate.update_coefs(p32), stream_plan.plan_for(p32, 4))
    assert stream.launches == dict.fromkeys(stream.launches, 0) and "yee_stream" in stream.launches


def test_stream_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        build.build(stream.KERNEL_SOURCE, build_dir=tmp_path / "build")
    a = build.library_path(stream.KERNEL_SOURCE, tmp_path)
    assert a.name.startswith("libyee_stream-") and a.suffix == ".so"


def test_cli_stream_on_cpu_is_an_error(tmp_path, capsys):
    params = tmp_path / "p.txt"
    params.write_text("0.01 0.01 0.01 0.001 1e-12 1e-11 5 0")
    rc = cli.main([str(params), "--device", "cpu", "--backend", "stream", "--out", str(tmp_path / "r")])
    assert rc == 1
    assert "--backend torch" in capsys.readouterr().err


# (s, bj, cr, tk, fold, smem_bytes, ring_words, dft_max_nf) of every
# ring_kernel plan at 256^3, the same in float32 and bfloat16: the routing's
# pick of each variant (nf = 1 and the means mode at 16 frequencies; a CPML
# sweep's psi-free interior at --pml 10; a shard's window of 65 planes at the
# picked depth) and every built depth (nf = 1, the means mode with one
# sweep's buffer).  The bf16 sweeps stage their rows inside the same ring,
# so no shape, shared-memory size or frequency cap moves with the staging.
_PICKED_256 = {
    "yee_stream": (4, 32, 0, 257, 0, 41088, 6, 0),
    "yee_stream_shard": (4, 32, 0, 65, 0, 41088, 6, 0),
    "yee_stream_lossy": (4, 24, 1, 129, 0, 123008, 36, 0),
    "yee_stream_lossy_shard": (4, 24, 1, 33, 0, 123008, 36, 0),
    "yee_stream_lossy_sar": (4, 24, 1, 86, 0, 162816, 46, 0),
    "yee_stream_lossy_sar_shard": (4, 24, 1, 65, 0, 162816, 46, 0),
    "yee_stream_lossy_het": (4, 24, 1, 129, 0, 169088, 51, 0),
    "yee_stream_lossy_het_shard": (4, 24, 1, 33, 0, 169088, 51, 0),
    "yee_stream_lossy_het_sar": (4, 24, 1, 86, 0, 208896, 61, 0),
    "yee_stream_lossy_het_sar_shard": (4, 24, 1, 65, 0, 208896, 61, 0),
    "yee_stream_pml_interior": (2, 32, 0, 116, 0, 41088, 6, 0),
    "yee_stream_lossy_pml_interior": (2, 32, 1, 116, 0, 114816, 24, 0),
    "yee_stream_ade": (2, 24, 1, 257, 0, 178304, 54, 0),
    "yee_stream_ade_sar": (2, 16, 1, 257, 0, 149504, 66, 0),
    "yee_stream_dft": (4, 24, 0, 86, 0, 39936, 6, 2),
    "yee_stream_dft_shard": (4, 24, 0, 65, 0, 39936, 6, 2),
    "yee_stream_dft_means": (4, 24, 0, 86, 32, 39936, 6, 0),
    "yee_stream_lossy_dft": (2, 24, 1, 43, 0, 95232, 24, 3),
    "yee_stream_lossy_dft_shard": (2, 24, 1, 22, 0, 95232, 24, 3),
    "yee_stream_lossy_dft_means": (2, 24, 1, 43, 32, 95232, 24, 0),
    "yee_stream_lossy_sar_dft": (2, 24, 1, 43, 0, 113664, 30, 3),
    "yee_stream_lossy_sar_dft_shard": (2, 24, 1, 22, 0, 113664, 30, 3),
    "yee_stream_lossy_sar_dft_means": (2, 24, 1, 43, 32, 113664, 30, 0),
    "yee_stream_lossy_het_dft": (2, 24, 1, 43, 0, 122880, 33, 2),
    "yee_stream_lossy_het_dft_shard": (2, 24, 1, 22, 0, 122880, 33, 2),
    "yee_stream_lossy_het_dft_means": (2, 24, 1, 43, 32, 122880, 33, 0),
    "yee_stream_lossy_het_sar_dft": (2, 24, 1, 43, 0, 141312, 39, 2),
    "yee_stream_lossy_het_sar_dft_shard": (2, 24, 1, 22, 0, 141312, 39, 2),
    "yee_stream_lossy_het_sar_dft_means": (2, 24, 1, 43, 32, 141312, 39, 0),
    "yee_stream_pml_dft_interior": (2, 24, 0, 58, 0, 39936, 6, 5),
    "yee_stream_pml_dft_means_interior": (2, 24, 0, 58, 32, 39936, 6, 0),
    "yee_stream_lossy_pml_dft_interior": (2, 24, 0, 58, 0, 39936, 6, 5),
    "yee_stream_lossy_pml_dft_means_interior": (2, 24, 1, 58, 32, 95232, 24, 0),
    "yee_stream_ade_dft": (2, 16, 1, 257, 0, 124928, 54, 4),
    "yee_stream_ade_dft_means": (2, 16, 1, 257, 32, 124928, 54, 0),
    "yee_stream_ade_sar_dft": (2, 16, 1, 257, 0, 149504, 66, 3),
    "yee_stream_ade_sar_dft_means": (2, 16, 1, 257, 32, 149504, 66, 0),
}
_BUILT_256 = {
    "yee_stream s8": (8, 24, 0, 129, 0, 30848, 6, 0),
    "yee_stream s4": (4, 32, 0, 257, 0, 41088, 6, 0),
    "yee_stream s2": (2, 32, 0, 52, 0, 41088, 6, 0),
    "yee_stream_shard s8": (8, 24, 0, 65, 0, 30848, 6, 0),
    "yee_stream_shard s4": (4, 32, 0, 65, 0, 41088, 6, 0),
    "yee_stream_shard s2": (2, 32, 0, 13, 0, 41088, 6, 0),
    "yee_stream_lossy s8": (8, 24, 0, 129, 0, 30848, 6, 0),
    "yee_stream_lossy s4": (4, 24, 1, 129, 0, 123008, 36, 0),
    "yee_stream_lossy s2": (2, 32, 1, 52, 0, 114816, 24, 0),
    "yee_stream_lossy_shard s8": (8, 24, 0, 65, 0, 30848, 6, 0),
    "yee_stream_lossy_shard s4": (4, 24, 1, 33, 0, 123008, 36, 0),
    "yee_stream_lossy_shard s2": (2, 32, 1, 13, 0, 114816, 24, 0),
    "yee_stream_lossy_sar s8": (8, 24, 0, 129, 0, 39936, 6, 0),
    "yee_stream_lossy_sar s4": (4, 24, 1, 86, 0, 162816, 46, 0),
    "yee_stream_lossy_sar s2": (2, 32, 1, 52, 0, 151552, 30, 0),
    "yee_stream_lossy_sar_shard s8": (8, 24, 0, 65, 0, 39936, 6, 0),
    "yee_stream_lossy_sar_shard s4": (4, 24, 1, 65, 0, 162816, 46, 0),
    "yee_stream_lossy_sar_shard s2": (2, 32, 1, 65, 0, 151552, 30, 0),
    "yee_stream_lossy_het s8": (8, 24, 0, 129, 0, 30848, 6, 0),
    "yee_stream_lossy_het s4": (4, 24, 1, 129, 0, 169088, 51, 0),
    "yee_stream_lossy_het s2": (2, 32, 1, 52, 0, 151680, 33, 0),
    "yee_stream_lossy_het_shard s8": (8, 24, 0, 65, 0, 30848, 6, 0),
    "yee_stream_lossy_het_shard s4": (4, 24, 1, 33, 0, 169088, 51, 0),
    "yee_stream_lossy_het_shard s2": (2, 32, 1, 13, 0, 151680, 33, 0),
    "yee_stream_lossy_het_sar s8": (8, 24, 0, 129, 0, 39936, 6, 0),
    "yee_stream_lossy_het_sar s4": (4, 24, 1, 86, 0, 208896, 61, 0),
    "yee_stream_lossy_het_sar s2": (2, 32, 1, 52, 0, 188416, 39, 0),
    "yee_stream_lossy_het_sar_shard s8": (8, 24, 0, 65, 0, 39936, 6, 0),
    "yee_stream_lossy_het_sar_shard s4": (4, 24, 1, 65, 0, 208896, 61, 0),
    "yee_stream_lossy_het_sar_shard s2": (2, 32, 1, 65, 0, 188416, 39, 0),
    "yee_stream_ade s2": (2, 24, 1, 257, 0, 178304, 54, 0),
    "yee_stream_ade_sar s2": (2, 16, 1, 257, 0, 149504, 66, 0),
    "yee_stream_dft s4": (4, 24, 0, 86, 0, 39936, 6, 2),
    "yee_stream_dft_means s4": (4, 24, 0, 86, 4, 39936, 6, 0),
    "yee_stream_dft_shard s4": (4, 24, 0, 65, 0, 39936, 6, 2),
    "yee_stream_dft_shard s2": (2, 24, 0, 22, 0, 39936, 6, 5),
    "yee_stream_dft_means_shard s4": (4, 24, 0, 65, 4, 39936, 6, 0),
    "yee_stream_dft_means_shard s2": (2, 24, 0, 22, 2, 39936, 6, 0),
    "yee_stream_lossy_dft s2": (2, 24, 1, 43, 0, 95232, 24, 3),
    "yee_stream_lossy_dft_means s2": (2, 24, 1, 43, 2, 95232, 24, 0),
    "yee_stream_lossy_dft_shard s2": (2, 24, 1, 22, 0, 95232, 24, 3),
    "yee_stream_lossy_dft_means_shard s2": (2, 24, 1, 22, 2, 95232, 24, 0),
    "yee_stream_lossy_sar_dft s2": (2, 24, 1, 43, 0, 113664, 30, 3),
    "yee_stream_lossy_sar_dft_means s2": (2, 24, 1, 43, 2, 113664, 30, 0),
    "yee_stream_lossy_sar_dft_shard s2": (2, 24, 1, 22, 0, 113664, 30, 3),
    "yee_stream_lossy_sar_dft_means_shard s2": (2, 24, 1, 22, 2, 113664, 30, 0),
    "yee_stream_lossy_het_dft s2": (2, 24, 1, 43, 0, 122880, 33, 2),
    "yee_stream_lossy_het_dft_means s2": (2, 24, 1, 43, 2, 122880, 33, 0),
    "yee_stream_lossy_het_dft_shard s2": (2, 24, 1, 22, 0, 122880, 33, 2),
    "yee_stream_lossy_het_dft_means_shard s2": (2, 24, 1, 22, 2, 122880, 33, 0),
    "yee_stream_lossy_het_sar_dft s2": (2, 24, 1, 43, 0, 141312, 39, 2),
    "yee_stream_lossy_het_sar_dft_means s2": (2, 24, 1, 43, 2, 141312, 39, 0),
    "yee_stream_lossy_het_sar_dft_shard s2": (2, 24, 1, 22, 0, 141312, 39, 2),
    "yee_stream_lossy_het_sar_dft_means_shard s2": (2, 24, 1, 22, 2, 141312, 39, 0),
    "yee_stream_ade_dft s2": (2, 16, 1, 257, 0, 124928, 54, 4),
    "yee_stream_ade_dft_means s2": (2, 16, 1, 257, 2, 124928, 54, 0),
    "yee_stream_ade_sar_dft s2": (2, 16, 1, 257, 0, 149504, 66, 3),
    "yee_stream_ade_sar_dft_means s2": (2, 16, 1, 257, 2, 149504, 66, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_plans_keep_their_shapes_at_256(dtype):
    p = _cube(256, dtype)
    one, many = DftConfig((2.45e10,)), DftConfig(tuple(2.40e10 + 1e8 * k for k in range(16)))

    def row(plan):
        return (plan.s, plan.bj, int(plan.cr), plan.tk, plan.fold, plan.smem_bytes, plan.ring_words, plan.dft_max_nf)

    picked, built = {}, {}
    for lossy, het, sar, pml, ade, dft in stream_plan.VARIANTS:
        for cfg in (one, many) if dft else (None,):
            name = stream_plan.variant_name(lossy, het, sar, pml, ade, dft, cfg is many)
            plan = stream_plan.pick_plan(p, lossy=lossy, het=het, sar=sar, pml=PMLConfig(cells=10) if pml else None,
                                         ade=ade, dft=cfg)
            if pml:
                picked[name + stream.INTERIOR] = row(plan.core)
                continue
            picked[name] = row(plan)
            if not ade and cfg is not many:
                picked[name + "_shard"] = row(stream_plan.plan_for(p, plan.s, lossy, het, sar, dft=cfg,
                                                                   window=(65, 257, 257)))
        if pml:
            continue
        for window in (None,) if ade else (None, (65, 257, 257)):
            for means in (False, True) if dft else (False,):
                for s in stream_plan._block_j(lossy or het or sar, False, ade, sar, dft, window is not None):
                    plan = stream_plan.plan_for(p, s, lossy, het, sar, ade=ade, dft=one if dft else None,
                                                window=window, fold=s if means else 0)
                    name = stream_plan.variant_name(lossy, het, sar, False, ade, dft, means)
                    built[f"{name}{'_shard' if window else ''} s{s}"] = row(plan)
    assert picked == _PICKED_256
    assert built == _BUILT_256


def test_staged_launch_counter(tiny_params, monkeypatch):
    """``stream.staged_launches`` starts at 0 and counts the bfloat16
    ring_kernel launches alone: plain-version calls leave it, an fp32 launch
    and a CPML sweep's shell do not count, the CPML interior does, and
    ``reset_launches`` clears it (the library and the device stubbed)."""
    stream.reset_launches()
    assert stream.staged_launches == 0
    p = convert.params_from(tiny_params)
    for dt in ("float32", "bfloat16"):
        pd = dataclasses.replace(p, dtype=dt)
        st = tstate.zeros(pd, "cpu", tstate.field_dtype(pd))
        stream.sweep(pd, st, tstate.zeros(pd, "cpu", st.ex.dtype), tstate.update_coefs(pd), stream_plan.plan_for(pd, 2))
    assert stream.staged_launches == 0 and stream.launches["yee_stream"] == 0

    calls = []
    lib = types.SimpleNamespace(yee_stream_sweep=lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(stream, "_on_cpu", lambda *a: False)
    monkeypatch.setattr(stream, "_lib", lambda: lib)
    monkeypatch.setattr(stream.build, "launch_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    want = 0
    for dt in ("float32", "bfloat16"):
        pd = dataclasses.replace(p, dtype=dt)
        st = tstate.zeros(pd, "cpu", tstate.field_dtype(pd))
        out = tstate.zeros(pd, "cpu", st.ex.dtype)
        coefs = tstate.update_coefs(pd)
        stream.sweep(pd, st, out, coefs, stream_plan.plan_for(pd, 2))
        cfg = PMLConfig(cells=2)
        plan = stream_plan.plan_for(pd, 2, pml=cfg)
        cp = make_cpml(pd, cfg, coefs, "cpu")
        psi = PsiState(**{n: torch.zeros(sh, dtype=st.ex.dtype) for n, sh in psi_shapes(pd, cfg).items()})
        psi_out = PsiState(**{n: torch.zeros_like(t) for n, t in zip(PsiState.names(), psi.tensors())})
        stream.sweep(pd, st, out, coefs, plan, cpml=cp, psi=psi, psi_out=psi_out)
        assert plan.core is not None and plan.pml_blocks
        want += 2 if dt == "bfloat16" else 0  # the whole grid's sweep, the CPML interior
        assert stream.staged_launches == want, dt
    assert len(calls) == 6  # per dtype: the sweep, the CPML interior and shell
    assert stream.launches["yee_stream_pml"] == 2
    stream.reset_launches()
    assert stream.staged_launches == 0
