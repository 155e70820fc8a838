"""The per-step SAR increment's wrapper (``fdtd_tpu_torch/ops/sar.py``, the
``sar_accum`` kernel of ``csrc/dft_accum.cu``) on the CPU, where it runs
its plain version, ``diagnostics.accumulate_power``:

- on the whole grid and on each shard of a 1-D and a 2-D mesh, fp32 and
  bf16 fields, random fields, sigma and a non-zero starting map: the map
  equals the plain version's whole-grid map bit for bit, and no launch is
  counted;
- the refusals of what the kernel does not take;
- the routing: the chunk runners hand the increment to the wrapper on
  ``twopass`` (and the stream runner's trailing steps), to the plain
  version on ``torch``, and so do the sharded runners;
- the benchmark's frozen kernel names (``benchmark/core/kernels.py``, read
  by file path) group the kernel as ``other``, so its time never counts as
  a field update.

The kernel itself runs only on the card (``chip_smoke.py``, phase 6f).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu_torch import convert, diagnostics  # noqa: E402
from fdtd_tpu_torch import step as step_mod  # noqa: E402
from fdtd_tpu_torch.grid import COMPONENTS  # noqa: E402
from fdtd_tpu_torch.ops import sar  # noqa: E402
from fdtd_tpu_torch.ops import stream  # noqa: E402
from fdtd_tpu_torch.parallel import mesh as M  # noqa: E402
from fdtd_tpu_torch.parallel import sharded_step  # noqa: E402
from fdtd_tpu_torch.params import Mode, Params, time_values  # noqa: E402
from fdtd_tpu_torch.profile_chunk import _group  # noqa: E402
from fdtd_tpu_torch.state import water_block  # noqa: E402
from fdtd_tpu_torch.step import make_chunk_runner, scan_inputs, zero_power_acc  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _scene(dtype: str = "float32", steps: int = 6) -> Params:
    """A non-cubic 9 x 8 x 7 (k, j, i) box in computation mode."""
    return Params(length=7e-3, width=8e-3, height=9e-3, spatial_step=1e-3, time_step=1e-12,
                  simulation_time=(steps - 0.5) * 1e-12, sampling_rate=10**9, mode=Mode.COMPUTATION, dtype=dtype)


def _random(p: Params, seed: int):
    """Random fields in the field dtype, a positive sigma map in it and a
    non-zero fp32 starting map."""
    rng = np.random.default_rng(seed)
    s = convert.state_from_numpy({c: rng.uniform(-3, 3, p.padded_shape) for c in COMPONENTS}, "cpu",
                                 DTYPES[p.dtype])
    cells = (p.maxk, p.maxj, p.maxi)
    sigma = torch.tensor(rng.uniform(0, 2, cells)).to(DTYPES[p.dtype])
    acc = torch.tensor(rng.uniform(0, 1e-20, cells), dtype=torch.float32)
    return s, sigma, acc


@pytest.mark.parametrize("mesh_shape", [None, (3, 1, 1), (2, 2, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_equals_the_plain_increment_bit_for_bit(dtype, mesh_shape):
    p = _scene(dtype)
    s, sigma, acc0 = _random(p, 7)
    want = acc0.clone()
    diagnostics.accumulate_power(p, s, sigma, want)
    assert float((want - acc0).abs().max()) > 0
    sar.reset_launches()
    got = acc0.clone()
    if mesh_shape is None:
        sar.accumulate_power(p, s, sigma, got)
    else:
        mesh = M.make_mesh(mesh_shape, "cpu")
        shards = M.scatter(p, s, mesh, 1, got)
        for sh in shards:
            assert not sh.box.is_full(p)
            sar.accumulate_power(p, sh.state, M.part(sigma, *sh.box.cells(p), "cpu"), sh.power, sh.box)
        M.gather(p, shards, s, got)
    assert torch.equal(got, want)
    assert sar.launches == {"sar_accum": 0, "sar_accum_shard": 0}  # CPU tensors: the plain version


def test_wrapper_refuses_what_the_kernel_does_not_take():
    p = _scene()
    s, sigma, acc = _random(p, 3)
    sar.accumulate_power(p, s, None, acc)  # vacuum deposits nothing
    with pytest.raises(ValueError, match="sigma must be"):
        sar.accumulate_power(p, s, sigma[1:], acc)
    with pytest.raises(ValueError, match="SAR map must be a"):
        sar.accumulate_power(p, s, sigma, acc[:, 1:])
    with pytest.raises(ValueError, match="float32"):
        sar.accumulate_power(p, s, sigma, acc.double())
    meta = dataclasses.replace(s, **{c: torch.empty(p.padded_shape, device="meta") for c in COMPONENTS})
    with pytest.raises(ValueError, match="one device"):
        sar.accumulate_power(p, meta, sigma, acc)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        sar.accumulate_power(p, meta, sigma.to("meta"), acc.to("meta"))
    assert sar.launches == {"sar_accum": 0, "sar_accum_shard": 0}


def _stub_increments(monkeypatch) -> dict:
    """Replace the wrapper and the plain version by counters."""
    calls = {"wrapper": 0, "plain": 0}

    def counter(name):
        def inc(p, s, sigma_cells, acc, box=None):
            assert sigma_cells is not None and acc.dtype == torch.float32
            calls[name] += 1

        return inc

    monkeypatch.setattr(sar, "accumulate_power", counter("wrapper"))
    monkeypatch.setattr(diagnostics, "accumulate_power", counter("plain"))
    return calls


@pytest.mark.parametrize("backend, steps, want", [
    ("torch", 5, {"wrapper": 0, "plain": 5}),
    ("twopass", 5, {"wrapper": 5, "plain": 0}),
    ("stream", 7, {"wrapper": 7 % 4, "plain": 0}),  # the trailing two-pass steps after one sweep of s = 4
])
def test_chunk_runner_hands_the_increment_to_its_backends_version(backend, steps, want, monkeypatch):
    p = _scene(steps=steps)
    monkeypatch.setattr(step_mod, "make_step", lambda *a, **k: lambda s, x: None)
    monkeypatch.setattr(step_mod, "_kernel_step", lambda *a, **k: lambda s, x: None)
    monkeypatch.setattr(stream, "sweep", lambda *a, **k: None)
    calls = _stub_increments(monkeypatch)
    run = make_chunk_runner(p, "cpu", water_block(p), backend, stream_s=4 if backend == "stream" else None,
                            accumulate_power=True)
    s, _, _ = _random(p, 1)
    run(s, scan_inputs(p, time_values(p)), zero_power_acc(p, "cpu"))
    assert calls == want


@pytest.mark.parametrize("backend, kernel", [("torch", False), ("twopass", True)])
def test_sharded_runner_hands_the_increment_to_its_backends_version(backend, kernel, monkeypatch):
    p = _scene(steps=3)
    mesh = M.make_mesh((2, 1, 1), "cpu")
    run = sharded_step.make_sharded_chunk_runner(p, mesh, water_block(p), True, backend)
    s, _, _ = _random(p, 2)
    shards = M.scatter(p, s, mesh, run.depth, zero_power_acc(p, "cpu"))
    calls = _stub_increments(monkeypatch)
    run(shards, scan_inputs(p, time_values(p)))
    n = 3 * len(shards)
    assert calls == ({"wrapper": n, "plain": 0} if kernel else {"wrapper": 0, "plain": n})


def _bench_kernels():
    """``benchmark/core/kernels.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location("bench_core_kernels", ROOT / "benchmark" / "core" / "kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, want", [
    ("void (anonymous namespace)::sar_accum_kernel<float, false>(float const*, float const*, float const*, int, "
     "int, int, float const*, float, float*, (anonymous namespace)::Box)", "other"),
    ("void (anonymous namespace)::sar_accum_kernel<__nv_bfloat16, true>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, int, int, int, __nv_bfloat16 const*, float, float*, (anonymous namespace)::Box)", "other"),
    ("void (anonymous namespace)::dft_accum_kernel<float, false>(float const*, float const*, float const*, int, int, "
     "int, float const*, int, int, float*, float*, (anonymous namespace)::Box)", "dft_accum"),
])
def test_benchmark_groups_the_sar_kernel_outside_the_field_updates(name, want):
    kernels = _bench_kernels()
    assert kernels.group(name) == want
    assert kernels.base(name) not in kernels.FIELD_UPDATE
    assert _group(name) == want
