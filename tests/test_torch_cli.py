"""The port's CLI takes the JAX package's command lines.

Every option of ``fdtd_tpu.cli.build_arg_parser()``, with a valid value
(each choice of a choice option), goes through the port's parser on
``--device cpu`` and parses to the value the JAX parser gives it.  The JAX
backend names map to the port's backends with a notice, ``--temporal-steps``
forces the stream depth (the depths the port does not build exit 1 naming
8, 4 and 2), ``--profile`` writes a torch.profiler trace, and the flags
that were once refused as not ported run: ``--shard`` (with ``--pml``
too), and ``--thermal``, ``--thermal-power``, ``--coupled`` and
``--rotate`` against the JAX CLI's outputs.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fdtd_tpu import cli as jcli  # noqa: E402
from fdtd_tpu_torch import cli, runner  # noqa: E402
from fdtd_tpu_torch.params import parse_params_text  # noqa: E402

# a valid value for each JAX option that takes a free-form value
_VALUES = {
    "--out": "o", "--checkpoint-every": "5", "--diag-log": "d.jsonl", "--profile": "prof",
    "--source-frequency": "2.45e9", "--source-aprime": "0.004", "--source-bprime": "0.003", "--shard": "2x2",
    "--pml": "3", "--source-pulse-width": "1e-10", "--source-pulse-delay": "3e-10", "--thermal": "30",
    "--dft": "2.45e10,1e9", "--probe": "1,2,3", "--coupled": "2", "--thermal-power": "900",
    "--salt-sigma": "0.3", "--thermal-ambient": "35", "--rotate": "10", "--load-center": "0.4,0.6",
}


def _jax_cases():
    cases = []
    for action in jcli.build_arg_parser()._actions:
        if not action.option_strings or action.dest == "help":
            continue
        flag = action.option_strings[-1]
        if action.nargs == 0:
            cases.append((flag, None))
        elif action.choices is not None:
            cases.extend((flag, str(c)) for c in action.choices)
        else:
            cases.append((flag, _VALUES[flag]))
    return cases


@pytest.mark.parametrize("flag, value", _jax_cases())
def test_port_parser_takes_every_jax_option(flag, value):
    argv = ["params.txt"] + ([flag] if value is None else [flag, value])
    want = jcli.build_arg_parser().parse_args(argv)
    got = cli.build_arg_parser().parse_args(argv + ["--device", "cpu"])
    dest = flag.lstrip("-").replace("-", "_")
    assert getattr(got, dest) == getattr(want, dest), (flag, value)


def _params_file(tmp_path, text="0.01 0.01 0.01 0.001 1e-12 1e-11 5 1"):
    path = tmp_path / "params.txt"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("name, port", sorted(runner.JAX_BACKENDS.items()))
def test_jax_backend_names_map_with_a_notice(name, port):
    p = parse_params_text("0.01 0.01 0.01 0.001 1e-12 1e-11 5 1", dtype="float32")
    notices = []
    assert runner.map_backend(name, notices.append) == port
    assert notices == [f"notice: backend {name!r} is the JAX package's; running the port's {port!r} backend"]
    notices.clear()
    if port == "torch":
        assert runner.resolve_backend(p, name, "cpu", log=notices.append) == "torch"
    else:  # the kernels need a card: off it the mapped name is refused as the port's own is
        with pytest.raises(ValueError, match="--backend torch"):
            runner.resolve_backend(p, name, "cpu", log=notices.append)
    assert len(notices) == 1
    # on a card the mapped backend is the one that runs
    assert runner.resolve_backend(p, name, "cuda") == port


def test_cli_runs_a_jax_backend_name(tmp_path, capsys):
    rc = cli.main([_params_file(tmp_path), "--device", "cpu", "--backend", "xla", "--no-output"])
    out = capsys.readouterr().out
    assert rc == 0 and "notice: backend 'xla' is the JAX package's; running the port's 'torch' backend" in out
    rc = cli.main([_params_file(tmp_path), "--device", "cpu", "--backend", "pallas_stream", "--no-output"])
    assert rc == 1 and "--backend torch" in capsys.readouterr().err


# the flags of item 6 with what they need, as a user runs them
_ITEM6_RUNS = {
    "--thermal": ["--water-block", "--sar", "--thermal", "30"],
    "--thermal-power": ["--water-block", "--sar", "--thermal", "30", "--thermal-power", "900"],
    "--coupled": ["--water-block", "--coupled", "2", "--thermal", "8"],
    "--rotate": ["--water-block", "--coupled", "2", "--thermal", "8", "--rotate", "10", "--load-center", "0.4,0.5"],
}


@pytest.mark.parametrize("flag, value, item", [
    ("--shard", "2", "item 11"), ("--thermal", "30", "item 6"), ("--thermal-power", "900", "item 6"),
    ("--coupled", "2", "item 6"), ("--rotate", "10", "item 6"),
])
def test_unported_flags_exit_1_naming_their_item(tmp_path, capsys, flag, value, item):
    """Every flag of this list is ported now.  ``--shard`` (items 11 and
    11b): alone it runs, and so does ``--shard 2 --pml 3``.  The flags of
    item 6 (the thermal solve, the coupled cook, the turntable): alone each
    exits as the JAX CLI exits, with its message, and with what it needs
    each writes the JAX CLI's temperature.vtr (the coupled cooks also
    coupled.jsonl) in fp64, at rtol 1e-6 of the rise's scale: the EM runs'
    fp32 power accumulators round their increments in another order (the
    bar of tests/test_torch_runner.py)."""
    if flag == "--shard":
        for extra in ([], ["--pml", "3"]):
            rc = cli.main([_params_file(tmp_path), "--device", "cpu", "--no-output", flag, value, *extra])
            assert rc == 0 and "Simulation complete!" in capsys.readouterr().out
        return
    from fdtd_tpu.io.vtr import read_vtr_cell_arrays

    params = _params_file(tmp_path)
    rc_j = jcli.main([params, "--out", str(tmp_path / "j0"), "--no-output", flag, value])
    err_j = capsys.readouterr().err.strip().splitlines()
    rc_t = cli.main([params, "--out", str(tmp_path / "t0"), "--device", "cpu", "--no-output", flag, value])
    err_t = capsys.readouterr().err.strip().splitlines()
    assert rc_t == rc_j and err_t[-1:] == err_j[-1:] and "not ported" not in "".join(err_t)
    run = [*_ITEM6_RUNS[flag], "--dtype", "float64"]
    assert jcli.main([params, "--out", str(tmp_path / "j"), "--backend", "xla", *run]) == 0
    capsys.readouterr()
    assert cli.main([params, "--out", str(tmp_path / "t"), "--device", "cpu", *run]) == 0
    assert "Simulation complete!" in capsys.readouterr().out
    got = read_vtr_cell_arrays(str(tmp_path / "t" / "temperature.vtr"))
    want = read_vtr_cell_arrays(str(tmp_path / "j" / "temperature.vtr"))
    assert list(got) == list(want)
    for key in want:
        base = 20.0 if key.startswith("temperature") else 0.0
        scale = float(np.abs(want[key] - base).max())
        assert scale > 0, key
        np.testing.assert_allclose(got[key] - base, want[key] - base, rtol=1e-6, atol=1e-6 * scale, err_msg=key)
    if "--coupled" in run:
        rows = [[json.loads(line) for line in (tmp_path / d / "coupled.jsonl").read_text().splitlines()]
                for d in ("t", "j")]
        assert [sorted(r) for r in rows[0]] == [sorted(r) for r in rows[1]] and len(rows[0]) == 2
        for g, w in zip(*rows):
            for key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("s", [3, 5, 6, 7])
def test_temporal_steps_the_port_does_not_build_exit_1(tmp_path, capsys, s):
    rc = cli.main([_params_file(tmp_path), "--device", "cpu", "--no-output", "--temporal-steps", str(s)])
    err = capsys.readouterr().err
    assert rc == 1 and "{8, 4, 2}" in err and str(s) in err


def test_temporal_steps_force_the_stream_depth(tmp_path):
    """--temporal-steps reaches the stream runner's plan (a built depth the
    variant lacks is refused as a forced ``stream_s`` is)."""
    from fdtd_tpu_torch.step import make_chunk_runner

    p = parse_params_text("0.012 0.012 0.012 0.001 1e-12 1e-11 5 1", dtype="float32")
    for s in (8, 4, 2):
        assert make_chunk_runner(p, "cpu", backend="stream", stream_s=s).plan.s == s
    assert cli.main([_params_file(tmp_path), "--device", "cpu", "--no-output", "--temporal-steps", "4"]) == 0
    with pytest.raises(ValueError, match="steps per sweep"):
        from fdtd_tpu_torch.ops.cpml import PMLConfig

        make_chunk_runner(p, "cpu", backend="stream", stream_s=8, pml=PMLConfig(cells=1))


def test_profile_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    rc = cli.main([_params_file(tmp_path), "--device", "cpu", "--no-output", "--profile", str(prof)])
    assert rc == 0 and f"profiler trace written to {prof}" in capsys.readouterr().out
    assert os.path.getsize(prof / "trace.json") > 0
