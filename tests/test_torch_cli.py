"""The port's CLI takes the JAX package's command lines.

Every option of ``fdtd_tpu.cli.build_arg_parser()``, with a valid value
(each choice of a choice option), goes through the port's parser on
``--device cpu`` and parses to the value the JAX parser gives it.  The JAX
backend names map to the port's backends with a notice, ``--temporal-steps``
forces the stream depth (the depths the port does not build exit 1 naming
8, 4 and 2), ``--profile`` writes a torch.profiler trace, and the flags of
features not ported yet exit 1 naming their ROADMAP item (``--shard``
runs, with ``--pml`` too).
"""

import os

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


@pytest.mark.parametrize("flag, value, item", [
    ("--shard", "2", "item 11"), ("--thermal", "30", "item 6"), ("--thermal-power", "900", "item 6"),
    ("--coupled", "2", "item 6"), ("--rotate", "10", "item 6"),
])
def test_unported_flags_exit_1_naming_their_item(tmp_path, capsys, flag, value, item):
    """The flags of item 6 exit 1 naming it.  ``--shard`` (items 11 and
    11b) is ported: alone it runs, and so does ``--shard 2 --pml 3``."""
    if flag == "--shard":
        for extra in ([], ["--pml", "3"]):
            rc = cli.main([_params_file(tmp_path), "--device", "cpu", "--no-output", flag, value, *extra])
            assert rc == 0 and "Simulation complete!" in capsys.readouterr().out
        return
    rc = cli.main([_params_file(tmp_path), "--device", "cpu", "--no-output", flag, value])
    err = capsys.readouterr().err
    assert rc == 1 and f"{flag} is not ported yet: ROADMAP queue 1 {item}" in err


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
