"""The benchmark of fdtd_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload oven_256.long --seed 7 --seconds 20 --trace 0

Run from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for (BENCHMARK.json).  The cell's configuration, traffic,
limits and per-layer readers are files under benchmark/ found by the names
in BENCHMARK.json (core/cell.py).  Earlier lines of standard output name
the card, its power limit, the torch and CUDA versions, nvcc, the plan the
program picks and the compile seconds; the last line is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` (each compared number with its
limit), which standard error repeats as its last lines.

Exit codes: 0 with a result (``correct`` true or false); 2 on bad
arguments; 3 without the CUDA devices the cell needs (no result, never a
CPU run); 4 when jax, jaxlib, flax or the JAX package is loaded once the
window has closed; 1 on any other failure.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for path in (str(BENCH_DIR), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)
# library caches at fixed paths inside the checkout (the program builds its
# own kernels under fdtd_tpu_torch/_build, also inside the checkout)
os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH_DIR / "_state" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / "_state" / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "fdtd_tpu")  # whole top-level module names


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from core.run_cell import NoCard, run_cell

    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except NoCard as e:
        print(f"error: {e}; the benchmark measures CUDA devices and does not run on the CPU", file=sys.stderr)
        return 3
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"error: loaded in this process: {', '.join(found)} (the benchmark runs without JAX)",
              file=sys.stderr)
        return 4
    info = result.pop("_info")
    phases = ", ".join(f"{k} {v:.3f}" for k, v in info["phases"].items())
    print(f"window: {info['steps']} steps in {info['window_s']:.3f} s (the loop {info['window_loop_s']:.3f} s); set-up {info['setup_s']:.3f} s "
          f"({phases}); warm-up call {info['warm_s']:.3f} s; reference {info['reference_s']:.3f} s"
          + (f"; trace events {info['trace_events']}, profiler stop {info['trace_stop_s']:.3f} s, summary "
             f"{info['summarize_s']:.3f} s, readers {info['trace_read_s']:.3f} s" if "trace_events" in info else ""),
          flush=True)
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
