"""The readings that the check's limits are set from, on the card.

    python3 benchmark/control.py --workload oven_256.long --seeds 1 2 3 ... \
        --control-seeds 4 5 6 [--seconds 3]

Runs the cell once per seed in one process (short windows: the readings
need only the warm-up call and the window's first records), first the
program as the configuration states it (the lower readings), then the
control, which has to come out as not correct (the upper readings): the
program at the field storage the configuration does not state
(``CONTROL``), while the reference keeps the stated one.  An fp32
configuration's control is the program's own bfloat16 path, the
precision below; a bfloat16 configuration's is the program at float32,
the rounding left out.  One JSON line a run: the workload, the seed,
which kind, the compared numbers and ``correct``.  The benchmark's own
runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

# the stated field storage -> the control's
CONTROL = {"float32": "bfloat16", "bfloat16": "float32"}

BENCH_DIR = Path(__file__).resolve().parent
for path in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from core.cell import Cell
    from core.run_cell import run_cell

    stated = Cell(args.workload).dtype
    runs = [("program", s, stated) for s in args.seeds] + [("control", s, CONTROL[stated])
                                                           for s in args.control_seeds]
    for kind, seed, dtype in runs:
        t0 = time.perf_counter()
        said: list[str] = []
        r = run_cell(args.workload, seed, args.seconds, False, program_dtype=dtype, say=said.append)
        info = r.pop("_info")
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, "dtype": dtype,
                          "plan": next((m for m in said if m.startswith("plan:")), None), "correct": r["correct"],
                          "checks": {k: v["value"] for k, v in r["checks"].items()},
                          "mcells_per_s": r["metrics"].get("mcells_per_s", {}).get("value"),
                          "steps": info["steps"], "reference_s": info["reference_s"],
                          "run_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
