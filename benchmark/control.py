"""The compared numbers' readings: the program's and the control's, seed by seed.

    python3 benchmark/control.py --workload CELL --seeds 1,2,3 --seconds 10 \
        [--program-quantize int8] [--trace 0]

Runs the cell once a seed in this process (a short window at the cell's
own load is enough: the check judges a sample of the answered songs) and
prints, a line a seed, the numbers the check compares for the program and
for the control: the plain reference in the precision below the
configuration's (``reference/judge.py`` ``CONTROL``), put in the program's
place on the same sample. ``--program-quantize int8`` serves the cell with
the program's own int8 path instead, judged against the configuration's
reference: the program's path below bfloat16. ``--fault NAME`` plants a
fault of ``harness/faults.py`` in the program and reads what the check
reads of it. The limits of
``benchmark/limits/<cell>.json`` are set from these readings (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    from benchmark.run import run_cell

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--program-quantize", default=None)
    parser.add_argument("--fault", default=None, help="a fault of harness/faults.py planted")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from benchmark.harness.faults import FAULTS

    overrides = {"quantize": args.program_quantize} if args.program_quantize else None
    fault = FAULTS[args.fault] if args.fault else None
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = run_cell(args.workload, seed, args.seconds, False, device=args.device,
                       control=overrides is None and fault is None,
                       t_start=time.monotonic(), program_overrides=overrides, fault=fault)
        readings = out["readings"]
        row = {"seed": seed, "correct": out["result"]["correct"],
               "program": readings["program"], "control": readings.get("control")}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for who in ("program", "control"):
        keys = sorted({k for r in rows if r.get(who) for k in r[who]})
        for key in keys:
            vals = [r[who][key] for r in rows if r.get(who)]
            print(f"{who} {key}: min {min(vals)} max {max(vals)} over {len(vals)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
