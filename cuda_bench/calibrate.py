"""Readings from which the limits of ``correct`` are set, on the card.

    python3 -m cuda_bench.calibrate --workload <cell> --seconds <s> --seeds <n ...> [--control-seeds <n ...>]

Runs the cell's window of ``--seconds`` for each seed in one process (the
kernels built once), checks it as a benchmark run does, and prints the
numbers compared (``check.NUMBERS``) per seed: for ``--seeds`` those of the
program, for ``--control-seeds`` those of the control, the reference in
fp8 in the program's place at the same inputs. Writes every reading to
``chiprun_out/calibrate_<cell>.json``. The benchmark's own runs do not run
the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    from cuda_bench import run as R

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    cell = R.Cell.load(args.workload)
    device = R.cuda_device(cell)
    readings = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            run = R.measure(cell, seed, args.seconds, False, device, control=control)
            rec = {"seed": seed, "control": control, "numbers": run["check"]["numbers"],
                   "rows_checked": run["check"]["rows_checked"], "attempted": run["result"]["attempted"],
                   "seconds": time.perf_counter() - t0, "worst": run["check"]["notes"][-8:]}
            readings.append(rec)
            print(json.dumps(rec), flush=True)
    for control in (False, True):
        rows = [r["numbers"] for r in readings if r["control"] == control]
        if rows:
            side = "control (lowest)" if control else "program (highest)"
            pick = np.min if control else np.max
            print(side, json.dumps({k: float(pick([r[k] for r in rows])) for k in rows[0]}), flush=True)
    Path(args.out).mkdir(exist_ok=True)
    (Path(args.out) / f"calibrate_{args.workload}.json").write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
