"""The highest rate the serving engine sustains, found once by a sweep.

    python3 -m cuda_bench.knee --workload <serving cell> --seconds <s> --rates <r ...>

One process, one engine: for each rate in turn, the cell's open loop for
``--seconds`` at that rate, drained. Prints per rate the requests
completed per second over the stretch, the median latency of the first
and last third of the requests, and the backlog when the last request
was due (requests due and not yet answered). A sustained rate keeps the
last third's latency near the first third's and the backlog under one
full batch. Writes ``chiprun_out/knee_<cell>.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    from cuda_bench import record, system
    from cuda_bench import run as R

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    cell = R.Cell.load(args.workload)
    device = R.cuda_device(cell)
    pipe, _weights = system.build(cell.config, args.seed, device)
    driver = R.load_file(cell.root / "cuda_bench" / "traffic" / f"{cell.mix['driver']}.py", "knee_driver")
    ctx = R.Context(pipe, record.Recorder(pipe.sd.unet), dict(cell.mix), args.seed, args.seconds,
                    np.random.default_rng(args.seed), cell.config["sd_2_1"], device)
    rows = []
    try:
        driver.warmup(ctx)
        for rate in args.rates:
            ctx.mix["rate_per_s"] = rate
            out = driver._serve(ctx, args.seconds, np.random.default_rng(args.seed))
            t0, due, done = out["t0"], out["due"], out["done"]
            n = len(due)
            last_due = t0 + due[-1]
            third = max(n // 3, 1)
            lat = [d - (t0 + u) for u, d in zip(due, done)]
            rows.append({
                "rate_per_s": rate, "requests": n, "failed": out["failed"],
                "completed_per_s": n / (max(done) - t0),
                "p50_first_third_s": statistics.median(lat[:third]),
                "p50_last_third_s": statistics.median(lat[-third:]),
                "p50_s": statistics.median(lat),
                "backlog_at_last_due": int(sum(1 for d in done if d > last_due)),
                "lateness_s": out["lateness_s"],
            })
            print(json.dumps(rows[-1]), flush=True)
    finally:
        for fn in ctx.closers:
            fn()
    Path(args.out).mkdir(exist_ok=True)
    (Path(args.out) / f"knee_{args.workload}.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
