"""Sustained serving throughput through the batching engine on one device.

    python -m guided_attention_tpu_torch.perf_server [--requests 24] [--buckets 4,8]
        [--artifacts DIR] [--device cuda] [--model sd15] [--steps 50] [concurrency ...]   (default: 8 4)

Counterpart of the JAX package's ``scripts/perf_server.py``: ``concurrency``
closed-loop client threads each keep one request in flight through
``frontends/server.BatchingEngine`` (the prompt alternating between
``workload.BATCH_PROMPTS``) until ``--requests`` are served. Before the
load levels, every bucket is served once with one prompt and with two
(``server.warmup``). Per level it prints s/image sustained (wall over
requests), the dispatched batch sizes, the padded samples, the min, p50,
p95 and max of the clients' latencies (submit to result) beside the
engine's ``last_batch_s``, and the card's name and power limit (a level of
fewer than 21 requests prints no p95 and is a smoke reading, not a
sustained rate); ``--artifacts DIR`` measures each level again with every
client writing its full artifact tree at diagnostic level 0, as the HTTP
server's ``save_artifacts`` does. The engine waits ``MAX_WAIT_MS`` (150 ms)
to form a group.
One JSON line per level goes to ``--out`` (``chiprun_out/perf_server.json``).

On ``--device cpu`` (``--model micro --steps 2`` for a quick drive) the
times are the CPU's.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

from guided_attention_tpu_torch import workload

OUT = os.path.join("chiprun_out", "perf_server.json")
MAX_WAIT_MS = 150.0  # the engine's group formation wait


def _percentile(sorted_values: List[float], q: float) -> float:
    return sorted_values[min(len(sorted_values) - 1, int(len(sorted_values) * q))]


def _has_tail(n: int) -> bool:
    """Whether ``n`` latencies have a p95 below their maximum. With fewer
    the level is a smoke reading: its top percentile is the maximum, and
    its wall is mostly the level's edges (the first group's formation, the
    last batch), not a sustained rate."""
    return int(n * 0.95) < n - 1


def run_load(engine, n_requests: int, concurrency: int, artifact_dir=None, steps: int = workload.STEPS) -> dict:
    """Closed loop: ``concurrency`` clients, one request in flight each,
    until ``n_requests`` are served (seeds 1 to ``n_requests``). Returns
    s/image, the batch sizes and padding this load dispatched, and the
    clients' latencies (min, p50, p95, max).
    ``artifact_dir``: each client then writes its artifact tree (level 0,
    diagnostics trimmed on the device) after its result, as the HTTP
    handler does for ``save_artifacts``."""
    from guided_attention_tpu_torch.config import HyperParams
    from guided_attention_tpu_torch.runtime.artifacts import write_run_artifacts

    seeds = iter(range(1, n_requests + 1))
    lock = threading.Lock()
    latencies: List[float] = []
    errors: List[BaseException] = []
    req_ids = itertools.count()
    knobs = dict(num_inference_steps=steps)
    if artifact_dir is not None:
        knobs.update(capture_diagnostics=True, trim_heavy_diags=True)

    def client():
        try:
            while True:
                with lock:
                    seed = next(seeds, None)
                if seed is None:
                    return
                prompt = workload.BATCH_PROMPTS[seed % len(workload.BATCH_PROMPTS)]  # mixed-prompt traffic
                t0 = time.perf_counter()
                out = engine.submit(prompt, seed=seed, **knobs).result(timeout=1200)
                if artifact_dir is not None:
                    write_run_artifacts(engine.pipe, out, output_path=Path(artifact_dir) / f"req{next(req_ids):06d}",
                                        seed=seed, hp=HyperParams(), meta_prompt=prompt)
                with lock:
                    latencies.append(time.perf_counter() - t0)
        except BaseException as e:  # reported by the caller's thread
            with lock:
                errors.append(e)

    before = engine.snapshot()
    threads = [threading.Thread(target=client, name=f"client{i}") for i in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if len(latencies) != n_requests:
        raise RuntimeError(f"{len(latencies)} of {n_requests} requests completed")
    after = engine.snapshot()
    sizes = {b: n - before["batch_sizes"].get(b, 0) for b, n in after["batch_sizes"].items()
             if n != before["batch_sizes"].get(b, 0)}
    lats = sorted(latencies)
    return {
        "concurrency": concurrency,
        "requests": n_requests,
        "steps": steps,
        "artifacts": artifact_dir is not None,
        "wall_s": wall,
        "s_per_image": wall / n_requests,
        "batch_sizes": sizes,
        "padded_samples": after["padded_samples"] - before["padded_samples"],
        "latency_s": {"min": lats[0], "p50": _percentile(lats, 0.5), "p95": _percentile(lats, 0.95), "max": lats[-1]},
        "last_batch_s": after["last_batch_s"],
    }


def report(row: dict, card: str) -> str:
    tag = " with artifact trees" if row["artifacts"] else ""
    lat = row["latency_s"]
    tail = _has_tail(row["requests"])
    rate = "s/image sustained" if tail else "s/image (smoke reading)"
    p95 = f"p95 {lat['p95']:.3f} s, " if tail else ""
    return (f"concurrency {row['concurrency']}: {row['s_per_image']:.3f} {rate}{tag} "
            f"({row['requests']} requests, batch sizes {row['batch_sizes']}, padded {row['padded_samples']}); "
            f"latency min {lat['min']:.3f} s, p50 {lat['p50']:.3f} s, {p95}max {lat['max']:.3f} s, "
            f"last batch {row['last_batch_s']} s ({card})")


def main(argv: Optional[List[str]] = None) -> List[dict]:
    from guided_attention_tpu_torch.frontends.server import BatchingEngine, warmup

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("concurrency", type=int, nargs="*", default=[8, 4], help="closed-loop client counts")
    ap.add_argument("--requests", type=int, default=24, help="requests per load level")
    ap.add_argument("--buckets", default="4,8", help="engine batch buckets, comma-separated")
    ap.add_argument("--artifacts", default=None, metavar="DIR",
                    help="also measure each level with full artifact trees written to DIR")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="sd15")
    ap.add_argument("--steps", type=int, default=workload.STEPS)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    cuda = torch.device(args.device).type == "cuda"
    card = "cpu"
    if cuda:
        from guided_attention_tpu_torch.runtime.timing import card_name_and_power

        card = card_name_and_power()
    pipe = workload.create(args.device, args.model, torch.bfloat16 if cuda else torch.float32)
    engine = BatchingEngine(pipe, max_wait_ms=MAX_WAIT_MS, buckets=tuple(int(b) for b in args.buckets.split(",")))
    rows = []
    try:
        warmup(engine, num_inference_steps=args.steps)
        for c in args.concurrency:
            for art in (None, args.artifacts) if args.artifacts else (None,):
                row = {"model": args.model, "device": args.device, "card": card,
                       **run_load(engine, args.requests, c, artifact_dir=art, steps=args.steps)}
                rows.append(row)
                print(report(row, card), flush=True)
    finally:
        engine.close()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
