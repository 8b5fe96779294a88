"""s/image of batched generation, one prompt or several, on one device.

    python -m guided_attention_tpu_torch.perf_batch [--multi] [--device cpu]
        [--model sd15] [--steps 50] [--reps 3] [batch_size ...]   (default: 1 4 8)

For each batch size B: one warm-up batch, then ``--reps`` timed batches of
new seeds (``workload.generate_batch``: the main path's guided generation,
B images per call), the host clock around each call ending in
``torch.cuda.synchronize()``. Prints, per size, the median s/batch and
s/image with every call's time, the model-FLOP share (the UNet work of the
batch's samples, ``runtime/flops.generation_flops`` from each sample's
counters, over the median time and the bf16 peak), the peak device memory,
and the card's name and power limit; one JSON line per size goes to
``--out`` (``chiprun_out/perf_batch.json``). ``--multi`` alternates the two
``workload.BATCH_PROMPTS`` over the batch, else every sample takes
``workload.META_PROMPT``.

The JAX script's ``--pipelined`` (chunk i+1 dispatched before chunk i is
read) has no counterpart: the port's loop reads a host bool per eval, so
a dispatch returns only when its work is done and there is no asynchrony
to overlap.

On ``--device cpu`` (at ``--model micro`` for a quick drive) the times are
the CPU's, and MFU and peak device memory read as not measured.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import List, Optional

import torch

from guided_attention_tpu_torch import workload
from guided_attention_tpu_torch.runtime import flops

OUT = os.path.join("chiprun_out", "perf_batch.json")


def measure(pipe, batch: int, multi: bool, steps: int, reps: int) -> dict:
    """One warm-up batch, then ``reps`` timed batches of ``batch`` samples."""
    cuda = pipe.sd.device.type == "cuda"
    prompts = workload.batch_prompts(batch) if multi else [workload.META_PROMPT] * batch

    def sync():
        if cuda:
            torch.cuda.synchronize()

    workload.generate_batch(pipe, list(range(100, 100 + batch)), prompts, steps)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    walls, outs = [], None
    for rep in range(reps):
        seeds = list(range(200 + rep * batch, 200 + (rep + 1) * batch))
        t0 = time.perf_counter()
        outs = workload.generate_batch(pipe, seeds, prompts, steps)
        sync()
        walls.append(time.perf_counter() - t0)
    sec = statistics.median(walls)
    # the last batch's counters stand for the work of every timed batch
    work = sum(flops.generation_flops(pipe.sd.unet.config, o.diagnostics, steps) for o in outs)
    return {
        "batch": batch,
        "multi_prompt": multi,
        "steps": steps,
        "s_per_batch": sec,
        "s_per_image": sec / batch,
        "walls_s": walls,
        "unet_tflop_per_batch": work / 1e12,
        "mfu": flops.mfu(work, sec) if cuda else None,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
        "n_evals_per_sample": [int(o.diagnostics.n_evals.sum()) for o in outs],
    }


def main(argv: Optional[List[str]] = None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sizes", nargs="*", type=int, default=[1, 4, 8])
    parser.add_argument("--multi", action="store_true", help="alternate the two batch prompts")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--model", default="sd15")
    parser.add_argument("--steps", type=int, default=workload.STEPS)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args(argv)

    cuda = torch.device(args.device).type == "cuda"
    card = "cpu"
    if cuda:
        from guided_attention_tpu_torch.runtime.timing import card_name_and_power

        card = card_name_and_power()
    pipe = workload.create(args.device, args.model, torch.bfloat16 if cuda else torch.float32)
    rows = []
    for batch in args.sizes:
        row = {"model": args.model, "device": args.device, "card": card,
               **measure(pipe, batch, args.multi, args.steps, args.reps)}
        rows.append(row)
        tag = " [multi-prompt]" if args.multi else ""
        mfu = "not measured" if row["mfu"] is None else f"{100 * row['mfu']:.3f}%"
        mem = "not measured" if row["peak_mem_gib"] is None else f"{row['peak_mem_gib']:.3f} GiB"
        print(f"batch {batch}{tag}: {row['s_per_image']:.3f} s/image ({row['s_per_batch']:.3f} s/batch, "
              f"walls {[round(t, 3) for t in row['walls_s']]}), MFU {mfu}, peak {mem} ({card})", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
