"""Reproducibility of the guided path under PyTorch's default algorithms,
and what its repair costs.

    python -m guided_attention_tpu_torch.determinism [--steps 15] [--timed]

A guided image runs the guidance eval's backward (``torch.autograd.grad``
from the token losses through the truncated UNet to the latent). The CUDA
backward of ``F.pad(mode="reflect")`` accumulates with atomics, so it may
sum in another order on each call; a one-ulp change in a token loss can
flip a refinement test, and the steps after it carry the change on. The
guidance smoothing therefore pads with ``smoothing.reflect_pad`` (slices
and ``cat``, no atomics).

Two forms of the padding: ``port`` (the package as it is) and ``old``
(``F.pad``). Each runs the main path's guided image (``workload.META_PROMPT``,
seed ``workload.TIMED_SEED``, ``--steps`` steps) ``IMAGE_RUNS`` times and a
batch of two seeds twice, and reports whether the final latents are bitwise
equal to the first run's, their largest difference over max|latent|, and
the first (step, eval slot) whose logged losses differ. The fault does not
show on every pair of runs, so the image runs more than twice. ``--timed``
then times the main path's 50-step image in seconds per image, alternating
(old, port, port, old, old, port after a warm-up). Deterministic algorithms
stay off throughout.

Prints one JSON line; the full record goes to ``chiprun_out/determinism.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from guided_attention_tpu_torch import workload
from guided_attention_tpu_torch.guidance import smoothing

FORMS = ("port", "old")
IMAGE_RUNS = 4
OUT_DIR = "chiprun_out"


def _reflect_pad_old(x, pad):
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


@contextlib.contextmanager
def padding(form: str):
    """Run the guidance smoothing with the port's padding or ``F.pad``'s."""
    saved = smoothing.reflect_pad
    if form == "old":
        smoothing.reflect_pad = _reflect_pad_old
    try:
        yield
    finally:
        smoothing.reflect_pad = saved


def compare(a, b) -> dict:
    """Bitwise equality of two runs' final latents, their largest difference
    over max|latent|, and the first (step, slot) whose logged losses differ."""
    la, lb = np.asarray(a.latents, np.float32), np.asarray(b.latents, np.float32)
    diff = np.argwhere((a.diagnostics.eval_unscaled != b.diagnostics.eval_unscaled).any(axis=-1))
    return {"bitwise_equal": bool(np.array_equal(la, lb)),
            "rel_max_err": float(np.abs(la - lb).max() / np.abs(lb).max()),
            "first_loss_diff_step_slot": [int(v) for v in diff[0]] if len(diff) else None}


def run(steps: int = 15, timed: bool = False, device: str = "cuda") -> dict:
    pipe = workload.create(device)
    record = {"deterministic_algorithms": torch.are_deterministic_algorithms_enabled(), "steps": steps,
              "image_runs": IMAGE_RUNS, "forms": {}}
    image = dict(meta_prompt=workload.META_PROMPT, seed=workload.TIMED_SEED, num_inference_steps=steps,
                 decode=False, capture_diagnostics=True)
    batch = dict(meta_prompt=workload.META_PROMPT, num_inference_steps=steps, decode=False, capture_diagnostics=False)
    seeds = [workload.TIMED_SEED, workload.TIMED_SEED + 1]
    pipe(**{**image, "num_inference_steps": 2})  # warm-up
    for form in FORMS:
        with padding(form):
            runs = [pipe(**image) for _ in range(IMAGE_RUNS)]
            b1, b2 = pipe.generate_batch(seeds, **batch), pipe.generate_batch(seeds, **batch)
        one = {"image_vs_first": [compare(r, runs[0]) for r in runs[1:]],
               "batch_of_2_bitwise_equal": all(np.array_equal(x.latents, y.latents) for x, y in zip(b1, b2))}
        record["forms"][form] = one
        print(f"{form:5s} {json.dumps(one)}", flush=True)
    if timed:
        times = {form: [] for form in FORMS}
        workload.generate(pipe, workload.WARMUP_SEED)
        for form in ("old", "port", "port", "old", "old", "port"):
            with padding(form):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                workload.generate(pipe, workload.TIMED_SEED)
                torch.cuda.synchronize()
                times[form].append(time.perf_counter() - t0)
        record["s_per_image"] = times
        print("s/image, 50 steps: " + json.dumps(times), flush=True)
    return record


def main(argv=None) -> int:
    from guided_attention_tpu_torch.runtime.timing import card_name_and_power

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--timed", action="store_true")
    args = ap.parse_args(argv)
    card = card_name_and_power()
    print(card, flush=True)
    record = run(args.steps, args.timed)
    record["card"] = card
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "determinism.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({form: [v["bitwise_equal"] for v in r["image_vs_first"]] + [r["batch_of_2_bitwise_equal"]]
                      for form, r in record["forms"].items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
