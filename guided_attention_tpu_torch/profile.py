"""Where the device time of one guided generation goes.

    python -m guided_attention_tpu_torch.profile [--batch]

Runs the main path (``workload.py``: guided 512x512 SD1.5, 50 steps, bf16,
on the CUDA device), or with ``--batch`` the batch path
(``workload.generate_batch``: ``BATCH_SEEDS`` under the two
``BATCH_PROMPTS``, B = 4 images per call): one warm-up call, then one call
under ``torch.profiler`` (CPU and CUDA activities), and prints one JSON
line: wall seconds, summed device kernel time and kernel launches (in all
and per image), the device's busy share, and kernel time by family (the
port's three kernels, convolutions, matrix products, norms, ...). The full
table goes to ``chiprun_out/profile.json`` (``profile_batch.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from guided_attention_tpu_torch import workload

OUT_DIR = "chiprun_out"

# first matching substring (lower-cased kernel name) names the family
FAMILIES = (
    ("k1_flash_self_fwd", ("flash_self_fwd",)),
    ("k2_flash_self_bwd", ("dkdv_kernel", "dq_kernel")),
    ("k3_cross_map", ("cross_map_kernel",)),
    ("conv", ("conv", "implicit", "winograd", "fprop", "dgrad", "wgrad", "nhwc", "nchw")),
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "sm90", "matmul")),
    ("norm", ("group_norm", "layer_norm", "norm")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("copy_cast", ("copy", "cast", "cat", "fill")),
    ("elementwise", ("elementwise", "vectorized")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", action="store_true", help="profile the batch path (B = 4)")
    args = parser.parse_args(argv)

    def run(timed: bool):
        if args.batch:
            seeds = workload.BATCH_SEEDS if timed else [workload.WARMUP_SEED] * len(workload.BATCH_SEEDS)
            return workload.generate_batch(pipe, seeds)
        return [workload.generate(pipe, workload.TIMED_SEED if timed else workload.WARMUP_SEED)]

    pipe = workload.create("cuda")
    run(timed=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = run(timed=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    by_family: dict = {}
    kernels = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = _self_device_us(evt)
        if us <= 0:
            continue
        fam = family(evt.key)
        by_family[fam] = by_family.get(fam, 0.0) + us / 1e3
        kernels.append({"name": evt.key[:160], "family": fam, "ms": us / 1e3, "count": evt.count})
    kernels.sort(key=lambda k: -k["ms"])
    device_ms = sum(by_family.values())
    launches = sum(k["count"] for k in kernels)
    images = len(outs)
    summary = {
        "model": "sd15",
        "steps": workload.STEPS,
        "images": images,
        "wall_s": wall,
        "device_kernel_ms": device_ms,
        "device_kernel_ms_per_image": device_ms / images,
        "launches": launches,
        "launches_per_image": launches / images,
        "device_busy_share": device_ms / 1e3 / wall if wall > 0 else None,
        "n_evals_total": sum(int(o.diagnostics.n_evals.sum()) for o in outs),
        "family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
    }
    out_path = os.path.join(OUT_DIR, "profile_batch.json" if args.batch else "profile.json")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"summary": summary, "kernels": kernels}, f, indent=1)
    print(json.dumps(summary), flush=True)
    for k in kernels[:25]:
        print(f"{k['ms']:10.2f} ms {k['count']:6d}x {k['family']:18s} {k['name'][:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
