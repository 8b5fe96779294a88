"""How much of one guided generation is the host issuing work, and how much
the device: the split of one call's wall time.

    python -m guided_attention_tpu_torch.perf_host_tail [--steps 50] [--reps 4] [--quick]
        [--device cuda|cpu]

Counterpart of the JAX package's ``scripts/perf_host_tail.py``. Runs the
main path (``workload.py``: guided 512x512 SD1.5, bf16, the two-object
meta-prompt) through ``pipe.dispatch(...)`` and ``.result()``. After one
warm-up call with ``decode`` True and one with False, ``--reps`` rounds of
two calls (decode True, then False; every call its own seed) give:

* the ``dispatch`` wall and the ``result()`` wall of each call. The port's
  dispatch returns when its work is done: its loop reads a host value at
  every guidance eval (``pipeline.py``: the threshold test after each eval,
  and the step-0 one before the update gate), so it holds the device's time
  too; ``result()`` pulls what stayed on the device: the uint8 image with
  decode, else the latents, and the step diagnostics;
* the pull-size delta: the median ``result()`` with decode less without;
* the round-trip floor: ``.item()`` of a scalar already on the device, the
  least of 6;
* the device-to-host bandwidth of an 8 MB tensor already on the device, the
  best of 3;
* from one more call (decode True) under ``torch.profiler`` (CPU and CUDA
  activities): the device's kernel time and busy share (kernel time over
  the wall); the host's seconds **blocked** on the device, the CPU time of
  the ops that own a device-to-host copy (the loop's host reads,
  ``aten::_local_scalar_dense`` and the copies of ``tolist``, and
  ``result()``'s pulls), and their count; and the host's **issue** time,
  the wall less the blocked time. A call whose blocked time is near zero
  never waits for the device: the host bounds it. The profiler's own cost
  per op lands in the issue time.

Prints each call, the medians, the floors and the split, the card's name
and power limit, and one JSON line. ``--quick`` runs micro in float32 on the
CPU: there is no device there, so the floors and the split's device and
blocked fields read as not measured.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List, Optional

import torch

from guided_attention_tpu_torch import workload

WARMUP_SEEDS = (90, 91)  # decode True, False
PROFILED_SEED = 999
RTT_TRIES = 6
BANDWIDTH_TRIES = 3
BANDWIDTH_SHAPE = (4, 1024, 1024)  # int16: 8 MB (8,388,608 bytes)


def one_call(pipe, seed: int, decode: bool, steps: int):
    """(dispatch wall, result wall, output) of one main-path call."""
    t0 = time.perf_counter()
    pending = pipe.dispatch(meta_prompt=workload.META_PROMPT, seed=seed, num_inference_steps=steps,
                            sd_2_1=workload.is_sd21(pipe), decode=decode, capture_diagnostics=False)
    t_dispatch = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = pending.result()
    t_result = time.perf_counter() - t0
    if (out.images_u8 is not None) != decode:
        raise RuntimeError(f"decode={decode} returned images_u8={out.images_u8 is not None}")
    return t_dispatch, t_result, out


def floors(device: torch.device) -> dict:
    """The scalar round trip (least of ``RTT_TRIES``) and the 8 MB
    device-to-host bandwidth (best of ``BANDWIDTH_TRIES``) of a CUDA
    device."""
    if device.type != "cuda":
        raise ValueError(f"floors: the round trip and the bandwidth are a CUDA device's, got {device}")
    scalar = torch.ones((), device=device) + 0
    big = torch.zeros(BANDWIDTH_SHAPE, dtype=torch.int16, device=device) + 0
    torch.cuda.synchronize()
    rtts, pulls = [], []
    for _ in range(RTT_TRIES):
        t0 = time.perf_counter()
        scalar.item()
        rtts.append(time.perf_counter() - t0)
    for _ in range(BANDWIDTH_TRIES):
        t0 = time.perf_counter()
        big.cpu()
        pulls.append(time.perf_counter() - t0)
    nbytes = big.numel() * big.element_size()
    return {"rtt_floor_ms": 1e3 * min(rtts), "rtts_ms": [1e3 * t for t in rtts], "pull_bytes": nbytes,
            "pull_mb_per_s": nbytes / 1e6 / min(pulls), "pulls_ms": [1e3 * t for t in pulls]}


def split(prof, wall: float) -> dict:
    """Device kernel time and busy share, and the host's blocked time (the
    spans of the CPU ops that own a device-to-host copy, merged per thread)
    and issue time, from a profile of one call of ``wall`` seconds."""
    from torch.autograd import DeviceType

    from guided_attention_tpu_torch.profile import is_device_work

    results = prof.profiler.kineto_results
    ops, dtoh_owners, device_us = {}, set(), 0.0
    for e in results.events():
        dtype = e.device_type()
        if dtype == DeviceType.CPU:
            if e.linked_correlation_id() == 0 and e.correlation_id() > 0:
                ops[e.correlation_id()] = (e.start_thread_id(), e.start_ns(), e.end_ns(), e.name())
        elif dtype == DeviceType.CUDA and is_device_work(e):
            device_us += e.duration_ns() / 1e3
            name = e.name()
            if "DtoH" in name or "Device -> Pageable" in name or "Device -> Pinned" in name:
                dtoh_owners.add(e.linked_correlation_id())
    spans = sorted(ops[c] for c in dtoh_owners if c in ops)
    blocked_ns, merged = 0, None
    for thread, start, end, _name in spans:  # merged per thread: a nested owner counts once
        if merged is not None and merged[0] == thread and start < merged[2]:
            merged[2] = max(merged[2], end)
            continue
        if merged is not None:
            blocked_ns += merged[2] - merged[1]
        merged = [thread, start, end]
    if merged is not None:
        blocked_ns += merged[2] - merged[1]
    blocked = blocked_ns / 1e9
    reads = {}
    for _t, _s, _e, name in spans:
        reads[name] = reads.get(name, 0) + 1
    return {"profiled_wall_s": wall, "device_kernel_ms": device_us / 1e3,
            "device_busy_share": device_us / 1e6 / wall, "blocked_s": blocked, "blocked_ops": len(spans),
            "blocked_ops_by_name": reads, "issue_s": wall - blocked, "blocked_share": blocked / wall}


def measure(pipe, steps: int = workload.STEPS, reps: int = 4, warmup: bool = True) -> dict:
    """The host tail of ``pipe``'s main-path call: walls, floors and the
    profiled split (the split and floors on CUDA only). ``warmup=False``
    skips the two warm-up calls, for a pipeline that has already run."""
    cuda = pipe.sd.device.type == "cuda"
    for seed, decode in zip(WARMUP_SEEDS if warmup else (), (True, False)):
        one_call(pipe, seed, decode, steps)
    calls = []
    for rep in range(reps):
        for decode in (True, False):
            t_dispatch, t_result, _out = one_call(pipe, 1000 + 2 * rep + int(decode), decode, steps)
            calls.append({"rep": rep, "decode": decode, "dispatch_s": t_dispatch, "result_s": t_result})
    res_img = statistics.median(c["result_s"] for c in calls if c["decode"])
    res_lat = statistics.median(c["result_s"] for c in calls if not c["decode"])
    row = {
        "steps": steps,
        "reps": reps,
        "calls": calls,
        "dispatch_s": statistics.median(c["dispatch_s"] for c in calls),
        "result_decode_s": res_img,
        "result_latents_s": res_lat,
        "pull_size_delta_s": res_img - res_lat,
        "rtt_floor_ms": None, "pull_mb_per_s": None, "split": None,
    }
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        row.update(floors(pipe.sd.device))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_call(pipe, PROFILED_SEED, True, steps)
            wall = time.perf_counter() - t0
        row["split"] = split(prof, wall)
    return row


def report(row: dict, card: str) -> List[str]:
    """The lines ``main`` prints."""
    lines = [f"rep {c['rep']} decode={int(c['decode'])}: dispatch {1e3 * c['dispatch_s']:9.1f} ms  result "
             f"{1e3 * c['result_s']:8.1f} ms  wall {1e3 * (c['dispatch_s'] + c['result_s']):9.1f} ms"
             for c in row["calls"]]
    lines += [
        f"median dispatch         : {1e3 * row['dispatch_s']:9.1f} ms (the whole loop: a host read at every eval)",
        f"median result(), decode : {1e3 * row['result_decode_s']:9.1f} ms (uint8 image pull)",
        f"median result(), latents: {1e3 * row['result_latents_s']:9.1f} ms (latents-only pull)",
        f"pull-size delta         : {1e3 * row['pull_size_delta_s']:9.1f} ms",
    ]
    if row["rtt_floor_ms"] is None:
        lines.append("round-trip floor, bandwidth, split: not measured (no device)")
    else:
        s = row["split"]
        lines += [
            f"scalar .item() round trip: {row['rtt_floor_ms']:9.3f} ms (floor, least of {RTT_TRIES})",
            f"8 MB pull bandwidth     : {row['pull_mb_per_s']:9.1f} MB/s",
            f"profiled call: wall {s['profiled_wall_s']:.3f} s, device kernels {s['device_kernel_ms']:.1f} ms "
            f"(busy {100 * s['device_busy_share']:.1f}%), host blocked {s['blocked_s']:.3f} s in "
            f"{s['blocked_ops']} device-to-host ops ({100 * s['blocked_share']:.1f}%), host issuing "
            f"{s['issue_s']:.3f} s",
            f"blocked ops: {json.dumps(s['blocked_ops_by_name'])}",
        ]
    lines.append(card)
    return lines


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=workload.STEPS)
    parser.add_argument("--reps", type=int, default=4)
    parser.add_argument("--quick", action="store_true", help="micro in float32 on the CPU")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = "cpu" if args.quick else args.device
    cuda = torch.device(device).type == "cuda"
    # raises without a card when the device is CUDA (the default)
    pipe = workload.create(device, "micro" if args.quick else "sd15", torch.bfloat16 if cuda else torch.float32)
    card = "cpu"
    if cuda:
        from guided_attention_tpu_torch.runtime.timing import card_name_and_power

        card = card_name_and_power()
    row = {"model": pipe.sd.config.name, "device": device, "card": card, **measure(pipe, args.steps, args.reps)}
    for line in report(row, card):
        print(line, flush=True)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
