"""Timing on the card with CUDA events, and the card's name and power limit.

Shared by ``chip_smoke.py`` and ``perf_attn_kernel.py``. A time is the
median over repetitions of one burst of ``calls`` back-to-back calls between
two CUDA events, divided by ``calls``: the host queues the next call while
the card runs the last, so the host's own latency per call (large for an
autograd backward, whose kernels are launched from the autograd engine's
thread) stays out of the device time as long as the card is the slower of
the two. Between calls the inputs stay in the 50 MB L2 cache wherever they
fit (warm L2), as they do when the generation path calls a kernel right
after the layer that made its inputs. Each measurement needs a CUDA device:
there is no CPU fallback.

A kernel that runs in microseconds is faster than the host can queue it:
an event burst then times the host's launch path (ctypes, allocation).
``graph_alternating_ms`` captures a burst of calls once into a CUDA graph
and times replays of it between events, so only the card's time is left.
"""
from __future__ import annotations

import functools
import statistics
import subprocess
from typing import Callable, Dict


def card_name_and_power() -> str:
    """The line ``nvidia-smi --query-gpu=name,power.limit`` prints for the
    first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi unavailable"


def _burst_ms(fn: Callable[[], object], calls: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def alternating_ms(fns: Dict[str, Callable[[], object]], reps: int = 20, warmup: int = 3,
                   calls: int = 10) -> Dict[str, float]:
    """Median per-call time of each function, in ms, with the functions
    taking turns burst by burst (a, b, c, a, b, c, ...), so that a drift of
    the clocks or the power draw during the run falls on all of them alike."""
    import torch

    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    times: Dict[str, list] = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            times[name].append(_burst_ms(fn, calls))
    return {name: statistics.median(t) for name, t in times.items()}


@functools.lru_cache(maxsize=None)
def _capture_stream(device_index: int):
    """One side stream per card for every warm-up and capture: each stream
    that runs a cuBLAS product keeps a workspace allocated for the life of
    the process, which a new stream per call would add to the allocated
    memory (and to a later peak-memory reading) every time."""
    import torch

    return torch.cuda.Stream(device=device_index)


def graph_alternating_ms(fns: Dict[str, Callable[[], object]], reps: int = 20, warmup: int = 3,
                         calls: int = 10) -> Dict[str, float]:
    """As ``alternating_ms``, but each burst of ``calls`` calls is captured
    once into a CUDA graph (after ``warmup`` eager calls on the side stream
    that captures, as capture requires) and the timed bursts are replays of
    it."""
    import torch

    side = _capture_stream(torch.cuda.current_device())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            for fn in fns.values():
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = {}
    for name, fn in fns.items():
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
        graphs[name] = graph
    for graph in graphs.values():
        graph.replay()
    torch.cuda.synchronize()
    times: Dict[str, list] = {name: [] for name in fns}
    for _ in range(reps):
        for name, graph in graphs.items():
            times[name].append(_burst_ms(graph.replay, 1) / calls)
    return {name: statistics.median(t) for name, t in times.items()}
