"""Open-loop serving: independent users' requests, each a layout of its own
and a distinct seed, submitted in process to the port's
``frontends.server.BatchingEngine`` at fixed times whether or not earlier
ones have finished. Every request due in the window is drained, and each
is timed from when it was due to when its result is in hand.

The arrivals are Poisson in distribution at the mix's rate, and the same
for every seed: the gaps are the exponential's quantiles at (k + 1/2) / N,
N = rate x window, put in an order drawn from the seed. So a seed changes
which request comes when, not how many come nor how they bunch overall.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np

from cuda_bench.traffic.common import knobs, layout, seed_block


class TimedPipe:
    """The engine's pipeline: the port's, with the benchmark's span around
    each ``dispatch_batch`` (to the host copy of its results), and the
    batch's rows and results kept for the check."""

    def __init__(self, pipe, ctx):
        self._pipe = pipe
        self._ctx = ctx

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def dispatch_batch(self, seeds, meta_prompt=None, meta_prompts=None, **kw):
        prompts = list(meta_prompts) if meta_prompts is not None else [meta_prompt] * len(seeds)
        rec = self._ctx.recorder
        batch = rec.begin(seeds, prompts) if self._ctx.state.get("recording") else None
        t0 = time.perf_counter()
        pending = self._pipe.dispatch_batch(seeds, meta_prompt=meta_prompt, meta_prompts=meta_prompts, **kw)
        return _Pending(pending, batch, t0, self._ctx)


class _Pending:
    def __init__(self, pending, batch, t0, ctx):
        self.pending, self.batch, self.t0, self.ctx = pending, batch, t0, ctx

    def result(self):
        outs = self.pending.result()
        end = time.perf_counter()
        self.ctx.state.setdefault("spans", []).append((self.t0, end, len(outs)))
        if self.batch is not None:
            self.batch.start, self.batch.end, self.batch.outputs = self.t0, end, outs
            self.ctx.recorder.end()
        return outs


def gaps(rate: float, seconds: float) -> np.ndarray:
    """N = rate x seconds gaps: the exponential's quantiles, scaled to sum
    to ``seconds``."""
    n = max(int(round(rate * seconds)), 1)
    g = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    return g * (seconds / g.sum())


def arrivals(rate: float, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Due times in [0, seconds): the first at 0, then the gaps in a seeded
    order (the last gap leads past the window)."""
    g = gaps(rate, seconds)
    return np.concatenate([[0.0], np.cumsum(g[rng.permutation(len(g))])[:-1]])


def warmup(ctx) -> None:
    """The engine, and one short generation at each of its buckets."""
    from guided_attention_tpu_torch.frontends.server import BatchingEngine

    mix = ctx.mix
    engine = BatchingEngine(TimedPipe(ctx.pipe, ctx), max_wait_ms=mix["max_wait_ms"], buckets=tuple(mix["buckets"]))
    ctx.state["engine"] = engine
    ctx.on_close(engine.close)
    kn = knobs(mix, ctx.sd_2_1)
    kn["num_inference_steps"] = mix["warmup_steps"]
    rng = np.random.default_rng(0)
    for b in mix["buckets"]:
        tickets = [engine.submit(layout(rng, mix), seed=i, **kn) for i in range(b)]
        for t in tickets:
            t.result(timeout=600)


def _serve(ctx, seconds: float, rng: np.random.Generator) -> Dict:
    mix, engine = ctx.mix, ctx.state["engine"]
    kn = knobs(mix, ctx.sd_2_1)
    due = arrivals(mix["rate_per_s"], seconds, rng)
    prompts = [layout(rng, mix) for _ in due]
    base = seed_block(rng)
    done: List[float] = [float("nan")] * len(due)
    errors: List[str] = []
    tickets, waiters = [], []

    def wait(k, ticket):
        try:
            ticket.result(timeout=mix["drain_timeout_s"])
            done[k] = time.perf_counter()
        except Exception as e:  # a failed request counts as missing its latency
            errors.append(f"request {k}: {type(e).__name__}: {e}")

    late = 0.0
    t0 = time.perf_counter()
    ctx.mark_window_start(t0)
    for k, d in enumerate(due):
        pause = t0 + d - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        late = max(late, time.perf_counter() - (t0 + d))
        ticket = engine.submit(prompts[k], seed=base + k, **kn)
        tickets.append(ticket)
        w = threading.Thread(target=wait, args=(k, ticket), daemon=True)
        w.start()
        waiters.append(w)
    for w in waiters:
        w.join(mix["drain_timeout_s"])
    lat = [done[k] - (t0 + d) for k, d in enumerate(due) if done[k] == done[k]]
    return {"t0": t0, "due": due, "done": done, "latencies": lat, "tickets": tickets, "errors": errors,
            "lateness_s": late, "attempted": len(due), "failed": len(due) - len(lat),
            "window_s": max([x for x in done if x == x], default=t0) - t0}


def run(ctx) -> dict:
    engine = ctx.state["engine"]
    before = engine.snapshot()
    ctx.state["recording"] = True
    ctx.state["spans"] = []
    out = _serve(ctx, ctx.seconds, ctx.rng)
    ctx.state["recording"] = False
    after = engine.snapshot()
    batches = ctx.recorder.batches
    # each request's output must be the row made for its own seed and prompt
    owner = {}
    for bi, batch in enumerate(batches):
        for row, o in enumerate(batch.outputs or ()):
            owner[id(o)] = (bi, row)
    for t in out["tickets"]:
        if t._output is None:
            continue
        bi, row = owner.get(id(t._output), (None, None))
        if bi is None or (batches[bi].seeds[row], batches[bi].prompts[row]) != (t.seed, t.meta_prompt):
            batches[bi if bi is not None else 0].delivery_errors += 1
    out.update(batches=batches, stats={k: after[k] - before[k] for k in ("requests", "samples", "padded_samples",
                                                                           "batches", "errors")},
               busy_s=sum(e - s for s, e, _n in ctx.state["spans"]),
               served_rows=[(bi, row) for bi, b in enumerate(batches) for row in range(len(b.seeds))
                            if row < len(b.seeds) - _padding(b)])
    return out


def _padding(batch) -> int:
    """Rows the engine added to fill its bucket: repeats of the last row's
    request at the end of the batch."""
    n = 0
    while n + 1 < len(batch.seeds) and batch.seeds[-1 - n - 1] == batch.seeds[-1] and \
            batch.prompts[-1 - n - 1] == batch.prompts[-1]:
        n += 1
    return n


def traced(ctx, profile) -> dict:
    """A further stretch of the same arrivals, under ``profile``."""
    with profile():
        t0 = time.perf_counter()
        out = _serve(ctx, ctx.mix["trace_seconds"], np.random.default_rng(ctx.seed + 1))
        wall = time.perf_counter() - t0
    return {"rows": out["attempted"], "wall_s": wall}
