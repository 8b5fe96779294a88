"""Closed-loop seed sweep: back-to-back batches of successive seeds of one
layout through ``GuidedAttentionPipeline.dispatch_batch``, each batch
waited for (its results on the host) before the next is sent. The rate
is every image completed over the time from the window's start to the
end of the last batch started in it."""
from __future__ import annotations

import time

from cuda_bench.traffic.common import knobs, layout, seed_block

WARMUP_LAYOUT_SEED = 0


def warmup(ctx) -> None:
    """One short batch at the mix's batch size, of another layout: every
    kernel, shape and path the window runs (evals, refinement, re-noise,
    CFG, decode) is built and run once."""
    import numpy as np

    mix = ctx.mix
    kn = knobs(mix, ctx.sd_2_1)
    kn["num_inference_steps"] = mix["warmup_steps"]
    prompt = layout(np.random.default_rng(WARMUP_LAYOUT_SEED), mix)
    ctx.pipe.dispatch_batch(list(range(mix["batch"])), meta_prompt=prompt, **kn).result()


def _batch(ctx, seeds, prompt, kn):
    batch = ctx.recorder.begin(seeds, [prompt] * len(seeds))
    batch.start = time.perf_counter()
    batch.outputs = ctx.pipe.dispatch_batch(seeds, meta_prompt=prompt, **kn).result()
    batch.end = time.perf_counter()
    ctx.recorder.end()
    return batch


def run(ctx) -> dict:
    mix = ctx.mix
    B = mix["batch"]
    kn = knobs(mix, ctx.sd_2_1)
    prompt = layout(ctx.rng, mix)
    base = seed_block(ctx.rng)
    ctx.state.update(prompt=prompt, base=base, kn=kn, next=0)
    t0 = time.perf_counter()
    ctx.mark_window_start(t0)
    batches = []
    while time.perf_counter() - t0 < ctx.seconds:
        k = ctx.state["next"]
        batches.append(_batch(ctx, [base + k * B + j for j in range(B)], prompt, kn))
        ctx.state["next"] = k + 1
    images = B * len(batches)
    return {"batches": batches, "window_s": batches[-1].end - t0, "images": images,
            "attempted": images, "failed": 0,
            "batch_walls": [b.end - b.start for b in batches]}


def traced(ctx, profile) -> dict:
    """One more batch of the sweep, under ``profile`` (a context manager)."""
    B = ctx.mix["batch"]
    k = ctx.state["next"]
    seeds = [ctx.state["base"] + k * B + j for j in range(B)]
    with profile():
        t0 = time.perf_counter()
        outs = ctx.pipe.dispatch_batch(seeds, meta_prompt=ctx.state["prompt"], **ctx.state["kn"]).result()
        wall = time.perf_counter() - t0
    return {"rows": B, "wall_s": wall, "diags": [(o.diagnostics.n_evals, o.diagnostics.recursions) for o in outs]}
