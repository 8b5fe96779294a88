#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--phases 1,2,3,13]

``--phases`` runs the phases it names, with the card and the build (1, 2)
and the phases they read from (9 and 12 read phase 8's tree, 10 reads
phase 6's batch, 13 reads phase 5's image, 14 runs on phase 5's warm
pipeline); without it, every phase. The kernels line needs phase 3.
Phases:
  1. the card's name and power limit, torch/CUDA versions, TF32 settings;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes its path gives it (bf16, forward and gradient): K1-K3 of the
     generation path (K1's logsumexp too, and every K1 tile configuration
     at a ragged shape; K2 against its plain version and autograd, at a
     ragged shape, in every tile configuration, and run twice for bitwise
     equal gradients; K3 at SD1.5's and SD2.1's cross shapes and a ragged
     one, 77 and 33 keys, every tile configuration, run twice for bitwise
     equal out and map; K1-K3 also at the batch path's shapes, K1 [64,
     4096, 40], K2 [32, 4096, 40], K3 [4, 8, 256, 160], timed there too),
     V1 and W1 of the microbench (at head dim 40 and 64
     and a ragged shape, in every tile configuration; V1 without bf16_p
     to a tighter rms limit that a bf16-rounded P fails; W1 run twice for
     bitwise equal gradients); time kernel, plain
     version and a library yardstick with CUDA events (median of 20
     bursts of 10 calls, taking turns burst by burst; SDPA's backward
     replayed from a CUDA graph, so that the host does not time it; K3 and
     its plain version also as CUDA-graph bursts, ``graph_ms``);
  4. one guidance eval (loss and latent gradient) of full-width SD1.5 with
     the kernels against the same eval through the plain attention path;
  5. the main path: guided 512x512 SD1.5 generation, 50 DDIM steps, the
     two-object meta-prompt, default thresholds; one warm-up seed, then one
     timed seed with the kernels' launch counters zeroed just before it;
     K1-K3 must each have launched; its model-FLOP share of the bf16 peak;
  6. the batch path: ``workload.generate_batch``, B = 4 (two seeds under
     each of two prompts), full width and 50 steps, after a short warm-up
     batch, with the counters zeroed just before it: K1-K3 must each have
     launched; s/image, MFU and peak memory. Then at 15 steps with
     paint-with-words on, under PyTorch's default algorithms, a batch run
     twice must be bitwise equal and sample 0 must not move by a bit when
     the other samples' prompts change; each sample's distance to its
     one-sample run is printed; a standard-SD batch (10 steps) must agree
     with the one-sample runs of its seeds and prompts in float32 (and is
     printed in bf16); and the guided path's reproducibility: the main
     path's image at 15 steps, and a batch of two, each run twice under the
     default algorithms, bitwise equal;
  7. the microbench path (``perf_attn_kernel.run``, few reps) with the
     counters zeroed just before it: V1 and W1 must each have launched;
  8. the CLI path: ``frontends.cli.main`` in this process, sd15 bf16 at full
     width, 50 steps, the two-object meta-prompt, seeds 28 and 42, default
     flags, with ``--batch_size 1`` and ``--batch_size 2``, then one 15-step
     run with ``--diagnostic_level 1 --save_individual_ca_maps true``; the
     counters zeroed before each, K1-K3 must each launch in each; the
     artifact tree (under ``build/``) must hold the expected files, every
     final PNG must decode with the standard library's zlib to a
     512x512x3 image that is not constant, the grid must hold the two
     images, and the writer must be the native one; s/image of each sweep
     and its seconds of artifact writing;
  9. resumable runs and native checkpoints, sd15 bf16 at full width:
     ``generate_resumable`` of the main path's workload (50 steps,
     ``checkpoint_every=10``) bitwise equal to ``dispatch`` of its seed in
     latents and uint8 image, s/image of each in turns (dispatch,
     resumable, dispatch) and seconds per state write; the same run stopped
     after step 20 by ``on_segment`` and run again: resumed from step 20,
     bitwise equal, no state file left; that again with a threshold step
     at 30 added, so that the guidance evals run after the resume, with
     the counters zeroed before the resumed call: K1-K3 must each launch
     in it; ``generate_batch_resumable`` at B = 2, 15 steps,
     ``checkpoint_every=5``, stopped after step 10 and resumed, bitwise
     equal to ``generate_batch``; ``frontends.cli.main`` with
     ``--checkpoint_every 10`` for seed 28, whose final PNG must be phase
     8's byte for byte; ``models.io.save_params`` of the bundle
     into ``build/`` (removed after) and ``StableDiffusion.create(
     checkpoint_dir=)``: every tensor bitwise equal; its bytes, save and
     load seconds and peak memory;
 10. serving, sd15 bf16 at full width, 50 steps: (a) ``BatchingEngine``
     (buckets 1, 2, 4) filled with three requests (two seeds under
     ``BATCH_PROMPTS[0]``, one under ``[1]``) before its thread starts, the
     counters zeroed just before: one bucket-4 batch with one padded
     sample, each output bitwise equal (uint8 image and latents) to its
     sample of ``generate_batch`` of the padded seeds and prompts, K1-K3
     each launched in it; (b) ``make_server`` on 127.0.0.1: ``/healthz``
     names the card, four concurrent ``POST /generate`` of the main path
     (seeds 40-43, 0.1 s apart) form one batch whose PNGs decode to
     ``generate_batch`` of its seeds bit for bit, malformed requests get
     400, a 15-step ``save_artifacts`` request leaves its tree under
     ``build/``; (c) the web UI (``gui.run_server(once=True)``): ``GET /``
     returns the port's page and one ``POST /execute_function`` leaves a
     decodable ``static/output.png``; (d) ``perf_server.run_load`` at 1
     client (2 requests) and 4 (8), then a burst of 8 clients of one
     request each, all queued before the batcher starts; a smoke reading:
     s/image beside phase 6's, the batch sizes, min/p50/max latency beside
     the last batch's seconds. In the burst two groups of 4 wait at once,
     and the first must be delivered within 1.5 batch times (a loop that
     delivers a group after the next group's dispatch takes two);
 11. SD2.1-base, bf16 at full width (``workload.create(model="sd21")``:
     head dim 64, linear projections, gelu CLIP, the guidance normalized up
     to the prompt's end-of-text token): one guidance eval through the
     kernels against the plain route (phase 4's limits); the 50-step guided
     image (a warm-up seed, then the timed seed with the counters zeroed
     just before it): s/image, MFU, peak memory, K1-K3 launches (each must
     launch), evals, refinements and recursions, a well-formed 512x512
     image; the 15-step image twice, bitwise equal; ``frontends.cli.main
     --sd_2_1 true`` (one seed, 15 steps) writing its tree under
     ``build/``; parity traces (``parity_trace``): the sd21 bf16 trace
     through the kernels, 10 steps, from the command line and from
     ``trace(pipe, ...)`` on one saved initial latent, equal at tolerance
     0; the float32 trace on the plain route against it, printed per key (a
     reading, not a gate); and micro in float32, 4 steps, on the card and on
     the CPU from one latent and one stream of re-noise draws, equal at the
     default tolerances;
 12. data parallelism, sd15 bf16 at full width: (a) one process,
     ``generate_batch`` of two seeds at 15 steps with ``mesh=make_mesh()``
     bitwise equal to it without a mesh; (b) one rank per card and at least
     two (on a machine with one card, two ranks share it), one torchrun
     launch (``python -m torch.distributed.run --standalone
     --nproc_per_node N chip_smoke.py --data-parallel-rank DIR``, gloo):
     ``frontends.cli.main --seeds 28 42 --batch_size N --mesh_shape
     '{"data": N}'``, 50 steps, one sample per rank (the chunk padded with
     seed 42 beyond two ranks): rank 0's tree must hold phase 8's
     ``--batch_size 1`` files and its PNGs byte for byte, no other rank may
     write a file; (c) then, in the same ranks, ``generate_batch`` of four
     seeds under the two prompts at 15 steps: the whole batch on every
     rank, bitwise equal, each rank's rows bitwise this process's
     one-process batch of them, images on rank 0 only; each rank must
     launch K1-K3 in (b) and in (c); readings: (b)'s seconds and s/image
     beside phase 8's, the launch's wall time, each rank's launches;
 13. the tensor axis and the served mesh, sd15 at full width: (d) in this
     process, K1-K3 against their plain versions at the shapes a rank of
     {"data": 1, "tensor": 2} launches (4 of 8 heads: K1 [8, 4096, 40], K2
     [4, 4096, 40], K3 q [1, 4, 256, 160], a cluster of 4 blocks), timed,
     K1 beside SDPA's forward and K2 beside SDPA's graph backward;
     then one torchrun launch of two ranks (``--tensor-parallel-rank DIR``;
     on one card they share it and the tensor group is gloo, with two cards
     or more each has its own and the group is NCCL; the backend is
     printed): (a) a bf16 guidance eval through the kernels on each rank's
     heads against the one process's (phase 4's limits), equal on both
     ranks; (b) standard SD in float32 on the plain route, 10 steps, against
     one process (phase 6's limits); (c) the main path's 50-step image at
     tp2: well-formed, its step-0 evals and refinements phase 5's, s/image
     beside phase 5's, K1-K3 launches and shapes per rank, all-reduces and
     their bytes per image; (e) ``frontends.server`` over {"data": 2}
     (buckets 2, 4): rank 0 serves three HTTP requests (15 steps, one
     bucket-4 batch), rank 1 follows; every PNG byte for byte its rank's
     one-process ``generate_batch`` of its two rows; ``/healthz`` names the
     mesh; the server's stop ends the follower and both ranks exit 0;
 14. the measuring tools on phase 5's pipeline, sd15 bf16 at full width:
     (a) ``perf_unet``'s chain of 20 batch-2 CFG forwards and (b) of 20
     batch-1 guidance evals, each replayed from one CUDA graph and issued
     eagerly in turns: the graph's last output against the eager chain's
     (bitwise equality printed, gated at phase 6's float32 limits), K1 in
     the CFG graph and K1-K3 in the eval graph (the kernels of a profiled
     replay), ms per forward and per eval both ways and their ratio; (c)
     ``profile.run`` on the main path's call: its join of every kernel to
     its module and op must close in every family (within 0.5% in time,
     exactly in launches), the top 10 (module, op) keys of copy/cast and of
     other printed, the table in ``chiprun_out/profile_ops.json``; (d)
     ``perf_host_tail.measure`` (2 reps): the walls, floors and the split
     of one call into the host's blocked and issuing seconds. Readings: no
     time is gated;
 15. a {"kernels": [...]} line (phase 14 adds the launches captured into
     its graphs, which a replay does not count), then the last line
     {"ok": true, "device": {...}}.

Any failed check or exception exits non-zero before the last line. Weights
are random (flax-style init from a seed); the compute is SD1.5's, and
SD2.1's in phase 11. A full
log goes to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path

# the kernels of each path: every one must launch when its path is driven
MAIN_PATH_KERNELS = ("flash_self_fwd", "flash_self_bwd", "cross_attention_map_fwd")
MICROBENCH_KERNELS = ("flash_self_fwd_v1", "flash_self_bwd_w1")
MICROBENCH_REPS = 5
# the sources on csrc/hopper.cuh, whose ptxas lines are printed in full
HOPPER_SOURCES = ("flash_self_fwd.cu", "flash_self_bwd.cu", "flash_self_fwd_v1.cu", "flash_self_bwd_w1.cu",
                  "cross_attention_map.cu")
# the batch path's checks (phase 6)
BATCH_WARMUP_STEPS = 2
INDEPENDENCE_STEPS = 15  # threshold step 0 and every recursion step (0-14)
INDEPENDENCE_PWW_STOP = 15
F3_IMAGE_RUNS = 4  # the guided 15-step image, run this many times in phase 6
STANDARD_STEPS = 10
# samples 1-3 of the second independence batch: two groups, as in
# workload.BATCH_PROMPTS, other words and boxes
OTHER_PROMPTS = (
    "a [cat:.5,.5,.4,.4] and a [red car:.05,.05,.35,.4]",
    "a [lighthouse:.1,.55,.35,.4] and a [small boat:.6,.05,.3,.5]",
    "a [teapot:.3,.3,.4,.4] and a [green apple:.0,.6,.3,.35]",
)
# the standard-SD batch: four texts (standard SD reads no boxes)
STANDARD_PROMPTS = ("a robot and a blue vase", "a cat on a red sofa", "a lighthouse at dusk", "two apples on a table")
# Two runs of one guided batch are bitwise equal under PyTorch's default
# algorithms (the guidance smoothing's reflect padding is built from slices:
# the CUDA backward of F.pad(mode="reflect") accumulates with atomics and
# made two runs differ by a few percent of max|latent| by step 15;
# ``python -m guided_attention_tpu_torch.determinism``). Since no kernel of
# the batch reads another sample's rows, sample 0 of a batch whose other
# samples take other prompts is bitwise equal to sample 0 of the first
# batch. Any coupling of the samples (the paint-with-words score max over
# the whole batch, a row mixed up) moves it.
# Standard SD, a batch against one-sample runs, in float32 (plain attention:
# the kernels take bf16): the CFG forward runs at batch 8 against 2, so the
# products sum in other orders, about 2^-20 relative each, through 10
# steps. In bf16 the same comparison reads a few percent (rounding at other
# batch shapes), which cannot tell a fault from rounding; it is printed.
STANDARD_MAX_REL, STANDARD_RMS_REL = 2.0**-10, 2.0**-12


def log(*a):
    print(*a, flush=True)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float, results: dict, **extra) -> None:
    ok = err <= tol
    results.setdefault("checks", []).append({"name": name, "max_abs_err": err, "tol": tol, "ok": ok, **extra})
    more = "".join(f" {k}={v:.3e}" for k, v in extra.items())
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e}{more} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: error {err} above tolerance {tol}")


# Kernel against plain version, both on the same bf16 inputs. The kernel
# rounds its output to bf16 (8 significant bits) and rounds P and dS to bf16
# for the tensor-core products; the plain version rounds its output to bf16
# too. Two output roundings differ by at most one bf16 ulp, 2^-7 of the top
# of the largest value's binade, so within 2^-6 * max|ref|. The limits:
#   max|out - ref| <= 2^-5 * max|ref|   (room for 4 ulps at the largest value)
#   ||out - ref||_2 <= 2^-7 * ||ref||_2 (each rounding costs about 2^-9.5
#   relative rms; a 1% error in the scale moves the output by about 1% rms)
MAX_REL, RMS_REL = 2.0**-5, 2.0**-7
# K1's logsumexp (fp32, natural log, values near ln N): fp32 scores of the
# same bf16 inputs on both sides, summed in another order; the limit is
# absolute, as K2 uses it (exp(s - lse)): 2^-7 moves P by under 0.8%.
LSE_TOL = 2.0**-7
# V1 with bf16_p=0 carries P~ as a bf16 hi + lo pair (about 16 significant
# bits), so it differs from the fp32-P plain version by its output rounding
# alone, about 2^-12.5 relative rms. A kernel that drops the lo product
# rounds P~ to bf16, as bf16_p=1 does, and reads about 2^-9: a tighter rms
# limit between the two holds the lo half. Each V1 shape also checks that
# the bf16_p=1 kernel, held against the bf16_p=0 plain version, fails it.
V1_EXACT_P_RMS = 2.0**-10


def check_same(name: str, got, want, results: dict) -> None:
    """Every tensor of ``got`` bitwise equal to its counterpart in ``want``."""
    import torch

    same = all(torch.equal(a, b) for a, b in zip(got, want))
    results.setdefault("checks", []).append({"name": name, "bitwise_equal": same, "ok": same})
    log(f"  {name}: bitwise equal {'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit(f"{name}: two runs on the same inputs differ")


def rms_rel_err(out, ref) -> float:
    import torch

    diff = out.float() - ref.float()
    return float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(ref.float()))


def check_close(name: str, out, ref, results: dict, rms_tol: float = RMS_REL) -> float:
    """Hold ``out`` against ``ref`` by the two limits above (or a tighter
    ``rms_tol``); returns the absolute tolerance it applied to the max error."""
    ref_max = float(ref.float().abs().max())
    rms_rel = rms_rel_err(out, ref)
    if rms_rel > rms_tol:
        raise SystemExit(f"{name}: relative rms error {rms_rel} above {rms_tol}")
    tol = MAX_REL * ref_max
    check(name, max_err(out, ref), tol, results, ref_max=ref_max, rms_rel=rms_rel, rms_tol=rms_tol)
    return tol


def kernel_phase(results: dict) -> list:
    """Phase 3: compare and time K1, K2, K3, V1 and W1 at their paths' shapes."""
    import torch
    import torch.nn.functional as F

    from guided_attention_tpu_torch import perf_attn_kernel as pak
    from guided_attention_tpu_torch.ops import attention_variants as av
    from guided_attention_tpu_torch.ops import flash_attention as fa
    from guided_attention_tpu_torch.runtime.flops import bound_ms
    from guided_attention_tpu_torch.runtime.timing import alternating_ms, graph_alternating_ms

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    def timed(kernel, plain, library=None) -> dict:
        fns = {"ms": kernel, "plain_ms": plain}
        if library is not None:
            fns["library_ms"] = library
        return {"library_ms": None, **alternating_ms(fns)}

    def k1_bound(bh, n, d):  # q, k, v, o in bf16, the logsumexp in fp32
        return bound_ms(pak.fwd_flops(bh, n, d), 4 * bh * n * d * 2 + bh * n * 4, exps=bh * n * n)

    def k2_bound(bh, n, d):  # q, k, v, o, do, dq, dk, dv in bf16, the logsumexp in fp32
        return bound_ms(pak.bwd_flops(bh, n, d), 8 * bh * n * d * 2 + bh * n * 4, exps=bh * n * n)

    kernels = []
    # ---- K1 forward: SD2.1 D=64 (CFG call [2*5, 4096, 64], eval call
    # [5, 4096, 64]), a ragged [3, 1000, 40] (TMA zero-fill and the -inf key
    # mask), the batch path's CFG call [2*4*8, 4096, 40], eval call
    # [8, 4096, 40], CFG call [2*8, 4096, 40]
    log("K1 flash_self_fwd")
    k1_batch, k1_sd21 = {}, {}
    for bh, n, d in ((10, 4096, 64), (5, 4096, 64), (3, 1000, 40), (64, 4096, 40), (8, 4096, 40), (16, 4096, 40)):
        q, k, v = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        scale = d**-0.5
        o, lse = fa.flash_self_fwd(q, k, v, scale)
        ref, lse_ref = fa.flash_self_fwd_plain(q, k, v, scale)
        torch.cuda.synchronize()
        k1_tol = check_close(f"K1 out [{bh},{n},{d}]", o, ref, results)
        k1_lse_err = max_err(lse, lse_ref)
        check(f"K1 lse [{bh},{n},{d}]", k1_lse_err, LSE_TOL, results)
        if (bh, n, d) in ((3, 1000, 40), (8, 4096, 40)):
            # the microbench's other tile configurations, off the main path
            for c in range(len(fa.K1_TILE_CONFIGS)):
                oc, lc = fa.flash_self_fwd_tiles(q, k, v, scale, c)
                torch.cuda.synchronize()
                check_close(f"K1 tiles {fa.K1_TILE_CONFIGS[c]} out [{bh},{n},{d}]", oc, ref, results)
                check(f"K1 tiles {fa.K1_TILE_CONFIGS[c]} lse [{bh},{n},{d}]", max_err(lc, lse_ref), LSE_TOL, results)
        if bh == 10:
            # the SD2.1 path's CFG call: 2 rows x 5 heads at the 64x64 latent
            q4, k4, v4 = (t.reshape(2, 5, n, d) for t in (q, k, v))
            b_ms, b_by = k1_bound(bh, n, d)
            k1_sd21 = {"shape": [bh, n, d], "max_abs_err": max_err(o, ref), "tol": k1_tol,
                       "lse_max_abs_err": k1_lse_err, "lse_tol": LSE_TOL, "bound_ms": b_ms, "bound_by": b_by,
                       **timed(lambda: fa.flash_self_fwd(q, k, v, scale), lambda: fa.flash_self_plain(q, k, v, scale),
                               lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))}
            del q4, k4, v4
        elif d == 64:
            # the SD2.1 path's eval call: its errors beside the CFG call's row
            k1_sd21["eval_shape"] = {"shape": [bh, n, d], "max_abs_err": max_err(o, ref), "tol": k1_tol,
                                     "lse_max_abs_err": k1_lse_err, "lse_tol": LSE_TOL}
        if bh == 64:
            q4, k4, v4 = (t.reshape(8, 8, n, d) for t in (q, k, v))
            b_ms, b_by = k1_bound(bh, n, d)
            k1_batch = {"shape": [bh, n, d], "max_abs_err": max_err(o, ref), "tol": k1_tol, "bound_ms": b_ms,
                        "bound_by": b_by,
                        **timed(lambda: fa.flash_self_fwd(q, k, v, scale), lambda: fa.flash_self_plain(q, k, v, scale),
                                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))}
            del ref, lse_ref, q4, k4, v4
    # the row and the timings are the CFG call's, the last case above
    k1_err = max_err(o, ref)
    q4, k4, v4 = (t.reshape(2, 8, n, d) for t in (q, k, v))
    b_ms, b_by = k1_bound(bh, n, d)
    kernels.append({
        "name": "flash_self_fwd", "route": "cuda", "path": "main",
        "source": "guided_attention_tpu_torch/csrc/flash_self_fwd.cu",
        "replaces": "guided_attention_tpu/ops/flash_attention.py:114",
        "shape": [bh, n, d], "max_abs_err": k1_err, "tol": k1_tol,
        "lse_max_abs_err": k1_lse_err, "lse_tol": LSE_TOL,
        "bound_ms": b_ms, "bound_by": b_by,
        **timed(lambda: fa.flash_self_fwd(q, k, v, scale), lambda: fa.flash_self_plain(q, k, v, scale),
                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)),
        "batch_shape": k1_batch, "sd21_shape": k1_sd21,
    })

    # ---- V1 forward (microbench): the CFG and eval shapes, SD2.1 D=64 and a
    # ragged [3, 1000, 40], bf16_p 0 and 1, main entry and every tile
    # configuration; the row is the CFG call's, with D=64's times beside it
    log("V1 flash_self_fwd_v1")
    v1, v1_d64 = {}, {}
    for bh, n, d in ((5, 4096, 64), (3, 1000, 40)) + pak.FWD_SHAPES[::-1]:
        q, k, v = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        scale = d**-0.5
        q4, k4, v4 = (t.reshape(1, bh, n, d) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)  # noqa: E731
        for bp in (False, True):
            o = av.flash_self_fwd_v1(q, k, v, scale, bp)
            ref = av.flash_self_fwd_v1_plain(q, k, v, scale, bp)
            torch.cuda.synchronize()
            rms_tol = RMS_REL if bp else V1_EXACT_P_RMS
            tol = check_close(f"V1 out bf16_p={int(bp)} [{bh},{n},{d}]", o, ref, results, rms_tol)
            for c, cfg in enumerate(av.V1_CONFIGS):
                oc = av.flash_self_fwd_v1_config(q, k, v, scale, bp, c)
                torch.cuda.synchronize()
                check_close(f"V1 tiles {cfg} bf16_p={int(bp)} [{bh},{n},{d}]", oc, ref, results, rms_tol)
            if (bh, n, d) == pak.FWD_SHAPES[0]:
                v1[bp] = {"max_abs_err": max_err(o, ref), "tol": tol}
            if not bp:
                ref_exact_p = ref
            else:
                # the bf16_p=1 kernel stands in for one without the lo product
                name = f"V1 bf16_p=1 against bf16_p=0 plain [{bh},{n},{d}]"
                rms_rel = rms_rel_err(o, ref_exact_p)
                told_apart = rms_rel > V1_EXACT_P_RMS
                results.setdefault("checks", []).append({"name": name, "rms_rel": rms_rel, "rms_tol": V1_EXACT_P_RMS,
                                          "above_tol": told_apart, "ok": told_apart})
                log(f"  {name}: rms_rel={rms_rel:.3e} above rms_tol={V1_EXACT_P_RMS:.3e} "
                    f"{'ok' if told_apart else 'FAIL'}")
                if not told_apart:
                    raise SystemExit(f"{name}: the bf16_p=0 rms limit does not tell bf16 P apart")
                del ref_exact_p
            del ref
            if d == 64:
                v1_d64[f"bf16_p_{int(bp)}"] = timed(lambda: av.flash_self_fwd_v1(q, k, v, scale, bp),
                                                    lambda: av.flash_self_fwd_v1_plain(q, k, v, scale, bp), sdpa)
                v1_d64["shape"] = [bh, n, d]
    # the last shape above is the CFG call's, FWD_SHAPES[0]
    for bp in (False, True):
        v1[bp].update(timed(lambda: av.flash_self_fwd_v1(q, k, v, scale, bp),
                            lambda: av.flash_self_fwd_v1_plain(q, k, v, scale, bp), sdpa))
    b_ms, b_by = bound_ms(pak.fwd_flops(bh, n, d), 4 * bh * n * d * 2, exps=bh * n * n)
    kernels.append({
        "name": "flash_self_fwd_v1", "route": "cuda", "path": "microbench",
        "source": "guided_attention_tpu_torch/csrc/flash_self_fwd_v1.cu",
        "replaces": "scripts/perf_attn_kernel.py:90",
        "design": "wgmma, TMA ring, S/P/O in registers, all-ones m64n8 denominator product",
        "config": av.V1_CONFIGS[av.V1_MAIN_CONFIG[0]],
        "shape": [bh, n, d], "bf16_p": 0, **v1[False], "bound_ms": b_ms, "bound_by": b_by,
        "bf16_p_1": {"config": av.V1_CONFIGS[av.V1_MAIN_CONFIG[1]], **v1[True]}, "d64": v1_d64,
    })

    # ---- K2 backward: SD2.1 [5, 4096, 64], a ragged [3, 1000, 40] (TMA
    # zero-fill, padded query statistics, the key mask), the batch path's
    # eval call [4*8, 4096, 40], the eval call [8, 4096, 40]; against its
    # plain version given the same o and lse, against autograd through the
    # plain forward, and run twice for the bits
    log("K2 flash_self_bwd")
    names = ("dq", "dk", "dv")
    k2_row, k2_batch, k2_sd21 = None, {}, {}
    for bh, n, d in ((5, 4096, 64), (3, 1000, 40), (32, 4096, 40), (8, 4096, 40)):
        q, k, v, do = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        scale = d**-0.5
        o, lse = fa.flash_self_fwd(q, k, v, scale)
        got = fa.flash_self_bwd(q, k, v, o, do, lse, scale)
        want = fa.flash_self_bwd_plain(q, k, v, o, do, lse, scale)
        torch.cuda.synchronize()
        errs = [max_err(a, b) for a, b in zip(got, want)]
        tols = [check_close(f"K2 {nm} [{bh},{n},{d}]", a, b, results) for nm, a, b in zip(names, got, want)]
        check_same(f"K2 twice [{bh},{n},{d}]", got, fa.flash_self_bwd(q, k, v, o, do, lse, scale), results)
        qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        out_ref = fa.flash_self_plain(qr, kr, vr, scale)
        grads = torch.autograd.grad(out_ref, (qr, kr, vr), do)
        for nm, a, b in zip(names, got, grads):
            check_close(f"K2 {nm} vs autograd [{bh},{n},{d}]", a, b, results)
        del qr, kr, vr, out_ref, grads
        if d == 40 and bh != 32:
            # the microbench's other tile configurations, off the main path
            for c, cfg in enumerate(fa.K2_TILE_CONFIGS):
                gc = fa.flash_self_bwd_tiles(q, k, v, o, do, lse, scale, c)
                torch.cuda.synchronize()
                for nm, a, b in zip(names, gc, want):
                    check_close(f"K2 tiles {cfg} {nm} [{bh},{n},{d}]", a, b, results)
                check_same(f"K2 tiles {cfg} twice [{bh},{n},{d}]", gc,
                           fa.flash_self_bwd_tiles(q, k, v, o, do, lse, scale, c), results)
        del want
        if d == 64:  # the SD2.1 path's eval call: 5 heads at the 64x64 latent
            b_ms, b_by = k2_bound(bh, n, d)
            _fwd, sdpa_bwd, _grads = pak.sdpa_graphs(q, k, v, do, scale)
            k2_sd21 = {"shape": [bh, n, d], "max_abs_err": max(errs), "tol": min(tols), "deterministic": True,
                       "bound_ms": b_ms, "bound_by": b_by,
                       **timed(lambda: fa.flash_self_bwd(q, k, v, o, do, lse, scale),
                               lambda: fa.flash_self_bwd_plain(q, k, v, o, do, lse, scale), sdpa_bwd)}
            del _fwd, sdpa_bwd, _grads
        if bh == 32:
            b_ms, b_by = k2_bound(bh, n, d)
            _fwd, sdpa_bwd, _grads = pak.sdpa_graphs(q, k, v, do, scale)
            k2_batch = {"shape": [bh, n, d], "max_abs_err": max(errs), "tol": min(tols), "deterministic": True,
                        "bound_ms": b_ms, "bound_by": b_by,
                        **timed(lambda: fa.flash_self_bwd(q, k, v, o, do, lse, scale),
                                lambda: fa.flash_self_bwd_plain(q, k, v, o, do, lse, scale), sdpa_bwd)}
            del _fwd, sdpa_bwd, _grads
        if (bh, n, d) == pak.BWD_SHAPE:
            # one exponential per pair, what the algorithm needs (K2 computes two)
            b_ms, b_by = k2_bound(bh, n, d)
            _fwd, sdpa_bwd, _grads = pak.sdpa_graphs(q, k, v, do, scale)
            k2_row = {
                "name": "flash_self_bwd", "route": "cuda", "path": "main",
                "source": "guided_attention_tpu_torch/csrc/flash_self_bwd.cu",
                "replaces": "guided_attention_tpu/ops/flash_attention.py:140",
                "shape": [bh, n, d], "max_abs_err": max(errs), "tol": min(tols), "deterministic": True,
                "bound_ms": b_ms, "bound_by": b_by,
                **timed(lambda: fa.flash_self_bwd(q, k, v, o, do, lse, scale),
                        lambda: fa.flash_self_bwd_plain(q, k, v, o, do, lse, scale), sdpa_bwd),
            }
    k2_row["batch_shape"], k2_row["sd21_shape"] = k2_batch, k2_sd21
    kernels.append(k2_row)

    # ---- W1 backward (microbench): SD2.1 D=64, a ragged [3, 1000, 40] and
    # the eval call [8, 4096, 40]; dq bf16, dk and dv fp32; main entry and
    # every tile configuration, each run twice for the bits (no atomics);
    # the row is the eval call's, with D=64's times beside it
    log("W1 flash_self_bwd_w1")
    w1_d64 = {}
    for bh, n, d in ((5, 4096, 64), (3, 1000, 40), pak.BWD_SHAPE):
        q, k, v, do = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        scale = d**-0.5
        got = av.flash_self_bwd_w1(q, k, v, do, scale)
        want = av.flash_self_bwd_w1_plain(q, k, v, do, scale)
        torch.cuda.synchronize()
        errs = [max_err(a, b) for a, b in zip(got, want)]
        tols = [check_close(f"W1 {nm} [{bh},{n},{d}]", a, b, results) for nm, a, b in zip(names, got, want)]
        check_same(f"W1 twice [{bh},{n},{d}]", got, av.flash_self_bwd_w1(q, k, v, do, scale), results)
        for c, cfg in enumerate(av.W1_CONFIGS):
            gc = av.flash_self_bwd_w1_config(q, k, v, do, scale, c)
            torch.cuda.synchronize()
            for nm, a, b in zip(names, gc, want):
                check_close(f"W1 tiles {cfg} {nm} [{bh},{n},{d}]", a, b, results)
            check_same(f"W1 tiles {cfg} twice [{bh},{n},{d}]", gc,
                       av.flash_self_bwd_w1_config(q, k, v, do, scale, c), results)
        del got, want
        if n % 64:
            continue  # the ragged shape is checked, not timed
        sdpa_fwd, sdpa_bwd, _grads = pak.sdpa_graphs(q, k, v, do, scale)

        def sdpa_fwd_bwd():
            sdpa_fwd()
            sdpa_bwd()

        w1_times = timed(lambda: av.flash_self_bwd_w1(q, k, v, do, scale),
                         lambda: av.flash_self_bwd_w1_plain(q, k, v, do, scale), sdpa_fwd_bwd)
        if d == 64:
            w1_d64 = {"shape": [bh, n, d], **w1_times}

    elems = bh * n * d
    b_ms, b_by = bound_ms(pak.bwd_flops(bh, n, d), 5 * elems * 2 + 2 * elems * 4, exps=bh * n * n)
    kernels.append({
        "name": "flash_self_bwd_w1", "route": "cuda", "path": "microbench",
        "source": "guided_attention_tpu_torch/csrc/flash_self_bwd_w1.cu",
        "replaces": "scripts/perf_attn_kernel.py:139",
        "design": "statistics-and-dQ pass over query tiles, then dK/dV pass over key tiles; wgmma, TMA rings, "
                  "no atomics",
        "config": av.W1_CONFIGS[av.W1_MAIN_CONFIG], "deterministic": True,
        "shape": [bh, n, d], "max_abs_err": max(errs), "tol": min(tols),
        "bound_ms": b_ms, "bound_by": b_by,
        # library: SDPA forward and backward (CUDA graphs), W1's function from the same inputs
        **w1_times, "d64": w1_d64,
    })

    # ---- K3 cross-attention with map: SD1.5's captured 16x16 layers
    # [1|2|4, 8, 256, 160] (the eval, a batch of two, the batch path's eval
    # of four, timed too), SD2.1's [1, 20, 256,
    # 64] (clusters of 7 blocks of 3 or 2 heads) and a ragged [1, 5, 100, 40]
    # (head dim padded to 48, a cluster of 5), each with 77 and 33 keys; main
    # entry and every tile configuration, each run twice for the bits (no
    # atomics). The row is the eval's [1, 8, 256, 160] with 77 keys.
    log("K3 cross_attention_map_fwd")
    k3_shapes = ((1, 8, 256, 160), (4, 8, 256, 160), (2, 8, 256, 160), (1, 20, 256, 64), (1, 5, 100, 40))

    def k3_bound(b, h, nq, nk, d):
        return bound_ms(4.0 * b * h * nq * nk * d, (2 * b * h * nq * d + 2 * b * h * nk * d) * 2 + b * nq * nk * 4,
                        exps=b * h * nq * nk)

    k3_sd21, k3_batch = {}, {}
    for (b, h, nq, d), nk in ((shape, nk) for shape in k3_shapes[::-1] for nk in (33, 77)):
        q, k, v = randn(b, h, nq, d), randn(b, h, nk, d), randn(b, h, nk, d)
        scale = d**-0.5
        o_ref, m_ref = fa.cross_attention_map_plain(q, k, v, scale)
        runs = [("", lambda: fa.cross_attention_map_fwd(q, k, v, scale))]
        runs += [(f" tiles {cfg}", lambda c=c: fa.cross_attention_map_tiles(q, k, v, scale, c))
                 for c, cfg in enumerate(fa.K3_TILE_CONFIGS)]
        for label, run in runs:
            o, pmap = run()
            torch.cuda.synchronize()
            tag = f"K3{label} [{b},{h},{nq},{d}] keys {nk}"
            k3_tol = check_close(f"{tag} out", o, o_ref, results)
            e_map = max_err(pmap, m_ref)
            check(f"{tag} map", e_map, 1e-5, results)  # fp32 map from fp32 scores on both sides
            check_same(f"{tag} twice", (o, pmap), run(), results)
            if not label:
                k3_main = {"max_abs_err": max_err(o, o_ref), "tol": k3_tol, "map_max_abs_err": e_map, "map_tol": 1e-5}
        if (b, h, nq, d, nk) == (1, 20, 256, 64, 77):
            # the SD2.1 path's eval call; ms is the CUDA-graph burst's
            b_ms, b_by = k3_bound(b, h, nq, nk, d)
            graphs = graph_alternating_ms(
                {"graph_ms": runs[0][1], "plain_graph_ms": lambda: fa.cross_attention_map_plain(q, k, v, scale)})
            k3_sd21 = {"shape": [b, h, nq, nk, d], **k3_main, "bound_ms": b_ms, "bound_by": b_by, **graphs,
                       "ms": graphs["graph_ms"], "plain_ms": graphs["plain_graph_ms"], "library_ms": None}
        if (b, h, nq, d, nk) == (4, 8, 256, 160, 77):
            b_ms, b_by = k3_bound(b, h, nq, nk, d)
            k3_batch = {"shape": [b, h, nq, nk, d], **k3_main, "bound_ms": b_ms, "bound_by": b_by, **graph_alternating_ms(
                {"graph_ms": runs[0][1], "plain_graph_ms": lambda: fa.cross_attention_map_plain(q, k, v, scale)})}
    # the last case above: [1, 8, 256, 160], 77 keys
    # gradient through the autograd Function (PyTorch-ops backward)
    qa, ka, va = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    qb, kb, vb = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    wo, wm = randn(b, h, nq, d), torch.randn(b, nq, nk, generator=g, device="cuda")
    oa, ma = fa.cross_attention_with_map(qa, ka, va, scale)
    ob, mb = fa.cross_attention_map_plain(qb, kb, vb, scale)
    ga_ = torch.autograd.grad((oa.float() * wo).sum() + (ma * wm).sum(), (qa, ka, va))
    gb_ = torch.autograd.grad((ob.float() * wo).sum() + (mb * wm).sum(), (qb, kb, vb))
    for nm, a_, b_ in zip(("dq", "dk", "dv"), ga_, gb_):
        check_close(f"K3 {nm}", a_, b_, results)
    b_ms, b_by = k3_bound(b, h, nq, nk, d)
    kernel, plain = (lambda: fa.cross_attention_map_fwd(q, k, v, scale)), (lambda: fa.cross_attention_map_plain(q, k, v, scale))
    # K3 runs in microseconds, faster than the host queues it: an event
    # burst times the host's launch path; a CUDA-graph burst the card
    graphs = graph_alternating_ms({"graph_ms": kernel, "plain_graph_ms": plain})
    kernels.append({
        "name": "cross_attention_map_fwd", "route": "cuda", "path": "main",
        "source": "guided_attention_tpu_torch/csrc/cross_attention_map.cu",
        "replaces": "guided_attention_tpu/ops/flash_attention.py:241",
        "design": "mma.sync m16n8k16, a block per (head group, 16 queries), 4 warps; TMA boxes; head mean summed "
                  "across a cluster through distributed shared memory, no atomics",
        "config": fa.K3_TILE_CONFIGS[fa.K3_MAIN_CONFIG], "deterministic": True,
        "shape": [b, h, nq, nk, d], **k3_main,
        "bound_ms": b_ms, "bound_by": b_by,
        **timed(kernel, plain), **graphs, "sd21_shape": k3_sd21, "batch_shape": k3_batch,
    })
    return kernels


# a bf16 guidance eval against another route or placement of its sums
# (phase 4's limits, and phase 13's): loss relative, gradient relative to
# its largest entry
EVAL_LOSS_REL, EVAL_GRAD_REL = 1e-4, 0.04


def guidance_eval(pipe, sd):
    """(loss, latent gradient in fp32) of one guidance eval of the main
    path's prompt at the first step, on the bundle ``sd`` (``pipe``'s, or a
    rank's tensor-sharded copy), from a latent drawn from seed 5 on its
    device."""
    import torch

    from guided_attention_tpu_torch import workload
    from guided_attention_tpu_torch.guidance.spec import stack_specs
    from guided_attention_tpu_torch.pipeline import _Loop
    from guided_attention_tpu_torch.runner import PrepareOptions

    hp, _p, _a, spec, statics, sched, arrays, emb = pipe._prepare(
        PrepareOptions(meta_prompt=workload.META_PROMPT, sd_2_1=workload.is_sd21(pipe)))
    g = torch.Generator(device=sd.device).manual_seed(5)
    s = sd.config.latent_size
    lat = torch.randn((1, s, s, sd.config.unet.in_channels), generator=g, device=sd.device).to(torch.bfloat16)
    loop = _Loop(sd, statics, hp, emb[None], stack_specs([spec]), sched, arrays, None, ("up", "down", "mid"))
    with torch.no_grad():
        loss, _aux, grad = loop.guidance_eval(lat, [0], int(sched.timesteps[0]), 0.0, lat)
    return float(loss), grad.float()


def eval_phase(sd, pipe, results: dict) -> dict:
    """One full-width guidance eval of ``pipe``'s bundle (phase 4: sd15,
    phase 11: sd21) through the kernels vs the plain attention path, same
    latent and prompt; returns the two losses and the relative distances."""
    import torch

    name = sd.config.name
    cfg = sd.unet.config
    outs = {}
    for route, flash in (("kernels", True), ("plain", False)):
        sd.unet.config = dataclasses.replace(cfg, use_flash_attention=flash)
        outs[route] = guidance_eval(pipe, sd)
    sd.unet.config = cfg
    (lk, gk), (lp, gp) = outs["kernels"], outs["plain"]
    log(f"  {name} eval loss kernels={lk:.6f} plain={lp:.6f}")
    # bf16 network on both routes: the attention outputs differ at bf16
    # rounding, which the eval's forward and backward carry along. Measured
    # on an H100: sd15's loss within 4.2-5.0e-5 relative and its gradient
    # within 1.3-2.1% of its largest entry, sd21's within 3.8e-6 and 1.5%;
    # the limits leave 2x room on sd15's loss and gradient (its maps come
    # from fp32 scores on both routes).
    loss_rel = abs(lk - lp) / abs(lp)
    check(f"{name} eval loss (rel)", loss_rel, EVAL_LOSS_REL, results)
    grad_rel = max_err(gk, gp) / float(gp.abs().max())
    check(f"{name} eval grad (rel to max|grad|)", grad_rel, EVAL_GRAD_REL, results)
    if not (torch.isfinite(gk).all() and float(gk.abs().max()) > 0):
        raise SystemExit(f"{name} eval gradient through the kernels is not finite and nonzero")
    return {"loss_kernels": lk, "loss_plain": lp, "loss_rel": loss_rel, "grad_rel_to_max": grad_rel}


def rel_max_err(out, ref) -> float:
    return max_err(out, ref) / float(ref.float().abs().max())


def batch_phase(pipe, results: dict) -> dict:
    """Phase 6: the batch path at full width, then its checks. Returns the
    K1-K3 launch counts of the timed batch."""
    import numpy as np
    import torch

    from guided_attention_tpu_torch import workload
    from guided_attention_tpu_torch.config import HyperParams
    from guided_attention_tpu_torch.models.bundle import StableDiffusion
    from guided_attention_tpu_torch.ops.flash_attention import LAUNCHES, reset_launches
    from guided_attention_tpu_torch.runner import GuidedAttentionPipeline
    from guided_attention_tpu_torch.runtime import flops

    cfg = pipe.sd.unet.config
    seeds, prompts = list(workload.BATCH_SEEDS), workload.batch_prompts(len(workload.BATCH_SEEDS))
    t0 = time.perf_counter()
    workload.generate_batch(pipe, steps=BATCH_WARMUP_STEPS)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    outs = workload.generate_batch(pipe)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {name: LAUNCHES[name] for name in MAIN_PATH_KERNELS}
    work = sum(flops.generation_flops(cfg, o.diagnostics, workload.STEPS) for o in outs)
    samples = [{
        "seed": seed, "prompt": prompt,
        "refine_iters_step0": int(o.diagnostics.refine_iters[0]),
        "recursions_0_14": o.diagnostics.recursions[:15].tolist(),
        "n_evals_total": int(o.diagnostics.n_evals.sum()),
        "image_std": float(o.images_u8.std()),
    } for seed, prompt, o in zip(seeds, prompts, outs)]
    batch = {
        "batch": len(outs), "steps": workload.STEPS, "warmup_s": warm, "warmup_steps": BATCH_WARMUP_STEPS,
        "s_per_batch": sec, "s_per_image": sec / len(outs),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "unet_tflop": work / 1e12, "mfu": flops.mfu(work, sec), "launches": launches, "samples": samples,
    }
    results["batch"] = batch
    log("batch path: " + json.dumps(batch))
    log(f"batch path: {sec:.3f} s/batch, {batch['s_per_image']:.3f} s/image, {batch['unet_tflop']:.3f} TFLOP of UNet "
        f"work = {100 * batch['mfu']:.3f}% of the bf16 peak, peak {batch['peak_mem_gib']:.3f} GiB ({results['card']})")
    for o in outs:
        if (o.images_u8.shape != (1, 512, 512, 3) or not np.isfinite(o.latents).all()
                or float(o.images_u8.std()) <= 0):
            raise SystemExit("batch path output is malformed (shape, finiteness or constant image)")
    for name, count in launches.items():
        if count <= 0:
            raise SystemExit(f"kernel {name} was not launched on the batch path")

    # sample 0 against a batch whose other samples take other prompts, with
    # paint-with-words on (its score max is per sample), under the default
    # algorithms; the first batch twice is the control
    if torch.are_deterministic_algorithms_enabled():
        raise SystemExit("deterministic algorithms are on; the checks below hold the default")
    hp = HyperParams(paint_with_words_stop=INDEPENDENCE_PWW_STOP)
    kw = dict(steps=INDEPENDENCE_STEPS, hp=hp, decode=False)
    first = workload.generate_batch(pipe, seeds, prompts, **kw)
    again = workload.generate_batch(pipe, seeds, prompts, **kw)
    other = workload.generate_batch(pipe, seeds, [prompts[0], *OTHER_PROMPTS], **kw)
    for tag, outs_ in (("first", first), ("other prompts", other)):
        log(f"  independence batch ({tag}): refine_iters[0] {[int(o.diagnostics.refine_iters[0]) for o in outs_]}, "
            f"n_evals {[int(o.diagnostics.n_evals.sum()) for o in outs_]}")
    independence = rel_max_err(torch.from_numpy(other[0].latents), torch.from_numpy(first[0].latents))
    log(f"  independence batch sample 0: rel max err {independence:.3e}")
    twice = [rel_max_err(torch.from_numpy(a.latents), torch.from_numpy(b.latents)) for a, b in zip(first, again)]
    log("  guided batch run twice, default algorithms (rel max err per sample): " + json.dumps(twice))
    # each sample against its one-sample run, no limit (rounding at other
    # shapes, carried by the refinement, may also branch a threshold test)
    dist = []
    for seed, prompt, o in zip(seeds, prompts, first):
        single = pipe(meta_prompt=prompt, seed=seed, num_inference_steps=INDEPENDENCE_STEPS, hp=hp, decode=False,
                      capture_diagnostics=False)
        dist.append({"rel_max_err": rel_max_err(torch.from_numpy(o.latents), torch.from_numpy(single.latents)),
                     "n_evals": [int(o.diagnostics.n_evals.sum()), int(single.diagnostics.n_evals.sum())]})
    results["batch_guided_default_twice"] = twice
    results["batch_guided_vs_single"] = dist
    log("  guided batch against one-sample runs (batch, single n_evals): " + json.dumps(dist))
    # standard SD: the bf16 batch twice (printed: no guidance, no
    # refinement to carry a difference), then batch against one-sample
    # runs, bf16 (printed) and float32
    std_twice = [workload.generate_batch(pipe, seeds, STANDARD_PROMPTS, steps=STANDARD_STEPS, run_standard_sd=True,
                                         decode=False) for _ in range(2)]
    log("  standard-SD bf16 batch run twice, default algorithms (rel max err per sample): " + json.dumps(
        [rel_max_err(torch.from_numpy(a.latents), torch.from_numpy(b.latents)) for a, b in zip(*std_twice)]))
    std_errs = {}
    sd32 = StableDiffusion.create("sd15", torch.float32, device="cuda", seed=workload.WEIGHT_SEED)
    sd32.unet.config = dataclasses.replace(sd32.unet.config, use_flash_attention=False)
    for name, p in (("bf16", pipe), ("float32", GuidedAttentionPipeline(sd32))):
        std = workload.generate_batch(p, seeds, STANDARD_PROMPTS, steps=STANDARD_STEPS, run_standard_sd=True,
                                      decode=False)
        std_errs[name] = []
        for seed, prompt, o in zip(seeds, STANDARD_PROMPTS, std):
            single = p(meta_prompt=prompt, seed=seed, num_inference_steps=STANDARD_STEPS, run_standard_sd=True,
                       decode=False, capture_diagnostics=False)
            got, want = torch.from_numpy(o.latents), torch.from_numpy(single.latents)
            std_errs[name].append((rel_max_err(got, want), rms_rel_err(got, want)))
        log(f"  standard-SD batch against one-sample runs, {name} (rel max, rel rms): " + json.dumps(std_errs[name]))
    del sd32
    results["batch_standard_vs_single"] = std_errs

    check_same("independence batch run twice (default algorithms)", [torch.from_numpy(o.latents) for o in again],
               [torch.from_numpy(o.latents) for o in first], results)
    check_same("batch sample 0 with the other samples' prompts changed (default algorithms)",
               [torch.from_numpy(other[0].latents)], [torch.from_numpy(first[0].latents)], results)
    for b, (err, rms) in enumerate(std_errs["float32"]):
        check(f"standard-SD float32 batch sample {b} against its one-sample run (rel to max|latent|)", err,
              STANDARD_MAX_REL, results, rms_rel=rms)
        if rms > STANDARD_RMS_REL:
            raise SystemExit(f"standard-SD batch sample {b}: relative rms error {rms} above {STANDARD_RMS_REL}")

    # the guided path's reproducibility under the default algorithms. The
    # fault this guards against (atomics in a backward) does not show on
    # every pair of runs: before the repair, one card run read the 15-step
    # image bitwise equal twice while its batch of two differed. The batch
    # checks (the B = 4 batch with paint-with-words above, and this batch
    # of two) are the witness that counts; the image runs F3_IMAGE_RUNS
    # times, each held against the first.
    single = [pipe(meta_prompt=workload.META_PROMPT, seed=workload.TIMED_SEED, num_inference_steps=INDEPENDENCE_STEPS,
                   decode=False, capture_diagnostics=False).latents for _ in range(F3_IMAGE_RUNS)]
    check_same(f"guided 15-step image run {F3_IMAGE_RUNS} times (default algorithms)",
               [torch.from_numpy(x) for x in single[1:]], [torch.from_numpy(single[0])] * (F3_IMAGE_RUNS - 1), results)
    pair = [workload.generate_batch(pipe, seeds[1:3], prompts[1:3], steps=INDEPENDENCE_STEPS, decode=False)
            for _ in range(2)]
    check_same("guided 15-step batch of two run twice (default algorithms)",
               [torch.from_numpy(o.latents) for o in pair[0]], [torch.from_numpy(o.latents) for o in pair[1]], results)
    return launches


# the CLI phase (phase 8): its sweeps, the diagnostic run's steps, and where
# its artifact trees go (a directory of the checkout that .gitignore lists)
CLI_SEEDS = (28, 42)
CLI_DIAG_STEPS = 15
CLI_OUT = os.path.join("build", "chip_smoke_cli")
CLI_IMAGE = 512  # sd15's and sd21's image side
SD21_SHORT_STEPS = 15  # the sd21 CLI run's, and phase 11's reproducibility runs'


def read_png(path: str):
    """An 8-bit RGB PNG file decoded by ``decode_png``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(b: bytes, path: str = "PNG bytes"):
    """An 8-bit RGB PNG decoded with the standard library's zlib (every
    chunk's CRC checked), as a uint8 [H, W, 3] array."""
    import struct
    import zlib

    import numpy as np

    if b[:8] != b"\x89PNG\r\n\x1a\n":
        raise SystemExit(f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(b):
        (n,) = struct.unpack(">I", b[pos : pos + 4])
        kind, data = b[pos + 4 : pos + 8], b[pos + 8 : pos + 8 + n]
        if zlib.crc32(kind + data) != struct.unpack(">I", b[pos + 8 + n : pos + 12 + n])[0]:
            raise SystemExit(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            w, h = struct.unpack(">II", data[:8])
            if data[8:10] != bytes([8, 2]):
                raise SystemExit(f"{path}: not 8-bit RGB")
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * 3 + 1)
    return rows[:, 1:].reshape(h, w, 3)


def cli_names():
    """The run directory's name and the file suffix the CLI gives the main
    path's meta-prompt under the default hyperparameters."""
    from guided_attention_tpu_torch import workload
    from guided_attention_tpu_torch.annotation import meta_prompt_clean
    from guided_attention_tpu_torch.config import HyperParams
    from guided_attention_tpu_torch.runtime.artifacts import dict_to_string

    hp = HyperParams()
    suffix = dict_to_string({k: getattr(hp, k) for k in ("strict", "inside_loss_scale", "outside_loss_scale",
                                                          "shrink_factor", "thresholds", "use_optimizer",
                                                          "recurse_until", "recurse_steps")})
    return meta_prompt_clean(workload.META_PROMPT), suffix


def cli_phase(results: dict) -> dict:
    """Phase 8: ``frontends.cli.main`` on the card (sd15, and sd21 with
    ``--sd_2_1``), its launches and its artifact trees. Returns the K1-K3
    launch counts of the first sweep."""
    import shutil

    import numpy as np

    from guided_attention_tpu_torch import workload
    from guided_attention_tpu_torch.frontends import cli
    from guided_attention_tpu_torch.ops.flash_attention import LAUNCHES, reset_launches
    from guided_attention_tpu_torch.runtime import native

    writer = native.AsyncArtifactWriter(1)
    if not writer.native:
        raise SystemExit("the artifact writer is not the native one")
    log(f"  artifact writer: native, {native.load_library()._name}")
    writer.close()
    shutil.rmtree(CLI_OUT, ignore_errors=True)
    clean, suffix = cli_names()
    base = ["--meta_prompt", workload.META_PROMPT, "--seeds", *map(str, CLI_SEEDS)]
    runs = (
        ("batch_size 1", CLI_SEEDS, base + ["--batch_size", "1"]),
        ("batch_size 2", CLI_SEEDS, base + ["--batch_size", "2"]),
        ("diagnostic", CLI_SEEDS[:1], ["--meta_prompt", workload.META_PROMPT, "--seeds", str(CLI_SEEDS[0]),
                                       "--n_inference_steps", str(CLI_DIAG_STEPS), "--diagnostic_level", "1",
                                       "--save_individual_ca_maps", "true"]),
        # SD2.1-base (512 px, as sd15): the CLI builds its own sd21 bundle
        ("sd21", CLI_SEEDS[:1], ["--meta_prompt", workload.META_PROMPT, "--seeds", str(CLI_SEEDS[0]),
                                 "--sd_2_1", "true", "--n_inference_steps", str(SD21_SHORT_STEPS)]),
    )
    out, first_launches = {}, None
    for name, seeds, argv in runs:
        root = os.path.join(CLI_OUT, name.replace(" ", "_"))
        stats: dict = {}
        reset_launches()
        t0 = time.perf_counter()
        cli.main(argv + ["--output_path", root], stats=stats)
        wall = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in MAIN_PATH_KERNELS}
        first_launches = first_launches or launches
        for k, count in launches.items():
            if count <= 0:
                raise SystemExit(f"kernel {k} was not launched on the CLI path ({name})")
        run_dir = os.path.join(root, clean)
        finals = []
        for seed in seeds:
            want = [f"{seed}{suffix}.png", f"{seed}{suffix}.txt"]
            want += [os.path.join(str(seed), (clean + f"cur_seed_{seed}_cur_time_step_iter_{i:02d}_optimizeDeepLatent"
                                              f"_False__subiter_00_pred").replace(".", "_") + ".png") for i in range(3)]
            if name == "diagnostic":
                want += [os.path.join(str(seed), "heads", "final.png")]
            missing = [f for f in want if not os.path.exists(os.path.join(run_dir, f))]
            maps = [f for f in os.listdir(os.path.join(run_dir, str(seed))) if f.startswith("_attnmap_")]
            if missing or len(maps) < 2:
                raise SystemExit(f"CLI {name}: missing artifacts {missing}, {len(maps)} attention maps")
            img = read_png(os.path.join(run_dir, want[0]))
            if img.shape != (CLI_IMAGE, CLI_IMAGE, 3) or float(img.std()) <= 0:
                raise SystemExit(f"CLI {name}: final image of seed {seed} is {img.shape}, std {float(img.std())}")
            finals.append(img)
        grid = read_png(os.path.join(root, clean + ".png"))
        tiles = [grid[:, CLI_IMAGE * j : CLI_IMAGE * (j + 1)] for j in range(len(finals))]
        # the grid carries the last run's annotation overlay: each tile is its
        # image except where a box, crosshair or label was drawn
        same = [float((t == f).all(-1).mean()) for t, f in zip(tiles, finals)]
        if grid.shape != (CLI_IMAGE, CLI_IMAGE * len(finals), 3) or min(same) < 0.9:
            raise SystemExit(f"CLI {name}: grid {grid.shape} does not hold the {len(finals)} images ({same})")
        names = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]
        files = len(names)
        kinds = {k: sum(k in f for f in names) for k in ("heads", "_attnmap_", "_pred.png", "_pred_pre_optim", ".txt")}
        n = stats["images"]
        out[name] = {"argv": argv, "images": n, "wall_s": wall, "generate_s": stats["generate_s"],
                     "artifacts_s": stats["artifacts_s"], "s_per_image": stats["generate_s"] / n,
                     "artifact_s_per_image": stats["artifacts_s"] / n, "files": files, "file_kinds": kinds,
                     "launches": launches,
                     "grid_tile_match": same}
        log(f"CLI {name}: {n} image(s), {stats['generate_s'] / n:.3f} s/image generating, "
            f"{stats['artifacts_s'] / n:.3f} s/image writing artifacts ({files} files: {json.dumps(kinds)}), "
            f"wall {wall:.1f} s, "
            f"launches {json.dumps(launches)} ({results['card']})")
    results["cli"] = out
    return first_launches


# the resumable phase (phase 9): the main path's run in segments of 10
# steps, stopped after step 20; a variant with a second threshold step
# after the stop, so that the resumed call evaluates guidance (K2, K3); a
# batch of two in segments of 5, stopped after step 10; state files and
# the native checkpoint under build/ (listed in .gitignore)
RESUME_EVERY, RESUME_STOP = 10, 20
RESUME_LATE_THRESHOLDS = {0: 1.0, 30: 1.0}
RESUME_BATCH_STEPS, RESUME_BATCH_EVERY, RESUME_BATCH_STOP = 15, 5, 10
RESUME_STATE = os.path.join("build", "chip_smoke_state")
NATIVE_DIR = os.path.join("build", "chip_smoke_native")


class StopRun(Exception):
    """Raised by ``on_segment`` to stop a resumable run at a boundary."""


def resume_phase(pipe, results: dict) -> dict:
    """Phase 9: resumable runs and the native checkpoint. Returns the K1-K3
    launch counts of the resumed call that evaluates guidance."""
    import resource
    import shutil

    import torch

    from guided_attention_tpu_torch import workload
    from guided_attention_tpu_torch.frontends import cli
    from guided_attention_tpu_torch.models.bundle import StableDiffusion
    from guided_attention_tpu_torch.models.io import COMPONENTS, save_params
    from guided_attention_tpu_torch.ops.flash_attention import LAUNCHES, reset_launches
    from guided_attention_tpu_torch.runtime import checkpoint as ckpt

    seed, state = workload.TIMED_SEED, RESUME_STATE
    shutil.rmtree(state, ignore_errors=True)
    writes = []  # seconds of each state write, the device-to-host copy included
    save_state = ckpt.save_state

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        out = save_state(*args, **kwargs)
        writes.append(time.perf_counter() - t0)
        return out

    def stop_after(step):
        def on_segment(done, total):
            if done == step:
                raise StopRun
        return on_segment

    def state_files():
        return sorted(os.listdir(state)) if os.path.isdir(state) else []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same_image(name, got, want):
        check_same(name, [torch.from_numpy(got.latents), torch.from_numpy(got.images_u8)],
                   [torch.from_numpy(want.latents), torch.from_numpy(want.images_u8)], results)

    kw = dict(meta_prompt=workload.META_PROMPT, num_inference_steps=workload.STEPS, capture_diagnostics=False)
    resumable = lambda **extra: pipe.generate_resumable(  # noqa: E731
        seed=seed, checkpoint_every=RESUME_EVERY, state_dir=state, **kw, **extra)
    ckpt.save_state = timed_save
    try:
        want, d1 = timed(lambda: workload.generate(pipe, seed))
        got, r1 = timed(resumable)
        n_writes = len(writes)
        _, d2 = timed(lambda: workload.generate(pipe, seed))
        same_image("resumable main path (50 steps, every 10) against dispatch", got, want)
        if got.resumed_from_step != 0 or n_writes != workload.STEPS // RESUME_EVERY or state_files():
            raise SystemExit(f"resumable run: resumed from {got.resumed_from_step}, {n_writes} writes, "
                             f"state left {state_files()}")
        try:
            resumable(on_segment=stop_after(RESUME_STOP))
            raise SystemExit("on_segment did not stop the run")
        except StopRun:
            pass
        left = state_files()
        again, r2 = timed(resumable)
        same_image(f"main path stopped after step {RESUME_STOP} and resumed, against dispatch", again, want)
        if again.resumed_from_step != RESUME_STOP or len(left) != RESUME_STOP // RESUME_EVERY or state_files():
            raise SystemExit(f"resume: from step {again.resumed_from_step}, files {left} then {state_files()}")

        # a threshold step after the stop: the resumed call runs guidance evals
        late = dict(thresholds=RESUME_LATE_THRESHOLDS)
        want_late = pipe(seed=seed, **kw, **late)
        try:
            resumable(on_segment=stop_after(RESUME_STOP), **late)
        except StopRun:
            pass
        reset_launches()
        again_late = resumable(**late)
        torch.cuda.synchronize()
        launches = {name: LAUNCHES[name] for name in MAIN_PATH_KERNELS}
        same_image(f"threshold at step 30, stopped after step {RESUME_STOP} and resumed, against dispatch",
                   again_late, want_late)
        if again_late.resumed_from_step != RESUME_STOP or state_files():
            raise SystemExit(f"late-threshold resume: from step {again_late.resumed_from_step}, left {state_files()}")
        for name, count in launches.items():
            if count <= 0:
                raise SystemExit(f"kernel {name} was not launched in the resumed call")

        # a batch of two, stopped and resumed
        seeds, prompts = list(workload.BATCH_SEEDS[1:3]), workload.batch_prompts(3)[1:3]
        bkw = dict(meta_prompts=prompts, num_inference_steps=RESUME_BATCH_STEPS, capture_diagnostics=False)
        want_b = pipe.generate_batch(seeds, **bkw)
        try:
            pipe.generate_batch_resumable(seeds, checkpoint_every=RESUME_BATCH_EVERY, state_dir=state,
                                          on_segment=stop_after(RESUME_BATCH_STOP), **bkw)
        except StopRun:
            pass
        got_b = pipe.generate_batch_resumable(seeds, checkpoint_every=RESUME_BATCH_EVERY, state_dir=state, **bkw)
        for b, (g, w) in enumerate(zip(got_b, want_b)):
            same_image(f"batch of two sample {b}, stopped after step {RESUME_BATCH_STOP} and resumed, against "
                       "generate_batch", g, w)
        if any(g.resumed_from_step != RESUME_BATCH_STOP for g in got_b) or state_files():
            raise SystemExit(f"batch resume: from {[g.resumed_from_step for g in got_b]}, left {state_files()}")

        # the CLI's --checkpoint_every: the final PNG of seed 28 is phase 8's
        # (batch size 1, same flags otherwise) byte for byte
        root, cli_seed = os.path.join(CLI_OUT, "checkpoint_every"), CLI_SEEDS[0]
        shutil.rmtree(root, ignore_errors=True)
        cli.main(["--meta_prompt", workload.META_PROMPT, "--seeds", str(cli_seed), "--checkpoint_every",
                  str(RESUME_EVERY), "--output_path", root])
        clean, suffix = cli_names()
        png = f"{cli_seed}{suffix}.png"
        with open(os.path.join(root, clean, png), "rb") as f, \
                open(os.path.join(CLI_OUT, "batch_size_1", clean, png), "rb") as g:
            same_png = f.read() == g.read()
        results.setdefault("checks", []).append({"name": "CLI --checkpoint_every final PNG", "ok": same_png})
        log(f"  CLI --checkpoint_every {RESUME_EVERY}: final PNG byte for byte phase 8's {'ok' if same_png else 'FAIL'}")
        if not same_png or os.listdir(os.path.join(root, "state")):
            raise SystemExit("CLI --checkpoint_every: final PNG differs from phase 8's, or state left")
    finally:
        ckpt.save_state = save_state
        shutil.rmtree(state, ignore_errors=True)
    out = {
        "steps": workload.STEPS, "checkpoint_every": RESUME_EVERY,
        "dispatch_s_per_image": [d1, d2], "resumable_s_per_image": r1, "resumed_s": r2,
        "state_writes": len(writes), "state_write_s": writes,
        "state_write_s_median": sorted(writes)[len(writes) // 2],
        "resumed_launches": launches,
    }
    log(f"resumable: dispatch {d1:.3f} s/image, resumable {r1:.3f}, dispatch {d2:.3f}; the resumed 30 steps "
        f"{r2:.3f} s; {len(writes)} state writes, median {out['state_write_s_median'] * 1e3:.3f} ms "
        f"(max {max(writes) * 1e3:.3f}); launches in the resumed call with a threshold at step 30 "
        f"{json.dumps(launches)} ({results['card']})")

    # the native checkpoint: save the bundle, load it into a new one
    sd = pipe.sd
    shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    rss_before_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # the process's high-water mark
    try:
        n, save_s = timed(lambda: save_params(NATIVE_DIR, sd))
        nbytes = sum(os.path.getsize(os.path.join(NATIVE_DIR, f"{c}.msgpack")) for c in COMPONENTS)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loaded, load_s = timed(lambda: StableDiffusion.create("sd15", torch.bfloat16, device="cuda",
                                                              checkpoint_dir=NATIVE_DIR))
        peak = torch.cuda.max_memory_allocated()
        rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        for c in COMPONENTS:
            a, b = getattr(loaded, c).state_dict(), getattr(sd, c).state_dict()
            if set(a) != set(b):
                raise SystemExit(f"native checkpoint {c}: keys differ")
            check_same(f"native checkpoint {c} ({len(a)} tensors) loaded against the bundle saved",
                       [a[k] for k in sorted(a)], [b[k] for k in sorted(b)], results)
            if any(a[k].dtype != b[k].dtype for k in a):
                raise SystemExit(f"native checkpoint {c}: dtypes differ")
        del loaded
    finally:
        shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    out["native"] = {"tensors": n, "bytes": nbytes, "save_s": save_s, "load_s": load_s,
                     "random_init_s": results.get("create_s"), "load_peak_gib": peak / 2**30,
                     "load_peak_above_before_gib": (peak - base) / 2**30, "host_max_rss_gib": rss_gib,
                     "host_max_rss_before_gib": rss_before_gib}
    log(f"native checkpoint sd15 bf16: {n} tensors, {nbytes} bytes, save {save_s:.3f} s, create from it "
        f"{load_s:.3f} s (random init {results.get('create_s', float('nan')):.3f} s), device peak "
        f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} above the {base / 2**30:.3f} held before), host "
        f"max RSS {rss_gib:.3f} GiB ({rss_before_gib:.3f} before the save) ({results['card']})")
    results["resume"] = out
    return launches


# the serving phase (phase 10): the engine's buckets and wait, the requests
# of each check, and where the served artifact trees go (under build/)
SERVE_BUCKETS = (1, 2, 4)
SERVE_WAIT_MS = 2000.0
SERVE_HTTP_SEEDS = (40, 41, 42, 43)
SERVE_HTTP_STAGGER_S = 0.1  # between the concurrent POSTs: the queue takes them in seed order
SERVE_ARTIFACT_STEPS = 15
SERVE_OUT = os.path.join("build", "chip_smoke_serve")
SERVE_LOAD = ((1, 2), (4, 8))  # (closed-loop clients, requests)
SERVE_BURST = 8  # clients of one request each, queued before the batcher starts: two groups of 4
SERVE_FIRST_GROUP_BATCHES = 1.5  # the burst's first group's latency, in batch times, at most


def _http(port: int, method: str, path: str, body=None, timeout: float = 600.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ui_once(config, pipe, engine, method: str, path: str, body=None):
    """One request through ``gui.run_server(once=True)``, retried until the
    server listens."""
    import threading

    from guided_attention_tpu_torch.frontends import gui

    port = _free_port()
    server = threading.Thread(target=gui.run_server, args=(config, pipe),
                              kwargs=dict(port=port, once=True, engine=engine), daemon=True)
    server.start()
    deadline = time.monotonic() + 60
    while True:
        try:
            out = _http(port, method, path, body)
            break
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    server.join(600)
    if server.is_alive():
        raise SystemExit("the web UI did not return after one request")
    return out


def serve_phase(pipe, results: dict) -> dict:
    """Phase 10: the serving path at full width. Returns the K1-K3 launch
    counts of the served batch of (a)."""
    import base64
    import shutil
    import threading

    import torch

    from guided_attention_tpu_torch import perf_server, workload
    from guided_attention_tpu_torch.config import RunConfig
    from guided_attention_tpu_torch.frontends import gui
    from guided_attention_tpu_torch.frontends.server import BatchingEngine, make_server
    from guided_attention_tpu_torch.ops.flash_attention import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    out: dict = {}
    card = results["card"]
    shutil.rmtree(SERVE_OUT, ignore_errors=True)
    steps = dict(num_inference_steps=workload.STEPS)
    p0, p1 = workload.BATCH_PROMPTS

    def same_images(name, got, want):
        check_same(name, [torch.from_numpy(g.images_u8) for g in got] + [torch.from_numpy(g.latents) for g in got],
                   [torch.from_numpy(w.images_u8) for w in want] + [torch.from_numpy(w.latents) for w in want], results)

    # ---- (a) the engine against the runner: three requests, one bucket-4
    # batch with the last request repeated
    reqs = [(p0, workload.TIMED_SEED), (p0, workload.TIMED_SEED + 1), (p1, workload.TIMED_SEED + 2)]
    engine = BatchingEngine(pipe, buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS, _start_thread=False)
    tickets = [engine.submit(p, seed=s, **steps) for p, s in reqs]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    engine._thread.start()
    served = [t.result(timeout=600) for t in tickets]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {name: LAUNCHES[name] for name in MAIN_PATH_KERNELS}
    engine.close()
    stats = engine.snapshot()
    if stats["batch_sizes"] != {4: 1} or stats["padded_samples"] != 1 or stats["errors"]:
        raise SystemExit(f"serving (a): expected one bucket-4 batch with one padded sample, stats {stats}")
    seeds = [s for _, s in reqs] + [reqs[-1][1]]
    want = pipe.generate_batch(seeds, meta_prompts=[p for p, _ in reqs] + [reqs[-1][0]], capture_diagnostics=False,
                               **steps)
    same_images("served batch of three (padded to 4) against generate_batch", served, want[:3])
    for name, count in launches.items():
        if count <= 0:
            raise SystemExit(f"kernel {name} was not launched in the served batch")
    out["engine"] = {"requests": len(reqs), "batch_s": sec, "s_per_image": sec / len(reqs),
                     "latency_s": stats.get("latency_s"), "last_batch_s": stats["last_batch_s"],
                     "batch_sizes": stats["batch_sizes"], "padded_samples": stats["padded_samples"],
                     "launches": launches}
    log(f"serving (a): one bucket-4 batch (3 requests, 1 padded): {sec:.3f} s from the thread's start to the last "
        f"result (of it up to {SERVE_WAIT_MS / 1000:.0f} s of group formation, max_wait_ms), the batch "
        f"{stats['last_batch_s']} s; bitwise equal to generate_batch; launches {json.dumps(launches)} ({card})")

    # ---- (b) HTTP: four concurrent requests of the main path
    engine = BatchingEngine(pipe, buckets=SERVE_BUCKETS, max_wait_ms=SERVE_WAIT_MS)
    server = make_server(engine, host="127.0.0.1", port=0, artifact_dir=SERVE_OUT)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    calls = []  # the seeds and prompts of each batch the engine dispatched
    dispatch_batch = pipe.dispatch_batch

    def recording_dispatch(seeds, **kw):
        calls.append((list(seeds), kw.get("meta_prompt"), kw.get("meta_prompts")))
        return dispatch_batch(seeds, **kw)

    pipe.dispatch_batch = recording_dispatch
    try:
        status, body = _http(port, "GET", "/healthz")
        health = json.loads(body)
        if status != 200 or health.get("device_name") != torch.cuda.get_device_name(0):
            raise SystemExit(f"/healthz: {status} {health}")
        replies = {}

        def post(seed):
            replies[seed] = _http(port, "POST", "/generate", dict(meta_prompt=workload.META_PROMPT, seed=seed, **steps))

        posts = []
        t0 = time.perf_counter()
        for seed in SERVE_HTTP_SEEDS:
            posts.append(threading.Thread(target=post, args=(seed,)))
            posts[-1].start()
            time.sleep(SERVE_HTTP_STAGGER_S)
        for t in posts:
            t.join(600)
        http_s = time.perf_counter() - t0
        bad = {s: r[0] for s, r in replies.items() if r[0] != 200}
        if len(replies) != len(SERVE_HTTP_SEEDS) or bad:
            raise SystemExit(f"serving (b): responses {bad or sorted(replies)}")
        http_stats = json.loads(_http(port, "GET", "/stats")[1])
        if http_stats["batch_sizes"] != {"4": 1} or len(calls) != 1:
            raise SystemExit(f"serving (b): expected one bucket-4 batch, stats {http_stats}, calls {calls}")
        batch_seeds = calls[0][0]
        log(f"  HTTP: four concurrent requests formed one batch of seeds {batch_seeds} in {http_s:.3f} s")
        want = {s: o for s, o in zip(batch_seeds, pipe.generate_batch(
            batch_seeds, meta_prompt=workload.META_PROMPT, capture_diagnostics=False, **steps))}
        got = []
        for seed in SERVE_HTTP_SEEDS:
            reply = json.loads(replies[seed][1])
            img = decode_png(base64.b64decode(reply["image_png_b64"]), f"image_png_b64 of seed {seed}")
            got.append(torch.from_numpy(img.copy()))
        check_same("HTTP responses' PNG pixels against generate_batch of their batch",
                   got, [torch.from_numpy(want[s].images_u8[0]) for s in SERVE_HTTP_SEEDS], results)
        codes = [_http(port, "POST", "/generate", b)[0] for b in ({"meta_prompt": ""},
                                                                   {"meta_prompt": workload.META_PROMPT, "nope": 1})]
        if codes != [400, 400]:
            raise SystemExit(f"serving (b): malformed requests got {codes}, not 400")
        status, body = _http(port, "POST", "/generate", dict(meta_prompt=workload.META_PROMPT, seed=CLI_SEEDS[0],
                                                              num_inference_steps=SERVE_ARTIFACT_STEPS,
                                                              save_artifacts=True))
        reply = json.loads(body)
        tree = reply.get("artifacts_path")
        files = [os.path.join(d, f) for d, _, fs in os.walk(SERVE_OUT) for f in fs]
        logs, maps = (sum(k in os.path.basename(f) for f in files) for k in (".txt", "_attnmap_"))
        if status != 200 or not tree or not os.path.exists(tree) or "artifacts_error" in reply or not logs or maps < 2:
            raise SystemExit(f"serving (b): save_artifacts {status} {reply.get('artifacts_error')}, {len(files)} files "
                             f"({logs} logs, {maps} maps)")
        if (read_png(tree) != decode_png(base64.b64decode(reply["image_png_b64"]))).any():
            raise SystemExit("serving (b): the artifact tree's image differs from the response's")
        log(f"  HTTP: /healthz {health}; malformed requests {codes}; save_artifacts wrote {len(files)} files "
            f"under {SERVE_OUT}")
        out["http"] = {"seeds": list(SERVE_HTTP_SEEDS), "batch_seeds": batch_seeds, "s": http_s, "stats": http_stats,
                       "health": health, "malformed_codes": codes, "artifact_files": len(files)}
    finally:
        del pipe.dispatch_batch
        server.shutdown()
        server.server_close()

    # ---- (c) the web UI, through the same engine
    config = RunConfig(output_path=Path(SERVE_OUT) / "ui", n_inference_steps=SERVE_ARTIFACT_STEPS, device="cuda")
    try:
        status, page = _ui_once(config, pipe, engine, "GET", "/")
        if status != 200 or page != (gui.WEB_DIR / "ui.html").read_bytes():
            raise SystemExit(f"web UI: GET / gave {status}, {len(page)} bytes that are not the port's page")
        status, body = _ui_once(config, pipe, engine, "POST", "/execute_function", {"variable1": workload.META_PROMPT})
        ui_png = os.path.join(config.output_path, "static", "output.png")
        img = read_png(ui_png) if status == 200 and os.path.exists(ui_png) else None
        if img is None or img.shape != (CLI_IMAGE, CLI_IMAGE, 3) or float(img.std()) <= 0:
            raise SystemExit(f"web UI: POST /execute_function gave {status} {body[:200]!r}")
    finally:
        engine.close()
    log(f"  web UI: the port's page ({len(page)} bytes), one generation to {ui_png}")
    out["ui"] = {"page_bytes": len(page), "result": json.loads(body)["result"]}

    # ---- (d) closed-loop load through perf_server
    engine = BatchingEngine(pipe, buckets=SERVE_BUCKETS, max_wait_ms=perf_server.MAX_WAIT_MS)
    try:
        out["load"] = [perf_server.run_load(engine, n, c) for c, n in SERVE_LOAD]
    finally:
        engine.close()
    # the burst: every request queued before the batcher starts, so the
    # second group waits when the first one's batch returns
    engine = BatchingEngine(pipe, buckets=SERVE_BUCKETS, max_wait_ms=perf_server.MAX_WAIT_MS, _start_thread=False)
    rows = []
    load = threading.Thread(target=lambda: rows.append(perf_server.run_load(engine, SERVE_BURST, SERVE_BURST)))
    load.start()
    try:
        deadline = time.monotonic() + 120
        while engine.snapshot()["queued"] < SERVE_BURST and load.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        engine._thread.start()
        load.join(600)
    finally:
        engine.close()
    if not rows:
        raise SystemExit(f"serving (d): the burst of {SERVE_BURST} did not complete")
    out["load"] += rows
    batch_s_per_image = results["batch"]["s_per_image"]
    for row in out["load"]:
        log("  perf_server " + perf_server.report(row, card) + f"; phase 6's batch of 4: {batch_s_per_image:.3f} "
            "s/image")
    burst = out["load"][-1]
    first = burst["latency_s"]["min"] / burst["last_batch_s"]
    if burst["batch_sizes"] != {4: 2} or first > SERVE_FIRST_GROUP_BATCHES:
        raise SystemExit(f"serving (d): in the burst of {SERVE_BURST} the first group took {first:.2f} batch times "
                         f"(at most {SERVE_FIRST_GROUP_BATCHES}), batch sizes {burst['batch_sizes']}")
    log(f"  the burst of {SERVE_BURST}: the first group delivered in {first:.3f} batch times")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serving phase: {out['phase_s']:.1f} s")
    results["serve"] = out
    return launches


# the SD2.1 phase (phase 11): the parity traces' steps, and where its files
# go (under build/)
SD21_TRACE_STEPS = 10
MICRO_TRACE_STEPS = 4
MICRO_TRACE_SEED = 7
SD21_OUT = os.path.join("build", "chip_smoke_sd21")


class HostNoise:
    """Re-noise draws from a seeded CPU generator, moved to ``device``: the
    same numbers on the card and on the CPU (their own generators differ)."""

    def __init__(self, seed: int, shape, device):
        import torch

        self.gen = torch.Generator().manual_seed(seed)
        self.shape, self.device = tuple(shape), device

    def __call__(self, kind: str, i: int, r):
        import torch

        return torch.randn(self.shape, generator=self.gen, dtype=torch.float32).to(self.device)


def sd21_phase(results: dict) -> dict:
    """Phase 11: SD2.1-base (head dim 64, linear projections, gelu CLIP, EOT
    normalization) at full width on the card, bf16. Returns the K1-K3
    launch counts of the timed image."""
    import shutil

    import numpy as np
    import torch

    from guided_attention_tpu_torch import parity_trace as pt
    from guided_attention_tpu_torch import workload
    from guided_attention_tpu_torch.models.bundle import StableDiffusion
    from guided_attention_tpu_torch.ops.flash_attention import LAUNCHES, reset_launches
    from guided_attention_tpu_torch.runner import GuidedAttentionPipeline
    from guided_attention_tpu_torch.runtime import flops

    t_phase = time.perf_counter()
    card = results["card"]
    out: dict = {}
    shutil.rmtree(SD21_OUT, ignore_errors=True)
    os.makedirs(SD21_OUT)
    t0 = time.perf_counter()
    pipe = workload.create("cuda", model="sd21")
    sd = pipe.sd
    torch.cuda.synchronize()
    out["create_s"] = time.perf_counter() - t0
    log(f"sd21 bf16 random init on the card: {out['create_s']:.1f} s")

    # ---- (1) one full-width guidance eval, kernels against the plain route
    out["eval"] = eval_phase(sd, pipe, results)

    # ---- (2) one guided image: a warm-up seed, then the timed seed
    t0 = time.perf_counter()
    workload.generate(pipe, workload.WARMUP_SEED)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    img_out = workload.generate(pipe, workload.TIMED_SEED)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {name: LAUNCHES[name] for name in MAIN_PATH_KERNELS}
    d = img_out.diagnostics
    work = flops.generation_flops(sd.unet.config, d, workload.STEPS)
    img = img_out.images_u8
    image = {
        "s_per_image": sec, "warmup_s": warm, "steps": workload.STEPS,
        "n_evals_total": int(d.n_evals.sum()), "n_evals_step0": int(d.n_evals[0]),
        "refine_iters_step0": int(d.refine_iters[0]), "recursions_0_14": d.recursions[:15].tolist(),
        "image_shape": list(img.shape), "latents_finite": bool(np.isfinite(img_out.latents).all()),
        "image_std": float(img.std()), "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "unet_tflop": work / 1e12, "mfu": flops.mfu(work, sec), "launches": launches,
    }
    out["image"] = image
    log("sd21 image: " + json.dumps(image))
    log(f"sd21 image: {sec:.3f} s/image, {image['unet_tflop']:.3f} TFLOP of UNet work = {100 * image['mfu']:.3f}% "
        f"of the bf16 peak, peak {image['peak_mem_gib']:.3f} GiB; launches {json.dumps(launches)} (sd15's main "
        f"path: 332 / 72 / 180); n_evals {image['n_evals_total']}, refinements at step 0 "
        f"{image['refine_iters_step0']}, recursions {image['recursions_0_14']} ({card})")
    if img.shape != (1, 512, 512, 3) or not image["latents_finite"] or image["image_std"] <= 0:
        raise SystemExit("sd21 image is malformed (shape, finiteness or constant image)")
    for name, count in launches.items():
        if count <= 0:
            raise SystemExit(f"kernel {name} was not launched on the sd21 path")

    # ---- (3) reproducibility: the 15-step image twice, bitwise (fault F3's guard)
    twice = [workload.generate(pipe, workload.TIMED_SEED, steps=SD21_SHORT_STEPS) for _ in range(2)]
    check_same(f"sd21 guided {SD21_SHORT_STEPS}-step image run twice (default algorithms)",
               [torch.from_numpy(twice[1].latents), torch.from_numpy(twice[1].images_u8)],
               [torch.from_numpy(twice[0].latents), torch.from_numpy(twice[0].images_u8)], results)

    # ---- (4) parity traces
    lat_file = os.path.join(SD21_OUT, "init_sd21.npy")
    tr = {k: os.path.join(SD21_OUT, f"{k}.npz")
          for k in ("bf16_cli", "bf16", "bf16_plain", "fp32_plain", "micro_cuda", "micro_cpu")}
    trace_argv = ["trace", "--model", "sd21", "--sd_2_1", "--steps", str(SD21_TRACE_STEPS)]

    def meta(key: str) -> dict:
        return json.loads(str(np.load(tr[key])["meta"]))

    def held_route(key: str, kernels: bool) -> None:
        """The trace's own launch counts: every main-path kernel launched
        (kernels), or none (the plain route)."""
        n = {k: meta(key)["launches"][k] for k in MAIN_PATH_KERNELS}
        if (min(n.values()) <= 0) if kernels else (max(n.values()) != 0):
            raise SystemExit(f"the {key} trace launched {n}, not the {'kernels' if kernels else 'plain'} route")
        log(f"  {key} trace: route {meta(key)['attention']}, launches {json.dumps(n)}")

    # (a) bf16 through the kernels: the command line (its own bundle, the same
    # weights) and the Python entry on this phase's pipeline, bitwise equal
    if pt.main(trace_argv + ["--dtype", "bf16", "--save_latents", lat_file, "--out", tr["bf16_cli"]]) != 0:
        raise SystemExit("parity_trace trace (sd21 bf16) failed")
    pt.save(tr["bf16"], pt.trace(pipe, latents=np.load(lat_file), steps=SD21_TRACE_STEPS, sd_2_1=True, model="sd21"))
    held_route("bf16_cli", True)
    held_route("bf16", True)
    rows_a: dict = {}
    same = pt.compare(tr["bf16_cli"], tr["bf16"], rtol=0.0, atol=0.0, rows=rows_a)
    results.setdefault("checks", []).append({"name": "sd21 bf16 trace twice at tolerance 0", "ok": same})
    log(f"  sd21 bf16 trace ({SD21_TRACE_STEPS} steps) twice, compare at tolerance 0: {'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("the sd21 bf16 trace does not repeat bitwise")
    # (b) the full-width bf16 reading, a finding and not a gate: float32 on
    # the plain route (the command line sets use_flash_attention=False: the
    # kernels take bf16), and bf16 on the plain route (set here), so that
    # the kernels' share of the bf16-vs-float32 distance shows apart from
    # bf16 rounding in plain PyTorch
    if pt.main(trace_argv + ["--dtype", "fp32", "--latents", lat_file, "--out", tr["fp32_plain"]]) != 0:
        raise SystemExit("parity_trace trace (sd21 fp32) failed")
    cfg = sd.unet.config
    sd.unet.config = dataclasses.replace(cfg, use_flash_attention=False)
    log("  sd21 bf16 trace on the plain route (use_flash_attention=False, set explicitly)")
    pt.save(tr["bf16_plain"],
            pt.trace(pipe, latents=np.load(lat_file), steps=SD21_TRACE_STEPS, sd_2_1=True, model="sd21"))
    sd.unet.config = cfg
    held_route("fp32_plain", False)
    held_route("bf16_plain", False)
    log("  sd21 bf16 against float32, readings and not gates (the float32 trace runs the plain route, "
        "use_flash_attention=False, set explicitly):")
    rows_b: dict = {}
    for name, ref, got in (("bf16_kernels_vs_fp32_plain", "fp32_plain", "bf16"),
                           ("bf16_plain_vs_fp32_plain", "fp32_plain", "bf16_plain"),
                           ("bf16_kernels_vs_bf16_plain", "bf16_plain", "bf16")):
        log(f"  sd21 {name}:")
        rows_b[name] = {}
        pt.compare(tr[ref], tr[got], rows=rows_b[name])
    a = np.load(tr["bf16"])
    for other in ("fp32_plain", "bf16_plain"):
        b = np.load(tr[other])
        for key in pt.COMPARE_KEYS + ("eval_mask",):
            if key not in b or a[key].shape != b[key].shape or not np.isfinite(b[key].astype(np.float64)).all():
                raise SystemExit(f"sd21 {other} trace: {key} missing, of another shape or not finite")
    # (c) micro in float32, the card against the CPU, from one latent and one
    # stream of re-noise draws; the threshold 0.0 is never met, so both take
    # the same branches whatever their rounding (as the CPU parity tests do)
    cpu = StableDiffusion.create("micro", torch.float32, device="cpu", seed=workload.WEIGHT_SEED)
    gpu = StableDiffusion.create("micro", torch.float32, device="cuda", seed=workload.WEIGHT_SEED)
    for c in ("unet", "text_encoder", "vae"):
        getattr(gpu, c).load_state_dict(getattr(cpu, c).state_dict())
    gpu.unet.config = dataclasses.replace(gpu.unet.config, use_flash_attention=False)
    log("  micro fp32 trace on the card: the plain attention route (use_flash_attention=False, set explicitly)")
    s_lat = cpu.config.latent_size
    lat_micro = np.random.default_rng(MICRO_TRACE_SEED).standard_normal((1, s_lat, s_lat, 4)).astype(np.float32)
    for key, bundle in (("micro_cuda", gpu), ("micro_cpu", cpu)):
        noise = HostNoise(MICRO_TRACE_SEED, lat_micro.shape, bundle.device)
        pt.save(tr[key], pt.trace(GuidedAttentionPipeline(bundle), latents=lat_micro, steps=MICRO_TRACE_STEPS,
                                  thresholds="0:0.0", noise=noise, model="micro"))
    held_route("micro_cuda", False)
    rows_c: dict = {}
    card_cpu = pt.compare(tr["micro_cpu"], tr["micro_cuda"], rows=rows_c)
    results.setdefault("checks", []).append({"name": "micro fp32 trace, card against CPU", "ok": card_cpu})
    log(f"  micro fp32 trace ({MICRO_TRACE_STEPS} steps), card against CPU at the default tolerance: "
        f"{'ok' if card_cpu else 'FAIL'}")
    if not card_cpu:
        raise SystemExit("the micro trace on the card does not match the CPU trace")
    out["traces"] = {"steps": SD21_TRACE_STEPS, "bf16_twice": rows_a, **rows_b,
                     "micro_steps": MICRO_TRACE_STEPS, "micro_card_vs_cpu": rows_c}
    del pipe, sd, img_out, twice, cpu, gpu
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"sd21 phase: {out['phase_s']:.1f} s ({card})")
    results["sd21"] = out
    return launches


# the data-parallel phase (phase 12): one rank per card, and at least two
# (on a machine with one card they share it), launched by torchrun, each
# running this script's ``dp_rank``; their files go under build/ (listed in
# .gitignore)
DP_MIN_RANKS = 2
DP_SHORT_STEPS = 15  # (a)'s and (c)'s runs
DP_SEEDS = (40, 41, 42, 43)  # (c): four seeds under the two BATCH_PROMPTS in turn
DP_OUT = os.path.join("build", "chip_smoke_dp")
DP_TIMEOUT_S = 300


def _same_outputs(got, want) -> bool:
    """Latents, uint8 images and every StepDiag field bitwise equal."""
    import numpy as np

    from guided_attention_tpu_torch.pipeline import StepDiag

    return all(
        np.array_equal(g.latents, w.latents) and np.array_equal(g.images_u8, w.images_u8)
        and all(np.array_equal(getattr(g.diagnostics, f.name), getattr(w.diagnostics, f.name))
                for f in dataclasses.fields(StepDiag))
        for g, w in zip(got, want))


def dp_rank(out_dir: str) -> int:
    """One rank of phase 12 (run by torchrun): after a 2-step warm-up image
    (the process's first generation pays the CUDA libraries' start-up, which
    phase 8 paid before its runs), ``frontends.cli.main`` with
    ``--mesh_shape '{"data": N}'`` (seeds 28 and 42, 50 steps, its tree under
    ``out_dir/rank<r>/tree``), then ``generate_batch`` of ``DP_SEEDS`` under
    the two prompts over the same mesh; each with the launch counters zeroed
    just before it. Writes ``out_dir/rank<r>.json`` (launches, seconds) and
    ``.npz`` (the whole batch's outputs as this rank holds them)."""
    import numpy as np
    import torch

    from guided_attention_tpu_torch import workload
    from guided_attention_tpu_torch.frontends import cli
    from guided_attention_tpu_torch.ops import build
    from guided_attention_tpu_torch.ops.flash_attention import LAUNCHES, reset_launches
    from guided_attention_tpu_torch.parallel import multihost
    from guided_attention_tpu_torch.parallel.mesh import make_mesh
    from guided_attention_tpu_torch.pipeline import StepDiag

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent runs
    torch.backends.cudnn.allow_tf32 = False
    build.load_library()
    multihost.initialize()  # from torchrun's environment
    pipe = workload.create(str(multihost.rank_device("cuda")))
    workload.generate(pipe, workload.WARMUP_SEED, steps=BATCH_WARMUP_STEPS)
    rank, ranks = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    out_dir = os.path.abspath(out_dir)
    here = os.path.join(out_dir, f"rank{rank}")
    os.makedirs(here)
    os.chdir(here)  # the CLI's tree goes to ./tree: rank 1 must leave this directory empty
    stats: dict = {}
    reset_launches()
    t0 = time.perf_counter()
    cli.main(["--meta_prompt", workload.META_PROMPT, "--seeds", *map(str, CLI_SEEDS), "--batch_size", str(ranks),
              "--mesh_shape", json.dumps({"data": ranks}), "--output_path", "tree"], stats=stats)
    cli_wall = time.perf_counter() - t0
    cli_launches = {k: LAUNCHES[k] for k in MAIN_PATH_KERNELS}

    reset_launches()
    t0 = time.perf_counter()
    outs = workload.generate_batch(pipe, DP_SEEDS, steps=DP_SHORT_STEPS, mesh=make_mesh({"data": ranks}))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    info = {"rank": rank, "device": str(pipe.sd.device), "cli_wall_s": cli_wall, "cli_stats": stats,
            "cli_launches": cli_launches, "batch_s": batch_s,
            "batch_launches": {k: LAUNCHES[k] for k in MAIN_PATH_KERNELS},
            "images": [o.images_u8 is not None for o in outs]}
    arrays = {"latents": np.stack([o.latents for o in outs])}
    if all(info["images"]):
        arrays["images_u8"] = np.stack([o.images_u8 for o in outs])
    for f in dataclasses.fields(StepDiag):
        arrays[f.name] = np.stack([getattr(o.diagnostics, f.name) for o in outs])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    log(f"rank {rank} on {info['device']}: CLI {cli_wall:.1f} s, launches {json.dumps(cli_launches)}; batch of "
        f"{len(DP_SEEDS)} {batch_s:.1f} s, launches {json.dumps(info['batch_launches'])}")
    multihost.barrier()
    return 0


def dp_phase(pipe, results: dict) -> dict:
    """Phase 12: data parallelism. (a) one process, world size 1: a mesh of
    one rank changes no bit; (b) and (c) one rank per card, at least two (on
    one card, two ranks share it), in one torchrun launch (``dp_rank``): the
    CLI's chunk of two seeds, padded to the ranks, one sample per rank; its
    PNGs must be phase 8's ``--batch_size 1`` PNGs byte for byte and no
    rank but 0 may write a file; the batch must be whole and equal on every
    rank, each rank's rows equal to this process's one-process batch of
    them, images on rank 0 only; each rank must launch K1-K3 in each.
    Returns the ranks' launch counts."""
    import shutil
    import signal
    import subprocess

    import numpy as np
    import torch

    from guided_attention_tpu_torch import workload
    from guided_attention_tpu_torch.parallel.mesh import make_mesh
    from guided_attention_tpu_torch.pipeline import StepDiag

    card = results["card"]
    n_ranks = max(DP_MIN_RANKS, torch.cuda.device_count())
    t_phase = time.perf_counter()
    out = {}
    # (a) world size 1
    seeds, prompts = list(CLI_SEEDS), [workload.META_PROMPT] * len(CLI_SEEDS)
    want = workload.generate_batch(pipe, seeds, prompts, steps=DP_SHORT_STEPS)
    got = workload.generate_batch(pipe, seeds, prompts, steps=DP_SHORT_STEPS, mesh=make_mesh())
    out["one_process_bitwise"] = _same_outputs(got, want)
    log(f"  (a) one process: generate_batch(mesh=make_mesh()) against no mesh, {len(seeds)} seeds, "
        f"{DP_SHORT_STEPS} steps: {'bitwise' if out['one_process_bitwise'] else 'DIFFERENT'}")
    if not out["one_process_bitwise"]:
        raise SystemExit("phase 12 (a): a mesh of one process changed the batch")

    # (b) and (c): one torchrun launch
    shutil.rmtree(DP_OUT, ignore_errors=True)
    os.makedirs(DP_OUT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n_ranks),
           os.path.abspath(__file__), "--data-parallel-rank", DP_OUT]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, start_new_session=True)
    try:
        rc = proc.wait(timeout=DP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise SystemExit(f"phase 12: the ranks did not finish within {DP_TIMEOUT_S} s")
    launch_wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"phase 12: torchrun exited with {rc}")
    ranks = []
    for r in range(n_ranks):
        with open(os.path.join(DP_OUT, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for info in ranks:
        for kind in ("cli_launches", "batch_launches"):
            if min(info[kind].values()) <= 0:
                raise SystemExit(f"phase 12: rank {info['rank']} launched no {info[kind]} ({kind})")

    # (b) the CLI's tree: rank 0's is phase 8's batch-size-1 tree, PNG for PNG
    tree, single = os.path.join(DP_OUT, "rank0", "tree"), os.path.join(CLI_OUT, "batch_size_1")
    files = {root: sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)
             for root in (tree, single)}
    pngs = [f for f in files[single] if f.endswith(".png")]
    same = [f for f in pngs if Path(tree, f).read_bytes() == Path(single, f).read_bytes()]
    others = [f for r in range(1, n_ranks) for f in os.listdir(os.path.join(DP_OUT, f"rank{r}"))]
    gen = max(info["cli_stats"]["generate_s"] for info in ranks)
    phase8 = results["cli"]["batch_size 1"]
    out["cli"] = {"files": len(files[tree]), "pngs": len(pngs), "pngs_equal": len(same),
                  "same_file_set": files[tree] == files[single], "other_ranks_files": others,
                  "wall_s": max(info["cli_wall_s"] for info in ranks), "generate_s": gen,
                  "s_per_image": gen / len(CLI_SEEDS), "phase8_batch_size_1_s_per_image": phase8["s_per_image"],
                  "launch_wall_s": launch_wall}
    log(f"  (b) {n_ranks} ranks on {torch.cuda.device_count()} card(s), CLI --mesh_shape {{\"data\": {n_ranks}}}, "
        f"seeds {list(CLI_SEEDS)}, {workload.STEPS} steps: {len(same)}/{len(pngs)} PNGs byte for byte phase 8's "
        f"--batch_size 1, same files {out['cli']['same_file_set']}, ranks 1-{n_ranks - 1} wrote {others}; "
        f"wall {out['cli']['wall_s']:.3f} s, "
        f"{out['cli']['s_per_image']:.3f} s/image generating (phase 8 --batch_size 1: {phase8['s_per_image']:.3f}); "
        f"torchrun launch {launch_wall:.1f} s ({card})")
    if not pngs or len(same) != len(pngs) or not out["cli"]["same_file_set"] or others:
        raise SystemExit("phase 12 (b): the data-parallel CLI's tree is not phase 8's, or another rank wrote files")

    # (c) the Python batch: whole and equal on both ranks, each rank's rows
    # this process's one-process batch of them
    got = [dict(np.load(os.path.join(DP_OUT, f"rank{r}.npz"))) for r in range(n_ranks)]
    names = ["latents"] + [f.name for f in dataclasses.fields(StepDiag)]
    equal_ranks = all(np.array_equal(got[0][n], g[n]) for g in got[1:] for n in names)
    per = len(DP_SEEDS) // n_ranks
    prompts = workload.batch_prompts(len(DP_SEEDS))
    rows_equal = []
    for r in range(n_ranks):
        rows = slice(r * per, (r + 1) * per)
        ref = workload.generate_batch(pipe, DP_SEEDS[rows], prompts[rows], steps=DP_SHORT_STEPS)
        rows_equal.append(all(np.array_equal(got[0][n][rows], np.stack([getattr(o.diagnostics, n) for o in ref]))
                              for n in names[1:])
                          and np.array_equal(got[0]["latents"][rows], np.stack([o.latents for o in ref]))
                          and np.array_equal(got[0]["images_u8"][rows], np.stack([o.images_u8 for o in ref])))
    images = [info["images"] for info in ranks]
    out["ranks_on_cards"] = [n_ranks, torch.cuda.device_count()]
    out["batch"] = {"seeds": list(DP_SEEDS), "steps": DP_SHORT_STEPS, "whole_equal_on_ranks": equal_ranks,
                    "rows_equal_one_process": rows_equal, "images": images,
                    "s": [info["batch_s"] for info in ranks]}
    log(f"  (c) {n_ranks} ranks, generate_batch of {len(DP_SEEDS)} seeds under two prompts, {DP_SHORT_STEPS} steps: "
        f"whole batch equal on every rank {equal_ranks}, rows equal to this process's batch of them {rows_equal}, "
        f"images on ranks {[all(i) for i in images]}; {json.dumps(out['batch']['s'])} s ({card})")
    if not equal_ranks or not all(rows_equal) or images != [[r == 0] * len(DP_SEEDS) for r in range(n_ranks)]:
        raise SystemExit("phase 12 (c): the data-parallel batch is not whole, not equal, or has images off rank 0")
    out["ranks"] = ranks
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"data-parallel phase: {out['phase_s']:.1f} s ({card})")
    results["data_parallel"] = out
    return {k: [[info["cli_launches"][k], info["batch_launches"][k]] for info in ranks] for k in MAIN_PATH_KERNELS}


# the tensor-parallel phase (phase 13): two ranks in one torchrun launch (on
# one card they share it, over gloo; with more cards each has its own, over
# NCCL), each running this script's ``tp_rank``; their files go under
# build/ (listed in .gitignore)
TP_RANKS = 2
TP_MESH = {"data": 1, "tensor": 2}
TP_SERVE_MESH = {"data": 2}
TP_SERVE_BUCKETS = (2, 4)  # every bucket divides by the data axis
TP_SERVE_SEEDS = (50, 51, 52)  # three requests, padded to four: rows (50, 51) and (52, 52)
TP_SERVE_STEPS = 15
TP_SERVE_WAIT_MS = 2000.0
TP_OUT = os.path.join("build", "chip_smoke_tp")
TP_TIMEOUT_S = 420
# the main path at tp2 launches each kernel as often as one process does, on
# half the heads: 52 CFG forwards x 5 + 36 evals x 2 K1 calls, 36 x 2 K2
# (two kernels each), 36 evals x 5 captured layers K3
TP_PREDICTED_LAUNCHES = {"flash_self_fwd": 332, "flash_self_bwd": 72, "cross_attention_map_fwd": 180}


def _record_kernel_shapes() -> dict:
    """Wrap the K1-K3 launchers to record the shapes they launch (counted
    per shape); returns the record, filled as they run."""
    from guided_attention_tpu_torch.ops import flash_attention as fa

    seen: dict = {}
    for name, attr in (("flash_self_fwd", "_launch_k1"), ("flash_self_bwd", "_launch_k2"),
                       ("cross_attention_map_fwd", "_launch_k3")):
        launch = getattr(fa, attr)

        def wrapped(q, *args, _launch=launch, _name=name):
            key = f"{_name} {list(q.shape)}"
            seen[key] = seen.get(key, 0) + 1
            return _launch(q, *args)

        setattr(fa, attr, wrapped)
    return seen


def tp_rank(out_dir: str) -> int:
    """One rank of phase 13 (run by torchrun). On ``TP_MESH``: (a) one sd15
    bf16 guidance eval through the kernels, this rank's slices and the one
    process's whole UNet; (b) standard SD in float32 on the plain route,
    ``STANDARD_STEPS`` steps, tensor mesh and one process; (c) the main
    path's image, 50 steps, with the launch and collective counters zeroed
    just before it. On ``TP_SERVE_MESH``: (e) rank 0 serves over HTTP three
    requests (one bucket-4 batch), the other rank follows; each rank runs
    the one-process batch of its two rows; the server stops its follower.
    Writes ``out_dir/rank<r>.json`` and ``.npz``."""
    import base64
    import threading

    import numpy as np
    import torch

    from guided_attention_tpu_torch import workload
    from guided_attention_tpu_torch.frontends import server
    from guided_attention_tpu_torch.models.bundle import StableDiffusion
    from guided_attention_tpu_torch.ops import build
    from guided_attention_tpu_torch.ops.flash_attention import LAUNCHES, reset_launches
    from guided_attention_tpu_torch.parallel import multihost
    from guided_attention_tpu_torch.parallel import tensor as ptensor
    from guided_attention_tpu_torch.parallel.mesh import make_mesh
    from guided_attention_tpu_torch.runner import GuidedAttentionPipeline
    from guided_attention_tpu_torch.runtime.native import png_bytes

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent runs
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    build.load_library()
    multihost.initialize()  # from torchrun's environment
    dev = multihost.rank_device("cuda")
    rank = multihost.process_index()
    shapes = _record_kernel_shapes()
    pipe = workload.create(str(dev))
    tp = make_mesh(TP_MESH, device=dev)
    info = {"rank": rank, "device": str(dev), "backend": tp.tensor_backend}
    arrays = {}

    # (a) the eval: this rank's heads, then one process's whole UNet
    reset_launches()
    info["eval_tp_loss"], grad = guidance_eval(pipe, pipe._sd_for(tp))
    info["eval_launches"] = {k: LAUNCHES[k] for k in MAIN_PATH_KERNELS}
    arrays["eval_tp_grad"] = grad.cpu().numpy()
    info["eval_one_loss"], grad = guidance_eval(pipe, pipe.sd)
    arrays["eval_one_grad"] = grad.cpu().numpy()

    # (b) standard SD in float32, plain route (the kernels take bf16)
    sd32 = StableDiffusion.create("sd15", torch.float32, device=dev, seed=workload.WEIGHT_SEED)
    sd32.unet.config = dataclasses.replace(sd32.unet.config, use_flash_attention=False)
    p32 = GuidedAttentionPipeline(sd32)
    std = dict(meta_prompt=STANDARD_PROMPTS[0], num_inference_steps=STANDARD_STEPS, run_standard_sd=True,
               decode=False, capture_diagnostics=False)
    t0 = time.perf_counter()
    arrays["standard_tp"] = p32.generate_batch([workload.TIMED_SEED], mesh=tp, **std)[0].latents
    info["standard_tp_s"] = time.perf_counter() - t0
    arrays["standard_one"] = p32.generate_batch([workload.TIMED_SEED], **std)[0].latents
    del sd32, p32
    torch.cuda.empty_cache()

    # (c) the main path's image at tp2
    shapes.clear()
    reset_launches()
    ptensor.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = workload.generate_batch(pipe, [workload.TIMED_SEED], [workload.META_PROMPT], mesh=tp)[0]
    torch.cuda.synchronize()
    info["image_s"] = time.perf_counter() - t0
    d = out.diagnostics
    info.update(image_launches={k: LAUNCHES[k] for k in MAIN_PATH_KERNELS}, image_shapes=dict(shapes),
                image_all_reduces=ptensor.COLLECTIVES["all_reduce"], image_all_reduce_bytes=ptensor.COLLECTIVES["bytes"],
                n_evals_step0=int(d.n_evals[0]), refine_iters_step0=int(d.refine_iters[0]),
                recursions_step0=int(d.recursions[0]), n_evals_total=int(d.n_evals.sum()))
    arrays["image_latents"] = out.latents
    if out.images_u8 is not None:
        arrays["image_u8"] = out.images_u8

    # (e) the served mesh, data parallel: rank 0 serves, the other follows
    dp = make_mesh(TP_SERVE_MESH, device=dev)
    per = TP_SERVE_BUCKETS[-1] // TP_RANKS
    padded = list(TP_SERVE_SEEDS) + [TP_SERVE_SEEDS[-1]] * (TP_SERVE_BUCKETS[-1] - len(TP_SERVE_SEEDS))
    rows = padded[rank * per:(rank + 1) * per]
    knobs = dict(num_inference_steps=TP_SERVE_STEPS)
    t0 = time.perf_counter()
    if rank == 0:
        engine = server.BatchingEngine(pipe, max_wait_ms=TP_SERVE_WAIT_MS, buckets=TP_SERVE_BUCKETS, mesh=dp)
        httpd = server.make_server(engine, host="127.0.0.1", port=0)
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            status, body = _http(port, "GET", "/healthz")
            info["healthz"] = json.loads(body)
            replies = {}

            def post(seed):
                replies[seed] = _http(port, "POST", "/generate",
                                      {"meta_prompt": workload.META_PROMPT, "seed": seed, **knobs})

            posts = []
            for seed in TP_SERVE_SEEDS:  # in seed order: the batch's rows are the seeds in turn
                posts.append(threading.Thread(target=post, args=(seed,)))
                posts[-1].start()
                time.sleep(SERVE_HTTP_STAGGER_S)
            for t in posts:
                t.join(600)
            info["served_status"] = [replies[s][0] for s in TP_SERVE_SEEDS]
            served = [base64.b64decode(json.loads(replies[s][1])["image_png_b64"]) for s in TP_SERVE_SEEDS]
            info["serve_stats"] = engine.snapshot()
        finally:
            httpd.shutdown()
            httpd.server_close()
            engine.close()  # its stop message ends the follower
    else:
        info["followed"] = server.follow(pipe, dp)
    info["serve_s"] = time.perf_counter() - t0
    ref = pipe.generate_batch(rows, meta_prompt=workload.META_PROMPT, capture_diagnostics=False, **knobs)
    info["serve_rows"] = rows
    ref_png = [png_bytes(o.images_u8[0]) for o in ref]
    if rank == 0:
        info["served_png_equal"] = [served[b] == ref_png[b] for b in range(per)]
    info["rank_s"] = time.perf_counter() - t_start
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    if rank != 0:
        for b, png in enumerate(ref_png):
            Path(out_dir, f"rank{rank}_row{b}.png").write_bytes(png)
    else:
        for seed, png in zip(TP_SERVE_SEEDS, served):
            Path(out_dir, f"served_{seed}.png").write_bytes(png)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    log(f"rank {rank} on {info['device']} ({tp.tensor_backend}): image {info['image_s']:.1f} s, launches "
        f"{json.dumps(info['image_launches'])}, {info['image_all_reduces']} all-reduces")
    multihost.barrier()
    torch.distributed.destroy_process_group()  # the NCCL tensor group's resources with it
    return 0


def _tp_kernel_checks(results: dict) -> dict:
    """Phase 13 (d): K1-K3 against their plain versions at the local-head
    shapes a rank of ``TP_MESH`` launches on sd15 (4 of 8 heads): K1 [8,
    4096, 40] (CFG, two rows), K2 [4, 4096, 40] (the eval), K3 q [1, 4, 256,
    160] with 77 keys (a cluster of 4 blocks), phase 3's limits; timed as in
    phase 3, K1 beside SDPA's forward and K2 beside SDPA's backward replayed
    from a CUDA graph (phase 3's yardsticks). Returns each kernel's row for
    the kernels line."""
    import torch
    import torch.nn.functional as F

    from guided_attention_tpu_torch import perf_attn_kernel as pak
    from guided_attention_tpu_torch.ops import flash_attention as fa
    from guided_attention_tpu_torch.runtime.flops import bound_ms
    from guided_attention_tpu_torch.runtime.timing import alternating_ms, graph_alternating_ms

    g = torch.Generator(device="cuda").manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    rows = {}
    n, d = 4096, 40
    scale = d**-0.5
    q, k, v = randn(8, n, d), randn(8, n, d), randn(8, n, d)
    o, lse = fa.flash_self_fwd(q, k, v, scale)
    ref, lse_ref = fa.flash_self_fwd_plain(q, k, v, scale)
    torch.cuda.synchronize()
    tol = check_close(f"K1 out [8,{n},{d}] (tp2 CFG)", o, ref, results)
    check(f"K1 lse [8,{n},{d}] (tp2 CFG)", max_err(lse, lse_ref), LSE_TOL, results)
    b_ms, b_by = bound_ms(pak.fwd_flops(8, n, d), 4 * 8 * n * d * 2 + 8 * n * 4, exps=8 * n * n)
    q4, k4, v4 = (t.reshape(1, 8, n, d) for t in (q, k, v))
    rows["flash_self_fwd"] = {"shape": [8, n, d], "max_abs_err": max_err(o, ref), "tol": tol, "bound_ms": b_ms,
                              "bound_by": b_by, **alternating_ms({
                                  "ms": lambda: fa.flash_self_fwd(q, k, v, scale),
                                  "plain_ms": lambda: fa.flash_self_plain(q, k, v, scale),
                                  "library_ms": lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)})}
    q, k, v, do = randn(4, n, d), randn(4, n, d), randn(4, n, d), randn(4, n, d)
    o, lse = fa.flash_self_fwd(q, k, v, scale)
    got = fa.flash_self_bwd(q, k, v, o, do, lse, scale)
    want = fa.flash_self_bwd_plain(q, k, v, o, do, lse, scale)
    torch.cuda.synchronize()
    tols = [check_close(f"K2 {nm} [4,{n},{d}] (tp2 eval)", a, b, results) for nm, a, b in zip(("dq", "dk", "dv"), got, want)]
    check_same(f"K2 twice [4,{n},{d}] (tp2 eval)", got, fa.flash_self_bwd(q, k, v, o, do, lse, scale), results)
    b_ms, b_by = bound_ms(pak.bwd_flops(4, n, d), 8 * 4 * n * d * 2 + 4 * n * 4, exps=4 * n * n)
    _sdpa_fwd, sdpa_bwd, _grads = pak.sdpa_graphs(q, k, v, do, scale)
    rows["flash_self_bwd"] = {"shape": [4, n, d], "max_abs_err": max(max_err(a, b) for a, b in zip(got, want)),
                              "tol": min(tols), "bound_ms": b_ms, "bound_by": b_by,
                              **alternating_ms({"ms": lambda: fa.flash_self_bwd(q, k, v, o, do, lse, scale),
                                                "plain_ms": lambda: fa.flash_self_bwd_plain(q, k, v, o, do, lse, scale),
                                                "library_ms": sdpa_bwd})}
    del _sdpa_fwd, sdpa_bwd, _grads
    b, h, nq, nk, d = 1, 4, 256, 77, 160
    q, k, v = randn(b, h, nq, d), randn(b, h, nk, d), randn(b, h, nk, d)
    o, pmap = fa.cross_attention_map_fwd(q, k, v, d**-0.5)
    o_ref, m_ref = fa.cross_attention_map_plain(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    geo = fa.cross_map_geometry(b, h, nq, nk, d)
    tol = check_close(f"K3 out [{b},{h},{nq},{d}] keys {nk} (tp2, cluster of {geo['cluster']})", o, o_ref, results)
    check(f"K3 map [{b},{h},{nq},{d}] keys {nk} (tp2)", max_err(pmap, m_ref), 1e-5, results)
    check_same(f"K3 twice [{b},{h},{nq},{d}] keys {nk} (tp2)", (o, pmap), fa.cross_attention_map_fwd(q, k, v, d**-0.5),
               results)
    b_ms, b_by = bound_ms(4.0 * b * h * nq * nk * d, (2 * b * h * nq * d + 2 * b * h * nk * d) * 2 + b * nq * nk * 4,
                          exps=b * h * nq * nk)
    graphs = graph_alternating_ms({"graph_ms": lambda: fa.cross_attention_map_fwd(q, k, v, d**-0.5),
                                   "plain_graph_ms": lambda: fa.cross_attention_map_plain(q, k, v, d**-0.5)})
    rows["cross_attention_map_fwd"] = {"shape": [b, h, nq, nk, d], "geometry": geo, "max_abs_err": max_err(o, o_ref),
                                       "tol": tol, "map_max_abs_err": max_err(pmap, m_ref), "map_tol": 1e-5,
                                       "bound_ms": b_ms, "bound_by": b_by, **graphs, "ms": graphs["graph_ms"],
                                       "plain_ms": graphs["plain_graph_ms"], "library_ms": None}
    for name, row in rows.items():
        library = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
        log(f"  (d) {name} {row['shape']}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library (SDPA) "
            f"{library}, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def tp_phase(results: dict) -> dict:
    """Phase 13: the tensor axis and the served mesh. (d) in this process;
    (a)-(c) and (e) in one torchrun launch of ``TP_RANKS`` ranks
    (``tp_rank``). (a) each rank's eval loss within ``EVAL_LOSS_REL`` and
    its gradient within ``EVAL_GRAD_REL`` of the one process's, both
    bitwise equal across the ranks; (b) the float32 standard-SD latents
    within ``STANDARD_MAX_REL`` / ``STANDARD_RMS_REL`` of one process's;
    (c) the image well-formed, its step-0 evals and refinements phase 5's,
    each rank launching K1-K3; (e) every served PNG byte for byte its
    rank's one-process row, and both ranks exiting 0 once the server
    stops. Returns the ranks' K1-K3 launches in (c) and (d)'s rows."""
    import shutil
    import signal
    import subprocess

    import numpy as np
    import torch

    from guided_attention_tpu_torch import workload

    card = results["card"]
    main = results["main"]
    t_phase = time.perf_counter()
    out: dict = {"kernels": _tp_kernel_checks(results)}
    shutil.rmtree(TP_OUT, ignore_errors=True)
    os.makedirs(TP_OUT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(TP_RANKS),
           os.path.abspath(__file__), "--tensor-parallel-rank", TP_OUT]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, start_new_session=True)
    try:
        rc = proc.wait(timeout=TP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise SystemExit(f"phase 13: the ranks did not finish within {TP_TIMEOUT_S} s")
    out["launch_wall_s"] = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"phase 13: torchrun exited with {rc}")
    ranks, arrays = [], []
    for r in range(TP_RANKS):
        with open(os.path.join(TP_OUT, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        arrays.append(dict(np.load(os.path.join(TP_OUT, f"rank{r}.npz"))))
    backends = sorted({info["backend"] for info in ranks})
    out["backend"], out["ranks_on_cards"] = backends, [TP_RANKS, torch.cuda.device_count()]
    log(f"  tensor group: {TP_RANKS} ranks on {torch.cuda.device_count()} card(s), backend {', '.join(backends)} "
        f"(devices {[info['device'] for info in ranks]})")

    # (a) the eval at full width
    r0 = ranks[0]
    loss_rel = abs(r0["eval_tp_loss"] - r0["eval_one_loss"]) / abs(r0["eval_one_loss"])
    gt, go = arrays[0]["eval_tp_grad"], arrays[0]["eval_one_grad"]
    grad_rel = float(np.abs(gt - go).max() / np.abs(go).max())
    same_ranks = all(info["eval_tp_loss"] == r0["eval_tp_loss"] and np.array_equal(a["eval_tp_grad"], gt)
                     for info, a in zip(ranks[1:], arrays[1:]))
    log(f"  (a) sd15 eval at {json.dumps(TP_MESH)}: loss {r0['eval_tp_loss']:.6f} against one process "
        f"{r0['eval_one_loss']:.6f}; equal on every rank {same_ranks}; launches {json.dumps(r0['eval_launches'])}")
    check("tp2 eval loss (rel)", loss_rel, EVAL_LOSS_REL, results)
    check("tp2 eval grad (rel to max|grad|)", grad_rel, EVAL_GRAD_REL, results)
    if not same_ranks or not np.isfinite(gt).all() or not np.abs(gt).max() > 0:
        raise SystemExit("phase 13 (a): the eval differs between the ranks, or its gradient is not finite and nonzero")
    out["eval"] = {"loss_tp": r0["eval_tp_loss"], "loss_one": r0["eval_one_loss"], "loss_rel": loss_rel,
                   "grad_rel_to_max": grad_rel, "equal_on_ranks": same_ranks}

    # (b) standard SD, float32, plain route
    st, so = torch.from_numpy(arrays[0]["standard_tp"]), torch.from_numpy(arrays[0]["standard_one"])
    std_rel, std_rms = rel_max_err(st, so), rms_rel_err(st, so)
    std_same = all(np.array_equal(a["standard_tp"], arrays[0]["standard_tp"]) for a in arrays[1:])
    log(f"  (b) standard SD float32, {STANDARD_STEPS} steps, plain route: tp2 against one process rel max "
        f"{std_rel:.3e}, rel rms {std_rms:.3e}; equal on every rank {std_same}; tp2 {r0['standard_tp_s']:.1f} s")
    check("tp2 standard-SD float32 against one process (rel to max|latent|)", std_rel, STANDARD_MAX_REL, results,
          rms_rel=std_rms)
    if std_rms > STANDARD_RMS_REL or not std_same:
        raise SystemExit(f"phase 13 (b): relative rms {std_rms} above {STANDARD_RMS_REL}, or the ranks differ")
    out["standard"] = {"rel_max": std_rel, "rel_rms": std_rms, "equal_on_ranks": std_same, "s": r0["standard_tp_s"]}

    # (c) the main path's image at tp2
    img = arrays[0].get("image_u8")
    lat = arrays[0]["image_latents"]
    well = (img is not None and img.shape == (1, CLI_IMAGE, CLI_IMAGE, 3) and float(img.std()) > 0
            and bool(np.isfinite(lat).all()))
    same_diag = all(info["n_evals_step0"] == main["n_evals_step0"]
                    and info["refine_iters_step0"] == main["refine_iters_step0"] for info in ranks)
    image = {"s_per_image": [info["image_s"] for info in ranks], "phase5_s_per_image": main["s_per_image"],
             "n_evals_step0": [info["n_evals_step0"] for info in ranks],
             "refine_iters_step0": [info["refine_iters_step0"] for info in ranks],
             "phase5_step0": [main["n_evals_step0"], main["refine_iters_step0"]],
             "launches": [info["image_launches"] for info in ranks], "predicted_launches": TP_PREDICTED_LAUNCHES,
             "shapes": [info["image_shapes"] for info in ranks],
             "all_reduces": [info["image_all_reduces"] for info in ranks],
             "all_reduce_bytes": [info["image_all_reduce_bytes"] for info in ranks],
             "well_formed": well, "step0_as_phase5": same_diag,
             "image_std": None if img is None else float(img.std())}
    out["image"] = image
    log(f"  (c) main path at {json.dumps(TP_MESH)}, {workload.STEPS} steps: "
        f"{json.dumps(image['s_per_image'])} s/image per rank (phase 5, one process: {main['s_per_image']:.3f}); "
        f"step 0 evals / refinements {image['n_evals_step0']} / {image['refine_iters_step0']} (phase 5: "
        f"{main['n_evals_step0']} / {main['refine_iters_step0']}); well-formed {well} ({card})")
    for info in ranks:
        log(f"  (c) rank {info['rank']}: launches {json.dumps(info['image_launches'])} (predicted "
            f"{json.dumps(TP_PREDICTED_LAUNCHES)}); shapes {json.dumps(info['image_shapes'])}; "
            f"{info['image_all_reduces']} all-reduces, {info['image_all_reduce_bytes'] / 1e9:.3f} GB per image")
        if min(info["image_launches"].values()) <= 0:
            raise SystemExit(f"phase 13 (c): rank {info['rank']} launched no {info['image_launches']}")
    if not well or not same_diag:
        raise SystemExit("phase 13 (c): the tp2 image is malformed, or its step-0 diagnostics are not phase 5's")

    # (e) the served mesh
    served = [Path(TP_OUT, f"served_{s}.png").read_bytes() for s in TP_SERVE_SEEDS]
    per = TP_SERVE_BUCKETS[-1] // TP_RANKS
    rank1_rows = [Path(TP_OUT, f"rank1_row{b}.png").read_bytes() for b in range(per)]
    equal = r0["served_png_equal"] + [served[per + b] == rank1_rows[b] for b in range(len(served) - per)]
    decoded = [decode_png(p).shape for p in served]
    health = r0["healthz"]
    serve = {"seeds": list(TP_SERVE_SEEDS), "steps": TP_SERVE_STEPS, "status": r0["served_status"],
             "png_equal_one_process_rows": equal, "decoded": [list(sh) for sh in decoded], "healthz": health,
             "followed": ranks[1].get("followed"), "batch_sizes": r0["serve_stats"]["batch_sizes"],
             "serve_s": r0["serve_s"], "rows": [info["serve_rows"] for info in ranks]}
    out["serve"] = serve
    log(f"  (e) served mesh {json.dumps(TP_SERVE_MESH)}, buckets {list(TP_SERVE_BUCKETS)}: three requests, status "
        f"{serve['status']}, batch sizes {serve['batch_sizes']}, rows per rank {serve['rows']}; PNGs byte for byte "
        f"the one-process rows {equal}; /healthz mesh {health.get('mesh')}; rank 1 followed {serve['followed']} "
        f"batch(es) and stopped; {r0['serve_s']:.1f} s")
    if (not all(equal) or serve["status"] != [200] * len(TP_SERVE_SEEDS) or health.get("mesh") != TP_SERVE_MESH
            or serve["followed"] != 1 or serve["batch_sizes"] != {str(TP_SERVE_BUCKETS[-1]): 1}):
        raise SystemExit("phase 13 (e): the served mesh's PNGs, statuses, mesh or batches are not as expected")

    out["ranks"] = ranks
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tensor-parallel phase: {out['phase_s']:.1f} s, torchrun launch {out['launch_wall_s']:.1f} s ({card})")
    results["tensor_parallel"] = out
    return {k: [info["image_launches"][k] for info in ranks] for k in MAIN_PATH_KERNELS}


# the tooling phase (phase 14): the chains' length and reps, the profile's
# keys printed, the host tail's reps
TOOL_CHAIN = 20
TOOL_CHAIN_REPS = 3
TOOL_TOP_KEYS = 10
TOOL_HOST_TAIL_REPS = 2
# what each chain's graph must hold (the replay's kernels)
TOOL_CAPTURED = {"cfg": ("flash_self_fwd",), "eval": MAIN_PATH_KERNELS}


def tooling_phase(pipe, results: dict) -> dict:
    """Phase 14: the measuring tools on phase 5's pipeline. (a) and (b)
    ``perf_unet``'s CFG chain and eval chain (``TOOL_CHAIN`` calls each):
    each replayed from one CUDA graph, its last output against the eager
    chain's within ``STANDARD_MAX_REL`` / ``STANDARD_RMS_REL`` (bitwise
    equality printed), the graph holding the kernels of ``TOOL_CAPTURED``
    (counted in a profiled replay) and their captures counted; (c)
    ``profile.run`` on the main path's call, its join closing in every
    family, the top keys of copy/cast and other printed, the table in
    ``chiprun_out/profile_ops.json``; (d) ``perf_host_tail.measure`` and
    its split (no warm-up calls: phase 5 ran the path). Readings only: no
    time is gated. Returns each kernel's captured launches per chain."""
    from guided_attention_tpu_torch import perf_host_tail, perf_unet, workload
    from guided_attention_tpu_torch import profile as port_profile

    card = results["card"]
    t_phase = time.perf_counter()
    out: dict = {}
    captured = {name: {} for name in MAIN_PATH_KERNELS}
    for tag, variant in (("cfg", perf_unet.Variant()), ("eval", perf_unet.Variant(bwd=True))):
        t0 = time.perf_counter()
        row = perf_unet.measure(pipe.sd.unet, variant, n=TOOL_CHAIN, reps=TOOL_CHAIN_REPS)
        row["s"] = time.perf_counter() - t0
        out[tag] = row
        part = "(a)" if tag == "cfg" else "(b)"
        log(f"  {part} perf_unet {perf_unet.report(row, card)}; {row['s']:.1f} s")
        if not row["finite"] or row["rel_max_err"] > STANDARD_MAX_REL or row["rel_rms_err"] > STANDARD_RMS_REL:
            raise SystemExit(f"phase 14 {part}: the graph's {tag} chain is not finite or is not the eager chain's "
                             f"(rel max {row['rel_max_err']}, rel rms {row['rel_rms_err']})")
        if tag == "eval" and row["loss_rel_max_err"] > STANDARD_MAX_REL:
            raise SystemExit(f"phase 14 (b): the graph's losses are not the eager chain's ({row['loss_rel_max_err']})")
        for name in TOOL_CAPTURED[tag]:
            if row["graph_kernels"][name] <= 0 or row["captured_launches"][name] <= 0:
                raise SystemExit(f"phase 14 {part}: {name} was not captured into the {tag} chain's graph")
        for name in MAIN_PATH_KERNELS:
            captured[name][tag + "_chain"] = row["captured_launches"][name]

    # (c) the op and module breakdown of the main path's call (phase 5 warmed it)
    t0 = time.perf_counter()
    table = port_profile.run(pipe, warmup=False)
    summary, joined = table["summary"], table["join"]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_ops.json"), "w") as f:
        json.dump(table, f)
    top = {fam: port_profile.top_keys(joined, fam, TOOL_TOP_KEYS) for fam in port_profile.FULL_FAMILIES}
    out["profile"] = {"summary": summary, "families": joined["families"], "top": top, "s": time.perf_counter() - t0}
    log(f"  (c) profile: wall {summary['wall_s']:.3f} s, device {summary['device_kernel_ms']:.1f} ms, "
        f"{summary['launches']} launches, busy {100 * summary['device_busy_share']:.1f}%, join closes "
        f"{joined['closes']} ({summary['join_rows']} rows, unattributed {summary['join_unattributed_ms']:.2f} ms, "
        f"join {summary['join_s']:.1f} s); {out['profile']['s']:.1f} s")
    for fam, f in joined["families"].items():
        log(f"    [{fam}] {f['ms']:.2f} ms / {f['launches']}: rows {f['rows_ms']:.2f} ms / {f['rows_launches']}, "
            f"unattributed {f['unattributed_ms']:.2f} ms / {f['unattributed_launches']} "
            f"{'ok' if f['closes'] else 'FAIL'}")
    for fam in port_profile.FULL_FAMILIES:
        for what, rows, label in (("(module, op)", top[fam], "module"),
                                  ("(module kind, op)", port_profile.by_kind(joined, fam)[:TOOL_TOP_KEYS], "kind")):
            log(f"    top {TOOL_TOP_KEYS} {what} of {fam} by device ms:")
            for r in rows:
                log(f"    {r['ms']:10.2f} ms {r['launches']:7d}x  {r[label]}{' (backward)' if r['backward'] else ''}  "
                    f"{r['op'][:60]}")
    if not joined["closes"]:
        raise SystemExit("phase 14 (c): the profile's join does not close")

    # (d) the host tail of one call
    t0 = time.perf_counter()
    tail = perf_host_tail.measure(pipe, workload.STEPS, reps=TOOL_HOST_TAIL_REPS, warmup=False)
    tail["s"] = time.perf_counter() - t0
    out["host_tail"] = tail
    for line in perf_host_tail.report(tail, card):
        log("  (d) " + line)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tooling phase: {out['phase_s']:.1f} s ({card})")
    results["tooling"] = out
    return captured


# --phases: what a phase reads from another one's run
PHASES = tuple(range(1, 15))
PHASE_NEEDS = {9: (8,), 10: (6,), 12: (8,), 13: (5,), 14: (5,)}


def selected_phases(argv) -> list:
    """The phases ``--phases 1,2,3,13`` names, with the phases they read
    from (``PHASE_NEEDS``) and the card and build (1, 2); every phase
    without the flag."""
    if "--phases" not in argv:
        return list(PHASES)
    i = argv.index("--phases")
    try:
        chosen = {int(x) for x in argv[i + 1].split(",")}
    except (IndexError, ValueError):
        raise SystemExit("--phases takes a comma-separated list of phase numbers, e.g. --phases 1,2,3,13")
    if not chosen <= set(PHASES):
        raise SystemExit(f"--phases: no phase {sorted(chosen - set(PHASES))}; the phases are 1-{PHASES[-1]}")
    todo = list(chosen | {1, 2})
    while todo:
        for need in PHASE_NEEDS.get(todo.pop(), ()):
            if need not in chosen:
                chosen.add(need)
                todo.append(need)
    return sorted(chosen | {1, 2})


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
        return 2

    import numpy as np

    from guided_attention_tpu_torch import perf_attn_kernel, workload
    from guided_attention_tpu_torch.ops import build
    from guided_attention_tpu_torch.ops.flash_attention import LAUNCHES, reset_launches
    from guided_attention_tpu_torch.runtime import flops
    from guided_attention_tpu_torch.runtime.timing import card_name_and_power

    phases = selected_phases(list(argv))
    t_start = time.perf_counter()
    results: dict = {"phases": phases}
    # ---- 1. device
    card = card_name_and_power()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    log(f"phases: {phases}")
    results["card"] = card

    # ---- 2. build
    t0 = time.perf_counter()
    build.load_library()
    results["build_s"] = time.perf_counter() - t0
    log(f"kernels built/loaded in {results['build_s']:.1f} s")
    src = ""
    for line in build.build_log.splitlines():
        src = line[3:] if line.startswith("== ") else src
        # -Xptxas -v: registers, spills; for K1, K2, V1 and W1 also which kernel, and
        # ptxas's warnings and advisories (C75xx: wgmma serialized, warpgroup.arrive injected)
        hopper = src in HOPPER_SOURCES and any(w in line for w in ("entry function", "arning", "C75"))
        if "registers" in line or "spill" in line or line.startswith("==") or hopper:
            log("  " + line.strip())

    # ---- 3. kernels against their plain versions
    kernels = kernel_phase(results) if 3 in phases else []

    # ---- 4 and 5. the main path
    pipe = None
    if {4, 5, 6, 9, 10, 12, 14} & set(phases):
        t0 = time.perf_counter()
        pipe = workload.create("cuda")
        torch.cuda.synchronize()
        results["create_s"] = time.perf_counter() - t0
        log(f"sd15 bf16 random init on the card: {results['create_s']:.1f} s")
    if 4 in phases:
        results["eval_sd15"] = eval_phase(pipe.sd, pipe, results)

    launches: dict = {}
    if 5 in phases:
        t0 = time.perf_counter()
        workload.generate(pipe, workload.WARMUP_SEED)
        torch.cuda.synchronize()
        results["warmup_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = workload.generate(pipe, workload.TIMED_SEED)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches.update({name: LAUNCHES[name] for name in MAIN_PATH_KERNELS})
        d = out.diagnostics
        gen_flops = flops.generation_flops(pipe.sd.unet.config, d, workload.STEPS)
        img = out.images_u8
        main = {
            "s_per_image": sec,
            "warmup_s": results["warmup_s"],
            "steps": workload.STEPS,
            "n_evals_step0": int(d.n_evals[0]),
            "refine_iters_step0": int(d.refine_iters[0]),
            "recursions_step0": int(d.recursions[0]),
            "n_evals_total": int(d.n_evals.sum()),
            "image_shape": list(img.shape),
            "latents_finite": bool(np.isfinite(out.latents.astype(np.float32)).all()),
            "image_std": float(img.std()),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "unet_tflop": gen_flops / 1e12,
            "mfu": flops.mfu(gen_flops, sec),
            "launches": dict(launches),
        }
        results["main"] = main
        log("main path: " + json.dumps(main))
        log(f"main path model-FLOP share: {main['unet_tflop']:.3f} TFLOP of UNet work in {sec:.3f} s = "
            f"{100 * main['mfu']:.3f}% of the {flops.H100_BF16_PEAK_FLOPS / 1e12:.0f} TF/s bf16 peak ({card})")
        if img.shape != (1, 512, 512, 3) or not main["latents_finite"] or main["image_std"] <= 0:
            raise SystemExit("main path output is malformed (shape, finiteness or constant image)")

    # ---- 6. the batch path
    batch_launches = batch_phase(pipe, results) if 6 in phases else None

    # ---- 7. the microbench path
    if 7 in phases:
        reset_launches()
        bench = perf_attn_kernel.run(reps=MICROBENCH_REPS)
        torch.cuda.synchronize()
        perf_attn_kernel.report(bench)
        results["microbench"] = bench
        launches.update({name: LAUNCHES[name] for name in MICROBENCH_KERNELS})
    log("launches: " + json.dumps(launches))
    for name, count in launches.items():
        if count <= 0:
            path = "main" if name in MAIN_PATH_KERNELS else "microbench"
            raise SystemExit(f"kernel {name} was not launched on the {path} path")

    # ---- 8. the CLI path
    cli_launches = cli_phase(results) if 8 in phases else None

    # ---- 9. resumable runs and native checkpoints
    resumed_launches = resume_phase(pipe, results) if 9 in phases else None

    # ---- 10. serving
    serve_launches = serve_phase(pipe, results) if 10 in phases else None

    # ---- 11. SD2.1 at full width, and the parity traces
    sd21_launches = sd21_phase(results) if 11 in phases else None

    # ---- 12. data parallelism: one process, then two ranks on the card
    dp_launches = dp_phase(pipe, results) if 12 in phases else None

    # ---- 13. the tensor axis and the served mesh: two ranks
    tp_launches = tp_phase(results) if 13 in phases else None

    # ---- 14. the measuring tools: perf_unet's graphs, the profile's join, the host tail
    tool_launches = tooling_phase(pipe, results) if 14 in phases else None

    # ---- 15. the kernels line and the last line

    for row in kernels:
        row["launches"] = launches.get(row["name"])
        if row["name"] not in MAIN_PATH_KERNELS:
            continue
        for key, counts in (("batch_launches", batch_launches), ("cli_launches", cli_launches),
                            ("resumed_launches", resumed_launches), ("serve_launches", serve_launches),
                            ("sd21_launches", sd21_launches),
                            # per rank: [CLI run, Python batch]
                            ("data_parallel_launches", dp_launches),
                            # per rank: the main path's image at tp2
                            ("tensor_parallel_launches", tp_launches),
                            # captured into phase 14's graphs: a replay counts nothing
                            ("tooling_captured_launches", tool_launches)):
            if counts is not None:
                row[key] = counts[row["name"]]
        if tp_launches is not None:
            row["tensor_parallel_shape"] = results["tensor_parallel"]["kernels"][row["name"]]

    # ---- the kernels line; exponentials are operations: the line names the
    # two kinds of bound
    for row in kernels:
        for r in (row, row.get("batch_shape") or {}, row.get("sd21_shape") or {}, row.get("tensor_parallel_shape") or {}):
            if r.get("bound_by") == "exp":
                r["bound_by"], r["bound_by_unit"] = "operations", "exponentials"
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    log(f"total {results['total_s']:.1f} s")
    log(card)
    if kernels:
        log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--data-parallel-rank"]:
        sys.exit(dp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--tensor-parallel-rank"]:
        sys.exit(tp_rank(sys.argv[2]))
    sys.exit(main(sys.argv[1:]))
