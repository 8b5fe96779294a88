#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit, torch/CUDA versions, TF32 settings;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes its path gives it (bf16, forward and gradient): K1-K3 of the
     generation path (K1's logsumexp too, and every K1 tile configuration
     at a ragged shape), V1 and W1 of the microbench; time kernel, plain
     version and a library yardstick with CUDA events (median of 20
     bursts of 10 calls, taking turns burst by burst; SDPA's backward
     replayed from a CUDA graph, so that the host does not time it);
  4. one guidance eval (loss and latent gradient) of full-width SD1.5 with
     the kernels against the same eval through the plain attention path;
  5. the main path: guided 512x512 SD1.5 generation, 50 DDIM steps, the
     two-object meta-prompt, default thresholds; one warm-up seed, then one
     timed seed with the kernels' launch counters zeroed just before it;
     K1-K3 must each have launched; its model-FLOP share of the bf16 peak;
  6. the microbench path (``perf_attn_kernel.run``, few reps) with the
     counters zeroed just before it: V1 and W1 must each have launched;
  7. a {"kernels": [...]} line, then the last line
     {"ok": true, "device": {...}}.

Any failed check or exception exits non-zero before the last line. Weights
are random (flax-style init from a seed); the compute is SD1.5's. A full
log goes to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

# the kernels of each path: every one must launch when its path is driven
MAIN_PATH_KERNELS = ("flash_self_fwd", "flash_self_bwd", "cross_attention_map_fwd")
MICROBENCH_KERNELS = ("flash_self_fwd_v1", "flash_self_bwd_w1")
MICROBENCH_REPS = 5


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


def check_close(name: str, out, ref, results: dict) -> float:
    """Hold ``out`` against ``ref`` by the two limits above; returns the
    absolute tolerance it applied to the max error."""
    import torch

    diff = out.float() - ref.float()
    ref_max = float(ref.float().abs().max())
    rms_rel = float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(ref.float()))
    if rms_rel > RMS_REL:
        raise SystemExit(f"{name}: relative rms error {rms_rel} above {RMS_REL}")
    tol = MAX_REL * ref_max
    check(name, float(diff.abs().max()), tol, results, ref_max=ref_max, rms_rel=rms_rel, rms_tol=RMS_REL)
    return tol


def kernel_phase(results: dict) -> list:
    """Phase 3: compare and time K1, K2, K3, V1 and W1 at their paths' shapes."""
    import torch
    import torch.nn.functional as F

    from guided_attention_tpu_torch import perf_attn_kernel as pak
    from guided_attention_tpu_torch.ops import attention_variants as av
    from guided_attention_tpu_torch.ops import flash_attention as fa
    from guided_attention_tpu_torch.runtime.flops import bound_ms
    from guided_attention_tpu_torch.runtime.timing import alternating_ms

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(torch.bfloat16)

    def timed(kernel, plain, library=None) -> dict:
        fns = {"ms": kernel, "plain_ms": plain}
        if library is not None:
            fns["library_ms"] = library
        return {"library_ms": None, **alternating_ms(fns)}

    kernels = []
    # ---- K1 forward: SD2.1 D=64, a ragged [3, 1000, 40] (TMA zero-fill and
    # the -inf key mask), eval call [8, 4096, 40], CFG call [2*8, 4096, 40]
    log("K1 flash_self_fwd")
    for bh, n, d in ((10, 4096, 64), (3, 1000, 40), (8, 4096, 40), (16, 4096, 40)):
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
    # the row and the timings are the CFG call's, the last case above
    k1_err = max_err(o, ref)
    q4, k4, v4 = (t.reshape(2, 8, n, d) for t in (q, k, v))
    b_ms, b_by = bound_ms(pak.fwd_flops(bh, n, d), 4 * bh * n * d * 2 + bh * n * 4, exps=bh * n * n)
    kernels.append({
        "name": "flash_self_fwd", "route": "cuda", "path": "main",
        "source": "guided_attention_tpu_torch/csrc/flash_self_fwd.cu",
        "replaces": "guided_attention_tpu/ops/flash_attention.py:114",
        "shape": [bh, n, d], "max_abs_err": k1_err, "tol": k1_tol,
        "lse_max_abs_err": k1_lse_err, "lse_tol": LSE_TOL,
        "bound_ms": b_ms, "bound_by": b_by,
        **timed(lambda: fa.flash_self_fwd(q, k, v, scale), lambda: fa.flash_self_plain(q, k, v, scale),
                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)),
    })

    # ---- V1 forward (microbench): both forward shapes, bf16_p 0 and 1
    log("V1 flash_self_fwd_v1")
    v1 = {}
    for bh, n, d in pak.FWD_SHAPES[::-1]:
        q, k, v = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        scale = d**-0.5
        for bp in (False, True):
            o = av.flash_self_fwd_v1(q, k, v, scale, bp)
            ref = av.flash_self_fwd_v1_plain(q, k, v, scale, bp)
            torch.cuda.synchronize()
            tol = check_close(f"V1 out bf16_p={int(bp)} [{bh},{n},{d}]", o, ref, results)
            v1[bp] = {"max_abs_err": max_err(o, ref), "tol": tol}
    # the row and the timings are at the CFG call's shape, FWD_SHAPES[0]
    q4, k4, v4 = (t.reshape(1, bh, n, d) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)  # noqa: E731
    for bp in (False, True):
        v1[bp].update(timed(lambda: av.flash_self_fwd_v1(q, k, v, scale, bp),
                            lambda: av.flash_self_fwd_v1_plain(q, k, v, scale, bp), sdpa))
    b_ms, b_by = bound_ms(pak.fwd_flops(bh, n, d), 4 * bh * n * d * 2, exps=bh * n * n)
    kernels.append({
        "name": "flash_self_fwd_v1", "route": "cuda", "path": "microbench",
        "source": "guided_attention_tpu_torch/csrc/flash_self_fwd_v1.cu",
        "replaces": "scripts/perf_attn_kernel.py:90",
        "shape": [bh, n, d], "bf16_p": 0, **v1[False], "bound_ms": b_ms, "bound_by": b_by,
        "bf16_p_1": v1[True],
    })

    # ---- K2 backward: eval call [8, 4096, 40], SD2.1 [5, 4096, 64]
    log("K2 flash_self_bwd")
    k2_row = None
    for bh, n, d in ((5, 4096, 64), (8, 4096, 40)):
        q, k, v, do = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        scale = d**-0.5
        o, lse = fa.flash_self_fwd(q, k, v, scale)
        dq, dk, dv = fa.flash_self_bwd(q, k, v, o, do, lse, scale)
        qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        out_ref = fa.flash_self_plain(qr, kr, vr, scale)
        gq, gk, gv = torch.autograd.grad(out_ref, (qr, kr, vr), do, retain_graph=True)
        torch.cuda.synchronize()
        errs = [max_err(a, b) for a, b in ((dq, gq), (dk, gk), (dv, gv))]
        tols = [check_close(f"K2 {nm} [{bh},{n},{d}]", a, b, results)
                for nm, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), (gq, gk, gv))]
        if d == 40:
            # one exponential per pair, what the algorithm needs (K2 recomputes P twice)
            b_ms, b_by = bound_ms(pak.bwd_flops(bh, n, d), 8 * bh * n * d * 2 + bh * n * 4, exps=bh * n * n)
            _fwd, sdpa_bwd, _grads = pak.sdpa_graphs(q, k, v, do, scale)
            k2_row = {
                "name": "flash_self_bwd", "route": "cuda", "path": "main",
                "source": "guided_attention_tpu_torch/csrc/flash_self_bwd.cu",
                "replaces": "guided_attention_tpu/ops/flash_attention.py:140",
                "shape": [bh, n, d], "max_abs_err": max(errs), "tol": min(tols),
                "bound_ms": b_ms, "bound_by": b_by,
                **timed(lambda: fa.flash_self_bwd(q, k, v, o, do, lse, scale),
                        lambda: torch.autograd.grad(out_ref, (qr, kr, vr), do, retain_graph=True),
                        sdpa_bwd),
            }
    kernels.append(k2_row)

    # ---- W1 backward (microbench): [8, 4096, 40]; dq bf16, dk and dv fp32
    log("W1 flash_self_bwd_w1")
    bh, n, d = pak.BWD_SHAPE
    q, k, v, do = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
    scale = d**-0.5
    got = av.flash_self_bwd_w1(q, k, v, do, scale)
    want = av.flash_self_bwd_w1_plain(q, k, v, do, scale)
    torch.cuda.synchronize()
    errs = [max_err(a, b) for a, b in zip(got, want)]
    tols = [check_close(f"W1 {nm} [{bh},{n},{d}]", a, b, results) for nm, a, b in zip(("dq", "dk", "dv"), got, want)]
    del got, want
    sdpa_fwd, sdpa_bwd, _grads = pak.sdpa_graphs(q, k, v, do, scale)

    def sdpa_fwd_bwd():
        sdpa_fwd()
        sdpa_bwd()

    elems = bh * n * d
    b_ms, b_by = bound_ms(pak.bwd_flops(bh, n, d), 5 * elems * 2 + 2 * elems * 4, exps=bh * n * n)
    kernels.append({
        "name": "flash_self_bwd_w1", "route": "cuda", "path": "microbench",
        "source": "guided_attention_tpu_torch/csrc/flash_self_bwd_w1.cu",
        "replaces": "scripts/perf_attn_kernel.py:139",
        "shape": [bh, n, d], "max_abs_err": max(errs), "tol": min(tols),
        "bound_ms": b_ms, "bound_by": b_by,
        # library: SDPA forward and backward (CUDA graphs), W1's function from the same inputs
        **timed(lambda: av.flash_self_bwd_w1(q, k, v, do, scale),
                lambda: av.flash_self_bwd_w1_plain(q, k, v, do, scale), sdpa_fwd_bwd),
    })

    # ---- K3 cross-attention with map: q [1,8,256,160], k/v [1,8,77,160]
    log("K3 cross_attention_map_fwd")
    b, h, nq, nk, d = 1, 8, 256, 77, 160
    q, k, v = randn(b, h, nq, d), randn(b, h, nk, d), randn(b, h, nk, d)
    scale = d**-0.5
    o, pmap = fa.cross_attention_map_fwd(q, k, v, scale)
    o_ref, m_ref = fa.cross_attention_map_plain(q, k, v, scale)
    torch.cuda.synchronize()
    e_out, e_map = max_err(o, o_ref), max_err(pmap, m_ref)
    k3_tol = check_close("K3 out", o, o_ref, results)
    check("K3 map", e_map, 1e-5, results)  # fp32 map, fp32 math on both sides
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
    flops = 4.0 * b * h * nq * nk * d
    nbytes = (2 * b * h * nq * d + 2 * b * h * nk * d) * 2 + b * nq * nk * 4
    b_ms, b_by = bound_ms(flops, nbytes)
    kernels.append({
        "name": "cross_attention_map_fwd", "route": "cuda", "path": "main",
        "source": "guided_attention_tpu_torch/csrc/cross_attention_map.cu",
        "replaces": "guided_attention_tpu/ops/flash_attention.py:241",
        "shape": [b, h, nq, nk, d], "max_abs_err": e_out, "tol": k3_tol,
        "map_max_abs_err": e_map, "map_tol": 1e-5,
        "bound_ms": b_ms, "bound_by": b_by,
        **timed(lambda: fa.cross_attention_map_fwd(q, k, v, scale),
                lambda: fa.cross_attention_map_plain(q, k, v, scale)),
    })
    return kernels


def eval_phase(sd, pipe, results: dict) -> None:
    """Phase 4: one full-width guidance eval through the kernels vs the
    plain attention path, same latent and prompt."""
    import torch

    from guided_attention_tpu_torch import workload
    from guided_attention_tpu_torch.pipeline import _Loop
    from guided_attention_tpu_torch.runner import PrepareOptions

    hp, _p, _a, spec, statics, sched, arrays, emb = pipe._prepare(PrepareOptions(meta_prompt=workload.META_PROMPT))
    g = torch.Generator(device="cuda").manual_seed(5)
    lat = torch.randn((1, 64, 64, 4), generator=g, device="cuda").to(torch.bfloat16)
    t = int(sched.timesteps[0])
    cfg = sd.unet.config
    outs = {}
    for route, flash in (("kernels", True), ("plain", False)):
        sd.unet.config = dataclasses.replace(cfg, use_flash_attention=flash)
        loop = _Loop(sd, statics, hp, emb, spec, sched, arrays, None, ("up", "down", "mid"))
        with torch.no_grad():
            loss, aux, grad = loop.guidance_eval(lat, t, 0.0, lat)
        outs[route] = (float(loss), grad.float())
    sd.unet.config = cfg
    (lk, gk), (lp, gp) = outs["kernels"], outs["plain"]
    log(f"  eval loss kernels={lk:.6f} plain={lp:.6f}")
    # bf16 network on both routes: the attention outputs differ at bf16
    # rounding, which the eval's forward and backward carry along. Measured
    # on an H100: loss within 5e-7 relative, gradient within 1.3-1.6% of
    # its largest entry; the limits leave 2.5x room on the gradient and
    # ~200x on the loss (its maps come from fp32 scores on both routes).
    check("eval loss (rel)", abs(lk - lp) / abs(lp), 1e-4, results)
    gerr = max_err(gk, gp)
    check("eval grad (rel to max|grad|)", gerr / float(gp.abs().max()), 0.04, results)
    if not (torch.isfinite(gk).all() and float(gk.abs().max()) > 0):
        raise SystemExit("eval gradient through the kernels is not finite and nonzero")


def main() -> int:
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

    t_start = time.perf_counter()
    results: dict = {}
    # ---- 1. device
    card = card_name_and_power()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    results["card"] = card

    # ---- 2. build
    t0 = time.perf_counter()
    build.load_library()
    results["build_s"] = time.perf_counter() - t0
    log(f"kernels built/loaded in {results['build_s']:.1f} s")
    src = ""
    for line in build.build_log.splitlines():
        src = line[3:] if line.startswith("== ") else src
        # -Xptxas -v: registers, spills; for K1 also which kernel, and ptxas's
        # warnings and advisories (C75xx: wgmma serialized, warpgroup.arrive injected)
        k1 = src == "flash_self_fwd.cu" and any(w in line for w in ("entry function", "arning", "C75"))
        if "registers" in line or "spill" in line or line.startswith("==") or k1:
            log("  " + line.strip())

    # ---- 3. kernels against their plain versions
    kernels = kernel_phase(results)

    # ---- 4 and 5. the main path
    t0 = time.perf_counter()
    pipe = workload.create("cuda")
    sd = pipe.sd
    torch.cuda.synchronize()
    results["create_s"] = time.perf_counter() - t0
    log(f"sd15 bf16 random init on the card: {results['create_s']:.1f} s")
    eval_phase(sd, pipe, results)

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
    launches = {name: LAUNCHES[name] for name in MAIN_PATH_KERNELS}
    d = out.diagnostics
    gen_flops = flops.generation_flops(sd.unet.config, d, workload.STEPS)
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
        "launches": launches,
    }
    results["main"] = main
    log("main path: " + json.dumps(main))
    log(f"main path model-FLOP share: {main['unet_tflop']:.3f} TFLOP of UNet work in {sec:.3f} s = "
        f"{100 * main['mfu']:.3f}% of the {flops.H100_BF16_PEAK_FLOPS / 1e12:.0f} TF/s bf16 peak ({card})")
    if img.shape != (1, 512, 512, 3) or not main["latents_finite"] or main["image_std"] <= 0:
        raise SystemExit("main path output is malformed (shape, finiteness or constant image)")

    # ---- 6. the microbench path
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
    for row in kernels:
        row["launches"] = launches[row["name"]]

    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    log(f"total {results['total_s']:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
