"""Microbenchmark of the self-attention kernels and their variants on the card.

    python -m guided_attention_tpu_torch.perf_attn_kernel [--reps 30]

The CUDA counterpart of the JAX package's ``scripts/perf_attn_kernel.py``.
Rows, each a kernel of ``ops/`` or PyTorch's fused attention as yardstick:

  forward at [16, 4096, 40] (the CFG call) and [8, 4096, 40] (the eval call):
    K1 ``flash_self_fwd`` (the main path's tile configuration) and one row
    per tile configuration of K1 (``K1 c<i> (BQ,BK,stages)``,
    ``flash_self_fwd_tiles``); V1 ``flash_self_fwd_v1`` with bf16_p 0 and 1
    (the ones-column denominator); SDPA (``scaled_dot_product_attention``);
  backward at [8, 4096, 40] (the eval call):
    K2 ``flash_self_bwd`` given K1's output and logsumexp; K1+K2; W1
    ``flash_self_bwd_w1`` (no saved output or logsumexp); SDPA's backward
    given its forward, and SDPA forward+backward (W1's function from the
    same inputs), both replayed from CUDA graphs (``sdpa_graphs``): through
    autograd the host takes longer per call than the card, so only a graph
    times SDPA's device work.

For each row: the median over ``--reps`` repetitions of the per-call time
of a burst of 10 calls between two CUDA events (``runtime/timing.py``), the
variants of one shape taking turns burst by burst, after warm-up calls, with
inputs warm in L2 (the largest input set, q/k/v at [16, 4096, 40], is 15.7 MB
of the 50 MB); TF/s of the function's own operations (4*BH*N^2*D forward,
10*BH*N^2*D backward) and their share of the H100's 989 TF/s bf16 peak; the
least time the card could take (``runtime/flops.bound_ms``, which counts
the one exponential per (query, key) pair beside the products and bytes);
and the numerics: max |out - ref| / max |ref| against the row's plain PyTorch
version (over dq, dk and dv for a backward) and, for V1 and W1, against
K1's and K2's output. The TPU script's block sweeps become K1's tile rows;
the other kernels' tiles are compile-time constants, one row each. A failed
build or launch raises: nothing falls back.

Prints a table, the card's name and power limit, and one JSON line; writes
the same JSON to ``chiprun_out/perf_attn_kernel.json``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import torch

from guided_attention_tpu_torch.ops import attention_variants as av
from guided_attention_tpu_torch.ops import flash_attention as fa
from guided_attention_tpu_torch.runtime.flops import H100_BF16_PEAK_FLOPS, bound_ms
from guided_attention_tpu_torch.runtime.timing import alternating_ms, card_name_and_power

FWD_SHAPES = ((16, 4096, 40), (8, 4096, 40))
BWD_SHAPE = (8, 4096, 40)
OUT = os.path.join("chiprun_out", "perf_attn_kernel.json")


def fwd_flops(bh: int, n: int, d: int) -> float:
    return 4.0 * bh * n * n * d


def bwd_flops(bh: int, n: int, d: int) -> float:
    return 10.0 * bh * n * n * d


def rel_err(out, ref) -> float:
    """max |out - ref| / max |ref|, in fp32."""
    ref = ref.float()
    return float((out.float() - ref).abs().max() / ref.abs().max())


def k1_tiles_name(config: int) -> str:
    """Row name of K1's tile configuration ``config``: its (queries, keys,
    stages) per block."""
    return f"K1 c{config} ({','.join(map(str, fa.K1_TILE_CONFIGS[config]))})"


def sdpa_graphs(q, k, v, do, scale: float, warmup: int = 3):
    """SDPA's forward and its backward through autograd on [BH, N, D]
    tensors, each captured in a CUDA graph on one side stream (the backward
    keeps its saved tensors: ``retain_graph``). Returns (forward replay,
    backward replay, the backward's (dq, dk, dv) as [BH, N, D]); the
    forward has been replayed once, so the backward reads a real output.
    A replay launches the captured kernels without the host's per-op work,
    so its time is the device's."""
    import torch.nn.functional as F

    bh, n, d = q.shape
    q4, k4, v4 = (t.detach().reshape(1, bh, n, d).requires_grad_(True) for t in (q, k, v))
    do4 = do.reshape(1, bh, n, d)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4, scale=scale), (q4, k4, v4), do4)
    torch.cuda.current_stream().wait_stream(side)
    fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(fwd, stream=side):
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
    with torch.cuda.graph(bwd, stream=side, pool=fwd.pool()):
        grads = torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)
    fwd.replay()
    bwd.replay()
    return fwd.replay, bwd.replay, [g.reshape(bh, n, d) for g in grads]


def _inputs(count: int, shape, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(torch.bfloat16) for _ in range(count)]


def _rows(shape, flops: float, nbytes: Dict[str, float], ms: Dict[str, float], errs: Dict[str, dict]) -> List[dict]:
    bh, n, _d = shape
    rows = []
    for name, t in ms.items():
        b_ms, b_by = bound_ms(flops, nbytes[name], exps=bh * n * n)
        rows.append({
            "variant": name, "shape": list(shape), "ms": t, "tflops": flops / t / 1e9,
            "pct_peak": 100.0 * flops / (t * 1e-3) / H100_BF16_PEAK_FLOPS,
            "bound_ms": b_ms, "bound_by": b_by, **errs[name],
        })
    return rows


def forward_rows(bh: int, n: int, d: int, reps: int, seed: int = 0) -> List[dict]:
    import torch.nn.functional as F

    q, k, v = _inputs(3, (bh, n, d), seed)
    scale = d**-0.5
    q4, k4, v4 = (t.reshape(1, bh, n, d) for t in (q, k, v))
    with torch.no_grad():
        ref = fa.flash_self_plain(q, k, v, scale)
        o_k1, _ = fa.flash_self_fwd(q, k, v, scale)
        errs = {
            "K1": {"err_vs_plain": rel_err(o_k1, ref)},
            "SDPA": {"err_vs_plain": rel_err(F.scaled_dot_product_attention(q4, k4, v4, scale=scale).reshape(q.shape), ref)},
        }
        fns = {"K1": lambda: fa.flash_self_fwd(q, k, v, scale)}
        for c in range(len(fa.K1_TILE_CONFIGS)):
            name = k1_tiles_name(c)
            o, _ = fa.flash_self_fwd_tiles(q, k, v, scale, c)
            errs[name] = {"err_vs_plain": rel_err(o, ref), "err_vs_k1": rel_err(o, o_k1)}
            fns[name] = lambda c=c: fa.flash_self_fwd_tiles(q, k, v, scale, c)
        for bp in (0, 1):
            name = f"V1 bf16_p={bp}"
            o = av.flash_self_fwd_v1(q, k, v, scale, bool(bp))
            errs[name] = {
                "err_vs_plain": rel_err(o, av.flash_self_fwd_v1_plain(q, k, v, scale, bool(bp))),
                "err_vs_k1": rel_err(o, o_k1),
            }
            fns[name] = lambda bp=bp: av.flash_self_fwd_v1(q, k, v, scale, bool(bp))
        fns["SDPA"] = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        del ref
        ms = alternating_ms(fns, reps)
    io = 4.0 * bh * n * d * 2  # q, k, v read, o written, bf16
    nbytes = {name: io + (bh * n * 4 if name.startswith("K1") else 0) for name in fns}  # and K1's fp32 logsumexp
    return _rows((bh, n, d), fwd_flops(bh, n, d), nbytes, ms, {name: errs[name] for name in fns})


def backward_rows(bh: int, n: int, d: int, reps: int, seed: int = 1) -> List[dict]:
    q, k, v, do = _inputs(4, (bh, n, d), seed)
    scale = d**-0.5
    qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    ref = torch.autograd.grad(fa.flash_self_plain(qr, kr, vr, scale), (qr, kr, vr), do)
    del qr, kr, vr

    def worst(got, want) -> float:
        return max(rel_err(a, b) for a, b in zip(got, want))

    o, lse = fa.flash_self_fwd(q, k, v, scale)
    g_k2 = fa.flash_self_bwd(q, k, v, o, do, lse, scale)
    g_w1 = av.flash_self_bwd_w1(q, k, v, do, scale)
    sdpa_fwd, sdpa_bwd, g_sdpa = sdpa_graphs(q, k, v, do, scale)
    errs = {
        "K2": {"err_vs_plain": worst(g_k2, ref)},
        "K1+K2": {"err_vs_plain": worst(g_k2, ref)},
        "W1": {"err_vs_plain": worst(g_w1, av.flash_self_bwd_w1_plain(q, k, v, do, scale)),
               "err_vs_k2": worst(g_w1, g_k2)},
        "SDPA bwd (graph)": {"err_vs_plain": worst(g_sdpa, ref)},
        "SDPA fwd+bwd (graph)": {"err_vs_plain": worst(g_sdpa, ref)},
    }
    del ref, g_k2, g_w1

    def k1k2():
        o, lse = fa.flash_self_fwd(q, k, v, scale)
        return fa.flash_self_bwd(q, k, v, o, do, lse, scale)

    def sdpa_fwd_bwd():
        sdpa_fwd()
        sdpa_bwd()

    fns = {
        "K2": lambda: fa.flash_self_bwd(q, k, v, o, do, lse, scale),
        "K1+K2": k1k2,
        "W1": lambda: av.flash_self_bwd_w1(q, k, v, do, scale),
        "SDPA bwd (graph)": sdpa_bwd,
        "SDPA fwd+bwd (graph)": sdpa_fwd_bwd,
    }
    ms = alternating_ms(fns, reps)
    elems = bh * n * d
    nbytes = {
        "K2": 5 * elems * 2 + bh * n * 4 + 3 * elems * 2,  # q, k, v, o, do, lse in; dq, dk, dv out
        "K1+K2": 4 * elems * 2 + 3 * elems * 2,  # q, k, v, do in; dq, dk, dv out
        "W1": 4 * elems * 2 + elems * 2 + 2 * elems * 4,  # dk, dv in fp32
        "SDPA bwd (graph)": 5 * elems * 2 + bh * n * 4 + 3 * elems * 2,
        "SDPA fwd+bwd (graph)": 4 * elems * 2 + 3 * elems * 2,
    }
    return _rows((bh, n, d), bwd_flops(bh, n, d), nbytes, ms, errs)


def run(reps: int = 30) -> dict:
    """Every row at the microbench's shapes; needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("perf_attn_kernel: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    rows = [r for shape in FWD_SHAPES for r in forward_rows(*shape, reps)]
    rows += backward_rows(*BWD_SHAPE, reps)
    return {"card": card_name_and_power(), "device": torch.cuda.get_device_name(0), "reps": reps, "rows": rows}


def report(result: dict) -> None:
    print(f"{'variant':20s} {'shape':16s} {'ms':>8s} {'TF/s':>7s} {'%peak':>6s} {'bound ms':>9s} "
          f"{'err/plain':>10s} {'err/K1|K2':>10s}", flush=True)
    for r in result["rows"]:
        vs = r.get("err_vs_k1", r.get("err_vs_k2"))
        print(f"{r['variant']:20s} {str(r['shape']):16s} {r['ms']:8.3f} {r['tflops']:7.1f} {r['pct_peak']:6.2f} "
              f"{r['bound_ms']:9.4f} {r['err_vs_plain']:10.2e} {'' if vs is None else f'{vs:10.2e}'}", flush=True)
    print(result["card"], flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30, help="timed calls per variant (median; at least 20)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = run(args.reps)
    report(result)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
