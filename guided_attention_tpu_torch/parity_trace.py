"""Parity trace of the port: dump a guided trajectory, compare two dumps.

Counterpart of the JAX package's ``scripts/parity_trace.py`` (its ``trace``
and ``compare`` modes). A run starts from a FIXED initial latent, so that two
runs (the port against the JAX package on the CPU, the card against the CPU,
bf16 against float32) can be held against each other step by step. Both
tools write the same npz schema, and each one's ``compare`` reads the
other's files.

Usage:
  python -m guided_attention_tpu_torch.parity_trace trace --model sd21 --sd_2_1 --dtype bf16 \\
      --steps 10 --save_latents init.npy --out a.npz                  # on the card
  python -m guided_attention_tpu_torch.parity_trace trace --model micro --steps 3 --cpu \\
      --latents init.npy --out b.npz                                   # on the CPU
  python -m guided_attention_tpu_torch.parity_trace compare a.npz b.npz [--rtol 1e-3 --atol 1e-4]

npz schema (the JAX package's layouts: NHWC latents, maps [R,R,K]):
  total_loss      f32[S]             final-eval loss of the last recursion
  eval_unscaled   f32[S,R_sub,K]     per-eval-slot per-token unscaled losses;
                                     slot 0 = eval0, 1.. = refinement
                                     subiters, R_sub-1 = final fresh forward
  eval_mask       bool[S,R_sub]      which slots ran
  eval_maps       f16[S,R_sub,R,R,K] per-slot re-softmaxed (unsmoothed)
                                     aggregated cross maps
  latent_mean     f32[S,C]           post-scheduler-step latent stats
  latent_std      f32[S,C]           (std of |latent|)
  latent_p99      f32[S,C]
  init_latents    f32[h,w,C]         the initial latent actually used
  final_latents   f32[h,w,C]
  meta            json string        prompt, seed, steps, model, dtype,
                                     hyperparameters; here also
                                     ``side: "torch"``, the device, the
                                     attention route and ``launches``, each
                                     kernel's launches in this run

The initial latent interchange file (``--latents`` / ``--save_latents``) is
a plain .npy in either the NCHW [1,4,h,w] or the NHWC [1,h,w,4] layout,
told apart by which axis is 4, so that one file serves both packages. The
initial latent enters the loop in float32 whatever the model's dtype, as in
the JAX tool.

The device is "cuda" unless ``--device cpu`` (or ``--cpu``) says otherwise;
without a GPU a CUDA trace raises. The kernels take bfloat16: a float32
model on the card runs the plain attention route (``use_flash_attention``
set to False), and the trace says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, Optional

import numpy as np

DEFAULT_META_PROMPT = "a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]"
DTYPES = ("fp32", "bf16")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def norm_latents(arr: np.ndarray) -> np.ndarray:
    """Accept [1,C,h,w] (NCHW) or [1,h,w,C] (NHWC); return NHWC float32, C
    order (a strided latent would run other CPU kernels, which round
    differently)."""
    if arr.ndim != 4 or arr.shape[0] != 1:
        raise ValueError(f"initial latents must be [1,...], got {arr.shape}")
    if arr.shape[-1] == 4:
        return np.ascontiguousarray(arr, np.float32)
    if arr.shape[1] == 4:
        return np.ascontiguousarray(np.transpose(arr, (0, 2, 3, 1)), np.float32)
    raise ValueError(f"cannot find channel axis of size 4 in {arr.shape}")


def parse_thresholds(s: str) -> Optional[Dict[int, float]]:
    """"0:0.1,3:0.8" -> {0: 0.1, 3: 0.8}; "" -> None (the default thresholds)."""
    if not s:
        return None
    out = {}
    for part in s.split(","):
        k, v = part.split(":")
        out[int(k)] = float(v)
    return out


def attention_route(sd) -> str:
    """"kernels" when the UNet launches the hand-written kernels; else
    "plain" (the plain attention route, or the kernel wrappers' plain
    versions on CPU tensors)."""
    return "kernels" if sd.unet.config.use_flash_attention and sd.device.type == "cuda" else "plain"


def trace(
    pipe,
    meta_prompt: str = DEFAULT_META_PROMPT,
    seed: int = 28,
    steps: int = 10,
    latents: Optional[np.ndarray] = None,
    thresholds: str = "",
    hp: Optional[Dict[str, Any]] = None,
    guidance_scale: float = 7.5,
    max_iter_to_alter: int = 25,
    run_standard_sd: bool = False,
    sd_2_1: bool = False,
    model: Optional[str] = None,
    noise=None,
) -> Dict[str, Any]:
    """One generation of ``pipe`` (a ``GuidedAttentionPipeline``) from the
    initial latent ``latents`` (either layout; the seed's own draw when
    None), as the npz fields of the schema above. ``thresholds`` is the
    command line's string, ``hp`` the HyperParams overrides, ``noise`` a
    ``NoiseSource`` in place of the seed's re-noise draws."""
    import torch

    from guided_attention_tpu_torch.config import HyperParams
    from guided_attention_tpu_torch.ops.flash_attention import LAUNCHES

    sd = pipe.sd
    if latents is None:
        init = pipe._seeded([seed])[1].float().cpu().numpy()
    else:
        init = norm_latents(np.asarray(latents))
    hp_over = dict(hp or {})
    before = dict(LAUNCHES)
    out = pipe.dispatch(
        meta_prompt=meta_prompt,
        seed=seed,
        hp=HyperParams(**hp_over) if hp_over else None,
        num_inference_steps=steps,
        guidance_scale=guidance_scale,
        max_iter_to_alter=max_iter_to_alter,
        run_standard_sd=run_standard_sd,
        thresholds=parse_thresholds(thresholds),
        sd_2_1=sd_2_1,
        latents=torch.from_numpy(init),
        decode=False,
        capture_diagnostics=True,
        capture_eval_maps=True,
        noise=noise,
    ).result()
    d = out.diagnostics
    dtype = {torch.float32: "fp32", torch.bfloat16: "bf16"}.get(sd.config.unet.dtype, str(sd.config.unet.dtype))
    meta = {
        "side": "torch",
        "meta_prompt": meta_prompt,
        "prompt": out.prompt,
        "seed": seed,
        "steps": steps,
        "model": model or sd.config.name,
        "dtype": dtype,
        "thresholds": thresholds or "",
        "hp": hp_over,
        "guidance_scale": guidance_scale,
        "run_standard_sd": run_standard_sd,
        "sd_2_1": sd_2_1,
        "device": str(sd.device),
        "device_name": torch.cuda.get_device_name(sd.device) if sd.device.type == "cuda" else "cpu",
        "attention": attention_route(sd),
        "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES},
    }
    return {
        "total_loss": np.asarray(d.total_loss, np.float32),
        "eval_unscaled": np.asarray(d.eval_unscaled, np.float32),
        "eval_mask": np.asarray(d.eval_mask, bool),
        "eval_maps": np.asarray(d.eval_maps, np.float16),
        "latent_mean": np.asarray(d.latent_mean, np.float32),
        "latent_std": np.asarray(d.latent_std, np.float32),
        "latent_p99": np.asarray(d.latent_p99, np.float32),
        "init_latents": init[0],
        "final_latents": np.asarray(out.latents, np.float32)[0],
        "meta": json.dumps(meta),
    }


def save(path: str, fields: Dict[str, Any]) -> None:
    np.savez_compressed(path, **fields)


# keys compared (when present in both). When the tolerances are left at
# their defaults, per-key tolerances from _KEY_TOL apply: eval_maps gets a
# looser floor because both sides quantize through f16 (rel eps 2^-11 ~
# 4.9e-4, and values near 1/77 make the default atol=1e-4 tighter than one
# f16 ulp).
COMPARE_KEYS = (
    "total_loss",
    "eval_unscaled",
    "eval_maps",
    "latent_mean",
    "latent_std",
    "latent_p99",
    "init_latents",
    "final_latents",
)
DEFAULT_RTOL, DEFAULT_ATOL = 1e-3, 1e-4
_KEY_TOL = {"eval_maps": (5e-3, 1e-3)}


def key_tolerances(key: str, rtol: Optional[float] = None, atol: Optional[float] = None):
    """(rtol, atol) for one compared key: explicit values always win; at the
    defaults, f16-quantized keys use their looser per-key floor."""
    if rtol is None and atol is None and key in _KEY_TOL:
        return _KEY_TOL[key]
    return (DEFAULT_RTOL if rtol is None else rtol), (DEFAULT_ATOL if atol is None else atol)


def compare(a_path: str, b_path: str, rtol: Optional[float] = None, atol: Optional[float] = None,
            rows: Optional[Dict[str, Dict[str, float]]] = None) -> bool:
    """Hold trace ``b_path`` against ``a_path`` key by key; print one line
    per key and the verdict, return whether every key passed. Only eval
    slots valid in both files are compared, and a differing eval mask (the
    control flow diverged) fails. ``rows``, when given, receives each key's
    max_abs, max_rel, n and tolerances."""
    a = np.load(a_path, allow_pickle=False)
    b = np.load(b_path, allow_pickle=False)
    for f, name in ((a, a_path), (b, b_path)):
        if "meta" in f:
            _log(f"{name}: {json.loads(str(f['meta']))}")

    ok = True
    mask = None
    if "eval_mask" in a and "eval_mask" in b:
        ma, mb = a["eval_mask"], b["eval_mask"]
        S = min(ma.shape[0], mb.shape[0])
        Rs = min(ma.shape[1], mb.shape[1])
        if not np.array_equal(ma[:S, :Rs], mb[:S, :Rs]):
            print(f"eval_mask DIFFERS (control flow diverged on "
                  f"{int((ma[:S, :Rs] != mb[:S, :Rs]).sum())} slots) — comparing joint slots only")
            ok = False
        mask = ma[:S, :Rs] & mb[:S, :Rs]

    for key in COMPARE_KEYS:
        if key not in a or key not in b:
            continue
        xa, xb = a[key].astype(np.float64), b[key].astype(np.float64)
        S = min(xa.shape[0], xb.shape[0]) if xa.ndim else 0
        if xa.ndim and xb.ndim and xa.shape[1:] != xb.shape[1:]:
            print(f"{key}: SHAPE MISMATCH {xa.shape} vs {xb.shape}")
            ok = False
            continue
        xa, xb = xa[:S], xb[:S]
        if key.startswith("eval_") and mask is not None and xa.ndim >= 2:
            m = mask[:S, : xa.shape[1]]
            sel = np.broadcast_to(m.reshape(m.shape + (1,) * (xa.ndim - 2)), xa.shape)
            xa, xb = xa[sel], xb[sel]
        if xa.size == 0:
            print(f"{key}: (empty after masking)")
            continue
        adiff = np.abs(xa - xb)
        max_abs = float(adiff.max())
        max_rel = float((adiff / np.maximum(np.abs(xb), 1e-12)).max())
        k_rtol, k_atol = key_tolerances(key, rtol, atol)
        close = bool(np.allclose(xa, xb, rtol=k_rtol, atol=k_atol))
        print(f"{'OK ' if close else 'FAIL'} {key:16s} max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
              f"n={xa.size} (rtol={k_rtol:g} atol={k_atol:g})")
        if rows is not None:
            rows[key] = {"max_abs": max_abs, "max_rel": max_rel, "n": int(xa.size), "rtol": k_rtol,
                         "atol": k_atol, "ok": close}
        ok = ok and close
    print("PARITY: " + ("PASS" if ok else "FAIL"), flush=True)
    return ok


def cmd_trace(args) -> int:
    import torch

    from guided_attention_tpu_torch.models.bundle import StableDiffusion
    from guided_attention_tpu_torch.runner import GuidedAttentionPipeline

    device = "cpu" if args.cpu else args.device
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    sd = StableDiffusion.create(args.model, dtype, device=device, checkpoint_dir=args.checkpoint)
    if dtype == torch.float32 and sd.device.type == "cuda" and sd.unet.config.use_flash_attention:
        # the kernels take bf16: a float32 model on the card runs the plain route
        sd.unet.config = dataclasses.replace(sd.unet.config, use_flash_attention=False)
    _log(f"trace: {args.model} {args.dtype} on {sd.device}, attention route: {attention_route(sd)}"
         + (" (float32 on the card: use_flash_attention=False)" if dtype == torch.float32 and sd.device.type == "cuda"
            else ""))
    pipe = GuidedAttentionPipeline(sd)
    latents = np.load(args.latents) if args.latents else None
    fields = trace(
        pipe,
        meta_prompt=args.meta_prompt,
        seed=args.seed,
        steps=args.steps,
        latents=latents,
        thresholds=args.thresholds,
        hp=json.loads(args.hp) if args.hp else None,
        guidance_scale=args.guidance_scale,
        max_iter_to_alter=args.max_iter_to_alter,
        run_standard_sd=args.run_standard_sd,
        sd_2_1=args.sd_2_1,
        model=args.model,
    )
    if args.save_latents:
        np.save(args.save_latents, fields["init_latents"][None])
        _log(f"initial latents -> {args.save_latents}")
    save(args.out, fields)
    _log(f"trace -> {args.out} (S={args.steps})")
    return 0


def cmd_compare(args) -> int:
    return 0 if compare(args.a, args.b, args.rtol, args.atol) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("trace", help="run a generation and dump the trajectory")
    t.add_argument("--model", default="sd15", help="config name: sd15/sd21/micro")
    t.add_argument("--checkpoint", default=None, help="local checkpoint dir (native or diffusers layout)")
    t.add_argument("--meta_prompt", default=DEFAULT_META_PROMPT)
    t.add_argument("--seed", type=int, default=28)
    t.add_argument("--steps", type=int, default=10)
    t.add_argument("--latents", default=None, help=".npy initial latent (NCHW or NHWC)")
    t.add_argument("--save_latents", default=None, help="write the initial latent used to this .npy")
    t.add_argument("--out", required=True)
    t.add_argument("--dtype", choices=DTYPES, default="fp32")
    t.add_argument("--thresholds", default="", help='e.g. "0:1.0" or "0:0.1,3:0.8"')
    t.add_argument("--hp", default="", help='HyperParams overrides as JSON, e.g. {"recurse_steps":1}')
    t.add_argument("--guidance_scale", type=float, default=7.5)
    t.add_argument("--max_iter_to_alter", type=int, default=25)
    t.add_argument("--run_standard_sd", action="store_true")
    t.add_argument("--sd_2_1", action="store_true")
    t.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    t.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    t.set_defaults(fn=cmd_trace)

    c = sub.add_parser("compare", help="compare two trace npz files")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--rtol", type=float, default=None,
                   help=f"uniform rtol for every key (default: {DEFAULT_RTOL:g}, with per-key overrides for "
                        "f16-quantized keys; see _KEY_TOL)")
    c.add_argument("--atol", type=float, default=None,
                   help=f"uniform atol (default: {DEFAULT_ATOL:g}; same per-key rule)")
    c.set_defaults(fn=cmd_compare)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
